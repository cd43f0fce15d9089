"""Replay the JAX package's DLRM train goldens through the port.

``tests/data/torch_train_golden.npz`` holds, for the small DLRM of the
serve golden (8 tables, D=128, B=256, bf16 compute, 3 of its tables in a
dense class) trained by the JAX package's ``make_sparse_train_step`` on
the CPU with the SGD rule and ``optax.sgd``: the initial state (packed
buffers, dense-class tables, flax dense params), three batches, the
three losses and the final state. ``tests/test_torch_train_golden.py``
regenerates it with JAX and holds the port to it on the CPU;
``chip_smoke.py`` replays it on the card.

The tolerance is of the bf16 class (:data:`LOSS_TOL`, :data:`UPDATE_TOL`):
both frameworks round every MLP and interaction output and cotangent to
bf16 at the same places, but a pre-rounding value within an f32
summation-order error of a rounding boundary flips by one bf16 ulp (2^-8
relative), and on the card the dense-class backward rounds its cotangent
to bf16 as the JAX package does on the TPU (the CPU golden keeps it f32).
Each final tensor is therefore held to a share of its own largest update
over the three steps, not to its absolute values.

``tests/data/torch_train_world4_golden.npz`` is the world-4 counterpart:
a small hybrid-parallel DLRM (9 tables, D=128, global batch 64, two
tables row-sliced, three in a dense class) trained by the JAX
``make_sparse_train_step`` over a 4-device CPU mesh under
``overlap='fused'``, from one initial state, once with f32 and once with
bf16 compute, each with its eval predictions. Every rank of a world-4
process group replays it with :func:`replay_world4`;
``tests/test_torch_train_world4.py`` holds the f32 replay to the f32
class on four gloo CPU ranks. ``chip_smoke.py`` replays the bf16 run on
the card to the tolerances above: on the card the interaction runs in
bf16 whatever the compute dtype (as on the TPU), which only the bf16
run shares with the CPU golden. Each run's final state is stored as the
update from the initial state (``<compute>_<part>_moved/<name>``): the
untouched rows are zero and compress.

``tests/data/torch_dense_train_golden.npz`` is the dense-autodiff path's
(the README's Quick start): a small DLRM that owns its tables (8 tables,
D=16, three of them in a dense class), three steps of the JAX
``make_train_step`` with ``optax.sgd`` from one initial param tree, once
with f32 and once with bf16 compute. The file holds the initial tree
(``init/<path>``), the batches, each run's losses and each final tensor
as its update (``<compute>_moved/<path>``). :func:`replay_dense` replays
a run through the port's ``training.make_train_step``.
``tests/test_torch_dense_train.py`` holds the f32 run to the f32 class on
the CPU; ``chip_smoke.py`` replays the bf16 run on the card to the
tolerances above (on the card the interaction runs in bf16 whatever the
compute dtype, which only the bf16 run shares with the CPU golden).

``tests/data/torch_dense_train_world4_golden.npz`` is the Quick start at
world 4: a small DLRM that owns its tables (9 tables, D=16, global batch
64, two tables row-sliced, three in a dense class), three steps of the
JAX ``make_train_step`` with ``optax.sgd`` over a 4-device CPU mesh from
one initial param tree (its class buffers global, ``[4 * rows, width]``),
once with f32 and once with bf16 compute, each with its eval step's
global predictions. Every rank of a world-4 process group replays it with
:func:`replay_dense_world4`; ``tests/test_torch_dense_train_world4.py``
holds the f32 run to the f32 class on four gloo CPU ranks, and
``chip_smoke.py`` the f32 run to the tolerances above on the card (where
the interaction runs in bf16). Not the bf16 run: the JAX step sums a
bf16-compute model's replicated gradients in bf16 (its ``shard_map`` psum
lands after the parameters' cast), the port in f32 as both packages'
sparse steps do, and with 16 samples a rank that rounding alone moves
the bf16 run by about 4 % of an update
(``tools/torch_dense_golden_shares.py``).

``tests/data/torch_train_zoo_golden.npz`` is the synthetic zoo's: the
published Tiny model with its big vocabularies cut to
:data:`ZOO_VOCAB_CAP` rows (:func:`zoo_plan`), Adagrad 0.01 on the sparse
classes (narrow multi-hot classes with optimizer state: the masked
physical-row gather) and ``optax.adagrad(0.01)`` on the dense parameters,
three f32 steps of the JAX ``make_sparse_train_step`` on batches of
:data:`ZOO_BATCH` power-law ids. Its initial state is made by
:func:`zoo_initial_state` from a numpy seed (``RandomState``, whose
stream numpy keeps stable), so the file holds only the batches, the
losses, the final dense params and each buffer's update; ``zoo_init_sum``
entries pin the initial state. :func:`replay_zoo` replays it through the
port.
``tests/data/torch_train_bf16_golden.npz`` is narrow storage's: the
train golden's model, batches and SGD on the JAX package's bf16 state
(``init_sparse_state_direct(dtype=jnp.bfloat16)``: bf16 packed buffers
and dense-class tables), its initial and final bf16 arrays stored as their
``uint16`` bits (numpy has no bf16 type without ``ml_dtypes``).
:func:`replay_bf16` replays it, :func:`compare_bf16` holds the replay to
the tolerances above (``tests/test_torch_narrow_storage.py`` on the CPU,
``chip_smoke.py`` on the card).
``tests/data/torch_train_ragged_golden.npz`` is the ragged value
streams': a small DLRM of eight D=128 tables (``combiner='sum'``, one of
them in a dense class) whose inputs 2, 3, 5 and 7 arrive as
``RaggedIds`` (lengths uniform in ``[1, h]``, declared by negative
``input_hotness``, so the 24-row table stays sparse), bf16 compute,
three steps of the JAX ``make_sparse_train_step`` (SGD rule,
``optax.sgd``) on the CPU. Its tables come from a numpy seed
(:func:`ragged_initial_tables`, pinned by ``ragged_init_sum`` entries),
so the file holds the batches, the dense params before and after, the
losses and each table's update. :func:`replay_ragged` replays it through
the port, to the tolerances above.
``tests/data/torch_train_tiered_golden.npz`` is tiered storage's: a small
f32 DLRM (:data:`TIERED_VOCAB`, D=16, its 4,000-row table host-tier)
trained by three guarded steps of the JAX ``tiering.TieredTrainer``
(Adagrad 0.05 on the sparse classes, ``optax.adagrad(0.05)`` on the dense
ones) with a staging region small enough that a step spills and a re-rank
after the second step. Its tables come from a numpy seed
(:func:`tiered_initial_tables`, pinned by ``tiered_init_sum`` entries);
the file holds the batches, the losses, the cumulative hit counters
(``hits/<class>``, exact), the spill steps, each reconciled simple-layout
table's update and the dense params before and after.
:func:`replay_tiered` replays it through the port's ``TieredTrainer``, to
the tolerances above (on the card the interaction runs in bf16).
``tests/data/torch_train_dynvocab_golden.npz`` is the dynamic
vocabulary's: the train golden's DLRM cut to D=32 (B=128, bf16 compute,
its three smallest tables in a dense class), the plan with
``oov='allocate'`` (:data:`DYNVOCAB_KNOBS`: admission after two
sightings, a TTL of two steps), five guarded steps of the JAX
``dynvocab.DynVocabTrainer`` (SGD rule, ``optax.sgd``) on raw 63-bit ids
drawn by :func:`dynvocab_batches` (a power law over four times each
sparse table's rows, each rank hashed to a key by :func:`raw_keys`). The
file holds the initial and final states, the raw batches, each step's
translated ids (``tcat/<input>``), the translator's final state
(``vocab/<key>``), its lifecycle counters (``vocab_totals/<class>``) and
the losses. :func:`replay_dynvocab` replays it through the port's
``DynVocabTrainer``; :func:`compare_dynvocab` holds translations,
translator state and counters bit-equal and the rest to the tolerances
above.
``tests/data/torch_stream_golden.npz`` is the delta stream's: a small
f32 DLRM (:data:`STREAM_VOCAB`, D=32, its three smallest tables in a
dense class; on the card the interaction runs in bf16) trained by the JAX sparse step (SGD rule,
``optax.sgd``) over :data:`STREAM_STEPS` batches, its chain published as
f32 (the base after :data:`STREAM_BASE_AFTER` batches, a delta after
each later one) and folded by the JAX subscriber. The file holds the initial state, the
batches, each delta's row sets and rows (``delta<i>/idx/<class>_r<rank>``,
``delta<i>/data/...``) and a probe's predictions after each fold
(``preds<i>``). :func:`replay_stream` replays the loop through the port's
publisher and subscriber; :func:`compare_stream` holds the row sets
bit-equal, the rows to :data:`UPDATE_TOL` of their largest update and the
predictions to :data:`PRED_TOL`.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .convert import (
    dlrm_state_dict_from_flax,
    dlrm_state_dict_to_flax,
    synthetic_state_dict_from_flax,
    train_state_from_flax,
    zoo_train_state_from_flax,
)
from .layers.embedding import TableConfig
from .layers.planner import DistEmbeddingStrategy
from .models.dlrm import DLRM, bce_loss, dlrm_embedding_plan
from .models.synthetic import (
    SYNTHETIC_MODELS,
    SyntheticModel,
    expand_tables,
    generate_batch,
    mlp_in_features,
    power_law_ids,
    synthetic_plan,
)
from .ops.packed_table import PackedLayout, adagrad_rule, adam_rule, \
    sgd_rule
from .parallel import wire
from .parallel.lookup_engine import class_param_name, padded_rows
from .serving.golden import PRED_TOL
from .training import (
    Adagrad,
    Adam,
    init_sparse_state,
    make_eval_step,
    make_sparse_eval_step,
    make_sparse_train_step,
    make_train_step,
    shard_batch,
)

GOLDEN_PATH = (Path(__file__).resolve().parents[1] / "tests" / "data" /
               "torch_train_golden.npz")
WORLD4_PATH = GOLDEN_PATH.with_name("torch_train_world4_golden.npz")
ZOO_PATH = GOLDEN_PATH.with_name("torch_train_zoo_golden.npz")
DENSE_PATH = GOLDEN_PATH.with_name("torch_dense_train_golden.npz")
DENSE_WORLD4_PATH = GOLDEN_PATH.with_name(
    "torch_dense_train_world4_golden.npz")
BF16_PATH = GOLDEN_PATH.with_name("torch_train_bf16_golden.npz")
LR = 0.1
STEPS = 3
# per-step losses
LOSS_TOL = dict(rtol=1e-2, atol=1e-3)
# per final tensor: max |got - want| <= UPDATE_TOL * max |want - initial|
UPDATE_TOL = 0.05
# per bf16 table cell of the narrow-storage golden: BF16_ULPS bf16 ulps of
# the larger magnitude (one flipped rounding of p + u a step, where u is a
# little off: STEPS), plus UPDATE_TOL of the cell's own update (the
# bf16-compute gradient a few per cent off, as above), plus BF16_ATOL for
# the cells near zero, whose summed gradient cancels (2^-16: a sixteenth
# of the ulp of the smallest table bound, 1/sqrt(300) ~ 0.058, ulp 2^-12)
BF16_ULPS = STEPS
BF16_ATOL = 2.0 ** -16
# the narrow-storage golden's f32 dense params: a share of their largest
# update, as UPDATE_TOL. Wider: bf16 compute rounds the MLPs' activations
# and cotangents, and from the second step on a bf16 table cell an ulp
# (2^-8) apart moves them; on the CPU the port's replay lands 7.7 % of an
# update from the JAX run (bottom_mlp.layers.0.weight), the f32-storage
# golden's 1.2 %
BF16_DENSE_UPDATE_TOL = 0.15


def load(path=GOLDEN_PATH) -> Dict[str, np.ndarray]:
  with np.load(path) as z:
    return {k: z[k] for k in z.files}


def flax_tree(golden: Dict[str, np.ndarray], prefix: str) -> Dict:
  """The ``<prefix>/<mlp>/<layer>/<leaf>`` entries -> the flax tree."""
  tree: Dict = {}
  for key, arr in golden.items():
    if key.startswith(prefix + "/"):
      mlp, layer, leaf = key.split("/")[1:]
      tree.setdefault(mlp, {}).setdefault(layer, {})[leaf] = arr
  return tree


def _entries(golden, prefix: str) -> Dict[str, np.ndarray]:
  return {k.split("/", 1)[1]: v for k, v in golden.items()
          if k.startswith(prefix + "/")}


def initial_state(golden: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
  """The JAX initial train state as numpy (``train_state_from_flax``'s
  input)."""
  return {"fused": _entries(golden, "fused0"),
          "emb_dense": _entries(golden, "emb_dense0"),
          "dense": flax_tree(golden, "dense0"), "step": 0}


def final_state(golden: Dict[str, np.ndarray]) -> Dict[str, Dict]:
  """The JAX final state, each part keyed as the port's state is."""
  return {"fused": _entries(golden, "fused3"),
          "emb_dense": _entries(golden, "emb_dense3"),
          "dense": {k: v.numpy() for k, v in dlrm_state_dict_from_flax(
              flax_tree(golden, "dense3")).items()}}


def replay(golden: Dict[str, np.ndarray], device="cuda", initial=None
           ) -> Tuple[List[float], Dict[str, Dict[str, np.ndarray]]]:
  """Three steps of the port's sparse train step from the golden's
  initial state (or ``initial``, numpy) on ``device``: returns ``(losses,
  final state)`` with the final state as f32 numpy, keyed as
  :func:`final_state`."""
  vocab = [int(v) for v in golden["vocab"]]
  dim = int(golden["dim"])
  plan = dlrm_embedding_plan(
      vocab, dim, dense_row_threshold=int(golden["dense_row_threshold"]))
  model = DLRM(vocab, dim,
               bottom_mlp=tuple(int(w) for w in golden["bottom_mlp"]),
               top_mlp=tuple(int(w) for w in golden["top_mlp"]),
               num_numerical=golden["numerical"].shape[2],
               compute_dtype=torch.bfloat16, tables=False, device=device)
  state = train_state_from_flax(
      initial_state(golden) if initial is None else initial, device=device)
  step = make_sparse_train_step(
      model, plan, bce_loss, functools.partial(torch.optim.SGD, lr=LR),
      sgd_rule(LR))
  dev = torch.device(device)
  losses = []
  for i in range(STEPS):
    cats = [torch.as_tensor(c, device=dev) for c in golden["cats"][i]]
    state, loss = step(state, torch.as_tensor(golden["numerical"][i],
                                              device=dev),
                       cats, torch.as_tensor(golden["labels"][i],
                                             device=dev))
    losses.append(float(loss))
  got = {part: {k: v.detach().cpu().to(torch.float32).numpy()
                for k, v in state[part].items()}
         for part in ("fused", "emb_dense", "dense")}
  return losses, got


def compare(golden: Dict[str, np.ndarray], losses: List[float],
            got: Dict[str, Dict[str, np.ndarray]]) -> Dict[str, float]:
  """Hold a replay to the golden; returns the worst loss error and the
  worst final-tensor error as a share of that tensor's largest update.
  Raises ``AssertionError`` naming the first tensor out of tolerance."""
  return _compare(golden["losses"], initial_state(golden),
                  final_state(golden), losses, got)


def _compare(want_loss, initial, want, losses, got,
             to_port=train_state_from_flax) -> Dict[str, float]:
  np.testing.assert_allclose(losses, want_loss, **LOSS_TOL)
  init = to_port(initial, device="cpu")
  worst = 0.0
  for part, tensors in want.items():
    assert sorted(tensors) == sorted(got[part]), part
    worst = max(worst, _update_share(
        {n: init[part][n].numpy() for n in tensors}, tensors, got[part],
        part))
  return {"loss_max_abs_err": float(np.abs(np.asarray(losses)
                                            - want_loss).max()),
          "state_max_err_share": worst}


def _update_share(init, want, got, part: str,
                  tol: float = UPDATE_TOL) -> float:
  """The worst ``max |got - want| / max |want - init|`` over the named
  tensors; raises naming the first above ``tol``."""
  worst = 0.0
  for name, w in want.items():
    moved = float(np.abs(w - init[name]).max())
    err = float(np.abs(got[name] - w).max())
    assert moved > 0.0, f"{part}/{name} never changed in the golden"
    share = err / moved
    assert share <= tol, (
        f"{part}/{name}: off by {err} against a largest update of "
        f"{moved} ({share:.3%} > {tol:.0%})")
    worst = max(worst, share)
  return worst


# ---------------------------------------------------------------------------
# the narrow-storage golden
# ---------------------------------------------------------------------------


def _bits_entries(golden, prefix: str) -> Dict[str, np.ndarray]:
  """bf16 entries stored as their ``uint16`` bits, as 2-byte voids (the
  form ``np.load`` gives a bf16 array, which ``convert`` takes)."""
  return {k: v.view("V2") for k, v in _entries(golden, prefix).items()}


def _widened(golden, prefix: str) -> Dict[str, np.ndarray]:
  """bf16 bits entries widened to f32 (exact)."""
  return {k: (v.astype(np.uint32) << 16).view(np.float32)
          for k, v in _entries(golden, prefix).items()}


def bf16_initial_state(golden: Dict[str, np.ndarray]
                       ) -> Dict[str, np.ndarray]:
  """The narrow-storage golden's initial state (bf16 buffers and
  dense-class tables, f32 dense params), ``train_state_from_flax``'s
  input."""
  return {"fused": _bits_entries(golden, "fused0"),
          "emb_dense": _bits_entries(golden, "emb_dense0"),
          "dense": flax_tree(golden, "dense0"), "step": 0}


def replay_bf16(golden: Dict[str, np.ndarray], device="cuda"
                ) -> Tuple[List[float], Dict[str, Dict[str, np.ndarray]]]:
  """:func:`replay` of ``tests/data/torch_train_bf16_golden.npz``: the
  train golden's model and batches on the JAX package's bf16 state
  (``init_sparse_state_direct(dtype=jnp.bfloat16)``); the final state
  comes back widened to f32."""
  return replay(golden, device, initial=bf16_initial_state(golden))


# the rules golden (Adam on the sparse and the dense side, f32 compute):
# every tensor, its bf16 cells and the f32 dense params, to this share of
# its largest update on the card. Adam's step is the gradient over its own
# running RMS, so a gradient a little off moves a touched cell that share
# of a whole step off, where an SGD step of a cell is a few per cent of
# its own (small) update. On the card the interaction's bf16 operands make
# the gradients a little off, and K1's bf16 form adds a run of duplicate
# ids at once where XLA rounds each add (the golden's smallest tables take
# dozens of ids a row a batch): three runs of the card needed 0.300-0.305.
# A planted fault fails it: ``b2=0.99``, ``b1=0.8`` or ``eps=1e-5`` in
# both Adams (``tests/test_torch_narrow_rules.py``)
RULES_UPDATE_TOL = 0.5
# ... and the CPU replay's (which needs 0.002): the CPU path runs the
# JAX package's arithmetic, so only the bf16 adds' order parts them
RULES_CPU_UPDATE_TOL = 0.02
# ... and the rules golden's f32 dense params (``optax.adam``): this share
# of each tensor's cells within the update bound of its largest update.
# Adam normalizes a weight's gradient by its own RMS, so a weight whose
# gradient is near zero steps by about the learning rate in either
# direction: on the card, where the interaction's operands are rounded to
# bf16, a few such weights of the largest tensors step the other way
# (0.2-0.3 % of their cells), as the CPU replay's do not (it holds every
# cell)
RULES_DENSE_CELL_SHARE = 0.99


# The rules golden's second card bound: the card's replay against the
# port's own CPU replay of the card's arithmetic
# (``tests/data/torch_train_bf16_rules_card.npz``, written by
# ``tests/test_torch_narrow_rules.py --write-card``): the interaction's
# operands rounded to bf16 (``mxu_operand_dtype``) and K1-bf16's tiles
# (``cuda_apply.plan_apply``: each tile's run of one id summed in f32 and
# added to the bf16 row once), tiles in stream order. What is left between
# the two is the order of the card's adds (a row's tile atomics, a run's
# sum) and the f32 order of the interaction's sums. The bound reads the
# second-moment lanes (Adam's ``v``) of every row the emulation touched:
# at least RULES_CARD_MOMENT_SHARE of those cells within RULES_CARD_ULPS
# bf16 ulps of the emulation. K1's stated rounding is at most 3 bf16 ulps
# of a cell's absolute sum a hit, so a cell hit at most 5 times in a step
# stays within 15 <= 16 ulps of an exact sum, and ``v`` accumulates
# ``(1 - b2) g^2``, which the f32 order of ``g`` moves by a few parts in
# 2^8 at most. A ``b2`` fault moves every touched row's ``v`` by the
# factor ``(1 - b2') / (1 - b2)`` at its first step: 2 for ``b2=0.998``
# against the golden's 0.999, about 128 ulps. (The share over every lane,
# reported beside it, mixes in the table and first-moment lanes, whose
# Adam step turns the f32 order of a small gradient into a whole step.)
RULES_CARD_PATH = GOLDEN_PATH.with_name("torch_train_bf16_rules_card.npz")
RULES_CARD_ULPS = 16
RULES_CARD_MOMENT_SHARE = 0.5


def compare_card_emulation(emulated: Dict[str, np.ndarray],
                           losses: List[float],
                           got: Dict[str, Dict[str, np.ndarray]],
                           moment_share: float = RULES_CARD_MOMENT_SHARE
                           ) -> Dict[str, float]:
  """Hold a rules-golden replay to the CPU emulation of the card's
  arithmetic (:data:`RULES_CARD_PATH`): the losses within
  :data:`LOSS_TOL` of the emulation's, and in each bf16 buffer (Adam's
  ``[table | m | v]`` lanes of one row a physical row) the share of the
  ``v`` cells of the rows the emulation touched within
  :data:`RULES_CARD_ULPS` bf16 ulps of the emulation's at least
  ``moment_share``. Returns, per buffer, that share, the share of every
  cell within the same ulps and the bit-equal share; raises
  AssertionError naming the first buffer below."""
  np.testing.assert_allclose(losses, emulated["losses"], **LOSS_TOL)
  dim = int(emulated["dim"])
  out: Dict[str, float] = {}
  for name, w in _widened(emulated, "fused3").items():
    g = got["fused"][name]
    assert w.shape[1] == 3 * dim, (name, w.shape, dim)
    m = np.maximum(np.abs(g), np.abs(w))
    ulp = np.exp2(np.floor(np.log2(np.maximum(m, 2.0 ** -126))) - 7)
    within = np.abs(g - w) <= RULES_CARD_ULPS * ulp
    touched = np.any(w[:, 2 * dim:] != 0, axis=1)
    moment = float(within[touched][:, 2 * dim:].mean())
    out[f"{name}/moment_within_share"] = moment
    out[f"{name}/within_share"] = float(within.mean())
    out[f"{name}/bit_equal_share"] = float((g == w).mean())
    assert moment >= moment_share, (
        f"fused/{name}: {moment:.4%} of the touched rows' second-moment "
        f"cells within {RULES_CARD_ULPS} bf16 ulps of the card emulation "
        f"(< {moment_share:.0%})")
  return out


def _bf16_ulps(got: np.ndarray, want: np.ndarray,
               init: np.ndarray, tensor_share=None) -> np.ndarray:
  """``max(|got - want| - BF16_ATOL - UPDATE_TOL * |want - init|, 0)`` in
  bf16 ulps of the larger of the two magnitudes; with ``tensor_share``
  the slack is that share of the tensor's largest ``|want - init|``
  instead of :data:`UPDATE_TOL` of the cell's own."""
  m = np.maximum(np.abs(got), np.abs(want))
  ulp = np.exp2(np.floor(np.log2(np.maximum(m, 2.0 ** -126))) - 7)
  moved = np.abs(want - init)
  slack = BF16_ATOL + (UPDATE_TOL * moved if tensor_share is None
                       else tensor_share * moved.max())
  return np.maximum(np.abs(got - want) - slack, 0.0) / ulp


def compare_bf16(golden: Dict[str, np.ndarray], losses: List[float],
                 got: Dict[str, Dict[str, np.ndarray]],
                 tensor_share=None,
                 dense_cell_share: float = RULES_DENSE_CELL_SHARE
                 ) -> Dict[str, float]:
  """Hold a narrow-storage replay to its golden: the losses to
  :data:`LOSS_TOL`; every bf16 table cell within :data:`BF16_ULPS` bf16
  ulps, plus :data:`UPDATE_TOL` of its own update, plus
  :data:`BF16_ATOL`, of the golden's (most SGD updates of these tables are
  an ulp or two, so a share of a tensor's largest update says nothing
  here); the f32 dense params to :data:`BF16_DENSE_UPDATE_TOL` of their
  largest update. With ``tensor_share`` (the rules golden's Adam,
  :data:`RULES_UPDATE_TOL`) every bf16 cell to that share of its
  tensor's largest update, and ``dense_cell_share`` of each dense
  param's cells.
  Returns the worst errors and the bit-equal share of the bf16 cells."""
  np.testing.assert_allclose(losses, golden["losses"], **LOSS_TOL)
  worst_ulps, cells, equal, needed = 0.0, 0, 0, 0.0
  for part in ("fused", "emb_dense"):
    want = _widened(golden, f"{part}3")
    init = _widened(golden, f"{part}0")
    assert sorted(want) == sorted(got[part]), part
    for name, w in want.items():
      if tensor_share is not None:
        # the share of the tensor's largest update this replay needs
        over = _bf16_ulps(got[part][name], w, init[name], 0.0)
        m = np.maximum(np.abs(got[part][name]), np.abs(w))
        ulp = np.exp2(np.floor(np.log2(np.maximum(m, 2.0 ** -126))) - 7)
        excess = np.maximum(over - BF16_ULPS, 0.0) * ulp
        needed = max(needed, float(excess.max())
                     / max(float(np.abs(w - init[name]).max()), 1e-30))
      u = _bf16_ulps(got[part][name], w, init[name], tensor_share)
      assert u.max() <= BF16_ULPS, (
          f"{part}/{name}: off by {u.max()} bf16 ulps (> {BF16_ULPS})")
      worst_ulps = max(worst_ulps, float(u.max()))
      cells += u.size
      equal += int((got[part][name] == w).sum())
  dense0 = {k: v.numpy() for k, v in dlrm_state_dict_from_flax(
      flax_tree(golden, "dense0")).items()}
  if tensor_share is None:
    share = _update_share(dense0, final_state(golden)["dense"],
                          got["dense"], "dense", BF16_DENSE_UPDATE_TOL)
  else:
    name, share = _cells_within(dense0, final_state(golden)["dense"],
                                got["dense"], tensor_share)
    assert share >= dense_cell_share, (
        f"dense/{name}: {share:.4%} of the cells within {tensor_share:.0%} "
        f"of the tensor's largest update (< {dense_cell_share:.2%})")
  out = {"loss_max_abs_err": float(np.abs(np.asarray(losses)
                                           - golden["losses"]).max()),
         "table_max_ulps": worst_ulps, "table_bit_equal_share":
         equal / cells}
  if tensor_share is None:
    out["dense_max_err_share"] = share
  else:
    out["table_update_share_needed"] = needed
    out["dense_cells_within_share"] = share
    out["dense_worst_tensor"] = name
  return out


def _cells_within(init, want, got, tol: float) -> Tuple[str, float]:
  """The tensor with the smallest share of cells within ``tol`` of its
  largest update ``max |want - init|``, and that share."""
  worst = ("", 1.0)
  for name, w in want.items():
    moved = float(np.abs(w - init[name]).max())
    share = float((np.abs(got[name] - w) <= tol * moved).mean())
    worst = min(worst, (name, share), key=lambda x: x[1])
  return worst


# ---------------------------------------------------------------------------
# the narrow-storage rules golden (Adam on bf16 buffers, a ragged input)
# ---------------------------------------------------------------------------

BF16_RULES_PATH = GOLDEN_PATH.with_name("torch_train_bf16_rules_golden.npz")
RULES_LR = 0.01  # adam_rule(0.01) and optax.adam(0.01)
RULES_RAGGED = {7: 6}  # the ragged input -> its longest sample
# every table a sparse class: the card rounds a dense class's cotangent to
# bf16 as the TPU does, the CPU golden keeps it f32, and Adam turns that
# rounding of a small gradient into a whole step
RULES_DENSE_ROW_THRESHOLD = 0


def bf16_rules_plan(golden: Dict[str, np.ndarray],
                    table_config=TableConfig,
                    strategy=DistEmbeddingStrategy):
  """The rules golden's plan (of this package, or of another with its
  ``TableConfig`` and ``DistEmbeddingStrategy``): the train golden's
  tables, every one a sparse class (``dense_row_threshold`` 0), the
  ragged input's with a ``sum`` combiner and its negative
  ``input_hotness``."""
  vocab = [int(v) for v in golden["vocab"]]
  return strategy(
      [table_config(input_dim=v, output_dim=int(golden["dim"]),
                    combiner="sum" if i in RULES_RAGGED else None)
       for i, v in enumerate(vocab)], 1, "basic",
      dense_row_threshold=int(golden["dense_row_threshold"]),
      input_hotness=[-RULES_RAGGED[i] if i in RULES_RAGGED else 1
                     for i in range(len(vocab))])


def bf16_rules_cats(golden: Dict[str, np.ndarray], i: int, device="cpu"):
  """Batch ``i``'s inputs: ``[B]`` ids, the ragged input a ``RaggedIds``
  of its stored ``values/<j>`` and ``splits/<j>``."""
  from .ops.ragged import RaggedIds
  dev = torch.device(device)
  return [RaggedIds(torch.as_tensor(golden[f"values/{j}"][i], device=dev),
                    torch.as_tensor(golden[f"splits/{j}"][i], device=dev))
          if j in RULES_RAGGED else
          torch.as_tensor(golden["cats"][i][j], device=dev)
          for j in range(len(golden["vocab"]))]


def replay_bf16_rules(golden: Dict[str, np.ndarray], device="cuda",
                      adam_kw: Optional[Dict[str, float]] = None
                      ) -> Tuple[List[float], Dict[str, Dict[str, np.ndarray]]]:
  """Three steps of the port's sparse step on the rules golden's bf16
  state (``tests/data/torch_train_bf16_rules_golden.npz``: the train
  golden's model and batches, bf16 buffers under ``adam_rule``, one input
  ragged, ``training.Adam`` for ``optax.adam`` on the dense side):
  returns ``(losses, final state)`` as :func:`replay_bf16`. ``adam_kw``
  (``b1``, ``b2``, ``eps``) sets both Adams' constants other than the
  golden's: a planted fault that :func:`compare_bf16` must refuse. The model
  computes in f32 (Adam normalizes every gradient, so a bf16 compute's
  noise would reach every touched cell), its interaction in bf16 on the
  card (``mxu_operand_dtype``) as on the TPU."""
  vocab = [int(v) for v in golden["vocab"]]
  dim = int(golden["dim"])
  model = DLRM(vocab, dim,
               bottom_mlp=tuple(int(w) for w in golden["bottom_mlp"]),
               top_mlp=tuple(int(w) for w in golden["top_mlp"]),
               num_numerical=golden["numerical"].shape[2],
               tables=False, device=device)
  state = train_state_from_flax(bf16_initial_state(golden), device=device)
  adam_kw = adam_kw or {}
  step = make_sparse_train_step(
      model, bf16_rules_plan(golden), bce_loss,
      functools.partial(Adam, lr=RULES_LR, **adam_kw),
      adam_rule(RULES_LR, **adam_kw))
  dev = torch.device(device)
  losses = []
  for i in range(STEPS):
    state, loss = step(
        state, torch.as_tensor(golden["numerical"][i], device=dev),
        bf16_rules_cats(golden, i, device),
        torch.as_tensor(golden["labels"][i], device=dev))
    losses.append(float(loss))
  got = {part: {k: v.detach().cpu().to(torch.float32).numpy()
                for k, v in state[part].items()}
         for part in ("fused", "emb_dense", "dense")}
  return losses, got


# ---------------------------------------------------------------------------
# the world-4 golden
# ---------------------------------------------------------------------------


def world4_plan(golden: Dict[str, np.ndarray], overlap: str = "fused",
                chunks=None) -> DistEmbeddingStrategy:
  """The world-4 golden's plan under the schedule ``overlap`` (the golden
  itself was made under ``'fused'`` with its ``exchange_chunks``)."""
  dim = int(golden["dim"])
  tables = [TableConfig(input_dim=int(v), output_dim=dim)
            for v in golden["vocab"]]
  return DistEmbeddingStrategy(
      tables, int(golden["world"]), "memory_balanced",
      dense_row_threshold=int(golden["dense_row_threshold"]),
      row_slice_threshold=int(golden["row_slice"]), overlap=overlap,
      exchange_chunks=int(golden["exchange_chunks"] if chunks is None
                          else chunks))


def world4_final_state(golden: Dict[str, np.ndarray],
                       compute: str = "f32") -> Dict[str, Dict]:
  """The JAX final state (global) of the ``compute`` run, keyed as
  :func:`final_state`."""
  init = initial_state(golden)
  return {part: {k: init[part][k] + v for k, v in
                 _entries(golden, f"{compute}_{part}_moved").items()}
          for part in ("fused", "emb_dense")} | {
              "dense": {k: v.numpy() for k, v in dlrm_state_dict_from_flax(
                  flax_tree(golden, f"{compute}_dense3")).items()}}


def replay_world4(golden: Dict[str, np.ndarray], mesh, overlap: str = "fused",
                  chunks=None, compute: str = "f32"):
  """Three steps of the port's world-4 train step from the golden's
  initial state at ``compute`` (``'f32'`` or ``'bf16'``), then its eval
  step, in this rank of ``mesh`` (every rank calls it). Returns
  ``(losses, final state, preds)``: the final state gathered to its
  global view as numpy (keyed as :func:`final_state`) and the global
  batch's predictions, the same on every rank."""
  plan = world4_plan(golden, overlap, chunks)
  vocab = [int(v) for v in golden["vocab"]]
  model = DLRM(vocab, int(golden["dim"]),
               bottom_mlp=tuple(int(w) for w in golden["bottom_mlp"]),
               top_mlp=tuple(int(w) for w in golden["top_mlp"]),
               num_numerical=golden["numerical"].shape[2],
               compute_dtype=(torch.float32 if compute == "f32"
                              else torch.bfloat16), tables=False,
               device=mesh.device)
  state = train_state_from_flax(initial_state(golden), mesh=mesh)
  step = make_sparse_train_step(
      model, plan, bce_loss, functools.partial(torch.optim.SGD, lr=LR),
      sgd_rule(LR), mesh=mesh)
  losses = []
  for i in range(STEPS):
    numerical, cats, labels = shard_batch(
        (golden["numerical"][i], list(golden["cats"][i]),
         golden["labels"][i]), mesh)
    state, loss = step(state, numerical, cats, labels)
    losses.append(float(loss))
  numerical, cats = shard_batch(
      (golden["eval_numerical"], list(golden["eval_cats"])), mesh)
  preds = make_sparse_eval_step(model, plan, sgd_rule(LR), mesh=mesh)(
      state, numerical, cats)
  got = {part: {k: wire.gather_blocks(v.detach(), mesh).cpu().numpy()
                for k, v in state[part].items()}
         for part in ("fused", "emb_dense")}
  got["dense"] = {k: v.detach().cpu().numpy()
                  for k, v in state["dense"].items()}
  return losses, got, wire.gather_blocks(preds, mesh).cpu().numpy()


def compare_world4(golden: Dict[str, np.ndarray], losses: List[float],
                   got: Dict[str, Dict[str, np.ndarray]], preds: np.ndarray,
                   compute: str = "bf16") -> Dict[str, float]:
  """:func:`compare` for a :func:`replay_world4` result of the
  ``compute`` run; the eval predictions are held to the loss
  tolerance."""
  out = _compare(golden[f"{compute}_losses"], initial_state(golden),
                 world4_final_state(golden, compute), losses, got)
  want = golden[f"{compute}_preds"]
  np.testing.assert_allclose(preds, want, **LOSS_TOL)
  out["preds_max_abs_err"] = float(np.abs(preds - want).max())
  return out


# ---------------------------------------------------------------------------
# the synthetic zoo golden (Tiny, Adagrad)
# ---------------------------------------------------------------------------

ZOO_MODEL = "tiny"
# rows kept of each table: the 10- and 1,000-row tables whole, the larger
# ones cut to this many
ZOO_VOCAB_CAP = 2000
# below the cut and above the 1,000-row tables: the published model's
# split of sparse and dense classes (bench_synthetic.py's threshold 2,048
# would make every cut table dense)
ZOO_DENSE_ROW_THRESHOLD = 1024
ZOO_BATCH = 64
ZOO_ALPHA = 1.05  # tools/bench_synthetic.py's power law
ZOO_LR = 0.01  # adagrad_rule(0.01), optax.adagrad(0.01)
ZOO_SEED = 0
# the uniform bound of the initial tables (the Keras default)
ZOO_INIT_SCALE = 0.05


def zoo_tables(cap: int = ZOO_VOCAB_CAP) -> List[TableConfig]:
  """Tiny's tables with every vocabulary above ``cap`` cut to ``cap``."""
  tables, _, _ = expand_tables(SYNTHETIC_MODELS[ZOO_MODEL])
  return [TableConfig(input_dim=min(t.input_dim, cap),
                      output_dim=t.output_dim, combiner=t.combiner)
          for t in tables]


def zoo_plan(cap: int = ZOO_VOCAB_CAP,
             dense_row_threshold: int = ZOO_DENSE_ROW_THRESHOLD,
             batch_hint=None) -> DistEmbeddingStrategy:
  """The world-1 plan of ``tools/bench_synthetic.py`` over
  :func:`zoo_tables`."""
  return synthetic_plan(SYNTHETIC_MODELS[ZOO_MODEL],
                        dense_row_threshold=dense_row_threshold,
                        batch_hint=batch_hint, tables=zoo_tables(cap))


def zoo_batches(steps: int = STEPS, batch: int = ZOO_BATCH,
                cap: int = ZOO_VOCAB_CAP, seed: int = ZOO_SEED):
  """``steps`` batches ``(numerical, cats, labels)`` as numpy:
  ``generate_batch(tiny, batch, alpha=1.05, seed=seed + i)``, ids folded
  into the cut vocabularies with a modulo (``bench_synthetic.py``'s rule
  for cut vocabularies) and hotness-1 inputs as ``[B]``."""
  cfg = SYNTHETIC_MODELS[ZOO_MODEL]
  tables = zoo_tables(cap)
  _, tmap, hotness = expand_tables(cfg)
  out = []
  for i in range(steps):
    numerical, cats, labels = generate_batch(cfg, batch, alpha=ZOO_ALPHA,
                                             seed=seed + i)
    cats = [(c % tables[t].input_dim).astype(np.int32)
            for c, t in zip(cats, tmap)]
    cats = [c if h > 1 else c[:, 0] for c, h in zip(cats, hotness)]
    out.append((numerical, cats, labels))
  return out


def zoo_initial_params(plan: DistEmbeddingStrategy, seed: int = ZOO_SEED
                       ) -> Dict:
  """Initial simple-layout params as numpy, in the flax layout:
  ``{"embeddings": {class name: [rows, width]}, "mlp": {"dense_i":
  {"kernel", "bias"}}}``. Tables uniform in +-0.05, MLP kernels normal
  with variance ``1 / fan_in``, biases zero; drawn from
  ``np.random.RandomState(seed)``."""
  rs = np.random.RandomState(seed)
  tables = {}
  for key in plan.class_keys:
    tables[class_param_name(*key)] = rs.uniform(
        -ZOO_INIT_SCALE, ZOO_INIT_SCALE,
        (padded_rows(plan, key), plan.classes[key].width)).astype(np.float32)
  cfg = SYNTHETIC_MODELS[ZOO_MODEL]
  widths = [mlp_in_features(cfg)] + list(cfg.mlp_sizes) + [1]
  mlp = {}
  for i, (fan_in, fan_out) in enumerate(zip(widths[:-1], widths[1:])):
    mlp[f"dense_{i}"] = {
        "kernel": (rs.standard_normal((fan_in, fan_out))
                   * fan_in ** -0.5).astype(np.float32),
        "bias": np.zeros((fan_out,), np.float32)}
  return {"embeddings": tables, "mlp": mlp}


def zoo_initial_state(plan: DistEmbeddingStrategy, rule,
                      seed: int = ZOO_SEED) -> Dict:
  """The zoo's initial train state as numpy in the JAX package's layout
  (``{"fused", "emb_dense", "dense", "step"}``, ``dense`` a flax tree):
  :func:`zoo_initial_params` packed by the port's ``init_sparse_state``
  (which packs as the JAX ``init_sparse_state`` does)."""
  params = zoo_initial_params(plan, seed)
  dense = synthetic_state_dict_from_flax({"mlp": params["mlp"]})
  state = init_sparse_state(
      plan, {"embeddings": {k: torch.tensor(v)
                            for k, v in params["embeddings"].items()},
             **dense}, rule, functools.partial(Adagrad, lr=ZOO_LR),
      device="cpu")
  return {"fused": {k: v.numpy() for k, v in state["fused"].items()},
          "emb_dense": {k: v.detach().numpy()
                        for k, v in state["emb_dense"].items()},
          "dense": {"mlp": params["mlp"]}, "step": 0}


def zoo_init_sums(state: Dict) -> Dict[str, np.ndarray]:
  """f64 sums of every initial buffer and table: a fingerprint of
  :func:`zoo_initial_state` that the golden stores."""
  out = {}
  for part in ("fused", "emb_dense"):
    for k, v in state[part].items():
      out[f"zoo_init_sum/{part}/{k}"] = np.float64(
          np.asarray(v, np.float64).sum())
  return out


def zoo_golden_state(golden: Dict[str, np.ndarray]):
  """``(initial, final)`` numpy states of the zoo golden: the initial one
  rebuilt (:func:`zoo_initial_state`, checked against the stored sums),
  the final one as the initial plus the stored updates, its dense params
  as the port's state_dict (keyed as :func:`final_state`)."""
  plan = zoo_plan()
  initial = zoo_initial_state(plan, adagrad_rule(ZOO_LR),
                              int(golden["seed"]))
  for k, v in zoo_init_sums(initial).items():
    if not np.isclose(v, golden[k], rtol=1e-12, atol=1e-9):
      raise AssertionError(
          f"the rebuilt initial state differs from the golden's ({k}: "
          f"{v} vs {golden[k]}): numpy's RandomState stream changed?")
  final = {part: {k: initial[part][k] + v for k, v in
                  _entries(golden, f"{part}_moved").items()}
           for part in ("fused", "emb_dense")}
  final["dense"] = {k: v.numpy() for k, v in synthetic_state_dict_from_flax(
      flax_tree(golden, "dense3")).items()}
  return initial, final


def zoo_cats(golden: Dict[str, np.ndarray], i: int) -> List[np.ndarray]:
  """Batch ``i``'s categorical inputs of the zoo golden (``cat/<input>``
  entries, ``[STEPS, B]`` or ``[STEPS, B, h]``)."""
  n = sum(1 for k in golden if k.startswith("cat/"))
  return [golden[f"cat/{j}"][i] for j in range(n)]


def replay_zoo(golden: Dict[str, np.ndarray], device="cuda"):
  """Three steps of the port's train step from the zoo golden's initial
  state on ``device``: returns ``(losses, final state)`` as
  :func:`replay` does."""
  plan = zoo_plan()
  initial, _ = zoo_golden_state(golden)
  model = SyntheticModel(SYNTHETIC_MODELS[ZOO_MODEL], tables=False,
                         device=device)
  state = zoo_train_state_from_flax(initial, device=device)
  step = make_sparse_train_step(
      model, plan, bce_loss, functools.partial(Adagrad, lr=ZOO_LR),
      adagrad_rule(ZOO_LR))
  dev = torch.device(device)
  losses = []
  for i in range(STEPS):
    cats = [torch.as_tensor(c, device=dev) for c in zoo_cats(golden, i)]
    state, loss = step(state,
                       torch.as_tensor(golden["numerical"][i], device=dev),
                       cats, torch.as_tensor(golden["labels"][i], device=dev))
    losses.append(float(loss))
  got = {part: {k: v.detach().cpu().to(torch.float32).numpy()
                for k, v in state[part].items()}
         for part in ("fused", "emb_dense", "dense")}
  return losses, got


def compare_zoo(golden: Dict[str, np.ndarray], losses: List[float],
                got: Dict[str, Dict[str, np.ndarray]]) -> Dict[str, float]:
  """:func:`compare` for a :func:`replay_zoo` result."""
  initial, final = zoo_golden_state(golden)
  return _compare(golden["losses"], initial, final, losses, got,
                  zoo_train_state_from_flax)


# ---------------------------------------------------------------------------
# the ragged golden (RaggedIds through make_sparse_train_step)
# ---------------------------------------------------------------------------

RAGGED_PATH = GOLDEN_PATH.with_name("torch_train_ragged_golden.npz")
RAGGED_VOCAB = (3, 10, 24, 33, 40, 48, 52, 60)
RAGGED_DIM = 128
RAGGED_BOTTOM = (16, 128)
RAGGED_TOP = (16, 1)
RAGGED_NUM = 13
RAGGED_BATCH = 128
RAGGED_HOT = {2: 5, 3: 3, 5: 8, 7: 12}  # ragged input -> its longest sample
RAGGED_DENSE_ROW_THRESHOLD = 32
RAGGED_SEED = 0


def ragged_hotness() -> List[int]:
  """The plan's ``input_hotness``: ``-h`` for a ragged input."""
  return [-RAGGED_HOT[i] if i in RAGGED_HOT else 1
          for i in range(len(RAGGED_VOCAB))]


def ragged_plan(table_config=TableConfig, strategy=DistEmbeddingStrategy):
  """The ragged golden's plan (of this package, or of another with its
  ``TableConfig`` and ``DistEmbeddingStrategy``)."""
  return strategy(
      [table_config(input_dim=v, output_dim=RAGGED_DIM, combiner="sum")
       for v in RAGGED_VOCAB], 1, "basic",
      dense_row_threshold=RAGGED_DENSE_ROW_THRESHOLD,
      input_hotness=ragged_hotness())


def ragged_initial_tables(plan, seed: int = RAGGED_SEED
                          ) -> Dict[str, np.ndarray]:
  """Every class's simple-layout table, uniform in +-0.05 from
  ``np.random.RandomState(seed)``."""
  rs = np.random.RandomState(seed)
  return {class_param_name(*key): rs.uniform(
      -ZOO_INIT_SCALE, ZOO_INIT_SCALE,
      (padded_rows(plan, key), plan.classes[key].width)).astype(np.float32)
          for key in plan.class_keys}


def ragged_golden_state(golden: Dict[str, np.ndarray]):
  """``(initial, final)`` numpy states of the ragged golden: the tables
  rebuilt (checked against the stored sums) and packed by the port's
  ``init_sparse_state`` beside the stored initial dense params; the final
  one as the initial plus the stored updates, its dense params as the
  port's state_dict (keyed as :func:`final_state`)."""
  plan = ragged_plan()
  tables = ragged_initial_tables(plan, int(golden["seed"]))
  for name, t in tables.items():
    want = golden[f"ragged_init_sum/{name}"]
    if not np.isclose(np.float64(t.sum(dtype=np.float64)), want, rtol=1e-12,
                      atol=1e-9):
      raise AssertionError(
          f"the rebuilt table {name} differs from the golden's: numpy's "
          "RandomState stream changed?")
  dense0 = flax_tree(golden, "dense0")
  packed = init_sparse_state(
      plan, {"embeddings": {k: torch.tensor(v) for k, v in tables.items()},
             **dlrm_state_dict_from_flax(dense0)}, sgd_rule(LR),
      functools.partial(torch.optim.SGD, lr=LR), device="cpu")
  initial = {"fused": {k: v.numpy() for k, v in packed["fused"].items()},
             "emb_dense": {k: v.detach().numpy()
                           for k, v in packed["emb_dense"].items()},
             "dense": dense0, "step": 0}
  final = {part: {k: initial[part][k] + v for k, v in
                  _entries(golden, f"{part}_moved").items()}
           for part in ("fused", "emb_dense")}
  final["dense"] = {k: v.numpy() for k, v in dlrm_state_dict_from_flax(
      flax_tree(golden, "dense3")).items()}
  return initial, final


def ragged_cats(golden: Dict[str, np.ndarray], i: int, device="cpu"):
  """Batch ``i``'s categorical inputs of the ragged golden: ``[B]`` ids,
  or a ``RaggedIds`` of the stored ``values/<j>`` and ``splits/<j>``."""
  from .ops.ragged import RaggedIds
  dev = torch.device(device)
  out = []
  for j in range(len(RAGGED_VOCAB)):
    if j in RAGGED_HOT:
      out.append(RaggedIds(
          torch.as_tensor(golden[f"values/{j}"][i], device=dev),
          torch.as_tensor(golden[f"splits/{j}"][i], device=dev)))
    else:
      out.append(torch.as_tensor(golden[f"cat/{j}"][i], device=dev))
  return out


def replay_ragged(golden: Dict[str, np.ndarray], device="cuda"):
  """Three steps of the port's sparse train step from the ragged golden's
  initial state on ``device``: returns ``(losses, final state)`` as
  :func:`replay` does."""
  plan = ragged_plan()
  initial, _ = ragged_golden_state(golden)
  model = DLRM(list(RAGGED_VOCAB), RAGGED_DIM, bottom_mlp=RAGGED_BOTTOM,
               top_mlp=RAGGED_TOP, num_numerical=RAGGED_NUM,
               compute_dtype=torch.bfloat16, tables=False, device=device)
  state = train_state_from_flax(initial, device=device)
  step = make_sparse_train_step(
      model, plan, bce_loss, functools.partial(torch.optim.SGD, lr=LR),
      sgd_rule(LR))
  dev = torch.device(device)
  losses = []
  for i in range(STEPS):
    state, loss = step(state,
                       torch.as_tensor(golden["numerical"][i], device=dev),
                       ragged_cats(golden, i, device),
                       torch.as_tensor(golden["labels"][i], device=dev))
    losses.append(float(loss))
  got = {part: {k: v.detach().cpu().to(torch.float32).numpy()
                for k, v in state[part].items()}
         for part in ("fused", "emb_dense", "dense")}
  return losses, got


def compare_ragged(golden: Dict[str, np.ndarray], losses: List[float],
                   got: Dict[str, Dict[str, np.ndarray]]) -> Dict[str, float]:
  """:func:`compare` for a :func:`replay_ragged` result."""
  initial, final = ragged_golden_state(golden)
  return _compare(golden["losses"], initial, final, losses, got)


# ---------------------------------------------------------------------------
# the dense-autodiff golden (make_train_step, optax.sgd)
# ---------------------------------------------------------------------------


def flax_paths(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
  """A nested param tree -> ``{"<a>/<b>/...": leaf}``."""
  out = {}
  for k, v in tree.items():
    path = f"{prefix}/{k}" if prefix else k
    if isinstance(v, dict):
      out.update(flax_paths(v, path))
    else:
      out[path] = np.asarray(v)
  return out


def _tree_of(paths: Dict[str, np.ndarray]) -> Dict:
  tree: Dict = {}
  for path, arr in paths.items():
    node = tree
    *parents, leaf = path.split("/")
    for p in parents:
      node = node.setdefault(p, {})
    node[leaf] = arr
  return tree


def dense_initial(golden: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
  """The dense golden's initial params, ``path -> array``."""
  return _entries(golden, "init")


def dense_final(golden: Dict[str, np.ndarray],
                compute: str = "f32") -> Dict[str, np.ndarray]:
  """The JAX final params of the ``compute`` run, ``path -> array``."""
  init = dense_initial(golden)
  return {k: init[k] + v
          for k, v in _entries(golden, f"{compute}_moved").items()}


def dense_model(golden: Dict[str, np.ndarray], compute: str = "f32",
                device="cuda") -> DLRM:
  """The golden's DLRM with its tables, holding the initial params."""
  vocab = [int(v) for v in golden["vocab"]]
  model = DLRM(vocab, int(golden["dim"]),
               bottom_mlp=tuple(int(w) for w in golden["bottom_mlp"]),
               top_mlp=tuple(int(w) for w in golden["top_mlp"]),
               num_numerical=golden["numerical"].shape[2],
               compute_dtype=(torch.float32 if compute == "f32"
                              else torch.bfloat16),
               dense_row_threshold=int(golden["dense_row_threshold"]),
               device=device)
  model.load_state_dict(dlrm_state_dict_from_flax(
      _tree_of(dense_initial(golden))))
  return model


def dense_loss(model, numerical, cats, labels):
  """The golden's ``loss_fn``: the model through its own embedding
  layer, mean sigmoid cross-entropy."""
  return bce_loss(model(numerical, cats), labels)


def replay_dense(golden: Dict[str, np.ndarray], compute: str = "f32",
                 device="cuda") -> Tuple[List[float], Dict[str, np.ndarray]]:
  """Three steps of the port's ``make_train_step`` (``torch.optim.SGD``)
  from the dense golden's initial params: ``(losses, final params as
  path -> numpy array)``."""
  model = dense_model(golden, compute, device)
  opt = torch.optim.SGD(model.parameters(), lr=LR)
  step = make_train_step(dense_loss, opt, model, device=device)
  dev = torch.device(device)
  losses = []
  for i in range(STEPS):
    cats = [torch.as_tensor(c, device=dev) for c in golden["cats"][i]]
    losses.append(float(step(
        torch.as_tensor(golden["numerical"][i], device=dev), cats,
        torch.as_tensor(golden["labels"][i], device=dev))))
  return losses, flax_paths(dlrm_state_dict_to_flax(model.state_dict()))


def compare_dense(golden: Dict[str, np.ndarray], losses: List[float],
                  got: Dict[str, np.ndarray],
                  compute: str = "bf16") -> Dict[str, float]:
  """Hold a :func:`replay_dense` result of the ``compute`` run to the
  golden within the train-golden tolerances; returns the worst loss error
  and the worst tensor error as a share of its largest update."""
  want_loss = golden[f"{compute}_losses"]
  np.testing.assert_allclose(losses, want_loss, **LOSS_TOL)
  want = dense_final(golden, compute)
  assert sorted(want) == sorted(got)
  return {"loss_max_abs_err": float(np.abs(np.asarray(losses)
                                            - want_loss).max()),
          "state_max_err_share": _update_share(dense_initial(golden), want,
                                               got, "params")}


def dense_world4_model(golden: Dict[str, np.ndarray], mesh,
                       overlap: str = "fused", chunks=None,
                       compute: str = "f32") -> DLRM:
  """The world-4 dense golden's DLRM in this rank of ``mesh``, holding
  this rank's blocks of the initial params, under the wire schedule
  ``overlap`` (the JAX model's plan is ``'none'``; every schedule gives
  the same values)."""
  vocab = [int(v) for v in golden["vocab"]]
  model = DLRM(vocab, int(golden["dim"]),
               bottom_mlp=tuple(int(w) for w in golden["bottom_mlp"]),
               top_mlp=tuple(int(w) for w in golden["top_mlp"]),
               num_numerical=golden["numerical"].shape[2],
               compute_dtype=(torch.float32 if compute == "f32"
                              else torch.bfloat16),
               world_size=int(golden["world"]), strategy="memory_balanced",
               row_slice=int(golden["row_slice"]),
               dense_row_threshold=int(golden["dense_row_threshold"]),
               overlap=overlap,
               exchange_chunks=int(golden["exchange_chunks"] if chunks is None
                                   else chunks), mesh=mesh)
  model.load_state_dict(dlrm_state_dict_from_flax(
      _tree_of(dense_initial(golden)), mesh=mesh))
  return model


def global_params(model: DLRM, mesh) -> Dict[str, np.ndarray]:
  """A world-N model's params as the global flax paths (``path ->
  numpy``): every rank's class blocks gathered, the MLPs as they are.
  Every rank calls it."""
  sd = {k: v.detach() for k, v in model.state_dict().items()}
  for name, p in model.embeddings.class_params().items():
    sd[f"embeddings.{name}"] = wire.gather_blocks(p.detach(), mesh)
  return flax_paths(dlrm_state_dict_to_flax(sd))


def replay_dense_world4(golden: Dict[str, np.ndarray], mesh,
                        overlap: str = "fused", chunks=None,
                        compute: str = "f32"):
  """Three steps of the port's world-4 ``make_train_step``
  (``torch.optim.SGD``) from the world-4 dense golden's initial params at
  ``compute``, then its eval step, in this rank of ``mesh`` (every rank
  calls it). Returns ``(losses, final params, preds)``: the params as
  global flax paths (:func:`global_params`) and the global batch's
  logits, the same on every rank."""
  model = dense_world4_model(golden, mesh, overlap, chunks, compute)
  opt = torch.optim.SGD(model.parameters(), lr=LR)
  step = make_train_step(dense_loss, opt, model, mesh=mesh)
  losses = []
  for i in range(STEPS):
    losses.append(float(step(*shard_batch(
        (golden["numerical"][i], list(golden["cats"][i]),
         golden["labels"][i]), mesh))))
  preds = make_eval_step(lambda m, n, c: m(n, c), model, mesh)(
      *shard_batch((golden["eval_numerical"], list(golden["eval_cats"])),
                   mesh))
  return losses, global_params(model, mesh), preds.cpu().numpy()


def compare_dense_world4(golden: Dict[str, np.ndarray], losses: List[float],
                         got: Dict[str, np.ndarray], preds: np.ndarray,
                         compute: str = "f32") -> Dict[str, float]:
  """:func:`compare_dense` for a :func:`replay_dense_world4` result of the
  ``compute`` run; the eval logits are held to the serve golden's bf16
  logit class (``serving.golden.PRED_TOL``): this small model's logits lie
  near 0, where one bf16 ulp of a term is a large share of the sum."""
  out = compare_dense(golden, losses, got, compute)
  want = golden[f"{compute}_preds"]
  np.testing.assert_allclose(preds, want, **PRED_TOL)
  out["preds_max_abs_err"] = float(np.abs(preds - want).max())
  return out


# duplicates add in another order on the two paths (and with atomics on the
# card): K1's tolerance, a share of each cell's absolute sum
DUP_SHARE = 1e-5
# the dense parameters: the f32 matmul class
DENSE_TOL = dict(rtol=1e-5, atol=1e-6)


def dense_vs_sparse_step(model: DLRM, plan: DistEmbeddingStrategy,
                         numerical, cats, labels,
                         lr: float = LR) -> Dict[str, float]:
  """One SGD step of the dense-autodiff ``make_train_step`` on ``model``
  (which owns its tables) and one SGD step of ``make_sparse_train_step``
  on fused buffers packed from the same tables, from one state. With
  plain SGD the two updates are one function (the JAX package's
  contract), so a gradient that lands on the wrong rows shows here.

  Every class row must agree within ``DUP_SHARE`` of each cell's absolute
  sum (``|row| + lr * sum |cotangent|`` over the step's occurrences: the
  duplicates add in another order), the dense parameters within the f32
  matmul class. ``model`` takes the dense step; hotness-1 inputs only.
  Returns the losses and the worst shares; raises ``AssertionError``."""
  from torch.func import functional_call

  from .parallel.lookup_engine import DistributedLookup

  dev = next(model.parameters()).device
  b = numerical.shape[0]
  if any(c.dim() != 1 for c in cats):
    raise ValueError("dense_vs_sparse_step takes hotness-1 inputs")
  tables = {n: p.detach().clone()
            for n, p in model.embeddings.class_params().items()}
  dense = {k: v.detach().clone() for k, v in model.state_dict().items()
           if not k.startswith("embeddings.")}
  rule = sgd_rule(lr)
  sgd = functools.partial(torch.optim.SGD, lr=lr)
  state = init_sparse_state(plan, {"embeddings": tables, **dense}, rule, sgd,
                            device=dev)
  engine = DistributedLookup(plan)
  layouts = engine.fused_layouts(rule)
  # the per-occurrence cotangents, for each cell's absolute sum
  ids_all = engine.route_ids(cats)
  with torch.no_grad():
    z_sparse, _ = engine.lookup_sparse_fused(state["fused"], layouts, ids_all,
                                             keep_aux=False)
  z_leaves = {bk: z.detach().requires_grad_(True)
              for bk, z in z_sparse.items()}
  acts = engine.finish_forward(
      z_leaves, {k: v.detach() for k, v in state["emb_dense"].items()},
      ids_all, b, lambda i: 1)
  bce_loss(functional_call(model, dense, (numerical, cats),
                           {"emb_acts": acts}), labels).backward()
  abs_sum = {}
  for bk, z in z_leaves.items():
    name = class_param_name(*bk.class_key)
    rows = tables[name].shape[0]
    ids = ids_all[bk].reshape(-1)
    keep = (ids >= 0) & (ids < rows)
    acc = abs_sum.setdefault(name, tables[name].abs())
    acc.index_add_(0, ids[keep], lr * z.grad.reshape(-1, z.shape[-1])[keep]
                   .abs())
  del z_leaves, acts
  # the two steps
  sparse_step = make_sparse_train_step(model, plan, bce_loss, sgd, rule)
  _, sparse_loss = sparse_step(state, numerical, cats, labels)
  opt = torch.optim.SGD(model.parameters(), lr=lr)
  dense_loss_ = make_train_step(dense_loss, opt, model, device=dev)(
      numerical, cats, labels)
  got_tables = {n: p.detach() for n, p in
                model.embeddings.class_params().items()}
  worst = 0.0
  for key in plan.class_keys:
    name = class_param_name(*key)
    if plan.classes[key].kind == "sparse":
      other = layouts[name].unpack(state["fused"][name])[0]
    else:
      other = state["emb_dense"][name].detach()
    diff = (got_tables[name] - other).abs()
    allow = DUP_SHARE * abs_sum.get(name, tables[name].abs())
    share = float((diff / allow.clamp(min=1e-30)).max())
    assert share <= 1.0, (
        f"{name}: the dense and the sparse step differ by {share} of "
        f"{DUP_SHARE} of a cell's absolute sum")
    worst = max(worst, share)
  dense_err = 0.0
  for k, v in model.state_dict().items():
    if k.startswith("embeddings."):
      continue
    other = state["dense"][k].detach()
    torch.testing.assert_close(v, other, **DENSE_TOL)
    dense_err = max(dense_err, float((v - other).abs().max()))
  return {"dense_loss": float(dense_loss_), "sparse_loss": float(sparse_loss),
          "class_max_dup_share": worst, "dense_max_abs_err": dense_err}


# ---------------------------------------------------------------------------
# the tiered golden (tiering.TieredTrainer, a host-tier class)
# ---------------------------------------------------------------------------

TIERED_PATH = GOLDEN_PATH.with_name("torch_train_tiered_golden.npz")
TIERED_VOCAB = (4000, 300, 120, 40)
TIERED_DIM = 16
TIERED_BOTTOM = (32, 16)
TIERED_TOP = (32, 1)
TIERED_NUM = 13
TIERED_BATCH = 64
TIERED_HOST_ROWS = 1000  # the 4,000-row table is host-tier
TIERED_LR = 0.05
TIERED_ALPHA = 1.05
TIERED_SEED = 0
# a staging region the first batch's cold rows overflow (a spill) and a
# re-rank after the second step
TIERED_CONFIG = dict(cache_fraction=0.25, staging_grps=8, rerank_interval=2)


def tiered_plan(table_config=TableConfig, strategy=DistEmbeddingStrategy):
  """The tiered golden's plan (of this package, or of another with its
  ``TableConfig`` and ``DistEmbeddingStrategy``)."""
  return strategy(
      [table_config(input_dim=v, output_dim=TIERED_DIM)
       for v in TIERED_VOCAB], 1, "basic", dense_row_threshold=0,
      host_row_threshold=TIERED_HOST_ROWS)


def tiered_initial_tables(plan, seed: int = TIERED_SEED
                          ) -> Dict[str, np.ndarray]:
  """Every class's simple-layout table, uniform in +-0.05 from
  ``np.random.RandomState(seed)``."""
  return ragged_initial_tables(plan, seed)


def tiered_model(device="cuda") -> DLRM:
  return DLRM(list(TIERED_VOCAB), TIERED_DIM, bottom_mlp=TIERED_BOTTOM,
              top_mlp=TIERED_TOP, num_numerical=TIERED_NUM, tables=False,
              device=device)


def tiered_golden_state(golden: Dict[str, np.ndarray]):
  """``(initial tables, final tables, final dense params)`` of the tiered
  golden: the tables rebuilt (checked against the stored sums), the final
  ones as the initial plus the stored updates, the dense params as the
  port's state_dict."""
  plan = tiered_plan()
  tables = tiered_initial_tables(plan, int(golden["seed"]))
  for name, t in tables.items():
    want = golden[f"tiered_init_sum/{name}"]
    if not np.isclose(np.float64(t.sum(dtype=np.float64)), want, rtol=1e-12,
                      atol=1e-9):
      raise AssertionError(
          f"the rebuilt table {name} differs from the golden's: numpy's "
          "RandomState stream changed?")
  final = {k: tables[k] + v
           for k, v in _entries(golden, "tables_moved").items()}
  dense = {k: v.numpy() for k, v in dlrm_state_dict_from_flax(
      flax_tree(golden, "dense3")).items()}
  return tables, final, dense


def tiered_batches(golden: Dict[str, np.ndarray]) -> list:
  """The golden's global host batches, numpy."""
  n = sum(1 for k in golden if k.startswith("cat/"))
  return [(golden["numerical"][i], [golden[f"cat/{j}"][i] for j in range(n)],
           golden["labels"][i]) for i in range(STEPS)]


def replay_tiered(golden: Dict[str, np.ndarray], device="cuda"):
  """Three guarded steps of the port's ``TieredTrainer`` from the tiered
  golden's initial state on ``device``: returns ``(losses, summary,
  final)`` with the trainer's metrics summary and ``final = {'tables':
  reconciled simple-layout tables, 'dense': dense params}`` as f32 numpy.
  """
  from .tiering import (
      HostTierStore,
      TieredTrainer,
      TieringConfig,
      TieringPlan,
      init_tiered_state_from_params,
      unpack_tiered_state,
  )
  plan = tiered_plan()
  tables, _, _ = tiered_golden_state(golden)
  rule = adagrad_rule(TIERED_LR)
  factory = functools.partial(Adagrad, lr=TIERED_LR)
  tplan = TieringPlan(plan, rule, TieringConfig(**TIERED_CONFIG))
  store = HostTierStore(tplan)
  params = dict(dlrm_state_dict_from_flax(flax_tree(golden, "dense0")))
  params["embeddings"] = tables
  state = init_tiered_state_from_params(tplan, store, rule, params, factory,
                                        device=device)
  trainer = TieredTrainer(tiered_model(device), tplan, store, bce_loss,
                          factory, rule, None, state, guard=True,
                          device=device)
  losses = trainer.run(tiered_batches(golden))
  trainer.flush()
  got = unpack_tiered_state(tplan, store, rule, trainer.state)
  final = {"tables": {k: v.detach().cpu().numpy()
                      for k, v in got["embeddings"].items()},
           "dense": {k: v.detach().cpu().numpy() for k, v in got.items()
                     if k != "embeddings"}}
  return losses, trainer.metrics_summary(), final


def compare_tiered(golden: Dict[str, np.ndarray], losses: List[float],
                   summary: Dict, got: Dict[str, Dict[str, np.ndarray]]
                   ) -> Dict[str, float]:
  """Hold a :func:`replay_tiered` result to the golden: losses within
  :data:`LOSS_TOL`, the hit counters and spill steps exact, each final
  table and dense tensor within :data:`UPDATE_TOL` of its largest
  update."""
  np.testing.assert_allclose(losses, golden["losses"], **LOSS_TOL)
  for key in golden:
    if key.startswith("hits/"):
      name = key.split("/", 1)[1]
      m = summary["per_class"][name]
      assert [m["hot"], m["staged"], m["missed"], m["total"]] == \
          golden[key].tolist(), (name, m, golden[key])
  assert summary["spill_steps"] == int(golden["spill_steps"])
  tables, final, dense = tiered_golden_state(golden)
  dense0 = {k: v.numpy() for k, v in dlrm_state_dict_from_flax(
      flax_tree(golden, "dense0")).items()}
  worst = max(_update_share(tables, final, got["tables"], "tables"),
              _update_share(dense0, dense, got["dense"], "dense"))
  return {"loss_max_abs_err": float(np.abs(np.asarray(losses)
                                            - golden["losses"]).max()),
          "state_max_err_share": worst}


# ---------------------------------------------------------------------------
# the dynamic-vocabulary golden
# ---------------------------------------------------------------------------

DYNVOCAB_PATH = GOLDEN_PATH.with_name("torch_train_dynvocab_golden.npz")
DYNVOCAB_VOCAB = (3, 10, 24, 40, 64, 100, 160, 300)
DYNVOCAB_DIM = 32
DYNVOCAB_BOTTOM = (64, 32)
DYNVOCAB_TOP = (64, 32, 1)
DYNVOCAB_NUM = 13
DYNVOCAB_BATCH = 128
DYNVOCAB_STEPS = 5
DYNVOCAB_DENSE_ROW_THRESHOLD = 32
DYNVOCAB_KNOBS = dict(oov="allocate", admit_threshold=2, evict_ttl=2)
DYNVOCAB_SKETCH_WIDTH = 1 << 10  # keeps the file's sketch state small
DYNVOCAB_RAW_SPACE = 4  # raw ids per allocatable row of a sparse table
DYNVOCAB_ALPHA = 1.05
DYNVOCAB_SEED = 0

_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def raw_keys(ranks: np.ndarray, salt: int) -> np.ndarray:
  """Distinct-looking raw 63-bit ids for popularity ranks: a splitmix64
  finalizer of ``ranks + salt * 2^40`` with the sign bit cleared (raw
  ids are non-negative; the hash is a bijection before the clear, so
  collisions are vanishingly rare). Numpy, deterministic."""
  x = (np.asarray(ranks, np.int64).astype(np.uint64)
       + np.uint64(salt) * np.uint64(1 << 40))
  x ^= x >> np.uint64(30)
  x *= _MIX1
  x ^= x >> np.uint64(27)
  x *= _MIX2
  x ^= x >> np.uint64(31)
  return (x & np.uint64(0x7FFFFFFFFFFFFFFF)).astype(np.int64)


def dynvocab_plan(table_config=TableConfig, strategy=DistEmbeddingStrategy):
  """The golden's plan, from either package's ``TableConfig`` and
  ``DistEmbeddingStrategy``."""
  return strategy([table_config(input_dim=v, output_dim=DYNVOCAB_DIM)
                   for v in DYNVOCAB_VOCAB], 1, "basic",
                  dense_row_threshold=DYNVOCAB_DENSE_ROW_THRESHOLD,
                  **DYNVOCAB_KNOBS)


def dynvocab_batches(steps: int = DYNVOCAB_STEPS,
                     batch: int = DYNVOCAB_BATCH, seed: int = DYNVOCAB_SEED):
  """Global host batches (numpy): raw power-law ids for the sparse
  tables (more than the dense-class threshold of rows), in-range ids for
  the dense-class ones, normal features, random labels."""
  from .models.synthetic import power_law_ids
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(steps):
    cats = []
    for t, v in enumerate(DYNVOCAB_VOCAB):
      if v > DYNVOCAB_DENSE_ROW_THRESHOLD:
        ranks = power_law_ids(rng, batch, 1, DYNVOCAB_RAW_SPACE * v,
                              DYNVOCAB_ALPHA)[:, 0]
        cats.append(raw_keys(ranks, t))
      else:
        cats.append(rng.integers(0, v, batch).astype(np.int64))
    out.append((rng.standard_normal((batch, DYNVOCAB_NUM))
                .astype(np.float32), cats,
                rng.integers(0, 2, batch).astype(np.float32)))
  return out


def replay_dynvocab(golden: Dict[str, np.ndarray], device="cuda"):
  """The golden's guarded steps through the port's ``DynVocabTrainer``
  from its initial state on ``device``: returns ``(losses, final,
  translated, trainer)`` with the final state as f32 numpy (keyed as
  :func:`final_state`) and each step's translated ids."""
  from .dynvocab import DynVocabTrainer, DynVocabTranslator
  plan = dynvocab_plan()
  model = DLRM(list(DYNVOCAB_VOCAB), DYNVOCAB_DIM, bottom_mlp=DYNVOCAB_BOTTOM,
               top_mlp=DYNVOCAB_TOP, num_numerical=DYNVOCAB_NUM,
               compute_dtype=torch.bfloat16, tables=False, device=device)
  rule = sgd_rule(LR)
  factory = functools.partial(torch.optim.SGD, lr=LR)
  state = train_state_from_flax(initial_state(golden), device=device)
  translator = DynVocabTranslator(plan, rule,
                                  sketch_width=DYNVOCAB_SKETCH_WIDTH)
  trainer = DynVocabTrainer(model, plan, translator, bce_loss, factory, rule,
                            None, state, guard=True, device=device)
  translated = []
  translate = trainer.engine.translate_dynamic_ids

  def recorded(cats, tr):
    out = translate(cats, tr)
    translated.append([np.asarray(c).copy() for c in out[0]])
    return out

  trainer.engine.translate_dynamic_ids = recorded
  losses = trainer.run(dynvocab_golden_batches(golden))
  got = {part: {k: v.detach().cpu().to(torch.float32).numpy()
                for k, v in trainer.state[part].items()}
         for part in ("fused", "emb_dense", "dense")}
  return losses, got, translated, trainer


def dynvocab_golden_batches(golden: Dict[str, np.ndarray]):
  n = sum(1 for k in golden if k.startswith("cat/"))
  return [(golden["numerical"][i],
           [golden[f"cat/{j}"][i] for j in range(n)], golden["labels"][i])
          for i in range(golden["numerical"].shape[0])]


def dynvocab_final_state(golden: Dict[str, np.ndarray]) -> Dict[str, Dict]:
  return {"fused": _entries(golden, "fused_final"),
          "emb_dense": _entries(golden, "emb_dense_final"),
          "dense": {k: v.numpy() for k, v in dlrm_state_dict_from_flax(
              flax_tree(golden, "dense_final")).items()}}


def compare_dynvocab(golden: Dict[str, np.ndarray], losses: List[float],
                     got: Dict[str, Dict[str, np.ndarray]], translated,
                     trainer) -> Dict[str, float]:
  """Hold a :func:`replay_dynvocab` result to the golden: every step's
  translated ids, the translator's state and the lifecycle counters
  bit-equal; losses within :data:`LOSS_TOL`, each final tensor within
  :data:`UPDATE_TOL` of its largest update. Raises ``AssertionError``
  naming the first difference."""
  n = sum(1 for k in golden if k.startswith("tcat/"))
  assert len(translated) == golden["numerical"].shape[0]
  for i, cats in enumerate(translated):
    for j in range(n):
      np.testing.assert_array_equal(cats[j], golden[f"tcat/{j}"][i],
                                    err_msg=f"step {i} input {j}")
  vocab = trainer.translator.state_arrays()
  want = {k.split("/", 1)[1]: v for k, v in golden.items()
          if k.startswith("vocab/")}
  assert sorted(vocab) == sorted(want)
  for k, v in want.items():
    np.testing.assert_array_equal(vocab[k], v, err_msg=k)
  for k, v in golden.items():
    if k.startswith("vocab_totals/"):
      name = k.split("/", 1)[1]
      np.testing.assert_array_equal(trainer.vocab_totals[name], v,
                                    err_msg=name)
  out = _compare(golden["losses"], initial_state(golden),
                 dynvocab_final_state(golden), losses, got)
  out["rows_zeroed"] = trainer.rows_zeroed
  return out


# ---------------------------------------------------------------------------
# the delta stream's golden
# ---------------------------------------------------------------------------

STREAM_PATH = GOLDEN_PATH.with_name("torch_stream_golden.npz")
STREAM_VOCAB = (3, 10, 24, 40, 64, 100, 160, 300)
STREAM_DIM = 32
STREAM_BOTTOM = (64, 32)
STREAM_TOP = (64, 32, 1)
STREAM_NUM = 13
STREAM_BATCH = 64
STREAM_PROBE = 32
STREAM_STEPS = 6
STREAM_BASE_AFTER = 3  # the base after the third batch, then a delta a batch
STREAM_DENSE_ROW_THRESHOLD = 32
STREAM_QUANTIZE = "f32"
STREAM_ALPHA = 1.05
STREAM_SEED = 0


def stream_plan(table_config=TableConfig, strategy=DistEmbeddingStrategy):
  """The stream golden's plan, from either package's ``TableConfig`` and
  ``DistEmbeddingStrategy``."""
  return strategy([table_config(input_dim=v, output_dim=STREAM_DIM)
                   for v in STREAM_VOCAB], 1, "basic",
                  dense_row_threshold=STREAM_DENSE_ROW_THRESHOLD)


def _stream_batch(rng, b: int):
  cats = [(power_law_ids(rng, b, 1, v, STREAM_ALPHA)[:, 0]
           if v > STREAM_DENSE_ROW_THRESHOLD
           else rng.integers(0, v, b)).astype(np.int32)
          for v in STREAM_VOCAB]
  return (rng.standard_normal((b, STREAM_NUM)).astype(np.float32), cats,
          rng.integers(0, 2, b).astype(np.float32))


def stream_batches(steps: int = STREAM_STEPS, batch: int = STREAM_BATCH,
                   seed: int = STREAM_SEED):
  """Global host batches (numpy): power-law ids for the sparse tables,
  uniform ones for the dense-class tables."""
  rng = np.random.default_rng(seed)
  return [_stream_batch(rng, batch) for _ in range(steps)]


def stream_probe(seed: int = STREAM_SEED + 1):
  """The request whose predictions the golden records after each fold."""
  num, cats, _ = _stream_batch(np.random.default_rng(seed), STREAM_PROBE)
  return num, cats


def _stream_model(device) -> DLRM:
  return DLRM(list(STREAM_VOCAB), STREAM_DIM, bottom_mlp=STREAM_BOTTOM,
              top_mlp=STREAM_TOP, num_numerical=STREAM_NUM, tables=False,
              device=device)


def replay_stream(golden: Dict[str, np.ndarray], device="cuda"
                  ) -> Dict[str, np.ndarray]:
  """The golden's loop through the port on ``device``: its sparse steps
  from the initial state, a ``streaming.DeltaPublisher`` observing every
  batch (the base after :data:`STREAM_BASE_AFTER`, a delta after each
  later one) and a
  ``DeltaSubscriber`` folding each delta into its own engine. Returns
  the arrays keyed as the golden's (``delta<i>/idx|data/...``,
  ``preds<i>``)."""
  import os
  import tempfile

  from .streaming import DeltaPublisher, DeltaSubscriber, \
      RowGenerationTracker
  plan = stream_plan()
  rule = sgd_rule(LR)
  step = make_sparse_train_step(
      _stream_model(device), plan, bce_loss,
      functools.partial(torch.optim.SGD, lr=LR), rule)
  state = train_state_from_flax(initial_state(golden), device=device)
  n = len(STREAM_VOCAB)
  probe = (golden["probe_numerical"],
           [golden[f"probe_cat/{j}"] for j in range(n)])
  dev = torch.device(device)
  out: Dict[str, np.ndarray] = {}
  with tempfile.TemporaryDirectory() as tmp:
    pub = DeltaPublisher(tmp, plan, rule, RowGenerationTracker(plan),
                         quantize=STREAM_QUANTIZE)
    sub = None
    for i in range(golden["numerical"].shape[0]):
      cats = [golden[f"cat/{j}"][i] for j in range(n)]
      pub.observe_batch(cats)
      state, _ = step(state, torch.as_tensor(golden["numerical"][i],
                                             device=dev),
                      [torch.as_tensor(c, device=dev) for c in cats],
                      torch.as_tensor(golden["labels"][i], device=dev))
      if i < STREAM_BASE_AFTER - 1:
        continue
      if i == STREAM_BASE_AFTER - 1:
        pub.publish_base(state)
        sub = DeltaSubscriber.from_artifact(_stream_model(device), plan, tmp,
                                            heartbeat=False, device=device)
      else:
        path = pub.publish_delta(state)
        assert sub.poll_once() == 1, sub.last_refusal
        for f in sorted(os.listdir(path)):
          if f.startswith("rows_"):
            with np.load(os.path.join(path, f)) as z:
              out[f"delta{i}/idx/{f[5:-4]}"] = np.asarray(z["idx"])
              out[f"delta{i}/data/{f[5:-4]}"] = np.asarray(z["data"])
      out[f"preds{i}"] = np.asarray(sub.predict(*probe), np.float32)
  return out


def compare_stream(golden: Dict[str, np.ndarray],
                   got: Dict[str, np.ndarray]) -> Dict[str, float]:
  """Hold a :func:`replay_stream` result to the golden: the same delta
  files, each row set bit-equal, each delta's rows of a class within
  :data:`UPDATE_TOL` of the class's largest update at that delta (the
  initial table with the golden's deltas folded in, against the initial
  table: the train golden's per-tensor rule), and every probe prediction
  within :data:`PRED_TOL`. Raises ``AssertionError`` naming the first
  difference."""
  plan = stream_plan()
  want_keys = sorted(k for k in golden
                     if k.startswith("delta") or k.startswith("preds"))
  assert sorted(got) == want_keys, (sorted(got), want_keys)
  init = {}
  for key_c in plan.class_keys:
    name = class_param_name(*key_c)
    if plan.classes[key_c].kind == "sparse":
      lay = PackedLayout(rows=padded_rows(plan, key_c), width=STREAM_DIM,
                         n_aux=0)
      init[name] = np.asarray(lay.unpack(
          initial_state(golden)["fused"][name])[0])
  folded = {name: t.copy() for name, t in init.items()}
  worst, pred_err, deltas = 0.0, 0.0, set()
  for key in sorted(want_keys, key=lambda k: (k[:6], k)):
    if key.startswith("preds"):
      np.testing.assert_allclose(got[key], golden[key], err_msg=key,
                                 **PRED_TOL)
      pred_err = max(pred_err, float(np.abs(got[key] - golden[key]).max()))
      continue
    tag, kind, fname = key.split("/")
    deltas.add(tag)
    if kind == "idx":
      np.testing.assert_array_equal(got[key], golden[key], err_msg=key)
      continue
    name = fname.rsplit("_r", 1)[0]
    folded[name][golden[f"{tag}/idx/{fname}"]] = golden[key]
    moved = float(np.abs(folded[name] - init[name]).max())
    err = float(np.abs(got[key] - golden[key]).max())
    assert moved > 0.0, f"{key} never moved in the golden"
    share = err / moved
    assert share <= UPDATE_TOL, (
        f"{key}: off by {err} against a largest update of {moved} "
        f"({share:.3%} > {UPDATE_TOL:.0%})")
    worst = max(worst, share)
  return {"rows_max_err_share": worst, "preds_max_abs_err": pred_err,
          "deltas": len(deltas)}
