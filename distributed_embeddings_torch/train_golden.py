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
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from .convert import (
    dlrm_state_dict_from_flax,
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
    synthetic_plan,
)
from .ops.packed_table import adagrad_rule, sgd_rule
from .parallel import wire
from .parallel.lookup_engine import class_param_name, padded_rows
from .training import (
    Adagrad,
    init_sparse_state,
    make_sparse_eval_step,
    make_sparse_train_step,
    shard_batch,
)

GOLDEN_PATH = (Path(__file__).resolve().parents[1] / "tests" / "data" /
               "torch_train_golden.npz")
WORLD4_PATH = GOLDEN_PATH.with_name("torch_train_world4_golden.npz")
ZOO_PATH = GOLDEN_PATH.with_name("torch_train_zoo_golden.npz")
LR = 0.1
STEPS = 3
# per-step losses
LOSS_TOL = dict(rtol=1e-2, atol=1e-3)
# per final tensor: max |got - want| <= UPDATE_TOL * max |want - initial|
UPDATE_TOL = 0.05


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


def replay(golden: Dict[str, np.ndarray], device="cuda"
           ) -> Tuple[List[float], Dict[str, Dict[str, np.ndarray]]]:
  """Three steps of the port's sparse train step from the golden's
  initial state on ``device``: returns ``(losses, final state)`` with the
  final state as numpy, keyed as :func:`final_state`."""
  vocab = [int(v) for v in golden["vocab"]]
  dim = int(golden["dim"])
  plan = dlrm_embedding_plan(
      vocab, dim, dense_row_threshold=int(golden["dense_row_threshold"]))
  model = DLRM(vocab, dim,
               bottom_mlp=tuple(int(w) for w in golden["bottom_mlp"]),
               top_mlp=tuple(int(w) for w in golden["top_mlp"]),
               num_numerical=golden["numerical"].shape[2],
               compute_dtype=torch.bfloat16, device=device)
  state = train_state_from_flax(initial_state(golden), device=device)
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
  got = {part: {k: v.detach().cpu().numpy() for k, v in state[part].items()}
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
    for name, w in tensors.items():
      moved = float(np.abs(w - init[part][name].numpy()).max())
      err = float(np.abs(got[part][name] - w).max())
      assert moved > 0.0, f"{part}/{name} never changed in the golden"
      share = err / moved
      assert share <= UPDATE_TOL, (
          f"{part}/{name}: off by {err} against a largest update of "
          f"{moved} ({share:.3%} > {UPDATE_TOL:.0%})")
      worst = max(worst, share)
  return {"loss_max_abs_err": float(np.abs(np.asarray(losses)
                                            - want_loss).max()),
          "state_max_err_share": worst}


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
                              else torch.bfloat16), device=mesh.device)
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
  model = SyntheticModel(SYNTHETIC_MODELS[ZOO_MODEL], device=device)
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
  got = {part: {k: v.detach().cpu().numpy() for k, v in state[part].items()}
         for part in ("fused", "emb_dense", "dense")}
  return losses, got


def compare_zoo(golden: Dict[str, np.ndarray], losses: List[float],
                got: Dict[str, Dict[str, np.ndarray]]) -> Dict[str, float]:
  """:func:`compare` for a :func:`replay_zoo` result."""
  initial, final = zoo_golden_state(golden)
  return _compare(golden["losses"], initial, final, losses, got,
                  zoo_train_state_from_flax)
