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
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from .convert import dlrm_state_dict_from_flax, train_state_from_flax
from .layers.embedding import TableConfig
from .layers.planner import DistEmbeddingStrategy
from .models.dlrm import DLRM, bce_loss, dlrm_embedding_plan
from .ops.packed_table import sgd_rule
from .parallel import wire
from .training import make_sparse_eval_step, make_sparse_train_step, shard_batch

GOLDEN_PATH = (Path(__file__).resolve().parents[1] / "tests" / "data" /
               "torch_train_golden.npz")
WORLD4_PATH = GOLDEN_PATH.with_name("torch_train_world4_golden.npz")
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


def _compare(want_loss, initial, want, losses, got) -> Dict[str, float]:
  np.testing.assert_allclose(losses, want_loss, **LOSS_TOL)
  init = train_state_from_flax(initial, device="cpu")
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
