"""Replay the JAX package's DLRM train golden through the port.

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
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from .convert import dlrm_state_dict_from_flax, train_state_from_flax
from .models.dlrm import DLRM, bce_loss, dlrm_embedding_plan
from .ops.packed_table import sgd_rule
from .training import make_sparse_train_step

GOLDEN_PATH = (Path(__file__).resolve().parents[1] / "tests" / "data" /
               "torch_train_golden.npz")
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
  want_loss = golden["losses"]
  np.testing.assert_allclose(losses, want_loss, **LOSS_TOL)
  init = train_state_from_flax(initial_state(golden), device="cpu")
  want = final_state(golden)
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
