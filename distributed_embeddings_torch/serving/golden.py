"""Replay the JAX package's DLRM serve golden through the port.

``tests/data/torch_serve_golden.npz`` holds, for a small DLRM (8 tables,
D=128, B=256, bf16 compute, SGD train state) served by the JAX package on
the CPU: the request, the flax dense params, the frozen f32 and int8
blocks with the dense-class tables, and per image the embedding
activations and the predictions of the JAX serve step.
``tests/test_torch_golden.py`` regenerates it with JAX and holds the port
to it on the CPU; ``chip_smoke.py`` replays it on the card. The
activations must be bit-equal (gather + one dequant multiply on both
sides); the predictions agree within :data:`PRED_TOL` (bf16 compute: the
two frameworks round the MLP and interaction outputs to bf16 at the same
places, but a pre-rounding value that lands within an f32 summation-order
error of a bf16 rounding boundary flips by one bf16 ulp, and the flip
carries through the top MLP into the logit).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..convert import dlrm_state_dict_from_flax
from ..models.dlrm import DLRM, dlrm_embedding_plan
from ..ops.packed_table import sgd_rule
from .engine import ServeEngine, make_serve_step, shard_batch
from .export import FrozenTables, serve_class_meta

GOLDEN_PATH = (Path(__file__).resolve().parents[2] / "tests" / "data" /
               "torch_serve_golden.npz")
QUANTIZE = ("f32", "int8")
PRED_TOL = dict(rtol=3e-2, atol=3e-2)


class EmbActs(nn.Module):
  """Model stub for a serve step: returns the embedding activations it is
  handed, stacked ``[F, B, D]``."""

  def forward(self, numerical, cats, emb_acts=None):
    del numerical, cats
    return torch.stack(list(emb_acts))


def load(path=GOLDEN_PATH) -> Dict[str, np.ndarray]:
  with np.load(path) as z:
    return {k: z[k] for k in z.files}


def flax_params(golden: Dict[str, np.ndarray]) -> Dict:
  """The ``params/<mlp>/<layer>/<leaf>`` entries -> the flax tree."""
  tree: Dict = {}
  for key, arr in golden.items():
    if key.startswith("params/"):
      mlp, layer, leaf = key.split("/")[1:]
      tree.setdefault(mlp, {}).setdefault(layer, {})[leaf] = arr
  return tree


def plan_of(golden: Dict[str, np.ndarray]):
  return dlrm_embedding_plan(
      [int(v) for v in golden["vocab"]], int(golden["dim"]),
      dense_row_threshold=int(golden["dense_row_threshold"]))


def frozen_of(golden: Dict[str, np.ndarray], plan,
              quantize: str) -> FrozenTables:
  """The port's ``FrozenTables`` from the golden's frozen blocks (world
  1); the serve geometry comes from the port's own plan."""
  meta, _ = serve_class_meta(plan, sgd_rule(0.0), quantize)
  return FrozenTables(
      quantize=quantize, step=0, meta=meta,
      device_blocks={n: [torch.tensor(golden[f"blocks/{quantize}/{n}"])]
                     for n in meta},
      dense=dlrm_state_dict_from_flax(flax_params(golden)),
      emb_dense={k.split("/", 1)[1]: torch.tensor(v)
                 for k, v in golden.items() if k.startswith("emb_dense/")})


def replay(golden: Dict[str, np.ndarray], quantize: str,
           device="cuda") -> Tuple[np.ndarray, np.ndarray]:
  """One image through the port's ``ServeEngine`` on ``device``: returns
  ``(acts [F, B, D], preds [B])`` as numpy."""
  plan = plan_of(golden)
  model = DLRM([int(v) for v in golden["vocab"]], int(golden["dim"]),
               bottom_mlp=tuple(int(w) for w in golden["bottom_mlp"]),
               top_mlp=tuple(int(w) for w in golden["top_mlp"]),
               num_numerical=golden["numerical"].shape[1],
               compute_dtype=torch.bfloat16, tables=False, device=device)
  eng = ServeEngine(model, plan, frozen_of(golden, plan, quantize),
                    device=device)
  cats = list(golden["cats"])
  preds = eng.predict(golden["numerical"], cats)
  acts_step = make_serve_step(EmbActs(), plan, eng.meta)
  numerical, cats_dev = shard_batch((golden["numerical"], tuple(cats)),
                                    None, eng.device)
  acts = acts_step(eng.state, numerical, cats_dev).cpu().numpy()
  return acts, preds
