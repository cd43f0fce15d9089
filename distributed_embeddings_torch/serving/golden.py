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

``tests/data/torch_serve_tiered_golden.npz`` is the tiered counterpart:
the tiered train golden's DLRM (``train_golden.tiered_plan``: four D=16
tables, the 4,000-row one host-tier) after its three JAX training steps,
frozen by the JAX ``freeze(store=)`` to f32, int8 and fp8 (the cold
images, rankings and counts, the device-tier blocks, the dense
parameters), and the JAX tiered ``ServeEngine``'s predictions,
activations and ``[hot, staged, missed, valid]`` counters on two
power-law requests, under a serve cache and under a staging region that
spills. ``tests/test_torch_serve_tiered_golden.py`` regenerates it and
holds the port to it on the CPU (:func:`replay_tiered`,
:func:`compare_tiered`); ``chip_smoke.py`` replays it on the card.
"""

from __future__ import annotations

import dataclasses
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


# ---------------------------------------------------------------------------
# the tiered serve golden (a host-tier class behind a device hot cache)
# ---------------------------------------------------------------------------

TIERED_PATH = GOLDEN_PATH.with_name("torch_serve_tiered_golden.npz")
TIERED_QUANTIZE = ("f32", "int8", "fp8")
# the serve cache and staging: a quarter of the host-tier class's serve
# rows resident; the spill engine stages two rows, so a request's cold rows
# overflow into a larger bucket
TIERED_SERVE_CONFIG = dict(cache_fraction=0.25, staging_grps=16)
TIERED_SPILL_CONFIG = dict(cache_fraction=0.25, staging_grps=2)
# CPU predictions against the JAX engine's (f32 MLPs, both on the CPU)
TIERED_CPU_PRED_TOL = dict(rtol=1e-5, atol=1e-6)


def _entries(golden: Dict[str, np.ndarray], prefix: str
             ) -> Dict[str, np.ndarray]:
  n = len(prefix) + 1
  return {k[n:]: v for k, v in golden.items() if k.startswith(prefix + "/")}


def tiered_requests(golden: Dict[str, np.ndarray]) -> list:
  """The golden's requests ``[(numerical, cats)]``, numpy."""
  n = sum(1 for k in golden if k.startswith("numerical/"))
  return [(golden[f"numerical/{i}"],
           [v for _, v in sorted(_entries(golden, f"cat/{i}").items(),
                                 key=lambda kv: int(kv[0]))])
          for i in range(n)]


def tiered_frozen(golden: Dict[str, np.ndarray], quantize: str
                  ) -> FrozenTables:
  """The port's tiered ``FrozenTables`` from the golden's frozen arrays
  (world 1): the device-tier blocks, the host-tier cold images with their
  ranking and counts, the dense parameters."""
  from ..ops.packed_table import adagrad_rule
  from ..train_golden import TIERED_LR, tiered_plan
  plan = tiered_plan()
  cold = _entries(golden, f"cold/{quantize}")
  meta, _ = serve_class_meta(plan, adagrad_rule(TIERED_LR), quantize,
                             frozenset(cold))
  return FrozenTables(
      quantize=quantize, step=int(golden["step"]), meta=meta,
      device_blocks={n: [torch.tensor(b)] for n, b in _entries(
          golden, f"blocks/{quantize}").items()},
      dense=dlrm_state_dict_from_flax(flax_params(golden)),
      emb_dense={k: torch.tensor(v)
                 for k, v in _entries(golden, "emb_dense").items()},
      host_images={n: [np.array(v)] for n, v in cold.items()},
      ranking={n: [np.array(v)] for n, v in _entries(
          golden, f"ranking/{quantize}").items()},
      counts={n: [np.array(v)] for n, v in _entries(
          golden, f"counts/{quantize}").items()})


def replay_tiered(golden: Dict[str, np.ndarray], quantize: str,
                  device="cuda") -> Dict[str, list]:
  """One image of the tiered serve golden through the port's tiered
  ``ServeEngine`` on ``device`` (with metrics), under
  :data:`TIERED_SERVE_CONFIG` and the spilling :data:`TIERED_SPILL_CONFIG`:
  per request the predictions, the activations ``[B, F * D]`` and the
  ``[hot, staged, missed, valid]`` counters, and each engine's spill
  dispatches, as numpy."""
  from ..train_golden import tiered_model, tiered_plan
  from .engine import ServeTierConfig
  plan = tiered_plan()
  frozen = tiered_frozen(golden, quantize)
  acts_frozen = dataclasses.replace(frozen, dense={})
  out: Dict[str, list] = {}
  for tag, cfg in (("serve", TIERED_SERVE_CONFIG),
                   ("spill", TIERED_SPILL_CONFIG)):
    tc = ServeTierConfig(**cfg)
    eng = ServeEngine(tiered_model(device), plan, frozen, device=device,
                      tier_config=tc, with_metrics=True)
    acts = ServeEngine(EmbActs(), plan, acts_frozen, device=device,
                       tier_config=tc)
    rows = []
    for numerical, cats in tiered_requests(golden):
      preds, m = eng.predict(numerical, cats)
      a = acts.predict(numerical, cats)  # [F, B, D]
      rows.append({"preds": preds,
                   "acts": np.concatenate(list(a), axis=-1),
                   "tier": m["tier"]})
    out[tag] = rows
    out[f"{tag}_spill_dispatches"] = [eng.prefetcher.spill_steps]
  return out


def compare_tiered(golden: Dict[str, np.ndarray], quantize: str,
                   got: Dict[str, list], pred_tol=PRED_TOL) -> float:
  """Hold a :func:`replay_tiered` result to the golden: activations
  bit-equal, counters and spill dispatches exact (``missed == 0``),
  predictions within ``pred_tol`` (:data:`PRED_TOL` on the card, whose
  interaction runs in bf16; :data:`TIERED_CPU_PRED_TOL` on the CPU).
  Returns the largest prediction difference."""
  worst = 0.0
  for tag in ("serve", "spill"):
    assert got[f"{tag}_spill_dispatches"][0] == int(
        golden[f"{tag}_spill_dispatches/{quantize}"]), tag
    for i, row in enumerate(got[tag]):
      key = f"{tag}/{quantize}/{i}"
      want_a = golden[f"acts/{key}"]
      assert row["acts"].shape == want_a.shape, key
      assert np.array_equal(row["acts"].view(np.int32),
                            want_a.view(np.int32)), \
          f"{key}: activations differ by {np.abs(row['acts'] - want_a).max()}"
      for name, want_m in _entries(golden, f"tier/{key}").items():
        assert row["tier"][name].tolist() == want_m.tolist(), (key, name)
        assert int(want_m[2]) == 0, (key, name)
      want_p = golden[f"preds/{key}"]
      np.testing.assert_allclose(row["preds"], want_p, err_msg=key,
                                 **pred_tol)
      worst = max(worst, float(np.abs(row["preds"] - want_p).max()))
  return worst
