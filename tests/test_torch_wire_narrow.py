"""The port's world-4 sparse train step on the narrow wires with the
deduplicated exchange, against the JAX package's.

The cell of ``tests/torch_wire_cases.py``, three SGD steps from one JAX
state, ``dedup_exchange=True`` with ``wire_dtype='bf16'`` (fused, 2
chunks) and ``'fp8'`` (fused, 2 chunks; pipelined, 2 chunks: the scale
windows differ between the two), on four gloo processes and on a
4-device CPU mesh. The narrowing itself is bit-exact against the JAX
codec (``tests/test_torch_wire.py``); the trajectories, the final state
and the eval predictions are held in the f32 class (rtol 1e-5, atol
1e-6) against the JAX run of the same knobs. Each narrow run also stays
within the JAX tests' loose bounds of the f32 run (losses within 5e-3
for bf16 and 5e-2 for fp8, ``tests/test_wire_exchange.py:364-367,
634-642``).
"""

import numpy as np
import pytest

import torch_wire_cases as C
from test_torch_wire_train import assert_final
from torch_ranks import spawn

RUNS = {
    "bf16_fused": {"overlap": "fused", "wire_dtype": "bf16"},
    "fp8_fused": {"overlap": "fused", "wire_dtype": "fp8"},
    "fp8_pipelined": {"overlap": "pipelined", "wire_dtype": "fp8"},
}
LOOSE = {"bf16": 5e-3, "fp8": 5e-2}


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
  batches = C.batches(C.STEPS)
  ev = C.batches(1, seed=99)[0][:2]
  state = C.initial("sgd")
  runs = [dict(name=name, overlap=kw["overlap"], micro_batches=1,
               guard=False, eval=ev,
               plan_kw={"dedup_exchange": True,
                        "wire_dtype": kw["wire_dtype"]})
          for name, kw in RUNS.items()]
  runs.append(dict(name="f32", overlap="fused", micro_batches=1,
                   guard=False, plan_kw={"dedup_exchange": True}))
  got = spawn(tmp_path_factory.mktemp("wirenarrow"), C.WORLD,
              "mb_guard_job", C.spec(state, "sgd", runs, batches))
  want = {name: C.jax_run(state, "sgd", batches, eval_batch=ev,
                          overlap=kw["overlap"], dedup_exchange=True,
                          wire_dtype=kw["wire_dtype"])
          for name, kw in RUNS.items()}
  return got, want


@pytest.mark.parametrize("name", list(RUNS))
def test_narrow_dedup_trajectory_matches_jax(narrow, name):
  got, want = narrow
  for rank_out in got:
    res = rank_out[name]
    assert all(np.isfinite(res["losses"]))
    np.testing.assert_allclose(res["losses"], want[name]["losses"], **C.TOL)
    np.testing.assert_allclose(res["eval"]["preds"],
                               want[name]["eval"]["preds"], **C.TOL)
  assert_final(got[0][name], want[name]["final"])


@pytest.mark.parametrize("name", list(RUNS))
def test_narrow_wire_stays_close_to_f32(narrow, name):
  got, _ = narrow
  losses = np.asarray(got[0][name]["losses"])
  f32 = np.asarray(got[0]["f32"]["losses"])
  np.testing.assert_allclose(losses, f32, rtol=0,
                             atol=LOOSE[RUNS[name]["wire_dtype"]])
  assert not np.array_equal(losses[1:], f32[1:])  # the wire narrowed
