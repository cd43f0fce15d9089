"""``dedup_capacity`` and its ``dedup_overflow`` counter at world 4,
against the JAX package and a numpy count.

The cell of ``tests/torch_wire_cases.py`` under ``dedup_exchange=True,
dedup_capacity=6``, ``overlap='fused'``, SGD, on four gloo processes and
on a 4-device CPU mesh:

- the guarded step's per-class ``dedup_overflow`` (summed over the
  ranks) equals the JAX guarded step's and the numpy count of distinct
  routed ids past the cap (``torch_wire_cases.routed_overflow``) at every
  step, on every rank; the eval step with metrics equals the JAX eval
  step's; the trajectory (aliased rows included) stays in the f32 class;
- with ``micro_batches=2`` the count is the sum of the two slices' numpy
  counts; a generous cap counts 0 and trains as the uncapped plan does;
- a guarded dedup step over the bf16 wire whose batch holds NaN in one
  rank's slice is skipped on every rank, its arrays bit-equal;
- ``ResilientTrainer`` accumulates the counts into
  ``dedup_overflow_totals`` and the ``train/dedup_overflow/<class>``
  counters, and carries them in the checkpoint: the JAX trainer resumes
  the port's world-4 root with the same totals and counters, and the
  port's trainer resumes the JAX trainer's.
"""

import os

import numpy as np
import optax
import pytest

import torch_wire_cases as C
from distributed_embeddings_tpu.resilience.trainer import \
    ResilientTrainer as JTrainer
from distributed_embeddings_tpu.telemetry import MetricsRegistry as JRegistry
from test_torch_wire_train import assert_final
from torch_ranks import spawn

CAP = 6
CAPPED = {"dedup_exchange": True, "dedup_capacity": CAP}


def _slices(cats, n_mb):
  """Micro-batch ``i``'s global ids: slice ``i`` of every rank's part."""
  b = cats[0].shape[0] // C.WORLD
  m = b // n_mb
  return [[np.concatenate([c[r * b + i * m:r * b + (i + 1) * m]
                           for r in range(C.WORLD)]) for c in cats]
          for i in range(n_mb)]


@pytest.fixture(scope="module")
def capped(tmp_path_factory):
  batches = C.batches(C.STEPS)
  ev = C.batches(1, seed=99)[0][:2]
  state = C.initial("sgd")
  runs = [dict(name="cap", overlap="fused", micro_batches=1, guard=True,
               plan_kw=CAPPED, eval=ev),
          dict(name="cap_mb2", overlap="fused", micro_batches=2, guard=True,
               plan_kw=CAPPED),
          dict(name="generous", overlap="fused", micro_batches=1, guard=True,
               plan_kw={"dedup_exchange": True, "dedup_capacity": 1 << 20},
               eval=ev),
          dict(name="uncapped", overlap="fused", micro_batches=1,
               guard=False, plan_kw={"dedup_exchange": True}),
          dict(name="poison", overlap="fused", micro_batches=1, guard=True,
               plan_kw={"dedup_exchange": True, "wire_dtype": "bf16"},
               nan_rank=1, nan_steps=[1])]
  got = spawn(tmp_path_factory.mktemp("wireovf"), C.WORLD, "mb_guard_job",
              C.spec(state, "sgd", runs, batches))
  want = C.jax_run(state, "sgd", batches, guard=True, eval_batch=ev,
                   overlap="fused", **CAPPED)
  return batches, ev, got, want


def test_guarded_overflow_matches_jax_and_numpy(capped):
  batches, _, got, want = capped
  plan = C.plan("fused", **CAPPED)
  counts = [C.routed_overflow(plan, cats, CAP) for _, cats, _ in batches]
  assert all(sum(c.values()) > 0 for c in counts)
  for i, m in enumerate(want["metrics"]):
    assert m["dedup_overflow"] == counts[i]
  for rank_out in got:
    res = rank_out["cap"]
    assert [m["dedup_overflow"] for m in res["metrics"]] == counts
    assert [m["bad_step"] for m in res["metrics"]] == [0] * C.STEPS
    np.testing.assert_allclose(res["losses"], want["losses"], **C.TOL)
    # only sparse-kind classes dedup, so only they can overflow
    for name, v in res["metrics"][0]["dedup_overflow"].items():
      if name.endswith("_dense"):
        assert v == 0
  assert_final(got[0]["cap"], want["final"])


def test_eval_overflow_matches_jax_and_numpy(capped):
  _, ev, got, want = capped
  plan = C.plan("fused", **CAPPED)
  count = C.routed_overflow(plan, ev[1], CAP)
  assert want["eval"]["dedup_overflow"] == count
  for rank_out in got:
    assert rank_out["cap"]["eval"]["dedup_overflow"] == count
    assert rank_out["cap"]["eval"]["oov"] == want["eval"]["oov"]
    np.testing.assert_allclose(rank_out["cap"]["eval"]["preds"],
                               want["eval"]["preds"], **C.TOL)


def test_micro_batch_overflow_is_the_sum_of_the_slices(capped):
  batches, _, got, _ = capped
  plan = C.plan("fused", **CAPPED)
  for step, (_, cats, _) in enumerate(batches):
    parts = [C.routed_overflow(plan, s, CAP) for s in _slices(cats, 2)]
    want = {k: parts[0][k] + parts[1][k] for k in parts[0]}
    assert sum(want.values()) > 0
    for rank_out in got:
      assert rank_out["cap_mb2"]["metrics"][step]["dedup_overflow"] == want


def test_a_generous_cap_counts_nothing_and_changes_nothing(capped):
  _, _, got, _ = capped
  for rank_out in got:
    res, base = rank_out["generous"], rank_out["uncapped"]
    assert all(v == 0 for m in res["metrics"]
               for v in m["dedup_overflow"].values())
    assert res["eval"]["dedup_overflow"] == {
        k: 0 for k in res["eval"]["dedup_overflow"]}
    assert res["losses"] == base["losses"]
    for part in (0, 1):
      for k, arr in base["unpacked"][part].items():
        np.testing.assert_array_equal(res["unpacked"][part][k], arr)


def test_a_poisoned_dedup_step_is_skipped_bit_exactly(capped):
  _, _, got, _ = capped
  for rank_out in got:
    res = rank_out["poison"]
    assert [m["bad_step"] for m in res["metrics"]] == [0, 1, 0]
    assert res["skipped"] == [(1, [])]  # every array bit-equal
    assert res["step"] == C.STEPS - 1
    assert "dedup_overflow" not in res["metrics"][0]  # uncapped plan


# ---------------------------------------------------------------------------
# ResilientTrainer
# ---------------------------------------------------------------------------


def _jax_trainer(state, stream, root, resume=True):
  from distributed_embeddings_tpu.models import bce_loss
  from distributed_embeddings_tpu.parallel import create_mesh
  from distributed_embeddings_tpu.training import (
      make_sparse_train_step,
      shard_params,
  )
  mesh = create_mesh(C.WORLD)
  plan = C.plan("fused", **CAPPED)
  rule = C.rule_of("sgd")
  st = shard_params(state, mesh)
  step = make_sparse_train_step(C.model(), plan, bce_loss, optax.sgd(C.LR),
                                rule, mesh, st, stream[0], donate=False,
                                guard=True)
  return JTrainer(step, st, plan, rule, root, mesh=mesh, snapshot_every=2,
                  telemetry=JRegistry(), resume=resume)


def test_trainer_totals_cross_the_checkpoint_both_ways(tmp_path):
  state = C.initial("sgd")
  stream = C.batches(4, seed=21)
  plan = C.plan("fused", **CAPPED)
  counts = [C.routed_overflow(plan, cats, CAP) for _, cats, _ in stream]
  want = {k: sum(c[k] for c in counts) for k in counts[0]}
  want = {k: v for k, v in want.items() if v}
  spec = C.spec(state, "sgd", [], stream)
  spec.update({"overlap": "fused", "plan_kw": CAPPED, "snapshot_every": 2,
               "root": str(tmp_path / "port"), "split": 4, "stream": stream})
  res = spawn(tmp_path, C.WORLD, "trainer_job", spec)
  for r in res:
    assert r["summary"]["dedup_overflow"] == want
    assert r["dedup_overflow_counters"] == {
        f"train/dedup_overflow/{k}": v for k, v in want.items()}
  # the JAX trainer resumes the port's root with the port's totals
  jt = _jax_trainer(state, stream, spec["root"])
  assert jt.consumed == 4 and jt.dedup_overflow_totals == want
  for k, v in want.items():
    assert jt.telemetry.counter(f"train/dedup_overflow/{k}").value == v
  # and the port's resumes the JAX trainer's
  jroot = str(tmp_path / "jax")
  jt = _jax_trainer(state, stream, jroot, resume=False)
  jt.run(stream)
  assert jt.dedup_overflow_totals == want
  spec.update({"root": jroot, "split": 0})
  os.makedirs(tmp_path / "resume")
  res = spawn(tmp_path / "resume", C.WORLD, "trainer_job", spec)
  for r in res:
    assert r["resumed_at"] == 4
    assert r["summary"]["dedup_overflow"] == want
    assert r["dedup_overflow_counters"] == {
        f"train/dedup_overflow/{k}": v for k, v in want.items()}
