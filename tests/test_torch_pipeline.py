"""The host-pass pipeline in the port (``distributed_embeddings_torch/
pipeline.py``, ``TieredTrainer(overlap_host=True)``, ``ResilientTrainer(
overlap_host=True)``) against its serial loop and the JAX package's, on
``tests/torch_tiering_cases.py``'s cell (vocabularies ``[5000, 300, 40]``,
width 16, the 5,000-row table host-tier, Adagrad 0.05), world 1.

- **The worker** (the JAX package's ``tests/test_pipeline.py`` worker
  tests): jobs in submission order, a failed job re-raised on the caller
  with the worker alive, no submit after close, close drains dropped jobs.
- **Overlap against serial.** One stream with a NaN batch the guard skips
  and a re-rank every three steps, one batch repeated (its cold rows
  written back while the worker gathers them): the overlapped run's losses, fused
  buffers, host images, resident sets, observed counts and hit counters
  are bit-equal to the serial run's (which never calls the scheduler),
  conflict rows were re-gathered and host time was hidden. The serial
  run is held to the JAX serial run on the same numpy batches: losses
  and reconciled tables in the f32 class of the port's other tiering
  tests, hit counters, resident sets and counts equal.
- **A worker failure fails the run**, with no serial fallback.
- **ResilientTrainer**: overlapped with async snapshots against the
  serial, synchronous reference (losses bit-equal, the same accounting
  and snapshot steps); a resume from those snapshots continues bit-equal;
  a crash in the middle of the second snapshot, with a worker job in
  flight, resumes from the first to a bit-equal tail.
- **The dynamic vocabulary** (``run_dynvocab_overlapped``, the JAX
  ``tests/test_pipeline.py`` dynvocab tests, on ``tests/
  test_torch_dynvocab.py``'s cell): batch k+1 translated on the worker
  while step k runs, over power-law raw ids with admissions, denials and
  evictions (the re-zeroing on the main thread), bit-equal to the serial
  loop (losses, fused buffers, translator state, counters), one-shot and
  micro-batched; the serial loop held to the JAX one; a failed
  translation fails the run; the ``ResilientTrainer`` overlapped with
  snapshots equal to its serial run, and an interrupted overlapped run
  resumes to the same tail.
"""

import functools
import threading

import numpy as np
import pytest
import torch

import torch_tiering_cases as C
from distributed_embeddings_torch import pipeline
from distributed_embeddings_torch import tiering as tt
from distributed_embeddings_torch import training as ttr
from distributed_embeddings_torch.convert import dlrm_state_dict_from_flax
from distributed_embeddings_torch.layers.dist_model_parallel import \
    get_weights
from distributed_embeddings_torch.models import bce_loss
from distributed_embeddings_torch.ops import packed_table as tpt
from distributed_embeddings_torch.pipeline import HostWorker
from distributed_embeddings_torch.resilience import durable, faultinject
from distributed_embeddings_torch.resilience.faultinject import (
    FaultInjector,
    InjectedCrash,
)
from distributed_embeddings_torch.resilience.trainer import ResilientTrainer
from distributed_embeddings_torch.telemetry import MetricsRegistry
from distributed_embeddings_tpu import tiering as jt

TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)
TABLE_TOL = dict(rtol=1e-4, atol=1e-5)
CFG = dict(cache_fraction=0.3, staging_grps=64, rerank_interval=3)


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------


def test_worker_runs_jobs_in_submission_order():
  seen = []
  with HostWorker("t") as w:
    jobs = [w.submit(lambda i=i: (seen.append(i), i * i)[1], label="j")
            for i in range(16)]
    results = [w.result(j)[0] for j in jobs]
  assert seen == list(range(16))  # one thread, FIFO: never reordered
  assert results == [i * i for i in range(16)]
  assert all(w.result(j)[1] >= 0.0 for j in jobs)


def test_worker_reraises_job_error_and_survives():
  def boom():
    raise ValueError("job exploded")
  with HostWorker("t") as w:
    bad = w.submit(boom, label="j")
    ok = w.submit(lambda: 7, label="j")
    with pytest.raises(ValueError, match="job exploded"):
      w.result(bad)
    assert w.result(ok)[0] == 7  # a failed job does not poison the worker


def test_worker_submit_after_close_refuses():
  w = HostWorker("t")
  w.close()
  w.close()  # idempotent
  with pytest.raises(RuntimeError, match="closed"):
    w.submit(lambda: None)


def test_worker_close_drains_discarded_jobs():
  done = []
  w = HostWorker("t")
  w.submit(lambda: done.append(1), label="j")
  w.close()
  assert done == [1]


def test_dynvocab_overlap_names_its_item():
  # item 12a ported the dynvocab half: an empty stream runs no step and
  # touches nothing (tests/test_torch_dynvocab.py holds the overlap)
  assert pipeline.run_dynvocab_overlapped(None, []) == []


# ---------------------------------------------------------------------------
# the tiered overlap against the serial loop (and the serial one against
# the JAX package's)
# ---------------------------------------------------------------------------


def _factory():
  return functools.partial(ttr.Adagrad, lr=C.LR)


def _port(overlap, cfg=CFG, registry=None):
  plan = C.torch_plan(1)
  rule = tpt.adagrad_rule(C.LR)
  tplan = tt.TieringPlan(plan, rule, tt.TieringConfig(**cfg))
  store = tt.HostTierStore(tplan)
  dense_p, tables = C.jax_params(1)
  params = dict(dlrm_state_dict_from_flax(dense_p))
  params["embeddings"] = tables
  state = tt.init_tiered_state_from_params(tplan, store, rule, params,
                                           _factory(), device="cpu")
  return tt.TieredTrainer(C.torch_model(), tplan, store, bce_loss,
                          _factory(), rule, None, state, guard=True,
                          overlap_host=overlap, device="cpu",
                          telemetry=registry)


def _poisoned(batches, at):
  return list(faultinject.nan_batches(batches, at_steps={at}))


def _tier_arrays(trainer):
  trainer.flush()
  st = trainer.store
  out = {f"{part}/{name}/{r}": np.asarray(v).copy()
         for part in ("images", "resident_grps", "counts")
         for name, per in getattr(st, part).items()
         for r, v in enumerate(per) if v is not None}
  out.update({f"fused/{k}": v.numpy().copy()
              for k, v in trainer.state["fused"].items()})
  out.update({f"hits/{k}": v.copy() for k, v in trainer.hits.items()})
  for part in ("dense", "emb_dense"):
    out.update({f"{part}/{k}": v.detach().numpy().copy()
                for k, v in trainer.state[part].items()})
  return out


def _assert_equal(got, want):
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_tiered_overlap_bit_exact_vs_serial_with_guard_skip(monkeypatch):
  batches = _poisoned([C.jax_batch(200 + i) for i in range(7)], 2)
  # batch 4 repeats batch 3: its cold rows are the rows step 3 writes back
  # while the worker gathers them (the conflict the repair re-gathers)
  batches[4] = batches[3]

  ser = _port(False)
  with monkeypatch.context() as m:
    m.setattr(pipeline, "run_tiered_overlapped",
              lambda *a, **k: pytest.fail("serial run called the scheduler"))
    losses_ser = ser.run(batches)

  reg = MetricsRegistry()
  ovl = _port(True, registry=reg)
  ovl.prefetcher.telemetry = reg
  repairs = {"n": 0}
  orig_repair = ovl.prefetcher.repair_conflicts

  def counted_repair(*a, **k):
    repairs["n"] += 1
    return orig_repair(*a, **k)
  ovl.prefetcher.repair_conflicts = counted_repair
  losses_ovl = ovl.run(batches)

  np.testing.assert_array_equal(losses_ovl, losses_ser)
  assert not np.isfinite(losses_ovl[2])  # the poison batch skipped
  assert ser.bad_steps == ovl.bad_steps == 1 and ser.steps == ovl.steps
  assert repairs["n"] >= 1
  assert reg.histogram("tiered/overlap_hidden_s").count >= 1
  assert reg.state_dict()["counters"]["tiered/conflict_rows_regathered"] > 0
  _assert_equal(_tier_arrays(ovl), _tier_arrays(ser))

  # the serial loop against the JAX package's on the same batches
  want = C.jax_run(1, jt.TieringConfig(**CFG), batches, guard=True,
                   dense="adagrad")
  np.testing.assert_allclose(losses_ser, want["losses"], **TRAJ_TOL)
  p = tt.unpack_tiered_state(ser.tplan, ser.store, tpt.adagrad_rule(C.LR),
                             ser.state)
  got = [np.asarray(w) for w in get_weights(ser.tplan.plan, p["embeddings"])]
  for g, w in zip(got, want["weights"]):
    np.testing.assert_allclose(g, w, **TABLE_TOL)
  for name, h in want["hits"].items():
    np.testing.assert_array_equal(ser.hits[name], h, err_msg=name)
  for part in ("resident", "counts"):
    for name, per in want[part].items():
      mine = getattr(ser.store, "resident_grps" if part == "resident"
                     else "counts")[name]
      for r, v in enumerate(per):
        np.testing.assert_array_equal(mine[r], v, err_msg=f"{part} {name}")


def test_tiered_worker_failure_fails_the_run():
  """A broken host pass on the worker fails the run: no serial
  fallback."""
  t = _port(True)
  orig = t.prefetcher.gather_cold
  threads = []

  def broken_gather(cold):
    threads.append(threading.current_thread().name)
    if threading.current_thread().name == "tiered-overlap":
      raise RuntimeError("cold store unreachable")
    return orig(cold)
  t.prefetcher.gather_cold = broken_gather
  with pytest.raises(RuntimeError, match="cold store unreachable"):
    t.run([C.jax_batch(300 + i) for i in range(3)])
  assert threads == ["MainThread", "tiered-overlap"]
  # the first step ran; the worker is joined before its accounting, so
  # the failure surfaced there and the second step never dispatched
  assert t.state["step"] == 1 and t.steps == 0


# ---------------------------------------------------------------------------
# the resilient trainer: overlap x async snapshots x a kill
# ---------------------------------------------------------------------------


def _resilient(root, overlap, async_snapshots=False):
  t = _port(overlap)
  return ResilientTrainer(None, None, t.tplan.plan, tpt.adagrad_rule(C.LR),
                          str(root), snapshot_every=2, tiered=t,
                          overlap_host=overlap,
                          async_snapshots=async_snapshots,
                          telemetry=MetricsRegistry())


def test_resilient_tiered_overlap_parity_async_and_kill_resume(tmp_path):
  batches = _poisoned([C.jax_batch(500 + i) for i in range(6)], 3)

  ref = _resilient(tmp_path / "ref", overlap=False)
  with faultinject.injected(FaultInjector()) as probe:
    ref_losses = ref.run(batches)
  writes = probe.count("ckpt_write")
  snaps_ref = [s for s, _ in durable.list_checkpoints(str(tmp_path / "ref"))]
  assert snaps_ref and writes % len(snaps_ref) == 0
  per_snap = writes // len(snaps_ref)

  # (a) overlap + async snapshots: identical losses and accounting
  ovl = _resilient(tmp_path / "run", overlap=True, async_snapshots=True)
  losses = ovl.run(batches)
  ovl.close()
  np.testing.assert_array_equal(losses, ref_losses)
  assert not np.isfinite(losses[3])
  assert (ovl.step_count, ovl.skipped_steps, ovl.consumed) == \
      (ref.step_count, ref.skipped_steps, ref.consumed)
  assert ovl.consumed == ovl.step_count + ovl.skipped_steps
  assert [s for s, _ in durable.list_checkpoints(str(tmp_path / "run"))] \
      == snaps_ref

  # (b) a fresh overlapped trainer resumes the async root: a bit-equal tail
  res = _resilient(tmp_path / "run", overlap=True)
  assert res.resumed_from is not None
  start = res.consumed
  assert 0 < start <= len(batches)
  np.testing.assert_array_equal(res.run(batches[start:]),
                                ref_losses[start:])

  # (c) a crash on a write of the SECOND snapshot, a worker job in flight
  kill = _resilient(tmp_path / "kill", overlap=True)
  with faultinject.injected(
      FaultInjector().crash_after("ckpt_write", per_snap + 1)):
    with pytest.raises(InjectedCrash):
      kill.run(batches)
  res2 = _resilient(tmp_path / "kill", overlap=True)
  assert res2.resumed_from is not None
  start2 = res2.consumed
  assert 0 < start2 < len(batches)
  np.testing.assert_array_equal(res2.run(batches[start2:]),
                                ref_losses[start2:])


# ---------------------------------------------------------------------------
# the dynamic vocabulary's translate-ahead
# ---------------------------------------------------------------------------


def _dv_pair(overlap, micro_batches=1):
  import test_torch_dynvocab as D
  jplan, tplan = D._plans(1, **D.KNOBS)
  state = D._jax_state(1, jplan)
  t = D._port_trainer(tplan, D._numpy_state(state),
                      micro_batches=micro_batches,
                      telemetry=MetricsRegistry(), overlap_host=overlap)
  return D, jplan, state, t


@pytest.mark.parametrize("micro_batches", [1, 2])
def test_dynvocab_overlap_bit_exact_vs_serial(micro_batches, monkeypatch):
  D, jplan, state, ser = _dv_pair(False, micro_batches)
  batches = [D._raw_batch(200 + s, space=480) for s in range(6)]
  with monkeypatch.context() as m:
    m.setattr(pipeline, "run_dynvocab_overlapped",
              lambda *a, **k: pytest.fail("serial run called the scheduler"))
    losses_ser = ser.run(batches)
  _, _, _, ovl = _dv_pair(True, micro_batches)
  losses_ovl = ovl.run(batches)
  assert losses_ovl == losses_ser
  assert ovl.telemetry.histogram("dynvocab/overlap_hidden_s").count == 5
  for name in ser.state["fused"]:
    assert torch.equal(ovl.state["fused"][name], ser.state["fused"][name])
  D._assert_arrays_equal(D._translator_arrays(ovl.translator),
                         D._translator_arrays(ser.translator))
  assert ovl.metrics_summary() == ser.metrics_summary()
  assert ser.metrics_summary()["rows_zeroed"] > 0
  # the serial loop against the JAX one on the same batches
  jt = D._jax_trainer(1, jplan, state, batches[0],
                      micro_batches=micro_batches)
  np.testing.assert_allclose(losses_ser, [jt.step(*b) for b in batches],
                             **TRAJ_TOL)
  D._close(D._port_tables(ser), D._jax_tables(jt))


def test_dynvocab_worker_failure_fails_the_run():
  D, _, _, t = _dv_pair(True)
  orig = t.engine.translate_dynamic_ids
  threads = []

  def flaky(cats, translator):
    threads.append(threading.current_thread().name)
    if len(threads) >= 2:  # the first call serves batch 0 on the main thread
      raise RuntimeError("translator wedged")
    return orig(cats, translator)
  t.engine.translate_dynamic_ids = flaky
  with pytest.raises(RuntimeError, match="translator wedged"):
    t.run([D._raw_batch(300 + s) for s in range(3)])
  assert threads == ["MainThread", "dynvocab-overlap"]
  assert t.state["step"] == 1 and t.steps == 0


def test_resilient_dynvocab_overlap_parity_and_resume(tmp_path):
  import test_torch_dynvocab as D
  plans = D._plans(1, oov="allocate", admit_threshold=1, evict_ttl=3)
  state = D._jax_state(1, plans[0])
  stream = [D._raw_batch(700 + s) for s in range(6)]
  ref = D._resilient(tmp_path / "ref", plans, state)
  ref_losses = ref.run(stream)
  ovl = D._resilient(tmp_path / "run", plans, state, overlap_host=True)
  assert ovl.run(stream) == ref_losses
  assert (ovl.step_count, ovl.consumed) == (ref.step_count, ref.consumed)
  D._assert_arrays_equal(D._translator_arrays(ovl.dynvocab.translator),
                         D._translator_arrays(ref.dynvocab.translator))
  for name in ref.state["fused"]:
    assert torch.equal(ovl.state["fused"][name], ref.state["fused"][name])
  t1 = D._resilient(tmp_path / "cut", plans, state, overlap_host=True)
  first = t1.run(stream[:4])
  t2 = D._resilient(tmp_path / "cut", plans, state, overlap_host=True)
  assert t2.resumed_from is not None
  start = t2.consumed
  assert 0 < start <= 4
  assert first[:start] + t2.run(stream[start:]) == ref_losses
