"""The port's ``MicroBatcher`` against the JAX package's.

The accounting tests of ``tests/test_serving.py`` (de-interleave under
concurrent submitters, exact rejection accounting, deadline flush and
padding, reject reasons, priority shed, oversize and close, drain
failure, flusher and completer death), with a dispatch that returns CPU
torch tensors, as ``ServeEngine.dispatch`` does. Where both batchers can
run one schedule deterministically (``start=False`` and ``flush_now``),
their ``stats`` must be equal. Then the batcher in front of a CPU
``ServeEngine`` on a loaded artifact: each request's rows are exactly
``predict`` of its rows alone, whatever it was packed and padded with.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_torch.convert import train_state_from_flax
from distributed_embeddings_torch.ops.packed_table import (
    sparse_rule as torch_sparse_rule,
)
from distributed_embeddings_torch.serving import (
    REJECT_REASONS,
    MicroBatcher,
    Rejected,
    ServeEngine,
    export,
    load,
)
from distributed_embeddings_torch.telemetry import DEAD_THREAD_GAUGE_STEM
from distributed_embeddings_tpu.serving import MicroBatcher as JaxBatcher
from distributed_embeddings_tpu.serving import Rejected as JaxRejected
from distributed_embeddings_tpu.serving.batcher import (
    REJECT_REASONS as JAX_REJECT_REASONS,
)
from distributed_embeddings_tpu.telemetry.http import (
    DEAD_THREAD_GAUGE_STEM as JAX_DEAD_THREAD_GAUGE_STEM,
)
from test_torch_serve_artifact import MULTI_HOT, _mixed
from test_torch_serving import TorchActsModel


def _echo(numerical, cats):
  """Row-identity dispatch returning a torch tensor: output row i is
  ``(numerical[i, 0], cats[0][i])``, so a de-interleave error shows."""
  return torch.stack([torch.as_tensor(numerical[:, 0]).double(),
                      torch.as_tensor(cats[0]).double()], dim=1)


def _jax_echo(numerical, cats):
  return jnp.stack([jnp.asarray(numerical[:, 0], jnp.float32),
                    jnp.asarray(cats[0], jnp.float32)], axis=1)


def _req(n, tag=0.0):
  return (np.full((n, 2), tag, np.float32),
          [np.arange(n, dtype=np.int32) + int(tag)])


def test_reject_reasons_and_gauge_name_match_jax():
  assert REJECT_REASONS == JAX_REJECT_REASONS
  assert DEAD_THREAD_GAUGE_STEM == JAX_DEAD_THREAD_GAUGE_STEM


def test_deinterleave_property():
  """Every request gets exactly its own rows back under concurrent
  submitters (the flusher and completer threads running)."""
  mb = MicroBatcher(_echo, max_batch=32, max_delay_s=0.002)
  failures = []
  ev = threading.Event()

  def client(tid, rng):
    for i in range(40):
      n = int(rng.integers(1, 9))
      tag = tid * 10000 + i
      while True:
        try:
          fut = mb.submit(*_req(n, tag))
          break
        except Rejected:
          ev.wait(0.001)
      out = fut.result(timeout=30)
      if out.shape[0] != n or not np.all(out[:, 0] == tag) \
          or not np.all(out[:, 1] == np.arange(n) + tag):
        failures.append((tid, i, out))

  threads = [threading.Thread(target=client,
                              args=(t, np.random.default_rng(t)))
             for t in range(6)]
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  mb.close()
  assert not failures
  assert mb.stats["completed"] == 6 * 40
  assert mb.stats["batches"] >= (6 * 40) // 32  # really coalesced


def _schedule_rejections(cls, echo, rejected_cls):
  mb = cls(echo, max_batch=8, queue_rows=16, start=False)
  outcome = []
  for _ in range(10):
    try:
      mb.submit(*_req(3))
      outcome.append("ok")
    except rejected_cls as e:
      outcome.append(e.reason)
  mb.flush_now()
  stats = dict(mb.stats)
  mb.close()
  return outcome, stats


def test_rejection_counted_exactly_as_jax():
  """With no flusher running, submissions past the row bound are shed,
  each counted, none enqueued; the JAX batcher counts the same."""
  got = _schedule_rejections(MicroBatcher, _echo, Rejected)
  want = _schedule_rejections(JaxBatcher, _jax_echo, JaxRejected)
  assert got == want
  outcome, stats = got
  assert outcome.count("ok") == 5 and outcome.count("queue_full") == 5
  assert (stats["rejected"], stats["submitted"], stats["completed"]) == \
      (5, 10, 5)


def test_deadline_flush_and_padding():
  """A lone small request does not wait for a full batch: the deadline
  flush fires and the dispatch is padded to max_batch with PAD_ID ids."""
  seen = []

  def spy(numerical, cats):
    seen.append((numerical.shape[0], cats[0][2:].copy()))
    return _echo(numerical, cats)

  mb = MicroBatcher(spy, max_batch=16, max_delay_s=0.005)
  out = mb.submit(*_req(2, 3.0)).result(timeout=30)
  assert out.shape[0] == 2 and np.all(out[:, 0] == 3.0)
  assert len(seen) == 1 and seen[0][0] == 16
  np.testing.assert_array_equal(seen[0][1], np.full(14, -1, np.int32))
  assert mb.stats["padded_rows"] == 14
  mb.close()


def _schedule_reasons(cls, echo, rejected_cls):
  """queue_full, priority_shed and deadline_expired in one schedule."""
  mb = cls(echo, max_batch=8, queue_rows=16, start=False)
  log = []
  for _ in range(5):
    mb.submit(*_req(3))
  try:
    mb.submit(*_req(3))
  except rejected_cls as e:
    log.append(("incoming", e.reason))
  hi = mb.submit(*_req(3, 5.0), priority=2)
  log.append(("after_priority", dict(mb.stats)))
  mb.flush_now()
  log.append(("hi_rows", hi.result(timeout=5).shape[0]))
  late = mb.submit(*_req(2), deadline_s=0.0)
  mb.flush_now()
  try:
    late.result(timeout=5)
  except rejected_cls as e:
    log.append(("late", e.reason))
  stats = dict(mb.stats)
  mb.close()
  return log, stats


def test_reject_reasons_exact_accounting_as_jax():
  """Every shed carries its reason and is counted once in the total and
  once per reason; the JAX batcher's counts on the same schedule are
  the same."""
  got = _schedule_reasons(MicroBatcher, _echo, Rejected)
  want = _schedule_reasons(JaxBatcher, _jax_echo, JaxRejected)
  assert got == want
  log, stats = got
  assert ("incoming", "queue_full") in log and ("late",
                                                "deadline_expired") in log
  assert stats["rejected/priority_shed"] == 1
  assert stats["rejected"] == 3 == sum(
      stats[f"rejected/{r}"] for r in REJECT_REASONS)


def _schedule_priority(cls, echo, rejected_cls):
  order = []

  def spy(numerical, cats):
    order.append(int(numerical[0, 0]))
    return echo(numerical, cats)

  mb = cls(spy, max_batch=4, queue_rows=8, start=False)
  lo1 = mb.submit(*_req(4, 1.0), priority=0)
  lo2 = mb.submit(*_req(4, 2.0), priority=0)
  hi = mb.submit(*_req(4, 9.0), priority=5)
  try:
    lo2.result(timeout=5)
    victim = None
  except rejected_cls as e:
    victim = e.reason
  mb.flush_now()
  rows = [f.result(timeout=5).shape[0] for f in (hi, lo1)]
  stats = dict(mb.stats)
  mb.close()
  return victim, order, rows, stats


def test_priority_shed_fails_victim_and_packs_priority_first():
  """The youngest low-priority request is evicted with 'priority_shed';
  flushes pack higher priorities first, FIFO within one; as in JAX."""
  got = _schedule_priority(MicroBatcher, _echo, Rejected)
  assert got == _schedule_priority(JaxBatcher, _jax_echo, JaxRejected)
  victim, order, rows, _ = got
  assert victim == "priority_shed" and order == [9, 1] and rows == [4, 4]


def test_rejects_oversize_and_close():
  mb = MicroBatcher(_echo, max_batch=4, start=False)
  with pytest.raises(ValueError, match="max_batch"):
    mb.submit(*_req(5))
  fut = mb.submit(*_req(2, 1.0))
  mb.close(drain=True)
  assert fut.result(timeout=5).shape[0] == 2
  with pytest.raises(RuntimeError, match="closed"):
    mb.submit(*_req(1))


def test_drain_failure_fails_queued_waiters():
  """A dispatch failure mid-drain fails every still-queued future."""
  def boom(numerical, cats):
    raise RuntimeError("kaput")

  mb = MicroBatcher(boom, max_batch=4, start=False)
  futs = [mb.submit(*_req(4)) for _ in range(2)]
  with pytest.raises(RuntimeError):
    mb.close(drain=True)
  for f in futs:
    assert f.done()
    with pytest.raises(RuntimeError):
      f.result(timeout=1)


def test_flusher_death_fails_queued_requests():
  """A flusher killed by an unexpected exception fails every queued
  request with a counted 'flusher_died' shed, closes the batcher and
  sets the dead-thread gauges; it never answers from elsewhere."""
  mb = MicroBatcher(_echo, max_batch=8, max_delay_s=0.002)

  def wrenched():
    raise RuntimeError("wrenched machinery")

  mb._take_batch_locked = wrenched  # dies on its next flush wakeup
  futs = [mb.submit(*_req(2)) for _ in range(3)]
  for f in futs:
    with pytest.raises(Rejected) as exc:
      f.result(timeout=30)
    assert exc.value.reason == "flusher_died"
    assert "serve-batcher-flush" in str(exc.value)
  assert mb.stats["rejected/flusher_died"] == 3
  assert mb.stats["rejected"] == 3
  with pytest.raises(Rejected) as exc:
    mb.submit(*_req(1))
  assert exc.value.reason == "flusher_died"
  assert mb.stats["rejected/flusher_died"] == 4
  assert mb.telemetry.gauge(DEAD_THREAD_GAUGE_STEM).value == 1
  key = f"{DEAD_THREAD_GAUGE_STEM}/serve-batcher-flush"
  assert mb.telemetry.gauge(key).value == 1
  mb.close()


def test_completer_death_fails_inflight_requests():
  """The completer dying mid-item fails that item's waiters too, and
  the flusher does not wedge behind it."""
  mb = MicroBatcher(_echo, max_batch=4, max_delay_s=0.002,
                    pipeline_depth=1)

  def wrenched(*a, **k):
    raise RuntimeError("completer wrenched")

  mb._complete = wrenched
  fut = mb.submit(*_req(2))
  with pytest.raises(Rejected) as exc:
    fut.result(timeout=30)
  assert exc.value.reason == "flusher_died"
  assert mb.stats["rejected/flusher_died"] >= 1
  mb.close()


@pytest.fixture(scope="module")
def artifact_engine(tmp_path_factory):
  """A CPU ServeEngine on an artifact the port exported and loaded (the
  mixed fixture: padded multi-hot ids, a few out of vocabulary)."""
  _, tplan, state, numerical, ids = _mixed("sum", 100, MULTI_HOT)
  path = str(tmp_path_factory.mktemp("artifact") / "serve")
  export(path, tplan, torch_sparse_rule("adagrad", 0.05),
         train_state_from_flax(state, "cpu"), quantize="int8")
  eng = ServeEngine(TorchActsModel(), tplan, load(path, tplan, device="cpu"),
                    device="cpu")
  return eng, numerical, ids


@pytest.mark.parametrize("threads", [False, True])
def test_batcher_over_the_artifact_engine(artifact_engine, threads):
  """Requests of 1-7 rows coalesced into padded dispatches of 8: each
  future holds exactly ``predict`` of its own rows (bit-equal: every row
  of the serve step is computed alone), and padded rows (PAD_ID ids,
  zero features) cost nothing but their slots."""
  eng, numerical, ids = artifact_engine
  mb = MicroBatcher(eng.dispatch, max_batch=8, max_delay_s=0.002,
                    start=threads)
  cuts = [0, 3, 4, 11, 16]  # 3 + 1, 7, 5 rows: three dispatches
  futs = [mb.submit(numerical[a:b], [x[a:b] for x in ids])
          for a, b in zip(cuts, cuts[1:])]
  if not threads:
    assert mb.flush_now() == 3
  for (a, b), fut in zip(zip(cuts, cuts[1:]), futs):
    want = eng.predict(numerical[a:b], [x[a:b] for x in ids])
    got = fut.result(timeout=30)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
  mb.close()
  stats = mb.stats
  assert stats["completed"] == 4 and stats["rejected"] == 0
  assert stats["padded_rows"] == 8 * stats["batches"] - 16
