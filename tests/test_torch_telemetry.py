"""The port's telemetry (a copy of the JAX package's pure-Python modules)
against the JAX package's: the registry, spans, the flight recorder's
stages and the lock-order monitor (the exporters and merged timelines
are in ``tests/test_torch_telemetry_export.py``, the metrics endpoint in
``tests/test_torch_telemetry_http.py``).

The same observations give the same counters, gauges and histogram
buckets (``state_dict``) and the same percentiles in both registries;
the serve stage taxonomy lands in the same histograms; ``span`` is a
no-op singleton that allocates nothing while no tracer is installed,
and an installed tracer records nesting, virtual tracks and the request
trace context the batcher mints at admission. ``LockOrderMonitor`` gives
the JAX verdicts on the same acquisition sequences, and a batcher run
with the ``MicroBatcher``, ``ServeEngine`` and ``LeaderBatcher`` locks
instrumented stays consistent with the JAX package's static lock graph.
"""

import os
import tracemalloc

import numpy as np
import pytest

from distributed_embeddings_torch import telemetry
from distributed_embeddings_torch.serving import MicroBatcher
from distributed_embeddings_torch.telemetry import flight
from distributed_embeddings_tpu import telemetry as jtelemetry
from distributed_embeddings_tpu.telemetry import flight as jflight


def _samples(kind: str) -> np.ndarray:
  rng = np.random.default_rng(7)
  if kind == "power_law":
    return (rng.pareto(1.2, 2000) + 1e-4) * 1e-3
  if kind == "bimodal":
    return np.concatenate([rng.normal(1e-3, 1e-5, 1000),
                           rng.normal(2.5, 0.1, 1000)]).clip(1e-9)
  # ten decades, constants and zeros
  return np.concatenate([10.0 ** rng.uniform(-6, 4, 1500),
                         np.full(300, 0.125), np.zeros(200)])


def _drive(mod, xs):
  reg = mod.MetricsRegistry()
  for i, x in enumerate(xs):
    reg.counter("serve/submitted").inc()
    if i % 7 == 0:
      reg.counter("serve/rejected").inc(2)
    reg.gauge("serve/queue_rows").set(float(i % 13))
    reg.histogram("serve/latency_s").observe(float(x))
    reg.histogram("coarse", rel_err=0.05).observe(float(x))
  return reg


@pytest.mark.parametrize("kind", ["power_law", "bimodal", "wide"])
def test_registry_matches_jax(kind):
  xs = _samples(kind)
  got, want = _drive(telemetry, xs), _drive(jtelemetry, xs)
  assert got.state_dict() == want.state_dict()
  assert got.snapshot() == want.snapshot()
  for name, rel_err in (("serve/latency_s", 0.01), ("coarse", 0.05)):
    g, w = got.histogram(name, rel_err), want.histogram(name, rel_err)
    assert g.count == w.count == len(xs)
    for q in (0.5, 0.9, 0.99, 0.999, 1.0):
      assert g.percentile(q) == w.percentile(q)


def test_stage_taxonomy_matches_jax():
  """``observe_stage`` with no recorder installed feeds the emitting
  component's registry, as in JAX."""
  assert flight.STAGES == jflight.STAGES
  got, want = telemetry.MetricsRegistry(), jtelemetry.MetricsRegistry()
  for i, stage in enumerate(flight.STAGES * 5):
    flight.observe_stage(stage, 1e-4 * (i + 1), registry=got)
    jflight.observe_stage(stage, 1e-4 * (i + 1), registry=want)
  assert got.state_dict() == want.state_dict()
  with flight.stage("pack", registry=got) as st:
    pass
  assert st.elapsed >= 0.0
  assert got.histogram("serve/stage_s/pack").count == 6


def test_disabled_span_is_singleton_and_zero_allocation():
  assert telemetry.current_tracer() is None
  assert telemetry.span("a") is telemetry.span("b") \
      is telemetry.span("c", track="device")
  here = os.path.dirname(telemetry.__file__)
  for _ in range(100):
    with telemetry.span("warm"):
      pass
  tracemalloc.start()
  try:
    s0 = tracemalloc.take_snapshot()
    for _ in range(5000):
      with telemetry.span("hot/stage"):
        pass
    s1 = tracemalloc.take_snapshot()
  finally:
    tracemalloc.stop()
  blocks = sum(st.count_diff for st in s1.compare_to(s0, "filename")
               if here in st.traceback[0].filename and st.count_diff > 0)
  assert blocks < 50, f"disabled spans allocate per call: {blocks}"


def test_span_nesting_tracks_and_context():
  with telemetry.tracing() as tr:
    ctx = telemetry.mint_context(["r1", "r2"])
    with telemetry.use_context(ctx):
      with telemetry.span("outer"):
        with telemetry.span("inner", args={"k": 3}):
          pass
    dev = telemetry.span("device/step", track="device").start()
    with telemetry.span("host"):
      pass
    dev.finish()
  evs = {e["name"]: e for e in tr.to_chrome()["traceEvents"]
         if e["ph"] == "X"}
  out_, in_ = evs["outer"], evs["inner"]
  assert out_["ts"] <= in_["ts"]
  assert in_["ts"] + in_["dur"] <= out_["ts"] + out_["dur"] + 1e-6
  assert in_["args"]["k"] == 3
  assert out_["args"]["trace_ids"] == ["r1", "r2"]
  assert in_["args"]["parent_span_id"] == out_["args"]["span_id"]
  assert out_["args"]["parent_span_id"] == ctx.span_id
  assert evs["device/step"]["tid"] != evs["host"]["tid"]
  assert "args" not in evs["host"]
  assert telemetry.current_tracer() is None


def test_batcher_mints_request_ids_only_while_tracing():
  """Admission mints each request's trace id when a tracer is
  installed, and the dispatch span carries every coalesced id; without
  one it mints nothing."""
  with telemetry.tracing() as tr:
    mb = MicroBatcher(lambda n, c: n, max_batch=8, start=False)
    f1 = mb.submit(np.zeros((2, 1), np.float32), [np.zeros(2, np.int32)])
    f2 = mb.submit(np.zeros((3, 1), np.float32), [np.zeros(3, np.int32)])
    mb.flush_now()
    assert f1.result(1.0).shape[0] == 2 and f2.done()
  evs = {e["name"]: e for e in tr.to_chrome()["traceEvents"]
         if e.get("ph") == "X"}
  disp = evs["serve/dispatch"]
  assert len(set(disp["args"]["trace_ids"])) == 2
  for name in ("serve/pack", "serve/complete"):
    assert evs[name]["args"]["trace_id"] == disp["args"]["trace_id"]
  mb = MicroBatcher(lambda n, c: n, max_batch=4, start=False)
  mb.submit(np.zeros((2, 1), np.float32), [np.zeros(2, np.int32)])
  assert all(p.trace_id is None for p in mb._pending)
  mb.flush_now()
  assert mb.telemetry.histogram("serve/latency_s").count == 1
  assert mb.telemetry.histogram("serve/stage_s/queue").count == 1


# ---------------------------------------------------------------------------
# the lock-order monitor
# ---------------------------------------------------------------------------


def _sequence_verdicts(mod):
  """Acquisition sequences through the monitor: an order then its
  inversion, a reentrant lock and a condition sharing its lock's name,
  and the merged-graph check; returns what each step did."""
  import threading

  out = []
  mon = mod.LockOrderMonitor()
  a = mon.wrap(threading.Lock(), "T.a")
  b = mon.wrap(threading.Lock(), "T.b")
  r = mon.wrap(threading.RLock(), "T.r")
  with a:
    with b:
      pass
  with r:
    with r:
      with a:
        pass
  lock = threading.Lock()
  shared = mon.wrap(lock, "T.c")
  cv = mon.wrap(threading.Condition(lock), "T.c")
  with shared:
    cv.notify_all()
  with cv:
    cv.wait(timeout=0.001)
  out.append(sorted(mon.edges()))
  try:
    with b:
      with a:
        pass
    out.append("no error")
  except mod.LockOrderError as e:
    out.append(str(e))
  for static in (set(), {("T.a", "T.b")}, {("T.b", "T.r")}):
    try:
      mon.assert_consistent_with(static)
      out.append("consistent")
    except mod.LockOrderError as e:
      out.append(str(e))
  return out


def test_lockorder_verdicts_match_jax():
  from distributed_embeddings_tpu.telemetry import lockorder as jlock
  got = _sequence_verdicts(telemetry)
  assert got == _sequence_verdicts(jlock)
  assert got[0] == [("T.a", "T.b"), ("T.r", "T.a")]
  assert "lock-order inversion" in got[1]
  assert got[2:4] == ["consistent", "consistent"] and "cycle" in got[4]


def test_lockorder_over_the_serving_locks(monkeypatch, tmp_path):
  """A batcher run with the ``MicroBatcher``, ``ServeEngine`` and
  ``LeaderBatcher`` locks instrumented: requests from several threads
  through a ``MicroBatcher`` over a port ``ServeEngine`` on an exported
  artifact (each answer equal to ``predict`` of its rows) and through a
  ``LeaderBatcher`` (its broadcast to the followers stubbed: one process
  holds no world), and the observed order merged with the JAX package's
  static lock graph (its threadlint) stays acyclic."""
  import threading

  import torch

  from distributed_embeddings_torch.convert import train_state_from_flax
  from distributed_embeddings_torch.ops.packed_table import sparse_rule
  from distributed_embeddings_torch.parallel.mesh import Mesh
  from distributed_embeddings_torch.serving import (
      ServeEngine,
      export,
      load,
  )
  from distributed_embeddings_torch.serving import leader as tleader
  from distributed_embeddings_tpu.analysis import threadlint
  from test_torch_serve_artifact import MULTI_HOT, _mixed
  from test_torch_serving import TorchActsModel

  _, tplan, state, numerical, ids = _mixed("sum", 100, MULTI_HOT)
  path = str(tmp_path / "serve")
  export(path, tplan, sparse_rule("adagrad", 0.05),
         train_state_from_flax(state, "cpu"), quantize="int8")
  eng = ServeEngine(TorchActsModel(), tplan, load(path, tplan, device="cpu"),
                    device="cpu")

  class LeadEngine:
    """Rank 0's engine as the leader sees it: a world-2 mesh and a
    dispatch under the engine lock (``ServeEngine.dispatch``'s)."""

    def __init__(self):
      self.lock = threading.RLock()
      self.mesh = Mesh(rank=0, world=2, device=torch.device("cpu"),
                       backend="gloo")

    def dispatch(self, numerical, cats):
      with self.lock:
        return torch.as_tensor(numerical[:, :1]).double()

  mon = telemetry.LockOrderMonitor()
  sent = []
  monkeypatch.setattr(tleader, "_send", lambda mesh, *msg: sent.append(msg))
  lead_eng = LeadEngine()
  for e in (eng, lead_eng):
    e.lock = mon.wrap(e.lock, "ServeEngine.lock")
  batchers = [MicroBatcher(eng.dispatch, max_batch=8, max_delay_s=0.002),
              tleader.LeaderBatcher(lead_eng, 8, max_delay_s=0.002)]
  for mb, name in zip(batchers, ("MicroBatcher._lock",
                                 "LeaderBatcher._lock")):
    # _nonempty is Condition(_lock): one lock, one name
    mb._lock = mon.wrap(mb._lock, name)
    mb._nonempty = mon.wrap(mb._nonempty, name)
  futs = []

  def client(k):
    for i in range(4):
      a, n = (3 * k + i) % 10, 1 + (i + k) % 4
      rows = (numerical[a:a + n], [x[a:a + n] for x in ids])
      futs.append(("engine", rows, batchers[0].submit(*rows)))
      x = np.full((n, 2), float(k * 10 + i), np.float32)
      futs.append(("leader", (x,), batchers[1].submit(
          x, [np.zeros(n, np.int32)])))

  threads = [threading.Thread(target=client, args=(k,)) for k in range(3)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=60)
    assert not t.is_alive()
  for kind, rows, fut in futs:
    got = np.asarray(fut.result(timeout=60))
    if kind == "engine":
      np.testing.assert_array_equal(got, np.asarray(eng.predict(*rows)))
    else:
      np.testing.assert_array_equal(got[:, 0], rows[0][:, 0])
  for mb in batchers:
    mb.close()
  assert sent and len(futs) == 24
  assert ("MicroBatcher._lock", "ServeEngine.lock") not in mon.edges()
  mon.assert_consistent_with(threadlint.static_lock_edges())
