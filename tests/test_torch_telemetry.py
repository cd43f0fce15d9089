"""The port's telemetry (a copy of the JAX package's pure-Python modules)
against the JAX package's, as far as the micro-batcher uses it.

The same observations give the same counters, gauges and histogram
buckets (``state_dict``) and the same percentiles in both registries;
the serve stage taxonomy lands in the same histograms; ``span`` is a
no-op singleton that allocates nothing while no tracer is installed,
and an installed tracer records nesting, virtual tracks and the request
trace context the batcher mints at admission.
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
