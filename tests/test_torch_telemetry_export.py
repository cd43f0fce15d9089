"""The port's telemetry exporters and cross-process timeline against the
JAX package's (``telemetry/export.py``, ``telemetry/trace.py``), on the
same registries and tracers.

- **Exporters**: ``prometheus_text`` string-equal to the JAX rendering of
  the same registry (counters, gauges, histograms as summaries, names
  the Prometheus charset refuses), ``write_prometheus`` atomic,
  ``JsonlWriter`` rotation keeping a contiguous tail, ``emit_verdict``'s
  record and exit codes equal to JAX's.
- **Clock offsets**: ``estimate_clock_offset`` against a deterministic
  fake remote clock gives the JAX estimate exactly; against injected
  skews the true offset lies within the stated uncertainty.
- **Merges**: ``merge_traces`` of the same tracers is JSON-equal to the
  JAX merge (a skewed owner corrected into its router's rpc window, one
  pid per process); ``attach_device_track`` anchors and spaces a device
  trace exactly as JAX does, and ``device_events`` selects the CUDA
  kernel and memcpy events of a ``torch.profiler`` trace.
"""

import json
import os

import numpy as np
import pytest

from distributed_embeddings_torch import telemetry
from distributed_embeddings_tpu import telemetry as jtelemetry


def _registry(mod):
  r = mod.MetricsRegistry()
  r.counter("train/oov/class_a").inc(4)
  r.counter("9lives/odd-name.x").inc(2)
  r.gauge("queue/depth").set(2)
  r.gauge("vocab/occupancy/sparse_16").set(17)
  r.gauge("stream/nan").set(float("nan"))
  rng = np.random.default_rng(3)
  r.histogram("serve/latency_s").observe_many(
      (rng.pareto(1.2, 500) + 1e-4) * 1e-3)
  r.histogram("empty_hist")
  return r


def test_prometheus_text_is_jax_string_equal(tmp_path):
  got = telemetry.prometheus_text(_registry(telemetry))
  want = jtelemetry.prometheus_text(_registry(jtelemetry))
  assert got == want
  assert "# TYPE train_oov_class_a counter" in got
  assert 'serve_latency_s{quantile="0.99"}' in got
  assert "_9lives_odd_name_x 2" in got and "stream_nan NaN" in got
  path = str(tmp_path / "metrics.prom")
  assert telemetry.write_prometheus(_registry(telemetry), path) == path
  assert open(path).read() == want
  assert not os.path.exists(path + ".tmp")


def test_jsonl_writer_rotation_keeps_tail(tmp_path):
  path = str(tmp_path / "events.jsonl")
  with telemetry.JsonlWriter(path, max_bytes=120, keep=2) as w:
    for i in range(120):
      w.write({"i": i})
  assert os.path.exists(path + ".1") and os.path.exists(path + ".2")
  assert not os.path.exists(path + ".3")
  ids = []
  for f in (path + ".2", path + ".1", path):
    with open(f) as fh:
      ids += [json.loads(line)["i"] for line in fh]
  assert ids == list(range(ids[0], 120))
  with pytest.raises(ValueError, match="max_bytes"):
    telemetry.JsonlWriter(str(tmp_path / "x.jsonl"), max_bytes=0)


def test_emit_verdict_matches_jax(tmp_path, capsys):
  runs = [("chaos", {"ok": True, "skips": 3}, True),
          ("chaos-kill", {"ok": False}, False), ("obs-bench", {}, False)]
  outs, logs = [], []
  for mod, name in ((telemetry, "port"), (jtelemetry, "jax")):
    log = str(tmp_path / f"{name}.jsonl")
    codes = [mod.emit_verdict(tool, res, verbose=v, path=log)
             for tool, res, v in runs]
    assert codes == [0, 1, 1]
    outs.append(capsys.readouterr().out)
    with open(log) as f:
      logs.append([json.loads(line) for line in f])
  assert outs[0] == outs[1] and "CHAOS: PASS" in outs[0]
  assert logs[0] == logs[1]
  assert [r["ok"] for r in logs[0]] == [True, False, False]


# ---------------------------------------------------------------------------
# clock offsets
# ---------------------------------------------------------------------------


def test_clock_offset_equals_jax_on_a_fake_clock(monkeypatch):
  """A deterministic local clock and remote channel: both packages pick
  the same min-RTT round and report the same offset and bound."""
  from distributed_embeddings_torch.telemetry import trace as tt
  from distributed_embeddings_tpu.telemetry import trace as jt

  def fake(mod):
    ticks = iter(np.cumsum([0, 7, 5, 9, 3, 4, 11, 2, 6, 8, 1, 5, 3]))
    monkeypatch.setattr(mod, "clock_ns", lambda: int(next(ticks)) * 1000)
    remote = iter([10 ** 9 + k * 17_000 for k in range(6)])
    return mod.estimate_clock_offset(lambda: next(remote), rounds=6)

  got, want = fake(tt), fake(jt)
  assert got.to_json() == want.to_json()
  assert got.uncertainty_ns == max(1, got.rtt_ns // 2)
  with pytest.raises(ValueError, match="rounds"):
    telemetry.estimate_clock_offset(lambda: 0, rounds=0)


def test_clock_offset_within_stated_uncertainty():
  import time as _time

  from distributed_embeddings_torch.telemetry import trace as tt

  for skew in (0, 25_000_000, -3_600_000_000_000):
    def remote(skew=skew):
      _time.sleep(0.0002)
      return tt.clock_ns() + skew
    off = telemetry.estimate_clock_offset(remote, rounds=4)
    assert abs(off.offset_ns - skew) <= off.uncertainty_ns
    local = off.to_local(tt.clock_ns() + skew)
    assert abs(local - tt.clock_ns()) <= off.uncertainty_ns + 10_000_000


# ---------------------------------------------------------------------------
# merged timelines
# ---------------------------------------------------------------------------


def _tracers(mod, skew):
  """A router and an owner whose clock reads ``skew`` ahead, with the
  same windows on both packages' tracers (same t0s)."""
  a = mod.Tracer(label="router")
  b = mod.Tracer(label="owner-0")
  a.t0_ns = 1_000_000_000
  b.t0_ns = 1_000_000_000 + skew
  t0 = 2_000_000_000
  ms = 1_000_000
  a.record_window("fleet/rpc", t0 + 1 * ms, t0 + 9 * ms,
                  args={"span_id": "S", "trace_id": "T"})
  a.record_window("serve/dispatch", t0 + 2 * ms, t0 + 4 * ms)
  b.record_window("fleet/owner/gather", t0 + 3 * ms + skew,
                  t0 + 6 * ms + skew,
                  args={"parent_span_id": "S", "trace_id": "T"})
  return a, b


def test_merge_traces_json_equal_to_jax(tmp_path):
  skew = 3_700_000_000
  traces = {}
  for name, mod in (("port", telemetry), ("jax", jtelemetry)):
    a, b = _tracers(mod, skew)
    merged = mod.merge_traces(
        [{"trace": a.to_chrome()},
         {"trace": b.to_chrome(), "offset_ns": skew, "label": "owner"}],
        path=str(tmp_path / f"{name}.json"))
    traces[name] = merged
  assert json.dumps(traces["port"], sort_keys=True) == \
      json.dumps(traces["jax"], sort_keys=True)
  with open(tmp_path / "port.json") as f:
    assert json.load(f) == json.loads(json.dumps(traces["port"]))
  xs = {e["name"]: e for e in traces["port"]["traceEvents"]
        if e.get("ph") == "X"}
  rpc, g = xs["fleet/rpc"], xs["fleet/owner/gather"]
  assert rpc["ts"] < g["ts"] and g["ts"] + g["dur"] < rpc["ts"] + rpc["dur"]
  assert rpc["pid"] != g["pid"]
  with pytest.raises(ValueError, match="no traces"):
    telemetry.merge_traces([])


def _cuda_profile():
  """A ``torch.profiler`` Chrome trace in Kineto's form: host ops on the
  process pid, CUDA runtime calls, and kernels / memcpys on the GPU's
  pid, one tid per stream."""
  return {"traceEvents": [
      {"ph": "M", "pid": 4242, "name": "process_name",
       "args": {"name": "python3"}},
      {"ph": "M", "pid": 0, "name": "process_name",
       "args": {"name": "GPU 0"}},
      {"ph": "X", "cat": "cpu_op", "pid": 4242, "tid": 4242,
       "name": "aten::mm", "ts": 90.0, "dur": 30.0},
      {"ph": "X", "cat": "cuda_runtime", "pid": 4242, "tid": 4242,
       "name": "cudaLaunchKernel", "ts": 95.0, "dur": 4.0},
      {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
       "name": "apply_rows_kernel", "ts": 100.0, "dur": 2.0,
       "args": {"stream": 7}},
      {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7,
       "name": "Memcpy HtoD (Pageable -> Device)", "ts": 103.5,
       "dur": 1.0},
      {"ph": "X", "cat": "kernel", "pid": 0, "tid": 13,
       "name": "interact::fwd_kernel", "ts": 104.0, "dur": 3.0},
      {"ph": "f", "pid": 0, "tid": 7, "name": "ac2g", "ts": 100.0},
  ]}


def test_device_events_select_cuda_work():
  evs = telemetry.device_events(_cuda_profile())
  assert [e["name"] for e in evs] == [
      "apply_rows_kernel", "Memcpy HtoD (Pageable -> Device)",
      "interact::fwd_kernel"]
  # no categories: the GPU-named pid, else every duration event
  bare = {"traceEvents": [dict(e) for e in _cuda_profile()["traceEvents"]]}
  for e in bare["traceEvents"]:
    e.pop("cat", None)
  assert [e["pid"] for e in telemetry.device_events(bare)] == [0, 0, 0]
  plain = {"traceEvents": [
      {"ph": "X", "pid": 1, "tid": 1, "name": "a", "ts": 0.0, "dur": 1.0},
      {"ph": "X", "pid": 2, "tid": 1, "name": "b", "ts": 1.0, "dur": 1.0}]}
  assert len(telemetry.device_events(plain)) == 2


def test_attach_device_track_json_equal_to_jax():
  """The CUDA events of a profiler trace, attached by the port, and the
  same events as a TPU trace, attached by JAX: one JSON timeline. The
  earliest event lands on the anchor, the spacing is kept, each stream
  its own track."""
  cuda = _cuda_profile()
  tpu = {"traceEvents": [{"ph": "M", "pid": 0, "name": "process_name",
                          "args": {"name": "/device:TPU:0"}}] + [
      {k: v for k, v in e.items() if k != "cat"}
      for e in telemetry.device_events(cuda)]}
  out = {}
  for name, mod, dev in (("port", telemetry, cuda),
                         ("jax", jtelemetry, tpu)):
    a, _ = _tracers(mod, 0)
    merged = mod.merge_traces([{"trace": a.to_chrome()}])
    anchor = 2_000_000_000 + 2_000_000  # the dispatch span's start
    out[name] = mod.attach_device_track(merged, dev, anchor)
    assert mod.attach_device_track(merged, {"traceEvents": []},
                                   anchor) is merged
  assert json.dumps(out["port"], sort_keys=True) == \
      json.dumps(out["jax"], sort_keys=True)
  evs = out["port"]["traceEvents"]
  disp = next(e for e in evs if e.get("name") == "serve/dispatch")
  dev = sorted((e for e in evs if e.get("ph") == "X"
                and e["pid"] != disp["pid"]), key=lambda e: e["ts"])
  assert dev[0]["ts"] == pytest.approx(disp["ts"])
  assert dev[1]["ts"] - dev[0]["ts"] == pytest.approx(3.5)
  assert dev[0]["tid"] == dev[1]["tid"] != dev[2]["tid"]
