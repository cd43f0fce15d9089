"""The port's live metrics endpoint (``telemetry/http.py``:
``MetricsServer``) against the JAX package's.

- ``GET /metrics`` equals ``prometheus_text`` of the registry, which is
  the JAX rendering; ``GET /healthz`` reports nulls before any promote,
  then the served watermark and its staleness, the most stale member of
  keyed promotes, and ``ok: false`` with the names of dead batcher
  threads (``DEAD_THREAD_GAUGE_STEM``); unknown paths are 404; the
  server binds loopback port 0 and closes clean (thread joined, port
  refused).
- ``?scope=fleet`` rolls up pushed registries (in process and over
  ``POST /push``) as the JAX server does: counters add, gauges take the
  last writer, re-pushes replace, bad payloads are 400; with
  ``snapshot_ttl_s`` an old snapshot drops out once, counted, and a
  re-push revives it; expiry is swept on pushes too.

Every HTTP call carries a timeout, and every server is joined.
"""

import json
import time
import urllib.error
import urllib.request

import pytest

from distributed_embeddings_torch import telemetry
from distributed_embeddings_tpu import telemetry as jtelemetry


def _get(url):
  return urllib.request.urlopen(url, timeout=5).read().decode()


def _health(server):
  return json.loads(_get(f"http://{server.host}:{server.port}/healthz"))


def _registry(mod):
  reg = mod.MetricsRegistry()
  reg.counter("stream/deltas_applied").inc(5)
  reg.gauge("vocab/occupancy/t0").set(17.0)
  reg.histogram("serve/latency_s").observe_many([0.001, 0.004, 0.2])
  return reg


def test_metrics_endpoint_serves_jax_text_and_shuts_down_clean():
  reg = _registry(telemetry)
  with telemetry.MetricsServer(reg) as server:
    assert server.host == "127.0.0.1" and server.port > 0
    body = _get(server.url)
    assert body == telemetry.prometheus_text(reg)
    assert body == jtelemetry.prometheus_text(_registry(jtelemetry))
    assert "vocab_occupancy_t0 17.0" in body
    assert _health(server) == {"ok": True, "served_step": None,
                               "last_promote_unix": None,
                               "staleness_s": None}
    with pytest.raises(urllib.error.HTTPError) as e:
      urllib.request.urlopen(
          f"http://{server.host}:{server.port}/nope", timeout=5)
    assert e.value.code == 404
    port = server.port
  assert server.closed
  with pytest.raises(OSError):
    urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2)
  server.close()  # idempotent


def test_healthz_watermark_members_and_dead_threads():
  reg = telemetry.MetricsRegistry()
  with telemetry.MetricsServer(reg) as server:
    telemetry.record_promote(reg, 42)
    reg.gauge("stream/last_promote_unixtime").set(time.time() - 5.0)
    h = _health(server)
    assert h["ok"] is True and h["served_step"] == 42
    assert 4.0 <= h["staleness_s"] <= 120.0 and h["members"] is None
    # keyed members: the most stale one wins, a removed one leaves
    now = time.time()
    telemetry.record_promote(reg, 1, subscriber_id="dead")
    reg.gauge("stream/last_promote_unixtime/dead").set(now - 3600.0)
    telemetry.record_promote(reg, 9, subscriber_id="live")
    h = server.health()
    assert h["staleness_s"] >= 3000.0 and h["members"] == 2
    telemetry.clear_promote(reg, subscriber_id="dead")
    h = server.health()
    assert h["served_step"] == 9 and h["staleness_s"] < 60.0
    # a batcher whose completer died fails readiness, naming the thread
    reg.gauge(f"{telemetry.DEAD_THREAD_GAUGE_STEM}/serve-completer").set(1)
    h = _health(server)
    assert h["ok"] is False and h["dead_threads"] == ["serve-completer"]
  # probing never creates gauges
  empty = telemetry.MetricsRegistry()
  telemetry.MetricsServer(empty).close()
  assert empty.peek("stream/served_step") is None


def _rollup(mod, ttl=None):
  """Local + two members, one pushed in process and one over HTTP, then a
  re-push; returns the fleet texts and the local text."""
  local = mod.MetricsRegistry()
  local.counter("serve/completed").inc(10)
  local.gauge("fleet/owners_dead").set(0.0)
  a = mod.MetricsRegistry()
  a.counter("serve/completed").inc(7)
  a.gauge("fleet/owners_dead").set(1.0)
  b = mod.MetricsRegistry()
  b.counter("serve/completed").inc(5)
  b.gauge("fleet/owners_dead").set(2.0)
  b.histogram("serve/latency_s").observe_many([0.01, 0.02])
  out = []
  with mod.MetricsServer(local, snapshot_ttl_s=ttl) as server:
    server.push("owner-0", a)
    req = urllib.request.Request(
        f"http://{server.host}:{server.port}/push",
        data=json.dumps({"source": "owner-1",
                         "telemetry": b.state_dict()}).encode("utf-8"),
        method="POST")
    assert urllib.request.urlopen(req, timeout=5).status == 200
    out.append(_get(server.fleet_url))
    out.append(_get(server.url))
    a.counter("serve/completed").inc(1)
    server.push("owner-0", a)
    out.append(_get(server.fleet_url))
    bad = urllib.request.Request(
        f"http://{server.host}:{server.port}/push",
        data=b'{"source": "x"}', method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
      urllib.request.urlopen(bad, timeout=5)
    assert e.value.code == 400
  return out


def test_fleet_rollup_equals_jax():
  got, want = _rollup(telemetry), _rollup(jtelemetry)
  assert got == want
  fleet, solo, again = got
  assert "serve_completed 22" in fleet and "fleet_owners_dead 2.0" in fleet
  assert "serve_completed 10" in solo
  assert "serve_completed 23" in again


def test_fleet_rollup_snapshot_ttl_expiry_and_sweep_on_push():
  local = telemetry.MetricsRegistry()
  local.counter("serve/completed").inc(10)
  member = telemetry.MetricsRegistry()
  member.counter("serve/completed").inc(7)
  with telemetry.MetricsServer(local, snapshot_ttl_s=0.25) as server:
    server.push("owner-0", member)
    assert "serve_completed 17" in _get(server.fleet_url)
    time.sleep(0.4)
    fleet = _get(server.fleet_url)
    assert "serve_completed 10" in fleet
    assert "telemetry_snapshots_expired 1" in fleet
    assert "telemetry_snapshots_expired 1" in _get(server.fleet_url)
    server.push("owner-0", member)
    assert "serve_completed 17" in _get(server.fleet_url)
  local = telemetry.MetricsRegistry()
  with telemetry.MetricsServer(local, snapshot_ttl_s=0.2) as server:
    server.push("dead-member", member)
    time.sleep(0.3)
    server.push("live-member", member)  # the write sweeps the store
    assert set(server._server._snapshots) == {"live-member"}
    assert local.peek("telemetry/snapshots_expired").value == 1
