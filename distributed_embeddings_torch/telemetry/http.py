"""Live ``/metrics`` scrape endpoint over the Prometheus renderer
(PyTorch port of ``distributed_embeddings_tpu/telemetry/http.py``).

The textfile exporter (:func:`.export.write_prometheus`) covers the
node-exporter deployment shape — a sidecar reads a file the process
atomically replaces.  A live serving or training process wants the other
standard shape too: Prometheus scraping ``GET /metrics`` straight off
the process, no file and no sidecar.  :class:`MetricsServer` is that
endpoint — a stdlib ``ThreadingHTTPServer`` on a daemon thread rendering
:func:`.export.prometheus_text` per request, so the scrape always sees a
point-in-time consistent snapshot (the registry lock is taken once per
render, never held across the socket write).

**Fleet roll-up** (``GET /metrics?scope=fleet``): a fleet of serving
processes each keeps a private registry for exact per-process
accounting; the roll-up view answers "what is the FLEET doing" from one
scrape.  Members push registry snapshots (``state_dict()`` JSON) — in
process via :meth:`MetricsServer.push`, or over HTTP via
``POST /push`` with ``{"source": id, "telemetry": state_dict}`` — and
the fleet scope renders this process's registry MERGED with every
pushed snapshot through ``MetricsRegistry.merge``: counters and
histogram buckets ADD, gauges take the LAST writer (push order), metric
geometry mismatches fail the scrape loudly.  Snapshots replace by
source id, so a re-pushing member never double-counts.  With
``snapshot_ttl_s`` set, a snapshot older than the TTL DROPS from the
roll-up — counted once per newly-expired source
(``telemetry/snapshots_expired``), re-entering on the next push — the
publisher's heartbeat-quorum rule applied to the metrics plane: a dead
member's last numbers must not be reported as the fleet's forever.

**Readiness detail** (``GET /healthz``): a JSON body carrying the
served train watermark (``stream/served_step``), the last promote wall
time, and the computed STALENESS age in seconds — so a stalled
subscriber (live process, dead freshness) is visible from the probe
alone, without scraping and joining two metrics.  Both gauges are set
through :func:`record_promote` at each promote; a process that never
promoted reports nulls.  A ``MicroBatcher`` whose flusher or completer
thread died sets :data:`DEAD_THREAD_GAUGE_STEM` gauges, and the probe
then answers ``ok: false`` with the dead threads' names.

Lifecycle is explicit and shutdown-clean: ``close()`` (or the context
manager) shuts the serve loop down, closes the listening socket, and
JOINS the serve thread — a test or a draining server never leaks the
port or the thread.  Bind ``port=0`` to let the OS pick a free port
(``server.port`` reports the bound one).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse

from .export import prometheus_text
from .registry import MetricsRegistry, get_registry

__all__ = ["MetricsServer", "record_promote", "clear_promote"]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# the readiness-detail gauge names the /healthz probe scans; the ONE
# place they are spelled — subscribers/followers write and clear them
# through the helpers below, never by hand
PROMOTE_GAUGE_STEMS = ("stream/served_step",
                       "stream/last_promote_unixtime")

# set (unkeyed + keyed by thread name) by a MicroBatcher whose
# flusher/completer thread died of an unexpected exception — the probe
# turns it into ok=False + the dead thread names, so a serving process
# whose batcher silently lost its engine room fails readiness instead
# of answering "ok" while every request times out
DEAD_THREAD_GAUGE_STEM = "serve/flusher_dead"


def record_promote(registry: MetricsRegistry, step: int,
                   subscriber_id: Optional[str] = None) -> None:
  """Set the /healthz readiness-detail gauges for one promote: the
  served train watermark and the promote wall time, BOTH unkeyed
  (single-subscriber convenience, last-writer) and keyed by
  ``subscriber_id`` — the keyed pair keeps a stalled member visible
  when followers share one registry (the probe reports the MOST STALE
  member)."""
  now = time.time()
  step_g, wall_g = PROMOTE_GAUGE_STEMS
  registry.gauge(step_g).set(int(step))
  registry.gauge(wall_g).set(now)
  if subscriber_id:
    registry.gauge(f"{step_g}/{subscriber_id}").set(int(step))
    registry.gauge(f"{wall_g}/{subscriber_id}").set(now)


def clear_promote(registry: MetricsRegistry,
                  subscriber_id: Optional[str] = None) -> None:
  """Leave the /healthz quorum: a DELIBERATELY stopped member removes
  its keyed promote gauges AND the unkeyed pair (last-writer state
  about a decommissioned member must not read as a stalled subscriber
  forever — a live sibling's next promote re-sets the unkeyed pair,
  and its keyed pair keeps the probe correct meanwhile). A genuinely
  stalled member never calls this, so it stays visible."""
  for stem in PROMOTE_GAUGE_STEMS:
    registry.remove(stem)
    if subscriber_id:
      registry.remove(f"{stem}/{subscriber_id}")


class _Handler(BaseHTTPRequestHandler):
  """One registry, three routes: ``/metrics`` (Prometheus text —
  ``?scope=fleet`` renders the merged roll-up), ``/healthz`` (liveness
  ping), and ``POST /push`` (fleet snapshot ingestion). Everything else
  is 404."""

  # the registry rides the SERVER object (one handler instance per
  # request; BaseHTTPRequestHandler offers no clean per-handler state)
  def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler's contract
    parsed = urlparse(self.path)
    path = parsed.path
    if path == "/metrics":
      scope = parse_qs(parsed.query).get("scope", ["self"])[0]
      try:
        registry = self.server.fleet_registry() if scope == "fleet" \
            else self.server.registry
        body = prometheus_text(registry).encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
      except ValueError as e:
        # a geometry mismatch across members must fail the scrape
        # loudly, not render half a fleet
        body = f"fleet merge failed: {e}\n".encode("utf-8")
        self.send_response(500)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
    elif path == "/healthz":
      body = json.dumps(self.server.health()).encode("utf-8") + b"\n"
      self.send_response(200)
      self.send_header("Content-Type", "application/json; charset=utf-8")
    else:
      body = b"not found: /metrics, /healthz and POST /push are served\n"
      self.send_response(404)
      self.send_header("Content-Type", "text/plain; charset=utf-8")
    self.send_header("Content-Length", str(len(body)))
    self.end_headers()
    self.wfile.write(body)

  def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler's contract
    if urlparse(self.path).path != "/push":
      body = b"not found\n"
      self.send_response(404)
    else:
      try:
        n = int(self.headers.get("Content-Length", "0"))
        payload = json.loads(self.rfile.read(n).decode("utf-8"))
        self.server.push(str(payload["source"]), payload["telemetry"])
        body = b"ok\n"
        self.send_response(200)
      except (ValueError, KeyError, TypeError) as e:
        body = f"bad push payload: {e}\n".encode("utf-8")
        self.send_response(400)
    self.send_header("Content-Type", "text/plain; charset=utf-8")
    self.send_header("Content-Length", str(len(body)))
    self.end_headers()
    self.wfile.write(body)

  def log_message(self, format, *args):  # noqa: A002 — base signature
    pass  # scrapes every few seconds must not spam the process log


class _Server(ThreadingHTTPServer):
  daemon_threads = True  # per-request handler threads die with close()
  registry: MetricsRegistry
  snapshot_ttl_s: Optional[float] = None

  def __init__(self, *args, **kwargs):
    super().__init__(*args, **kwargs)
    self._push_lock = threading.Lock()
    # source -> (monotonic push stamp, section); insertion-ordered
    self._snapshots: Dict[str, Any] = {}

  def push(self, source: str, section: Dict[str, Any]) -> None:
    # validate BEFORE adopting: a malformed snapshot must fail ITS push
    # (400 to the sender), never poison every later fleet scrape — the
    # throwaway load raises exactly what fleet_registry() would have
    try:
      MetricsRegistry().load_state_dict(section)
    except (ValueError, TypeError, KeyError, AttributeError) as e:
      raise ValueError(
          f"snapshot from {source!r} is not a registry state_dict: {e}"
      ) from e
    now = time.monotonic()
    with self._push_lock:
      # replace-by-source: a member re-pushing moves to the back of the
      # last-writer order and never double-counts; a re-push also
      # REVIVES an expired member (the heartbeat-quorum rule)
      self._snapshots.pop(source, None)
      self._snapshots[source] = (now, section)
      # sweep on every WRITE too — a churning fleet whose operator
      # never scrapes ?scope=fleet must not accumulate dead source
      # ids' sections forever (the sweep-on-read alone would only
      # evict when someone asks for the roll-up)
      expired = self._sweep_expired_locked(now)
    self._count_expired(expired)

  def _sweep_expired_locked(self, now: float) -> list:
    """Drop every snapshot older than the TTL from the store (caller
    holds ``_push_lock``); returns the evicted source ids. Expired
    members drop from the roll-up AND from the store — counted once
    per expiry by construction (mirroring ``stream/
    subscribers_expired``; a re-push revives): stale numbers from a
    dead process must not masquerade as the fleet's current state."""
    ttl = self.snapshot_ttl_s
    if ttl is None:
      return []
    expired = [source for source, (stamp, _) in self._snapshots.items()
               if now - stamp > ttl]
    for source in expired:
      del self._snapshots[source]
    return expired

  def _count_expired(self, expired: list) -> None:
    if expired:
      self.registry.counter("telemetry/snapshots_expired").inc(
          len(expired))

  def fleet_registry(self) -> MetricsRegistry:
    now = time.monotonic()
    with self._push_lock:
      expired = self._sweep_expired_locked(now)
      snaps = [section for _, section in self._snapshots.values()]
    self._count_expired(expired)
    merged = MetricsRegistry()
    merged.merge(self.registry)
    for section in snaps:
      tmp = MetricsRegistry()
      tmp.load_state_dict(section)
      merged.merge(tmp)
    return merged

  def health(self) -> Dict[str, Any]:
    """The /healthz readiness body: served watermark + staleness age.

    Subscribers/followers set BOTH an unkeyed gauge pair (single
    -subscriber convenience, last-writer) and per-subscriber keyed
    pairs (``.../<subscriber_id>``); the probe scans every
    ``stream/last_promote_unixtime*`` gauge and reports the MOST STALE
    member — a stalled follower must not be masked by a healthy
    sibling's later write.  Reads via the metrics map (never creating
    gauges a process hasn't earned); the names are
    :data:`PROMOTE_GAUGE_STEMS` — spelled once, written/cleared only
    through :func:`record_promote` / :func:`clear_promote`."""
    step_g, wall_g = PROMOTE_GAUGE_STEMS
    lasts: Dict[str, float] = {}
    steps: Dict[str, int] = {}
    dead_threads: list = []
    for name, m in self.registry.metrics().items():
      if name == wall_g:
        lasts[""] = float(m.value)
      elif name.startswith(wall_g + "/"):
        lasts[name.rsplit("/", 1)[1]] = float(m.value)
      elif name == step_g:
        steps[""] = int(m.value)
      elif name.startswith(step_g + "/"):
        steps[name.rsplit("/", 1)[1]] = int(m.value)
      elif name.startswith(DEAD_THREAD_GAUGE_STEM + "/") and m.value:
        # a batcher worker thread died (MicroBatcher._on_worker_death):
        # the process is alive but cannot serve — readiness must say so
        dead_threads.append(name.rsplit("/", 1)[1])
    out: Dict[str, Any]
    if not lasts:
      step = steps.get("")
      out = {"ok": True, "served_step": step,
             "last_promote_unix": None, "staleness_s": None}
    else:
      stalest = min(lasts, key=lambda k: lasts[k])
      last_wall = lasts[stalest]
      step = steps.get(stalest, steps.get(""))
      out = {
          "ok": True,
          "served_step": step,
          "last_promote_unix": last_wall,
          "staleness_s": max(0.0, time.time() - last_wall),
          "members": len([k for k in lasts if k]) or None,
      }
    if dead_threads:
      out["ok"] = False
      out["dead_threads"] = sorted(dead_threads)
    return out


class MetricsServer:
  """Serve a registry at ``http://host:port/metrics`` until closed.

  Args:
    registry: the registry to expose (default: the process-wide one).
    host: bind address — default loopback; bind ``"0.0.0.0"`` only when
      the scraper really is remote.
    port: TCP port; ``0`` (the default) picks a free one, reported by
      :attr:`port` / :attr:`url`.
    snapshot_ttl_s: fleet roll-up TTL — a pushed member snapshot older
      than this drops from ``?scope=fleet`` (counted once per expiry
      through ``telemetry/snapshots_expired``; a re-push revives).
      ``None`` (the default) keeps every snapshot forever.
  """

  def __init__(self, registry: Optional[MetricsRegistry] = None,
               host: str = "127.0.0.1", port: int = 0,
               snapshot_ttl_s: Optional[float] = None):
    self._server = _Server((host, port), _Handler)
    self._server.registry = registry if registry is not None \
        else get_registry()
    self._server.snapshot_ttl_s = None if snapshot_ttl_s is None \
        else float(snapshot_ttl_s)
    self.host = self._server.server_address[0]
    self.port = int(self._server.server_address[1])
    self._thread = threading.Thread(
        target=self._server.serve_forever, name="telemetry-metrics-http",
        daemon=True)
    self._thread.start()

  @property
  def url(self) -> str:
    return f"http://{self.host}:{self.port}/metrics"

  @property
  def fleet_url(self) -> str:
    return f"http://{self.host}:{self.port}/metrics?scope=fleet"

  def push(self, source: str, snapshot) -> None:
    """Adopt one fleet member's registry snapshot for the fleet scope.
    ``snapshot``: a ``MetricsRegistry`` (its ``state_dict()`` is taken
    now) or a ``state_dict()``-shaped JSON section."""
    if isinstance(snapshot, MetricsRegistry):
      snapshot = snapshot.state_dict()
    self._server.push(source, snapshot)

  def health(self) -> Dict[str, Any]:
    """The /healthz readiness body (also served over HTTP)."""
    return self._server.health()

  @property
  def closed(self) -> bool:
    return not self._thread.is_alive()

  def close(self) -> None:
    """Stop serving: shut the loop down, close the socket, join the
    thread. Idempotent."""
    if self._thread.is_alive():
      self._server.shutdown()
      self._thread.join(timeout=10.0)
    self._server.server_close()

  def __enter__(self) -> "MetricsServer":
    return self

  def __exit__(self, exc_type, exc, tb):
    self.close()
    return False
