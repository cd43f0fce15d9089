"""Flight recorder: a bounded ring of recent request traces + debug dumps.

A copy of ``distributed_embeddings_tpu/telemetry/flight.py`` for the PyTorch port
(pure Python; the port imports nothing of the JAX package).

When a fleet misbehaves — a failover fires, a delta is refused, the
batcher sheds load — the question is always "what were the last
requests doing, and where did the slow one spend its time?".  By the
time an operator attaches a profiler the moment is gone.  The
:class:`FlightRecorder` keeps the answer resident: a bounded ring
buffer of the last N per-request (per-dispatch) records, each carrying
a per-stage critical-path breakdown over the serve pipeline's stage
taxonomy::

    queue    submit -> flush pop (the oldest coalesced request's wait)
    pack     request coalescing + padding into the dispatch shape
    rpc      the router's remote owner fan-out (incl. retries/failover)
    gather   staging-buffer build + device upload of the fetched rows
    combine  the jitted serve-step dispatch (route/translate + launch)
    dequant  drain of the async device result to host (the device's
             gather/dequant/combine executes behind this window, on the
             completer thread)

Every stage observation also feeds a ``serve/stage_s/<stage>``
histogram in the registry, so the stage taxonomy is queryable as
percentiles whether or not a recorder is installed.

A TRIP (:meth:`FlightRecorder.trip` / module-level :func:`flight_trip`)
dumps a debug bundle — the ring's request traces, the per-stage
histogram digests, the slowest request's critical path, a metrics
snapshot, and the trip reason — as one JSON file through the durable
write protocol.  Trips fired mid-dispatch defer the dump until the
in-flight records complete (the failed-then-retried request must be IN
its own bundle), and a per-reason rate limit keeps an overload's shed
storm from dumping thousands of bundles.

Like the tracer, the recorder is an installed process-wide singleton
(:func:`install_flight_recorder`); the module-level helpers are no-ops
when none is installed, so the serve path stays cheap by default.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from .registry import MetricsRegistry, get_registry

__all__ = [
    "STAGES",
    "FlightRecorder",
    "RequestRecord",
    "current_flight_recorder",
    "flight_trip",
    "install_flight_recorder",
    "observe_stage",
    "stage",
    "uninstall_flight_recorder",
]

# the serve pipeline's stage taxonomy (docs/ARCHITECTURE.md section 21)
STAGES = ("queue", "pack", "rpc", "gather", "combine", "dequant")

_recorder: Optional["FlightRecorder"] = None
_tls = threading.local()


class RequestRecord:
  """One dispatch's flight record (mutated only by the threads the
  batcher hands it to — flusher then completer — so no lock)."""

  __slots__ = ("trace_id", "trace_ids", "started_wall", "stages", "notes",
               "error", "total_s", "done", "_t0_ns")

  def __init__(self, trace_id: str, trace_ids=()):
    from .trace import clock_ns
    self.trace_id = trace_id
    self.trace_ids = list(trace_ids) or [trace_id]
    self.started_wall = time.time()
    self.stages: Dict[str, float] = {}
    self.notes: List[Dict[str, Any]] = []
    self.error: Optional[str] = None
    self.total_s = 0.0
    self.done = False
    self._t0_ns = clock_ns()

  def observe(self, stage_name: str, seconds: float) -> None:
    self.stages[stage_name] = self.stages.get(stage_name, 0.0) \
        + float(seconds)

  def note(self, kind: str, **detail) -> None:
    self.notes.append({"kind": kind, **detail})

  @property
  def critical_stage(self) -> Optional[str]:
    """The stage this request spent the most time in."""
    if not self.stages:
      return None
    return max(self.stages.items(), key=lambda kv: kv[1])[0]

  def to_json(self) -> Dict[str, Any]:
    return {
        "trace_id": self.trace_id,
        "trace_ids": list(self.trace_ids),
        "started_wall": self.started_wall,
        "total_s": self.total_s,
        "stages": {k: self.stages[k] for k in sorted(self.stages)},
        "critical_stage": self.critical_stage,
        "notes": list(self.notes),
        "error": self.error,
        "done": self.done,
    }


class FlightRecorder:
  """Bounded ring of request records + trip-triggered debug bundles.

  Args:
    dir: where bundles land (``flight_<k>.json``, oldest overwritten
      past ``max_bundles`` — the recorder itself must never fill a
      disk).
    capacity: ring size (the "last N requests" of a bundle).
    registry: the metrics registry stage histograms and the bundle's
      snapshot read from (default: the process-wide one).
    max_bundles: bundle files kept before the sequence wraps.
    min_interval_s: per-reason dump rate limit — a shed storm trips
      once per interval, not once per request.
  """

  def __init__(self, dir: str, capacity: int = 64,
               registry: Optional[MetricsRegistry] = None,
               max_bundles: int = 8, min_interval_s: float = 1.0):
    if capacity < 1:
      raise ValueError(f"capacity must be >= 1, got {capacity}")
    self.dir = str(dir)
    os.makedirs(self.dir, exist_ok=True)
    self.capacity = int(capacity)
    self.registry = registry if registry is not None else get_registry()
    self.max_bundles = int(max_bundles)
    self.min_interval_s = float(min_interval_s)
    self._lock = threading.Lock()
    self._ring: List[RequestRecord] = []            # guarded-by: _lock
    self._live: Dict[int, RequestRecord] = {}       # guarded-by: _lock
    self._pending_trip: Optional[Dict[str, Any]] = None  # guarded-by: _lock
    # the records that were live AT TRIP TIME: the dump fires when THEY
    # end, not when the pipeline fully drains — under sustained load
    # _live never empties, and waiting for it would starve the bundle
    # past the ring's memory of the triggering request
    self._pending_waits: set = set()                # guarded-by: _lock
    # reason -> monotonic stamp
    self._last_dump: Dict[str, float] = {}          # guarded-by: _lock
    self._seq = 0                                   # guarded-by: _lock
    self.bundles: List[str] = []                    # guarded-by: _lock

  # ---- request records ----------------------------------------------------
  def begin(self, trace_id: str, trace_ids=()) -> RequestRecord:
    rec = RequestRecord(trace_id, trace_ids)
    with self._lock:
      self._live[id(rec)] = rec
    return rec

  def bind(self, rec: Optional[RequestRecord]) -> None:
    """Make ``rec`` the calling thread's current record (the batcher
    binds on the flusher thread for pack/dispatch and re-binds on the
    completer thread for the drain)."""
    _tls.rec = rec

  def current(self) -> Optional[RequestRecord]:
    return getattr(_tls, "rec", None)

  def observe_stage(self, stage_name: str, seconds: float,
                    rec: Optional[RequestRecord] = None) -> None:
    rec = rec if rec is not None else self.current()
    if rec is not None:
      rec.observe(stage_name, seconds)

  def note(self, kind: str, **detail) -> None:
    rec = self.current()
    if rec is not None:
      rec.note(kind, **detail)

  def end(self, rec: RequestRecord,
          error: Optional[BaseException] = None) -> None:
    from .trace import clock_ns
    rec.total_s = (clock_ns() - rec._t0_ns) / 1e9
    rec.error = None if error is None else repr(error)
    rec.done = True
    pending = None
    with self._lock:
      self._live.pop(id(rec), None)
      self._ring.append(rec)
      if len(self._ring) > self.capacity:
        del self._ring[:len(self._ring) - self.capacity]
      if self._pending_trip is not None:
        self._pending_waits.discard(id(rec))
        if not self._pending_waits:
          pending, self._pending_trip = self._pending_trip, None
    if pending is not None:
      self._dump(pending)

  # ---- trips --------------------------------------------------------------
  def trip(self, reason: str, defer: bool = False,
           **detail) -> Optional[str]:
    """A failover/refusal/shed fired: dump a debug bundle.  Deferred
    until the in-flight dispatch completes (its record — the one the
    trip is usually ABOUT — must be in the bundle); a pending trip is
    never overwritten by a later one (first reason wins — the earliest
    moment is the one worth capturing); rate-limited per reason.
    ``defer=True`` moves an otherwise-inline dump to a one-shot daemon
    thread (the batcher's shed path trips while holding its submit
    lock — a write+fsync there would stall every submitter).  Returns
    the bundle path when dumped inline."""
    self.registry.counter("flight/trips").inc()
    self.registry.counter(
        f"flight/trips/{reason.split('/', 1)[0]}").inc()
    now = time.monotonic()
    with self._lock:
      last = self._last_dump.get(reason)
      if last is not None and now - last < self.min_interval_s:
        return None
      record = {"reason": reason, "detail": detail, "wall": time.time()}
      if self._live:
        if self._pending_trip is None:
          self._pending_trip = record
          self._pending_waits = set(self._live)
          # the stamp is recorded only for trips that WILL dump — a
          # trip dropped because another is pending must not consume
          # its reason's rate-limit window
          self._last_dump[reason] = now
        return None
      self._last_dump[reason] = now
    if defer:
      threading.Thread(target=self._dump, args=(record,),
                       name="flight-dump", daemon=True).start()
      return None
    return self._dump(record)

  def dump_now(self, reason: str, **detail) -> str:
    """Unconditional bundle (tools' end-of-run capture)."""
    return self._dump({"reason": reason, "detail": detail,
                       "wall": time.time()})

  # ---- the bundle ---------------------------------------------------------
  def _stage_digest(self) -> Dict[str, Any]:
    out = {}
    for name, m in sorted(self.registry.metrics().items()):
      if name.startswith("serve/stage_s/") and m.kind == "histogram":
        out[name.split("/")[-1]] = {
            "count": m.count, "total_s": m.sum, "p50": m.p50,
            "p99": m.p99, "max": m.max}
    return out

  def snapshot(self) -> Dict[str, Any]:
    """The bundle body (also the tools' verdict section)."""
    with self._lock:
      ring = list(self._ring)
      live = list(self._live.values())
    requests = [r.to_json() for r in ring] + [r.to_json() for r in live]
    slowest = max(ring, key=lambda r: r.total_s, default=None)
    return {
        "requests": requests,
        "slowest": None if slowest is None else slowest.to_json(),
        "stage_s": self._stage_digest(),
        "metrics": self.registry.snapshot(),
    }

  def _dump(self, trip_record: Dict[str, Any]) -> str:
    from .export import atomic_write_text
    body = dict(trip_record)
    body.update(self.snapshot())
    with self._lock:
      seq = self._seq
      self._seq += 1
    path = os.path.join(self.dir,
                        f"flight_{seq % self.max_bundles}.json")
    atomic_write_text(path, json.dumps(body, indent=1, sort_keys=True))
    with self._lock:
      if path not in self.bundles:
        self.bundles.append(path)
    self.registry.counter("flight/bundles").inc()
    return path


# ---------------------------------------------------------------------------
# module-level surface (no-op safe, like the tracer's)
# ---------------------------------------------------------------------------


def install_flight_recorder(rec: FlightRecorder) -> FlightRecorder:
  global _recorder
  _recorder = rec
  return rec


def uninstall_flight_recorder() -> Optional[FlightRecorder]:
  global _recorder
  rec, _recorder = _recorder, None
  return rec


def current_flight_recorder() -> Optional[FlightRecorder]:
  return _recorder


def flight_trip(reason: str, defer: bool = False,
                **detail) -> Optional[str]:
  """Trip the installed recorder (no-op without one): the one hook the
  failover/refusal/shed paths call."""
  rec = _recorder
  if rec is None:
    return None
  return rec.trip(reason, defer=defer, **detail)


def observe_stage(stage_name: str, seconds: float,
                  registry: Optional[MetricsRegistry] = None) -> None:
  """Feed one stage observation: into the ``serve/stage_s/<stage>``
  histogram — the installed recorder's registry when one is installed
  (the bundle's stage digests must see every stage, whichever
  component emitted it), else the emitting component's ``registry``
  (exact per-component accounting, the batcher's private-registry
  contract), else the process-wide one — and into the current request
  record when a recorder is installed."""
  rec = _recorder
  reg = rec.registry if rec is not None else (
      registry if registry is not None else get_registry())
  reg.histogram(f"serve/stage_s/{stage_name}").observe(seconds)
  if rec is not None:
    rec.observe_stage(stage_name, seconds)


class stage:
  """Time one pipeline stage into the stage taxonomy::

      with flight.stage("rpc"):
          fan_out()

  Clock reads live here (telemetry/ is the GL113/GL115-sanctioned
  home); the elapsed seconds go to the stage histogram and the current
  flight record.  ``.elapsed`` holds the seconds after exit."""

  __slots__ = ("name", "registry", "elapsed", "_t0")

  def __init__(self, name: str, registry: Optional[MetricsRegistry] = None):
    self.name = name
    self.registry = registry
    self.elapsed = 0.0

  def __enter__(self) -> "stage":
    from .trace import clock_ns
    self._t0 = clock_ns()
    return self

  def __exit__(self, exc_type, exc, tb):
    from .trace import clock_ns
    self.elapsed = (clock_ns() - self._t0) / 1e9
    observe_stage(self.name, self.elapsed, registry=self.registry)
    return False
