"""Host-side span tracing: nestable spans -> Chrome trace-event JSON
(PyTorch port).

A copy of ``distributed_embeddings_tpu/telemetry/trace.py`` up to the
single-process tracer: :func:`span`, the :class:`TraceContext` minted at
batcher admission (:func:`mint_id`, :func:`mint_context`,
:func:`use_context`), :class:`Tracer` and :func:`tracing`, and the one
clock the port's telemetry reads (:func:`clock_ns`). Disabled mode is a
true no-op and the default: :func:`span` returns one process-wide
``_NullSpan`` singleton and allocates nothing.

Not ported yet: the cross-process merge (clock-offset handshake,
``merge_traces``) and the device-track join, which wait for the rest of
the telemetry package.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "TraceContext",
    "Tracer",
    "clock_ns",
    "get_current_context",
    "install_tracer",
    "mint_context",
    "mint_id",
    "set_current_context",
    "span",
    "tracing",
    "uninstall_tracer",
    "use_context",
    "current_tracer",
]

_tracer: Optional["Tracer"] = None


def clock_ns() -> int:
  """The library's one span/handshake clock: ``perf_counter_ns`` (on
  Linux, CLOCK_MONOTONIC — shared by every process on one host, so
  same-host offsets are ~0 and the handshake's estimate is a pure
  uncertainty measurement; across hosts the offset is real)."""
  return time.perf_counter_ns()


# ---------------------------------------------------------------------------
# trace context: minted at admission, carried end-to-end
# ---------------------------------------------------------------------------

# process-unique span-id prefix + a cheap atomic counter: span ids stay
# unique across the processes a merged timeline assembles, without an
# os.urandom syscall per span
_PROC_TAG = os.urandom(4).hex()
_span_seq = itertools.count(1)


def _remint_proc_tag() -> None:
  # a fork()ed child inherits the parent's tag AND counter position —
  # both must re-mint or the two processes emit colliding span ids
  # that silently mis-parent a merged timeline
  global _PROC_TAG, _span_seq
  _PROC_TAG = os.urandom(4).hex()
  _span_seq = itertools.count(1)


if hasattr(os, "register_at_fork"):  # pragma: no branch
  os.register_at_fork(after_in_child=_remint_proc_tag)


def mint_id(nbytes: int = 8) -> str:
  """Mint one opaque hex id (trace ids, subscriber ids). The one
  sanctioned id mint for the request/delta-path packages (GL115)."""
  return os.urandom(int(nbytes)).hex()


def _next_span_id() -> str:
  return f"{_PROC_TAG}-{next(_span_seq):x}"


@dataclasses.dataclass(frozen=True)
class TraceContext:
  """One request's identity as it crosses process boundaries.

  Attributes:
    trace_id: the request's (or the dispatch's primary) trace id.
    span_id: the CURRENT span — a span opened under this context
      becomes its child (``parent_span_id = span_id``).
    epoch_ns: the origin process's :func:`clock_ns` at mint — with a
      handshaked offset, any receiver can bound the request's age.
    trace_ids: every trace id riding this context (a micro-batched
      dispatch carries all of its coalesced requests' ids, so each
      request's id appears on every process track the dispatch
      touches). Defaults to ``(trace_id,)``.
  """

  trace_id: str
  span_id: str
  epoch_ns: int
  trace_ids: Tuple[str, ...] = ()

  def to_wire(self) -> Dict[str, Any]:
    out = {"tid": self.trace_id, "sid": self.span_id,
           "epoch_ns": int(self.epoch_ns)}
    if len(self.trace_ids) > 1:
      out["tids"] = list(self.trace_ids)
    return out

  @classmethod
  def from_wire(cls, d: Dict[str, Any]) -> "TraceContext":
    return cls(trace_id=str(d["tid"]), span_id=str(d["sid"]),
               epoch_ns=int(d.get("epoch_ns", 0)),
               trace_ids=tuple(d.get("tids", ())) or (str(d["tid"]),))


def mint_context(trace_ids: Sequence[str] = ()) -> TraceContext:
  """Mint a fresh root context (a new trace id, a root span id, this
  process's epoch). ``trace_ids``: member ids a coalescing context
  carries (the dispatch form); the primary id is the first."""
  ids = tuple(trace_ids)
  tid = ids[0] if ids else mint_id(8)
  return TraceContext(trace_id=tid, span_id=_next_span_id(),
                      epoch_ns=clock_ns(), trace_ids=ids or (tid,))


_ctx_tls = threading.local()


def get_current_context() -> Optional[TraceContext]:
  return getattr(_ctx_tls, "ctx", None)


def set_current_context(ctx: Optional[TraceContext]
                        ) -> Optional[TraceContext]:
  """Install ``ctx`` as this thread's current context; returns the
  previous one (restore it when done — or use :class:`use_context`)."""
  prev = getattr(_ctx_tls, "ctx", None)
  _ctx_tls.ctx = ctx
  return prev


class use_context:
  """``with use_context(ctx): ...`` — scope a context to a block (the
  fan-out worker / RPC-handler form). ``None`` is legal and clears the
  context for the block."""

  __slots__ = ("ctx", "_prev")

  def __init__(self, ctx: Optional[TraceContext]):
    self.ctx = ctx

  def __enter__(self) -> Optional[TraceContext]:
    self._prev = set_current_context(self.ctx)
    return self.ctx

  def __exit__(self, exc_type, exc, tb):
    set_current_context(self._prev)
    return False


class _NullSpan:
  """The disabled-mode span: a process-wide singleton whose enter/exit
  do nothing.  ``start``/``finish`` support the cross-function window
  form (``span(...).start()`` ... ``.finish()``)."""

  __slots__ = ()

  def __enter__(self):
    return self

  def __exit__(self, exc_type, exc, tb):
    return False

  def start(self):
    return self

  def finish(self):
    return None


_NULL_SPAN = _NullSpan()


class _Span:
  """One live span: records on exit into its tracer.  Exit/finish is
  idempotent — a protocol that syncs earlier than its tail (the
  resilient tiered step's metric fetch) may close the window at the
  true first sync and let the tail's finish be a no-op.

  Under a current :class:`TraceContext`, the span mints its own span id,
  becomes the context's child, and (context-manager form only) installs
  itself as the current context for the block — so nesting and
  cross-process parenting fall out of the thread-local alone. The
  ``start()/finish()`` window form captures the parent but never pushes
  (the window may finish on another thread or not at all)."""

  __slots__ = ("_tracer", "name", "track", "args", "_t0", "_done",
               "_ctx", "_parent_id", "_restore", "_windowed")

  def __init__(self, tracer: "Tracer", name: str, track: Optional[str],
               args: Optional[Dict[str, Any]]):
    self._tracer = tracer
    self.name = name
    self.track = track
    self.args = args
    self._t0 = 0
    self._done = False
    self._ctx: Optional[TraceContext] = None
    self._parent_id: Optional[str] = None
    self._restore = False
    self._windowed = False

  def __enter__(self):
    cur = get_current_context()
    if cur is not None:
      self._ctx = TraceContext(cur.trace_id, _next_span_id(),
                               cur.epoch_ns, cur.trace_ids)
      self._parent_id = cur.span_id
      if not self._windowed:
        set_current_context(self._ctx)
        self._restore = True
    self._t0 = time.perf_counter_ns()
    return self

  def __exit__(self, exc_type, exc, tb):
    if not self._done:
      self._done = True
      if self._restore:
        # restore the parent (pushed only when a context was current)
        set_current_context(
            TraceContext(self._ctx.trace_id, self._parent_id,
                         self._ctx.epoch_ns, self._ctx.trace_ids))
      self._tracer._record(self)
    return False

  @property
  def context(self) -> Optional[TraceContext]:
    return self._ctx

  # cross-function window form (e.g. device dispatch -> first host sync)
  def start(self):
    self._windowed = True
    return self.__enter__()

  def finish(self):
    self.__exit__(None, None, None)


def span(name: str, track: Optional[str] = None,
         args: Optional[Dict[str, Any]] = None):
  """A context manager timing one pipeline stage.

  ``track`` names a virtual track (e.g. ``"device"``) instead of the
  calling thread's; ``args`` is an optional JSON-able payload shown in
  the trace viewer.  With tracing disabled this returns the no-op
  singleton and allocates nothing."""
  tr = _tracer
  if tr is None:
    return _NULL_SPAN
  return _Span(tr, name, track, args)


def instant(name: str, track: Optional[str] = None) -> None:
  """A zero-duration marker event (no-op when tracing is disabled)."""
  tr = _tracer
  if tr is not None:
    tr._instant(name, track)


class Tracer:
  """Collects span events and renders Chrome trace-event JSON.

  Buffers are per thread (``threading.local``): the hot path is an
  unlocked list append; the tracer's lock is taken only when a thread
  records its FIRST event (buffer registration) and at render time.
  Events carry their track key, so a span targeting a virtual track is
  still appended to the calling thread's buffer."""

  def __init__(self, label: str = "distributed_embeddings_torch"):
    self._lock = threading.Lock()
    self._local = threading.local()
    self._buffers: List[List[tuple]] = []
    self._threads: Dict[int, str] = {}
    self.label = str(label)
    self.t0_ns = time.perf_counter_ns()

  # ---- recording ----------------------------------------------------------
  def _buffer(self) -> List[tuple]:
    buf = getattr(self._local, "buf", None)
    if buf is None:
      t = threading.current_thread()
      buf = self._local.buf = []
      with self._lock:
        # the track key is the registration index, NOT t.ident: CPython
        # reuses idents after a thread exits, so two short-lived writer
        # threads (ckpt-writer-<k>, ckpt-writer-<k+n>) would otherwise
        # merge onto one misnamed track
        key = len(self._buffers)
        self._buffers.append(buf)
        self._threads[key] = t.name
      self._local.tid = key
    return buf

  def _record(self, sp: _Span) -> None:
    t1 = time.perf_counter_ns()
    args = sp.args
    if sp._ctx is not None:
      args = dict(args) if args else {}
      args["trace_id"] = sp._ctx.trace_id
      args["span_id"] = sp._ctx.span_id
      if sp._parent_id is not None:
        args["parent_span_id"] = sp._parent_id
      if len(sp._ctx.trace_ids) > 1:
        args["trace_ids"] = list(sp._ctx.trace_ids)
    self._buffer().append(
        ("X", sp.track or self._local.tid, sp.name, sp._t0, t1 - sp._t0,
         args))

  def _instant(self, name: str, track: Optional[str]) -> None:
    t = time.perf_counter_ns()
    self._buffer().append(
        ("i", track or self._local.tid, name, t, 0, None))

  def record_window(self, name: str, t0_ns: int, t1_ns: int,
                    track: Optional[str] = None,
                    args: Optional[Dict[str, Any]] = None) -> None:
    """Record an already-measured ``[t0_ns, t1_ns)`` window (the
    ``timed`` helper's path — its clock reads happen either way, so it
    hands the finished window here instead of opening a span)."""
    buf = self._buffer()
    buf.append(("X", track or self._local.tid, name, t0_ns, t1_ns - t0_ns,
                args))

  # ---- rendering ----------------------------------------------------------
  def events(self) -> List[tuple]:
    with self._lock:
      return [e for buf in self._buffers for e in buf]

  def to_chrome(self) -> Dict[str, Any]:
    """The trace as a Chrome trace-event JSON object: one ``pid``, one
    ``tid`` per real thread, virtual tracks as extra tids sorted below
    the threads, ``ts``/``dur`` in microseconds from tracer start."""
    pid = 1
    with self._lock:
      events = [e for buf in self._buffers for e in buf]
      threads = dict(self._threads)
    tids: Dict[Any, int] = {}
    out: List[Dict[str, Any]] = [
        {"ph": "M", "pid": pid, "name": "process_name",
         "args": {"name": self.label}}]

    def tid_of(key) -> int:
      tid = tids.get(key)
      if tid is None:
        tid = tids[key] = len(tids) + 1
        label = threads.get(key, key if isinstance(key, str) else
                            f"thread-{key}")
        out.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_name", "args": {"name": str(label)}})
        # virtual tracks sort below the real threads
        out.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_sort_index",
                    "args": {"sort_index": 1000 + tid
                             if isinstance(key, str) else tid}})
      return tid

    for ph, key, name, t0, dur, args in sorted(
        events, key=lambda e: e[3]):
      ev: Dict[str, Any] = {
          "ph": ph, "pid": pid, "tid": tid_of(key), "name": name,
          "ts": (t0 - self.t0_ns) / 1e3,
      }
      if ph == "X":
        ev["dur"] = dur / 1e3
      if args:
        ev["args"] = dict(args)
      out.append(ev)
    # t0_ns/label/clock ride as top-level keys (Chrome ignores unknown
    # keys): merge_traces recovers absolute perf_counter_ns times from
    # ts + t0_ns, which is what a clock offset can be applied to
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "t0_ns": self.t0_ns, "label": self.label,
            "clock": "perf_counter_ns"}

  def save(self, path: str) -> str:
    """Write the trace as ``chrome://tracing``-viewable JSON through the
    durable-write protocol (tmp + fsync + atomic rename)."""
    from .export import atomic_write_text
    atomic_write_text(path, json.dumps(self.to_chrome()))
    return path


def install_tracer(tracer: Tracer) -> Tracer:
  """Enable tracing process-wide; returns the installed tracer."""
  global _tracer
  _tracer = tracer
  return tracer


def uninstall_tracer() -> Optional[Tracer]:
  """Disable tracing; returns the tracer that was active (if any)."""
  global _tracer
  tr, _tracer = _tracer, None
  return tr


def current_tracer() -> Optional[Tracer]:
  return _tracer


class tracing:
  """``with tracing("trace.json") as tr:`` — install a fresh tracer for
  the block, then save (when a path was given) and uninstall.  The
  previously-installed tracer (if any) is restored on exit, so scoped
  traces compose with a long-lived one."""

  def __init__(self, path: Optional[str] = None,
               label: str = "distributed_embeddings_torch"):
    self.path = path
    self.tracer = Tracer(label=label)
    self._prev: Optional[Tracer] = None

  def __enter__(self) -> Tracer:
    global _tracer
    self._prev = _tracer
    install_tracer(self.tracer)
    return self.tracer

  def __exit__(self, exc_type, exc, tb):
    global _tracer
    _tracer = self._prev
    if self.path is not None:
      os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                  exist_ok=True)
      self.tracer.save(self.path)
    return False
