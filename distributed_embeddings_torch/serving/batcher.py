"""Request micro-batcher: concurrent queries -> one padded device dispatch.

A copy of ``distributed_embeddings_tpu/serving/batcher.py`` for the
PyTorch port, with two differences: ``dispatch_fn`` (``ServeEngine.
dispatch``) returns a torch tensor, on the card in production, which
``np.asarray`` cannot read; the completer materializes it with
``.cpu()`` (the synchronization point) and de-interleaves the numpy
rows. And a request's categorical input may be a ``RaggedIds``: a flush
packs the requests' live value streams into one stream (splits offset,
the padded tail rows of length 0), its capacity the smallest power of
two that holds them, so a dispatch's bucket shapes take few values. The
padded dispatch's ``PAD_ID`` rows route to the sentinel, which the serve
gather reads as zero rows without indexing a serve block.

A serving device wants one big batch; users send many small concurrent
requests. The :class:`MicroBatcher` sits between them:

- **coalesce**: concurrent variable-size requests append to a FIFO; a
  flush packs whole requests (requests are never split) into one
  ``[max_batch, ...]`` dispatch, padding the tail with ``PAD_ID``
  categorical rows (the engine's hotness-padding sentinel — padded rows
  gather zero rows and their predictions are sliced off, never
  delivered).
- **deadline-or-full flush**: a flush fires when the packed rows reach
  ``max_batch`` (full) or the OLDEST pending request has waited
  ``max_delay_s`` (deadline) — the knob trading per-request latency
  against device efficiency. The padded dispatch shape is constant, so
  the serve step traces exactly once per batcher.
- **bounded queue, counted load-shed**: at most ``queue_rows`` rows may
  be pending; a request that would exceed the bound is REJECTED
  immediately (:class:`Rejected`, ``stats['rejected']`` counts it)
  instead of queueing into unbounded latency. Overload shows up as an
  explicit error rate at the edge — the only place it can be handled —
  not as a p99 that grew past every deadline.
- **pipelined completion**: the flusher thread hands the (asynchronous)
  device dispatch to a completer thread and immediately packs the next
  batch, so host-side packing and de-interleave overlap device compute;
  ``pipeline_depth`` bounds the in-flight dispatches.

De-interleave is positional: request k's predictions are exactly rows
``[off_k, off_k + n_k)`` of the dispatch result — the property test
pins that every request gets its own rows back under random arrival
interleavings.

Telemetry: the counters live in a ``telemetry.MetricsRegistry``
(``stats`` is the classic dict view), per-request latency feeds the
``serve/latency_s`` histogram, and the pack/dispatch/complete stages
run under spans — on the flusher/completer threads, so an enabled trace
shows host packing overlapping device compute on separate tracks.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.ragged import RaggedIds
from ..parallel.lookup_engine import PAD_ID
from ..telemetry import DEAD_THREAD_GAUGE_STEM, MetricsRegistry
from ..telemetry import flight as _flight
from ..telemetry import span as _span
from ..telemetry import trace as _trace


def _host_ids(c):
  """A request's categorical input on the host: numpy, or a RaggedIds
  with numpy fields."""
  if isinstance(c, RaggedIds):
    return RaggedIds(*(x.cpu().numpy() if isinstance(x, torch.Tensor)
                       else np.asarray(x) for x in (c.values, c.row_splits)))
  return np.asarray(c)


def _pack_ragged(parts: List[RaggedIds], pad: int) -> RaggedIds:
  """Requests' RaggedIds -> one stream: the live values in request order,
  the splits offset, ``pad`` trailing rows of length 0, the values padded
  to the smallest power of two that holds them."""
  values, lengths = [], []
  for p in parts:
    splits = np.asarray(p.row_splits, np.int64)
    values.append(np.asarray(p.values)[splits[0]:splits[-1]])
    lengths.append(np.diff(splits))
  values = np.concatenate(values)
  lengths = np.concatenate(lengths + [np.zeros(pad, np.int64)])
  total = values.shape[0]
  cap = 1 << max(0, total - 1).bit_length() if total else 0
  values = np.concatenate([values, np.zeros(cap - total, values.dtype)])
  splits = np.concatenate([[0], np.cumsum(lengths)]).astype(
      np.asarray(parts[0].row_splits).dtype)
  return RaggedIds(values, splits)


def _materialize(out) -> np.ndarray:
  """A dispatch result as host numpy: a tensor (on any device) through
  ``.cpu()``, which waits for the device; anything else ``np.asarray``."""
  if isinstance(out, torch.Tensor):
    return out.cpu().numpy()
  return np.asarray(out)


REJECT_REASONS = ("queue_full", "deadline_expired", "priority_shed",
                  "flusher_died")


class Rejected(RuntimeError):
  """The request was shed — counted, never silently dropped.

  ``reason`` names the shed class (callers route their backoff on it):

  - ``'queue_full'``: the bounded queue had no room (and nothing of
    lower priority to evict);
  - ``'deadline_expired'``: the request's own deadline passed before a
    flush could dispatch it;
  - ``'priority_shed'``: a higher-priority request evicted this one
    from the full queue;
  - ``'flusher_died'``: the batcher's flusher or completer thread died
    of an unexpected exception — every queued request failed with this
    reason instead of hanging forever, the flight recorder tripped,
    and the dead-thread gauge names the thread (the batcher is closed;
    rebuild it).

  Each reason has its own counter (``serve/rejected/<reason>``);
  ``serve/rejected`` stays the exact total."""

  def __init__(self, msg: str, reason: str = "queue_full"):
    super().__init__(msg)
    self.reason = reason


class ServeFuture:
  """Per-request handle: blocks on :meth:`result` until the dispatch
  carrying this request completes (or fails, re-raising here)."""

  def __init__(self, n: int):
    self.n = n
    # latency stamps, not stage timing: the delta feeds the telemetry
    # histogram; the flush deadline below needs the same clock
    self.t_submit = time.monotonic()  # graftlint: disable=GL113
    self.t_done: Optional[float] = None
    self._event = threading.Event()
    self._value: Optional[np.ndarray] = None
    self._error: Optional[BaseException] = None

  def _fulfill(self, value: np.ndarray) -> None:
    self.t_done = time.monotonic()  # graftlint: disable=GL113 (latency stamp)
    self._value = value
    self._event.set()

  def _fail(self, exc: BaseException) -> None:
    self.t_done = time.monotonic()  # graftlint: disable=GL113 (latency stamp)
    self._error = exc
    self._event.set()

  def done(self) -> bool:
    return self._event.is_set()

  def result(self, timeout: Optional[float] = None) -> np.ndarray:
    if not self._event.wait(timeout):
      raise TimeoutError("serve request still pending")
    if self._error is not None:
      raise self._error
    return self._value

  @property
  def latency_s(self) -> Optional[float]:
    """submit -> fulfill wall time (None while pending)."""
    return None if self.t_done is None else self.t_done - self.t_submit


class _Pending:
  __slots__ = ("numerical", "cats", "future", "priority", "deadline_s",
               "seq", "trace_id")

  def __init__(self, numerical, cats, future, priority=0,
               deadline_s=None, seq=0, trace_id=None):
    self.numerical = numerical
    self.cats = cats
    self.future = future
    self.priority = priority
    self.deadline_s = deadline_s  # absolute monotonic stamp, or None
    self.seq = seq
    self.trace_id = trace_id  # minted at admission when tracing is on

  def expired(self, now: float) -> bool:
    return self.deadline_s is not None and now >= self.deadline_s


class MicroBatcher:
  """Coalesce concurrent requests into padded fixed-shape dispatches.

  Args:
    dispatch_fn: ``dispatch_fn(numerical [max_batch, F], cats) ->
      preds`` — typically ``ServeEngine.dispatch``. May return a device
      array (completion materializes it on the completer thread, off
      the flush path); the result's leading axis must be ``max_batch``.
    max_batch: the dispatch batch (constant — one trace). Requests
      larger than this are rejected outright.
    max_delay_s: deadline the oldest pending request may wait before a
      partial flush fires.
    queue_rows: pending-row bound (default ``8 * max_batch``); the
      load-shed knob.
    pipeline_depth: max dispatches in flight (completer queue bound).
    start: start the flusher/completer threads (tests drive
      :meth:`flush_now` deterministically with ``start=False``).
    registry: the ``telemetry.MetricsRegistry`` the batcher's counters
      (``serve/submitted|rejected|batches|completed|padded_rows``) and
      request-latency histogram (``serve/latency_s``) live in. Default
      is a PRIVATE registry: the load-shed accounting contract is
      exactly-counted per batcher, and two batchers sharing names would
      merge counts. Pass ``telemetry.get_registry()`` to publish into
      the process-wide registry. ``stats`` stays the classic dict view.
    name: thread-name prefix (``<name>-flush`` / ``<name>-complete``),
      and therefore the key of the per-thread dead-thread gauges. Give each batcher SHARING a registry its own name, or a
      rebuild of one batcher cannot be told apart from its siblings on
      the readiness plane.

  Locking (threadlint-checked — the ``guarded-by`` annotations in
  ``__init__`` are the machine-readable form): ONE plain ``Lock``
  (``_lock``, with ``_nonempty = Condition(_lock)`` over it — holding
  either is holding both) protects all cross-thread state: the queue
  (``_pending``/``_pending_rows``/``_seq``), lifecycle
  (``_closed``/``_dead``/``_orphans``), the admission knobs
  (``queue_rows``/``max_delay_s``) and the ``dispatch_fn`` binding.
  ``_dead`` and ``dispatch_fn`` are locked-write/racy-read by design
  (set-once death flag; one binding captured per flush) — annotated
  ``[writes]``. The ``*_locked`` helpers carry ``requires-lock``
  contracts: callers hold ``_lock``. The in-flight handoff between
  flusher and completer is the (internally synchronized)
  ``_inflight`` queue, not the lock.
  """

  def __init__(self, dispatch_fn: Callable, max_batch: int,
               max_delay_s: float = 0.002,
               queue_rows: Optional[int] = None,
               pipeline_depth: int = 2,
               start: bool = True,
               registry: Optional[MetricsRegistry] = None,
               name: str = "serve-batcher"):
    if max_batch < 1:
      raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    self.dispatch_fn = dispatch_fn          # guarded-by: _lock [writes]
    self.max_batch = int(max_batch)
    self.max_delay_s = float(max_delay_s)   # guarded-by: _lock [writes]
    self.queue_rows = int(queue_rows) if queue_rows is not None \
        else 8 * self.max_batch             # guarded-by: _lock [writes]
    self._lock = threading.Lock()
    self._nonempty = threading.Condition(self._lock)
    self._pending: List[_Pending] = []      # guarded-by: _lock
    self._pending_rows = 0                  # guarded-by: _lock
    self._closed = False                    # guarded-by: _lock
    self.telemetry = registry if registry is not None else MetricsRegistry()
    self._counters = {k: self.telemetry.counter(f"serve/{k}")
                      for k in ("submitted", "rejected", "batches",
                                "completed", "padded_rows")}
    self._counters.update(
        {f"rejected/{r}": self.telemetry.counter(f"serve/rejected/{r}")
         for r in REJECT_REASONS})
    # arrival order (FIFO tie-break within a priority)
    self._seq = 0                           # guarded-by: _lock
    self._latency = self.telemetry.histogram("serve/latency_s")
    self._inflight: _queue.Queue = _queue.Queue(maxsize=max(1,
                                                           pipeline_depth))
    self._flusher: Optional[threading.Thread] = None
    self._completer: Optional[threading.Thread] = None
    # (thread name, exception) once a worker thread died unexpectedly;
    # written once under the lock, read racily (benign: set-once, and
    # every reader path is only reachable after the locked write)
    self._dead: Optional[tuple] = None      # guarded-by: _lock [writes]
    # requests a dying thread had already popped from a queue (neither
    # pending nor in-flight — they would be invisible to the drain)
    self._orphans: List[_Pending] = []      # guarded-by: _lock
    # a REBUILT batcher on the same registry supersedes the dead one
    # with the SAME name (the Rejected message says "rebuild the
    # batcher"): clear ITS OWN dead-thread gauges only — a still-dead
    # sibling batcher (distinct name=) must keep its gauge set — and
    # re-derive the unkeyed aggregate from whatever keyed gauges remain
    self._flush_name = f"{name}-flush"
    self._complete_name = f"{name}-complete"
    metrics = self.telemetry.metrics()
    for t in (self._flush_name, self._complete_name):
      key = f"{DEAD_THREAD_GAUGE_STEM}/{t}"
      if key in metrics:
        self.telemetry.gauge(key).set(0)
    if DEAD_THREAD_GAUGE_STEM in metrics:
      others = any(
          n.startswith(DEAD_THREAD_GAUGE_STEM + "/") and m.value
          for n, m in self.telemetry.metrics().items())
      self.telemetry.gauge(DEAD_THREAD_GAUGE_STEM).set(1 if others else 0)
    if start:
      self._flusher = threading.Thread(
          target=self._guarded_loop,
          args=(self._flush_name, self._flush_loop),
          name=self._flush_name, daemon=True)
      self._completer = threading.Thread(
          target=self._guarded_loop,
          args=(self._complete_name, self._complete_loop),
          name=self._complete_name, daemon=True)
      self._flusher.start()
      self._completer.start()

  # ---- worker-thread death (no request may hang forever) ------------------
  def _guarded_loop(self, name: str, loop: Callable) -> None:
    try:
      loop()
    except BaseException as e:  # noqa: BLE001 — the thread IS the engine
      # room: an escaped exception here used to kill the thread silently
      # and leave every queued waiter blocked forever
      self._on_worker_death(name, e)

  def _on_worker_death(self, name: str, exc: BaseException) -> None:
    """A flusher/completer thread died of an UNEXPECTED exception (a
    dispatch failure is expected and delivered per request; this is a
    bug in the batcher's own machinery or a monkey-wrenched callback).
    Queued requests would otherwise hang forever: fail every pending
    and in-flight request with a counted ``flusher_died`` shed, close
    the batcher, trip the flight recorder (via the shed path), and
    surface the dead thread through the gauge a health probe scans
    (``telemetry.DEAD_THREAD_GAUGE_STEM``, the JAX package's name)."""
    with self._nonempty:
      if self._dead is None:
        self._dead = (name, exc)
      self._closed = True
      pending = self._pending[:]
      self._pending.clear()
      self._pending_rows = 0
      # the swap must happen under the lock: the OTHER worker thread's
      # exception path appends orphans too, and a racy swap here could
      # strand its orphan forever (threadlint GL120 caught this)
      orphans, self._orphans = self._orphans, []
      self._nonempty.notify_all()
    self.telemetry.gauge(DEAD_THREAD_GAUGE_STEM).set(1)
    self.telemetry.gauge(f"{DEAD_THREAD_GAUGE_STEM}/{name}").set(1)
    # one shed count PER failed request (the exact-accounting contract)
    for p in pending + orphans:
      if not p.future.done():
        p.future._fail(self._dead_rejected())
    self._drain_inflight_dead()

  def _drain_inflight_dead(self) -> None:
    """Fail every dispatched-but-uncompleted in-flight item: their
    waiters block on the completer, which may be the thread that just
    died (and a flusher blocked on a full in-flight queue is unblocked
    by this). Called by the death handler AND by ``_dispatch`` after an
    enqueue that raced the handler's one-shot drain — idempotent
    (already-failed futures are skipped), so both draining is safe and
    no item can land in the queue after the last drain unseen."""
    _name, exc = self._dead
    items = []
    while True:
      try:
        item = self._inflight.get_nowait()
      except _queue.Empty:
        break
      if item is not None:
        items.append(item)
    try:
      self._inflight.put_nowait(None)  # stop the surviving loop thread
    except _queue.Full:
      pass
    for taken, _out, rec, _ctx, fr in items:
      for p in taken:
        if not p.future.done():
          p.future._fail(self._dead_rejected())
      if fr is not None and rec is not None:
        try:
          fr.end(rec, error=exc)
        except BaseException:  # noqa: BLE001 — a broken recorder may be
          pass  # WHY the thread died; it must not abort the drain and
          # strand the remaining items' waiters

  def _dead_rejected(self) -> Rejected:
    name, exc = self._dead
    return self._reject(
        "flusher_died",
        f"MicroBatcher thread {name!r} died: {exc!r} — the batcher is "
        "closed; queued requests were failed (counted "
        "serve/rejected/flusher_died) and the dead-thread gauge names the "
        "thread. Rebuild the batcher; re-submit with backoff.")

  @property
  def stats(self) -> Dict[str, int]:
    """The classic counter view (now registry-backed)."""
    return {k: c.value for k, c in self._counters.items()}

  def set_admission(self, queue_rows: Optional[int] = None,
                    max_delay_s: Optional[float] = None) -> None:
    """Adjust the admission knobs between flushes — a control plane's
    actuation hook (the JAX package's ``control.ControlPolicy`` tightens
    ``queue_rows`` as recent latency approaches a deadline-class
    budget, so overload sheds at the edge BEFORE the queue melts into
    p99 blowout; the port has no control plane yet). Same locked-swap discipline as
    :meth:`set_dispatch_fn`: pending requests already admitted stay
    admitted — a tightened bound applies to arrivals, never
    retroactively sheds queued work."""
    with self._lock:
      if queue_rows is not None:
        if int(queue_rows) < self.max_batch:
          raise ValueError(
              f"queue_rows {queue_rows} < max_batch {self.max_batch}: "
              "the queue could never admit one full dispatch")
        self.queue_rows = int(queue_rows)
      if max_delay_s is not None:
        if max_delay_s <= 0:
          raise ValueError(f"max_delay_s must be > 0, got {max_delay_s}")
        self.max_delay_s = float(max_delay_s)
      self._nonempty.notify_all()

  def set_dispatch_fn(self, dispatch_fn: Callable) -> None:
    """Swap the dispatch binding between flushes (the streaming
    subscriber's rebase hook: re-point the batcher at a freshly loaded
    engine without stopping either thread). ``_dispatch`` captures the
    binding once per flush, so every flush runs entirely through one
    binding — the swap can never split a batch across two engines."""
    with self._lock:
      self.dispatch_fn = dispatch_fn

  # ---- submission ---------------------------------------------------------
  def _reject(self, reason: str, msg: str) -> Rejected:
    """Count one shed (total + per-reason) and build the exception —
    the load-shed accounting contract: every shed is exactly one total
    count and exactly one reason count.  A shed also trips the flight
    recorder (no-op when none is installed): overload is exactly the
    moment the last-N-requests bundle is worth having.  ``defer=True``
    because this runs under the batcher's one lock — the bundle's
    write+fsync must not stall every submitter at peak overload."""
    self._counters["rejected"].inc()
    self._counters[f"rejected/{reason}"].inc()
    _flight.flight_trip(f"shed/{reason}", defer=True)
    return Rejected(msg, reason=reason)

  def _evict_for_locked(self, n: int, priority: int) -> None:  # requires-lock: _lock
    """Make room for an incoming higher-priority request by shedding
    pending LOWER-priority requests — lowest priority first, youngest
    first within a priority (the request that waited longest keeps its
    place). Sheds only what the incoming rows need; sheds nothing if
    even shedding everything below ``priority`` cannot make room."""
    room = self.queue_rows - self._pending_rows
    victims = sorted((p for p in self._pending if p.priority < priority),
                     key=lambda p: (p.priority, -p.seq))
    chosen, freed = [], 0
    for p in victims:
      if room + freed >= n:
        break
      chosen.append(p)
      freed += p.future.n
    if room + freed < n:
      return
    for p in chosen:
      self._pending.remove(p)
      self._pending_rows -= p.future.n
      p.future._fail(self._reject(
          "priority_shed",
          f"request shed for priority-{priority} traffic (this request "
          f"is priority {p.priority}; the queue is full). Re-submit "
          "with backoff, or raise this caller's priority class."))

  def submit(self, numerical, cats: Sequence, priority: int = 0,
             deadline_s: Optional[float] = None) -> ServeFuture:
    """Enqueue one request of ``n = numerical.shape[0]`` rows
    (``1 <= n <= max_batch``). Returns its :class:`ServeFuture`; raises
    :class:`Rejected` — counted, with ``reason`` — when it cannot be
    queued.

    ``priority``: admission class (higher wins). Flushes pack pending
    requests highest-priority-first, and a full queue sheds
    lower-priority pending work to admit higher-priority arrivals —
    so p99.9 for priority traffic survives overload instead of queueing
    behind it. ``deadline_s``: seconds from now this request is worth
    dispatching; one that expires in the queue is shed
    (``deadline_expired``) instead of wasting a dispatch slot on an
    answer nobody is waiting for."""
    numerical = np.asarray(numerical)
    cats = [_host_ids(c) for c in cats]
    n = numerical.shape[0]
    if n < 1 or n > self.max_batch:
      raise ValueError(
          f"request rows {n} outside [1, max_batch={self.max_batch}] — "
          "split oversized queries client-side")
    for c in cats:
      if isinstance(c, RaggedIds) and c.nrows != n:
        raise ValueError(f"a RaggedIds input of {c.nrows} rows in a request "
                         f"of {n} rows")
    fut = ServeFuture(n)
    with self._nonempty:
      if self._dead is not None:
        # a counted shed rides a counted submit attempt, like every
        # other reject path (accepted = submitted - rejected must not
        # go negative); plain closed below stays an un-counted error
        self._counters["submitted"].inc()
        raise self._dead_rejected()
      if self._closed:
        raise RuntimeError("MicroBatcher is closed")
      self._counters["submitted"].inc()
      if self._pending_rows + n > self.queue_rows:
        # expired occupants have no claim on the rows a live request
        # needs: purge them before rejecting or evicting live work
        self._purge_expired_locked()
      if self._pending_rows + n > self.queue_rows:
        # an arrival OUTRANKING pending work may evict it (the victim
        # filter is strict-lower-priority, so all-equal traffic no-ops)
        self._evict_for_locked(n, priority)
      if self._pending_rows + n > self.queue_rows:
        raise self._reject(
            "queue_full",
            f"serve queue full ({self._pending_rows} rows pending, bound "
            f"{self.queue_rows}): request shed. The device is saturated "
            "— back off client-side or raise queue_rows (which only "
            "trades the error for latency).")
      self._seq += 1
      deadline = None
      if deadline_s is not None:
        # absolute stamp on the flush clock (deadline arithmetic)
        deadline = fut.t_submit + float(deadline_s)
      # ADMISSION is where a request's trace identity is minted: the id
      # rides the dispatch context over the fleet wire, so every
      # process track a dispatch touches carries this request's id.
      # Minted only when tracing or the flight recorder is active — the
      # disabled path allocates nothing extra.
      trace_id = _trace.mint_id(8) \
          if (_trace.current_tracer() is not None
              or _flight.current_flight_recorder() is not None) else None
      self._pending.append(_Pending(numerical, cats, fut,
                                    priority=int(priority),
                                    deadline_s=deadline, seq=self._seq,
                                    trace_id=trace_id))
      self._pending_rows += n
      self._nonempty.notify()
    return fut

  # ---- flush policy -------------------------------------------------------
  def _purge_expired_locked(self) -> None:  # requires-lock: _lock
    """Shed pending requests whose own deadline passed — counted
    ``deadline_expired``; their waiters fail immediately instead of
    riding a dispatch whose answer is already too late."""
    now = time.monotonic()  # graftlint: disable=GL113 (deadline arithmetic)
    expired = [p for p in self._pending if p.expired(now)]
    for p in expired:
      self._pending.remove(p)
      self._pending_rows -= p.future.n
      p.future._fail(self._reject(
          "deadline_expired",
          f"request deadline passed after {now - p.future.t_submit:.4f}s "
          "in the serve queue — shed instead of dispatched late."))

  def _take_batch_locked(self) -> List[_Pending]:  # requires-lock: _lock
    """Pop whole requests while they fit in max_batch rows: highest
    priority first, FIFO within a priority (all-default-priority
    traffic keeps the classic FIFO order exactly). Expired requests
    are purged first — they never occupy dispatch rows (the inline
    ``flush_now`` path's purge; the flusher thread purges in its
    readiness check)."""
    self._purge_expired_locked()
    order = sorted(self._pending, key=lambda p: (-p.priority, p.seq))
    taken, rows = [], 0
    for p in order:
      if rows + p.future.n > self.max_batch:
        break
      self._pending.remove(p)
      rows += p.future.n
      taken.append(p)
    self._pending_rows -= rows
    return taken

  def _flush_ready_locked(self) -> bool:  # requires-lock: _lock
    # purge expired waiters HERE (they fail at their own deadline — the
    # wait timeout wakes the loop then) rather than treating expiry as
    # flush-readiness: an expired co-tenant must not force the live
    # requests into a premature, heavily padded dispatch
    self._purge_expired_locked()
    if not self._pending:
      return False
    now = time.monotonic()  # graftlint: disable=GL113 (deadline arithmetic)
    if self._pending_rows >= self.max_batch \
        or self._pending[0].future.n == self.max_batch:
      return True
    oldest = self._pending[0].future.t_submit
    # flush-deadline arithmetic against the submit stamps, not timing
    return (now - oldest) >= self.max_delay_s

  def _flush_loop(self) -> None:
    while True:
      with self._nonempty:
        while not self._flush_ready_locked() and not self._closed:
          if self._pending:
            now = time.monotonic()  # graftlint: disable=GL113 (deadline)
            wait = self.max_delay_s - (now
                                       - self._pending[0].future.t_submit)
            # a per-request deadline expiring BEFORE the flush deadline
            # must wake the loop then: its waiter fails at its own
            # deadline, not up to max_delay_s late
            for p in self._pending:
              if p.deadline_s is not None:
                wait = min(wait, p.deadline_s - now)
            self._nonempty.wait(timeout=max(wait, 0.0) + 1e-4)
          else:
            self._nonempty.wait(timeout=0.05)
        if self._closed and not self._pending:
          taken = None  # shutdown: deliver the completer sentinel below
        else:
          taken = self._take_batch_locked()
      if taken is None:
        # completer shutdown sentinel, outside the lock and death-aware:
        # after a completer death the handler owns sentinel delivery and
        # its own sentinel may hold the last queue slot — a plain
        # blocking put here wedged this thread forever (and close()'s
        # join for its full timeout)
        while True:
          with self._lock:
            if self._dead is not None:
              return
          try:
            self._inflight.put(None, timeout=0.05)
            return
          except _queue.Full:
            continue
      if taken:
        try:
          self._dispatch(taken)
        except BaseException:
          # already popped from pending: record the batch so the death
          # handler can fail its waiters (a dispatch-fn failure is
          # handled INSIDE _dispatch; reaching here is machinery death).
          # Under the lock: the completer's death handler swaps the
          # orphan list concurrently (threadlint GL120 caught this)
          with self._lock:
            self._orphans.extend(taken)
          raise

  def flush_now(self) -> int:
    """Synchronous flush (tests / drain): packs and dispatches pending
    requests batch by batch, completing inline. Returns the number of
    dispatches issued."""
    n = 0
    while True:
      with self._nonempty:
        taken = self._take_batch_locked()
      if not taken:
        return n
      item = self._dispatch(taken, inline=True)
      self._complete(*item)
      n += 1

  # ---- dispatch + completion ---------------------------------------------
  def _pad_batch(self, taken: List[_Pending]):
    with _span("serve/pack", args={"requests": len(taken)}):
      numerical = np.concatenate([p.numerical for p in taken])
      pad = self.max_batch - numerical.shape[0]
      cats = []
      for i in range(len(taken[0].cats)):
        if isinstance(taken[0].cats[i], RaggedIds):
          cats.append(_pack_ragged([p.cats[i] for p in taken], pad))
          continue
        c = np.concatenate([p.cats[i] for p in taken])
        if pad:
          c = np.concatenate(
              [c, np.full((pad,) + c.shape[1:], PAD_ID, c.dtype)])
        cats.append(c)
      if pad:
        numerical = np.concatenate(
            [numerical, np.zeros((pad,) + numerical.shape[1:],
                                 numerical.dtype)])
      self._counters["padded_rows"].inc(pad)
      return numerical, cats

  def _dispatch(self, taken: List[_Pending], inline: bool = False):
    dispatch_fn = self.dispatch_fn  # one binding per flush (see setter)
    # the dispatch context: primary id = the first packed request's,
    # trace_ids = every coalesced request's — each request's id appears
    # on every process track the fan-out touches
    tids = [p.trace_id for p in taken if p.trace_id is not None]
    ctx = _trace.mint_context(tids) if tids else None
    fr = _flight.current_flight_recorder()
    rec = None
    if fr is not None and ctx is not None:
      rec = fr.begin(ctx.trace_id, ctx.trace_ids)
      fr.bind(rec)
    # queue stage: how long the oldest coalesced request waited for
    # this flush (latency stamps on the submit clock, not timing)
    now = time.monotonic()  # graftlint: disable=GL113 (latency stamp)
    _flight.observe_stage(
        "queue", max(0.0, now - min(p.future.t_submit for p in taken)),
        registry=self.telemetry)
    try:
      with _trace.use_context(ctx):
        with _flight.stage("pack", registry=self.telemetry):
          numerical, cats = self._pad_batch(taken)
        with _span("serve/dispatch",
                   args={"requests": len(taken)}):
          out = dispatch_fn(numerical, cats)
      self._counters["batches"].inc()
    except BaseException as e:  # noqa: BLE001 — delivered per request
      for p in taken:
        p.future._fail(e)
      if rec is not None:
        fr.bind(None)
        fr.end(rec, error=e)
      if inline:
        raise
      return
    if fr is not None:
      fr.bind(None)
    # fr rides the item: completion must end the record against the
    # recorder that BEGAN it — re-resolving the global there would leak
    # the record (and wedge pending trips) across a recorder swap
    if inline:
      return (taken, out, rec, ctx, fr)
    # enqueue with a death-aware timed put: a plain blocking put could
    # wedge forever against a dead completer (the death handler's
    # sentinel may occupy the last slot), and a check-then-put could
    # land the item AFTER the handler's one-shot drain — so re-check
    # death on every Full timeout AND after a successful put, and
    # self-drain in the latter case (idempotent, see
    # _drain_inflight_dead) so the waiters can never be stranded
    while True:
      with self._lock:
        dead = self._dead is not None
      if dead:
        for p in taken:
          if not p.future.done():
            p.future._fail(self._dead_rejected())
        if rec is not None:
          fr.end(rec, error=self._dead[1])
        return None
      try:
        self._inflight.put((taken, out, rec, ctx, fr), timeout=0.05)
      except _queue.Full:
        continue
      with self._lock:
        dead = self._dead is not None
      if dead:
        self._drain_inflight_dead()
      return None

  def _complete(self, taken: List[_Pending], out: Any, rec=None,
                ctx=None, fr=None) -> None:
    if fr is not None and rec is not None:
      fr.bind(rec)  # the drain happens HERE, on the completer thread
    try:
      with _trace.use_context(ctx), \
          _span("serve/complete", args={"requests": len(taken)}):
        try:
          with _flight.stage("dequant", registry=self.telemetry):
            preds = _materialize(out)  # waits for the device result
        except BaseException as e:  # noqa: BLE001
          for p in taken:
            p.future._fail(e)
          if fr is not None and rec is not None:
            fr.end(rec, error=e)
            rec = None
          return
        off = 0
        for p in taken:
          p.future._fulfill(preds[off:off + p.future.n])
          off += p.future.n
          self._counters["completed"].inc()
          self._latency.observe(p.future.latency_s)
      if fr is not None and rec is not None:
        fr.end(rec)
    finally:
      if fr is not None:
        fr.bind(None)

  def _complete_loop(self) -> None:
    while True:
      item = self._inflight.get()
      if item is None:
        return
      try:
        self._complete(*item)
      except BaseException:
        # popped from in-flight already: hand the batch to the death
        # handler (expected completion failures are delivered per
        # request inside _complete; this is machinery death). Locked:
        # the flusher's death handler may swap the list concurrently
        with self._lock:
          self._orphans.extend(item[0])
        raise

  # ---- lifecycle ----------------------------------------------------------
  def close(self, drain: bool = True) -> None:
    """Stop the batcher. ``drain`` flushes pending requests first;
    otherwise they fail with a shutdown error."""
    with self._nonempty:
      self._closed = True
      pending = [] if drain else self._pending[:]
      if not drain:
        self._pending.clear()
        self._pending_rows = 0
      self._nonempty.notify_all()
    for p in pending:
      p.future._fail(RuntimeError("MicroBatcher closed before dispatch"))
    if self._flusher is not None:
      self._flusher.join(timeout=10.0)
      self._completer.join(timeout=10.0)
    elif drain:
      try:
        self.flush_now()
      finally:
        # a dispatch failure aborts flush_now mid-drain; requests still
        # queued behind it must fail loudly, not strand their waiters
        with self._nonempty:
          leftover = self._pending[:]
          self._pending.clear()
          self._pending_rows = 0
        for p in leftover:
          p.future._fail(
              RuntimeError("MicroBatcher closed before dispatch"))
