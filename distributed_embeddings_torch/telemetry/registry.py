"""Process-wide metrics registry: counters, gauges, latency histograms.

A copy of ``distributed_embeddings_tpu/telemetry/registry.py`` for the PyTorch port
(pure Python; the port imports nothing of the JAX package).

Every subsystem in the stack grew its own ad-hoc metric surface —
guarded steps return ``{'bad_step', 'oov'}`` dicts, the dynvocab trainer
keeps ``[allocs, evictions, admit_denied, occupancy]`` vectors, the
tiering prefetcher counts hits and retries, the micro-batcher counts
rejections.  This module is the one schema they all converge on:

- :class:`Counter` — a monotone cumulative ``int`` (events since the
  LOGICAL start of the run, not the process: the value persists through
  the checkpoint manifest's ``telemetry`` section and auto-resume adopts
  it, so restarts never double-count — the dynvocab totals pattern,
  generalized).
- :class:`Gauge` — a point-in-time ``float`` (occupancy, queue depth).
- :class:`Histogram` — log-bucketed magnitudes (latencies, bytes) with
  percentile queries whose RELATIVE error is bounded by construction:
  bucket boundaries are powers of ``gamma = (1+e)/(1-e)``, so the
  estimate for any quantile is within ``rel_err`` of the exact
  nearest-rank sample value, over any distribution, at O(1) memory per
  occupied bucket.  (The DDSketch boundary scheme; the full sketch's
  bucket-collapse machinery is not needed at the cardinalities a trainer
  produces.)

Thread-safety: registries and metrics are mutated from trainer threads,
the batcher's flusher/completer workers, and async checkpoint writers —
every mutation takes the owning registry's lock.  The lock is per
REGISTRY (not global): surfaces that need isolated exact accounting (the
micro-batcher's load-shed counters, unit tests) construct a private
:class:`MetricsRegistry`; everything else shares :func:`get_registry`.

Naming: ``/``-separated lowercase paths (``train/bad_step``,
``tiered/hot_hits/<class>``).  The Prometheus exporter
(:mod:`.export`) sanitizes them to the textfile charset.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, Iterable, Optional

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "WindowedHistogram",
    "get_registry",
    "counter",
    "gauge",
    "histogram",
]


class Counter:
  """Monotone cumulative event count."""

  __slots__ = ("name", "_lock", "_value")

  kind = "counter"

  def __init__(self, name: str, lock: threading.RLock):
    self.name = name
    self._lock = lock
    self._value = 0    # guarded-by: _lock [writes]

  def inc(self, n: int = 1) -> None:
    if n < 0:
      raise ValueError(f"counter {self.name!r}: inc({n}) — counters are "
                       "monotone; use a Gauge for values that go down")
    with self._lock:
      self._value += int(n)

  @property
  def value(self) -> int:
    return self._value

  def state(self) -> int:
    return self._value

  def load(self, state: Any) -> None:
    with self._lock:
      self._value = int(state)


class Gauge:
  """Point-in-time value (last write wins)."""

  __slots__ = ("name", "_lock", "_value")

  kind = "gauge"

  def __init__(self, name: str, lock: threading.RLock):
    self.name = name
    self._lock = lock
    self._value = 0.0  # guarded-by: _lock [writes]

  def set(self, v: float) -> None:
    with self._lock:
      self._value = float(v)

  @property
  def value(self) -> float:
    return self._value

  def state(self) -> float:
    return self._value

  def load(self, state: Any) -> None:
    with self._lock:
      self._value = float(state)


class Histogram:
  """Log-bucketed histogram with bounded-relative-error percentiles.

  Positive observations ``x`` land in bucket ``i = ceil(log_g(x))`` with
  ``g = (1 + rel_err) / (1 - rel_err)``; bucket ``i`` covers
  ``(g^(i-1), g^i]`` and is reported as ``2 g^i / (g + 1)`` — the value
  minimizing the worst-case relative error over the bucket, which is
  exactly ``rel_err``.  Non-positive observations (a clock that read
  zero) count in a dedicated zero bucket reported as ``0.0``.

  :meth:`percentile` answers the NEAREST-RANK quantile: the estimated
  value of the sample at 1-indexed rank ``ceil(q/100 * count)``.  For
  any distribution, ``|estimate - exact| <= rel_err * exact`` against
  the exact nearest-rank value of the raw stream (pinned adversarially
  in tests/test_telemetry.py).

  ``max_buckets`` bounds the occupied-bucket cardinality for metrics fed
  by unbounded-magnitude streams (a freshness lag that can span
  microseconds to hours would otherwise grow a bucket per decade-ish of
  gamma): when the bound is exceeded the LOWEST buckets collapse upward
  (the DDSketch policy — the smallest observations are the ones a
  latency/lag SLO never reads), so memory is O(max_buckets) forever.
  The ``rel_err`` percentile guarantee then holds only for quantiles
  landing ABOVE the collapse boundary; collapsed mass is reported at the
  boundary bucket's value (an overestimate of the collapsed samples,
  never of the upper quantiles).
  """

  __slots__ = ("name", "_lock", "rel_err", "_gamma", "_log_gamma",
               "_buckets", "_zero", "_count", "_sum", "_min", "_max",
               "max_buckets", "_collapsed")

  kind = "histogram"

  def __init__(self, name: str = "", rel_err: float = 0.01,
               lock: Optional[threading.RLock] = None,
               max_buckets: Optional[int] = None):
    if not 0.0 < rel_err < 1.0:
      raise ValueError(f"rel_err must be in (0, 1), got {rel_err}")
    if max_buckets is not None and max_buckets < 2:
      raise ValueError(f"max_buckets must be >= 2 (the collapse needs a "
                       f"boundary bucket to merge into), got {max_buckets}")
    self.name = name
    self._lock = lock if lock is not None else threading.RLock()
    self.rel_err = float(rel_err)
    self._gamma = (1.0 + rel_err) / (1.0 - rel_err)
    self._log_gamma = math.log(self._gamma)
    self._buckets: Dict[int, int] = {}  # guarded-by: _lock
    self._zero = 0         # guarded-by: _lock [writes]
    self._count = 0        # guarded-by: _lock [writes]
    self._sum = 0.0        # guarded-by: _lock [writes]
    self._min = math.inf   # guarded-by: _lock [writes]
    self._max = -math.inf  # guarded-by: _lock [writes]
    self.max_buckets = max_buckets
    # observations folded upward by bucket collapse
    self._collapsed = 0  # guarded-by: _lock [writes]

  # ---- recording ----------------------------------------------------------
  def observe(self, x: float) -> None:
    x = float(x)
    if math.isnan(x):
      raise ValueError(f"histogram {self.name!r}: observe(nan)")
    with self._lock:
      self._count += 1
      self._sum += x
      self._min = min(self._min, x)
      self._max = max(self._max, x)
      if x <= 0.0:
        self._zero += 1
      else:
        i = math.ceil(math.log(x) / self._log_gamma)
        self._buckets[i] = self._buckets.get(i, 0) + 1
        if self.max_buckets is not None \
            and len(self._buckets) > self.max_buckets:
          self._collapse_locked()

  def _collapse_locked(self) -> None:  # requires-lock: _lock
    """Merge the lowest buckets upward until the cardinality bound
    holds (caller holds the lock). Count/sum/min/max are exact
    regardless; only the collapsed samples' bucket resolution is lost."""
    while len(self._buckets) > self.max_buckets:
      lo = sorted(self._buckets)[:2]
      n = self._buckets.pop(lo[0])
      self._buckets[lo[1]] += n
      self._collapsed += n

  def observe_many(self, xs: Iterable[float]) -> None:
    for x in xs:
      self.observe(x)

  # ---- queries ------------------------------------------------------------
  @property
  def count(self) -> int:
    return self._count

  @property
  def sum(self) -> float:
    return self._sum

  @property
  def min(self) -> float:
    return self._min if self._count else math.nan

  @property
  def max(self) -> float:
    return self._max if self._count else math.nan

  @property
  def mean(self) -> float:
    return self._sum / self._count if self._count else math.nan

  def _bucket_value(self, i: int) -> float:
    return 2.0 * self._gamma ** i / (self._gamma + 1.0)

  def percentile(self, q: float) -> float:
    """Nearest-rank quantile estimate (``q`` in [0, 100]); NaN when
    empty.  Relative error vs the exact nearest-rank sample is bounded
    by ``rel_err``."""
    if not 0.0 <= q <= 100.0:
      raise ValueError(f"q must be in [0, 100], got {q}")
    with self._lock:
      if not self._count:
        return math.nan
      rank = max(1, math.ceil(q / 100.0 * self._count))
      if rank <= self._zero:
        return 0.0
      seen = self._zero
      for i in sorted(self._buckets):
        seen += self._buckets[i]
        if seen >= rank:
          return self._bucket_value(i)
      return self._bucket_value(max(self._buckets))  # fp-rounding guard

  @property
  def p50(self) -> float:
    return self.percentile(50.0)

  @property
  def p99(self) -> float:
    return self.percentile(99.0)

  def merge(self, other: "Histogram") -> None:
    """Fold ``other``'s observations into this histogram (geometries
    must match — merged buckets would otherwise mean nothing)."""
    if other.rel_err != self.rel_err:
      raise ValueError(
          f"histogram merge: rel_err {other.rel_err} != {self.rel_err} — "
          "bucket boundaries differ, counts cannot be combined")
    with self._lock:
      for i, n in other._buckets.items():
        self._buckets[i] = self._buckets.get(i, 0) + n
      self._zero += other._zero
      self._count += other._count
      self._sum += other._sum
      self._min = min(self._min, other._min)
      self._max = max(self._max, other._max)
      self._collapsed += other._collapsed
      if self.max_buckets is not None \
          and len(self._buckets) > self.max_buckets:
        self._collapse_locked()

  # ---- persistence --------------------------------------------------------
  def state(self) -> Dict[str, Any]:
    with self._lock:
      out = {
          "rel_err": self.rel_err,
          "count": self._count,
          "sum": self._sum,
          "min": None if not self._count else self._min,
          "max": None if not self._count else self._max,
          "zero": self._zero,
          # JSON object keys are strings; indices may be negative
          "buckets": {str(i): n for i, n in sorted(self._buckets.items())},
      }
      if self._collapsed:
        out["collapsed"] = self._collapsed
      return out

  def load(self, state: Dict[str, Any]) -> None:
    if float(state["rel_err"]) != self.rel_err:
      raise ValueError(
          f"histogram {self.name!r}: persisted rel_err "
          f"{state['rel_err']} != configured {self.rel_err} — the bucket "
          "boundaries differ, so the saved counts cannot be adopted")
    with self._lock:
      self._count = int(state["count"])
      self._sum = float(state["sum"])
      self._min = math.inf if state["min"] is None else float(state["min"])
      self._max = -math.inf if state["max"] is None else float(state["max"])
      self._zero = int(state["zero"])
      self._buckets = {int(i): int(n)
                       for i, n in state.get("buckets", {}).items()}
      self._collapsed = int(state.get("collapsed", 0))
      if self.max_buckets is not None \
          and len(self._buckets) > self.max_buckets:
        # a persisted unbounded (or wider-bound) histogram adopts this
        # configuration's bound on load
        self._collapse_locked()


class WindowedHistogram:
  """Rolling-window view over a :class:`Histogram` stream.

  A cumulative histogram answers "what has the p99 been since the
  process started" — useless to a control loop, which must react to the
  LAST few seconds.  This class keeps a ring of ``slots`` sealed
  sub-histograms plus one open slot: observations land in the open
  slot, :meth:`rotate` seals it into the ring (evicting the oldest
  sealed slot once the ring is full), and every read merges the ring
  plus the open slot into a throwaway cumulative view.  Because
  :meth:`Histogram.merge` is EXACT (bucket counts add; identical
  geometry by construction), the windowed percentile carries the same
  ``rel_err`` bound as a single histogram fed the same recent stream —
  pinned in tests/test_telemetry.py.

  Rotation is the CALLER's clock: the control tick (or any scheduler)
  calls :meth:`rotate` at its cadence, so the window span is
  ``slots x tick`` and — critically for the replayable decision log —
  the view is a deterministic function of the observation/rotation
  sequence, with no wall clock hidden inside.  ``maybe_rotate(now)``
  is the convenience for callers that do hold a clock reading: it
  rotates when ``rotate_every_s`` has elapsed since the last seal.

  Not a registry kind: windows are control-plane working state, not
  run-cumulative telemetry, so they never enter ``state_dict`` (a
  resumed run's "recent" is by definition empty).
  """

  __slots__ = ("name", "rel_err", "slots", "max_buckets", "_lock",
               "_open", "_ring", "_rotations", "rotate_every_s",
               "_last_rotate")

  def __init__(self, name: str = "", slots: int = 6,
               rel_err: float = 0.01,
               max_buckets: Optional[int] = None,
               rotate_every_s: Optional[float] = None):
    if slots < 1:
      raise ValueError(f"slots must be >= 1, got {slots}")
    self.name = name
    self.rel_err = float(rel_err)
    self.slots = int(slots)
    self.max_buckets = max_buckets
    self._lock = threading.RLock()
    self._open = self._fresh()  # guarded-by: _lock [writes]
    # oldest first, at most ``slots`` sealed
    self._ring: list = []       # guarded-by: _lock
    self._rotations = 0         # guarded-by: _lock [writes]
    self.rotate_every_s = rotate_every_s
    self._last_rotate: Optional[float] = None  # guarded-by: _lock

  def _fresh(self) -> Histogram:
    return Histogram(self.name, rel_err=self.rel_err, lock=self._lock,
                     max_buckets=self.max_buckets)

  # ---- recording ----------------------------------------------------------
  def observe(self, x: float) -> None:
    self._open.observe(x)

  def rotate(self) -> Histogram:
    """Seal the open slot into the ring and start a new one; returns
    the sealed sub-histogram (callers that also feed a lifetime
    histogram merge it there)."""
    with self._lock:
      sealed, self._open = self._open, self._fresh()
      self._ring.append(sealed)
      if len(self._ring) > self.slots:
        del self._ring[:len(self._ring) - self.slots]
      self._rotations += 1
      return sealed

  def maybe_rotate(self, now: float) -> bool:
    """Rotate if ``rotate_every_s`` elapsed since the last seal (the
    caller supplies the clock reading — this class never reads one)."""
    if self.rotate_every_s is None:
      return False
    with self._lock:
      if self._last_rotate is None:
        self._last_rotate = float(now)
        return False
      if now - self._last_rotate < self.rotate_every_s:
        return False
      self._last_rotate = float(now)
    self.rotate()
    return True

  # ---- reads --------------------------------------------------------------
  def view(self) -> Histogram:
    """The window as one cumulative histogram: sealed ring + open slot
    merged into a fresh (caller-owned) Histogram — reads never mutate
    the window."""
    out = Histogram(self.name, rel_err=self.rel_err,
                    max_buckets=self.max_buckets)
    with self._lock:
      for h in self._ring:
        out.merge(h)
      out.merge(self._open)
    return out

  def percentile(self, q: float) -> float:
    return self.view().percentile(q)

  @property
  def p50(self) -> float:
    return self.percentile(50.0)

  @property
  def p99(self) -> float:
    return self.percentile(99.0)

  @property
  def count(self) -> int:
    with self._lock:
      return self._open.count + sum(h.count for h in self._ring)

  @property
  def rotations(self) -> int:
    return self._rotations


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
  """One namespace of metrics, with JSON persistence.

  ``state_dict()`` is the checkpoint manifest's ``telemetry`` section:
  pure JSON (counters/gauges as scalars, histograms as sparse bucket
  maps), a deterministic function of what was observed.
  ``load_state_dict()`` REPLACES the values of every metric named in the
  section (creating them if absent) and leaves other metrics alone —
  adopt-on-resume, exactly how the ResilientTrainer adopts the persisted
  skip/OOV counters."""

  def __init__(self):
    self._lock = threading.RLock()
    self._metrics: Dict[str, Any] = {}  # guarded-by: _lock

  def _get(self, name: str, kind: str, **kwargs):
    with self._lock:
      m = self._metrics.get(name)
      if m is None:
        cls = _KINDS[kind]
        if kind == "histogram":
          m = cls(name, lock=self._lock, **kwargs)
        else:
          m = cls(name, self._lock)
        self._metrics[name] = m
      elif m.kind != kind:
        raise ValueError(
            f"metric {name!r} already registered as a {m.kind}, "
            f"requested as a {kind}")
      return m

  def counter(self, name: str) -> Counter:
    return self._get(name, "counter")

  def gauge(self, name: str) -> Gauge:
    return self._get(name, "gauge")

  def histogram(self, name: str, rel_err: float = 0.01,
                max_buckets: Optional[int] = None) -> Histogram:
    h = self._get(name, "histogram", rel_err=rel_err,
                  max_buckets=max_buckets)
    if h.rel_err != rel_err:
      # the silent alternative would hand back buckets with a different
      # error bound than the caller asked for — the same loud-mismatch
      # policy as Histogram.load/merge
      raise ValueError(
          f"histogram {name!r} already registered with rel_err="
          f"{h.rel_err}, requested {rel_err} — the bucket geometries "
          "differ; pick one rel_err per metric name")
    if max_buckets is not None and h.max_buckets != max_buckets:
      if h.max_buckets is not None:
        raise ValueError(
            f"histogram {name!r} already bounded at max_buckets="
            f"{h.max_buckets}, requested {max_buckets} — pick one bound "
            "per metric name")
      # an unbounded histogram adopts the first explicit bound (readers
      # calling histogram(name) with the default None keep not caring)
      with h._lock:
        h.max_buckets = max_buckets
        if len(h._buckets) > max_buckets:
          h._collapse_locked()
    return h

  def metrics(self) -> Dict[str, Any]:
    with self._lock:
      return dict(self._metrics)

  def peek(self, name: str):
    """The metric named ``name``, or None — WITHOUT creating it: a
    probe-style read (/healthz scans the :meth:`metrics` view for the
    same reason) must not materialize a gauge that nothing ever set."""
    with self._lock:
      return self._metrics.get(name)

  def remove(self, name: str) -> bool:
    """Drop the metric named ``name``; False if absent. A DELIBERATELY
    stopped fleet member removes its keyed promote gauges so the
    /healthz most-stale scan doesn't report a decommissioned member as
    stalled forever — a genuinely stalled member never calls this, so
    it stays visible (the heartbeat-quorum rule on the health plane)."""
    with self._lock:
      return self._metrics.pop(name, None) is not None

  def snapshot(self) -> Dict[str, Any]:
    """Human-facing summary: scalar values, histogram digests."""
    out: Dict[str, Any] = {}
    for name, m in sorted(self.metrics().items()):
      if m.kind == "histogram":
        out[name] = {"count": m.count, "mean": m.mean,
                     "p50": m.p50, "p99": m.p99, "max": m.max}
      else:
        out[name] = m.value
    return out

  def merge(self, other: "MetricsRegistry") -> None:
    """Fold another registry's observations into this one — the fleet
    ROLL-UP: N serving processes (or N subscribers on one delta chain)
    each keep a private registry for exact per-process accounting, and
    an aggregator merges them for the global view. Counters and
    histograms ADD (both are pure observation counts); gauges take the
    other's value (last-writer — a gauge is a point-in-time reading, so
    roll up gauges only from registries snapshotted together). Metric
    geometry mismatches (kind, histogram rel_err) raise loudly, the
    same policy as ``Histogram.merge``."""
    for name, m in sorted(other.metrics().items()):
      if m.kind == "counter":
        self.counter(name).inc(m.value)
      elif m.kind == "gauge":
        self.gauge(name).set(m.value)
      else:
        self.histogram(name, rel_err=m.rel_err,
                       max_buckets=m.max_buckets).merge(m)

  # ---- persistence --------------------------------------------------------
  def state_dict(self) -> Dict[str, Any]:
    """The manifest ``telemetry`` section (JSON-serializable)."""
    out: Dict[str, Dict[str, Any]] = \
        {"counters": {}, "gauges": {}, "histograms": {}}
    for name, m in sorted(self.metrics().items()):
      out[m.kind + "s"][name] = m.state()
    return out

  def load_state_dict(self, section: Dict[str, Any]) -> None:
    for name, v in section.get("counters", {}).items():
      self.counter(name).load(v)
    for name, v in section.get("gauges", {}).items():
      self.gauge(name).load(v)
    for name, st in section.get("histograms", {}).items():
      self.histogram(name, rel_err=float(st["rel_err"])).load(st)


_GLOBAL = MetricsRegistry()


def get_registry() -> MetricsRegistry:
  """The process-wide default registry."""
  return _GLOBAL


def counter(name: str) -> Counter:
  return _GLOBAL.counter(name)


def gauge(name: str) -> Gauge:
  return _GLOBAL.gauge(name)


def histogram(name: str, rel_err: float = 0.01,
              max_buckets: Optional[int] = None) -> Histogram:
  return _GLOBAL.histogram(name, rel_err=rel_err, max_buckets=max_buckets)
