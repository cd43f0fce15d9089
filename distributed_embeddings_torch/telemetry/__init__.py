"""Telemetry for the port: metrics registry, spans, durable export, the
metrics endpoint, flight recorder (PyTorch port of
``distributed_embeddings_tpu/telemetry``, pure Python, under the JAX
package's names):

- :mod:`.registry` — counters, gauges and log-bucketed latency
  histograms; cumulative counters persist through the checkpoint
  manifest's ``telemetry`` section;
- :mod:`.trace` — ``span`` (a no-op while no tracer is installed), the
  request trace context, the single-process :class:`Tracer`, and the
  cross-process timeline: :func:`estimate_clock_offset` (bounded
  uncertainty), :func:`merge_traces`, :func:`save_trace` and
  :func:`attach_device_track`, which joins a ``torch.profiler`` trace's
  CUDA kernel and memcpy events (:func:`device_events`) as a device track;
- :mod:`.export` — :func:`prometheus_text` / :func:`write_prometheus`,
  the rotated fsynced :class:`JsonlWriter`, :func:`emit_verdict` and
  :func:`atomic_write_text`;
- :mod:`.http` — :class:`MetricsServer`: ``GET /metrics`` (``?scope=
  fleet`` rolls up pushed registries, with a TTL), ``GET /healthz``
  (promote staleness, :func:`record_promote` / :func:`clear_promote`,
  and the dead-thread scan over :data:`DEAD_THREAD_GAUGE_STEM`) and
  ``POST /push``, on loopback port 0 by default;
- :mod:`.lockorder` — :class:`LockOrderMonitor`, the test-time
  lock-order sanitizer;
- :mod:`.flight` — the flight recorder and the serve stage taxonomy
  (``stage``, ``observe_stage``, ``flight_trip``);
- :class:`timed` — a block timed into a named histogram and a span.

A world-N checkpoint save measures each rank's clock against rank 0's
(``checkpoint.read_pod_clock``), which is what :func:`merge_traces`
takes as the per-process offsets.
"""

from .export import (
    JsonlWriter,
    atomic_write_text,
    emit_verdict,
    prometheus_text,
    write_prometheus,
)
from .flight import (
    FlightRecorder,
    current_flight_recorder,
    flight_trip,
    install_flight_recorder,
    observe_stage,
    stage,
    uninstall_flight_recorder,
)
from .http import (
    DEAD_THREAD_GAUGE_STEM,
    MetricsServer,
    clear_promote,
    record_promote,
)
from .lockorder import InstrumentedLock, LockOrderError, LockOrderMonitor
from .registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    WindowedHistogram,
    counter,
    gauge,
    get_registry,
    histogram,
)
from .trace import (
    ClockOffset,
    TraceContext,
    Tracer,
    attach_device_track,
    clock_ns,
    current_tracer,
    device_events,
    estimate_clock_offset,
    get_current_context,
    install_tracer,
    instant,
    merge_traces,
    mint_context,
    mint_id,
    save_trace,
    set_current_context,
    span,
    tracing,
    uninstall_tracer,
    use_context,
)


class timed:
  """Time a block into a named histogram (and a span of the same name)::

      with timed("zoo/step") as t:
          run_once()
      t.elapsed  # the block's seconds

  ``.elapsed`` holds the block's seconds after exit. The histogram is
  observed whether or not a tracer is installed; the clock is the
  tracer's (:func:`~.trace.clock_ns`). The JAX package's
  ``telemetry.timed``."""

  __slots__ = ("name", "registry", "elapsed", "_t0")

  def __init__(self, name: str, registry: MetricsRegistry = None):
    self.name = name
    self.registry = registry if registry is not None else get_registry()
    self.elapsed = 0.0

  def __enter__(self) -> "timed":
    self._t0 = clock_ns()
    return self

  def __exit__(self, exc_type, exc, tb):
    t1 = clock_ns()
    self.elapsed = (t1 - self._t0) / 1e9
    self.registry.histogram(self.name).observe(self.elapsed)
    tr = current_tracer()
    if tr is not None:
      tr.record_window(self.name, self._t0, t1)
    return False


__all__ = [
    "atomic_write_text",
    "attach_device_track",
    "clear_promote",
    "clock_ns",
    "ClockOffset",
    "Counter",
    "counter",
    "current_flight_recorder",
    "current_tracer",
    "DEAD_THREAD_GAUGE_STEM",
    "device_events",
    "emit_verdict",
    "estimate_clock_offset",
    "flight_trip",
    "FlightRecorder",
    "Gauge",
    "gauge",
    "get_current_context",
    "get_registry",
    "Histogram",
    "histogram",
    "install_flight_recorder",
    "install_tracer",
    "instant",
    "InstrumentedLock",
    "JsonlWriter",
    "LockOrderError",
    "LockOrderMonitor",
    "merge_traces",
    "MetricsRegistry",
    "MetricsServer",
    "mint_context",
    "mint_id",
    "observe_stage",
    "prometheus_text",
    "record_promote",
    "save_trace",
    "set_current_context",
    "span",
    "stage",
    "timed",
    "TraceContext",
    "Tracer",
    "tracing",
    "uninstall_flight_recorder",
    "uninstall_tracer",
    "use_context",
    "WindowedHistogram",
    "write_prometheus",
]
