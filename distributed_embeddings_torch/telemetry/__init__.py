"""Telemetry for the port's serving path: metrics registry, spans,
flight recorder (PyTorch port).

Copies of the JAX package's pure-Python telemetry modules, as far as the
micro-batcher (``serving/batcher.py``) uses them:

- :mod:`.registry` — counters, gauges and log-bucketed latency
  histograms (whole);
- :mod:`.trace` — ``span`` (a no-op while no tracer is installed), the
  request trace context, the single-process :class:`Tracer`;
- :mod:`.flight` — the flight recorder and the serve stage taxonomy
  (``stage``, ``observe_stage``, ``flight_trip``);
- :mod:`.export` — :func:`atomic_write_text` only.

Not ported yet: the HTTP metrics server (its dead-thread gauge name,
:data:`DEAD_THREAD_GAUGE_STEM`, is defined here so the batcher reports
under the same key), Prometheus and JSONL export, trace merging, the
lock-order monitor.
"""

from .export import atomic_write_text
from .flight import (
    FlightRecorder,
    current_flight_recorder,
    flight_trip,
    install_flight_recorder,
    observe_stage,
    stage,
    uninstall_flight_recorder,
)
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
    TraceContext,
    Tracer,
    clock_ns,
    current_tracer,
    get_current_context,
    install_tracer,
    instant,
    mint_context,
    mint_id,
    set_current_context,
    span,
    tracing,
    uninstall_tracer,
    use_context,
)

# the gauge a dead batcher thread sets (the JAX package's
# telemetry/http.py name, which its /healthz probe scans)
DEAD_THREAD_GAUGE_STEM = "serve/flusher_dead"

__all__ = [
    "Counter",
    "DEAD_THREAD_GAUGE_STEM",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "TraceContext",
    "Tracer",
    "WindowedHistogram",
    "atomic_write_text",
    "clock_ns",
    "counter",
    "current_flight_recorder",
    "current_tracer",
    "flight_trip",
    "gauge",
    "get_current_context",
    "get_registry",
    "histogram",
    "install_flight_recorder",
    "install_tracer",
    "instant",
    "mint_context",
    "mint_id",
    "observe_stage",
    "set_current_context",
    "span",
    "stage",
    "tracing",
    "uninstall_flight_recorder",
    "uninstall_tracer",
    "use_context",
]
