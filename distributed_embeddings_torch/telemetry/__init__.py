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
- :mod:`.export` — :func:`atomic_write_text` only;
- :class:`timed` — a block timed into a named histogram and a span
  (the zoo harness's timings, ``utils/zoo_bench.py``).

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
    "timed",
    "tracing",
    "uninstall_flight_recorder",
    "uninstall_tracer",
    "use_context",
]
