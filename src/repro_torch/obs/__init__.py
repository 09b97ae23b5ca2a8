"""repro_torch.obs — tracing, metrics and the roofline for the port.

The port of ``repro.obs``, with the same exports:

* ``repro_torch.obs.trace`` — a thread-aware span tracer.  Disabled (the
  default) every ``span()`` call returns one shared no-op singleton: no
  allocation, no lock, no clock read.  Enabled, spans record B/E event
  pairs (wall time, thread id, attributes) that export as Chrome/Perfetto
  trace-event JSON and aggregate into the per-phase table the CLI prints
  after a ``--trace`` run.

* ``repro_torch.obs.metrics`` — a metrics registry (counters, gauges,
  latency histograms) whose ``snapshot()`` is taken under one lock
  (``SimilarityService.metrics()`` is built on it).

* ``repro_torch.obs.roofline`` — the analytic H100 roofline: each kernel
  launch inside a ``ring-step`` / ``delta-border`` span is counted and the
  span's launches are priced as one ``roofline`` event.  It takes the
  place of ``repro``'s ``roofline_event(jitted, args, ...)``, which prices
  a compiled XLA program.
"""
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)
from repro_torch.obs.roofline import roofline_event  # noqa: F401
from repro_torch.obs.trace import (  # noqa: F401
    Tracer,
    aggregate_phases,
    current_path,
    disable,
    enable,
    enabled,
    fence,
    format_phase_table,
    get_tracer,
    span,
    validate_chrome_trace,
)
