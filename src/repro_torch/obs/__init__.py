"""Observability: flight-recorder tracing, a unified metrics registry,
and TTFT critical-path attribution.

  * ``repro.obs.tracer``      — causal spans on the sim clock, with a
    null-tracer fast path (``install``/``current_tracer``);
  * ``repro.obs.metrics``     — counters/gauges/log-histograms/binned
    timelines under one naming scheme (``MetricsRegistry``);
  * ``repro.obs.export``      — Chrome-trace/Perfetto JSON export +
    schema validation (``python -m repro.obs.export``);
  * ``repro.obs.attribution`` — per-request TTFT decomposition that
    provably sums to measured TTFT, from the span trees.

This package imports nothing from ``repro.core`` (the core imports
*us*), so instrumentation can thread through every layer without
cycles.
"""
from .attribution import (
    PHASES,
    aggregate_attribution,
    request_trees,
    ttft_attribution,
    validate_span_tree,
)
from .export import to_chrome, validate_chrome_trace, write_chrome_trace
from .metrics import (
    BinnedTimeline,
    Counter,
    Gauge,
    LogHistogram,
    MetricsRegistry,
)
from .tracer import (
    NULL_TRACER,
    NullTracer,
    Span,
    Tracer,
    current_tracer,
    install,
    spans_from_dicts,
    uninstall,
)

__all__ = [
    "PHASES", "aggregate_attribution", "request_trees",
    "ttft_attribution", "validate_span_tree",
    "to_chrome", "validate_chrome_trace", "write_chrome_trace",
    "BinnedTimeline", "Counter", "Gauge", "LogHistogram",
    "MetricsRegistry",
    "NULL_TRACER", "NullTracer", "Span", "Tracer", "current_tracer",
    "install", "spans_from_dicts", "uninstall",
]
