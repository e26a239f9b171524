"""The port's observability plane: tracing + metrics for the data plane.

Mirrors ``repro/obs`` with its own copy (stdlib only; nothing of the
reference is imported).  ``TRACER`` records per-query spans -- store
ingest and moves, per-batch page copies, stages, the drain -- nested
across threads, with the drain's D2H as device-timed spans on a
``cuda:drain`` track, exportable as Chrome trace-event JSON; ``METRICS``
is the process-global counter / histogram registry.  The names are
cataloged in ``obs/names.py`` and documented in
``docs/torch_observability.md``.
"""

from repro_torch.obs.metrics import (DEFAULT_LATENCY_BOUNDS_S, METRICS,
                                     Counter, Histogram, MetricsRegistry)
from repro_torch.obs.names import (EVENT_NAMES, METRIC_NAMES, SPAN_NAMES,
                                   SPAN_PREFIXES)
from repro_torch.obs.trace import (NULL_SPAN, NullSpan, Span, SpanEvent,
                                   Tracer, TraceSummary, TRACER)

__all__ = [
    "Counter", "Histogram", "MetricsRegistry", "METRICS",
    "DEFAULT_LATENCY_BOUNDS_S",
    "Span", "SpanEvent", "NullSpan", "NULL_SPAN", "Tracer", "TRACER",
    "TraceSummary",
    "SPAN_NAMES", "SPAN_PREFIXES", "EVENT_NAMES", "METRIC_NAMES",
]
