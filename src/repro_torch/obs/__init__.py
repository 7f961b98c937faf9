"""Unified observability: tracing spans, metrics registry, exporters (a
copy of ``repro/obs``, plain Python).  ``obs.timeline`` (the pipeline's
stage-time readout and tick synthesis) is imported on its own, as in the
JAX package.
"""
from repro_torch.obs.export import (chrome_trace, write_chrome_trace,
                                    write_jsonl, write_trace)
from repro_torch.obs.metrics import (DEFAULT_BOUNDS, Counter, Gauge,
                                     Histogram, MetricsRegistry, percentile)
from repro_torch.obs.trace import NULL_TRACER, ManualClock, Tracer, or_null

__all__ = [
    "Tracer", "ManualClock", "NULL_TRACER", "or_null",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "percentile",
    "DEFAULT_BOUNDS",
    "chrome_trace", "write_chrome_trace", "write_jsonl", "write_trace",
]
