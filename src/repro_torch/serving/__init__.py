"""Online serving: the continuous-batching engine, the CF scoring head,
the recsys traffic simulator, and SLO-aware latency metrics (the greedy
slice of ``repro/serving``)."""
from repro_torch.cache_layout import CacheLayout
from repro_torch.serving.cf_head import CFConfig, CFHead
from repro_torch.serving.engine import (EngineConfig, NativeBackend,
                                        ServingEngine, SlotBackend,
                                        make_backend, serve)
from repro_torch.serving.roofline import cf_lookup_bytes
from repro_torch.serving.metrics import (RequestRecord, WindowedLatency,
                                         format_report, percentile,
                                         summarize)
from repro_torch.serving.traffic import (BATCH_TIER, INTERACTIVE_TIER, Clock,
                                         Request, SLOTier, TrafficConfig,
                                         generate)

__all__ = [
    "CacheLayout", "EngineConfig", "ServingEngine", "SlotBackend",
    "NativeBackend", "make_backend", "serve", "CFConfig", "CFHead",
    "cf_lookup_bytes", "RequestRecord", "WindowedLatency", "format_report",
    "percentile", "summarize",
    "Request", "SLOTier", "TrafficConfig", "generate", "Clock",
    "INTERACTIVE_TIER", "BATCH_TIER",
]
