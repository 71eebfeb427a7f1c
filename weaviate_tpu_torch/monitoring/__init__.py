"""The port's observability planes: copies of `weaviate_tpu/monitoring/`
(metrics, the cost model, the perf window, tracing, the memory ledger,
the quality auditor, the incident journal) with the device hooks read
through torch: the H100's datasheet peaks (`costmodel.PEAKS`) and the
caching allocator's stats (`memory`); `profiling` (pprof's surface, with a
torch.profiler device trace) and `disk` (disk-pressure read-only
automation)."""

from weaviate_tpu_torch.monitoring.metrics import (
    Metrics,
    get_metrics,
    noop_metrics,
    record_device_fallback,
)

__all__ = ["Metrics", "get_metrics", "noop_metrics", "record_device_fallback"]
