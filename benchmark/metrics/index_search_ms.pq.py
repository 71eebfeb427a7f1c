"""index_search_ms.pq: the p50 of the shard's `device_search` phase (the
host index's dispatch: query upload, the scan of the bf16 copy, the
rescore, the fetch) over the window's gRPC BatchSearch traces."""

from wbench import spans


def read(run):
    return spans.dispatch_phase_p50(run, "grpc", "BatchSearch", "device_search")
