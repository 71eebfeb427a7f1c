"""index_search_ms.batch: the p50 of the shard's `device_search` phase
(the host index's dispatch: query upload, the scan, the fetch) over the
window's gRPC BatchSearch traces."""

from wbench import spans


def read(run):
    return spans.dispatch_phase_p50(run, "grpc", "BatchSearch", "device_search")
