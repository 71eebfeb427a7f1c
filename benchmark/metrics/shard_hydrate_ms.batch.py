"""shard_hydrate_ms.batch: the p50 of the shard's `hydrate` phase over the
window's gRPC BatchSearch traces (on the raw lane: the packed native
point-gets)."""

from wbench import spans


def read(run):
    return spans.dispatch_phase_p50(run, "grpc", "BatchSearch", "hydrate")
