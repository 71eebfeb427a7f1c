"""qps.shards: queries answered in the traced run's window, over the
window's length, in the four-shard cell, whose rate spreads too widely
from run to run for an end-to-end bound (PERF.md §2); read per layer,
under the tracer."""


def read(run):
    if run.traffic["protocol"] != "grpc_batch_search":
        return None
    return run.rows_done / run.seconds
