"""server_self_ms.batch: the p50, over the window's gRPC BatchSearch
traces, of the root span's self time (its duration less its children's,
on the raw lane the shard's dispatch): the gRPC parse, the query copy
and the native reply."""

from wbench import spans


def read(run):
    return spans.server_self(run, "grpc", "BatchSearch")
