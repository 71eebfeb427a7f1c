"""grpc_parse_ms.batch: the p50, over the window's gRPC BatchSearch
traces, of the `grpc.parse` span: the query matrix built from the request's
messages (a per-row `np.fromiter`)."""

from wbench import spantree


def read(run):
    return spantree.per_request_p50(run, spantree.BATCH, ["grpc.parse"])
