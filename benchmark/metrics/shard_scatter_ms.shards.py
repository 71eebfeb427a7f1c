"""shard_scatter_ms.shards: the p50, over the window's gRPC BatchSearch
traces, of a request's `class.scatter` span: from the first shard's
enqueue to the last shard's result on the host, each shard's dispatch
under it (ClassIndex.search_raw_packed)."""

from wbench import spantree


def read(run):
    return spantree.per_request_p50(run, spantree.BATCH, ["class.scatter"])
