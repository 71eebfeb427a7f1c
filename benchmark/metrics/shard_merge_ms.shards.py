"""shard_merge_ms.shards: the p50, over the window's gRPC BatchSearch
traces, of a request's `class.merge` span: the shards' answers merged to
each query's k nearest (ClassIndex.search_raw_packed)."""

from wbench import spantree


def read(run):
    return spantree.per_request_p50(run, spantree.BATCH, ["class.merge"])
