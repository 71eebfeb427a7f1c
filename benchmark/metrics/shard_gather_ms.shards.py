"""shard_gather_ms.shards: the p50, over the window's gRPC BatchSearch
traces, of a request's `class.gather` span: each shard's packed point-gets
of its own winners and one value arena rebuilt in the merged order
(ClassIndex.search_raw_packed)."""

from wbench import spantree


def read(run):
    return spantree.per_request_p50(run, spantree.BATCH, ["class.gather"])
