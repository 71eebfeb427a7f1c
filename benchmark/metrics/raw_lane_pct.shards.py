"""raw_lane_pct.shards: the share, in %, of the window's gRPC BatchSearch
traces whose root holds a `class.scatter` span: the requests the raw lane
served over the class's several shards (ClassIndex.search_raw_packed).
A program that records no such span in any of them gives no value."""

from wbench import spans, spantree


def read(run):
    roots = spans.roots(run, *spantree.BATCH)
    hit = sum(1 for r in roots if spantree.find(r, "class.scatter"))
    return 100.0 * hit / len(roots) if hit else None
