"""index_fetch_ms.batch: the p50 of the `index.fetch` step inside the
dispatch's `device_search` (the one blocking device-to-host fetch, which
waits for the dispatch's kernels) over the window's gRPC BatchSearch
traces."""

from wbench import spans, spantree


def read(run):
    return spans.p50([spantree.summed(ds, ["index.fetch"])
                      for ds in spantree.device_searches(run, spantree.BATCH)])
