"""dispatch_graph_pct.batch: the share, in %, of the window's gRPC
BatchSearch dispatches whose `graph` fact reads `replay`: those the host
index served by replaying one CUDA graph of the gmin chain (the upload,
K1, the top-k, the rescore and the packing) in place of its eager
launches. A program that records no `graph` fact gives no value."""

from wbench import spans, spantree


def read(run):
    facts = [d["attrs"]["graph"] for r in spans.roots(run, *spantree.BATCH)
             for d in spans.dispatches(r) if "graph" in d.get("attrs", {})]
    return 100.0 * facts.count("replay") / len(facts) if facts else None
