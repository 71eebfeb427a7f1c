"""dispatch_graph_pct.shards: the share, in %, of the window's gRPC
BatchSearch shard dispatches whose `graph` fact reads `replay`, in the
four-shard cell: four indexes on one card, each request dispatching to all
four, their graph pools under the one budget of the card. A program that
records no `graph` fact gives no value."""

from wbench import spans, spantree


def read(run):
    facts = [d["attrs"]["graph"] for r in spans.roots(run, *spantree.BATCH)
             for d in spans.dispatches(r) if "graph" in d.get("attrs", {})]
    return 100.0 * facts.count("replay") / len(facts) if facts else None
