"""search_roofline_pct.shards: the least time the chip could take for the
search work of the captured stretch, over the device's busy time in it, in
the four-shard cell (`wbench.roofline.served_share`). A request's four
shard dispatches read a quarter of the class's rows each, so together they
read the store once a request, as the served share counts it."""

from wbench import roofline


def read(run):
    return roofline.served_share(run)
