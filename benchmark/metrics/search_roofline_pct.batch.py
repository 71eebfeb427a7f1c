"""search_roofline_pct.batch: the least time the chip could take for the
search work of the captured stretch, over the device's busy time in it
(`wbench.roofline.served_share`, which says how the work is counted;
`wbench.roofline` says which of the two bounds it)."""

from wbench import roofline


def read(run):
    return roofline.served_share(run)
