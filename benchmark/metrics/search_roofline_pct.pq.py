"""search_roofline_pct.pq: the least time the chip could take for the
search work of the captured stretch, over the device's busy time in it
(`wbench.roofline.served_share`; the store read is the configuration's
`store_bytes_per_value`, 2 for the bf16 copy the PQ tier scans)."""

from wbench import roofline


def read(run):
    return roofline.served_share(run)
