"""device_idle_pct.shards: the share of the captured stretch of the window
in which no kernel, copy or memset ran on the card (the device trace of
GET /debug/pprof/trace), in the four-shard cell."""


def read(run):
    if run.device is None:
        return None
    return 100.0 * run.device.idle_share
