"""index_offcpu_ms.batch: the mean of the dispatch's `device_search` wall
less the dispatching thread's CPU time over it (`cpu_ms`), over the
window's gRPC BatchSearch traces: the time that thread waited, for the
device's fetch, the GIL, a lock or the scheduler. A mean and not a p50:
where the thread CPU clock advances in scheduler ticks (10 ms on the H100
machine), `cpu_ms` is a tick sample, right on average over many spans and
0, 10 or 20 ms in any one, so a p50 reads the wall less a whole tick."""

from wbench import spantree


def read(run):
    return spantree.mean([ds["duration_ms"] - ds["cpu_ms"]
                          for ds in spantree.device_searches(run, spantree.BATCH)
                          if "cpu_ms" in ds and "duration_ms" in ds])
