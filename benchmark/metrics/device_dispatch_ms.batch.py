"""device_dispatch_ms.batch: the p50 of a dispatch's `device_ms`, the time
between two CUDA events on its stream, one before the query upload and
one after its last kernel, over the window's gRPC BatchSearch traces. The
serving threads share that stream, so this is the dispatch's extent on
the card's clock: its own work, the other dispatches' kernels queued
between, and the card's waits for the host's next launch. A host index
metric: it falls as the host launches a dispatch's work closer together."""

from wbench import spantree


def read(run):
    return spantree.device_ms(run, spantree.BATCH)
