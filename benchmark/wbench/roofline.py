"""The least time the chip could take for a vector search, from the work
it needs: the table of peaks and the operation and byte counts.

Peaks: NVIDIA H100 SXM data sheet, dense rates: 989 TFLOP/s in bf16,
3.35 TB/s of HBM3, at the 700 W power limit (the run reports the card's
own limit beside the result).
"""

from __future__ import annotations

PEAK_FLOPS = 989e12   # bf16 dense, tensor cores
PEAK_BYTES = 3.35e12  # HBM3


def search_work(queries: int, rows: int, dim: int, dispatches: int,
                store_bytes_per_value: float) -> tuple[float, float]:
    """(operations, bytes) of brute-force search: 2·Q·n·D operations, and
    the store read once per dispatch plus the queries read once."""
    ops = 2.0 * queries * rows * dim
    nbytes = dispatches * rows * dim * store_bytes_per_value + 4.0 * queries * dim
    return ops, nbytes


def least_seconds(ops: float, nbytes: float) -> tuple[float, str]:
    """-> (the larger of ops at the peak rate and bytes at the memory
    rate, which of the two bounds it)."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def served_share(run):
    """The least time for the search work served in the run's captured
    stretch over the device's busy time in it, in percent; None without a
    device trace or with nothing served inside the capture.

    The work is counted from what was served, not from any kernel: the
    queries of the BatchSearch requests answered inside the capture, the
    configuration's live rows and width (2·Q·n·D operations), and the store
    read once per request (one dispatch each on the raw lane) at the
    configuration's `store_bytes_per_value`."""
    if run.device is None or "t0" not in run.capture:
        return None
    t0, t1 = run.capture["t0"], run.capture["t1"]
    served = [r for r in run.window.reqs if r.ok and t0 <= r.done <= t1]
    if not served:
        return None
    cfg = run.config
    ops, nbytes = search_work(sum(r.rows for r in served), int(cfg["n_objects"]),
                              int(cfg["data"]["dim"]), len(served),
                              float(cfg["store_bytes_per_value"]))
    least, _ = least_seconds(ops, nbytes)
    return 100.0 * least / run.device.busy_s
