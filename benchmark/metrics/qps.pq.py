"""qps.pq: queries answered in the traced run's window, over the window's
length, in the cell whose rate is too unsteady from run to run for a bound
(PERF.md §2); read per layer, under the tracer."""


def read(run):
    if run.traffic["protocol"] != "grpc_batch_search":
        return None
    return run.rows_done / run.seconds
