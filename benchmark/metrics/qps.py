"""qps: queries answered in the window, over the window's length."""


def read(run):
    if run.traffic["protocol"] != "grpc_batch_search":
        return None
    return run.rows_done / run.seconds
