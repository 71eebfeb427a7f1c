"""disk_bytes_per_object.import: the growth of the server's data
directory over the window (its LSM WAL and segments, vector.log), over the
objects acknowledged in it."""


def read(run):
    if run.traffic["protocol"] != "rest_batch_import" or not run.rows_done:
        return None
    return run.data_bytes / run.rows_done
