"""import_objects_s: objects acknowledged in the window, over the
window's length."""


def read(run):
    if run.traffic["protocol"] != "rest_batch_import":
        return None
    return run.rows_done / run.seconds
