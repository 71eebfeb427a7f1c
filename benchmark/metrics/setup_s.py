"""setup_s: seconds from the run's process start to the start of the
window (the server's start, the import, the flush and the warm-up)."""


def read(run):
    return run.setup_s
