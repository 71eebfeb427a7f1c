"""recall_at_10: the mean share of the exact top 10 (the reference, under
the configuration's distance) among the answers of the seeded sample of
the window's queries."""


def read(run):
    r = run.readings.get("recall")
    return None if r is None or not run.readings.get("sampled") else r
