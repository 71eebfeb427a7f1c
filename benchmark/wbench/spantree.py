"""Readers of single steps of the program's span tree (`GET
/debug/traces`), by span name, for the per-layer metrics of the gRPC raw
lane, the host index's dispatch and the REST import. A program that does
not record a step gives no value: every reader returns None then."""

from wbench import spans

IMPORT = ("rest", "POST /v1/batch/objects")
BATCH = ("grpc", "BatchSearch")


def find(span, name):
    """The spans named `name` anywhere under `span`."""
    out = []
    for c in span.get("children", []):
        if c.get("name") == name:
            out.append(c)
        out.extend(find(c, name))
    return out


def summed(span, names):
    """The summed duration of the spans under `span` named in `names`, or
    None when there is none."""
    found = [s for n in names for s in find(span, n)]
    return sum(s.get("duration_ms", 0.0) for s in found) if found else None


def mean(values):
    """The mean of `values`, or None when there is none."""
    return sum(values) / len(values) if values else None


def per_request_p50(run, root, names):
    """The p50, over the window's traces of the `root` (kind, name), of
    each request's summed `names` spans."""
    return spans.p50([summed(r, names) for r in spans.roots(run, *root)])


def device_searches(run, root):
    """The `device_search` phases of the dispatches under the traces of
    `root`."""
    return [c for r in spans.roots(run, *root) for d in spans.dispatches(r)
            for c in d.get("children", []) if c.get("name") == "device_search"]


def device_ms(run, root):
    """The p50 of the dispatches' device time as their CUDA events measured
    it (the `device_ms` fact). A dispatch that carries
    `dispatch_device_ms` is from a program whose `device_ms` was the
    host's blocked time, shared by rows: not read."""
    return spans.p50([d["attrs"]["device_ms"] for r in spans.roots(run, *root)
                      for d in spans.dispatches(r)
                      if "device_ms" in d.get("attrs", {})
                      and "dispatch_device_ms" not in d["attrs"]])
