"""The span readers' arithmetic: quantities of the window's request traces
(`GET /debug/traces`) of one kind and name."""

import numpy as np


def roots(run, kind, name):
    return [t["root"] for t in run.traces if t.get("kind") == kind and t.get("name") == name]


def dispatches(span):
    """The dispatch spans anywhere under `span`."""
    out = []
    for c in span.get("children", []):
        if c.get("name") == "dispatch":
            out.append(c)
        else:
            out.extend(dispatches(c))
    return out


def phase(d, name):
    return sum(c.get("duration_ms", 0.0) for c in d.get("children", [])
               if c.get("name") == name)


def p50(values):
    values = [v for v in values if v is not None]
    return float(np.percentile(values, 50)) if values else None


def server_self(run, kind, name):
    """The root span's self time: its duration less its children's."""
    return p50([r["duration_ms"] - sum(c.get("duration_ms", 0.0) for c in r.get("children", []))
                for r in roots(run, kind, name) if r.get("duration_ms") is not None])


def has_phase(d, name):
    return any(c.get("name") == name for c in d.get("children", []))


def dispatch_phase_p50(run, kind, name, phase_name):
    """The p50 of a dispatch phase over the traces of one kind and name."""
    return p50([phase(d, phase_name) for r in roots(run, kind, name)
                for d in dispatches(r) if has_phase(d, phase_name)])
