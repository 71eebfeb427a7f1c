"""The reader of the share of BatchSearch dispatches that the host index
served by replaying a CUDA graph, over hand-made traces."""

import pytest

from wbench import spec
from test_wbench_readers import fake_run
from test_wbench_spantree import batch_trace, import_trace


def test_dispatch_graph_share_reads_the_replays():
    """The share of BatchSearch dispatches whose `graph` fact is `replay`;
    an import's dispatches and a dispatch without the fact do not count."""
    traces = []
    for fact in ("eager", "capture", "replay", "replay", "replay", None):
        t = batch_trace(0)
        if fact is not None:
            t["root"]["children"][1]["attrs"]["graph"] = fact
        traces.append(t)
    traces.append(import_trace(0))
    read = spec.metric_reader("dispatch_graph_pct.batch")
    assert read(fake_run([], traces=traces)) == pytest.approx(60.0)
    assert read(fake_run([], traces=traces[-2:])) is None  # a program without the fact
