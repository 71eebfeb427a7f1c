"""The kernel wrappers launch under the tensor's device, not the thread's
current one: the C entry points launch on the calling thread's current
CUDA device and set the kernels' shared-memory attribute there, so
`gmin_scan.launch_scan` (K1, K1-bf16) and `pq_gmin.launch_codes` (K2, K3)
enter `torch.cuda.device(q.device)` around the query scratch and the
launch. A mesh slab on another card than the current one depends on it.

On the CPU the C library, `torch.cuda.device` and the stream lookup are
spies, and the wrappers' launch halves run on CPU tensors: the spy launch
records which device guard was open when it ran. The card's own check is
`tests/test_torch_kernels_cuda.py::test_launch_runs_under_the_tensors_device`
and `chip_smoke.py`'s.
"""

from types import SimpleNamespace

import torch

from weaviate_tpu_torch.ops import gmin_scan, pq_gmin


class _GuardSpy:
    """Stands in for torch.cuda.device: records the devices entered."""

    open: list = []

    def __init__(self, device):
        self.device = torch.device(device)

    def __enter__(self):
        _GuardSpy.open.append(self.device)
        return self

    def __exit__(self, *exc):
        _GuardSpy.open.pop()
        return False


def _spies(monkeypatch):
    seen = {"launch": [], "scratch": []}
    _GuardSpy.open = []

    def launch(*args):
        seen["launch"].append(list(_GuardSpy.open))
        return 0

    real_scratch = gmin_scan.query_scratch

    def scratch(q, plan):
        seen["scratch"].append(list(_GuardSpy.open))
        return real_scratch(q, plan)

    monkeypatch.setattr(torch.cuda, "device", _GuardSpy)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(gmin_scan, "query_scratch", scratch)
    monkeypatch.setattr(pq_gmin, "query_scratch", scratch)
    lib = SimpleNamespace(gmin_scan_launch=launch, gmin_scan_bf16_launch=launch,
                          pq8_gmin_launch=launch, pq4_gmin_launch=launch)
    monkeypatch.setattr(gmin_scan, "_gmin_lib", lambda: lib)
    monkeypatch.setattr(pq_gmin, "codes_lib", lambda: lib)
    return seen


def test_k1_launch_enters_the_tensors_device(monkeypatch):
    seen = _spies(monkeypatch)
    b, ncols, d = 8, 64, 32
    q = torch.zeros((b, d))
    plan = gmin_scan.resident_plan(d, 4)
    for dtype in (torch.float32, torch.bfloat16):
        store3 = torch.zeros((gmin_scan.G, ncols, d), dtype=dtype)
        out = gmin_scan.launch_scan(q, store3, torch.zeros((gmin_scan.G, ncols)), -2.0, 4, plan)
        assert out.shape == (b, ncols)
    assert seen["launch"] == [[q.device]] * 2
    assert seen["scratch"] == [[q.device]] * 2
    assert _GuardSpy.open == []  # the guard closes after the launch


def test_k2_k3_launch_enters_the_tensors_device(monkeypatch):
    seen = _spies(monkeypatch)
    b, ncols, d, m, c = 8, 64, 32, 8, 16
    q = torch.zeros((b, d))
    for fn, nb in (("pq8_gmin_launch", m), ("pq4_gmin_launch", m // 2)):
        out = pq_gmin.launch_codes(fn, q, torch.zeros((gmin_scan.G, ncols, nb), dtype=torch.uint8),
                                   torch.zeros((gmin_scan.G, ncols)),
                                   torch.zeros((m, c, d // m), dtype=torch.bfloat16), -1.0, 16,
                                   b, d, gmin_scan.G, ncols, m, c)
        assert out.shape == (b, ncols)
    assert seen["launch"] == [[q.device]] * 2
    assert seen["scratch"] == [[q.device]] * 2
    assert _GuardSpy.open == []
