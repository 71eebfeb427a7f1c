"""weaviate_tpu_torch: the PyTorch/CUDA port of weaviate_tpu.

The package mirrors `weaviate_tpu/` path for path (the one rename is
`index/tpu.py` -> `index/gpu.py`) and is held against it by the
`tests/test_torch_*.py` parity tests. It imports torch and never jax, and
nothing of `weaviate_tpu`: host modules it needs are copied here.

Entry points run on the CUDA card unless the caller passes
`device="cpu"` (see `device.resolve_device`); the server is
`python -m weaviate_tpu_torch [--device cpu]`. The hand-written Hopper
kernels live under `csrc/` and build at first use (`ops/_kernels.py`).
"""

from weaviate_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
