"""Device resolution for the port's entry points.

Every entry point takes an explicit `device` argument that defaults to
the CUDA card. The CPU is used only when the caller asks for it by name
(the CPU tests do); a missing card is an error, never a quiet move to
the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """-> the torch.device an entry point runs on. None means the card.
    Raises RuntimeError when a CUDA device is asked for (explicitly or by
    default) and torch sees none; raises ValueError for any other device
    type."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "weaviate_tpu_torch runs on a CUDA device and torch sees "
                "none; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev} (want 'cuda' or 'cpu')")
