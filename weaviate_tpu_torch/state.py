"""Carry an index's state across from the JAX package.

A JAX `IndexSnapshot`'s arrays, taken as numpy (`np.asarray` of each
device array plus the host mirrors), become the port's device state;
`GpuVectorIndex.load_state` installs it and publishes a snapshot. The
shared `vector.log` format is the other route across.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from weaviate_tpu_torch.device import resolve_device


@dataclass
class DeviceState:
    store: torch.Tensor       # [capacity, dim] f32
    sq_norms: torch.Tensor    # [capacity] f32 (row norms; zeros unless l2)
    tombs: torch.Tensor       # [capacity] bool
    slot_to_doc: np.ndarray   # [capacity] int64 host mirror, -1 unwritten
    n: int                    # high-water slot count
    capacity: int
    dim: int


def state_from_arrays(arrays: dict, device=None) -> DeviceState:
    """arrays: "store" [capacity, dim], "sq_norms" [capacity], "tombs"
    [capacity] bool, "slot_to_doc" [capacity] int64, and the ints "n",
    "capacity", "dim" -> the port's DeviceState on `device` (the card
    unless device="cpu")."""
    dev = resolve_device(device)
    cap, n, dim = int(arrays["capacity"]), int(arrays["n"]), int(arrays["dim"])
    store = np.asarray(arrays["store"], dtype=np.float32)
    if store.shape != (cap, dim):
        raise ValueError(f"store shape {store.shape} != {(cap, dim)}")
    slot_to_doc = np.asarray(arrays["slot_to_doc"], dtype=np.int64)[:cap]

    def dev_tensor(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)  # a writable copy

    return DeviceState(
        store=dev_tensor(store, np.float32),
        sq_norms=dev_tensor(np.asarray(arrays["sq_norms"])[:cap], np.float32),
        tombs=dev_tensor(np.asarray(arrays["tombs"])[:cap], np.bool_),
        slot_to_doc=slot_to_doc.copy(),
        n=n, capacity=cap, dim=dim)
