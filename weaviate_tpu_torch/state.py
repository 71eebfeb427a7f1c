"""Carry an index's state across from the JAX package.

A JAX `IndexSnapshot`'s arrays, taken as numpy (`np.asarray` of each
device array plus the host mirrors), become the port's device state;
`GpuVectorIndex.load_state` installs it and publishes a snapshot. A
compressed snapshot carries its codes, codebooks, bf16 rescore copy and
host rows in place of the f32 store. The shared `vector.log` and
`pq.npz` formats are the other route across.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from weaviate_tpu_torch.compress.pq import ProductQuantizer
from weaviate_tpu_torch.device import resolve_device
from weaviate_tpu_torch.entities.vectorindex import STORE_DTYPES


@dataclass
class DeviceState:
    tombs: torch.Tensor       # [capacity] bool
    slot_to_doc: np.ndarray   # [capacity] int64 host mirror, -1 unwritten
    n: int                    # high-water slot count
    capacity: int
    dim: int
    # uncompressed
    store: Optional[torch.Tensor] = None         # [capacity, dim] f32 or bf16
    sq_norms: Optional[torch.Tensor] = None      # [capacity] f32 (zeros unless l2)
    # compressed
    pq: Optional[ProductQuantizer] = None
    codes: Optional[torch.Tensor] = None         # [capacity, M]
    recon_norms: Optional[torch.Tensor] = None   # [capacity] f32
    host_vecs: Optional[np.ndarray] = None       # [capacity, dim] f32
    rescore: Optional[torch.Tensor] = None       # [capacity, dim] bf16 (pq.rescore)
    rescore_sq_norms: Optional[torch.Tensor] = None  # [capacity] f32 (l2 with rescore)
    pq4: Optional[ProductQuantizer] = None
    codes4: Optional[torch.Tensor] = None        # [capacity, M/2] uint8 (pq.bits=4)
    recon_norms4: Optional[torch.Tensor] = None  # [capacity] f32


def _quantizer(codebook, rotation, dim: int, metric: str, dev, opq: bool) -> ProductQuantizer:
    """A fitted quantizer from its codebook (and rotation): what search and
    encode read; the fit settings matter only to a fit, which a compressed
    index never runs again."""
    cb = np.array(codebook, dtype=np.float32)
    pq = ProductQuantizer(dim=dim, segments=cb.shape[0], centroids=cb.shape[1], metric=metric,
                          rotation="opq" if opq else "none", device=dev)
    pq.codebook = cb
    if rotation is not None:
        pq.rotation_matrix = np.array(rotation, dtype=np.float32)
    return pq


def _store_tensor(store, store_dtype: str, dev) -> torch.Tensor:
    """The carried store as a device tensor of the store dtype: a bf16
    store comes as its bf16 values (any float dtype, upcast exactly) or as
    their bits viewed as uint16."""
    a = np.asarray(store)
    if store_dtype == "bfloat16" and a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(dev)
    t = torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
    return t.to(torch.bfloat16) if store_dtype == "bfloat16" else t


def state_from_arrays(arrays: dict, device=None, store_dtype: str = "float32") -> DeviceState:
    """arrays: "tombs" [capacity] bool, "slot_to_doc" [capacity] int64, the
    ints "n", "capacity", "dim", and either
      - uncompressed: "store" [capacity, dim] in `store_dtype` ("float32",
        or "bfloat16": bf16 values in any float dtype, or their bits as
        uint16), "sq_norms" [capacity] (the f32 rows' norms); or
      - compressed: "pq_codebook" [M, C, ds] (+ "pq_rotation" [dim, dim]),
        "metric", "codes" [capacity, M], "recon_norms" [capacity],
        "host_vecs" [capacity, dim], optionally "rescore" [capacity, dim]
        (bf16 values, any float dtype) with "rescore_sq_norms", and
        "pq4_codebook" [M, 16, ds] with "codes4" [capacity, M/2] and
        "recon_norms4",
    -> the port's DeviceState on `device` (the card unless device="cpu")."""
    dev = resolve_device(device)
    cap, n, dim = int(arrays["capacity"]), int(arrays["n"]), int(arrays["dim"])
    slot_to_doc = np.asarray(arrays["slot_to_doc"], dtype=np.int64)[:cap]

    def dev_tensor(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)  # a writable copy

    def opt(key, dtype):
        a = arrays.get(key)
        return None if a is None else dev_tensor(np.asarray(a)[:cap], dtype)

    state = DeviceState(tombs=dev_tensor(np.asarray(arrays["tombs"])[:cap], np.bool_),
                        slot_to_doc=slot_to_doc.copy(), n=n, capacity=cap, dim=dim)
    if "pq_codebook" not in arrays:
        if store_dtype not in STORE_DTYPES:
            raise ValueError(f"store_dtype must be float32 or bfloat16, got {store_dtype!r}")
        store = np.asarray(arrays["store"])
        if store.shape != (cap, dim):
            raise ValueError(f"store shape {store.shape} != {(cap, dim)}")
        state.store = _store_tensor(store, store_dtype, dev)
        state.sq_norms = dev_tensor(np.asarray(arrays["sq_norms"])[:cap], np.float32)
        return state
    metric, rot = str(arrays["metric"]), arrays.get("pq_rotation")
    state.pq = _quantizer(arrays["pq_codebook"], rot, dim, metric, dev, rot is not None)
    state.codes = dev_tensor(np.asarray(arrays["codes"])[:cap],
                             np.uint8 if state.pq.centroids <= 256 else np.int32)
    state.recon_norms = opt("recon_norms", np.float32)
    state.host_vecs = np.array(np.asarray(arrays["host_vecs"])[:cap], dtype=np.float32)
    if arrays.get("rescore") is not None:
        state.rescore = opt("rescore", np.float32).to(torch.bfloat16)
        state.rescore_sq_norms = opt("rescore_sq_norms", np.float32)
    if arrays.get("pq4_codebook") is not None:
        state.pq4 = _quantizer(arrays["pq4_codebook"], rot, dim, metric, dev, False)
        state.codes4 = opt("codes4", np.uint8)
        state.recon_norms4 = opt("recon_norms4", np.float32)
    return state
