"""Doc-ID allowList container and the device filter-word packer (the port's
own copy of the parts of `weaviate_tpu/storage/bitmap.py` that the index
read path needs).

`Bitmap` is a sorted uint64 array (the JAX package's container, without
its set algebra and serialization, which belong to the storage layer
still to port): membership tests for device mask building are one
searchsorted call.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from weaviate_tpu_torch.index.interface import AllowList


def pack_allow_words(allowed_rows: np.ndarray, capacity: int) -> np.ndarray:
    """Row-allowed bool vector [n] -> packed uint32 filter words over
    [capacity] slots (capacity % 32 == 0), bit i of word w = slot 32w+i:
    the device bitmap layout every masked-scan path consumes."""
    mask = np.zeros(capacity, dtype=bool)
    mask[: allowed_rows.size] = allowed_rows
    return (np.packbits(mask.reshape(-1, 32), axis=1, bitorder="little")
            .view(np.uint32).ravel())


def allowed_mask(allow: "Bitmap", docs: np.ndarray) -> np.ndarray:
    """Membership of docs in the allowList: a direct scatter table when
    the id space is dense (ids come from a monotonic counter), the sorted
    searchsorted otherwise."""
    ids = allow._ids
    n = docs.size
    if ids.size == 0 or n == 0:
        return np.zeros(n, dtype=bool)
    dmax = int(docs.max())
    top = max(dmax, int(ids[-1]))
    if top < max(4 * n, 1 << 22):
        table = np.zeros(top + 1, dtype=bool)
        table[ids] = True
        # dead slots may carry the -1 sentinel doc id; clip reads a defined
        # entry and the tombstone/high-water masks discard those slots
        return table[np.clip(docs, 0, top)]
    return allow.contains_array(docs)


class Bitmap(AllowList):
    # the index caches its per-snapshot filter resolution ON the (immutable)
    # allowList: packed device words (_words_cache) for the masked scan and
    # the slot list (_slots_cache) for the gather tier
    __slots__ = ("_ids", "_words_cache", "_slots_cache")

    def __init__(self, ids: Optional[Iterable[int] | np.ndarray] = None):
        if ids is None:
            self._ids = np.empty(0, dtype=np.uint64)
        else:
            arr = ids if isinstance(ids, np.ndarray) else np.fromiter(ids, dtype=np.uint64)
            self._ids = np.unique(arr.astype(np.uint64, copy=False))

    def contains(self, doc_id: int) -> bool:
        i = np.searchsorted(self._ids, np.uint64(doc_id))
        return bool(i < self._ids.size and self._ids[i] == np.uint64(doc_id))

    def __len__(self) -> int:
        return int(self._ids.size)

    def to_array(self) -> np.ndarray:
        return self._ids

    def contains_array(self, doc_ids: np.ndarray) -> np.ndarray:
        if self._ids.size == 0:
            return np.zeros(doc_ids.shape, dtype=bool)
        d = doc_ids.astype(np.uint64, copy=False)
        idx = np.searchsorted(self._ids, d)
        idx_c = np.clip(idx, 0, self._ids.size - 1)
        return self._ids[idx_c] == d
