# The port's copy of weaviate_tpu/storage/bitmap.py, its imports pointed at the port.
"""Doc-ID bitmap: the AllowList container and RoaringSet value type.

Reference: helpers/allow_list.go:19-29 (AllowList over sroar.Bitmap) and
lsmkv/roaringset/. Weaviate uses 64-bit roaring bitmaps; here the container
is a sorted uint64 numpy array — set algebra is vectorized (np.union1d /
intersect1d / setdiff1d are O(n log n) merges), membership tests for device
mask building are one np.isin/searchsorted call, and serialization is the
raw LE array (self-describing, mmap-able). For the docID densities a shard
produces (monotonic counter, indexcounter/counter.go) a sorted array is as
compact as roaring containers and much friendlier to numpy/device bridging.
"""

from __future__ import annotations

import struct
from typing import Iterable, Iterator, Optional

import numpy as np

from weaviate_tpu_torch.index.interface import AllowList

_MAGIC = b"WTBM"


def pack_allow_words(allowed_rows: np.ndarray, capacity: int) -> np.ndarray:
    """Row-allowed bool vector [n] -> packed uint32 filter words over
    [capacity] slots (capacity % 32 == 0), the device bitmap layout every
    masked-scan kernel consumes."""
    mask = np.zeros(capacity, dtype=bool)
    mask[: allowed_rows.size] = allowed_rows
    return (np.packbits(mask.reshape(-1, 32), axis=1, bitorder="little")
            .view(np.uint32).ravel())


def allowed_mask(allow: "Bitmap", docs: np.ndarray) -> np.ndarray:
    """Membership of docs in the allowList, picking the cheaper algorithm:
    doc ids come from a monotonic counter (indexcounter semantics), so when
    the id space is dense a direct scatter table is O(n + m) versus the
    O(n log m) sorted-array searchsorted."""
    ids = allow._ids
    n = docs.size
    if ids.size == 0 or n == 0:
        return np.zeros(n, dtype=bool)
    dmax = int(docs.max())
    top = max(dmax, int(ids[-1]))
    if top < max(4 * n, 1 << 22):
        table = np.zeros(top + 1, dtype=bool)
        table[ids] = True
        # dead slots may carry sentinel doc ids (-1 as int64); clip reads a
        # defined entry and the kernel's tombstone mask discards those slots
        return table[np.clip(docs, 0, top)]
    return allow.contains_array(docs)


class Bitmap(AllowList):
    # the index caches its per-snapshot filter resolution ON the (immutable)
    # allowList: packed device words (_words_cache) for the masked scan and
    # the slot list (_slots_cache) for the gather tier (index/gpu.py
    # _allow_words, _allow_slots), so repeated filtered queries with the
    # same filter skip the host pack
    __slots__ = ("_ids", "_words_cache", "_slots_cache")

    def __init__(self, ids: Optional[Iterable[int] | np.ndarray] = None, _sorted: bool = False):
        if ids is None:
            self._ids = np.empty(0, dtype=np.uint64)
        elif isinstance(ids, np.ndarray) and _sorted:
            self._ids = ids.astype(np.uint64, copy=False)
        else:
            arr = np.fromiter(ids, dtype=np.uint64) if not isinstance(ids, np.ndarray) else ids
            self._ids = np.unique(arr.astype(np.uint64, copy=False))

    # -- AllowList interface -------------------------------------------------

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

    # -- set algebra (searcher_doc_bitmap.go:25-109 merge semantics) ---------

    def and_(self, other: "Bitmap") -> "Bitmap":
        return Bitmap(np.intersect1d(self._ids, other._ids), _sorted=True)

    def or_(self, other: "Bitmap") -> "Bitmap":
        return Bitmap(np.union1d(self._ids, other._ids), _sorted=True)

    def and_not(self, other: "Bitmap") -> "Bitmap":
        return Bitmap(np.setdiff1d(self._ids, other._ids, assume_unique=True), _sorted=True)

    def add(self, doc_id: int) -> "Bitmap":
        if self.contains(doc_id):
            return self
        return Bitmap(np.append(self._ids, np.uint64(doc_id)))

    def add_many(self, doc_ids: Iterable[int]) -> "Bitmap":
        extra = np.fromiter(doc_ids, dtype=np.uint64)
        return Bitmap(np.union1d(self._ids, extra), _sorted=True)

    def remove(self, doc_id: int) -> "Bitmap":
        return Bitmap(self._ids[self._ids != np.uint64(doc_id)], _sorted=True)

    def remove_many(self, doc_ids: Iterable[int]) -> "Bitmap":
        extra = np.fromiter(doc_ids, dtype=np.uint64)
        return Bitmap(np.setdiff1d(self._ids, extra), _sorted=True)

    def __iter__(self) -> Iterator[int]:
        return iter(self._ids.tolist())

    def __eq__(self, other) -> bool:
        return isinstance(other, Bitmap) and np.array_equal(self._ids, other._ids)

    def __repr__(self) -> str:
        return f"Bitmap(n={self._ids.size})"

    def min(self) -> int:
        return int(self._ids[0]) if self._ids.size else 0

    def max(self) -> int:
        return int(self._ids[-1]) if self._ids.size else 0

    # -- codec ---------------------------------------------------------------

    def to_bytes(self) -> bytes:
        return _MAGIC + struct.pack("<Q", self._ids.size) + self._ids.astype("<u8").tobytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "Bitmap":
        if data[:4] != _MAGIC:
            raise ValueError("bad bitmap magic")
        (n,) = struct.unpack_from("<Q", data, 4)
        ids = np.frombuffer(data, dtype="<u8", count=n, offset=12).copy()
        return cls(ids, _sorted=True)

    @classmethod
    def full_range(cls, start: int, stop: int) -> "Bitmap":
        return cls(np.arange(start, stop, dtype=np.uint64), _sorted=True)
