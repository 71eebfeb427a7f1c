# The port's copy of weaviate_tpu/storage/docid.py, its imports pointed at the port.
"""Monotonic doc-ID allocation (reference: adapters/repos/db/indexcounter/
counter.go — file-backed uint64 counter, and docid/ lookup helpers)."""

from __future__ import annotations

import os
import struct
import threading


class Counter:
    """File-backed monotonically increasing uint64 docID allocator.

    Persists in steps of `reserve` so a crash can skip but never reuse ids
    (same guarantee as the reference's counter file)."""

    def __init__(self, path: str, reserve: int = 1000):
        self.path = path
        self.reserve = reserve
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if os.path.exists(path):
            with open(path, "rb") as f:
                data = f.read(8)
            self._next = struct.unpack("<Q", data)[0] if len(data) == 8 else 0
        else:
            self._next = 0
        self._persisted = self._next
        self._persist(self._next + reserve)

    def _persist(self, value: int) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(struct.pack("<Q", value))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._persisted = value

    def get_and_inc(self) -> int:
        with self._lock:
            v = self._next
            self._next += 1
            if self._next >= self._persisted:
                self._persist(self._next + self.reserve)
            return v

    def get_and_inc_many(self, n: int) -> int:
        """Reserve n consecutive ids, return the first."""
        with self._lock:
            v = self._next
            self._next += n
            if self._next >= self._persisted:
                self._persist(self._next + self.reserve)
            return v

    def peek(self) -> int:
        with self._lock:
            return self._next

    def drop(self) -> None:
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass
