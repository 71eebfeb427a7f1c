# The port's copy of weaviate_tpu/index/geo.py, its imports pointed at the port.
"""Per-geo-property index: batched haversine distance on device.

Reference: adapters/repos/db/vector/geo (geo.go:60 NewIndex) wraps the HNSW
core with a haversine distancer (distancer/geo_spatial.go) to answer
WithinGeoRange filters. A graph is the wrong shape for batched scans; the equivalent
here is a flat [N, 2] coordinate store scanned with one vectorized haversine
evaluation per query — exact, batched, and trivially maskable.
"""

from __future__ import annotations

import os
import struct
import threading

import numpy as np

from weaviate_tpu_torch.storage.bitmap import Bitmap

EARTH_RADIUS_M = 6_371_000.0
_MAGIC = b"WTGE"


def haversine_m(lat1, lon1, lat2, lon2):
    """Vectorized haversine distance in meters (geo_spatial.go parity)."""
    p1, p2 = np.radians(lat1), np.radians(lat2)
    dp = np.radians(lat2 - lat1)
    dl = np.radians(lon2 - lon1)
    a = np.sin(dp / 2.0) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(dl / 2.0) ** 2
    return 2.0 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


class GeoIndex:
    """Append-log-persisted flat coordinate index."""

    def __init__(self, path: str, persist: bool = True):
        self.path = path
        self._lock = threading.Lock()
        self._doc_ids: list[int] = []
        self._coords: list[tuple[float, float]] = []
        self._deleted: set[int] = set()
        self._log = None
        if persist:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            valid_end = self._replay()
            if os.path.exists(self._log_path):
                size = os.path.getsize(self._log_path)
                if valid_end < size:
                    # truncate a torn tail so future appends stay replayable
                    with open(self._log_path, "r+b") as f:
                        f.truncate(max(valid_end, 0))
            new = not os.path.exists(self._log_path) or os.path.getsize(self._log_path) < 4
            self._log = open(self._log_path, "ab")
            if new:
                self._log.write(_MAGIC)

    @property
    def _log_path(self) -> str:
        return self.path + ".log"

    def _replay(self) -> int:
        """-> byte offset of the last fully-valid record (for tail truncation)."""
        if not os.path.exists(self._log_path):
            return 0
        with open(self._log_path, "rb") as f:
            data = f.read()
        if data[:4] != _MAGIC:
            return 0
        off = 4
        while off + 1 <= len(data):
            op = data[off]
            if op == 1 and off + 25 <= len(data):
                did, lat, lon = struct.unpack_from("<Qdd", data, off + 1)
                self._doc_ids.append(did)
                self._coords.append((lat, lon))
                self._deleted.discard(did)
                off += 25
            elif op == 2 and off + 9 <= len(data):
                (did,) = struct.unpack_from("<Q", data, off + 1)
                self._deleted.add(did)
                off += 9
            else:
                break  # torn tail
        return off

    def add(self, doc_id: int, lat: float, lon: float) -> None:
        with self._lock:
            self._doc_ids.append(int(doc_id))
            self._coords.append((float(lat), float(lon)))
            self._deleted.discard(int(doc_id))
            if self._log is not None:
                self._log.write(struct.pack("<BQdd", 1, int(doc_id), float(lat), float(lon)))

    def delete(self, doc_id: int) -> None:
        with self._lock:
            self._deleted.add(int(doc_id))
            if self._log is not None:
                self._log.write(struct.pack("<BQ", 2, int(doc_id)))

    def __len__(self) -> int:
        return len(set(self._doc_ids) - self._deleted)

    def within_range(self, lat: float, lon: float, max_distance_m: float) -> Bitmap:
        with self._lock:
            if not self._doc_ids:
                return Bitmap()
            ids = np.asarray(self._doc_ids, dtype=np.uint64)
            coords = np.asarray(self._coords, dtype=np.float64)
        d = haversine_m(lat, lon, coords[:, 0], coords[:, 1])
        hits = ids[d <= max_distance_m]
        if self._deleted:
            dele = np.fromiter(self._deleted, dtype=np.uint64)
            hits = hits[~np.isin(hits, dele)]
        return Bitmap(hits)

    def knn(self, lat: float, lon: float, k: int) -> tuple[np.ndarray, np.ndarray]:
        with self._lock:
            if not self._doc_ids:
                return np.zeros(0, np.uint64), np.zeros(0, np.float32)
            ids = np.asarray(self._doc_ids, dtype=np.uint64)
            coords = np.asarray(self._coords, dtype=np.float64)
        d = haversine_m(lat, lon, coords[:, 0], coords[:, 1])
        if self._deleted:
            dele = np.fromiter(self._deleted, dtype=np.uint64)
            d = np.where(np.isin(ids, dele), np.inf, d)
        order = np.argsort(d)[:k]
        return ids[order], d[order].astype(np.float32)

    def flush(self) -> None:
        if self._log is not None:
            self._log.flush()
            os.fsync(self._log.fileno())

    def shutdown(self) -> None:
        if self._log is not None:
            self._log.flush()
            self._log.close()
            self._log = None

    def drop(self) -> None:
        self.shutdown()
        try:
            os.remove(self._log_path)
        except FileNotFoundError:
            pass

    def list_files(self) -> list[str]:
        return [self._log_path] if os.path.exists(self._log_path) else []
