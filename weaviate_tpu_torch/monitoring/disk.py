# The port's copy of weaviate_tpu/monitoring/disk.py, its imports pointed at the port.
"""Disk-pressure failure detection: warn, then flip shards READONLY.

Reference: entities/storagestate + shard_status.go — when the data volume
crosses DISK_USE_WARNING_PERCENTAGE the node logs a warning; crossing
DISK_USE_READONLY_PERCENTAGE flips every local shard to READONLY so writes
fail fast instead of filling the disk and corrupting WALs. Recovery is an
operator action (PUT /v1/schema/{class}/shards/{shard} status=READY),
matching the reference's manual re-activation.
"""

from __future__ import annotations

import shutil
import sys
import threading
from typing import Optional


class DiskMonitor:
    def __init__(self, db, warning_pct: float, readonly_pct: float,
                 interval: float = 10.0):
        self.db = db
        self.warning_pct = warning_pct
        self.readonly_pct = readonly_pct
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._warned = False
        self.readonly_triggered = False

    def usage_pct(self) -> float:
        u = shutil.disk_usage(self.db.root_path)
        return 100.0 * u.used / u.total if u.total else 0.0

    def check_once(self) -> None:
        pct = self.usage_pct()
        if self.readonly_pct and pct >= self.readonly_pct:
            if not self.readonly_triggered:
                self.readonly_triggered = True
                print(
                    f"disk usage {pct:.1f}% >= readonly threshold "
                    f"{self.readonly_pct}%: marking all shards READONLY",
                    file=sys.stderr, flush=True,
                )
            for idx in list(self.db.indexes.values()):
                for shard in idx.shards.values():
                    if shard.status != "READONLY":
                        shard.set_status("READONLY")
        elif self.warning_pct and pct >= self.warning_pct and not self._warned:
            self._warned = True
            print(
                f"disk usage {pct:.1f}% >= warning threshold {self.warning_pct}%",
                file=sys.stderr, flush=True,
            )

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.check_once()
                except Exception:  # noqa: BLE001 — the monitor must survive
                    pass

        self._thread = threading.Thread(target=loop, daemon=True, name="disk-monitor")
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
