# The port's copy of weaviate_tpu/modules/backup_fs.py, its imports pointed at the port.
"""backup-filesystem: backup storage backend on a local/NFS path.

Reference: modules/backup-filesystem — the simplest BackupBackend: artifacts
live under {root}/{backup_id}/{key}, metadata as backup_config.json. S3/GCS/
Azure backends implement the same four verbs against object stores.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from weaviate_tpu_torch.modules.interface import BackupBackend, Module

META_FILE = "backup_config.json"


class FilesystemBackupBackend(Module, BackupBackend):
    def __init__(self, root: str):
        self.root = root

    @property
    def name(self) -> str:
        return "backup-filesystem"

    @property
    def module_type(self) -> str:
        return "backup"

    def meta(self) -> dict:
        return {"type": "backup", "rootPath": self.root}

    def _path(self, backup_id: str, key: str = "") -> str:
        if (not backup_id or os.path.isabs(backup_id)
                or os.path.basename(backup_id) != backup_id
                or backup_id in (".", "..")):
            raise ValueError(f"invalid backup id {backup_id!r}")
        base = os.path.join(self.root, backup_id)
        full = os.path.normpath(os.path.join(base, key)) if key else base
        if not (full == os.path.normpath(base) or
                full.startswith(os.path.normpath(base) + os.sep)):
            raise ValueError(f"backup key escapes backup dir: {key!r}")
        return full

    def put_object(self, backup_id: str, key: str, data: bytes) -> None:
        full = self._path(backup_id, key)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        tmp = full + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, full)

    def get_object(self, backup_id: str, key: str) -> bytes:
        with open(self._path(backup_id, key), "rb") as f:
            return f.read()

    def write_meta(self, backup_id: str, meta: dict) -> None:
        self.put_object(backup_id, META_FILE, json.dumps(meta).encode("utf-8"))

    def read_meta(self, backup_id: str) -> Optional[dict]:
        try:
            return json.loads(self.get_object(backup_id, META_FILE))
        except FileNotFoundError:
            return None

    def put_file(self, backup_id: str, key: str, src_path: str) -> None:
        import shutil

        full = self._path(backup_id, key)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        tmp = full + ".tmp"
        with open(src_path, "rb") as src, open(tmp, "wb") as dst:
            shutil.copyfileobj(src, dst, length=1 << 20)
            dst.flush()
            os.fsync(dst.fileno())
        os.replace(tmp, full)

    def fetch_to_file(self, backup_id: str, key: str, dst_path: str) -> None:
        import shutil

        os.makedirs(os.path.dirname(dst_path), exist_ok=True)
        with open(self._path(backup_id, key), "rb") as src, open(dst_path, "wb") as dst:
            shutil.copyfileobj(src, dst, length=1 << 20)

    def home_id(self, backup_id: str) -> str:
        return self._path(backup_id)
