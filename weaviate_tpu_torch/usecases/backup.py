# The port's copy of weaviate_tpu/usecases/backup.py, its imports pointed at the port.
"""Backup subsystem: scheduler + per-node backupper/restorer.

Reference: usecases/backup/ — Scheduler is the API facade
(scheduler.go), the coordinator runs the multi-node protocol over the
cluster API (coordinator.go: can-commit/commit per node), and each node's
backupper/restorer copies its local shards' files to a module storage
backend (backupper.go, restorer.go; repo side adapters/repos/db/backup.go:
flush, list files, copy, resume).

Layout in the backend:
    {backup_id}/backup_config.json              global meta (+schema snapshot)
    {backup_id}/{node}/{class}/{shard}/{rel}    shard files, node-keyed

Jobs run async (background thread) with status STARTED -> TRANSFERRING ->
SUCCESS | FAILED, mirroring backup/status.go; restore requires the class to
be absent (the reference refuses to restore over live data) and the same
node names as at backup time.
"""

from __future__ import annotations

import os
import threading
import time

from weaviate_tpu_torch.entities.schema import ClassDef

STATUS_STARTED = "STARTED"
STATUS_TRANSFERRING = "TRANSFERRING"
STATUS_SUCCESS = "SUCCESS"
STATUS_FAILED = "FAILED"


class BackupError(ValueError):
    pass


class BackupScheduler:
    def __init__(self, db, schema, modules, node_name: str = "node-0",
                 cluster=None, node_client=None):
        self.db = db
        self.schema = schema
        self.modules = modules
        self.node_name = node_name
        self.cluster = cluster          # ClusterState (multi-node) or None
        self.node_client = node_client  # NodeClient for remote backup calls
        self._status: dict[str, dict] = {}       # backup_id -> status payload
        self._restore_status: dict[str, dict] = {}
        self._lock = threading.Lock()

    # -- helpers -------------------------------------------------------------

    def _backend(self, name: str):
        if self.modules is None:
            raise BackupError("no modules enabled: backup needs a backend module")
        be = self.modules.backup_backend(name)
        if be is None:
            raise BackupError(f"backup backend {name!r} is not an enabled module")
        return be

    def _classes(self, body: dict) -> list[str]:
        all_classes = sorted(self.schema.get_schema().classes)
        include = body.get("include") or []
        exclude = body.get("exclude") or []
        if include and exclude:
            raise BackupError("include and exclude are mutually exclusive")
        if include:
            missing = [c for c in include if c not in all_classes]
            if missing:
                raise BackupError(f"unknown classes in include: {missing}")
            return include
        return [c for c in all_classes if c not in exclude]

    def _set_status(self, table: dict, backup_id: str, status: str,
                    error: str = "", **extra) -> dict:
        payload = {"id": backup_id, "status": status, "error": error or None,
                   "path": "", **extra}
        with self._lock:
            table[backup_id] = payload
        return payload

    # -- backup (backupper.go) ----------------------------------------------

    def backup(self, backend_name: str, body: dict) -> dict:
        backend = self._backend(backend_name)
        backup_id = body.get("id") or f"backup-{int(time.time())}"
        if backend.read_meta(backup_id) is not None:
            raise BackupError(f"backup {backup_id!r} already exists")
        classes = self._classes(body)
        if not classes:
            raise BackupError("nothing to back up: no classes selected")
        # check-and-reserve atomically: a concurrent request with the same
        # id must lose here, not interleave file writes
        with self._lock:
            running = self._status.get(backup_id)
            if running is not None and running["status"] in (STATUS_STARTED, STATUS_TRANSFERRING):
                raise BackupError(f"backup {backup_id!r} is already running")
            payload = {"id": backup_id, "status": STATUS_STARTED, "error": None,
                       "path": "", "backend": backend_name, "classes": classes}
            self._status[backup_id] = payload
        t = threading.Thread(
            target=self._run_backup, args=(backend, backend_name, backup_id, classes),
            daemon=True, name=f"backup-{backup_id}",
        )
        t.start()
        return payload

    def _backup_local_shards(self, backend, backup_id: str,
                             classes: list[str]) -> dict:
        """Copy this node's local shards for `classes` into the backend.
        -> {class: {shard: [relative file paths]}} for the backup manifest
        (keeps restore backend-agnostic: no listing of backend internals)."""
        manifest: dict = {}
        for cname in classes:
            idx = self.db.get_index(cname)
            if idx is None:
                continue
            for sname, shard in idx.shards.items():
                # copy under the shard's write lock: a concurrent memtable
                # flush would otherwise add a segment missing from this
                # listing while truncating the WAL we are about to copy
                with shard.paused_writes():
                    base = shard.path
                    rels = []
                    for root, _, files in os.walk(base):
                        for fn in files:
                            if fn.endswith(".tmp"):
                                continue  # in-flight compaction/flush scratch
                            full = os.path.join(root, fn)
                            rel = os.path.relpath(full, base)
                            rels.append(rel)
                            backend.put_file(
                                backup_id,
                                f"{self.node_name}/{cname}/{sname}/{rel}",
                                full,
                            )
                manifest.setdefault(cname, {})[sname] = sorted(rels)
        return manifest

    def _run_backup(self, backend, backend_name: str, backup_id: str,
                    classes: list[str]) -> None:
        try:
            self._set_status(self._status, backup_id, STATUS_TRANSFERRING,
                             backend=backend_name, classes=classes)
            files = {self.node_name: self._backup_local_shards(backend, backup_id, classes)}
            # coordinator role: every other node ships its own local shards
            # to the (shared) backend (coordinator.go commit phase)
            if self.cluster is not None and self.node_client is not None:
                for name in self.cluster.all_names():
                    if name == self.node_name:
                        continue
                    host = self.cluster.node_address(name)
                    files[name] = self.node_client.backup_shards(
                        host, backend_name, backup_id, classes
                    )
            meta = {
                "id": backup_id,
                "status": STATUS_SUCCESS,
                "startedAt": time.time(),
                "nodes": sorted(files),
                "classes": classes,
                "files": files,
                "schema": {
                    c: self.schema.get_class(c).to_dict() for c in classes
                },
            }
            backend.write_meta(backup_id, meta)
            self._set_status(self._status, backup_id, STATUS_SUCCESS,
                             backend=backend_name, classes=classes,
                             path=backend.home_id(backup_id))
        except Exception as e:  # noqa: BLE001 — job error becomes FAILED status
            self._set_status(self._status, backup_id, STATUS_FAILED, error=str(e))

    def backup_local(self, backend_name: str, backup_id: str,
                     classes: list[str]) -> dict:
        """Participant side (clusterapi entry): ship this node's shards,
        return the file manifest to the coordinator."""
        return self._backup_local_shards(self._backend(backend_name), backup_id, classes)

    def restore_local(self, backend_name: str, backup_id: str,
                      classes: list[str]) -> None:
        """Participant side: pull this node's shard files per the manifest.
        The class itself already exists via the schema 2PC."""
        backend = self._backend(backend_name)
        meta = backend.read_meta(backup_id)
        if meta is None:
            raise BackupError(f"backup {backup_id!r} not found")
        self._restore_local_shards(backend, backup_id, meta, classes)

    def backup_status(self, backend_name: str, backup_id: str) -> dict:
        with self._lock:
            st = self._status.get(backup_id)
        if st is not None:
            return st
        meta = self._backend(backend_name).read_meta(backup_id)
        if meta is None:
            raise BackupError(f"backup {backup_id!r} not found")
        return {"id": backup_id, "status": meta.get("status"), "error": None,
                "path": self._backend(backend_name).home_id(backup_id)}

    # -- restore (restorer.go) ------------------------------------------------

    def restore(self, backend_name: str, backup_id: str, body: dict) -> dict:
        backend = self._backend(backend_name)
        meta = backend.read_meta(backup_id)
        if meta is None:
            raise BackupError(f"backup {backup_id!r} not found")
        include = body.get("include") or []
        exclude = body.get("exclude") or []
        classes = [
            c for c in meta["classes"]
            if (not include or c in include) and c not in exclude
        ]
        if not classes:
            raise BackupError("nothing to restore: no classes selected")
        for c in classes:
            if self.schema.get_class(c) is not None:
                raise BackupError(
                    f"cannot restore: class {c!r} already exists (delete it first)"
                )
        with self._lock:
            running = self._restore_status.get(backup_id)
            if running is not None and running["status"] in (STATUS_STARTED, STATUS_TRANSFERRING):
                raise BackupError(f"restore of {backup_id!r} is already running")
            payload = {"id": backup_id, "status": STATUS_STARTED, "error": None,
                       "path": "", "backend": backend_name, "classes": classes}
            self._restore_status[backup_id] = payload
        t = threading.Thread(
            target=self._run_restore,
            args=(backend, backend_name, backup_id, meta, classes),
            daemon=True, name=f"restore-{backup_id}",
        )
        t.start()
        return payload

    def _restore_local_shards(self, backend, backup_id: str, meta: dict,
                              classes: list[str]) -> None:
        """Pull this node's shard files (per the backup manifest) out of the
        backend and reload the shards."""
        my_files = (meta.get("files") or {}).get(self.node_name) or {}
        for cname in classes:
            idx = self.db.get_index(cname)
            if idx is None:
                continue
            for sname, rels in (my_files.get(cname) or {}).items():
                # retire the live shard FIRST: its shutdown flush would
                # otherwise clobber restored segments/WALs written under it
                old = idx.shards.pop(sname, None)
                if old is not None:
                    old.shutdown()
                import shutil

                shard_dir = os.path.join(idx.path, sname)
                shutil.rmtree(shard_dir, ignore_errors=True)
                for rel in rels:
                    target = os.path.join(shard_dir, rel)
                    os.makedirs(os.path.dirname(target), exist_ok=True)
                    backend.fetch_to_file(
                        backup_id, f"{self.node_name}/{cname}/{sname}/{rel}", target
                    )
                if idx.sharding_state.is_local(sname, self.db.node_name):
                    idx._load_shard(sname)

    def _run_restore(self, backend, backend_name: str, backup_id: str,
                     meta: dict, classes: list[str]) -> None:
        try:
            self._set_status(self._restore_status, backup_id, STATUS_TRANSFERRING,
                             backend=backend_name, classes=classes)
            # 1. recreate classes from the schema snapshot — through the
            #    schema manager so the change propagates cluster-wide (2PC)
            for cname in classes:
                cd = ClassDef.from_dict(meta["schema"][cname])
                if self.schema.get_class(cname) is None:
                    self.schema.add_class(cd)
            # 2. every node pulls its own shard files
            self._restore_local_shards(backend, backup_id, meta, classes)
            if self.cluster is not None and self.node_client is not None:
                for name in self.cluster.all_names():
                    if name == self.node_name:
                        continue
                    host = self.cluster.node_address(name)
                    self.node_client.restore_shards(host, backend_name, backup_id, classes)
            self._set_status(self._restore_status, backup_id, STATUS_SUCCESS,
                             backend=backend_name, classes=classes,
                             path=backend.home_id(backup_id))
        except Exception as e:  # noqa: BLE001
            self._set_status(self._restore_status, backup_id, STATUS_FAILED,
                             error=str(e))

    def restore_status(self, backend_name: str, backup_id: str) -> dict:
        with self._lock:
            st = self._restore_status.get(backup_id)
        if st is None:
            raise BackupError(f"no restore running for {backup_id!r}")
        return st

    def wait(self, backup_id: str, restore: bool = False, timeout: float = 60.0) -> dict:
        """Test/CLI helper: block until the async job leaves TRANSFERRING."""
        table = self._restore_status if restore else self._status
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                st = table.get(backup_id)
            if st is not None and st["status"] in (STATUS_SUCCESS, STATUS_FAILED):
                return st
            time.sleep(0.02)
        raise TimeoutError(f"backup job {backup_id} still running")
