# The port's copy of weaviate_tpu/cluster/tx.py, its imports pointed at the port.
"""Two-phase schema transactions.

Reference: usecases/cluster/transactions_write.go — TxManager broadcasts an
"open" (prepare) to every participant, aborts everywhere if any participant
rejects, then broadcasts "commit". The schema manager calls
`tx.broadcast_commit(tx_type, payload)` before applying locally
(schema/manager.py); participants apply through the same `apply_*` methods
the coordinator uses, so both sides converge on identical state.

The participant side keeps open transactions in memory with a TTL —
a crashed coordinator's tx expires instead of wedging the node
(transactions_write.go clean-up behavior).
"""

from __future__ import annotations

import http.client as _hc
import json
import threading
import time
import uuid as uuidlib
from typing import Optional

from weaviate_tpu_torch.schema.manager import (
    TX_ADD_CLASS,
    TX_ADD_PROPERTY,
    TX_DELETE_CLASS,
    TX_UPDATE_CLASS,
)


class TxError(RuntimeError):
    pass


class TxParticipant:
    """Remote-node side: validates/opens, then applies on commit."""

    def __init__(self, schema_manager, tx_ttl: float = 60.0):
        self.schema = schema_manager
        self.tx_ttl = tx_ttl
        self._open: dict[str, tuple[str, dict, float]] = {}
        self._lock = threading.Lock()

    def open(self, tx_id: str, tx_type: str, payload: dict) -> None:
        with self._lock:
            now = time.time()
            # expire stale txs from dead coordinators
            for tid in [t for t, (_, _, ts) in self._open.items() if now - ts > self.tx_ttl]:
                del self._open[tid]
            self._open[tx_id] = (tx_type, payload, now)

    def commit(self, tx_id: str) -> None:
        with self._lock:
            entry = self._open.pop(tx_id, None)
        if entry is None:
            raise TxError(f"unknown tx {tx_id}")
        tx_type, payload, _ = entry
        self.apply(tx_type, payload)

    def abort(self, tx_id: str) -> None:
        with self._lock:
            self._open.pop(tx_id, None)

    def apply(self, tx_type: str, payload: dict) -> None:
        from weaviate_tpu_torch.entities.schema import ClassDef, Property

        if tx_type == TX_ADD_CLASS:
            self.schema.apply_add_class(ClassDef.from_dict(payload["class"]))
        elif tx_type == TX_DELETE_CLASS:
            self.schema.apply_delete_class(payload["class"])
        elif tx_type == TX_ADD_PROPERTY:
            self.schema.apply_add_property(
                payload["class"], Property.from_dict(payload["property"])
            )
        elif tx_type == TX_UPDATE_CLASS:
            self.schema.apply_update_class(payload["class"], payload["updated"])
        else:
            raise TxError(f"unknown tx type {tx_type!r}")


class TxManager:
    """Coordinator side, filling the schema manager's `tx` seam.

    broadcast_commit = open on all remotes -> (any failure => abort all,
    raise) -> commit on all remotes. The local apply happens in the schema
    manager right after this returns, mirroring the reference's
    commit-locally-last ordering."""

    def __init__(self, cluster_state, http_timeout: float = 10.0,
                 tolerate_node_failures: bool = False):
        from weaviate_tpu_torch.cluster.httputil import Http

        self.cluster = cluster_state
        self.http = Http(http_timeout)
        self.tolerate_node_failures = tolerate_node_failures

    def _remotes(self) -> list[tuple[str, str]]:
        out = []
        for name in self.cluster.all_names():
            if name == self.cluster.local_name:
                continue
            host = self.cluster.node_address(name)
            if host:
                out.append((name, host))
        return out

    def _post(self, host: str, path: str, body: dict) -> tuple[int, str]:
        status, raw = self.http.request(
            host, "POST", path, body=json.dumps(body).encode("utf-8")
        )
        return status, raw.decode("utf-8", "replace")

    def broadcast_commit(self, tx_type: str, payload: dict) -> None:
        remotes = self._remotes()
        if not remotes:
            return
        tx_id = str(uuidlib.uuid4())
        opened: list[tuple[str, str]] = []
        failed: Optional[str] = None
        for name, host in remotes:
            try:
                status, text = self._post(
                    host,
                    f"/schema/transactions/{tx_id}/open",
                    {"type": tx_type, "payload": payload},
                )
                if status != 200:
                    failed = f"{name}: {status} {text}"
                    break
                opened.append((name, host))
            except (OSError, _hc.HTTPException) as e:
                if self.tolerate_node_failures:
                    self.cluster.mark(name, False)
                    continue
                failed = f"{name}: {e}"
                break
        if failed is not None:
            for _, host in opened:
                try:
                    self._post(host, f"/schema/transactions/{tx_id}/abort", {})
                except (OSError, _hc.HTTPException):
                    pass
            raise TxError(f"schema tx open rejected by {failed}")
        for name, host in opened:
            try:
                status, text = self._post(host, f"/schema/transactions/{tx_id}/commit", {})
                if status != 200:
                    raise TxError(f"schema tx commit failed on {name}: {status} {text}")
            except (OSError, _hc.HTTPException) as e:
                if self.tolerate_node_failures:
                    self.cluster.mark(name, False)
                    continue
                raise TxError(f"schema tx commit failed on {name}: {e}") from e
