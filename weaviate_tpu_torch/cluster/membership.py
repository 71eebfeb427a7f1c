# The port's copy of weaviate_tpu/cluster/membership.py, its imports pointed at the port.
"""Cluster membership: node registry + liveness.

Reference: usecases/cluster/state.go — hashicorp memberlist gossip keeps the
node set and health score. Here membership is an explicit registry
(CLUSTER_JOIN env / config, or programmatic registration in tests) with
active liveness probes against each node's cluster API — the same role
(name -> host resolution, AllNames, ClusterHealthScore, NodeCount) without a
gossip dependency; a gossip transport can replace the probe loop behind the
same interface later.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional


@dataclass
class NodeInfo:
    name: str
    host: str          # "host:port" of the node's cluster API
    alive: bool = True
    last_seen: float = 0.0


class ClusterState:
    """state.go:38 Init analog. `local_name` is this node; `nodes` maps every
    known node (including local) to its cluster-API address."""

    def __init__(self, local_name: str = "node-0", probe_interval: float = 5.0):
        self.local_name = local_name
        self.probe_interval = probe_interval
        self._nodes: dict[str, NodeInfo] = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None

    # -- registry ------------------------------------------------------------

    def register(self, name: str, host: str) -> None:
        with self._lock:
            self._nodes[name] = NodeInfo(name=name, host=host, last_seen=time.time())

    def remove(self, name: str) -> None:
        with self._lock:
            self._nodes.pop(name, None)

    def all_names(self) -> list[str]:
        """cluster.State.AllNames analog (sorted for determinism)."""
        with self._lock:
            return sorted(self._nodes)

    def hostnames(self) -> list[str]:
        with self._lock:
            return [n.host for _, n in sorted(self._nodes.items())]

    def node_address(self, name: str) -> Optional[str]:
        with self._lock:
            info = self._nodes.get(name)
            return info.host if info else None

    def node_count(self) -> int:
        with self._lock:
            return len(self._nodes)

    def is_alive(self, name: str) -> bool:
        with self._lock:
            info = self._nodes.get(name)
            if info is None:
                return False
            if name == self.local_name:
                return True
            return info.alive

    # -- liveness ------------------------------------------------------------

    def mark(self, name: str, alive: bool) -> None:
        with self._lock:
            info = self._nodes.get(name)
            if info is not None:
                info.alive = alive
                if alive:
                    info.last_seen = time.time()

    def cluster_health_score(self) -> int:
        """state.go:159 semantics: 0 is healthy; the score is the number of
        unreachable nodes."""
        with self._lock:
            return sum(
                1
                for n in self._nodes.values()
                if n.name != self.local_name and not n.alive
            )

    def probe_once(self, timeout: float = 1.0, exclude=None) -> None:
        """Ping every remote node's cluster API health endpoint. `exclude`
        (name -> bool) skips nodes another failure detector owns (gossip)."""
        import http.client

        from weaviate_tpu_torch.cluster.httputil import Http

        http_client = Http(timeout)
        for name in self.all_names():
            if name == self.local_name:
                continue
            if exclude is not None and exclude(name):
                continue
            host = self.node_address(name)
            if host is None:
                continue
            try:
                status, _ = http_client.request(host, "GET", "/cluster/health")
                ok = status == 200
            except (OSError, http.client.HTTPException):
                ok = False
            self.mark(name, ok)

    def start_probing(self, exclude=None) -> None:
        if self._probe_thread is not None:
            return

        def loop():
            while not self._stop.wait(self.probe_interval):
                try:
                    self.probe_once(exclude=exclude)
                except Exception:  # noqa: BLE001 — the probe thread must survive
                    pass

        self._probe_thread = threading.Thread(target=loop, daemon=True, name="cluster-probe")
        self._probe_thread.start()

    def shutdown(self) -> None:
        self._stop.set()
