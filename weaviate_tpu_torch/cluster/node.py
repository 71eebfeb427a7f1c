# The port's copy of weaviate_tpu/cluster/node.py, its imports pointed at the port.
"""ClusterNode: one node's full distributed object graph.

The cluster-side slice of configure_api.go:105 — wires membership, the
inbound cluster API listener, outbound clients, schema 2PC, replication
coordinator, and the scaler around a DB + SchemaManager. Used by the server
entry point and by the in-process multi-node test harness (the analog of
adapters/repos/db/clusterintegrationtest/cluster_integration_test.go:61-80:
real DBs + real cluster API servers on random ports).

The port's ClusterNode differs from the JAX package's in one keyword:
`device`, resolved here (so a node asked for the card raises at once when
torch sees none) and handed to its DB, so every shard the node holds, its
own and those the scaler or a backup restore brings, keeps its index on
that device. None (the default) is the CUDA card; pass device="cpu" to run
on the CPU. The wire formats are the JAX package's, so port nodes and JAX
nodes can form one cluster.
"""

from __future__ import annotations

import os
from typing import Optional

from weaviate_tpu_torch.cluster.clusterapi import ClusterApi, ClusterApiServer
from weaviate_tpu_torch.cluster.membership import ClusterState
from weaviate_tpu_torch.cluster.remote_client import (
    NodeClient,
    RemoteIndex,
    ReplicationClient,
)
from weaviate_tpu_torch.cluster.tx import TxManager, TxParticipant
from weaviate_tpu_torch.db import DB
from weaviate_tpu_torch.device import resolve_device
from weaviate_tpu_torch.schema import SchemaManager
from weaviate_tpu_torch.usecases.replica import Finder, ReplicaCoordinator, Replicator
from weaviate_tpu_torch.usecases.scaler import Scaler


class ClusterNode:
    def __init__(
        self,
        data_path: str,
        node_name: str,
        node_names: Optional[list[str]] = None,
        bind_host: str = "127.0.0.1",
        bind_port: int = 0,
        advertise_host: Optional[str] = None,
        metrics=None,
        default_vectorizer: str = "none",
        tolerate_node_failures: bool = False,
        store_opts=None,
        enable_gossip: bool = False,
        gossip_bind_host: str = "127.0.0.1",
        gossip_bind_port: int = 0,
        gossip_interval: float = 1.0,
        device=None,
    ):
        # the card unless the caller names the CPU; no card => raise now
        self.device = resolve_device(device)
        os.makedirs(data_path, exist_ok=True)
        self.node_name = node_name
        self._gossip_opts = (enable_gossip, gossip_bind_host,
                             gossip_bind_port, gossip_interval)
        self.gossip = None
        self.node_names = node_names or [node_name]
        self.cluster = ClusterState(local_name=node_name)
        self.remote_index = RemoteIndex(self._resolve_shard)
        self.db = DB(
            data_path,
            node_name=node_name,
            remote_client=self.remote_index,
            metrics=metrics,
            node_names=self.node_names,
            store_opts=store_opts,
            device=self.device,
        )
        self.tx_manager = TxManager(
            self.cluster, tolerate_node_failures=tolerate_node_failures
        )
        self.schema = SchemaManager(
            os.path.join(data_path, "schema.json"),
            migrator=self.db,
            node_names=self.node_names,
            tx=self.tx_manager,
            default_vectorizer=default_vectorizer,
            # gossip clusters shard new classes over LIVE membership (the
            # static node_names list only knows construction-time peers);
            # suspect/dead members are excluded — a class must not be rung
            # onto a node the coordinator already knows is down
            node_source=(lambda: [
                n for n in self.cluster.all_names()
                if self.cluster.is_alive(n)
            ]) if enable_gossip else None,
        )
        self.tx_participant = TxParticipant(self.schema)
        self.api = ClusterApi(
            self.db, self.schema, self.tx_participant, self.cluster, node_name
        )
        self.server = ClusterApiServer(self.api, host=bind_host, port=bind_port)
        # the address peers should dial: binding 0.0.0.0 means "all
        # interfaces" and is not dialable, so advertise a concrete host
        if advertise_host:
            self.advertise = f"{advertise_host}:{self.server.port}"
        elif bind_host == "0.0.0.0":
            import socket as _socket

            try:
                host = _socket.gethostbyname(_socket.gethostname())
            except OSError:
                host = "127.0.0.1"
            self.advertise = f"{host}:{self.server.port}"
        else:
            self.advertise = self.server.address
        self.node_client = NodeClient()  # lightweight RPCs (status, schema)
        # shard-file transfer (scaler, backup) moves whole shards in one
        # call: a transfer-sized timeout, kept OFF the status path so an
        # unreachable peer can't stall /v1/nodes for minutes
        self.transfer_client = NodeClient(timeout=600.0)
        self.replica_coord = ReplicaCoordinator(
            node_name,
            self.cluster,
            self.api,
            ReplicationClient(),
            self.schema.sharding_state,
        )
        self.db.set_replication(
            Replicator(self.replica_coord), Finder(self.replica_coord)
        )
        self.schema.scaler = Scaler(node_name, self.cluster, self.transfer_client, self.db)

    # -- addressing ----------------------------------------------------------

    def _resolve_shard(self, class_name: str, shard_name: str) -> Optional[str]:
        """Pick an alive replica node for a non-local shard (the node lookup
        of usecases/sharding/remote_index.go)."""
        state = self.schema.sharding_state(class_name)
        if state is None:
            return None
        for node in state.belongs_to_nodes(shard_name):
            if node == self.node_name:
                continue
            if self.cluster.is_alive(node):
                addr = self.cluster.node_address(node)
                if addr is not None:
                    return addr
        return None

    @property
    def address(self) -> str:
        return self.server.address

    def start(self) -> None:
        self.server.start()
        self.cluster.register(self.node_name, self.advertise)
        enable, ghost, gport, ginterval = self._gossip_opts
        if enable:
            # gossip owns failure detection for its members: membership,
            # metadata, and liveness ride the UDP heartbeat table
            from weaviate_tpu_torch.cluster.gossip import GossipTransport

            self.gossip = GossipTransport(
                self.cluster, self.node_name, self.advertise,
                bind_host=ghost, bind_port=gport, interval=ginterval,
                suspect_after=4 * ginterval, dead_after=12 * ginterval)
            self.gossip.start()
        # the probe loop still covers STATICALLY registered peers (mixed
        # "name@host" + seed deployments) — gossip-managed names are skipped
        # so the two detectors never fight over the same node
        self.cluster.start_probing(
            exclude=lambda name: self.gossip is not None
            and self.gossip.status(name) is not None)

    def join(self, peers: dict[str, str]) -> None:
        """Register peer nodes (CLUSTER_JOIN analog): {name: host:port}."""
        for name, host in peers.items():
            self.cluster.register(name, host)

    def join_gossip(self, seeds: list[str]) -> None:
        """Seed-address join (memberlist Join analog): 'host:port' gossip
        addresses; one reachable seed makes this node visible cluster-wide."""
        if self.gossip is not None:
            self.gossip.join(seeds)

    def sync_schema(self) -> int:
        """Startup cluster schema sync (startup_cluster_sync.go /
        read_consensus.go): adopt classes the cluster already has that this
        node is missing — a node (re)joining with an empty or stale disk
        must serve the cluster's schema without waiting for the next DDL
        transaction. Local classes are never overwritten (divergence is the
        operator's call, CLUSTER_IGNORE_SCHEMA_SYNC semantics).
        -> number of classes adopted."""
        from weaviate_tpu_torch.entities.schema import ClassDef

        adopted = 0
        for name in self.cluster.all_names():
            if name == self.node_name:
                continue
            host = self.cluster.node_address(name)
            if host is None:
                continue
            try:
                remote = self.node_client.schema(host)
            except Exception:  # noqa: BLE001 — peer down: try the next one
                continue
            classes = remote.get("classes", [])
            if not classes:
                # a reachable peer with an EMPTY schema is not consensus —
                # it may be another fresh joiner; keep looking for a peer
                # that actually holds classes (read_consensus.go compares
                # payloads instead of trusting the first response)
                continue
            for cd_dict in classes:
                cname = cd_dict.get("class")
                if cname and self.schema.get_class(cname) is None:
                    self.schema.apply_add_class(ClassDef.from_dict(cd_dict))
                    adopted += 1
            break  # first peer with a non-empty schema is the source
        return adopted

    # -- /v1/nodes cluster aggregation (usecases/nodes/handler.go) -----------

    def nodes_status(self) -> list[dict]:
        out = [self.api.node_status()]
        for name in self.cluster.all_names():
            if name == self.node_name:
                continue
            host = self.cluster.node_address(name)
            try:
                out.append(self.node_client.node_status(host))
            except Exception:  # noqa: BLE001 — report unreachable nodes
                out.append({"name": name, "status": "UNAVAILABLE", "shards": []})
        return sorted(out, key=lambda n: n.get("name", ""))

    def shutdown(self) -> None:
        self.server.shutdown()
        if self.gossip is not None:
            self.gossip.shutdown()
        self.cluster.shutdown()
        self.replica_coord.shutdown()
        self.db.shutdown()
