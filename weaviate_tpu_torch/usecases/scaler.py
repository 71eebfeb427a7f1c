# The port's copy of weaviate_tpu/usecases/scaler.py, its imports pointed at the port.
"""Elastic scale-out: replication-factor increase copies shard data to the
newly-assigned replica nodes.

Reference: usecases/scaler/scaler.go + rsync.go — on a replicationConfig
factor change, compute the new shard distribution and sync each shard's
files to the nodes that just became replicas, then activate them. Here every
node runs the same schema transaction, and each node pushes the shards for
which it is the PRIMARY (first node in the old replica set) — so exactly one
source per shard, no coordinator needed. The file push goes over the cluster
API (upload + :reload), the analog of rsync over clusterapi.
"""

from __future__ import annotations

import os


class Scaler:
    def __init__(self, node_name: str, cluster_state, node_client, db):
        self.node_name = node_name
        self.cluster = cluster_state
        self.nodes = node_client
        self.db = db

    def scale(self, class_name: str, old_state, new_state) -> None:
        idx = self.db.get_index(class_name)
        if idx is None:
            return
        for shard_name in new_state.all_physical_shards():
            try:
                old_nodes = old_state.belongs_to_nodes(shard_name)
            except KeyError:
                old_nodes = []
            new_nodes = new_state.belongs_to_nodes(shard_name)
            added = [n for n in new_nodes if n not in old_nodes]
            if not added or not old_nodes or old_nodes[0] != self.node_name:
                continue  # only the shard's primary pushes
            shard = idx.shards.get(shard_name)
            if shard is None:
                continue
            # snapshot the shard files to local scratch UNDER the write
            # pause (bounded by local disk speed), then stream to the new
            # replicas with writes already flowing again — a slow peer must
            # not stall the shard for the whole transfer
            import shutil
            import tempfile

            scratch = tempfile.mkdtemp(prefix=f"scale-{shard_name}-")
            try:
                rels = []
                with shard.paused_writes():
                    base = shard.path
                    for root, _, files in os.walk(base):
                        for fn in files:
                            if fn.endswith(".tmp"):
                                continue
                            rel = os.path.relpath(os.path.join(root, fn), base)
                            rels.append(rel)
                            dst = os.path.join(scratch, rel)
                            os.makedirs(os.path.dirname(dst), exist_ok=True)
                            shutil.copy2(os.path.join(base, rel), dst)
                for target in added:
                    host = self.cluster.node_address(target)
                    if host is None:
                        continue
                    self.nodes.create_shard(host, class_name, shard_name)
                    for rel in rels:
                        with open(os.path.join(scratch, rel), "rb") as f:
                            self.nodes.upload_file(host, class_name, shard_name, rel, f.read())
                    self.nodes.reload_shard(host, class_name, shard_name)
            finally:
                shutil.rmtree(scratch, ignore_errors=True)
