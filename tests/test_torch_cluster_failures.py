"""Failure and backup journeys of the cluster, restated on the port's
nodes (device="cpu"): gossip seed join and partition detection
(tests/test_failure_detection.py), the backup / node-loss / restore /
QUORUM journey (tests/test_failure_journeys.py) and the multi-node backup
and restore (tests/test_backup.py).
"""

import shutil
import time

from weaviate_tpu_torch.cluster.node import ClusterNode
from weaviate_tpu_torch.modules import Provider
from weaviate_tpu_torch.modules.backup_fs import FilesystemBackupBackend
from weaviate_tpu_torch.usecases.backup import BackupScheduler

from tests.test_torch_cluster import make_class, new_obj, teardown_cluster


def _wait_until(pred, timeout=10.0, step=0.05):
    import time

    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(step)
    return False


def test_gossip_seed_join_propagates_cluster_wide():
    """memberlist-style auto-discovery (state.go:38): a node that joins with
    ONE seed address becomes visible to every member, and learns every
    member itself, via epidemic table exchange."""
    from weaviate_tpu_torch.cluster.gossip import GossipTransport
    from weaviate_tpu_torch.cluster.membership import ClusterState

    nodes = []
    try:
        for i in range(3):
            st = ClusterState(local_name=f"g{i}")
            g = GossipTransport(st, f"g{i}", f"127.0.0.1:9{i}00",
                                interval=0.1, suspect_after=1.0, dead_after=3.0)
            g.start()
            nodes.append((st, g))
        seed = nodes[0][1].gossip_addr
        # every newcomer knows ONLY the seed
        for _, g in nodes[1:]:
            g.join([seed])
        assert _wait_until(lambda: all(
            sorted(st.all_names()) == ["g0", "g1", "g2"] for st, _ in nodes)), \
            [st.all_names() for st, _ in nodes]
        # piggybacked metadata: every node resolves every data address
        for st, _ in nodes:
            assert st.node_address("g2") == "127.0.0.1:9200"
        assert all(st.cluster_health_score() == 0 for st, _ in nodes)
    finally:
        for st, g in nodes:
            g.shutdown()
            st.shutdown()


def test_gossip_partition_detection_and_recovery():
    """A partitioned node goes suspect -> not alive on the survivors (reads
    fail over), and its advancing heartbeat revives it when it returns."""
    from weaviate_tpu_torch.cluster.gossip import GossipTransport
    from weaviate_tpu_torch.cluster.membership import ClusterState

    nodes = []
    try:
        for i in range(3):
            st = ClusterState(local_name=f"p{i}")
            g = GossipTransport(st, f"p{i}", f"127.0.0.1:91{i}0",
                                interval=0.1, suspect_after=0.6, dead_after=30.0)
            g.start()
            nodes.append((st, g))
        for _, g in nodes[1:]:
            g.join([nodes[0][1].gossip_addr])
        assert _wait_until(lambda: all(
            len(st.all_names()) == 3 for st, _ in nodes))
        # partition p2: stop its gossip entirely (no heartbeats leave it)
        nodes[2][1].shutdown()
        assert _wait_until(
            lambda: not nodes[0][0].is_alive("p2")
            and not nodes[1][0].is_alive("p2")), "p2 never went suspect"
        assert nodes[0][0].cluster_health_score() == 1
        assert nodes[0][1].status("p2") in ("suspect", "dead")
        # p0/p1 keep trusting each other across the partition
        assert nodes[0][0].is_alive("p1") and nodes[1][0].is_alive("p0")

        # p2 returns with a fresh transport on the SAME identity: its table
        # restarts at hb=0, but its first merge learns the cluster's higher
        # hb for itself... the new instance gossips its own entry, and the
        # survivors revive it once its heartbeat advances past what they saw
        st2 = nodes[2][0]
        g2 = GossipTransport(st2, "p2", "127.0.0.1:9120",
                             interval=0.1, suspect_after=0.6, dead_after=30.0)
        g2.start()
        g2.join([nodes[0][1].gossip_addr])
        nodes[2] = (st2, g2)
        assert _wait_until(lambda: nodes[0][0].is_alive("p2")
                           and nodes[1][0].is_alive("p2")), "p2 never revived"
    finally:
        for st, g in nodes:
            g.shutdown()
            st.shutdown()


def _wait_long(pred):
    """tests/test_failure_journeys.py's wait: 15 s."""
    return _wait_until(pred, timeout=15.0)


def _attach_backup(node, shared_root):
    p = Provider()
    p.register(FilesystemBackupBackend(shared_root))
    sched = BackupScheduler(
        node.db, node.schema, p, node_name=node.node_name,
        cluster=node.cluster, node_client=node.transfer_client,
    )
    node.api.backup = sched
    return sched


def test_backup_node_loss_restore_quorum_journey(tmp_path):
    """import -> backup -> kill node-2 AND wipe its disk (gossip marks it
    dead) -> node-2 returns empty and is revived -> cluster-wide restore
    from the backup -> diverge one replica -> QUORUM read repairs it."""
    names = ["node-0", "node-1", "node-2"]
    shared_root = str(tmp_path / "shared-backups")
    nodes = [
        ClusterNode(str(tmp_path / n), n, node_names=names, device="cpu",
                    enable_gossip=True, gossip_interval=0.1)
        for n in names
    ]
    try:
        for n in nodes:
            n.start()
        seed = nodes[0].gossip.gossip_addr
        for n in nodes[1:]:
            n.join_gossip([seed])
        assert _wait_long(lambda: all(
            sorted(n.cluster.all_names()) == names for n in nodes))
        for n in nodes:
            _attach_backup(n, shared_root)

        # 1. import: rf=3 so every shard lives on all three nodes and
        # QUORUM (2/3) survives one node loss
        nodes[0].schema.add_class(make_class(shards=2, replicas=3))
        idx0 = nodes[0].db.get_index("Dist")
        objs = [new_obj(i) for i in range(40)]
        assert all(e is None for e in idx0.put_batch(objs))

        # 2. backup while everyone is alive
        sched0 = nodes[0].api.backup
        sched0.backup("filesystem", {"id": "journey1"})
        assert sched0.wait("journey1")["status"] == "SUCCESS"

        # 3. disaster: node-2 dies and its data directory is lost
        nodes[2].shutdown()
        shutil.rmtree(str(tmp_path / "node-2"))
        assert _wait_long(
            lambda: not nodes[0].cluster.is_alive("node-2")
            and not nodes[1].cluster.is_alive("node-2")), \
            "gossip never marked the dead node"

        # survivors still answer QUORUM reads (2 of 3 replicas)
        got = nodes[0].db.get_index("Dist").object_by_uuid(
            objs[7].uuid, cl="QUORUM")
        assert got is not None and got.properties["wordCount"] == 7

        # 4. node-2 returns on the same identity with an EMPTY disk,
        # rejoins via gossip, and syncs the schema from the cluster
        n2 = ClusterNode(str(tmp_path / "node-2"), "node-2", node_names=names, device="cpu",
                         enable_gossip=True, gossip_interval=0.1)
        n2.start()
        n2.join_gossip([seed])
        nodes[2] = n2
        assert _wait_long(lambda: nodes[0].cluster.is_alive("node-2")
                           and nodes[1].cluster.is_alive("node-2")), \
            "returned node never revived"
        _attach_backup(n2, shared_root)
        # the returned node's disk is empty: adopt the cluster schema
        # (startup_cluster_sync.go semantics)
        if n2.schema.get_class("Dist") is None:
            n2.sync_schema()
        assert n2.schema.get_class("Dist") is not None, \
            "returned node never adopted the cluster schema"

        # 5. cluster-wide restore from the backup: drop the class, then
        # restore brings every node's shards back (incl. the wiped node)
        nodes[0].schema.delete_class("Dist")
        for n in nodes:
            assert n.db.get_index("Dist") is None
        sched0.restore("filesystem", "journey1", {})
        assert sched0.wait("journey1", restore=True)["status"] == "SUCCESS"
        for n in nodes:
            idx = n.db.get_index("Dist")
            assert idx is not None
            local = sum(s.object_count() for s in idx.shards.values())
            assert local == 40  # rf=3: every node holds every object

        # 6. replicated read at QUORUM with repair: one replica silently
        # loses an object (data loss, not deletion), a QUORUM read detects
        # the divergence and backfills it
        obj = objs[11]
        shard_name = nodes[0].db.get_index("Dist").shard_for(obj.uuid)
        stale = nodes[1].db.get_index("Dist")._local_shard(shard_name)
        assert stale is not None
        stale.delete_object(obj.uuid)
        stale._deleted.clear()
        assert stale.object_by_uuid(obj.uuid) is None
        got = nodes[1].db.get_index("Dist").object_by_uuid(obj.uuid, cl="QUORUM")
        assert got is not None and got.properties["wordCount"] == 11
        assert stale.object_by_uuid(obj.uuid) is not None  # repaired

        # and the restored data actually serves vector search, cluster-wide
        res = nodes[2].db.get_index("Dist").object_vector_search(
            objs[5].vector, k=3)
        assert res[0][0].obj.uuid == objs[5].uuid
    finally:
        teardown_cluster(nodes)


def test_multinode_backup_restore(tmp_path):
    """Distributed journey: 2 nodes, shards on both; the coordinator backs
    up every node's shards; restore brings data back on both nodes."""
    from tests.test_torch_cluster import make_class, make_cluster, new_obj, teardown_cluster

    nodes = make_cluster(tmp_path, 2)
    try:
        shared_root = str(tmp_path / "shared-backups")
        for n in nodes:
            p = Provider()
            p.register(FilesystemBackupBackend(shared_root))
            sched = BackupScheduler(
                n.db, n.schema, p, node_name=n.node_name,
                cluster=n.cluster, node_client=n.transfer_client,
            )
            n.api.backup = sched

        n0, n1 = nodes
        n0.schema.add_class(make_class(shards=2, replicas=1))
        idx0 = n0.db.get_index("Dist")
        objs = [new_obj(i) for i in range(30)]
        assert all(e is None for e in idx0.put_batch(objs))
        per_node_before = [
            sum(s.object_count() for s in n.db.get_index("Dist").shards.values())
            for n in nodes
        ]
        assert sum(per_node_before) == 30 and all(c > 0 for c in per_node_before)

        sched0 = n0.api.backup
        sched0.backup("filesystem", {"id": "dist1"})
        assert sched0.wait("dist1")["status"] == "SUCCESS"

        n0.schema.delete_class("Dist")
        for n in nodes:
            assert n.db.get_index("Dist") is None

        sched0.restore("filesystem", "dist1", {})
        assert sched0.wait("dist1", restore=True)["status"] == "SUCCESS"

        for n, want in zip(nodes, per_node_before):
            idx = n.db.get_index("Dist")
            assert idx is not None
            got = sum(s.object_count() for s in idx.shards.values())
            assert got == want
        res = n1.db.get_index("Dist").object_vector_search(objs[5].vector, k=3)
        assert res[0][0].obj.uuid == objs[5].uuid
    finally:
        teardown_cluster(nodes)

