"""The cluster harness of tests/test_cluster.py, restated on the port's
ClusterNodes (device="cpu"): schema 2PC, distributed CRUD with remote
routing, scatter-gather search, replication with consistency levels, read
repair, node failure, scale-out, /v1/nodes aggregation, gossip discovery and
distributed aggregation. Then a mixed cluster, one port node beside two
JAX-package nodes, held against an all-JAX cluster fed the same operations.

Tolerances: vector answers compare ids equal and distances at rtol 1e-5 (the
f32 rescore of both packages); every value that crosses the wire compares
exactly.
"""

import uuid as uuidlib

import numpy as np
import pytest

from weaviate_tpu_torch.cluster.node import ClusterNode
from weaviate_tpu_torch.entities.filters import LocalFilter
from weaviate_tpu_torch.entities.schema import ClassDef, Property
from weaviate_tpu_torch.entities.storobj import StorObj
from weaviate_tpu_torch.usecases.replica import ReplicationError

DIM = 8


@pytest.fixture(scope="module", autouse=True)
def _sigterm_state_restored():
    """Each package's App chains its device-trace teardown onto SIGTERM.
    Put the handler and both packages' teardown state back after this
    module, so later tests in the same process find them as they were."""
    import signal

    from weaviate_tpu.monitoring import profiling as jax_profiling
    from weaviate_tpu_torch.monitoring import profiling as torch_profiling

    mods, keys = (jax_profiling, torch_profiling), ("signal_installed", "prev_sigterm")
    handler = signal.getsignal(signal.SIGTERM)
    states = [{k: m._teardown_state[k] for k in keys} for m in mods]
    yield
    signal.signal(signal.SIGTERM, handler)
    for m, st in zip(mods, states):
        m._teardown_state.update(st)


def make_cluster(tmp_path, n=3, **kw):
    names = [f"node-{i}" for i in range(n)]
    nodes = [
        ClusterNode(str(tmp_path / name), name, node_names=names, device="cpu", **kw)
        for name in names
    ]
    for node in nodes:
        node.start()
    peers = {n.node_name: n.address for n in nodes}
    for node in nodes:
        node.join({k: v for k, v in peers.items() if k != node.node_name})
    return nodes


def teardown_cluster(nodes):
    for n in nodes:
        try:
            n.shutdown()
        except Exception:
            pass


def make_class(name="Dist", shards=3, replicas=1):
    return ClassDef(
        name=name,
        properties=[
            Property(name="title", data_type=["text"]),
            Property(name="wordCount", data_type=["int"]),
        ],
        vector_index_type="hnsw_tpu",
        vector_index_config={"distance": "l2-squared"},
        sharding_config={"desiredCount": shards},
        replication_config={"factor": replicas},
    )


def new_obj(i, cls="Dist"):
    rng = np.random.default_rng(i)
    return StorObj(
        class_name=cls,
        uuid=str(uuidlib.UUID(int=i + 1)),
        properties={"title": f"obj number {i}", "wordCount": i},
        vector=rng.standard_normal(DIM).astype(np.float32),
    )


@pytest.fixture
def cluster3(tmp_path):
    nodes = make_cluster(tmp_path, 3)
    yield nodes
    teardown_cluster(nodes)


def test_schema_tx_propagates(cluster3):
    n0, n1, n2 = cluster3
    n0.schema.add_class(make_class())
    for n in cluster3:
        assert n.schema.get_class("Dist") is not None
        assert n.db.get_index("Dist") is not None
    # shards are spread: each node holds only its assigned shards
    total_local = sum(len(n.db.get_index("Dist").shards) for n in cluster3)
    assert total_local == 3  # desiredCount=3, rf=1: one shard per node
    # delete propagates too
    n1.schema.delete_class("Dist")
    for n in cluster3:
        assert n.schema.get_class("Dist") is None


def test_schema_tx_add_property(cluster3):
    n0, n1, _ = cluster3
    n0.schema.add_class(make_class())
    n1.schema.add_property("Dist", Property(name="extra", data_type=["text"]))
    for n in cluster3:
        assert n.schema.get_class("Dist").get_property("extra") is not None


def test_distributed_crud_and_search(cluster3):
    n0, n1, n2 = cluster3
    n0.schema.add_class(make_class())
    idx0 = n0.db.get_index("Dist")
    objs = [new_obj(i) for i in range(60)]
    errs = idx0.put_batch(objs)
    assert all(e is None for e in errs)

    # every node sees the full logical index
    for n in cluster3:
        idx = n.db.get_index("Dist")
        assert idx.object_count() == 60

    # read an object whose shard is NOT local to n1
    idx1 = n1.db.get_index("Dist")
    remote_obj = next(
        o for o in objs if idx1._local_shard(idx1.shard_for(o.uuid)) is None
    )
    got = idx1.object_by_uuid(remote_obj.uuid)
    assert got is not None
    assert got.properties["title"] == remote_obj.properties["title"]
    assert got.vector is not None

    # scatter-gather vector search from a different node
    idx2 = n2.db.get_index("Dist")
    res = idx2.object_vector_search(objs[17].vector, k=5)
    assert res[0][0].obj.uuid == objs[17].uuid

    # filtered search across nodes
    flt = LocalFilter.from_dict(
        {"operator": "LessThan", "path": ["wordCount"], "valueInt": 10}
    )
    res = idx2.object_vector_search(objs[3].vector, k=20, flt=flt)
    assert 0 < len(res[0]) <= 10
    assert all(r.obj.properties["wordCount"] < 10 for r in res[0])

    # bm25 across nodes
    hits = idx1.object_search(limit=10, keyword_ranking={"query": "number"})
    assert len(hits) == 10

    # delete via a non-owner node
    assert idx1.delete_object(remote_obj.uuid)
    assert not idx1.exists(remote_obj.uuid)
    assert idx0.object_count() == 59


def test_replicated_write_and_consistency_levels(tmp_path):
    nodes = make_cluster(tmp_path, 3)
    try:
        n0, n1, n2 = nodes
        n0.schema.add_class(make_class(shards=2, replicas=2))
        idx0 = n0.db.get_index("Dist")
        objs = [new_obj(i) for i in range(30)]
        errs = idx0.put_batch(objs)
        assert all(e is None for e in errs)

        # each shard exists on exactly 2 nodes
        state = n0.schema.sharding_state("Dist")
        for shard in state.all_physical_shards():
            owners = state.belongs_to_nodes(shard)
            assert len(owners) == 2
            live = sum(
                1 for n in nodes
                if n.db.get_index("Dist")._local_shard(shard) is not None
            )
            assert live == 2

        # replicated single put + consistent read from every node
        extra = new_obj(1000)
        idx0.put_object(extra, cl="ALL")
        for n in nodes:
            got = n.db.get_index("Dist").object_by_uuid(extra.uuid, cl="QUORUM")
            assert got is not None

        # kill one node: QUORUM (2 of 2... n replicas=2 -> quorum=2) — use ONE
        n2.server.shutdown()
        n0.cluster.mark("node-2", False)
        n1.cluster.mark("node-2", False)
        # writes to shards replicated on node-2: ALL must fail, ONE succeeds
        state = n0.schema.sharding_state("Dist")
        victim = next(
            o for o in [new_obj(i) for i in range(2000, 2100)]
            if "node-2" in state.belongs_to_nodes(idx0.shard_for(o.uuid))
        )
        with pytest.raises(ReplicationError):
            idx0.put_object(victim, cl="ALL")
        idx0.put_object(victim, cl="ONE")
        got = idx0.object_by_uuid(victim.uuid, cl="ONE")
        assert got is not None
    finally:
        teardown_cluster(nodes)


def test_read_repair(tmp_path):
    nodes = make_cluster(tmp_path, 2)
    try:
        n0, n1 = nodes
        n0.schema.add_class(make_class(shards=1, replicas=2))
        idx0 = n0.db.get_index("Dist")
        obj = new_obj(7)
        idx0.put_object(obj, cl="ALL")
        shard_name = idx0.shard_for(obj.uuid)

        # simulate DATA LOSS on one replica (not a deletion): remove the
        # object and clear the tombstone, as if the replica lost a write
        stale_shard = n1.db.get_index("Dist")._local_shard(shard_name)
        assert stale_shard is not None
        stale_shard.delete_object(obj.uuid)
        stale_shard._deleted.clear()
        assert stale_shard.object_by_uuid(obj.uuid) is None

        # a QUORUM read via n1 sees the divergence and repairs the stale copy
        got = n1.db.get_index("Dist").object_by_uuid(obj.uuid, cl="QUORUM")
        assert got is not None
        assert stale_shard.object_by_uuid(obj.uuid) is not None  # repaired
    finally:
        teardown_cluster(nodes)


def test_delete_not_resurrected_by_read_repair(tmp_path):
    """A deletion must win over a stale live copy: the repairer propagates
    the delete instead of resurrecting the object."""
    nodes = make_cluster(tmp_path, 2)
    try:
        n0, n1 = nodes
        n0.schema.add_class(make_class(shards=1, replicas=2))
        idx0 = n0.db.get_index("Dist")
        obj = new_obj(5)
        idx0.put_object(obj, cl="ALL")
        shard_name = idx0.shard_for(obj.uuid)

        # replicated delete ONLY on n0's replica (simulate a missed delete
        # on n1 by deleting directly through n0's local shard with a
        # coordinator-style tombstone)
        s0 = n0.db.get_index("Dist")._local_shard(shard_name)
        s1 = n1.db.get_index("Dist")._local_shard(shard_name)
        s0.delete_object(obj.uuid)
        assert s1.object_by_uuid(obj.uuid) is not None  # n1 is stale

        # QUORUM read: the tombstone outranks the stale live copy
        got = n0.db.get_index("Dist").object_by_uuid(obj.uuid, cl="QUORUM")
        assert got is None
        assert s1.object_by_uuid(obj.uuid) is None  # delete propagated
        assert not n0.db.get_index("Dist").exists(obj.uuid, cl="QUORUM")
    finally:
        teardown_cluster(nodes)


def test_replica_timestamps_converge(tmp_path):
    """Coordinator-stamped times: replicas store identical updateTime, so a
    consistent read triggers no repair ping-pong, and an update preserves
    the original creation time."""
    nodes = make_cluster(tmp_path, 2)
    try:
        n0, n1 = nodes
        n0.schema.add_class(make_class(shards=1, replicas=2))
        idx0 = n0.db.get_index("Dist")
        obj = new_obj(9)
        stored = idx0.put_object(obj, cl="ALL")
        created = stored.creation_time_unix
        shard_name = idx0.shard_for(obj.uuid)
        s0 = n0.db.get_index("Dist")._local_shard(shard_name)
        s1 = n1.db.get_index("Dist")._local_shard(shard_name)
        o0 = s0.object_by_uuid(obj.uuid)
        o1 = s1.object_by_uuid(obj.uuid)
        assert o0.last_update_time_unix == o1.last_update_time_unix
        assert o0.creation_time_unix == o1.creation_time_unix

        # update through the replicated path: times still identical, and the
        # reported creation time is the ORIGINAL one
        obj2 = new_obj(9)
        obj2.properties["title"] = "updated"
        stored2 = idx0.put_object(obj2, cl="ALL")
        assert stored2.creation_time_unix == created
        o0b = s0.object_by_uuid(obj.uuid)
        o1b = s1.object_by_uuid(obj.uuid)
        assert o0b.creation_time_unix == o1b.creation_time_unix == created
        assert o0b.last_update_time_unix == o1b.last_update_time_unix
    finally:
        teardown_cluster(nodes)


def test_scale_out(tmp_path):
    nodes = make_cluster(tmp_path, 2)
    try:
        n0, n1 = nodes
        n0.schema.add_class(make_class(shards=1, replicas=1))
        idx0 = n0.db.get_index("Dist")
        objs = [new_obj(i) for i in range(25)]
        assert all(e is None for e in idx0.put_batch(objs))
        state = n0.schema.sharding_state("Dist")
        shard_name = state.all_physical_shards()[0]
        owners = state.belongs_to_nodes(shard_name)
        assert len(owners) == 1
        source = next(n for n in nodes if n.node_name == owners[0])
        target = next(n for n in nodes if n.node_name != owners[0])
        assert target.db.get_index("Dist")._local_shard(shard_name) is None

        # raise the replication factor: scaler pushes files to the new replica
        source.schema.update_class("Dist", {"replicationConfig": {"factor": 2}})

        new_state = target.schema.sharding_state("Dist")
        assert len(new_state.belongs_to_nodes(shard_name)) == 2
        tshard = target.db.get_index("Dist")._local_shard(shard_name)
        assert tshard is not None
        assert tshard.object_count() == 25
        got = tshard.object_by_uuid(objs[3].uuid)
        assert got is not None and got.properties["wordCount"] == 3
    finally:
        teardown_cluster(nodes)


def test_full_app_rest_cluster(tmp_path):
    """Two full Apps (REST + cluster graph) wired via CLUSTER_* config:
    schema created over REST on node A is queryable over REST on node B,
    with consistency_level accepted on the wire."""
    import json
    import socket
    import urllib.request

    from weaviate_tpu_torch.config import Config
    from weaviate_tpu_torch.server import App, RestServer

    def free_port():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        p = s.getsockname()[1]
        s.close()
        return p

    pa, pb = free_port(), free_port()
    cfgs = []
    for name, port, peer in (("node-a", pa, f"node-b@127.0.0.1:{pb}"),
                             ("node-b", pb, f"node-a@127.0.0.1:{pa}")):
        c = Config()
        c.cluster.hostname = name
        c.cluster.data_bind_port = port
        c.cluster.join = [peer]
        cfgs.append(c)

    apps, servers = [], []
    try:
        for i, c in enumerate(cfgs):
            app = App(config=c, data_path=str(tmp_path / f"app{i}"), device="cpu")
            srv = RestServer(app, port=0)
            srv.start()
            apps.append(app)
            servers.append(srv)

        def req(port, method, path, body=None):
            url = f"http://127.0.0.1:{port}{path}"
            data = json.dumps(body).encode() if body is not None else None
            r = urllib.request.Request(url, data=data, method=method)
            r.add_header("Content-Type", "application/json")
            with urllib.request.urlopen(r, timeout=30) as resp:
                raw = resp.read()
                return resp.status, json.loads(raw) if raw else None

        st, _ = req(servers[0].port, "POST", "/v1/schema", {
            "class": "AppDist",
            "properties": [{"name": "title", "dataType": ["text"]}],
            "vectorIndexType": "hnsw_tpu",
            "vectorIndexConfig": {"distance": "l2-squared"},
            "shardingConfig": {"desiredCount": 2},
        })
        assert st == 200
        # schema propagated to node B
        st, sch = req(servers[1].port, "GET", "/v1/schema")
        assert st == 200
        assert any(c["class"] == "AppDist" for c in sch["classes"])

        # import via node A (objects land on both nodes' shards)
        objs = [{"class": "AppDist", "id": str(uuidlib.UUID(int=i + 1)),
                 "properties": {"title": f"t{i}"},
                 "vector": np.random.default_rng(i).standard_normal(4).tolist()}
                for i in range(10)]
        st, out = req(servers[0].port, "POST", "/v1/batch/objects", {"objects": objs})
        assert st == 200
        assert all(o["result"]["status"] == "SUCCESS" for o in out)

        # read each object via node B with a consistency level
        st, got = req(
            servers[1].port, "GET",
            f"/v1/objects/AppDist/{objs[3]['id']}?consistency_level=ONE",
        )
        assert st == 200 and got["properties"]["title"] == "t3"

        # /v1/nodes aggregates both nodes
        st, nodes = req(servers[0].port, "GET", "/v1/nodes")
        assert st == 200
        assert {n["name"] for n in nodes["nodes"]} == {"node-a", "node-b"}
        total = sum(n["stats"]["objectCount"] for n in nodes["nodes"] if "stats" in n)
        assert total == 10
    finally:
        for s in servers:
            s.stop()
        for a in apps:
            a.shutdown()


def test_nodes_status_aggregation(cluster3):
    n0, _, _ = cluster3
    n0.schema.add_class(make_class())
    idx0 = n0.db.get_index("Dist")
    idx0.put_batch([new_obj(i) for i in range(12)])
    statuses = n0.nodes_status()
    assert len(statuses) == 3
    assert {s["name"] for s in statuses} == {"node-0", "node-1", "node-2"}
    total = sum(s["stats"]["objectCount"] for s in statuses if "stats" in s)
    assert total == 12


def test_late_joiner_syncs_schema(tmp_path):
    """startup_cluster_sync.go: a node joining AFTER classes were created
    adopts the cluster schema at startup instead of waiting for the next
    DDL transaction."""
    names = ["node-0", "node-1", "node-2"]
    early = [ClusterNode(str(tmp_path / n), n, node_names=names, device="cpu") for n in names[:2]]
    try:
        for n in early:
            n.start()
        early[0].join({early[1].node_name: early[1].address})
        early[1].join({early[0].node_name: early[0].address})
        early[0].schema.add_class(make_class(shards=3))
        assert early[1].schema.get_class("Dist") is not None

        # node-2 starts later with an empty disk
        late = ClusterNode(str(tmp_path / "node-2"), "node-2", node_names=names, device="cpu")
        late.start()
        late.join({n.node_name: n.address for n in early})
        for n in early:
            n.cluster.register("node-2", late.address)
        assert late.schema.get_class("Dist") is None
        adopted = late.sync_schema()
        assert adopted == 1
        assert late.schema.get_class("Dist") is not None
        # and it now serves its shard of the ring
        assert late.db.get_index("Dist") is not None
        idx0 = early[0].db.get_index("Dist")
        objs = [new_obj(i) for i in range(30)]
        assert all(e is None for e in idx0.put_batch(objs))
        res = late.db.get_index("Dist").object_vector_search(objs[3].vector, k=1)
        assert res[0][0].obj.uuid == objs[3].uuid
        late.shutdown()
    finally:
        teardown_cluster(early)


def test_gossip_cluster_auto_discovery(tmp_path):
    """Gossip-backed ClusterNodes: each node joins with ONE seed address and
    the full membership (names + dialable cluster-API addresses) propagates;
    the late joiner can then sync schema from discovered peers."""
    import time

    names = ["node-0", "node-1", "node-2"]
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
        deadline = time.time() + 10
        while time.time() < deadline:
            if all(sorted(n.cluster.all_names()) == names for n in nodes):
                break
            time.sleep(0.05)
        assert all(sorted(n.cluster.all_names()) == names for n in nodes)
        # discovered addresses are the real cluster-API endpoints
        assert nodes[2].cluster.node_address("node-0") == nodes[0].advertise
        nodes[0].schema.add_class(make_class(shards=3))
        # new classes shard over the DISCOVERED membership (not just the
        # static construction-time list), and every node derives the SAME
        # ring (the coordinator persists its node assignment in the 2PC
        # payload / shardingConfig)
        st0 = nodes[0].schema.sharding_state("Dist")
        owners = {st0.belongs_to_nodes(s)[0] for s in st0.all_physical_shards()}
        assert owners == set(names)
        st2 = nodes[2].schema.sharding_state("Dist")
        assert all(st2.belongs_to_nodes(s) == st0.belongs_to_nodes(s)
                   for s in st0.all_physical_shards())
        # nodes_status aggregates over gossip-discovered members
        statuses = nodes[1].nodes_status()
        assert {s["name"] for s in statuses} == set(names)
    finally:
        teardown_cluster(nodes)


def test_distributed_aggregation(cluster3):
    """Aggregate over a sharded class reaches REMOTE shards through the
    cluster API :aggregations endpoint (clusterapi indices.go analog) —
    counts/sums/median come from the full logical data set, filtered
    aggregation respects the filter cluster-wide."""
    from weaviate_tpu_torch.usecases.aggregator import AggregateParams, Aggregator

    n0, n1, n2 = cluster3
    n0.schema.add_class(make_class("AggDist"))
    idx0 = n0.db.get_index("AggDist")
    objs = [new_obj(i, "AggDist") for i in range(40)]
    assert all(e is None for e in idx0.put_batch(objs))

    # aggregate from a node that does NOT hold every shard
    idx1 = n1.db.get_index("AggDist")
    local = sum(1 for s, sh in idx1._all_shard_targets() if sh is not None)
    total = len(idx1._all_shard_targets())
    assert local < total  # the test is vacuous unless some shards are remote

    agg = Aggregator(n1.db, n1.schema)
    out = agg.aggregate(AggregateParams(
        class_name="AggDist", include_meta_count=True,
        properties={"wordCount": ["count", "sum", "mean", "median", "minimum", "maximum"]},
    ))
    a = out[0]
    assert a["meta"]["count"] == 40
    wc = a["wordCount"]
    assert wc["count"] == 40
    assert wc["sum"] == sum(range(40))
    assert wc["minimum"] == 0 and wc["maximum"] == 39
    assert wc["median"] == 19.5

    # filtered aggregation, cluster-wide
    flt = LocalFilter.from_dict(
        {"operator": "LessThan", "path": ["wordCount"], "valueInt": 10})
    out = agg.aggregate(AggregateParams(
        class_name="AggDist", filters=flt, include_meta_count=True,
        properties={"wordCount": ["count", "sum"]},
    ))
    assert out[0]["meta"]["count"] == 10
    assert out[0]["wordCount"]["sum"] == sum(range(10))

    # grouped aggregation sees all shards
    out = agg.aggregate(AggregateParams(
        class_name="AggDist", group_by=["title"], include_meta_count=True))
    assert len(out) == 40  # every title unique -> one group per object


def test_ten_node_cluster_scatter_gather(tmp_path):
    """The reference's clusterintegrationtest scale: 10 in-process nodes,
    real cluster-API servers, distributed import + search + aggregate
    (cluster_integration_test.go:61-80)."""
    from weaviate_tpu_torch.usecases.aggregator import AggregateParams, Aggregator

    nodes = make_cluster(tmp_path, 10)
    try:
        n0 = nodes[0]
        n0.schema.add_class(make_class("Ten", shards=10))
        idx0 = n0.db.get_index("Ten")
        objs = [new_obj(i, "Ten") for i in range(120)]
        assert all(e is None for e in idx0.put_batch(objs))

        # schema propagated everywhere; every node serves the whole index
        for n in nodes:
            assert n.schema.get_class("Ten") is not None
        idx7 = nodes[7].db.get_index("Ten")
        assert idx7.object_count() == 120

        # search from three different coordinators hits the same winner
        for ni in (1, 4, 9):
            idx = nodes[ni].db.get_index("Ten")
            res = idx.object_vector_search(objs[42].vector, k=3)
            assert res[0][0].obj.uuid == objs[42].uuid

        # cluster-wide aggregate from the last node
        agg = Aggregator(nodes[9].db, nodes[9].schema)
        out = agg.aggregate(AggregateParams(
            class_name="Ten", include_meta_count=True,
            properties={"wordCount": ["count", "sum"]},
        ))
        assert out[0]["meta"]["count"] == 120
        assert out[0]["wordCount"]["sum"] == sum(range(120))
    finally:
        teardown_cluster(nodes)


def test_distributed_meta_count_fast_path(cluster3):
    """include_meta_count with no properties ships per-shard integers over
    the :aggregations countOnly wire, never objects."""
    from weaviate_tpu_torch.usecases.aggregator import AggregateParams, Aggregator

    n0, n1, _ = cluster3
    n0.schema.add_class(make_class("CntDist"))
    idx0 = n0.db.get_index("CntDist")
    assert all(e is None for e in idx0.put_batch(
        [new_obj(i, "CntDist") for i in range(50)]))
    agg = Aggregator(n1.db, n1.schema)
    out = agg.aggregate(AggregateParams(class_name="CntDist", include_meta_count=True))
    assert out == [{"meta": {"count": 50}}]
    flt = LocalFilter.from_dict(
        {"operator": "GreaterThanEqual", "path": ["wordCount"], "valueInt": 40})
    out = agg.aggregate(AggregateParams(
        class_name="CntDist", include_meta_count=True, filters=flt))
    assert out == [{"meta": {"count": 10}}]


def test_is_consistent_probe(tmp_path):
    """_additional.isConsistent digest-compares replicas (finder.go
    CheckConsistency): consistent after an ALL write, inconsistent when a
    replica holds a stale copy, consistent again after read repair."""
    nodes = make_cluster(tmp_path, 2)
    try:
        n0, n1 = nodes
        n0.schema.add_class(make_class("Cons", shards=1, replicas=2))
        idx0 = n0.db.get_index("Cons")
        obj = new_obj(5, "Cons")
        idx0.put_object(obj, cl="ALL")
        shard = idx0.shard_for(obj.uuid)
        assert idx0.is_consistent(obj.uuid, idx0.object_by_uuid(
            obj.uuid).last_update_time_unix)

        # make node-1's replica stale: bump the copy on node-0 only
        sh0 = n0.db.get_index("Cons")._local_shard(shard)
        sh1 = n1.db.get_index("Cons")._local_shard(shard)
        assert sh0 is not None and sh1 is not None
        newer = sh0.merge_object(obj.uuid, {"title": "edited"},
                                 update_time=obj.last_update_time_unix + 5000)
        assert not idx0.is_consistent(obj.uuid, newer.last_update_time_unix)

        # a QUORUM read repairs the stale replica; probe flips back
        got = idx0.object_by_uuid(obj.uuid, cl="QUORUM")
        assert got.properties["title"] == "edited"
        assert idx0.is_consistent(obj.uuid, got.last_update_time_unix)
    finally:
        teardown_cluster(nodes)


# -- a mixed cluster: one port node beside JAX-package nodes ----------------

PORT_AT = 1  # node-1 is the port's; node-0 (the usual coordinator) is JAX's


def _is_port(node):
    return type(node).__module__.startswith("weaviate_tpu_torch.")


def make_mixed(tmp_path, n=3, port_at=(PORT_AT,)):
    """n nodes with static membership; the nodes at `port_at` are port
    ClusterNodes (device="cpu"), the others the JAX package's."""
    from weaviate_tpu.cluster.node import ClusterNode as JaxClusterNode

    names = [f"node-{i}" for i in range(n)]
    nodes = [
        ClusterNode(str(tmp_path / name), name, node_names=names, device="cpu")
        if i in port_at else JaxClusterNode(str(tmp_path / name), name, node_names=names)
        for i, name in enumerate(names)
    ]
    for node in nodes:
        node.start()
    peers = {n.node_name: n.address for n in nodes}
    for node in nodes:
        node.join({k: v for k, v in peers.items() if k != node.node_name})
    return nodes


def class_dict(name="Dist", shards=3, replicas=1):
    """make_class's schema as a dict, which either package parses."""
    return make_class(name, shards, replicas).to_dict()


def obj_for(node, i, cls="Dist"):
    """new_obj(i) as the StorObj of `node`'s package."""
    if _is_port(node):
        return new_obj(i, cls)
    from weaviate_tpu.entities.storobj import StorObj as JaxStorObj

    o = new_obj(i, cls)
    return JaxStorObj(class_name=o.class_name, uuid=o.uuid,
                      properties=dict(o.properties), vector=o.vector)


def _hits(rows):
    return [(r.obj.uuid, r.obj.properties["wordCount"]) for r in rows], \
        [r.distance for r in rows]


def _same_answers(got, want):
    """ids equal, distances rtol 1e-5 (the f32 rescore of each package)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        (gi, gd), (wi, wd) = _hits(g), _hits(w)
        assert gi == wi
        np.testing.assert_allclose(gd, wd, rtol=1e-5)
        assert all(type(d) is float for d in gd)


def test_mixed_schema_2pc_both_directions(tmp_path):
    nodes = make_mixed(tmp_path)
    try:
        jax0, port1, jax2 = nodes
        # a port coordinator opens and commits on JAX participants
        port1.schema.add_class(class_dict("FromPort"))
        # a JAX coordinator on the port participant
        jax0.schema.add_class(class_dict("FromJax"))
        for n in nodes:
            for c in ("FromPort", "FromJax"):
                assert n.schema.get_class(c) is not None
                assert n.db.get_index(c) is not None
        assert sum(len(n.db.get_index("FromPort").shards) for n in nodes) == 3
        jax2.schema.add_property("FromPort", {"name": "extra", "dataType": ["text"]})
        port1.schema.add_property("FromJax", {"name": "extra", "dataType": ["text"]})
        for n in nodes:
            for c in ("FromPort", "FromJax"):
                assert n.schema.get_class(c).get_property("extra") is not None
        # the port node's ring is the JAX nodes' ring
        want = jax0.schema.sharding_state("FromPort")
        got = port1.schema.sharding_state("FromPort")
        assert {s: got.belongs_to_nodes(s) for s in got.all_physical_shards()} == \
            {s: want.belongs_to_nodes(s) for s in want.all_physical_shards()}
        port1.schema.delete_class("FromJax")
        jax0.schema.delete_class("FromPort")
        for n in nodes:
            assert n.schema.get_class("FromJax") is None
            assert n.schema.get_class("FromPort") is None
    finally:
        teardown_cluster(nodes)


def test_mixed_crud_and_search_equal_an_all_jax_cluster(tmp_path):
    """The same writes through the same coordinators: every read and every
    scatter-gather search of the mixed cluster answers as an all-JAX
    cluster does."""
    clusters = [make_mixed(tmp_path / "mixed"), make_mixed(tmp_path / "jax", port_at=())]
    try:
        answers = []
        for nodes in clusters:
            nodes[0].schema.add_class(class_dict())
            # import through the JAX node and through the port node
            for c, lo, hi in ((0, 0, 40), (1, 40, 80)):
                node = nodes[c]
                errs = node.db.get_index("Dist").put_batch(
                    [obj_for(node, i) for i in range(lo, hi)])
                assert all(e is None for e in errs)
            got = {"count": [n.db.get_index("Dist").object_count() for n in nodes]}
            flt = {"operator": "LessThan", "path": ["wordCount"], "valueInt": 30}
            for c, node in enumerate(nodes):
                idx = node.db.get_index("Dist")
                qs = np.stack([new_obj(i).vector for i in (3, 41, 77)])
                got[f"search{c}"] = idx.object_vector_search(qs, k=6)
                got[f"filtered{c}"] = idx.object_vector_search(
                    qs, k=10, flt=_filter_for(node, flt))
                o = idx.object_by_uuid(new_obj(55).uuid)
                got[f"get{c}"] = (o.properties, o.vector.tolist())
                hits = idx.object_search(limit=10, keyword_ranking={"query": "number 7"})
                got[f"bm25_{c}"] = [(r.obj.uuid, r.score) for r in hits]
            # delete through the port node (a JAX node in the all-JAX cluster)
            assert nodes[1].db.get_index("Dist").delete_object(new_obj(12).uuid)
            got["after_delete"] = [n.db.get_index("Dist").exists(new_obj(12).uuid)
                                   for n in nodes]
            got["count_after"] = nodes[2].db.get_index("Dist").object_count()
            answers.append(got)
        mixed, ref = answers
        assert mixed["count"] == ref["count"] == [80, 80, 80]
        assert mixed["after_delete"] == ref["after_delete"] == [False] * 3
        assert mixed["count_after"] == ref["count_after"] == 79
        for c in range(3):
            _same_answers(mixed[f"search{c}"], ref[f"search{c}"])
            _same_answers(mixed[f"filtered{c}"], ref[f"filtered{c}"])
            assert all(r.obj.properties["wordCount"] < 30
                       for rows in mixed[f"filtered{c}"] for r in rows)
            assert mixed[f"get{c}"] == ref[f"get{c}"]
            assert [u for u, _ in mixed[f"bm25_{c}"]] == [u for u, _ in ref[f"bm25_{c}"]]
            np.testing.assert_allclose([s for _, s in mixed[f"bm25_{c}"]],
                                       [s for _, s in ref[f"bm25_{c}"]], rtol=1e-5)
    finally:
        for nodes in clusters:
            teardown_cluster(nodes)


def _filter_for(node, d):
    if _is_port(node):
        return LocalFilter.from_dict(d)
    from weaviate_tpu.entities.filters import LocalFilter as JaxLocalFilter

    return JaxLocalFilter.from_dict(d)


@pytest.mark.parametrize("coordinator", [0, PORT_AT], ids=["jax_coordinator",
                                                            "port_coordinator"])
def test_mixed_replicated_writes_at_every_consistency_level(tmp_path, coordinator):
    from weaviate_tpu.usecases.replica import ReplicationError as JaxReplicationError

    nodes = make_mixed(tmp_path)
    try:
        coord = nodes[coordinator]
        coord.schema.add_class(class_dict(shards=1, replicas=3))
        idx = coord.db.get_index("Dist")
        for i, cl in enumerate(("ONE", "QUORUM", "ALL")):
            idx.put_object(obj_for(coord, 100 + i), cl=cl)
        errs = idx.put_batch([obj_for(coord, i) for i in range(20)], cl="QUORUM")
        assert all(e is None for e in errs)
        for n in nodes:
            sh = next(iter(n.db.get_index("Dist").shards.values()))
            assert sh.object_count() == 23
            for u in (new_obj(100).uuid, new_obj(102).uuid, new_obj(7).uuid):
                a = n.db.get_index("Dist").object_by_uuid(u, cl="ALL")
                b = nodes[0].db.get_index("Dist").object_by_uuid(u, cl="ALL")
                assert a.properties == b.properties
                assert a.last_update_time_unix == b.last_update_time_unix
                assert a.vector.tolist() == b.vector.tolist()
        # one replica down: QUORUM reads and writes go on, ALL is refused
        down = next(n for i, n in enumerate(nodes) if i != coordinator)
        down.server.shutdown()
        for n in nodes:
            if n is not down:
                n.cluster.mark(down.node_name, False)
        idx.put_object(obj_for(coord, 200), cl="QUORUM")
        assert idx.object_by_uuid(new_obj(200).uuid, cl="QUORUM") is not None
        err = ReplicationError if _is_port(coord) else JaxReplicationError
        with pytest.raises(err):
            idx.put_object(obj_for(coord, 201), cl="ALL")
    finally:
        teardown_cluster(nodes)


@pytest.mark.parametrize("stale_at", [0, PORT_AT], ids=["jax_replica_stale",
                                                         "port_replica_stale"])
def test_mixed_read_repair_across_the_packages(tmp_path, stale_at):
    """One replica loses a write; a QUORUM read through the other package's
    node repairs it. A deletion wins over a stale live copy."""
    nodes = make_mixed(tmp_path, 2)
    try:
        stale_node = nodes[stale_at]
        reader = nodes[1 - stale_at]
        reader.schema.add_class(class_dict(shards=1, replicas=2))
        ridx = reader.db.get_index("Dist")
        obj = obj_for(reader, 7)
        ridx.put_object(obj, cl="ALL")
        shard_name = ridx.shard_for(obj.uuid)
        stale = stale_node.db.get_index("Dist")._local_shard(shard_name)
        stale.delete_object(obj.uuid)
        stale._deleted.clear()
        assert stale.object_by_uuid(obj.uuid) is None
        got = ridx.object_by_uuid(obj.uuid, cl="QUORUM")
        assert got is not None and got.properties["wordCount"] == 7
        repaired = stale.object_by_uuid(obj.uuid)
        assert repaired is not None
        assert repaired.last_update_time_unix == got.last_update_time_unix
        assert repaired.vector.tolist() == got.vector.tolist()
        # a deletion on the reader's replica only: the tombstone wins
        obj2 = obj_for(reader, 9)
        ridx.put_object(obj2, cl="ALL")
        ridx._local_shard(shard_name).delete_object(obj2.uuid)
        assert stale.object_by_uuid(obj2.uuid) is not None
        assert stale_node.db.get_index("Dist").object_by_uuid(obj2.uuid, cl="QUORUM") is None
        assert stale.object_by_uuid(obj2.uuid) is None
    finally:
        teardown_cluster(nodes)


def test_mixed_scale_out_from_a_jax_node_onto_a_port_node(tmp_path):
    """The scaler copies a JAX node's shard files (the LSM segments and the
    vector log) to a port node, which reloads them into its own index; the
    new replica answers as the source does."""
    nodes = make_mixed(tmp_path, 2)
    try:
        jax0, port1 = nodes
        # the ring puts a one-shard class on the first node, the JAX one
        name = "Scale"
        jax0.schema.add_class(class_dict(name, shards=1, replicas=1))
        idx0 = jax0.db.get_index(name)
        assert all(e is None for e in idx0.put_batch(
            [obj_for(jax0, i, name) for i in range(40)]))
        shard_name = jax0.schema.sharding_state(name).all_physical_shards()[0]
        assert jax0.schema.sharding_state(name).belongs_to_nodes(shard_name) == ["node-0"]
        assert port1.db.get_index(name)._local_shard(shard_name) is None
        jax0.schema.update_class(name, {"replicationConfig": {"factor": 2}})
        assert len(port1.schema.sharding_state(name).belongs_to_nodes(shard_name)) == 2
        tshard = port1.db.get_index(name)._local_shard(shard_name)
        sshard = idx0._local_shard(shard_name)
        assert tshard is not None and tshard.object_count() == 40
        qs = np.stack([new_obj(i).vector for i in (2, 17, 33)])
        _same_answers(tshard.object_vector_search(qs, 5), sshard.object_vector_search(qs, 5))
        got = tshard.object_by_uuid(new_obj(3).uuid)
        want = sshard.object_by_uuid(new_obj(3).uuid)
        assert got.properties == want.properties
        assert got.vector.tolist() == want.vector.tolist()
    finally:
        teardown_cluster(nodes)



def test_app_refuses_a_write_at_all_with_a_node_down_as_the_jax_app(tmp_path):
    """Two App nodes of each package, a class at factor 2, node-b stopped
    and marked down: over node-a's REST, a write at ALL is refused with the
    status and the error the JAX App gives. So is a write at ONE: the JAX
    App's object create checks the id's existence at the default QUORUM,
    whatever the request's level, and the port keeps that."""
    import json
    import socket
    import urllib.error
    import urllib.request

    from weaviate_tpu.config import Config as JaxConfig
    from weaviate_tpu.server import App as JaxApp
    from weaviate_tpu.server import RestServer as JaxRestServer
    from weaviate_tpu_torch.config import Config
    from weaviate_tpu_torch.server import App, RestServer

    def free_port():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        p = s.getsockname()[1]
        s.close()
        return p

    def req(port, path, body):
        r = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                   data=json.dumps(body).encode(), method="POST")
        r.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(r, timeout=30) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    answers = []
    for tag, cfg_cls, app_cls, srv_cls, kw in (
            ("jax", JaxConfig, JaxApp, JaxRestServer, {}),
            ("port", Config, App, RestServer, {"device": "cpu"})):
        pa, pb = free_port(), free_port()
        apps, servers = [], []
        try:
            for name, port, peer in (("node-a", pa, f"node-b@127.0.0.1:{pb}"),
                                     ("node-b", pb, f"node-a@127.0.0.1:{pa}")):
                c = cfg_cls()
                c.cluster.hostname, c.cluster.data_bind_port = name, port
                c.cluster.join = [peer]
                apps.append(app_cls(config=c, data_path=str(tmp_path / tag / name), **kw))
                servers.append(srv_cls(apps[-1], port=0))
                servers[-1].start()
            st, _ = req(servers[0].port, "/v1/schema", {
                "class": "Repl", "properties": [{"name": "n", "dataType": ["int"]}],
                "vectorIndexConfig": {"distance": "l2-squared"},
                "replicationConfig": {"factor": 2}})
            assert st == 200
            servers[1].stop()
            apps[1].shutdown()
            apps[0].cluster_node.cluster.mark("node-b", False)

            def write(i, cl):
                st, body = req(servers[0].port, f"/v1/objects?consistency_level={cl}", {
                    "class": "Repl", "id": str(uuidlib.UUID(int=i + 1)),
                    "properties": {"n": i}, "vector": [float(i), 1.0, 0.0, 0.0]})
                return st, (body.get("error") or [{}])[0].get("message", "")

            answers.append((write(1, "ALL"), write(2, "ONE")))
        finally:
            servers[0].stop()
            apps[0].shutdown()
    assert answers[1] == answers[0]
    assert answers[0][0][0] == 500 and answers[0][0][1].startswith("ReplicationError")


def test_cluster_nodes_need_a_card_or_an_explicit_cpu(tmp_path, monkeypatch):
    """A ClusterNode, and an App with a cluster config, resolve their
    device first: without a card they raise unless given device="cpu",
    before a listener binds; with it, the node's shards sit on the CPU."""
    import torch

    from weaviate_tpu_torch.config import load_config
    from weaviate_tpu_torch.server import App

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ClusterNode(str(tmp_path / "a"), "node-0")
    with pytest.raises(RuntimeError, match="CUDA"):
        App(config=load_config({"CLUSTER_HOSTNAME": "node-0", "CLUSTER_DATA_BIND_PORT": "0"}),
            data_path=str(tmp_path / "b"))
    node = ClusterNode(str(tmp_path / "c"), "node-0", device="cpu")
    try:
        node.start()
        node.schema.add_class(make_class(shards=1))
        shard = next(iter(node.db.get_index("Dist").shards.values()))
        assert node.device.type == "cpu" and shard.vector_index.device.type == "cpu"
    finally:
        node.shutdown()


def test_wire_values_are_python_numbers_and_the_formats_are_shared():
    """What crosses the wire is JSON of Python numbers, whatever the
    distance's type (a torch or numpy f32 scalar off the card), and each
    package reads the other's payloads exactly."""
    import json

    import torch

    from weaviate_tpu.cluster import payloads as jax_wire
    from weaviate_tpu.db.shard import SearchResult as JaxSearchResult
    from weaviate_tpu_torch.cluster import payloads as wire
    from weaviate_tpu_torch.db.shard import SearchResult

    obj = new_obj(3)
    d32 = np.float32(0.1234567)
    for dist in (d32, torch.tensor(d32), float(d32)):
        out = wire.result_to_wire(SearchResult(obj=obj, distance=dist, certainty=np.float32(0.5),
                                               score=None, shard="shard-0"))
        assert type(out["distance"]) is float and out["distance"] == float(d32)
        assert type(out["certainty"]) is float and out["score"] is None
        back = jax_wire.result_from_wire(json.loads(json.dumps(out)))
        assert back.distance == float(d32) and back.obj.uuid == obj.uuid
        assert back.obj.vector.tolist() == obj.vector.tolist()
    jax_obj = jax_wire.obj_from_wire(wire.obj_to_wire(obj))
    assert wire.obj_to_wire(wire.obj_from_wire(jax_wire.obj_to_wire(jax_obj))) == \
        wire.obj_to_wire(obj)
    vecs = np.random.default_rng(1).standard_normal((5, 8)).astype(np.float32)
    assert jax_wire.vectors_to_wire(vecs) == wire.vectors_to_wire(vecs)
    assert np.array_equal(jax_wire.vectors_from_wire(wire.vectors_to_wire(vecs)), vecs)
    flt = {"operator": "LessThan", "path": ["wordCount"], "valueInt": 10}
    assert jax_wire.filter_to_wire(jax_wire.filter_from_wire(
        wire.filter_to_wire(wire.filter_from_wire(flt)))) == wire.filter_to_wire(
        wire.filter_from_wire(flt))
    assert type(jax_wire.result_to_wire(JaxSearchResult(obj=jax_obj, distance=0.5))["distance"]) \
        is float
