# The port's copy of weaviate_tpu/usecases/replica.py, its imports pointed at the port.
"""Leaderless per-op replication: write 2PC + consistency-level reads +
read repair.

Reference: usecases/replica/ — `Replicator` (writes, replicator.go:89) and
`Finder` (reads, finder.go) share a generic coordinator (coordinator.go:66
broadcast, :149 Push, :167 Pull): phase 1 "prepare" to every replica of the
shard, phase 2 commit, with success judged against a consistency level
ONE / QUORUM / ALL (resolver.go:24-26); stale replicas found by digest
comparison are repaired by pushing the newest version (repairer.go).

Participants are addressed uniformly: the local node through its in-process
ClusterApi facade, remote nodes through ReplicationClient — same
prepare/commit/abort/digest/overwrite verbs either way.
"""

from __future__ import annotations

import uuid as uuidlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

from weaviate_tpu_torch.cluster import payloads as wire
from weaviate_tpu_torch.entities.storobj import StorObj

ONE = "ONE"
QUORUM = "QUORUM"
ALL = "ALL"
DEFAULT_CONSISTENCY = QUORUM  # adapters/repos/db/index.go:1442


def required_acks(level: Optional[str], n_replicas: int) -> int:
    """resolver.go:24-26 semantics."""
    level = (level or DEFAULT_CONSISTENCY).upper()
    if level == ONE:
        return 1
    if level == ALL:
        return n_replicas
    if level == QUORUM:
        return n_replicas // 2 + 1
    raise ValueError(f"unknown consistency level {level!r}")


class ReplicationError(RuntimeError):
    pass


class _Participant:
    """One replica target: local (direct ClusterApi calls) or remote."""

    def __init__(self, node: str, local_api=None, client=None, host: Optional[str] = None):
        self.node = node
        self.local = local_api
        self.client = client
        self.host = host

    def prepare(self, class_name, shard, req_id, ops):
        if self.local is not None:
            self.local.replica_prepare(req_id, class_name, shard, ops)
        else:
            self.client.prepare(self.host, class_name, shard, req_id, ops)

    def commit(self, class_name, shard, req_id):
        if self.local is not None:
            return self.local.replica_commit(req_id)
        return self.client.commit(self.host, class_name, shard, req_id)

    def abort(self, class_name, shard, req_id):
        if self.local is not None:
            self.local.replica_abort(req_id)
        else:
            self.client.abort(self.host, class_name, shard, req_id)

    def digest(self, class_name, shard, uuid):
        if self.local is not None:
            return self.local.digest(class_name, shard, uuid)
        return self.client.digest(self.host, class_name, shard, uuid)

    def digest_many(self, class_name, shard, uuids):
        if self.local is not None:
            return self.local.digest_many(class_name, shard, list(uuids))
        return self.client.digest_many(self.host, class_name, shard, uuids)

    def fetch(self, class_name, shard, uuid) -> Optional[StorObj]:
        if self.local is not None:
            s = self.local._shard(class_name, shard)
            return s.object_by_uuid(uuid, True) if s is not None else None
        return self.client.fetch_object(self.host, class_name, shard, uuid)

    def overwrite(self, class_name, shard, objs, deletes=None):
        if self.local is not None:
            s = self.local._shard(class_name, shard)
            if s is not None:
                for o in objs:
                    s.put_object(o, preserve_times=True)
                for d in deletes or []:
                    s.delete_object(d["uuid"], deletion_time=d.get("time"))
        else:
            self.client.overwrite(self.host, class_name, shard, objs, deletes)


class ReplicaCoordinator:
    """Shared plumbing: resolve a shard's replica set into participants."""

    def __init__(self, node_name: str, cluster_state, local_api, repl_client,
                 sharding_resolver, pool_size: int = 8):
        """sharding_resolver(class_name) -> ShardingState."""
        self.node_name = node_name
        self.cluster = cluster_state
        self.local_api = local_api
        self.client = repl_client
        self.sharding = sharding_resolver
        self._pool = ThreadPoolExecutor(max_workers=pool_size, thread_name_prefix="replica")

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)

    def participants(self, class_name: str, shard: str) -> list[_Participant]:
        state = self.sharding(class_name)
        nodes = state.belongs_to_nodes(shard) if state else [self.node_name]
        out = []
        for n in nodes:
            if n == self.node_name:
                out.append(_Participant(n, local_api=self.local_api))
            else:
                out.append(
                    _Participant(n, client=self.client, host=self.cluster.node_address(n))
                )
        return out

    def map_parallel(self, fn, items):
        if len(items) == 1:
            try:
                return [(items[0], fn(items[0]), None)]
            except Exception as e:  # noqa: BLE001 — per-replica fault isolation
                return [(items[0], None, e)]
        futs = {self._pool.submit(fn, it): it for it in items}
        out = []
        for f, it in futs.items():
            try:
                out.append((it, f.result(), None))
            except Exception as e:  # noqa: BLE001
                out.append((it, None, e))
        return out


class Replicator:
    """Write path (replicator.go): 2PC per op batch with consistency level."""

    def __init__(self, coord: ReplicaCoordinator):
        self.coord = coord

    def _run(self, class_name: str, shard: str, ops: list[dict],
             level: Optional[str]) -> list:
        parts = self.coord.participants(class_name, shard)
        need = required_acks(level, len(parts))
        req_id = str(uuidlib.uuid4())

        prepared = self.coord.map_parallel(
            lambda p: p.prepare(class_name, shard, req_id, ops), parts
        )
        ok_parts = [p for p, _, err in prepared if err is None]
        if len(ok_parts) < need:
            for p in ok_parts:
                p.abort(class_name, shard, req_id)
            errs = "; ".join(str(e) for _, _, e in prepared if e is not None)
            raise ReplicationError(
                f"prepare: {len(ok_parts)}/{len(parts)} replicas ok, "
                f"need {need} ({level or DEFAULT_CONSISTENCY}): {errs}"
            )
        committed = self.coord.map_parallel(
            lambda p: p.commit(class_name, shard, req_id), ok_parts
        )
        ok_commits = [(p, res) for p, res, err in committed if err is None]
        if len(ok_commits) < need:
            errs = "; ".join(str(e) for _, _, e in committed if e is not None)
            raise ReplicationError(
                f"commit: {len(ok_commits)}/{len(parts)} replicas ok, need {need}: {errs}"
            )
        return ok_commits[0][1]

    def put_object(self, class_name: str, shard: str, obj: StorObj,
                   level: Optional[str] = None) -> Optional[dict]:
        """-> the stored object's times (creation preserved on update), so
        the caller can report them accurately."""
        res = self._run(
            class_name, shard, [{"op": "put", "object": wire.obj_to_wire(obj)}], level
        )
        return res[0] if res else None

    def put_batch(self, class_name: str, shard: str, objs: Sequence[StorObj],
                  level: Optional[str] = None) -> list:
        res = self._run(
            class_name, shard,
            [{"op": "put_batch", "objects": wire.objs_to_wire(objs)}], level,
        )
        return res[0] if res else [None] * len(objs)

    def delete_object(self, class_name: str, shard: str, uuid: str,
                      level: Optional[str] = None) -> bool:
        import time

        # coordinator-stamped deletion time: replicas record identical
        # tombstone times, letting reads order the deletion vs stale copies
        res = self._run(
            class_name, shard,
            [{"op": "delete", "uuid": uuid, "deletionTime": int(time.time() * 1000)}],
            level,
        )
        return bool(res[0]) if res else False

    def merge_object(self, class_name: str, shard: str, uuid: str, props: dict,
                     vector=None, level: Optional[str] = None,
                     meta: Optional[dict] = None) -> bool:
        import time

        op = {"op": "merge", "uuid": uuid, "properties": props,
              "vector": list(map(float, vector)) if vector is not None else None,
              "meta": meta,
              "updateTime": int(time.time() * 1000)}
        res = self._run(class_name, shard, [op], level)
        return bool(res[0]) if res else False


class Finder:
    """Read path (finder.go): full read + digests, consistency-checked, with
    read repair of stale replicas (repairer.go)."""

    def __init__(self, coord: ReplicaCoordinator):
        self.coord = coord

    def check_consistency(self, class_name: str, shard: str, uuid: str,
                          update_time: int) -> bool:
        """True when every reachable replica's digest agrees with the given
        updateTime (the _additional.isConsistent probe, finder.go
        CheckConsistency). Unreachable replicas count as inconsistent —
        the honest answer when agreement cannot be confirmed."""
        return self.check_consistency_many(
            class_name, shard, [(uuid, update_time)])[0]

    def check_consistency_many(
        self, class_name: str, shard: str,
        pairs: list[tuple[str, int]],
    ) -> list[bool]:
        """Batch isConsistent: ONE digest request per replica covers every
        (uuid, updateTime) pair (finder.go DigestObjects shape) — a page of
        results costs R roundtrips, not rows x R."""
        if not pairs:
            return []
        uuids = [u for u, _ in pairs]
        verdicts = [True] * len(pairs)
        for p in self.coord.participants(class_name, shard):
            try:
                digests = p.digest_many(class_name, shard, uuids)
            except Exception:  # noqa: BLE001 — unreachable replica
                return [False] * len(pairs)
            by_uuid = {d.get("uuid"): d for d in digests}
            for i, (u, t) in enumerate(pairs):
                d = by_uuid.get(u)
                if d is None or not d.get("exists") or d.get("updateTime", 0) != t:
                    verdicts[i] = False
        return verdicts

    def get_object(self, class_name: str, shard: str, uuid: str,
                   level: Optional[str] = None,
                   include_vector: bool = True) -> Optional[StorObj]:
        parts = self.coord.participants(class_name, shard)
        need = required_acks(level, len(parts))
        # prefer the local replica for the full read
        parts.sort(key=lambda p: p.local is None)
        if need == 1 and parts and parts[0].local is not None:
            return parts[0].fetch(class_name, shard, uuid)

        full_part = None
        full_obj: Optional[StorObj] = None
        digests = []
        acks = 0
        for p in parts:
            try:
                if full_part is None:
                    full_obj = p.fetch(class_name, shard, uuid)
                    full_part = p
                    if full_obj is not None:
                        digests.append(
                            (p, {"exists": True,
                                 "updateTime": full_obj.last_update_time_unix})
                        )
                    else:
                        # absent locally: the digest carries tombstone info
                        digests.append((p, p.digest(class_name, shard, uuid)))
                else:
                    digests.append((p, p.digest(class_name, shard, uuid)))
                acks += 1
                if acks >= need and len(digests) >= need:
                    break
            except Exception:  # noqa: BLE001 — unreachable replica
                continue
        if acks < need:
            raise ReplicationError(
                f"read: {acks}/{len(parts)} replicas answered, need {need}"
            )
        # newest version wins by updateTime — a KNOWN deletion (tombstone
        # time) outranks older live copies, so repair propagates the delete
        # instead of resurrecting the object; an absence with no tombstone
        # (updateTime 0, e.g. a fresh scale-out replica) never outranks a
        # live copy
        newest_part, newest = max(digests, key=lambda pd: pd[1].get("updateTime", 0))
        newest_time = newest.get("updateTime", 0)
        if not newest.get("exists"):
            if newest.get("deleted"):
                # propagate the deletion to replicas still holding older copies
                for p, d in digests:
                    if p is not newest_part and d.get("exists") and d.get("updateTime", 0) < newest_time:
                        try:
                            p.overwrite(class_name, shard, [],
                                        deletes=[{"uuid": uuid, "time": newest_time}])
                        except Exception:  # noqa: BLE001
                            pass
                return None
            # nobody has it and nobody remembers deleting it
            if not any(d.get("exists") for _, d in digests):
                return None
            newest_part, newest = max(
                (pd for pd in digests if pd[1].get("exists")),
                key=lambda pd: pd[1].get("updateTime", 0),
            )
            newest_time = newest.get("updateTime", 0)
        if full_part is not newest_part or full_obj is None or (
            full_obj.last_update_time_unix < newest_time
        ):
            full_obj = newest_part.fetch(class_name, shard, uuid)
        # read repair: push the newest version to stale replicas (best effort)
        if full_obj is not None:
            for p, d in digests:
                if p is newest_part:
                    continue
                if (not d.get("exists")) or d.get("updateTime", 0) < full_obj.last_update_time_unix:
                    try:
                        p.overwrite(class_name, shard, [full_obj])
                    except Exception:  # noqa: BLE001
                        pass
        return full_obj

    def exists(self, class_name: str, shard: str, uuid: str,
               level: Optional[str] = None) -> bool:
        parts = self.coord.participants(class_name, shard)
        need = required_acks(level, len(parts))
        parts.sort(key=lambda p: p.local is None)
        answers = []
        for p in parts:
            try:
                answers.append(p.digest(class_name, shard, uuid))
                if len(answers) >= need:
                    break
            except Exception:  # noqa: BLE001
                continue
        if len(answers) < need:
            raise ReplicationError(
                f"exists: {len(answers)}/{len(parts)} replicas answered, need {need}"
            )
        best = max(answers, key=lambda d: d.get("updateTime", 0))
        if not best.get("exists") and not best.get("deleted"):
            # absence without a tombstone doesn't outrank live copies
            return any(d.get("exists") for d in answers)
        return bool(best.get("exists"))
