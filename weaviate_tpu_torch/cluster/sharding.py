# The port's copy of weaviate_tpu/cluster/sharding.py, its imports pointed at the port.
"""Sharding state: murmur3 token ring with virtual shards.

Reference: usecases/sharding/state.go — 128 virtual shards per physical
(config.go:22 DefaultVirtualPerPhysical), each virtual shard owns a token
range on a murmur3-64 ring; PhysicalShard(uuid) hashes the object key and
binary-searches the ring (state.go:136, initVirtual state.go:261); physical
shards are assigned to nodes including replicas (BelongsToNodes).

The ring layout is deterministic per (class, shard count) so every node
derives the identical state from the schema — the reference instead persists
the randomly-drawn ring inside the schema; determinism here removes that
synchronisation need without changing routing semantics.
"""

from __future__ import annotations

import bisect
import struct
from dataclasses import dataclass, field
from typing import Optional

DEFAULT_VIRTUAL_PER_PHYSICAL = 128


def murmur3_64(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x64_128 finalized to its first 64 bits (the hash the
    reference uses for shard routing via spaolacci/murmur3 Sum64)."""
    c1 = 0x87C37B91114253D5
    c2 = 0x4CF5AD432745937F
    mask = (1 << 64) - 1
    length = len(data)
    h1 = seed
    h2 = seed

    def rotl(x: int, r: int) -> int:
        return ((x << r) | (x >> (64 - r))) & mask

    nblocks = length // 16
    for i in range(nblocks):
        k1, k2 = struct.unpack_from("<QQ", data, i * 16)
        k1 = (k1 * c1) & mask
        k1 = rotl(k1, 31)
        k1 = (k1 * c2) & mask
        h1 ^= k1
        h1 = rotl(h1, 27)
        h1 = (h1 + h2) & mask
        h1 = (h1 * 5 + 0x52DCE729) & mask
        k2 = (k2 * c2) & mask
        k2 = rotl(k2, 33)
        k2 = (k2 * c1) & mask
        h2 ^= k2
        h2 = rotl(h2, 31)
        h2 = (h2 + h1) & mask
        h2 = (h2 * 5 + 0x38495AB5) & mask

    tail = data[nblocks * 16 :]
    k1 = 0
    k2 = 0
    tl = len(tail)
    if tl >= 9:
        for i in range(tl - 1, 7, -1):
            k2 = (k2 << 8) | tail[i]
        k2 = (k2 * c2) & mask
        k2 = rotl(k2, 33)
        k2 = (k2 * c1) & mask
        h2 ^= k2
    if tl > 0:
        for i in range(min(tl, 8) - 1, -1, -1):
            k1 = (k1 << 8) | tail[i]
        k1 = (k1 * c1) & mask
        k1 = rotl(k1, 31)
        k1 = (k1 * c2) & mask
        h1 ^= k1

    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & mask
    h2 = (h2 + h1) & mask

    def fmix(k: int) -> int:
        k ^= k >> 33
        k = (k * 0xFF51AFD7ED558CCD) & mask
        k ^= k >> 33
        k = (k * 0xC4CEB9FE1A85EC53) & mask
        k ^= k >> 33
        return k

    h1 = fmix(h1)
    h2 = fmix(h2)
    h1 = (h1 + h2) & mask
    return h1


@dataclass
class ShardingConfig:
    """usecases/sharding/config.go analog."""

    desired_count: int = 1
    virtual_per_physical: int = DEFAULT_VIRTUAL_PER_PHYSICAL
    replicas: int = 1
    key: str = "_id"
    strategy: str = "hash"
    function: str = "murmur3"

    @classmethod
    def from_dict(cls, d: Optional[dict], node_count: int = 1) -> "ShardingConfig":
        d = d or {}
        return cls(
            desired_count=int(d.get("desiredCount", node_count) or node_count),
            virtual_per_physical=int(d.get("virtualPerPhysical", DEFAULT_VIRTUAL_PER_PHYSICAL)),
            replicas=int(d.get("replicas", 1) or 1),
            key=d.get("key", "_id"),
            strategy=d.get("strategy", "hash"),
            function=d.get("function", "murmur3"),
        )

    def to_dict(self) -> dict:
        return {
            "desiredCount": self.desired_count,
            "virtualPerPhysical": self.virtual_per_physical,
            "replicas": self.replicas,
            "key": self.key,
            "strategy": self.strategy,
            "function": self.function,
        }


@dataclass
class Physical:
    name: str
    belongs_to_nodes: list[str] = field(default_factory=list)
    status: str = "READY"


class ShardingState:
    """Token ring: virtual shards -> physical shards -> nodes.

    Deterministic virtual tokens (murmur3 of "class/shard/v{i}") replace the
    reference's persisted random draw (state.go:261 initVirtual)."""

    def __init__(self, class_name: str, config: ShardingConfig, node_names: list[str]):
        self.class_name = class_name
        self.config = config
        self.physical: dict[str, Physical] = {}
        self._tokens: list[int] = []
        self._token_owner: list[str] = []  # physical name per sorted token
        names = [f"shard-{i}" for i in range(config.desired_count)]
        rf = min(max(config.replicas, 1), max(len(node_names), 1))
        for i, name in enumerate(names):
            nodes = [node_names[(i + r) % len(node_names)] for r in range(rf)] if node_names else []
            self.physical[name] = Physical(name=name, belongs_to_nodes=nodes)
        pairs = []
        for name in names:
            for v in range(config.virtual_per_physical):
                tok = murmur3_64(f"{class_name}/{name}/v{v}".encode("utf-8"))
                pairs.append((tok, name))
        pairs.sort()
        self._tokens = [p[0] for p in pairs]
        self._token_owner = [p[1] for p in pairs]

    def all_physical_shards(self) -> list[str]:
        return sorted(self.physical)

    def physical_shard(self, uuid_key: bytes) -> str:
        """Route an object key to its physical shard (state.go:136)."""
        tok = murmur3_64(uuid_key)
        i = bisect.bisect_left(self._tokens, tok)
        if i >= len(self._tokens):
            i = 0  # wrap the ring
        return self._token_owner[i]

    def belongs_to_nodes(self, shard_name: str) -> list[str]:
        return self.physical[shard_name].belongs_to_nodes

    def is_local(self, shard_name: str, local_node: str) -> bool:
        nodes = self.belongs_to_nodes(shard_name)
        return not nodes or local_node in nodes

    def to_dict(self) -> dict:
        return {
            "config": self.config.to_dict(),
            "physical": {
                n: {"belongsToNodes": p.belongs_to_nodes, "status": p.status}
                for n, p in self.physical.items()
            },
        }
