"""Vector-index user configs and the index-type registry (the port's own
copy of `weaviate_tpu/entities/vectorindex.py`, cut to what the
`hnsw_tpu`, `flat` and `noop` index types read; other schema keys are
ignored, as the JAX package ignores keys it does not know).

Reference: entities/vectorindex/hnsw/config.go:33-66 (UserConfig +
defaults), config.go:69-71 (IndexType discriminator), config.go:101
(ParseAndValidateConfig). The config surface and its JSON names are the
same as the JAX package's, so one schema parses the same in both.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional


class ConfigValidationError(ValueError):
    pass


DISTANCE_COSINE = "cosine"
DISTANCE_DOT = "dot"
DISTANCE_L2 = "l2-squared"
DISTANCE_MANHATTAN = "manhattan"
DISTANCE_HAMMING = "hamming"

DISTANCES = (
    DISTANCE_COSINE,
    DISTANCE_DOT,
    DISTANCE_L2,
    DISTANCE_MANHATTAN,
    DISTANCE_HAMMING,
)

# the metrics with a matmul form: the group-min scan and the fast-scan
# rescore serve only these
MATMUL_DISTANCES = (DISTANCE_L2, DISTANCE_DOT, DISTANCE_COSINE)

# defaults mirroring entities/vectorindex/hnsw/config.go:33-49
DEFAULT_MAX_CONNECTIONS = 64
DEFAULT_EF_CONSTRUCTION = 128
DEFAULT_EF = -1  # dynamic
DEFAULT_CLEANUP_INTERVAL_SECONDS = 300
DEFAULT_FLAT_SEARCH_CUTOFF = 40_000


@dataclass
class PQConfig:
    """The `pq` block of the schema, as far as the port reads it: it
    serves no compressed tier yet, so an index with `enabled` set refuses
    to start (the other pq settings wait for ROADMAP queue 1 item 7)."""

    enabled: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "PQConfig":
        return cls(enabled=bool(d.get("enabled", False)))


@dataclass
class HnswUserConfig:
    """UserConfig shared by "hnsw_tpu", "flat" and "noop" (config.go:52-66)."""

    index_type: str = "hnsw_tpu"
    skip: bool = False
    cleanup_interval_seconds: int = DEFAULT_CLEANUP_INTERVAL_SECONDS
    max_connections: int = DEFAULT_MAX_CONNECTIONS
    ef_construction: int = DEFAULT_EF_CONSTRUCTION
    ef: int = DEFAULT_EF
    flat_search_cutoff: int = DEFAULT_FLAT_SEARCH_CUTOFF
    distance: str = DISTANCE_COSINE
    pq: PQConfig = field(default_factory=PQConfig)
    store_dtype: str = "float32"
    exact_topk: bool = False  # skip the group-min fast scan: exact chunked scan

    def IndexType(self) -> str:  # discriminator parity (config.go:69-71)
        return self.index_type

    def distance_name(self) -> str:
        return self.distance

    @classmethod
    def from_dict(cls, d: Optional[dict], index_type: str = "hnsw_tpu") -> "HnswUserConfig":
        d = d or {}
        cfg = cls(
            index_type=index_type,
            skip=bool(d.get("skip", False)),
            cleanup_interval_seconds=int(d.get("cleanupIntervalSeconds", DEFAULT_CLEANUP_INTERVAL_SECONDS)),
            max_connections=int(d.get("maxConnections", DEFAULT_MAX_CONNECTIONS)),
            ef_construction=int(d.get("efConstruction", DEFAULT_EF_CONSTRUCTION)),
            ef=int(d.get("ef", DEFAULT_EF)),
            flat_search_cutoff=int(d.get("flatSearchCutoff", DEFAULT_FLAT_SEARCH_CUTOFF)),
            distance=d.get("distance", DISTANCE_COSINE),
            pq=PQConfig.from_dict(d.get("pq") or {}),
            store_dtype=d.get("storeDtype", "float32"),
            exact_topk=bool(d.get("exactTopK", False)),
        )
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if self.distance not in DISTANCES:
            raise ConfigValidationError(
                f"invalid distance {self.distance!r}; must be one of {DISTANCES}"
            )
        if self.max_connections < 4:
            raise ConfigValidationError("maxConnections must be >= 4")
        if self.ef_construction < 4:
            raise ConfigValidationError("efConstruction must be >= 4")
        if self.ef != -1 and self.ef < 1:
            raise ConfigValidationError("ef must be -1 (dynamic) or >= 1")
        if self.store_dtype != "float32":
            # the JAX package also takes "bfloat16"; the port's store is
            # float32 only until its bf16 store lands
            raise ConfigValidationError(
                f"storeDtype must be 'float32' in this port, got {self.store_dtype!r}"
            )


IMMUTABLE_FIELDS = (
    "max_connections",
    "ef_construction",
    "cleanup_interval_seconds",
    "distance",
)


def validate_config_update(old: HnswUserConfig, new: HnswUserConfig) -> None:
    """Hot-update validation (hnsw/config_update.go)."""
    for f in IMMUTABLE_FIELDS:
        if getattr(old, f) != getattr(new, f):
            raise ConfigValidationError(f"{f} is immutable: can't update vector index config")
    if old.pq.enabled and not new.pq.enabled:
        raise ConfigValidationError("pq is already enabled: can't disable")


# the index types this port serves (the JAX package's registry also holds
# the mesh and native-graph types, which are not ported yet)
_PARSERS: dict[str, Callable[[Optional[dict]], HnswUserConfig]] = {
    "hnsw_tpu": lambda d: HnswUserConfig.from_dict(d, "hnsw_tpu"),
    "flat": lambda d: HnswUserConfig.from_dict(d, "flat"),
    "noop": lambda d: HnswUserConfig.from_dict({**(d or {}), "skip": True}, "noop"),
}


def parse_and_validate_config(index_type: str, cfg: Optional[dict]) -> HnswUserConfig:
    """Parse and validate a schema's vectorIndexConfig (config.go:101)."""
    parser = _PARSERS.get(index_type)
    if parser is None:
        raise ConfigValidationError(
            f"unknown vectorIndexType {index_type!r}; registered: {sorted(_PARSERS)}"
        )
    return parser(cfg)
