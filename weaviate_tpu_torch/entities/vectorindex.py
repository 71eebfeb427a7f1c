"""Vector-index user configs and the index-type registry (the port's own
copy of `weaviate_tpu/entities/vectorindex.py`, cut to what the `hnsw`,
`hnsw_tpu`, `hnsw_tpu_mesh`, `flat` and `noop` index types read, the whole `pq` block
included; other schema keys are ignored, as the JAX package ignores keys
it does not know).

Reference: entities/vectorindex/hnsw/config.go:33-66 (UserConfig +
defaults), config.go:69-71 (IndexType discriminator), config.go:101
(ParseAndValidateConfig). The config surface and its JSON names are the
same as the JAX package's, so one schema parses the same in both.
"""

from __future__ import annotations

import logging
import threading
import time
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

# the device store's element types (`storeDtype`): bfloat16 halves the
# store's bytes, and K1 scans it with its bf16 filler
STORE_DTYPES = ("float32", "bfloat16")

# the metrics with a matmul form: the group-min scan and the fast-scan
# rescore serve only these
MATMUL_DISTANCES = (DISTANCE_L2, DISTANCE_DOT, DISTANCE_COSINE)

# defaults mirroring entities/vectorindex/hnsw/config.go:33-49
DEFAULT_MAX_CONNECTIONS = 64
DEFAULT_EF_CONSTRUCTION = 128
DEFAULT_EF = -1  # dynamic
DEFAULT_DYNAMIC_EF_MIN = 100
DEFAULT_DYNAMIC_EF_MAX = 500
DEFAULT_DYNAMIC_EF_FACTOR = 8
DEFAULT_CLEANUP_INTERVAL_SECONDS = 300
DEFAULT_FLAT_SEARCH_CUTOFF = 40_000


# PQ defaults (pq_config.go:21-26)
DEFAULT_PQ_CENTROIDS = 256
PQ_ENCODER_KMEANS = "kmeans"
PQ_ENCODER_TILE = "tile"
PQ_DISTRIBUTION_LOG_NORMAL = "log-normal"
PQ_DISTRIBUTION_NORMAL = "normal"
# learned orthogonal rotation before quantization (OPQ)
PQ_ROTATION_NONE = "none"
PQ_ROTATION_OPQ = "opq"


@dataclass
class PQEncoderConfig:
    type: str = PQ_ENCODER_KMEANS
    distribution: str = PQ_DISTRIBUTION_LOG_NORMAL


@dataclass
class PQConfig:
    """The schema's `pq` block (pq_config.go plus the JAX package's
    extensions): `rescore` keeps a bf16 copy of the rows on the device for
    the fast scan and the exact rescore (0 = auto `rescoreLimit`),
    `rotation` 'opq' fits an orthogonal rotation before quantizing, and
    `bits` 4 adds the nibble-packed 16-centroid quantizer that serves
    through the three-stage funnel (ops/pq4.py)."""

    enabled: bool = False
    segments: int = 0  # 0 = auto (= dims)
    centroids: int = DEFAULT_PQ_CENTROIDS
    encoder: PQEncoderConfig = field(default_factory=PQEncoderConfig)
    rescore: bool = True
    rescore_limit: int = 0
    rotation: str = PQ_ROTATION_NONE
    bits: int = 8

    @classmethod
    def from_dict(cls, d: dict) -> "PQConfig":
        enc = d.get("encoder") or {}
        return cls(
            enabled=bool(d.get("enabled", False)),
            segments=int(d.get("segments", 0)),
            centroids=int(d.get("centroids", DEFAULT_PQ_CENTROIDS)),
            encoder=PQEncoderConfig(
                type=enc.get("type", PQ_ENCODER_KMEANS),
                distribution=enc.get("distribution", PQ_DISTRIBUTION_LOG_NORMAL),
            ),
            rescore=bool(d.get("rescore", True)),
            rescore_limit=int(d.get("rescoreLimit", 0)),
            rotation=str(d.get("rotation", PQ_ROTATION_NONE)),
            bits=int(d.get("bits", 8)),
        )


@dataclass
class HnswUserConfig:
    """UserConfig shared by "hnsw", "hnsw_tpu", "hnsw_tpu_mesh", "flat" and
    "noop" (config.go:52-66)."""

    index_type: str = "hnsw_tpu"
    skip: bool = False
    cleanup_interval_seconds: int = DEFAULT_CLEANUP_INTERVAL_SECONDS
    max_connections: int = DEFAULT_MAX_CONNECTIONS
    ef_construction: int = DEFAULT_EF_CONSTRUCTION
    ef: int = DEFAULT_EF
    # the native graph engine's dynamic ef (index/hnsw.py, ef = -1)
    dynamic_ef_min: int = DEFAULT_DYNAMIC_EF_MIN
    dynamic_ef_max: int = DEFAULT_DYNAMIC_EF_MAX
    dynamic_ef_factor: int = DEFAULT_DYNAMIC_EF_FACTOR
    flat_search_cutoff: int = DEFAULT_FLAT_SEARCH_CUTOFF
    distance: str = DISTANCE_COSINE
    pq: PQConfig = field(default_factory=PQConfig)
    store_dtype: str = "float32"  # device store dtype: float32 | bfloat16
    exact_topk: bool = False  # skip the group-min fast scan: exact chunked scan
    mesh_devices: int = 0  # hnsw_tpu_mesh: devices to shard over (0 = all)

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
            dynamic_ef_min=int(d.get("dynamicEfMin", DEFAULT_DYNAMIC_EF_MIN)),
            dynamic_ef_max=int(d.get("dynamicEfMax", DEFAULT_DYNAMIC_EF_MAX)),
            dynamic_ef_factor=int(d.get("dynamicEfFactor", DEFAULT_DYNAMIC_EF_FACTOR)),
            flat_search_cutoff=int(d.get("flatSearchCutoff", DEFAULT_FLAT_SEARCH_CUTOFF)),
            distance=d.get("distance", DISTANCE_COSINE),
            pq=PQConfig.from_dict(d.get("pq") or {}),
            store_dtype=d.get("storeDtype", "float32"),
            exact_topk=bool(d.get("exactTopK", False)),
            mesh_devices=int(d.get("meshDevices", 0)),
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
        if self.store_dtype not in STORE_DTYPES:
            raise ConfigValidationError(
                f"storeDtype must be 'float32' or 'bfloat16', got {self.store_dtype!r}"
            )
        if self.pq.enabled:
            validate_pq(self.pq, self.distance)


def validate_pq(pq: PQConfig, distance: str) -> None:
    """The pq checks of the JAX package's `HnswUserConfig.validate`."""
    if pq.centroids < 1 or pq.centroids > 65536:
        raise ConfigValidationError("pq.centroids must be in [1, 65536]")
    if pq.encoder.type not in (PQ_ENCODER_KMEANS, PQ_ENCODER_TILE):
        raise ConfigValidationError(f"invalid pq encoder {pq.encoder.type!r}")
    if pq.rotation not in (PQ_ROTATION_NONE, PQ_ROTATION_OPQ):
        raise ConfigValidationError(f"invalid pq rotation {pq.rotation!r} (none|opq)")
    if pq.bits not in (4, 8):
        raise ConfigValidationError("pq.bits must be 4 or 8")
    if pq.bits == 4:
        if distance not in MATMUL_DISTANCES:
            # the funnel's 4-bit scan and 8-bit rescore are matmul-ADC
            # formulations; manhattan's LUT tier has no 4-bit twin
            raise ConfigValidationError(
                "pq.bits=4 requires an l2-squared/dot/cosine distance")
        if pq.encoder.type != PQ_ENCODER_KMEANS:
            raise ConfigValidationError("pq.bits=4 requires the kmeans encoder")
    if not pq.rescore:
        # codes-only ADC over a flat scan lands the quantizer's whole error
        # on the result set: loud at config time, rate-limited because
        # validate() runs on every config load and update
        _warn_rescore_off()


_RESCORE_WARN_INTERVAL_S = 60.0
_rescore_warn_last = [0.0]  # one rate limit per process
_rescore_warn_lock = threading.Lock()


def _warn_rescore_off() -> None:
    with _rescore_warn_lock:
        now = time.monotonic()
        if now - _rescore_warn_last[0] < _RESCORE_WARN_INTERVAL_S:
            return
        _rescore_warn_last[0] = now
    logging.getLogger(__name__).warning(
        "pq.rescore=false serves raw ADC distances with NO exact "
        "rescoring pass: expect a severe recall drop on flat scans. Set "
        "pq.rescore=true (default) unless you need the absolute memory "
        "floor; pq.rotation='opq' recovers part of the loss for "
        "codes-only serving.")


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


# the index types this port serves: the JAX package's registry
_PARSERS: dict[str, Callable[[Optional[dict]], HnswUserConfig]] = {
    "hnsw": lambda d: HnswUserConfig.from_dict(d, "hnsw"),
    "hnsw_tpu": lambda d: HnswUserConfig.from_dict(d, "hnsw_tpu"),
    "hnsw_tpu_mesh": lambda d: HnswUserConfig.from_dict(d, "hnsw_tpu_mesh"),
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
