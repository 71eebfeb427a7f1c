"""The port's copy of the serving knobs the compressed tiers read, and of
the environment-boolean parser (twin of
`weaviate_tpu/config/config.py:29,57,63,66`).

In the JAX package a recall-guarded controller may step each budget down
its ladder; without one installed, the index reads the top bucket. The
port has no control plane, so each cap is its ladder's top bucket.
"""

from typing import Mapping

# fast-scan candidate depth of the chunked scan: max(4k, 32) capped at the
# top bucket
RESCORE_R_BUCKETS = (32, 48, 64, 96, 128)

# 4-bit funnel stage-1 survivors C (multiples of the group width 16)
PQ4_FUNNEL_C_BUCKETS = (256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)

# 4-bit funnel stage-2 survivors c
PQ4_FUNNEL_RESCORE_BUCKETS = (32, 48, 64, 96, 128, 192, 256)


def _bool(env: Mapping[str, str], key: str, default: bool = False) -> bool:
    """env[key] as a boolean: true, enabled, on or 1 (any case, outer
    spaces ignored) is True, anything else False; default when unset. The
    reference's truth table, so one knob reads the same in both
    packages."""
    v = env.get(key)
    if v is None:
        return default
    return v.strip().lower() in ("true", "enabled", "on", "1")
