# The port's copy of weaviate_tpu/cluster/payloads.py, its imports pointed at the port.
"""Wire codecs for the internal cluster API.

Reference: adapters/handlers/rest/clusterapi/indices_payloads.go — the
hand-rolled binary payload codecs for node-to-node shard ops. Here the
envelope is JSON (cheap to debug, fast enough for the control+data plane at
this scale) with the hot fields binary-packed inside:

- objects ride as base64 of the storobj binary codec (entities/storobj.py,
  the same bytes that sit in the LSM) — no re-serialization tax;
- vector batches ride as base64 little-endian float32 with an explicit
  shape, so a 256-query batch is one contiguous blob.

The formats are the JAX package's, so a port node and a JAX node read each
other. In the port every number that crosses the wire is a Python float or
int (`_num`): a search result's distance may come off the card, and a torch
or numpy scalar is not JSON.
"""

from __future__ import annotations

import base64
from typing import Optional, Sequence

import numpy as np

from weaviate_tpu_torch.db.shard import SearchResult
from weaviate_tpu_torch.entities.filters import LocalFilter
from weaviate_tpu_torch.entities.storobj import StorObj


def obj_to_wire(obj: StorObj) -> str:
    return base64.b64encode(obj.to_binary()).decode("ascii")


def obj_from_wire(s: str, include_vector: bool = True) -> StorObj:
    return StorObj.from_binary(base64.b64decode(s), include_vector)


def objs_to_wire(objs: Sequence[StorObj]) -> list[str]:
    return [obj_to_wire(o) for o in objs]


def objs_from_wire(items: Sequence[str]) -> list[StorObj]:
    return [obj_from_wire(s) for s in items]


def vectors_to_wire(vecs: np.ndarray) -> dict:
    v = np.ascontiguousarray(vecs, dtype="<f4")
    return {
        "shape": list(v.shape),
        "data": base64.b64encode(v.tobytes()).decode("ascii"),
    }


def vectors_from_wire(d: dict) -> np.ndarray:
    raw = base64.b64decode(d["data"])
    return np.frombuffer(raw, dtype="<f4").reshape(d["shape"]).copy()


def filter_to_wire(flt: Optional[LocalFilter]) -> Optional[dict]:
    return flt.to_dict() if flt is not None else None


def filter_from_wire(d: Optional[dict]) -> Optional[LocalFilter]:
    return LocalFilter.from_dict(d) if d else None


def _num(x):
    """A result's number as a Python float (None stays None): exact for an
    f32 or f64 value, which a Python float holds bit for bit."""
    return None if x is None else float(x)


def result_to_wire(r: SearchResult) -> dict:
    return {
        "obj": obj_to_wire(r.obj),
        "distance": _num(r.distance),
        "certainty": _num(r.certainty),
        "score": _num(r.score),
        "explainScore": r.explain_score,
        "shard": r.shard,
        "additional": r.additional or {},
    }


def result_from_wire(d: dict) -> SearchResult:
    return SearchResult(
        obj=obj_from_wire(d["obj"]),
        distance=d.get("distance"),
        certainty=d.get("certainty"),
        score=d.get("score"),
        explain_score=d.get("explainScore"),
        shard=d.get("shard", ""),
        additional=d.get("additional") or {},
    )


def results_to_wire(rows: Sequence[SearchResult]) -> list[dict]:
    return [result_to_wire(r) for r in rows]


def results_from_wire(items: Sequence[dict]) -> list[SearchResult]:
    return [result_from_wire(d) for d in items]
