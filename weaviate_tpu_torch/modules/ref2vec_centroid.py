# The port's copy of weaviate_tpu/modules/ref2vec_centroid.py, its imports pointed at the port.
"""ref2vec-centroid: an object's vector is the centroid of its referenced
objects' vectors.

Reference: modules/ref2vec-centroid — instead of embedding text, the
module resolves the object's cross-references (beacon lists) and averages
the targets' vectors (mean calculation, config `referenceProperties`).
Needs a DB handle to resolve beacons; the provider wires it via set_db.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from weaviate_tpu_torch.modules.interface import Module, Vectorizer


class Ref2VecCentroid(Module, Vectorizer):
    def __init__(self):
        self.db = None

    @property
    def name(self) -> str:
        return "ref2vec-centroid"

    @property
    def module_type(self) -> str:
        return "ref2vec"

    def set_db(self, db) -> None:
        self.db = db

    def meta(self) -> dict:
        return {"type": "ref2vec", "method": "centroid"}

    def vectorize_object(self, class_def, obj, module_cfg: dict) -> Optional[np.ndarray]:
        if self.db is None:
            return None
        ref_props = module_cfg.get("referenceProperties") or [
            p.name for p in class_def.properties if p.primitive_type() is None
        ]
        vectors = []
        for pname in ref_props:
            for ref in obj.properties.get(pname) or []:
                beacon = ref.get("beacon", "") if isinstance(ref, dict) else str(ref)
                uuid = beacon.rstrip("/").split("/")[-1]
                if not uuid:
                    continue
                target, _ = self.db.object_by_uuid_any_class(uuid, include_vector=True)
                if target is not None and target.vector is not None:
                    vectors.append(np.asarray(target.vector, dtype=np.float32))
        if not vectors:
            return None
        return np.mean(np.stack(vectors), axis=0)

    def vectorize_input(self, class_def, obj, module_cfg: dict):
        ref_props = module_cfg.get("referenceProperties") or [
            p.name for p in class_def.properties if p.primitive_type() is None
        ]
        beacons = []
        for pname in sorted(ref_props):
            for ref in obj.properties.get(pname) or []:
                beacons.append(ref.get("beacon", "") if isinstance(ref, dict) else str(ref))
        return tuple(beacons)

    def vectorize_text(self, texts: Sequence[str]) -> np.ndarray:
        from weaviate_tpu_torch.modules.provider import ModuleError

        # ValueError-family so the API layer reports 422, not a 500
        raise ModuleError("ref2vec-centroid cannot embed text (no nearText)")
