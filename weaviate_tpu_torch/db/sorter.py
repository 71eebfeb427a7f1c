# The port's copy of weaviate_tpu/db/sorter.py, its imports pointed at the port.
"""LSM-backed sorter: order doc ids by property values without hydrating
full result objects.

Reference: adapters/repos/db/sorter/ — sorting a large filtered result set
must not decode every matching object into a full API object; the sorter
extracts just the sort keys from the LSM object bucket (partial storobj
decode: the vector — the bulk of the payload — is skipped), orders doc ids,
and only the page being returned gets hydrated.

One comparator serves both the shard-level id sort and the class-level merge
of per-shard sorted pages: missing values sort LAST regardless of direction
(the reference's nil handling), and mixed-type property values (auto-schema
drift, geo/phone dicts) order by a type rank instead of raising — numbers,
then strings, then everything else by its JSON rendering.
"""

from __future__ import annotations

import json
import struct
from typing import Optional, Sequence

from weaviate_tpu_torch.entities.storobj import StorObj


def _sort_key(obj: StorObj, path: str):
    if path in ("_id", "id"):
        return obj.uuid
    if path == "_creationTimeUnix":
        return obj.creation_time_unix
    if path == "_lastUpdateTimeUnix":
        return obj.last_update_time_unix
    v = obj.properties.get(path)
    if isinstance(v, list):
        return v[0] if v else None
    return v


def _spec_path(spec: dict) -> str:
    path = spec.get("path") or spec.get("property") or ""
    if isinstance(path, list):
        path = path[0] if path else ""
    return str(path)


class _Reversed:
    """Inverts comparison for descending string/json keys (numbers negate
    instead, but str has no negation)."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return self.v == other.v


def _typed_key(value, desc: bool):
    """Total-order key for arbitrary property values: (missing, type_rank,
    comparable). Safe under mixed types; missing last in BOTH directions."""
    if value is None:
        return (1, 0, 0)
    if isinstance(value, bool):
        value = int(value)
    if isinstance(value, (int, float)):
        return (0, 0, -float(value) if desc else float(value))
    if isinstance(value, str):
        return (0, 1, _Reversed(value) if desc else value)
    rendered = json.dumps(value, sort_keys=True, default=str)
    return (0, 2, _Reversed(rendered) if desc else rendered)


def _order(pairs: list, key_of, sort: list[dict]) -> list:
    """Stable multi-spec ordering: apply specs from last to first."""
    for spec in reversed(sort):
        path = _spec_path(spec)
        desc = (spec.get("order") or "asc").lower() == "desc"
        pairs.sort(key=lambda p: _typed_key(key_of(p, path), desc))
    return pairs


def sort_results(rows, sort: list[dict]):
    """Class-level merge of per-shard sorted pages (index.go merge role):
    re-order hydrated SearchResults by the same comparator the shards used."""
    return _order(list(rows), lambda r, path: _sort_key(r.obj, path), sort)


class Sorter:
    def __init__(self, shard):
        self.shard = shard

    def sort_doc_ids(
        self,
        doc_ids: Sequence[int],
        sort: list[dict],
        limit: Optional[int] = None,
    ) -> list[int]:
        """Order `doc_ids` by the sort spec [{path|property, order}];
        -> the first `limit` ids (all when None)."""
        keyed = []
        for d in doc_ids:
            key = self.shard.docid_lookup.get(struct.pack("<Q", int(d)))
            if key is None:
                continue
            raw = self.shard.objects.get(key)
            if raw is None:
                continue
            obj = StorObj.from_binary(raw, include_vector=False)
            keyed.append((int(d), obj))
        _order(keyed, lambda p, path: _sort_key(p[1], path), sort)
        ordered = [d for d, _ in keyed]
        return ordered[:limit] if limit is not None else ordered
