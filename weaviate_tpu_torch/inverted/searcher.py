# The port's copy of weaviate_tpu/inverted/searcher.py, its imports pointed at the port.
"""Filter evaluation: where-clause tree -> doc-ID Bitmap (AllowList).

Reference: inverted/searcher.go:157 (DocIDs) + searcher_doc_bitmap.go:25-109
(per-clause docBitmap, sroar AND/OR/AndNot merges) + like_regexp.go.

Operator semantics (entities/filters/filters.go:24-35):
Equal / NotEqual / GreaterThan(Equal) / LessThan(Equal) / Like / IsNull /
ContainsAny / ContainsAll / WithinGeoRange + And / Or / Not combinators.
Range operators run as lexicographic key-range scans over the byte-sortable
token keys (analyzer.encode_*).
"""

from __future__ import annotations

import bisect
import re
from typing import Callable, Optional

from weaviate_tpu_torch.entities.filters import (
    Clause,
    FilterValidationError,
    GeoRange,
    LocalFilter,
    Operator,
    like_to_regex,
)
from weaviate_tpu_torch.entities.schema import ClassDef, DataType
from weaviate_tpu_torch.inverted.analyzer import filter_value_token
from weaviate_tpu_torch.inverted.index import (
    NULL_TRUE,
    InvertedIndex,
    filterable_bucket,
)
from weaviate_tpu_torch.storage.bitmap import Bitmap


class FilterSearcher:
    def __init__(
        self,
        inverted: InvertedIndex,
        class_def: ClassDef,
        geo_search: Optional[Callable[[str, GeoRange], Bitmap]] = None,
        ref_resolver: Optional[Callable[[list[str], Clause], Bitmap]] = None,
    ):
        self.inverted = inverted
        self.class_def = class_def
        self.geo_search = geo_search
        self.ref_resolver = ref_resolver

    def doc_ids(self, flt: LocalFilter) -> Bitmap:
        return self._eval(flt.root)

    # -- tree ----------------------------------------------------------------

    def _eval(self, c: Clause) -> Bitmap:
        if c.operator is Operator.AND:
            out: Optional[Bitmap] = None
            for op in c.operands:
                b = self._eval(op)
                out = b if out is None else out.and_(b)
            return out or Bitmap()
        if c.operator is Operator.OR:
            out = Bitmap()
            for op in c.operands:
                out = out.or_(self._eval(op))
            return out
        if c.operator is Operator.NOT:
            # complement against the live universe (searcher uses the doc
            # universe the same way for NotEqual)
            universe = self.inverted.all_doc_ids()
            out = Bitmap()
            for op in c.operands:
                out = out.or_(self._eval(op))
            return universe.and_not(out)
        return self._eval_value(c)

    # -- leaves --------------------------------------------------------------

    def _prop(self, c: Clause):
        if not c.on:
            raise FilterValidationError("filter clause without path")
        name = c.on[0]
        if len(c.on) > 1:
            if name == "id" or name == "_id":
                raise FilterValidationError("id path cannot be nested")
            if self.ref_resolver is None:
                raise FilterValidationError("reference filters not supported here")
            return None  # handled by caller via ref path
        prop = self.class_def.get_property(name)
        if prop is None and name not in ("id", "_id", "_creationTimeUnix", "_lastUpdateTimeUnix"):
            raise FilterValidationError(f"unknown property {name!r} in filter")
        return prop

    def _eval_value(self, c: Clause) -> Bitmap:
        if len(c.on) > 1:
            # cross-reference path: [RefProp, TargetClass, targetProp...]
            if self.ref_resolver is None:
                raise FilterValidationError("reference filters not supported")
            return self.ref_resolver(c.on, c)
        name = c.on[0]
        if name in ("id", "_id"):
            return self._eval_id(c)
        prop = self._prop(c)
        if prop is None:
            raise FilterValidationError(f"unknown property {name!r}")
        pt = prop.primitive_type()
        if pt is None:
            raise FilterValidationError(
                f"property {name!r} is a reference; use a nested path"
            )
        if c.operator is Operator.WITHIN_GEO_RANGE:
            if pt.base is not DataType.GEO_COORDINATES:
                raise FilterValidationError("WithinGeoRange needs a geoCoordinates property")
            if self.geo_search is None:
                raise FilterValidationError("geo index not available")
            return self.geo_search(name, c.value)
        if c.operator is Operator.IS_NULL:
            from weaviate_tpu_torch.inverted.index import null_bucket

            nb = self.inverted.store.bucket(null_bucket(name))
            if nb is None:
                return Bitmap()
            nulls = nb.roaring_get(NULL_TRUE)
            if c.value in (False, None) or (isinstance(c.value, bool) and not c.value):
                return self.inverted.all_doc_ids().and_not(nulls)
            return nulls
        if not prop.index_filterable:
            raise FilterValidationError(f"property {name!r} is not indexFilterable")
        bucket = self.inverted.store.bucket(filterable_bucket(name))
        if bucket is None:
            return Bitmap()

        if c.operator in (Operator.CONTAINS_ANY, Operator.CONTAINS_ALL):
            values = c.value if isinstance(c.value, list) else [c.value]
            out: Optional[Bitmap] = None
            for v in values:
                tok = filter_value_token(pt, prop.tokenization, v)
                b = bucket.roaring_get(tok)
                if c.operator is Operator.CONTAINS_ANY:
                    out = b if out is None else out.or_(b)
                else:
                    out = b if out is None else out.and_(b)
            return out or Bitmap()

        if c.operator is Operator.LIKE:
            rx = re.compile(like_to_regex(str(c.value)).encode("utf-8"))
            out = Bitmap()
            for key in bucket.keys():
                if rx.match(key):
                    out = out.or_(bucket.roaring_get(key))
            return out

        tok = filter_value_token(pt, prop.tokenization, c.value)
        if c.operator is Operator.EQUAL:
            return bucket.roaring_get(tok)
        if c.operator is Operator.NOT_EQUAL:
            return self.inverted.all_doc_ids().and_not(bucket.roaring_get(tok))
        if c.operator in (
            Operator.GREATER_THAN,
            Operator.GREATER_THAN_EQUAL,
            Operator.LESS_THAN,
            Operator.LESS_THAN_EQUAL,
        ):
            return self._range(bucket, tok, c.operator)
        raise FilterValidationError(f"unsupported operator {c.operator}")

    def _range(self, bucket, tok: bytes, op: Operator) -> Bitmap:
        keys = bucket.keys()
        lo = bisect.bisect_left(keys, tok)
        out = Bitmap()
        if op is Operator.GREATER_THAN:
            start = bisect.bisect_right(keys, tok)
            sel = keys[start:]
        elif op is Operator.GREATER_THAN_EQUAL:
            sel = keys[lo:]
        elif op is Operator.LESS_THAN:
            sel = keys[:lo]
        else:  # LESS_THAN_EQUAL
            sel = keys[: bisect.bisect_right(keys, tok)]
        for k in sel:
            out = out.or_(bucket.roaring_get(k))
        return out

    def _eval_id(self, c: Clause) -> Bitmap:
        """id filters resolve through the uuid->docID mapping supplied by the
        shard (searcher_doc_bitmap uuid path). Requires an id_resolver."""
        raise FilterValidationError(
            "id-path filters must be evaluated by the shard (uuid index)"
        )
