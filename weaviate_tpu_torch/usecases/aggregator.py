# The port's copy of weaviate_tpu/usecases/aggregator.py, its imports pointed at the port.
"""Aggregate queries: meta count, per-property aggregations, groupBy.

Reference: adapters/repos/db/aggregator/ — numeric (mean/max/min/sum/mode/
median/count), text (topOccurrences), boolean (totalTrue/percentageTrue/...),
date (min/max/mode/median/count), grouped mode, filtered mode (reuses the
allowList), unfiltered fast path; GraphQL surface built in
adapters/handlers/graphql/local/aggregate.

Aggregation inputs are decoded JSON properties on the host, so the math runs
in numpy (vectorized over the hydrated column); a device round-trip would
cost more than the reduction itself at any realistic result size.
"""

from __future__ import annotations

from collections import Counter as CollCounter
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from weaviate_tpu_torch.entities.filters import LocalFilter
from weaviate_tpu_torch.entities.schema import DataType


class AggregatorError(ValueError):
    pass


@dataclass
class AggregateParams:
    class_name: str
    filters: Optional[LocalFilter] = None
    near_vector: Optional[dict] = None
    near_object: Optional[dict] = None
    near_text: Optional[dict] = None  # resolved via modules in the explorer
    object_limit: Optional[int] = None  # required with near*
    group_by: Optional[list[str]] = None
    properties: dict[str, list[str]] = field(default_factory=dict)  # prop -> aggs
    include_meta_count: bool = False
    limit: Optional[int] = None  # max groups


NUMERIC_AGGS = ("count", "minimum", "maximum", "mean", "median", "mode", "sum")
TEXT_AGGS = ("count", "topOccurrences", "type")
BOOL_AGGS = ("count", "totalTrue", "totalFalse", "percentageTrue", "percentageFalse")
DATE_AGGS = ("count", "minimum", "maximum", "median", "mode")


class Aggregator:
    def __init__(self, db, schema_manager, explorer=None):
        self.db = db
        self.schema = schema_manager
        self.explorer = explorer  # for near* doc-set restriction

    def aggregate(self, params: AggregateParams) -> list[dict]:
        """-> list of group dicts (one element when ungrouped):
        {groupedBy?, meta?: {count}, <prop>: {agg: value, ...}}"""
        resolved = self.schema.resolve_class_name(params.class_name)
        idx = self.db.get_index(resolved) if resolved else None
        if idx is None:
            raise AggregatorError(f"class {params.class_name!r} not found")
        cd = self.schema.get_class(resolved)

        # meta-count-only fast path: ships per-shard integers instead of
        # the object set (the reference's unfiltered fast path, generalized
        # to filtered counts)
        if (
            params.include_meta_count
            and not params.properties
            and not params.group_by
            and params.near_vector is None
            and params.near_object is None
            and params.near_text is None
        ):
            return [{"meta": {"count": idx.aggregate_count(params.filters)}}]

        count, cols = self._columns(idx, params)

        if params.group_by:
            prop = params.group_by[0]
            # group by ROW INDEX so every aggregated column stays aligned
            # with its group without re-shipping objects
            groups: dict[Any, list[int]] = {}
            for i, v in enumerate(cols.get(prop, [])):
                for key in v if isinstance(v, list) else [v]:
                    groups.setdefault(key, []).append(i)
            out = []
            items = sorted(groups.items(), key=lambda kv: -len(kv[1]))
            if params.limit is not None:
                items = items[: params.limit]
            for key, idxs in items:
                sub = {p: [cols[p][i] for i in idxs] for p in params.properties}
                g = self._aggregate_cols(cd, sub, len(idxs), params)
                g["groupedBy"] = {"path": [prop], "value": key}
                out.append(g)
            return out
        return [self._aggregate_cols(cd, cols, count, params)]

    # -- column selection (filtered / near-restricted / full) ----------------

    def _columns(self, idx, params: AggregateParams) -> tuple[int, dict]:
        """-> (matching-row count, {prop: row-aligned raw values}) for every
        property the query references. Shards ship columns, not objects."""
        need = sorted(set(params.properties) | set(params.group_by or []))
        if (
            params.near_vector is not None
            or params.near_object is not None
            or params.near_text is not None
        ):
            if params.object_limit is None:
                raise AggregatorError("near<Media> aggregation requires objectLimit")
            if self.explorer is None:
                raise AggregatorError("no explorer wired for near* aggregation")
            from weaviate_tpu_torch.usecases.traverser import GetParams

            res = self.explorer.get_class(
                GetParams(
                    class_name=idx.class_name,
                    near_vector=params.near_vector,
                    near_object=params.near_object,
                    near_text=params.near_text,
                    filters=params.filters,
                    limit=params.object_limit,
                )
            )
            return len(res), {
                p: [r.obj.properties.get(p) for r in res] for p in need
            }
        # scatter-gather over ALL physical shards (remote included) so a
        # distributed class aggregates its full data set (index.go +
        # clusterapi :aggregations)
        data = idx.aggregate_columns(params.filters, need)
        return data["count"], data["cols"]

    # -- per-group aggregation ----------------------------------------------

    def _aggregate_cols(self, cd, cols: dict, count: int,
                        params: AggregateParams) -> dict:
        out: dict[str, Any] = {}
        if params.include_meta_count:
            out["meta"] = {"count": count}
        for prop_name, aggs in params.properties.items():
            prop = cd.get_property(prop_name)
            if prop is None:
                raise AggregatorError(f"unknown property {prop_name!r}")
            pt = prop.primitive_type()
            col = [v for v in cols.get(prop_name, []) if v is not None]
            # flatten array props
            if col and isinstance(col[0], list):
                col = [x for v in col for x in v]
            base = pt.base if pt is not None else None
            if base in (DataType.INT, DataType.NUMBER):
                out[prop_name] = self._numeric(col, aggs, base)
            elif base is DataType.BOOLEAN:
                out[prop_name] = self._boolean(col, aggs)
            elif base is DataType.DATE:
                out[prop_name] = self._date(col, aggs)
            else:
                out[prop_name] = self._text(col, aggs)
        return out

    def _numeric(self, col: list, aggs: list[str], base) -> dict:
        vals = np.asarray([float(v) for v in col], dtype=np.float64)
        res: dict[str, Any] = {}
        cast = int if base is DataType.INT else float
        for a in aggs:
            if a == "count":
                res[a] = int(vals.size)
            elif vals.size == 0:
                res[a] = None
            elif a == "minimum":
                res[a] = cast(vals.min())
            elif a == "maximum":
                res[a] = cast(vals.max())
            elif a == "mean":
                res[a] = float(vals.mean())
            elif a == "median":
                res[a] = float(np.median(vals))
            elif a == "sum":
                res[a] = cast(vals.sum())
            elif a == "mode":
                v, _ = CollCounter(vals.tolist()).most_common(1)[0]
                res[a] = cast(v)
            else:
                raise AggregatorError(f"unknown numeric aggregation {a!r}")
        return res

    def _boolean(self, col: list, aggs: list[str]) -> dict:
        n = len(col)
        t = sum(1 for v in col if bool(v))
        f = n - t
        res: dict[str, Any] = {}
        for a in aggs:
            if a == "count":
                res[a] = n
            elif a == "totalTrue":
                res[a] = t
            elif a == "totalFalse":
                res[a] = f
            elif a == "percentageTrue":
                res[a] = (t / n) if n else None
            elif a == "percentageFalse":
                res[a] = (f / n) if n else None
            else:
                raise AggregatorError(f"unknown boolean aggregation {a!r}")
        return res

    def _date(self, col: list, aggs: list[str]) -> dict:
        from weaviate_tpu_torch.inverted.analyzer import parse_date

        stamps = sorted(parse_date(v) for v in col)
        res: dict[str, Any] = {}
        for a in aggs:
            if a == "count":
                res[a] = len(stamps)
            elif not stamps:
                res[a] = None
            elif a == "minimum":
                res[a] = stamps[0].isoformat()
            elif a == "maximum":
                res[a] = stamps[-1].isoformat()
            elif a == "median":
                res[a] = stamps[len(stamps) // 2].isoformat()
            elif a == "mode":
                v, _ = CollCounter(s.isoformat() for s in stamps).most_common(1)[0]
                res[a] = v
            else:
                raise AggregatorError(f"unknown date aggregation {a!r}")
        return res

    def _text(self, col: list, aggs: list[str]) -> dict:
        res: dict[str, Any] = {}
        for a in aggs:
            if a == "count":
                res[a] = len(col)
            elif a == "type":
                res[a] = "text"
            elif a == "topOccurrences":
                res[a] = [
                    {"value": v, "occurs": c}
                    for v, c in CollCounter(str(x) for x in col).most_common(5)
                ]
            else:
                raise AggregatorError(f"unknown text aggregation {a!r}")
        return res
