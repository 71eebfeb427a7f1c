# The port's copy of weaviate_tpu/graphql/executor.py, its imports pointed at the port.
"""GraphQL executor: Get / Aggregate / Explore roots over the traverser.

Reference: adapters/handlers/graphql/local — get (class_builder_fields.go:229
makeResolveGetClass), aggregate, explore; the `where` grammar of
local/common_filters, `_additional` props (class_builder_fields.go:526-620),
and result->map conversion (usecases/traverser/explorer.go:338).
"""

from __future__ import annotations

from typing import Any, Optional


from weaviate_tpu_torch.entities.filters import LocalFilter
from weaviate_tpu_torch.graphql.parser import (
    EnumValue,
    Field,
    GraphQLParseError,
    InlineFragment,
    parse_query,
)
from weaviate_tpu_torch.monitoring import tracing
from weaviate_tpu_torch.serving import robustness
from weaviate_tpu_torch.usecases.aggregator import AggregateParams
from weaviate_tpu_torch.usecases.traverser import GetParams


def _plain(v: Any) -> Any:
    """EnumValue -> str, recursively (args arrive enum-typed from the parser)."""
    if isinstance(v, EnumValue):
        return v.name
    if isinstance(v, list):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return v


class GraphQLExecutor:
    def __init__(self, traverser, aggregator, schema_manager, db):
        self.traverser = traverser
        self.aggregator = aggregator
        self.schema = schema_manager
        self.db = db

    # -- entry ---------------------------------------------------------------

    def execute(self, query: str, variables: Optional[dict] = None) -> dict:
        try:
            op = parse_query(query, variables)
        except GraphQLParseError as e:
            return {"errors": [{"message": str(e)}]}
        data: dict[str, Any] = {}
        errors: list[dict] = []
        for sel in op.selections:
            if not isinstance(sel, Field):
                errors.append({"message": "fragments not allowed at root"})
                continue
            try:
                if sel.name == "Get":
                    data[sel.out_name] = self._exec_get(sel)
                elif sel.name == "Aggregate":
                    data[sel.out_name] = self._exec_aggregate(sel)
                elif sel.name == "Explore":
                    data[sel.out_name] = self._exec_explore(sel)
                elif sel.name == "__schema":
                    from weaviate_tpu_torch.graphql.introspection import (
                        build_introspection,
                        project_tree,
                    )

                    data[sel.out_name] = project_tree(
                        build_introspection(self.schema), sel.selections
                    )
                elif sel.name == "__type":
                    from weaviate_tpu_torch.graphql.introspection import (
                        find_type,
                        project_tree,
                    )

                    name = str(sel.args.get("name", ""))
                    data[sel.out_name] = project_tree(
                        find_type(self.schema, name), sel.selections
                    )
                else:
                    errors.append({"message": f"unknown root field {sel.name!r}"})
            except (robustness.DeadlineExceededError,
                    robustness.OverloadedError):
                # request-level lifecycle conditions, not per-field errors:
                # propagate so the REST layer maps them to 504 / 429 (+
                # Retry-After) instead of burying them in a 200 envelope
                raise
            except Exception as e:
                errors.append({"message": str(e), "path": [sel.name]})
        out: dict[str, Any] = {"data": data}
        if errors:
            out["errors"] = errors
        return out

    # -- Get -----------------------------------------------------------------

    # Get args the executor itself understands; module near-args are added
    # per enabled provider (class_builder_fields.go:210-233 arg surface)
    _GET_ARGS = frozenset({
        "where", "nearVector", "nearObject", "bm25", "hybrid", "group",
        "groupBy", "sort", "limit", "offset", "after", "ask",
        "consistencyLevel",
    })
    _BUILTIN_ADDITIONAL = frozenset({
        "id", "vector", "certainty", "distance", "score", "explainScore",
        "creationTimeUnix", "lastUpdateTimeUnix", "classification",
        "isConsistent", "group",
    })

    def _validate_get_class(self, class_field: Field) -> None:
        """Schema validation the reference gets from its generated GraphQL
        schema (class_builder_fields.go): unknown args, unknown properties,
        and unknown _additional props are errors, not silent nulls."""
        resolved = self.schema.resolve_class_name(class_field.name)
        cd = self.schema.get_class(resolved) if resolved else None
        if cd is None:
            raise GraphQLParseError(f"class {class_field.name!r} not found")
        provider = self._module_provider()
        args_ok = set(self._GET_ARGS)
        add_ok = set(self._BUILTIN_ADDITIONAL)
        if provider is not None:
            args_ok.update(provider.graphql_arguments())
            add_ok.update(provider.additional_properties())
        for a in class_field.args:
            if a not in args_ok:
                raise GraphQLParseError(
                    f"unknown argument {a!r} on Get.{class_field.name}")
        props = {p.name for p in cd.properties}
        for s in class_field.selections:
            if not isinstance(s, Field):
                continue
            if s.name == "_additional":
                for sub in s.selections:
                    if isinstance(sub, Field) and sub.name not in add_ok:
                        raise GraphQLParseError(
                            f"unknown _additional prop {sub.name!r}")
            elif s.name not in props:
                raise GraphQLParseError(
                    f"class {class_field.name!r} has no property {s.name!r}")

    def _exec_get(self, root: Field) -> dict:
        out = {}
        for class_field in root.selections:
            if not isinstance(class_field, Field):
                raise GraphQLParseError("expected class field under Get")
            # one span per Get class: a multi-class query's trace shows
            # which class the time went to, not one opaque "graphql" blob
            # the tenant rides the same contextvar plumbing as the
            # deadline; tagging the span here keeps multi-class queries'
            # per-class time attributable per tenant in the slow-query log
            with tracing.span(
                    "graphql.get", class_name=class_field.name,
                    tenant=robustness.effective_tenant(class_field.name)):
                self._validate_get_class(class_field)
                params = self._get_params(class_field)
                results = self.traverser.get_class(params)
                self._resolve_module_additionals(class_field, params, results)
                self._resolve_is_consistent(class_field, params, results)
                # per-query ref cache (refcache/ role): N results pointing
                # at the same referenced object hit storage once, not N
                # times
                ref_cache: dict[str, object] = {}
                out[class_field.out_name] = [
                    self._project(r, class_field.selections, params,
                                  ref_cache)
                    for r in results
                ]
        return out

    def _module_provider(self):
        return getattr(getattr(self.traverser, "explorer", None), "modules", None)

    def _resolve_is_consistent(self, class_field: Field, params: GetParams,
                               results) -> None:
        """Batch isConsistent resolution (finder.go CheckConsistency):
        resolve the class once and fan the per-row digest probes out in
        parallel — the per-row sequential form costs N_results x N_replicas
        network roundtrips."""
        wanted = any(
            isinstance(sel, Field) and sel.name == "_additional"
            and any(isinstance(x, Field) and x.name == "isConsistent"
                    for x in sel.selections)
            for sel in class_field.selections
        )
        if not wanted or not results:
            return
        resolved = self.schema.resolve_class_name(params.class_name)
        cidx = self.db.get_index(resolved) if resolved else None
        if cidx is None or cidx.finder is None:
            return  # _additional defaults isConsistent to True
        verdicts = cidx.are_consistent(
            [(r.obj.uuid, r.obj.last_update_time_unix) for r in results])
        for r, v in zip(results, verdicts):
            r.additional["isConsistent"] = v

    def _resolve_module_additionals(self, class_field: Field, params: GetParams,
                                    results) -> None:
        """Batch-resolve module-provided _additional props (answer, generate,
        summary, tokens, spellCheck, ...) once per query and attach the
        per-result payloads (modulecapabilities/additional.go dispatch)."""
        provider = self._module_provider()
        if provider is None or not results:
            return
        module_props = set(provider.additional_properties())
        if not module_props:
            return
        class_def = self.schema.get_class(params.class_name)
        for sel in class_field.selections:
            if not (isinstance(sel, Field) and sel.name == "_additional"):
                continue
            for sub in sel.selections:
                if not isinstance(sub, Field) or sub.name not in module_props:
                    continue
                if sub.name == "answer":
                    prop_params = _plain(params.ask) if params.ask else {}
                elif sub.name == "semanticPath":
                    # sempath/builder.go: the path starts at the nearText
                    # query concepts, so the resolver needs them
                    prop_params = {k: _plain(v) for k, v in sub.args.items()}
                    prop_params["near_text"] = _plain(params.near_text) if params.near_text else None
                elif sub.name == "spellCheck":
                    concepts = (params.near_text or {}).get("concepts") or []
                    if isinstance(concepts, str):
                        concepts = [concepts]
                    prop_params = {"text": " ".join(str(c) for c in concepts)}
                else:
                    prop_params = {k: _plain(v) for k, v in sub.args.items()}
                values = provider.resolve_additional(
                    sub.name, results, prop_params, class_def=class_def)
                for r, v in zip(results, values):
                    r.additional[sub.name] = v

    def _get_params(self, f: Field) -> GetParams:
        a = {k: _plain(v) for k, v in f.args.items()}
        where = a.get("where")
        needs_vector = self._selection_wants_vector(f.selections)
        params = GetParams(
            class_name=f.name,
            filters=LocalFilter.from_dict(self._convert_where(where)) if where else None,
            near_vector=a.get("nearVector"),
            near_object=a.get("nearObject"),
            near_text=a.get("nearText"),
            near_image=a.get("nearImage"),
            ask=a.get("ask"),
            keyword_ranking=a.get("bm25"),
            hybrid=a.get("hybrid"),
            sort=self._as_list(a.get("sort")),
            group=a.get("group"),
            group_by=a.get("groupBy"),
            limit=int(a.get("limit", 0) or 0),  # 0 => traverser's query_limit
            offset=int(a.get("offset", 0) or 0),
            after=a.get("after"),
            include_vector=needs_vector,
            consistency_level=(a.get("consistencyLevel") or None),
        )
        if params.keyword_ranking is not None:
            params.keyword_ranking = dict(params.keyword_ranking)
            params.keyword_ranking.setdefault("query", "")
        return params

    @staticmethod
    def _as_list(v):
        if v is None:
            return []
        return v if isinstance(v, list) else [v]

    def _convert_where(self, w: dict) -> dict:
        """GraphQL where arg -> entities.filters dict (same keys; nested
        operands recursed; enum operator already plain)."""
        out = dict(w)
        if "operands" in out and out["operands"]:
            out["operands"] = [self._convert_where(o) for o in out["operands"]]
        return out

    # _additional props whose module resolvers need the result vectors
    # (explain.py: neighbors/path/interpretation/projection all score
    # against the object embedding)
    _VECTOR_HUNGRY_PROPS = frozenset(
        {"vector", "featureProjection", "nearestNeighbors", "semanticPath",
         "interpretation"})

    def _selection_wants_vector(self, sels: list) -> bool:
        for s in sels:
            if isinstance(s, Field) and s.name == "_additional":
                for sub in s.selections:
                    if isinstance(sub, Field) and sub.name in self._VECTOR_HUNGRY_PROPS:
                        return True
        return False

    # -- result projection ---------------------------------------------------

    def _project(self, r, sels: list, params: GetParams,
                 ref_cache: Optional[dict] = None) -> dict:
        obj = r.obj
        row: dict[str, Any] = {}
        for s in sels:
            if isinstance(s, InlineFragment):
                continue
            if s.name == "_additional":
                row[s.out_name] = self._additional(r, s.selections, params)
                continue
            value = obj.properties.get(s.name)
            if s.selections and isinstance(value, list):
                # cross-reference: resolve beacons via inline fragments
                row[s.out_name] = self._resolve_refs(value, s.selections, ref_cache)
            elif s.selections and isinstance(value, dict):
                row[s.out_name] = {
                    sub.out_name: value.get(sub.name)
                    for sub in s.selections
                    if isinstance(sub, Field)
                }
            else:
                row[s.out_name] = value
        return row

    def _resolve_refs(self, beacons: list, sels: list,
                      ref_cache: Optional[dict] = None) -> list:
        out = []
        frags = [s for s in sels if isinstance(s, InlineFragment)]
        for b in beacons:
            beacon = b.get("beacon") if isinstance(b, dict) else None
            if beacon is None:
                continue
            if ref_cache is not None and beacon in ref_cache:
                obj = ref_cache[beacon]
                if obj is None:
                    continue
                self._project_ref(obj, frags, out)
                continue
            parts = beacon.split("weaviate://")[-1].split("/")
            # host/Class/uuid or host/uuid (legacy)
            target_class = parts[1] if len(parts) >= 3 else None
            target_uuid = parts[-1]
            obj, idx = (None, None)
            if target_class:
                tidx = self.db.get_index(target_class)
                if tidx is not None:
                    obj = tidx.object_by_uuid(target_uuid, include_vector=False)
            else:
                obj, idx = self.db.object_by_uuid_any_class(target_uuid, False)
            if ref_cache is not None:
                ref_cache[beacon] = obj
            if obj is None:
                continue
            self._project_ref(obj, frags, out)
        return out

    @staticmethod
    def _project_ref(obj, frags, out: list) -> None:
        for frag in frags:
            if frag.type_name == obj.class_name:
                row = {
                    sub.out_name: obj.properties.get(sub.name)
                    for sub in frag.selections
                    if isinstance(sub, Field) and sub.name != "_additional"
                }
                for sub in frag.selections:
                    if isinstance(sub, Field) and sub.name == "_additional":
                        row[sub.out_name] = {"id": obj.uuid}
                out.append(row)

    def _additional(self, r, sels: list, params: GetParams) -> dict:
        obj = r.obj
        add: dict[str, Any] = {}
        for s in sels:
            if not isinstance(s, Field):
                continue
            n = s.name
            if n == "id":
                add[s.out_name] = obj.uuid
            elif n == "vector":
                add[s.out_name] = (
                    [float(x) for x in obj.vector] if obj.vector is not None else None
                )
            elif n == "distance":
                add[s.out_name] = r.distance
            elif n == "certainty":
                add[s.out_name] = (
                    r.certainty
                    if r.certainty is not None
                    else (
                        max(0.0, 1.0 - r.distance / 2.0)
                        if r.distance is not None and self._is_cosine(params.class_name)
                        else None
                    )
                )
            elif n == "score":
                add[s.out_name] = None if r.score is None else str(r.score)
            elif n == "explainScore":
                add[s.out_name] = r.explain_score
            elif n == "creationTimeUnix":
                add[s.out_name] = str(obj.creation_time_unix)
            elif n == "lastUpdateTimeUnix":
                add[s.out_name] = str(obj.last_update_time_unix)
            elif n == "group":
                add[s.out_name] = r.additional.get("group")
            elif n == "classification":
                # stamped at classification time (usecases/classification.py
                # _class_meta; entities/additional/classification.go shape),
                # projected to the selected subfields with aliases honored
                payload = (obj.meta or {}).get("classification")
                subs = [x for x in s.selections if isinstance(x, Field)]
                if payload is not None and subs:
                    payload = {x.out_name: payload.get(x.name) for x in subs}
                add[s.out_name] = payload
            elif n == "isConsistent":
                # batch-resolved once per query (_resolve_is_consistent)
                add[s.out_name] = r.additional.get("isConsistent", True)
            else:
                add[s.out_name] = r.additional.get(n)
        return add

    def _is_cosine(self, class_name: str) -> bool:
        resolved = self.schema.resolve_class_name(class_name)
        idx = self.db.get_index(resolved) if resolved else None
        return idx is not None and idx.vector_config.distance == "cosine"

    # -- Aggregate -----------------------------------------------------------

    _AGGREGATE_ARGS = frozenset({
        "where", "nearVector", "nearObject", "objectLimit", "groupBy", "limit",
    })
    # module near-args AggregateParams can actually execute; intersected
    # with the provider's contributed args so Get/Aggregate share one
    # source of truth without claiming support Aggregate lacks
    _AGGREGATE_MODULE_ARGS = frozenset({"nearText"})

    def _exec_aggregate(self, root: Field) -> dict:
        out = {}
        for class_field in root.selections:
            if not isinstance(class_field, Field):
                continue
            resolved_name = self.schema.resolve_class_name(class_field.name)
            cd = self.schema.get_class(resolved_name) if resolved_name else None
            if cd is None:
                raise GraphQLParseError(f"class {class_field.name!r} not found")
            props_ok = {p.name for p in cd.properties} | {"meta", "groupedBy"}
            args_ok = set(self._AGGREGATE_ARGS)
            provider = self._module_provider()
            if provider is not None:
                args_ok.update(
                    set(provider.graphql_arguments()) & self._AGGREGATE_MODULE_ARGS)
            for arg in class_field.args:
                if arg not in args_ok:
                    raise GraphQLParseError(
                        f"unknown argument {arg!r} on Aggregate.{class_field.name}")
            for s in class_field.selections:
                if isinstance(s, Field) and s.name not in props_ok:
                    raise GraphQLParseError(
                        f"class {class_field.name!r} has no property {s.name!r}")
            a = {k: _plain(v) for k, v in class_field.args.items()}
            prop_aggs: dict[str, list[str]] = {}
            include_meta = False
            group_by_sel = False
            for s in class_field.selections:
                if not isinstance(s, Field):
                    continue
                if s.name == "meta":
                    include_meta = True
                elif s.name == "groupedBy":
                    group_by_sel = True
                else:
                    prop_aggs[s.name] = [
                        sub.name for sub in s.selections if isinstance(sub, Field)
                    ]
            gb = a.get("groupBy")
            params = AggregateParams(
                class_name=class_field.name,
                filters=(
                    LocalFilter.from_dict(self._convert_where(a["where"]))
                    if a.get("where")
                    else None
                ),
                near_vector=a.get("nearVector"),
                near_object=a.get("nearObject"),
                near_text=a.get("nearText"),
                object_limit=a.get("objectLimit"),
                group_by=self._as_list(gb) if gb else None,
                properties=prop_aggs,
                include_meta_count=include_meta,
                limit=a.get("limit"),
            )
            groups = self.aggregator.aggregate(params)
            rows = []
            for g in groups:
                row = dict(g)
                if not group_by_sel:
                    row.pop("groupedBy", None)
                rows.append(row)
            out[class_field.out_name] = rows
        return out

    # -- Explore -------------------------------------------------------------

    def _exec_explore(self, root: Field) -> list[dict]:
        a = {k: _plain(v) for k, v in root.args.items()}
        hits = self.traverser.explorer.explore(
            near_vector=a.get("nearVector"),
            near_object=a.get("nearObject"),
            near_text=a.get("nearText"),
            limit=int(a.get("limit", 25) or 25),
        )
        wanted = [s.name for s in root.selections if isinstance(s, Field)]
        return [{k: h.get(k) for k in wanted} for h in hits]
