# The port's copy of weaviate_tpu/usecases/traverser.py, its imports pointed at the port.
"""Traverser: query orchestration — GetClass, Explore, hybrid, grouping.

Reference: usecases/traverser — Traverser.GetClass (traverser_get.go:23,
gated by MAXIMUM_CONCURRENT_GET_REQUESTS), Explorer dispatch keyword vs
vector vs list (explorer.go:108-139), hybrid (explorer.go:227 +
hybrid/searcher.go), near-params -> vector resolution via modules
(near_params_vector.go), CrossClassVectorSearch (explorer.go:492), result ->
map conversion (explorer.go:338), grouper (usecases/traverser/grouper).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np

from weaviate_tpu_torch.db.shard import SearchResult
from weaviate_tpu_torch.entities.filters import LocalFilter
from weaviate_tpu_torch.entities.vectorindex import DISTANCE_COSINE
from weaviate_tpu_torch.monitoring import tracing
from weaviate_tpu_torch.serving import robustness
from weaviate_tpu_torch.usecases import hybrid as hybrid_mod


class TraverserError(ValueError):
    pass


@dataclass
class GetParams:
    """traverser.GetParams analog (the full Get arg surface)."""

    class_name: str
    properties: list[str] = field(default_factory=list)
    filters: Optional[LocalFilter] = None
    near_vector: Optional[dict] = None       # {vector, certainty?, distance?}
    near_object: Optional[dict] = None       # {id|beacon, certainty?, distance?}
    near_text: Optional[dict] = None         # module-resolved {concepts, ...}
    near_image: Optional[dict] = None         # module-resolved {image: b64}
    ask: Optional[dict] = None                # qna module {question, properties}
    keyword_ranking: Optional[dict] = None   # {query, properties?}
    hybrid: Optional[dict] = None            # {query, alpha?, vector?, fusionType?}
    sort: list[dict] = field(default_factory=list)  # [{path, order}]
    group: Optional[dict] = None             # {type: closest|merge, force}
    group_by: Optional[dict] = None          # {path, groups, objectsPerGroup}
    limit: int = 25
    offset: int = 0
    after: Optional[str] = None
    additional: dict = field(default_factory=dict)
    include_vector: bool = False
    consistency_level: Optional[str] = None


class Traverser:
    """Rate-limited facade (traverser_get.go:23)."""

    def __init__(self, explorer, max_concurrent: int = 0):
        self.explorer = explorer
        self._gate = threading.Semaphore(max_concurrent) if max_concurrent > 0 else None

    def get_class(self, params: GetParams) -> list[SearchResult]:
        # the span context propagates from here via contextvars into the
        # coalescer lane (submit captures the active span) and into the
        # shard's dispatch record on the direct path; the request DEADLINE
        # rides its own contextvar the same way (serving/robustness.py)
        with tracing.span("traverser.get_class",
                          class_name=params.class_name):
            robustness.check_deadline("traverser")
            if self._gate is not None:
                # the concurrency gate is deadline-bounded: a request that
                # can't get a permit inside its budget fails fast instead
                # of occupying the accept queue until it times out anyway
                timeout = robustness.remaining_s()
                acquired = (self._gate.acquire() if timeout is None
                            else self._gate.acquire(timeout=timeout))
                if not acquired:
                    robustness.count_deadline("traverser.gate")
                    raise robustness.DeadlineExceededError(
                        "deadline expired waiting for the concurrent-GET "
                        "gate")
                try:
                    return self.explorer.get_class(params)
                finally:
                    self._gate.release()
            return self.explorer.get_class(params)

    def get_class_batched(
        self, params_list: Sequence[GetParams]
    ) -> "list[list[SearchResult] | Exception]":
        """Cross-query batched entry (TPU extension): nearVector queries of
        the same class ride one device dispatch.

        Per-slot error isolation: a slot whose query failed holds the
        Exception instead of a result list (callers check isinstance) — one
        bad query must not fail the whole device batch."""
        with tracing.span("traverser.get_class_batched",
                          slots=len(params_list)):
            robustness.check_deadline("traverser")
            return self.explorer.get_class_batched(params_list)


class Explorer:
    def __init__(self, db, schema_manager, modules=None, query_limit: int = 25,
                 max_results: int = 10000, coalescer=None):
        self.db = db
        self.schema = schema_manager
        self.modules = modules
        self.query_limit = query_limit
        self.max_results = max_results
        # cross-request micro-batching (serving/coalescer.py); None => every
        # dispatch below is the direct path, untouched
        self.coalescer = coalescer

    # -- cross-request coalescing (serving/coalescer.py) ---------------------

    def _coalesce_submit(self, idx, vecs: np.ndarray, k: int, flt,
                         include_vector: bool):
        """Admission-queue a request's rows for a coalesced device dispatch.
        -> blocking finalize() (same contract as object_vector_search_async's
        `done`) or None => the caller uses the direct path. Only the
        single-local-shard layout coalesces: multi-shard/remote fan-out
        already runs per-shard batches on the pool. The tenant identity is
        resolved HERE (explicit X-Tenant-Id riding the contextvar, else
        the queried class name) so the coalescer's weighted-fair
        admission accounts the request to the right budget."""
        co = self.coalescer
        if co is None:
            return None
        shard = getattr(idx, "single_local_shard", lambda: None)()
        if shard is None:
            co.record_bypass("multi_shard")
            return None
        return co.submit(shard, vecs, k, flt=flt,
                         include_vector=include_vector,
                         tenant=robustness.effective_tenant(idx.class_name))

    # -- vector resolution (near_params_vector.go) ---------------------------

    def _autocorrected_near_text(self, nt: dict) -> dict:
        """nearText {autocorrect: true}: run the concepts through the
        enabled TextTransformer (text-spellcheck's autocorrect,
        texttransformer.go) before embedding."""
        if not nt.get("autocorrect"):
            return nt
        if self.modules is None or not self.modules.has_text_transformer():
            # the reference only exposes the arg when the module exists —
            # silently skipping correction would misreport zero hits
            raise TraverserError(
                "autocorrect requires a text transformer module "
                "(text-spellcheck)")
        concepts = nt.get("concepts") or []
        if isinstance(concepts, str):
            concepts = [concepts]
        # flag cleared in the output: callers that pre-transform (explore's
        # once-before-the-loop) must not re-correct per class
        return {**nt, "concepts": self.modules.transform_text(concepts),
                "autocorrect": False}

    def _autocorrected_bm25(self, kw: dict) -> dict:
        """bm25 {autocorrect: true}: correct the query string before term
        matching."""
        if not kw.get("autocorrect"):
            return kw
        if self.modules is None or not self.modules.has_text_transformer():
            raise TraverserError(
                "autocorrect requires a text transformer module "
                "(text-spellcheck)")
        return {**kw, "query": self.modules.transform_text([kw.get("query", "")])[0]}

    def _resolve_vector(self, params: GetParams, idx) -> Optional[np.ndarray]:
        nv = params.near_vector
        if nv is not None and nv.get("vector") is not None:
            return np.asarray(nv["vector"], dtype=np.float32)
        no = params.near_object
        if no is not None:
            target = no.get("id") or (no.get("beacon") or "").split("/")[-1]
            if not target:
                raise TraverserError("nearObject needs id or beacon")
            obj = idx.object_by_uuid(target, include_vector=True)
            if obj is None or obj.vector is None:
                raise TraverserError(f"nearObject: object {target} has no vector")
            return obj.vector
        nt = params.near_text
        if nt is not None:
            if self.modules is None:
                raise TraverserError("nearText requires a vectorizer module")
            cd = self.schema.get_class(idx.class_name)
            nt = self._autocorrected_near_text(nt)
            vec = self.modules.vectorize_query(cd, nt)
            if vec is None:
                raise TraverserError("nearText: vectorizer returned no vector")
            return np.asarray(vec, dtype=np.float32)
        ni = params.near_image
        if ni is not None:
            if self.modules is None:
                raise TraverserError("nearImage requires an image vectorizer module")
            cd = self.schema.get_class(idx.class_name)
            return self.modules.vectorize_image_query(cd, ni)
        ask = params.ask
        if ask is not None and ask.get("question"):
            # Ask retrieval (qna module semantics): the question is embedded
            # like a nearText concept so answers come from relevant objects
            if self.modules is None:
                raise TraverserError("ask requires a vectorizer module")
            cd = self.schema.get_class(idx.class_name)
            vec = self.modules.vectorize_query(cd, {"concepts": [ask["question"]]})
            return np.asarray(vec, dtype=np.float32)
        return None

    def _near_threshold(self, params: GetParams, idx) -> Optional[float]:
        """certainty/distance -> target distance. certainty is defined only
        for cosine (d = 2(1-c)); the reference rejects it elsewhere."""
        src = (params.near_vector or params.near_object or params.near_text
               or params.near_image or {})
        if src.get("distance") is not None:
            return float(src["distance"])
        if src.get("certainty") is not None:
            if idx is not None and idx.vector_config.distance != DISTANCE_COSINE:
                raise TraverserError(
                    "certainty is only valid for distance 'cosine'; use 'distance'"
                )
            c = float(src["certainty"])
            return 2.0 * (1.0 - c)
        return None

    # -- dispatch (explorer.go:108-139) --------------------------------------

    def get_class(self, params: GetParams) -> list[SearchResult]:
        res = self.get_class_batched([params])[0]
        if isinstance(res, Exception):
            raise res
        return res

    def get_class_batched(
        self, params_list: Sequence[GetParams]
    ) -> list[list[SearchResult] | Exception]:
        """Cross-query batched Get with per-query error isolation: a failed
        slot holds the Exception instead of results (callers surface it as
        that query's error; the other slots are unaffected)."""
        out: list[Optional[list[SearchResult] | Exception]] = [None] * len(params_list)
        batchable: dict[tuple, list[int]] = {}
        # plain-BM25 slots: one device matmul per (class, limit, offset,
        # properties) group when the class serves device BM25 on a single
        # local shard (ClassIndex.keyword_search_batch); ineligible layouts
        # fall back to the per-query path below
        kw_batchable: dict[tuple, list[int]] = {}
        # hybrid slots: BOTH legs batch — Q hybrid queries ride one keyword
        # matmul + one dense kNN dispatch instead of 2Q device calls;
        # fusion stays host-side per slot (alpha/fusionType vary freely)
        hyb_batchable: dict[tuple, list[int]] = {}
        for i, p in enumerate(params_list):
            try:
                limit = p.limit or self.query_limit
                if limit + p.offset > self.max_results:
                    raise TraverserError(
                        f"limit+offset ({limit + p.offset}) exceeds QUERY_MAXIMUM_RESULTS ({self.max_results})"
                    )
                if (
                    p.near_vector is not None
                    and p.near_vector.get("vector") is not None
                    and not (p.hybrid or p.keyword_ranking or p.group_by or p.group or p.sort)
                    and p.filters is None
                    and p.near_vector.get("distance") is None
                    and p.near_vector.get("certainty") is None
                ):
                    key = (p.class_name, limit, p.offset, p.include_vector)
                    batchable.setdefault(key, []).append(i)
                elif (
                    p.keyword_ranking is not None
                    and p.keyword_ranking.get("query")
                    and not p.keyword_ranking.get("autocorrect")
                    and not p.keyword_ranking.get("additionalExplanations")
                    and not (p.hybrid or p.near_vector or p.group_by
                             or p.group or p.sort or p.after)
                    and p.filters is None
                ):
                    props = tuple(p.keyword_ranking.get("properties") or ())
                    kkey = (p.class_name, limit, p.offset, props,
                            p.include_vector)
                    kw_batchable.setdefault(kkey, []).append(i)
                elif (
                    p.hybrid is not None
                    and (p.hybrid.get("query")
                         or p.hybrid.get("vector") is not None)
                    and not (p.near_vector or p.keyword_ranking or p.group_by
                             or p.group or p.sort or p.after)
                    and p.filters is None
                ):
                    props = tuple(p.hybrid.get("properties") or ())
                    hkey = (p.class_name, limit, p.offset, props,
                            p.include_vector)
                    hyb_batchable.setdefault(hkey, []).append(i)
                else:
                    out[i] = self._get_one(p)
            except Exception as e:
                out[i] = e
        # two-phase: enqueue every group's device dispatch first, THEN
        # finalize — groups (and concurrent requests) overlap device compute
        # with hydration instead of serializing. The keyword lane (which
        # blocks on its own fetch) runs BETWEEN enqueue and finalize, so a
        # mixed keyword+vector batch overlaps the keyword matmul with the
        # in-flight vector dispatches instead of serializing two round trips.
        pending: list[tuple] = []
        for (class_name, limit, offset, inc_vec), idxs in batchable.items():
            try:
                idx = self._index(class_name)
                vecs = np.stack(
                    [np.asarray(params_list[i].near_vector["vector"], np.float32) for i in idxs]
                )
                # coalescer first: a narrow group (the gRPC single-Search /
                # REST shape) merges with other in-flight requests into one
                # padded dispatch; wide groups bypass inside submit()
                done = self._coalesce_submit(
                    idx, vecs, limit + offset, None, inc_vec)
                if done is None:
                    if hasattr(idx, "object_vector_search_async"):
                        done = idx.object_vector_search_async(
                            vecs, limit + offset, include_vector=inc_vec)
                    else:
                        res = idx.object_vector_search(
                            vecs, limit + offset, include_vector=inc_vec)
                        done = (lambda res=res: res)
                pending.append((idxs, offset, done))
            except (robustness.DeadlineExceededError,
                    robustness.OverloadedError) as e:
                # shed/expired at admission: fail the whole group fast —
                # per-slot retries would hammer the same full queue
                for i in idxs:
                    out[i] = e
            except Exception:
                # ragged shapes or a bad class: isolate per query
                for i in idxs:
                    try:
                        out[i] = self._get_one(params_list[i])
                    except Exception as e2:
                        out[i] = e2
        for (class_name, limit, offset, props, inc_vec), idxs in kw_batchable.items():
            res = None
            try:
                idx = self._index(class_name)
                res = idx.keyword_search_batch(
                    [params_list[i].keyword_ranking["query"] for i in idxs],
                    limit, offset=offset, properties=list(props) or None,
                    include_vector=inc_vec)
            except Exception:
                res = None  # fall through to the per-query path
            for j, i in enumerate(idxs):
                try:
                    if res is not None:
                        out[i] = self._postprocess(params_list[i], res[j])
                    else:
                        out[i] = self._get_one(params_list[i])
                except Exception as e2:
                    out[i] = e2
        for (class_name, limit, offset, props, inc_vec), idxs in hyb_batchable.items():
            try:
                self._hybrid_group(out, params_list, idxs, class_name, limit,
                                   offset, list(props) or None, inc_vec)
            except Exception:
                for i in idxs:
                    try:
                        out[i] = self._get_one(params_list[i])
                    except Exception as e2:
                        out[i] = e2
        for idxs, offset, done in pending:
            try:
                res = done()
                for j, i in enumerate(idxs):
                    out[i] = self._postprocess(params_list[i], res[j][offset:])
            except (robustness.DeadlineExceededError,
                    robustness.OverloadedError) as e:
                # fail fast per slot — no direct-path retry (see _get_one)
                for i in idxs:
                    out[i] = e
            except Exception:
                for i in idxs:
                    try:
                        out[i] = self._get_one(params_list[i])
                    except Exception as e2:
                        out[i] = e2
        return out  # type: ignore[return-value]

    def _index(self, class_name: str):
        resolved = self.schema.resolve_class_name(class_name)
        idx = self.db.get_index(resolved) if resolved else None
        if idx is None:
            raise TraverserError(f"class {class_name!r} not found")
        return idx

    def _get_one(self, params: GetParams) -> list[SearchResult]:
        idx = self._index(params.class_name)
        limit = params.limit or self.query_limit
        if limit + params.offset > self.max_results:
            raise TraverserError(
                f"limit+offset ({limit + params.offset}) exceeds QUERY_MAXIMUM_RESULTS ({self.max_results})"
            )
        # grouping needs result vectors even if the caller didn't ask for them
        inc_vec = params.include_vector or params.group is not None
        if params.hybrid is not None:
            res = self._hybrid(params, idx, limit, inc_vec)
        elif params.keyword_ranking is not None:
            res = idx.object_search(
                limit,
                flt=params.filters,
                keyword_ranking=self._autocorrected_bm25(params.keyword_ranking),
                offset=params.offset,
                include_vector=inc_vec,
            )
        else:
            vec = self._resolve_vector(params, idx)
            if vec is not None:
                target = self._near_threshold(params, idx)
                res = None
                if target is None:
                    # coalesce single kNN queries cross-request; filtered
                    # queries lane per filter SIGNATURE (a shared filter
                    # coalesces, a one-off allowList bypasses inside
                    # submit). target-distance queries stay direct — their
                    # iterative widening can't share a fixed-k dispatch.
                    wait = self._coalesce_submit(
                        idx, np.asarray(vec, np.float32)[None, :],
                        limit + params.offset, params.filters, inc_vec)
                    if wait is not None:
                        try:
                            res = wait()[0][params.offset:]
                        except (robustness.DeadlineExceededError,
                                robustness.OverloadedError):
                            # fail-fast classes by contract: the budget is
                            # spent / the server shed this request — a
                            # direct-path retry would defeat both
                            raise
                        except Exception as ce:  # noqa: BLE001 — dead batch:
                            res = None     # re-run on the direct path
                            # the retry is invisible in aggregate metrics
                            # (the direct dispatch records its own spans);
                            # mark the trace so a slow query explains the
                            # doubled device work
                            tracing.annotate_current(
                                "coalescer_retry_direct",
                                f"{type(ce).__name__}: {ce}")
                if res is None:
                    res = idx.object_vector_search(
                        vec,
                        limit + params.offset,
                        flt=params.filters,
                        target_distance=target,
                        include_vector=inc_vec,
                    )[0][params.offset :]
            else:
                # sort pushdown: shards order doc ids via the LSM-backed
                # sorter and hydrate only the requested page
                res = idx.object_search(
                    limit,
                    flt=params.filters,
                    offset=params.offset,
                    include_vector=inc_vec,
                    cursor_after=params.after,
                    sort=params.sort or None,
                )
                return self._postprocess(params, res, skip_sort=bool(params.sort))
        return self._postprocess(params, res)

    def _hybrid_group(self, out, params_list, idxs, class_name, limit,
                      offset, props, inc_vec) -> None:
        """Batched hybrid: one keyword matmul + one dense kNN dispatch for
        a group of same-class hybrid slots, fused host-side per slot with
        each slot's own alpha/fusionType — semantics identical to
        _hybrid() run per slot (same fetch oversampling, same leg
        skipping at alpha 0/1)."""
        idx = self._index(class_name)
        fetch = max(limit * 4, 100)
        slots = [params_list[i] for i in idxs]
        alphas = [float(s.hybrid.get("alpha", 0.75)) for s in slots]
        queries = [s.hybrid.get("query") or "" for s in slots]
        cd = self.schema.get_class(idx.class_name) \
            if self.modules is not None else None
        vecs: list = []
        for s, a, q in zip(slots, alphas, queries):
            v = s.hybrid.get("vector")
            if v is None and a > 0 and q and self.modules is not None:
                v = self.modules.vectorize_query(cd, {"concepts": [q]})
            vecs.append(v if a > 0 else None)

        # dense leg ENQUEUED FIRST (async when the index supports it) so
        # its device round trip overlaps the sparse matmul below — the two
        # legs are independent, same two-phase idea as the pure-dense lane
        dense_lists: list[list] = [[] for _ in slots]
        dn = [j for j in range(len(slots)) if vecs[j] is not None]
        dense_done = None
        if dn:
            dvecs = np.stack([np.asarray(vecs[j], np.float32) for j in dn])
            if hasattr(idx, "object_vector_search_async"):
                dense_done = idx.object_vector_search_async(
                    dvecs, fetch, include_vector=inc_vec)
            else:
                dres = idx.object_vector_search(
                    dvecs, fetch, include_vector=inc_vec)
                dense_done = (lambda dres=dres: dres)

        sparse_lists: list[list] = [[] for _ in slots]
        sp = [j for j in range(len(slots)) if alphas[j] < 1 and queries[j]]
        if sp:
            res_kw = idx.keyword_search_batch(
                [queries[j] for j in sp], fetch, properties=props,
                include_vector=inc_vec)
            if res_kw is not None:
                for j, r in zip(sp, res_kw):
                    sparse_lists[j] = r
            else:  # no device engine: per-slot host keyword (dense leg
                   # above still batches)
                for j in sp:
                    sparse_lists[j] = idx.object_search(
                        fetch, keyword_ranking={
                            "query": queries[j], "properties": props},
                        include_vector=inc_vec)

        if dense_done is not None:
            for j, r in zip(dn, dense_done()):
                dense_lists[j] = r

        for j, i in enumerate(idxs):
            # per-slot isolation AFTER the device work: one slot failing in
            # fusion/postprocess must not discard the whole group's results
            # and re-pay 2Q dispatches through the per-query fallback
            try:
                s = slots[j]
                fused = hybrid_mod.fuse(sparse_lists[j], dense_lists[j],
                                        alphas[j], s.hybrid.get("fusionType"))
                out[i] = self._postprocess(s, fused[offset:offset + limit])
            except Exception as e:  # noqa: BLE001
                out[i] = e

    # -- hybrid (explorer.go:227, hybrid/searcher.go) ------------------------

    def _hybrid(
        self, params: GetParams, idx, limit: int, include_vector: bool | None = None
    ) -> list[SearchResult]:
        h = params.hybrid
        if include_vector is None:
            include_vector = params.include_vector
        alpha = float(h.get("alpha", 0.75))
        query = h.get("query") or ""
        fetch = max(limit * 4, 100)  # oversample both legs before fusion
        sparse: list[SearchResult] = []
        dense: list[SearchResult] = []
        if alpha < 1 and query:
            sparse = idx.object_search(
                fetch,
                flt=params.filters,
                keyword_ranking={"query": query, "properties": h.get("properties")},
                include_vector=include_vector,
            )
        if alpha > 0:
            vec = h.get("vector")
            if vec is None and query:
                if self.modules is not None:
                    cd = self.schema.get_class(idx.class_name)
                    vec = self.modules.vectorize_query(cd, {"concepts": [query]})
            if vec is not None:
                dense = idx.object_vector_search(
                    np.asarray(vec, dtype=np.float32),
                    fetch,
                    flt=params.filters,
                    include_vector=include_vector,
                )[0]
        fused = hybrid_mod.fuse(sparse, dense, alpha, h.get("fusionType"))
        return fused[params.offset : params.offset + limit]

    # -- post-processing: sort, group ----------------------------------------

    def _postprocess(self, params: GetParams, res: list[SearchResult],
                     skip_sort: bool = False) -> list[SearchResult]:
        if params.sort and not skip_sort:
            res = self._sort(params.sort, res)
        if params.group is not None:
            res = self._group(params.group, res)
        if params.group_by is not None:
            res = self._group_by(params.group_by, res)
        if params.additional.get("certainty") or "certainty" in params.additional:
            self._add_certainty(params, res)
        return res

    def _sort(self, sort: list[dict], res: list[SearchResult]) -> list[SearchResult]:
        for s in reversed(sort):
            path = s.get("path") or []
            prop = path[0] if path else None
            desc = (s.get("order") or "asc") == "desc"
            if prop:
                res = sorted(
                    res,
                    key=lambda r: (
                        (v := r.obj.properties.get(prop)) is None,
                        v if not isinstance(v, bool) else int(v),
                    ),
                    reverse=desc,
                )
        return res

    def _group(self, group: dict, res: list[SearchResult]) -> list[SearchResult]:
        """Get(group:) semantics (usecases/traverser/grouper): cluster results
        whose pairwise OBJECT-vector cosine distance <= (1-force); merge or
        keep the closest-to-query representative."""
        if not res:
            return res
        gtype = group.get("type", "closest")
        force = float(group.get("force", 0.5))

        def unit(v):
            v = np.asarray(v, dtype=np.float32)
            n = float(np.linalg.norm(v))
            return v / n if n > 0 else v

        groups: list[list[SearchResult]] = []
        heads: list[Optional[np.ndarray]] = []
        for r in res:
            v = unit(r.obj.vector) if r.obj.vector is not None else None
            placed = False
            for gi, g in enumerate(groups):
                hv = heads[gi]
                if v is not None and hv is not None:
                    if 1.0 - float(np.dot(v, hv)) <= (1 - force):
                        g.append(r)
                        placed = True
                        break
            if not placed:
                groups.append([r])
                heads.append(v)
        out = []
        for g in groups:
            if gtype == "merge":
                head = g[0]
                for other in g[1:]:
                    for k, v in other.obj.properties.items():
                        hv = head.obj.properties.get(k)
                        if isinstance(hv, str) and isinstance(v, str) and v not in hv:
                            head.obj.properties[k] = f"{hv} ({v})"
                out.append(head)
            else:
                out.append(g[0])
        return out

    def _group_by(self, group_by: dict, res: list[SearchResult]) -> list[SearchResult]:
        """groupBy{path, groups, objectsPerGroup}: one result per group head,
        hits recorded in additional (the gRPC group-by shape)."""
        path = group_by.get("path") or []
        prop = path[0] if path else None
        max_groups = int(group_by.get("groups", 5))
        per_group = int(group_by.get("objectsPerGroup", 5))
        if prop is None:
            return res
        seen: dict[Any, list[SearchResult]] = {}
        for r in res:
            v = r.obj.properties.get(prop)
            key = tuple(v) if isinstance(v, list) else v
            seen.setdefault(key, [])
            if len(seen[key]) < per_group:
                seen[key].append(r)
        out = []
        for key, rows in list(seen.items())[:max_groups]:
            head = rows[0]
            head.additional["group"] = {
                "groupedBy": {"path": [prop], "value": key},
                "count": len(rows),
                "hits": [
                    {**row.obj.to_rest(), "_additional": {"distance": row.distance}}
                    for row in rows
                ],
            }
            out.append(head)
        return out

    def _add_certainty(self, params: GetParams, res: list[SearchResult]) -> None:
        idx = self._index(params.class_name)
        if idx.vector_config.distance != DISTANCE_COSINE:
            return
        for r in res:
            if r.distance is not None:
                r.certainty = max(0.0, 1.0 - r.distance / 2.0)

    # -- Explore (cross-class, explorer.go:492) ------------------------------

    def explore(
        self,
        near_vector: Optional[dict] = None,
        near_object: Optional[dict] = None,
        near_text: Optional[dict] = None,
        limit: int = 25,
    ) -> list[dict]:
        out = []
        if near_text is not None:
            # transform ONCE before the per-class loop: the loop's
            # per-class except must not swallow a missing-transformer error
            # into silent zero hits
            near_text = self._autocorrected_near_text(near_text)
        for idx in self.db.indexes.values():
            p = GetParams(
                class_name=idx.class_name,
                near_vector=near_vector,
                near_object=near_object,
                near_text=near_text,
                limit=limit,
            )
            # certainty is a cosine-only concept (same gate as _add_certainty)
            is_cos = idx.vector_config.distance == DISTANCE_COSINE
            try:
                for r in self._get_one(p):
                    out.append(
                        {
                            "className": idx.class_name,
                            "beacon": f"weaviate://localhost/{idx.class_name}/{r.obj.uuid}",
                            "distance": r.distance,
                            "certainty": (
                                max(0.0, 1.0 - r.distance / 2.0)
                                if r.distance is not None and is_cos
                                else None
                            ),
                        }
                    )
            except TraverserError:
                continue
        out.sort(key=lambda d: d.get("distance") if d.get("distance") is not None else np.inf)
        return out[:limit]
