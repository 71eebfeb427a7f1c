# The port's copy of weaviate_tpu/server/grpc_server.py, its imports pointed at the port.
"""gRPC Search service.

Reference: adapters/handlers/grpc/server.go — `StartAndListen` (:35) exposes
`Weaviate.Search` (:66): build traverser.GetParams from the proto
(searchParamsFromProto, :137), call Traverser.GetClass, marshal results
(searchResultsToProto, :85).

TPU extension: BatchSearch maps onto Traverser.get_class_batched so N
concurrent kNN queries ride one device dispatch instead of N.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent import futures
from typing import Optional

import grpc
import numpy as np

from weaviate_tpu_torch.entities.filters import LocalFilter
from weaviate_tpu_torch.grpcapi import weaviate_pb2 as pb
from weaviate_tpu_torch.monitoring import incidents, tracing
from weaviate_tpu_torch.serving import robustness
from weaviate_tpu_torch.server import reply_native
from weaviate_tpu_torch.usecases.traverser import GetParams

_SERVICE = "weaviatetpu.v1.Weaviate"


def _request_meta(context) -> tuple[str, Optional[str], float, float,
                                    Optional[str]]:
    """(request_id, traceparent, explicit_timeout_ms, transport_timeout_ms,
    raw_tenant) from invocation metadata. The request id (inbound
    ``x-request-id`` honored, else generated) is the gRPC twin of the REST
    X-Request-Id header; `_set_reply_meta` echoes it back. The EXPLICIT
    deadline is the ``x-request-timeout-ms`` metadata entry (the REST
    header's twin — an intentional caller override, may extend past the
    config default); the TRANSPORT deadline is
    ``context.time_remaining()`` — usually just the stub's generous
    default (e.g. 30 s), so the servicer treats it as a CAP on the config
    default, never as an override: an implicit client timeout must not
    silently opt the request out of the operator's QUERY_TIMEOUT_MS. 0 =
    absent for either. ``raw_tenant`` is the UNVALIDATED ``x-tenant-id``
    entry — the servicer validates it (robustness.validate_tenant_id)
    and aborts INVALID_ARGUMENT on an injection-shaped value, the REST
    400's twin."""
    md = {}
    try:
        md = {k.lower(): v for k, v in (context.invocation_metadata() or ())}
    except Exception:  # noqa: BLE001 — metadata is best-effort plumbing
        pass
    transport_ms = 0.0
    try:
        tr = context.time_remaining()
        if tr is not None:
            transport_ms = float(tr) * 1000.0
    except Exception:  # noqa: BLE001 — deadline introspection is optional
        pass
    explicit_ms = 0.0
    raw = md.get("x-request-timeout-ms")
    if raw:
        try:
            explicit_ms = float(raw)
        except ValueError:
            pass  # malformed metadata entry: ignore, keep the defaults
    return tracing.clean_request_id(md.get("x-request-id")), \
        md.get("traceparent"), explicit_ms, transport_ms, \
        md.get("x-tenant-id")


def _set_reply_meta(context, rid: str, trace) -> None:
    """Trailing metadata on EVERY reply, tracing on or off: the request id
    for log joining, plus — when this request was traced — the server's
    W3C traceparent so the caller can join its own trace to ours."""
    md = [("x-request-id", rid)]
    if trace is not None:
        md.append(("traceparent", trace.traceparent()))
    try:
        context.set_trailing_metadata(tuple(md))
    except Exception:  # noqa: BLE001 — metadata is best-effort plumbing
        pass


def _collect_fast(results, req: pb.SearchRequest):
    """(raws, dists, certs) for the native marshaller — ONLY when every
    result can be emitted verbatim from its storage image (no property
    filtering, no vectors, no scores, objects pristine); None otherwise.
    The single source of fast-path eligibility for both the per-reply and
    whole-batch builders."""
    if req.properties or "vector" in req.additional_properties:
        return None
    raws, dists, certs = [], [], []
    for r in results:
        raw = r.raw_pristine()
        if raw is None or r.score is not None or r.explain_score:
            return None
        raws.append(raw)
        dists.append(r.distance)
        certs.append(r.certainty)
    return raws, dists, certs


def fast_reply_bytes(results, req: pb.SearchRequest,
                     took: float) -> Optional[bytes]:
    """Serialized SearchReply via the native marshaller, or None => use the
    upb path (result_to_proto), which is always correct."""
    triple = _collect_fast(results, req)
    if triple is None:
        return None
    return reply_native.build_search_reply(*triple, took)


def params_from_proto(req: pb.SearchRequest) -> GetParams:
    """searchParamsFromProto twin (server.go:137)."""
    near_vector = None
    if req.HasField("near_vector") and len(req.near_vector.vector):
        near_vector = {"vector": list(req.near_vector.vector)}
        if req.near_vector.HasField("certainty"):
            near_vector["certainty"] = req.near_vector.certainty
        if req.near_vector.HasField("distance"):
            near_vector["distance"] = req.near_vector.distance
    near_object = None
    if req.HasField("near_object") and req.near_object.id:
        near_object = {"id": req.near_object.id}
        if req.near_object.HasField("certainty"):
            near_object["certainty"] = req.near_object.certainty
        if req.near_object.HasField("distance"):
            near_object["distance"] = req.near_object.distance
    bm25 = None
    if req.HasField("bm25") and req.bm25.query:
        bm25 = {"query": req.bm25.query}
        if req.bm25.properties:
            bm25["properties"] = list(req.bm25.properties)
    hybrid = None
    if req.HasField("hybrid") and (req.hybrid.query or len(req.hybrid.vector)):
        hybrid = {"query": req.hybrid.query}
        if len(req.hybrid.vector):
            hybrid["vector"] = list(req.hybrid.vector)
        if req.hybrid.HasField("alpha"):
            hybrid["alpha"] = req.hybrid.alpha
        if req.hybrid.fusion_type:
            hybrid["fusionType"] = req.hybrid.fusion_type
    filters = None
    if req.where_json:
        filters = LocalFilter.from_dict(json.loads(req.where_json))
    include_vector = "vector" in req.additional_properties
    return GetParams(
        class_name=req.class_name,
        properties=list(req.properties),
        filters=filters,
        near_vector=near_vector,
        near_object=near_object,
        keyword_ranking=bm25,
        hybrid=hybrid,
        limit=int(req.limit) or 0,
        offset=int(req.offset),
        include_vector=include_vector,
        consistency_level=req.consistency_level or None,
    )


def result_to_proto(r, req: pb.SearchRequest) -> pb.SearchResult:
    """searchResultsToProto twin (server.go:85)."""
    obj = r.obj
    if req.properties:
        props = obj.properties or {}
        props_json = json.dumps(
            {k: v for k, v in props.items() if k in req.properties},
            default=str)
    else:
        # unfiltered replies reuse the stored JSON verbatim — the hot path
        # never parses or re-serializes properties (props_json_bytes is None
        # once the dict was materialized/mutated)
        raw = obj.props_json_bytes()
        props_json = (raw.decode("utf-8") if raw is not None
                      else json.dumps(obj.properties or {}, default=str))
    out = pb.SearchResult(
        id=obj.uuid,
        properties_json=props_json,
        creation_time_unix=obj.creation_time_unix,
        last_update_time_unix=obj.last_update_time_unix,
    )
    addl = set(req.additional_properties)
    if r.distance is not None:
        out.distance = float(r.distance)
    if r.certainty is not None:
        out.certainty = float(r.certainty)
    if r.score is not None:
        out.score = float(r.score)
    if r.explain_score:
        out.explain_score = r.explain_score
    if "vector" in addl and obj.vector is not None:
        out.vector.extend(float(x) for x in obj.vector)
    return out


class SearchServicer:
    def __init__(self, app):
        self.app = app
        # BatchSearch requests the raw lane answered (the port's addition:
        # whether the lane engaged, read from the requests it served)
        self.raw_lane_batches = 0
        self._raw_lane_lock = threading.Lock()

    def _timeout_ms(self, explicit_ms: float, transport_ms: float) -> float:
        """The effective deadline: an EXPLICIT x-request-timeout-ms wins
        outright (the REST header's semantics — an intentional override
        may extend past the default); otherwise the config default capped
        by the transport deadline (the stub's implicit 30 s timeout must
        not override the operator's QUERY_TIMEOUT_MS — see
        _request_meta); 0 = unbounded."""
        if explicit_ms > 0:
            return explicit_ms
        bounds = [v for v in (transport_ms,
                              self.app.config.robustness.query_timeout_ms)
                  if v > 0]
        return min(bounds) if bounds else 0.0

    @staticmethod
    def _note_slo(outcome: str, start: float,
                  tenant: Optional[str] = None) -> None:
        """SLO accounting (monitoring/incidents.py): the gRPC twin of the
        REST _dispatch classification — one-comparison no-op when the
        plane is off, exception-guarded internally."""
        incidents.note_request(
            outcome, (time.perf_counter() - start) * 1000.0, tenant)

    def _abort_lifecycle(self, context, rid: str, e: BaseException,
                         trace=None) -> None:
        """Map robustness errors to their canonical gRPC codes. Shed
        replies carry retry-after-s in trailing metadata (the Retry-After
        twin) so clients back off instead of retrying in lockstep.
        set_trailing_metadata REPLACES what _set_reply_meta installed, so
        the request id AND (for traced requests) the traceparent are
        re-included — the error-reply header-echo contract holds on the
        shed path too."""
        if isinstance(e, robustness.OverloadedError):
            md = [("x-request-id", rid),
                  ("retry-after-s", f"{e.retry_after_s:.3f}")]
            if trace is not None:
                md.append(("traceparent", trace.traceparent()))
            try:
                context.set_trailing_metadata(tuple(md))
            except Exception:  # noqa: BLE001 — metadata is best-effort
                pass
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))

    def Search(self, request: pb.SearchRequest, context) -> pb.SearchReply:
        start = time.perf_counter()
        rid, traceparent, expl_tmo, trans_tmo, raw_tenant = \
            _request_meta(context)
        with tracing.request("grpc", "Search", traceparent=traceparent,
                             request_id=rid,
                             class_name=request.class_name) as tr:
            _set_reply_meta(context, rid, tr)
            try:
                # inside the traced scope, after _set_reply_meta: the
                # invalid-tenant abort must carry the request-id /
                # traceparent echo like every other error reply
                tenant = robustness.validate_tenant_id(raw_tenant)
            except ValueError as e:
                # caller-mistake aborts count as "client" like the REST
                # twin — identical workloads must burn identically
                self._note_slo("client", start)
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
                return
            if tenant:
                tracing.annotate_current("tenant", tenant)
            try:
                params = params_from_proto(request)
            except Exception as e:
                self._note_slo("client", start, tenant)
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
                return
            try:
                with robustness.tenant_concurrency(tenant), \
                        robustness.tenant_scope(tenant), \
                        robustness.deadline_scope(
                            self._timeout_ms(expl_tmo, trans_tmo)):
                    results = self.app.traverser.get_class(params)
            except (robustness.DeadlineExceededError,
                    robustness.OverloadedError) as e:
                self._note_slo(
                    "shed" if isinstance(e, robustness.OverloadedError)
                    else "deadline", start, tenant)
                self._abort_lifecycle(context, rid, e, trace=tr)
                return
            except ValueError as e:
                self._note_slo("client", start, tenant)
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
                return
            except Exception as e:
                self._note_slo("error", start, tenant)
                context.abort(grpc.StatusCode.INTERNAL,
                              f"{type(e).__name__}: {e}")
                return
            self._note_slo("ok", start, tenant)
            took = time.perf_counter() - start
            fast = fast_reply_bytes(results, request, took)
            if fast is not None:
                return fast  # pre-serialized; the passthrough serializer ships it
            reply = pb.SearchReply(took_seconds=took)
            reply.results.extend(result_to_proto(r, request) for r in results)
            return reply

    def _raw_batch_lane(self, request: pb.BatchSearchRequest,
                        start: float) -> Optional[bytes]:
        """Zero-object serving lane: when every slot is a plain same-class
        nearVector query with verbatim replies, the whole batch runs as
        device search -> packed native point-gets -> packed native reply
        marshalling, with no per-result Python objects anywhere. None =>
        the general path (which is always correct) serves the batch."""
        reqs = request.requests
        if not reqs:
            return None
        f0 = reqs[0]
        cls, limit = f0.class_name, int(f0.limit)
        explorer = self.app.traverser.explorer
        k = limit or explorer.query_limit
        if k > explorer.max_results:
            return None
        dim = len(f0.near_vector.vector) if f0.HasField("near_vector") else 0
        if dim == 0:
            return None
        for r in reqs:
            if (r.class_name != cls or int(r.limit) != limit or r.offset
                    or r.properties or r.additional_properties or r.where_json
                    or r.consistency_level
                    or not r.HasField("near_vector")
                    or len(r.near_vector.vector) != dim
                    or r.near_vector.HasField("certainty")
                    or r.near_vector.HasField("distance")
                    or r.HasField("near_object") or r.HasField("bm25")
                    or r.HasField("hybrid")):
                return None
        resolved = self.app.schema.resolve_class_name(cls)
        idx = self.app.db.get_index(resolved) if resolved else None
        if idx is None:
            return None
        shard = idx.single_local_shard()
        if shard is None:
            return None
        if not shard.raw_plane_ready():
            return None  # before ANY device work: the general path searches once
        q = np.empty((len(reqs), dim), dtype=np.float32)
        for i, r in enumerate(reqs):
            q[i] = np.fromiter(r.near_vector.vector, np.float32, dim)
        try:
            out = shard.search_raw_packed(q, k)
        except Exception:  # noqa: BLE001 — the general path re-runs + reports
            return None
        if out is None:
            return None
        vbuf, voffs, vflags, flat_dists, counts = out
        return reply_native.build_batch_reply_packed(
            vbuf, voffs, vflags, flat_dists, counts,
            time.perf_counter() - start)

    def BatchSearch(self, request: pb.BatchSearchRequest, context) -> pb.BatchSearchReply:
        """Per-slot error isolation end to end: a malformed request or failed
        query yields a reply with error_message; the other slots still ride
        the shared device dispatch."""
        start = time.perf_counter()
        rid, traceparent, expl_tmo, trans_tmo, raw_tenant = \
            _request_meta(context)
        with tracing.request("grpc", "BatchSearch", traceparent=traceparent,
                             request_id=rid,
                             slots=len(request.requests)) as tr:
            _set_reply_meta(context, rid, tr)
            try:
                # traced + metadata-echoed like the Search twin above
                tenant = robustness.validate_tenant_id(raw_tenant)
            except ValueError as e:
                self._note_slo("client", start)
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
                return
            if tenant:
                tracing.annotate_current("tenant", tenant)
            try:
                # ONE deadline scopes the whole batch (the RPC is the unit
                # the caller is waiting on); per-slot shed/expired errors
                # land in their slot's error_message via get_class_batched
                with robustness.tenant_concurrency(tenant), \
                        robustness.tenant_scope(tenant), \
                        robustness.deadline_scope(
                            self._timeout_ms(expl_tmo, trans_tmo)):
                    reply = self._batch_search(request, start)
                self._note_slo("ok", start, tenant)
                return reply
            except (robustness.DeadlineExceededError,
                    robustness.OverloadedError) as e:
                self._note_slo(
                    "shed" if isinstance(e, robustness.OverloadedError)
                    else "deadline", start, tenant)
                self._abort_lifecycle(context, rid, e, trace=tr)
            except ValueError as e:
                self._note_slo("client", start, tenant)
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            except Exception as e:
                # the Search-twin classification: a batch-only outage must
                # spend availability budget like a single-query one
                self._note_slo("error", start, tenant)
                context.abort(grpc.StatusCode.INTERNAL,
                              f"{type(e).__name__}: {e}")

    def _batch_search(self, request: pb.BatchSearchRequest, start: float):
        # with the coalescer on, a NARROW batch (up to max_request_rows —
        # the widest request the coalescer admits) skips the raw lane: its
        # own dispatch would run underfilled, while the general path merges
        # the slots with other in-flight requests into one padded dispatch.
        # STRICTLY wider batches keep the raw lane — they already fill a
        # dispatch and its reply marshalling is strictly cheaper.
        co = getattr(self.app, "coalescer", None)
        if co is None or len(request.requests) > co.max_request_rows:
            raw = self._raw_batch_lane(request, start)
            if raw is not None:
                with self._raw_lane_lock:
                    self.raw_lane_batches += 1
                return raw
        slot_params: list = [None] * len(request.requests)
        parse_errs: dict[int, str] = {}
        for i, r in enumerate(request.requests):
            try:
                slot_params[i] = params_from_proto(r)
            except Exception as e:
                parse_errs[i] = str(e)
        valid = [(i, p) for i, p in enumerate(slot_params) if i not in parse_errs]
        results = self.app.traverser.get_class_batched([p for _, p in valid]) if valid else []
        took = time.perf_counter() - start
        slot_out: dict[int, object] = {i: res for (i, _), res in zip(valid, results)}
        if not parse_errs and len(valid) == len(request.requests):
            whole = self._whole_batch_fast(request, slot_out, took)
            if whole is not None:
                return whole
        # assemble the outer BatchSearchReply as wire bytes so fast-path
        # slots (native-marshalled, see fast_reply_bytes) splice in without
        # ever becoming Python message objects; slow slots serialize via upb
        # and splice the same way — concatenated length-delimited field 1
        # entries ARE the repeated `replies` encoding
        chunks: list[bytes] = []
        for i, req in enumerate(request.requests):
            body: Optional[bytes] = None
            if i not in parse_errs:
                slot = slot_out.get(i)
                if slot is not None and not isinstance(slot, Exception):
                    body = fast_reply_bytes(slot, req, took)
            if body is None:
                one = pb.SearchReply(took_seconds=took)
                if i in parse_errs:
                    one.error_message = parse_errs[i]
                else:
                    slot = slot_out.get(i)
                    if isinstance(slot, Exception):
                        one.error_message = str(slot)
                    elif slot is not None:
                        one.results.extend(result_to_proto(r, req) for r in slot)
                body = one.SerializeToString()
            chunks.append(b"\x0a" + reply_native.varint(len(body)) + body)
        return b"".join(chunks)

    def _whole_batch_fast(self, request, slot_out, took) -> Optional[bytes]:
        """One native call serializes the ENTIRE BatchSearchReply when every
        slot is fast-eligible; None falls back to per-slot assembly."""
        raws: list[bytes] = []
        dists: list = []
        certs: list = []
        counts: list[int] = []
        for i, req in enumerate(request.requests):
            slot = slot_out.get(i)
            if slot is None or isinstance(slot, Exception):
                return None
            triple = _collect_fast(slot, req)
            if triple is None:
                return None
            raws.extend(triple[0])
            dists.extend(triple[1])
            certs.extend(triple[2])
            counts.append(len(triple[0]))
        return reply_native.build_batch_reply(raws, dists, certs, counts, took)


def _serialize_passthrough(msg):
    """Responses are either upb messages or pre-serialized wire bytes from
    the native marshaller — both ship as-is."""
    if isinstance(msg, (bytes, bytearray)):
        return bytes(msg)
    return msg.SerializeToString()


def _handlers(servicer) -> grpc.GenericRpcHandler:
    return grpc.method_handlers_generic_handler(_SERVICE, {
        "Search": grpc.unary_unary_rpc_method_handler(
            servicer.Search,
            request_deserializer=pb.SearchRequest.FromString,
            response_serializer=_serialize_passthrough,
        ),
        "BatchSearch": grpc.unary_unary_rpc_method_handler(
            servicer.BatchSearch,
            request_deserializer=pb.BatchSearchRequest.FromString,
            response_serializer=_serialize_passthrough,
        ),
    })


# The port's send and receive message limit, on the server and the client
# alike. grpc's defaults (4 MiB received, which the reference keeps) refuse
# the widest BatchSearch the raw lane serves: 16384 128-float queries are
# ~8.7 MB of request and, at k 10 with each object's vector, ~170 MB of
# reply. 1 GiB holds that reply about six times over (wider vectors or k).
MAX_MESSAGE_BYTES = 1 << 30
_MESSAGE_OPTIONS = [("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
                    ("grpc.max_send_message_length", MAX_MESSAGE_BYTES)]


class GrpcServer:
    """StartAndListen twin (server.go:35), with MAX_MESSAGE_BYTES."""

    def __init__(self, app, host: str = "127.0.0.1", port: int = 0, max_workers: int = 16):
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers),
                                  options=_MESSAGE_OPTIONS)
        self.servicer = SearchServicer(app)
        self.server.add_generic_rpc_handlers((_handlers(self.servicer),))
        self.port = self.server.add_insecure_port(f"{host}:{port}")

    def start(self) -> None:
        self.server.start()

    def stop(self, grace: Optional[float] = 1.0) -> None:
        self.server.stop(grace).wait()


class SearchClient:
    """Minimal client (the generated-stub equivalent, for tests/tools),
    with MAX_MESSAGE_BYTES."""

    def __init__(self, target: str):
        self.channel = grpc.insecure_channel(target, options=_MESSAGE_OPTIONS)
        self._search = self.channel.unary_unary(
            f"/{_SERVICE}/Search",
            request_serializer=pb.SearchRequest.SerializeToString,
            response_deserializer=pb.SearchReply.FromString,
        )
        self._batch = self.channel.unary_unary(
            f"/{_SERVICE}/BatchSearch",
            request_serializer=pb.BatchSearchRequest.SerializeToString,
            response_deserializer=pb.BatchSearchReply.FromString,
        )

    def search(self, request: pb.SearchRequest, timeout: float = 30.0,
               metadata=None) -> pb.SearchReply:
        # metadata: e.g. (("x-request-timeout-ms", "50"),) — the server-side
        # deadline (shed/expire without a client-side transport deadline)
        return self._search(request, timeout=timeout, metadata=metadata)

    def batch_search(self, request: pb.BatchSearchRequest,
                     timeout: float = 60.0,
                     metadata=None) -> pb.BatchSearchReply:
        return self._batch(request, timeout=timeout, metadata=metadata)

    def close(self) -> None:
        self.channel.close()
