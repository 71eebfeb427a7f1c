# The port's copy of weaviate_tpu/server/rest.py, its imports pointed at the port.
"""REST API: the full /v1 surface on a threaded stdlib HTTP server.

Reference: adapters/handlers/rest/ — go-swagger generated ops wired in
configure_api.go:293-300 (objects CRUD, batch, schema, graphql, backups,
nodes, meta, well-known, classifications). Here the routing is one regex
table; handlers translate HTTP <-> the use-case managers exactly like the
reference's handlers_*.go files, including Weaviate's error envelope
`{"error": [{"message": ...}]}`.

Threaded (not async) on purpose: handlers call synchronous use-case code
whose hot path is a device dispatch; the GIL releases during device work so
concurrent queries still batch. /metrics is mounted on the main port and,
when PROMETHEUS_MONITORING_ENABLED, on its own port (configure_api.go:116).

The port's one difference from the JAX package's server: its listen
backlog is the system's (socket.SOMAXCONN), as Go's net/http listener's
is, instead of socketserver's 5, so many clients connecting at once
queue instead of being reset.
"""

from __future__ import annotations

import json
import math
import re
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from weaviate_tpu_torch.auth import ForbiddenError, UnauthorizedError
from weaviate_tpu_torch.monitoring import incidents, tracing
from weaviate_tpu_torch.serving import robustness
from weaviate_tpu_torch.schema.manager import SchemaError
from weaviate_tpu_torch.usecases.objects import NotFoundError, ObjectsError
from weaviate_tpu_torch.version import __version__ as VERSION

_UUID_RE = r"[0-9a-fA-F-]{36}"


class HTTPError(Exception):
    def __init__(self, status: int, message: str = ""):
        self.status = status
        self.message = message


def _err_body(message: str) -> dict:
    return {"error": [{"message": message}]}


class _Routes:
    def __init__(self):
        self.table: list[tuple[str, re.Pattern, str]] = []

    def add(self, method: str, pattern: str, name: str):
        self.table.append((method, re.compile("^" + pattern + "$"), name))

    def match(self, method: str, path: str):
        allowed = []
        for m, pat, name in self.table:
            mt = pat.match(path)
            if mt:
                if m == method or (m == "GET" and method == "HEAD" and name == "meta"):
                    return name, mt
                allowed.append(m)
        if allowed:
            raise HTTPError(405, f"method {method} not allowed")
        raise HTTPError(404, f"no route for {path}")


ROUTES = _Routes()
for _m, _p, _n in [
    ("GET", r"/v1/meta", "meta"),
    ("GET", r"/v1/\.well-known/openid-configuration", "openid"),
    ("GET", r"/v1/\.well-known/live", "live"),
    ("GET", r"/v1/\.well-known/ready", "ready"),
    ("GET", r"/v1/schema", "schema_list"),
    ("POST", r"/v1/schema", "schema_create"),
    ("GET", r"/v1/schema/(?P<cls>[^/]+)", "schema_get"),
    ("PUT", r"/v1/schema/(?P<cls>[^/]+)", "schema_update"),
    ("DELETE", r"/v1/schema/(?P<cls>[^/]+)", "schema_delete"),
    ("POST", r"/v1/schema/(?P<cls>[^/]+)/properties", "schema_add_property"),
    ("GET", r"/v1/schema/(?P<cls>[^/]+)/shards", "shards_get"),
    ("PUT", r"/v1/schema/(?P<cls>[^/]+)/shards/(?P<shard>[^/]+)", "shard_update"),
    ("GET", r"/v1/objects", "objects_list"),
    ("POST", r"/v1/objects", "objects_create"),
    ("POST", r"/v1/objects/validate", "objects_validate"),
    # class-scoped must come before legacy so /v1/objects/Class/uuid wins
    ("GET", rf"/v1/objects/(?P<cls>[^/]+)/(?P<id>{_UUID_RE})", "object_get"),
    ("HEAD", rf"/v1/objects/(?P<cls>[^/]+)/(?P<id>{_UUID_RE})", "object_head"),
    ("PUT", rf"/v1/objects/(?P<cls>[^/]+)/(?P<id>{_UUID_RE})", "object_put"),
    ("PATCH", rf"/v1/objects/(?P<cls>[^/]+)/(?P<id>{_UUID_RE})", "object_patch"),
    ("DELETE", rf"/v1/objects/(?P<cls>[^/]+)/(?P<id>{_UUID_RE})", "object_delete"),
    ("GET", rf"/v1/objects/(?P<id>{_UUID_RE})", "object_get"),
    ("HEAD", rf"/v1/objects/(?P<id>{_UUID_RE})", "object_head"),
    ("PUT", rf"/v1/objects/(?P<id>{_UUID_RE})", "object_put"),
    ("PATCH", rf"/v1/objects/(?P<id>{_UUID_RE})", "object_patch"),
    ("DELETE", rf"/v1/objects/(?P<id>{_UUID_RE})", "object_delete"),
    ("POST", rf"/v1/objects/(?P<cls>[^/]+)/(?P<id>{_UUID_RE})/references/(?P<prop>[^/]+)", "ref_add"),
    ("PUT", rf"/v1/objects/(?P<cls>[^/]+)/(?P<id>{_UUID_RE})/references/(?P<prop>[^/]+)", "ref_put"),
    ("DELETE", rf"/v1/objects/(?P<cls>[^/]+)/(?P<id>{_UUID_RE})/references/(?P<prop>[^/]+)", "ref_delete"),
    ("POST", r"/v1/batch/objects", "batch_objects"),
    ("DELETE", r"/v1/batch/objects", "batch_delete"),
    ("POST", r"/v1/batch/references", "batch_references"),
    ("POST", r"/v1/graphql", "graphql"),
    ("POST", r"/v1/graphql/batch", "graphql_batch"),
    ("GET", r"/v1/nodes", "nodes"),
    ("GET", r"/metrics", "metrics"),
    # completed-request trace ring (monitoring/tracing.py) — same
    # authorizer as the pprof surface below: span trees name classes and
    # filters and are not for anonymous remote clients
    ("GET", r"/debug/traces", "debug_traces"),
    # rolling perf-attribution window (monitoring/perf.py): roofline,
    # duty cycle, host-overhead ledger percentiles — same authorizer as
    # pprof (it names classes and exposes serving internals)
    ("GET", r"/debug/perf", "debug_perf"),
    # shadow recall auditor window (monitoring/quality.py): online
    # recall/RBO/distance-error estimates per tier + audit accounting —
    # the quality twin of /debug/perf, same authorizer
    ("GET", r"/debug/quality", "debug_quality"),
    # per-index/shard health introspection (index/gpu.py health()):
    # tombstone fractions, snapshot/staged generations, PQ state,
    # cache residency — same authorizer (it names classes)
    ("GET", r"/debug/index", "debug_index"),
    # device/host/disk byte ledger (monitoring/memory.py): per-component
    # bytes, write-path lifecycle, exhaustion forecast — same authorizer
    ("GET", r"/debug/memory", "debug_memory"),
    # incident flight recorder + ops-event journal (monitoring/
    # incidents.py): recent bundle index + journal tail, and an explicit
    # dump trigger — same authorizer as pprof (bundles name classes,
    # tenants, and config)
    ("GET", r"/debug/incidents", "debug_incidents"),
    ("POST", r"/debug/incidents/dump", "debug_incidents_dump"),
    # config-declared SLOs: multi-window burn rates + budget remaining
    ("GET", r"/debug/slo", "debug_slo"),
    # self-tuning control plane (serving/controller.py): per-controller
    # state, knob values vs configured defaults, brownout-ladder stage,
    # recent actuations — same authorizer (it names tenants and config)
    ("GET", r"/debug/controllers", "debug_controllers"),
    # the debug surface's index page: every /debug endpoint, one line each
    ("GET", r"/debug/?", "debug_root"),
    # always-mounted profiling surface (configure_api.go:25 net/http/pprof)
    ("GET", r"/debug/pprof/?", "pprof_index"),
    ("GET", r"/debug/pprof/profile", "pprof_profile"),
    ("GET", r"/debug/pprof/trace", "pprof_trace"),
    ("GET", r"/debug/pprof/goroutine", "pprof_goroutine"),
    ("GET", r"/debug/pprof/heap", "pprof_heap"),
    ("GET", r"/debug/pprof/cmdline", "pprof_cmdline"),
    ("POST", r"/v1/backups/(?P<backend>[^/]+)", "backup_create"),
    ("GET", r"/v1/backups/(?P<backend>[^/]+)/(?P<id>[^/]+)", "backup_status"),
    ("POST", r"/v1/backups/(?P<backend>[^/]+)/(?P<id>[^/]+)/restore", "backup_restore"),
    ("GET", r"/v1/backups/(?P<backend>[^/]+)/(?P<id>[^/]+)/restore", "backup_restore_status"),
    ("POST", r"/v1/classifications", "classification_create"),
    ("GET", r"/v1/classifications/(?P<id>[^/]+)", "classification_get"),
    # module REST extensions: /v1/modules/<module>/<module-defined subpath>
    # (the reference mounts each module's RootHandler at this prefix,
    # middlewares.go:66)
    ("GET", r"/v1/modules/(?P<module>[^/]+)(?P<rest>/.*)", "module_rest"),
    ("POST", r"/v1/modules/(?P<module>[^/]+)(?P<rest>/.*)", "module_rest"),
    ("PUT", r"/v1/modules/(?P<module>[^/]+)(?P<rest>/.*)", "module_rest"),
    ("DELETE", r"/v1/modules/(?P<module>[^/]+)(?P<rest>/.*)", "module_rest"),
]:
    ROUTES.add(_m, _p, _n)

_WRITE_METHODS = {"POST": "create", "PUT": "update", "PATCH": "update", "DELETE": "delete"}


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    app = None  # injected by RestServer

    # silence default stderr logging
    def log_message(self, fmt, *args):
        pass

    # -- plumbing ------------------------------------------------------------

    def _json_body(self):
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b""
        self._body_consumed = True
        if not raw:
            return None
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise HTTPError(400, f"invalid json: {e}") from None

    def _drain_body(self):
        """Consume an unread request body so an early error reply doesn't
        desynchronize the keep-alive stream (the next request would otherwise
        parse the stale body bytes as its request line)."""
        if getattr(self, "_body_consumed", False):
            return
        self._body_consumed = True
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except (TypeError, ValueError):
            length = 0
        while length > 0:
            chunk = self.rfile.read(min(length, 65536))
            if not chunk:
                break
            length -= len(chunk)

    def _reply(self, status: int, body=None, raw: Optional[bytes] = None,
               content_type: str = "application/json"):
        self._drain_body()
        data = raw if raw is not None else (
            b"" if body is None else json.dumps(body).encode())
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        # every response (success AND error) carries the request id —
        # inbound X-Request-Id honored, else generated — so client logs
        # join to server traces/slow-query lines without tracing enabled
        rid = getattr(self, "_request_id", None)
        if rid:
            self.send_header("X-Request-Id", rid)
        # shed responses (429) carry the server's drain estimate so
        # well-behaved clients back off instead of retrying in lockstep
        ra = getattr(self, "_retry_after", None)
        if ra is not None:
            self.send_header("Retry-After", str(max(1, math.ceil(ra))))
        # ...and a traced request emits its W3C traceparent (this server's
        # root span id), so a caller can join its own outbound trace to
        # the /debug/traces entry this request produced
        tp = getattr(self, "_traceparent", None)
        if tp:
            self.send_header("traceparent", tp)
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(data)

    def _principal(self):
        auth = self.headers.get("Authorization") or ""
        token = auth[7:] if auth.startswith("Bearer ") else None
        return self.app.authenticator.principal_from_bearer(token)

    # plumbing/introspection routes never open a trace: they are not the
    # serving path, and tracing /debug/traces would feed the ring with
    # reads of itself
    _UNTRACED = frozenset({
        "live", "ready", "openid", "metrics", "debug_traces", "debug_perf",
        "debug_quality", "debug_index", "debug_memory", "debug_root",
        "debug_incidents", "debug_incidents_dump", "debug_slo",
        "debug_controllers",
        "pprof_index", "pprof_profile", "pprof_trace", "pprof_goroutine",
        "pprof_heap", "pprof_cmdline",
    })

    def _request_timeout_ms(self, route: str) -> float:
        """Per-request deadline in ms: the caller's X-Request-Timeout-Ms
        wins, else the config default (QUERY_TIMEOUT_MS); <= 0 (or a
        plumbing route) = unbounded. A malformed header is a caller error,
        not a silently-unbounded request."""
        if route in self._UNTRACED:
            return 0.0
        hdr = self.headers.get("X-Request-Timeout-Ms")
        if hdr:
            try:
                v = float(hdr)
            except ValueError:
                raise HTTPError(
                    400, f"invalid X-Request-Timeout-Ms: {hdr!r}") from None
            if v > 0:
                return v
            # <= 0 falls through to the config default (the gRPC twin's
            # semantics): a client cannot opt OUT of the operator's
            # deadline by sending 0
        return self.app.config.robustness.query_timeout_ms

    def _dispatch(self):
        self._body_consumed = False
        # request id before anything can fail: the error envelope carries
        # the header too (satellite contract: EVERY response has one);
        # cleaned — an inbound id is echoed into a response header and must
        # not be able to smuggle CR/LF
        self._request_id = tracing.clean_request_id(
            self.headers.get("X-Request-Id"))
        self._traceparent = None
        self._retry_after = None
        try:
            # tenant identity: X-Tenant-Id is an ACCOUNTING key (budgets,
            # metrics), so unlike X-Request-Id an invalid value is a 400,
            # never cleaned-and-used — two spellings of one tenant must
            # not split its budget, and injection bytes must not reach a
            # metric label or log line
            try:
                tenant = robustness.validate_tenant_id(
                    self.headers.get("X-Tenant-Id"))
            except ValueError as e:
                raise HTTPError(400, str(e)) from None
            parsed = urlparse(self.path)
            self.query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
            name, mt = ROUTES.match(self.command, parsed.path)
            # unlike the reference's unauthenticated DefaultServeMux
            # side-mount (configure_api.go:25), pprof goes through the same
            # authorizer as the data plane — thread stacks and CPU profiles
            # are not for anonymous remote clients
            if name not in ("live", "ready", "openid", "metrics"):
                principal = self._principal()
                verb = _WRITE_METHODS.get(self.command, "get")
                self.app.authorizer.authorize(principal, verb, parsed.path)
            handler = getattr(self, "h_" + name)
            # the deadline scope wraps the WHOLE handler (serving/
            # robustness.py): it propagates via contextvars through the
            # graphql executor and traverser into coalescer lanes and
            # shard dispatches; 0 => a no-op scope. The tenant scope rides
            # the same plumbing (None => class-name default downstream);
            # the concurrency gate sheds an over-parallel tenant HERE,
            # before the handler does any per-request work.
            # SLO accounting (monitoring/incidents.py): every serving
            # request's outcome + wall duration feeds the burn-rate
            # engine under the same taxonomy the shed/deadline counters
            # use. Plumbing/introspection routes are exempt (they are not
            # the serving SLO); note_request is a one-comparison no-op
            # when the plane is off and exception-guarded internally.
            slo = name not in self._UNTRACED
            t0 = time.perf_counter() if slo else 0.0
            try:
                with robustness.tenant_concurrency(tenant), \
                        robustness.tenant_scope(tenant), \
                        robustness.deadline_scope(
                            self._request_timeout_ms(name)):
                    if tracing.get_tracer() is None \
                            or name in self._UNTRACED:
                        handler(**mt.groupdict())
                    else:
                        attrs = {"route": name}
                        if tenant:
                            attrs["tenant"] = tenant
                        with tracing.request(
                                "rest", f"{self.command} {parsed.path}",
                                traceparent=self.headers.get("traceparent"),
                                request_id=self._request_id, **attrs) as tr:
                            if tr is not None:
                                self._traceparent = tr.traceparent()
                            handler(**mt.groupdict())
            except robustness.OverloadedError:
                if slo:
                    incidents.note_request(
                        "shed", (time.perf_counter() - t0) * 1000.0, tenant)
                raise
            except robustness.DeadlineExceededError:
                if slo:
                    incidents.note_request(
                        "deadline", (time.perf_counter() - t0) * 1000.0,
                        tenant)
                raise
            except (HTTPError, UnauthorizedError, ForbiddenError,
                    NotFoundError, ObjectsError, SchemaError, ValueError,
                    BrokenPipeError):
                # caller mistakes (4xx family) and client disconnects:
                # counted toward request totals, never against the
                # availability error budget
                if slo:
                    incidents.note_request(
                        "client", (time.perf_counter() - t0) * 1000.0,
                        tenant)
                raise
            except Exception:
                if slo:
                    incidents.note_request(
                        "error", (time.perf_counter() - t0) * 1000.0,
                        tenant)
                raise
            else:
                if slo:
                    incidents.note_request(
                        "ok", (time.perf_counter() - t0) * 1000.0, tenant)
        except HTTPError as e:
            self._reply(e.status, _err_body(e.message))
        except UnauthorizedError as e:
            self._reply(401, _err_body(str(e)))
        except ForbiddenError as e:
            self._reply(403, _err_body(str(e)))
        except NotFoundError as e:
            self._reply(404, _err_body(str(e)))
        except robustness.OverloadedError as e:
            # shed by admission control: 429 + Retry-After (the server's
            # queue-drain estimate) so clients back off with jitter
            self._retry_after = e.retry_after_s
            self._reply(429, _err_body(str(e)))
        except robustness.DeadlineExceededError as e:
            self._reply(504, _err_body(str(e)))
        except (ObjectsError, SchemaError, ValueError) as e:
            self._reply(422, _err_body(str(e)))
        except BrokenPipeError:
            pass
        except Exception as e:  # internal
            self._reply(500, _err_body(f"{type(e).__name__}: {e}"))

    do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = do_HEAD = _dispatch

    # -- well-known / meta ---------------------------------------------------

    def h_meta(self):
        self._reply(200, self.app.meta())

    def h_openid(self):
        oidc = self.app.config.auth.oidc
        if not oidc.enabled:
            self._reply(404, _err_body("OIDC not configured"))
            return
        self._reply(200, {"href": f"{oidc.issuer}/.well-known/openid-configuration",
                          "clientId": oidc.client_id})

    def h_live(self):
        self._reply(200, raw=b"")

    def h_ready(self):
        self._reply(200, raw=b"")

    def h_metrics(self):
        self._reply(200, raw=self.app.metrics.expose(),
                    content_type="text/plain; version=0.0.4")

    # -- tracing (monitoring/tracing.py) -------------------------------------

    def h_debug_traces(self):
        t = tracing.get_tracer()
        if t is None:
            self._reply(200, {"enabled": False, "traces": []})
            return
        traces = t.snapshot()
        try:
            limit = int(self.query.get("limit", 0) or 0)
        except ValueError:
            limit = 0
        if limit > 0:
            traces = traces[-limit:]
        self._reply(200, {"enabled": True, "count": len(traces),
                          "traces": traces})

    def h_debug_perf(self):
        from weaviate_tpu_torch.monitoring import perf

        w = perf.get_window()
        if w is None:
            self._reply(200, {"enabled": False})
            return
        self._reply(200, {"enabled": True, **w.summary()})

    def h_debug_quality(self):
        from weaviate_tpu_torch.monitoring import quality

        a = quality.get_auditor()
        if a is None:
            self._reply(200, {"enabled": False})
            return
        self._reply(200, {"enabled": True, **a.summary()})

    def h_debug_memory(self):
        from weaviate_tpu_torch.monitoring import memory

        led = memory.get_ledger()
        if led is None:
            self._reply(200, {"enabled": False})
            return
        self._reply(200, {"enabled": True, **led.summary()})

    def h_debug_incidents(self):
        """Recent bundle index + journal tail (monitoring/incidents.py)."""
        rec = incidents.get_recorder()
        journal = incidents.get_journal()
        if rec is None and journal is None:
            self._reply(200, {"enabled": False})
            return
        out: dict = {"enabled": True}
        if rec is not None:
            out["recorder"] = rec.stats()
            out["bundles"] = rec.index()
        if journal is not None:
            try:
                limit = int(self.query.get("limit", 128) or 128)
            except ValueError:
                limit = 128
            out["journal"] = {"counts": journal.counts(),
                              "tail": journal.tail(limit)}
        self._reply(200, out)

    def h_debug_incidents_dump(self):
        """Explicit bundle trigger (synchronous, rate-limit-exempt: an
        operator asking for a dump should get one)."""
        rec = incidents.get_recorder()
        if rec is None:
            self._reply(503, _err_body(
                "incident recorder disabled (INCIDENTS_ENABLED)"))
            return
        path = rec.dump_now(
            "manual", reason="explicit POST /debug/incidents/dump",
            force=True)
        if path is None:
            self._reply(500, _err_body("bundle capture failed"))
            return
        self._reply(200, {"file": path})

    def h_debug_slo(self):
        eng = incidents.get_engine()
        if eng is None:
            self._reply(200, {"enabled": False})
            return
        self._reply(200, {"enabled": True, **eng.summary()})

    def h_debug_controllers(self):
        """Control-plane state (serving/controller.py): per-controller
        sense/decide state, every knob's current value vs its configured
        default, the brownout-ladder stage, and recent actuations."""
        from weaviate_tpu_torch.serving import controller

        p = controller.get_plane()
        if p is None:
            self._reply(200, {"enabled": False})
            return
        self._reply(200, {"enabled": True, **p.summary()})

    def h_debug_index(self):
        out = {}
        # snapshot the live registries before iterating (db.py's own
        # defensive idiom): concurrent class/shard creation must not 500
        # a health endpoint with a dict-changed-size error
        for cls, idx in list(self.app.db.indexes.items()):
            out[cls] = {name: shard.debug_health()
                        for name, shard in list(idx.shards.items())}
        self._reply(200, {"indexes": out})

    def h_debug_root(self):
        """The /debug index page: every debug endpoint with a one-line
        description (same authorizer as all of them)."""
        self._reply(200, {"endpoints": {
            "/debug/traces": "completed request traces ring (span trees "
                             "with device-time attribution; "
                             "TRACING_ENABLED)",
            "/debug/perf": "rolling device-performance window: roofline, "
                           "duty cycle, host-overhead ledger percentiles "
                           "(rides TRACING_ENABLED)",
            "/debug/quality": "shadow recall auditor window: online "
                              "recall/RBO/distance-error per tier, audit "
                              "accounting (RECALL_AUDIT_SAMPLE_RATE > 0)",
            "/debug/index": "per-index/shard health: live/tombstone "
                            "counts, snapshot + staged generations, PQ "
                            "state, cache residency (always on)",
            "/debug/memory": "device/host/disk byte ledger: per-component "
                             "bytes, write-path lifecycle, COW costs, "
                             "exhaustion forecast + headroom alerts "
                             "(MEMORY_LEDGER_ENABLED, default on)",
            "/debug/incidents": "incident flight recorder: recent bundle "
                                "index + ops-event journal tail "
                                "(INCIDENTS_ENABLED, default on)",
            "/debug/incidents/dump": "POST: capture a bundle now "
                                     "(rate-limit-exempt)",
            "/debug/slo": "config-declared SLOs: 5m/1h burn rates, error "
                          "budget remaining, alert state "
                          "(SLO_AVAILABILITY_TARGET / SLO_LATENCY_P99_MS)",
            "/debug/controllers": "self-tuning control plane: brownout "
                                  "ladder stage, knob values vs "
                                  "configured defaults, recent "
                                  "actuations (CONTROL_PLANE_ENABLED)",
            "/debug/pprof/": "profiling surface index",
            "/debug/pprof/profile": "sampled CPU profile "
                                    "(?seconds=N&hz=N)",
            "/debug/pprof/trace": "device trace capture, torch.profiler (?seconds=N)",
            "/debug/pprof/goroutine": "all-thread stack dump",
            "/debug/pprof/heap": "heap allocation summary (?limit=N)",
            "/debug/pprof/cmdline": "process command line",
        }})

    # -- profiling (monitoring/profiling.py; pprof surface) ------------------

    def h_pprof_index(self):
        from weaviate_tpu_torch.monitoring import profiling

        self._reply(200, raw=profiling.index().encode(), content_type="text/plain")

    def h_pprof_profile(self):
        from weaviate_tpu_torch.monitoring import profiling

        text = self.app.stack_sampler.profile(
            seconds=float(self.query.get("seconds", 5)),
            hz=int(self.query.get("hz", 100)),
        )
        self._reply(200, raw=text.encode(), content_type="text/plain")

    def h_pprof_trace(self):
        from weaviate_tpu_torch.monitoring import profiling

        try:
            text = profiling.device_trace(
                self.app.db.root_path,
                seconds=float(self.query.get("seconds", 3)),
                device=self.app.db.device,
            )
        except profiling.TraceBusyError as e:
            self._reply(409, {"error": [{"message": str(e)}]})
            return
        self._reply(200, raw=text.encode(), content_type="text/plain")

    def h_pprof_goroutine(self):
        from weaviate_tpu_torch.monitoring import profiling

        self._reply(200, raw=profiling.thread_dump().encode(), content_type="text/plain")

    def h_pprof_heap(self):
        from weaviate_tpu_torch.monitoring import profiling

        text = profiling.heap_profile(limit=int(self.query.get("limit", 30)))
        self._reply(200, raw=text.encode(), content_type="text/plain")

    def h_pprof_cmdline(self):
        from weaviate_tpu_torch.monitoring import profiling

        self._reply(200, raw=profiling.cmdline().encode(), content_type="text/plain")

    # -- schema --------------------------------------------------------------

    def h_schema_list(self):
        self._reply(200, self.app.schema.get_schema().to_dict())

    def h_schema_create(self):
        body = self._json_body() or {}
        cd = self.app.schema.add_class(body)
        self._reply(200, cd.to_dict())

    def _resolved(self, cls: str) -> str:
        resolved = self.app.schema.resolve_class_name(cls)
        if resolved is None:
            raise NotFoundError(f"class {cls!r} not found")
        return resolved

    def h_schema_get(self, cls):
        cd = self.app.schema.get_class(self._resolved(cls))
        self._reply(200, cd.to_dict())

    def h_schema_update(self, cls):
        body = self._json_body() or {}
        cd = self.app.schema.update_class(self._resolved(cls), body)
        self._reply(200, cd.to_dict())

    def h_schema_delete(self, cls):
        self.app.schema.delete_class(self._resolved(cls))
        self._reply(200)

    def h_schema_add_property(self, cls):
        body = self._json_body() or {}
        prop = self.app.schema.add_property(self._resolved(cls), body)
        self._reply(200, prop.to_dict())

    def h_shards_get(self, cls):
        self._reply(200, self.app.schema.shards_status(self._resolved(cls)))

    def h_shard_update(self, cls, shard):
        body = self._json_body() or {}
        status = body.get("status", "")
        self.app.schema.update_shard_status(self._resolved(cls), shard, status)
        self._reply(200, {"status": status})

    # -- objects -------------------------------------------------------------

    def _include_vector(self) -> bool:
        return "vector" in (self.query.get("include") or "")

    def _cl(self):
        return self.query.get("consistency_level")

    def h_objects_list(self):
        objs = self.app.objects.list_objects(
            class_name=self.query.get("class"),
            limit=int(self.query.get("limit", 25)),
            offset=int(self.query.get("offset", 0)),
            after=self.query.get("after"),
            include_vector=self._include_vector(),
        )
        self._reply(200, {
            "objects": [o.to_rest(self._include_vector()) for o in objs],
            "totalResults": len(objs),
        })

    def h_objects_create(self):
        obj = self.app.objects.add(self._json_body() or {}, cl=self._cl())
        self._reply(200, obj.to_rest(include_vector=True))

    def h_objects_validate(self):
        self.app.objects.validate(self._json_body() or {})
        self._reply(200)

    def h_object_get(self, id, cls=None):
        obj = self.app.objects.get(
            id, cls, include_vector=self._include_vector(), cl=self._cl())
        self._reply(200, obj.to_rest(self._include_vector()))

    def h_object_head(self, id, cls=None):
        if self.app.objects.exists(id, cls):
            self._reply(204)
        else:
            self._reply(404)

    def h_object_put(self, id, cls=None):
        body = self._json_body() or {}
        if cls:
            body.setdefault("class", cls)
        body["id"] = id
        obj = self.app.objects.update(id, body, cl=self._cl())
        self._reply(200, obj.to_rest(include_vector=True))

    def h_object_patch(self, id, cls=None):
        body = self._json_body() or {}
        class_name = cls or body.get("class")
        if not class_name:
            raise HTTPError(422, "PATCH requires the class name")
        self.app.objects.merge(
            id, class_name, body.get("properties") or {}, vector=body.get("vector"),
            cl=self._cl())
        self._reply(204)

    def h_object_delete(self, id, cls=None):
        self.app.objects.delete(id, cls, cl=self._cl())
        self._reply(204)

    # -- references ----------------------------------------------------------

    def h_ref_add(self, cls, id, prop):
        body = self._json_body() or {}
        self.app.objects.add_reference(id, cls, prop, body.get("beacon", ""))
        self._reply(200)

    def h_ref_put(self, cls, id, prop):
        body = self._json_body()
        beacons = [b.get("beacon", "") for b in body] if isinstance(body, list) else []
        self.app.objects.put_references(id, cls, prop, beacons)
        self._reply(200)

    def h_ref_delete(self, cls, id, prop):
        body = self._json_body() or {}
        self.app.objects.delete_reference(id, cls, prop, body.get("beacon", ""))
        self._reply(204)

    # -- batch ---------------------------------------------------------------

    def h_batch_objects(self):
        body = self._json_body() or {}
        payloads = body.get("objects") or []
        results = self.app.batch.add_objects(payloads, cl=self._cl())
        out = []
        for r in results:
            if r.err:
                out.append({
                    **(r.original or {}),
                    "result": {"status": "FAILED",
                               "errors": {"error": [{"message": r.err}]}},
                })
            else:
                out.append({**r.obj.to_rest(include_vector=False),
                            "result": {"status": "SUCCESS"}})
        self._reply(200, out)

    def h_batch_delete(self):
        body = self._json_body() or {}
        match = body.get("match") or {}
        out = self.app.batch.delete_objects(
            match.get("class", ""),
            match.get("where"),
            dry_run=bool(body.get("dryRun", False)),
            output=body.get("output", "minimal"),
        )
        self._reply(200, out)

    def h_batch_references(self):
        body = self._json_body() or []
        if not isinstance(body, list):
            raise HTTPError(400, "batch references body must be a list")
        self._reply(200, self.app.batch.add_references(body))

    # -- graphql -------------------------------------------------------------

    def h_graphql(self):
        body = self._json_body() or {}
        self._reply(200, self.app.graphql.execute(
            body.get("query") or "", body.get("variables")))

    def h_graphql_batch(self):
        body = self._json_body() or []
        if not isinstance(body, list):
            raise HTTPError(400, "graphql batch body must be a list")
        pool = getattr(self.app, "serving_pool", None)
        if pool is not None and len(body) > 1:
            # coalescing on: run the slots CONCURRENTLY so their kNN
            # dispatches admission-queue into one padded device batch (the
            # REST twin of gRPC BatchSearch) instead of serializing one
            # one-wide dispatch per slot. graphql.execute returns per-query
            # error envelopes, so slot isolation matches the serial path.
            # Each slot runs under a COPY of this handler's context (one
            # copy per slot — a shared Context cannot be entered twice
            # concurrently), so the request's trace span reaches the pool
            # threads and the coalescer lanes they submit into.
            import contextvars

            ctxs = [contextvars.copy_context() for _ in body]
            out = list(pool.map(
                lambda qc: qc[1].run(
                    self.app.graphql.execute,
                    qc[0].get("query") or "", qc[0].get("variables")),
                zip(body, ctxs)))
            self._reply(200, out)
            return
        self._reply(200, [
            self.app.graphql.execute(q.get("query") or "", q.get("variables"))
            for q in body
        ])

    # -- nodes ---------------------------------------------------------------

    def h_nodes(self):
        if self.app.cluster is not None:
            self._reply(200, {"nodes": self.app.cluster.nodes_status()})
            return
        shards = []
        total = 0
        for cls, idx in self.app.db.indexes.items():
            for name, shard in idx.shards.items():
                cnt = shard.object_count()
                total += cnt
                shards.append({"name": name, "class": cls, "objectCount": cnt})
        self._reply(200, {"nodes": [{
            "name": self.app.config.cluster.hostname or "node1",
            "status": "HEALTHY",
            "version": VERSION,
            "gitHash": "",
            "stats": {"objectCount": total, "shardCount": len(shards)},
            "shards": shards,
        }]})

    # -- backups / classifications (wired when subsystems present) -----------

    def _backup_or_501(self):
        if self.app.backup_scheduler is None:
            raise HTTPError(501, "backup subsystem not configured")
        return self.app.backup_scheduler

    def h_backup_create(self, backend):
        s = self._backup_or_501()
        body = self._json_body() or {}
        self._reply(200, s.backup(backend, body))

    def h_backup_status(self, backend, id):
        s = self._backup_or_501()
        self._reply(200, s.backup_status(backend, id))

    def h_backup_restore(self, backend, id):
        s = self._backup_or_501()
        body = self._json_body() or {}
        self._reply(200, s.restore(backend, id, body))

    def h_backup_restore_status(self, backend, id):
        s = self._backup_or_501()
        self._reply(200, s.restore_status(backend, id))

    def _classifier_or_501(self):
        if self.app.classifier is None:
            raise HTTPError(501, "classification subsystem not configured")
        return self.app.classifier

    def h_classification_create(self):
        c = self._classifier_or_501()
        self._reply(201, c.schedule(self._json_body() or {}))

    def h_classification_get(self, id):
        c = self._classifier_or_501()
        st = c.get(id)
        if st is None:
            raise NotFoundError(f"classification {id} not found")
        self._reply(200, st)

    def h_module_rest(self, module, rest):
        if self.app.modules is None:
            self._reply(404, _err_body("no modules enabled"))
            return
        body = self._json_body() if self.command in ("POST", "PUT") else None
        status, payload = self.app.modules.handle_module_rest(
            module, self.command, rest, body)
        self._reply(status, payload)


class _MetricsHandler(BaseHTTPRequestHandler):
    """Dedicated metrics listener (configure_api.go:116-121: Prometheus on
    its own port when PROMETHEUS_MONITORING_ENABLED)."""

    app = None

    def log_message(self, fmt, *args):
        pass

    def do_GET(self):
        if urlparse(self.path).path != "/metrics":
            self.send_error(404)
            return
        data = self.app.metrics.expose()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


class _Server(ThreadingHTTPServer):
    # pending connections the listener holds before the kernel resets
    # new ones (socketserver's default is 5)
    request_queue_size = socket.SOMAXCONN


class RestServer:
    """Threaded HTTP server hosting the /v1 surface for an App."""

    def __init__(self, app, host: str = "127.0.0.1", port: int = 8080):
        self.app = app
        handler = type("BoundHandler", (Handler,), {"app": app})
        self.httpd = _Server((host, port), handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self._metrics_httpd: Optional[ThreadingHTTPServer] = None
        self._metrics_thread: Optional[threading.Thread] = None
        if app.config.monitoring.enabled:
            mhandler = type("BoundMetricsHandler", (_MetricsHandler,), {"app": app})
            self._metrics_httpd = _Server(
                (host, app.config.monitoring.port), mhandler)
            self._metrics_httpd.daemon_threads = True
            self.metrics_port = self._metrics_httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        if self._metrics_httpd is not None:
            self._metrics_thread = threading.Thread(
                target=self._metrics_httpd.serve_forever, daemon=True)
            self._metrics_thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        if self._metrics_httpd is not None:
            self._metrics_httpd.shutdown()
            self._metrics_httpd.server_close()
            if self._metrics_thread:
                self._metrics_thread.join(timeout=5)
