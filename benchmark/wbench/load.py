"""The general load generator: the clients a traffic file describes.

Two protocols, each a user's client of the port's server:
  grpc_batch_search   closed loop, `clients` callers, each with its own
                      channel, each sending its next BatchSearch when the
                      last one answered;
  rest_batch_import   closed loop of POST /v1/batch/objects, the bodies
                      made ahead by a feed process (`import_feed.py`).
Every request sent in the window is recorded (`Req`); a request that
fails counts as failed, never as fast. Inside the loop a caller only
sends and receives: bodies are made before the window or by the feed,
and replies are judged once the window has closed, so the client's own
work does not sit in the cycle the window times.
"""

from __future__ import annotations

import http.client
import json
import random
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional



@dataclass
class Req:
    key: int             # the pool entry or import batch it sent
    rows: int            # queries or objects it carried
    due: float           # perf_counter: when it fell due (closed loop: sent)
    sent: float = 0.0
    done: float = 0.0
    ok: bool = False
    error: str = ""
    caller: int = 0      # the closed-loop caller that sent it
    raw: bytes = b""     # the reply, until it is judged after the window


@dataclass
class Window:
    start: float
    end: float
    reqs: list = field(default_factory=list)


class Reservoir:
    """A seeded uniform sample of `size` items from a stream of unknown
    length: `slot()` says where the next item goes (None: not kept), so a
    caller builds only the items it keeps."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.items, self.seen = size, random.Random(seed), [], 0
        self.lock = threading.Lock()

    def slot(self) -> Optional[int]:
        with self.lock:
            self.seen += 1
            if len(self.items) < self.size:
                self.items.append(None)
                return len(self.items) - 1
            j = self.rng.randrange(self.seen)
            return j if j < self.size else None

    def put(self, slot: int, item) -> None:
        with self.lock:
            self.items[slot] = item


def _run_threads(fns) -> None:
    threads = [threading.Thread(target=f, daemon=True) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise RuntimeError("a client thread did not finish within 600 s")


# -- gRPC BatchSearch, closed loop ---------------------------------------------------

def grpc_batch_search(target: str, bodies: list, clients: int, seconds: float, k: int,
                      keep: Reservoir, timeout: float = 120.0) -> Window:
    """`clients` closed-loop callers of BatchSearch over the pre-encoded
    `bodies` ([(request bytes, queries)]); the replies are judged, and
    `keep` filled, once the window has closed (`judge_batch_replies`)."""
    import grpc

    from wbench import wire

    wire.parse_batch_reply(b"")  # build the message classes before the threads start
    win = Window(start=time.perf_counter(), end=0.0)
    win.end = win.start + seconds
    lock = threading.Lock()

    def client(c: int) -> None:
        chan = grpc.insecure_channel(target, options=wire.CHANNEL_OPTIONS)
        call = chan.unary_unary(wire.BATCH_SEARCH)
        mine, j = [], 0
        try:
            while True:
                t0 = time.perf_counter()
                if t0 >= win.end:
                    break
                key = (c + j * clients) % len(bodies)
                j += 1
                body, rows = bodies[key]
                r = Req(key=key, rows=rows, due=t0, sent=t0, caller=c)
                try:
                    r.raw = call(body, timeout=timeout)
                    r.done = time.perf_counter()
                    r.ok = True
                except grpc.RpcError as e:
                    r.done = time.perf_counter()
                    r.error = f"{e.code()}: {e.details()}"
                mine.append(r)
        finally:
            chan.close()
            with lock:
                win.reqs.extend(mine)

    _run_threads([lambda c=c: client(c) for c in range(clients)])
    judge_batch_replies(win, k, keep)
    return win


def judge_batch_replies(win: Window, k: int, keep: Reservoir) -> None:
    """After the window: each reply that came back is parsed; one with
    fewer answers than queries, an answer with an error or fewer than k
    results, fails its request. `keep` takes a seeded sample of the
    replies, in the order they were sent."""
    from wbench import wire

    for r in sorted(win.reqs, key=lambda r: (r.sent, r.caller)):
        if not r.ok:
            continue
        reply = wire.parse_batch_reply(r.raw)
        r.raw = b""
        errs = [one.error_message for one in reply.replies if one.error_message]
        short = sum(len(one.results) < k for one in reply.replies)
        if len(reply.replies) != r.rows or errs or short:
            r.ok = False
            r.error = (f"{len(reply.replies)} of {r.rows} slots answered, {short} "
                       f"short; {errs[:1]}")
        slot = keep.slot()
        if slot is not None:
            keep.put(slot, (r.key, [([x.id for x in one.results],
                                     [x.distance for x in one.results])
                                    for one in reply.replies]))


def client_share(win: Window) -> float:
    """The share of the window in which a closed-loop caller was between
    a reply and its next request: the client's own work in the cycle,
    averaged over the callers."""
    callers: dict = {}
    for r in win.reqs:
        callers.setdefault(r.caller, []).append(r)
    idle = 0.0
    for reqs in callers.values():
        reqs.sort(key=lambda r: r.sent)
        idle += sum(max(b.sent - a.done, 0.0) for a, b in zip(reqs, reqs[1:]))
    return idle / max(len(callers) * (win.end - win.start), 1e-9)


# -- REST -----------------------------------------------------------------------------

class Http:
    """One keep-alive HTTP/1.1 connection to the server."""

    def __init__(self, port: int, timeout: float = 120.0):
        self.port, self.timeout = port, timeout
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)

    def request(self, method: str, path: str, body: Optional[bytes] = None):
        headers = {"Content-Type": "application/json"} if body is not None else {}
        try:
            self.conn.request(method, path, body=body, headers=headers)
            resp = self.conn.getresponse()
            data = resp.read()
        except (OSError, http.client.HTTPException):
            # a dropped keep-alive connection: one fresh connection, one retry
            self.conn.close()
            self.conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=self.timeout)
            self.conn.request(method, path, body=body, headers=headers)
            resp = self.conn.getresponse()
            data = resp.read()
        return resp.status, data

    def close(self) -> None:
        self.conn.close()


def gql_near_vector(class_name: str, vector_text: bytes, k: int) -> bytes:
    """POST /v1/graphql body: Get nearVector, ids and distances."""
    q = (b"{ Get { " + class_name.encode() + b"(nearVector: {vector: [" + vector_text
         + b"]}, limit: " + str(int(k)).encode() + b") { _additional { id distance } } } }")
    return json.dumps({"query": q.decode()}).encode()


def gql_answer(class_name: str, data: bytes) -> tuple[list, list]:
    doc = json.loads(data)
    if doc.get("errors"):
        raise ValueError(str(doc["errors"])[:300])
    rows = doc["data"]["Get"][class_name]
    return ([r["_additional"]["id"] for r in rows],
            [float(r["_additional"]["distance"]) for r in rows])


class ImportFeed:
    """The import bodies, made ahead of the caller by a child process
    (`import_feed.py`) from the seed, batch `first` on, and read from its
    pipe: (batch, body, objects)."""

    def __init__(self, spec: dict):
        import subprocess
        import sys
        from pathlib import Path

        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).with_name("import_feed.py")), json.dumps(spec)],
            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE)
        try:  # room for a few bodies ahead (Linux: F_SETPIPE_SZ)
            import fcntl
            fcntl.fcntl(self.proc.stdout.fileno(), 1031, 1 << 20)
        except (ImportError, OSError):
            pass
        self.per = int(spec["per"])
        self.lock = threading.Lock()

    def next(self) -> tuple[int, bytes, int]:
        with self.lock:
            head = self.proc.stdout.read(16)
            if len(head) != 16:
                raise OSError(f"the import feed ended (exit code {self.proc.poll()})")
            b, n = struct.unpack("<qQ", head)
            body = self.proc.stdout.read(n)
        return b, body, self.per

    def close(self) -> None:
        import subprocess

        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            self.proc.wait(30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(30)
        self.proc.stdout.close()


def batch_import(port: int, next_body: Callable[[], tuple[int, bytes, int]], clients: int,
                 seconds: float, acked: dict) -> Window:
    """Closed loop of POST /v1/batch/objects; next_body() -> (batch, body,
    objects). Once the window has closed, acked[batch] = the objects of a
    batch every one of whose objects came back SUCCESS."""
    win = Window(start=time.perf_counter(), end=0.0)
    win.end = win.start + seconds
    lock = threading.Lock()

    def client(c: int) -> None:
        conn, mine = Http(port), []
        try:
            while True:
                t0 = time.perf_counter()
                if t0 >= win.end:
                    break
                b, body, rows = next_body()
                r = Req(key=b, rows=rows, due=time.perf_counter(), caller=c)
                r.sent = r.due
                try:
                    st, r.raw = conn.request("POST", "/v1/batch/objects", body)
                    r.done = time.perf_counter()
                    r.ok = st == 200
                    if not r.ok:
                        r.error = f"HTTP {st}: {r.raw[:200]!r}"
                except (OSError, http.client.HTTPException) as e:
                    r.done = time.perf_counter()
                    r.error = f"{type(e).__name__}: {e}"[:300]
                mine.append(r)
        finally:
            conn.close()
            with lock:
                win.reqs.extend(mine)

    _run_threads([lambda c=c: client(c) for c in range(clients)])
    for r in win.reqs:
        if not r.ok:
            continue
        try:
            res = json.loads(r.raw)
        except ValueError:
            res = None
        r.raw = b""
        good = (sum(1 for o in res if isinstance(o, dict)
                    and o.get("result", {}).get("status") == "SUCCESS")
                if isinstance(res, list) else 0)
        if good == r.rows and len(res) == r.rows:
            acked[r.key] = r.rows
        else:
            r.ok = False
            r.error = f"{good} of {r.rows} objects acknowledged"
    return win
