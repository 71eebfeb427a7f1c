# The port's copy of weaviate_tpu/cluster/gossip.py, its imports pointed at the port.
"""UDP gossip membership: seed-based auto-discovery + failure detection.

Reference: usecases/cluster/state.go:38 wraps hashicorp memberlist — nodes
join via a seed list, the member table propagates epidemically, and failed
nodes are detected by timeout. This is the same protocol family
(heartbeat-table gossip, van Renesse style) built directly on a UDP socket:

- every node keeps a table {name -> (data host, gossip addr, heartbeat)}
  and bumps its OWN heartbeat each tick;
- each tick the full table goes to `fanout` random peers; receivers merge
  per entry by highest heartbeat (piggybacked node metadata travels with
  the same message);
- a JOIN to one seed address is enough: the seed replies with its table
  (push-pull), and subsequent ticks spread the newcomer cluster-wide;
- an entry whose heartbeat has not advanced within `suspect_after` seconds
  is SUSPECT (marked not-alive in ClusterState so reads fail over), and
  after `dead_after` it is DEAD; a returning node's advancing heartbeat
  revives it.

The transport feeds the existing ClusterState — every surface that reads
membership (AllNames, node_address, is_alive, health score) is unchanged,
exactly the seam membership.py promised a gossip transport could fill.
"""

from __future__ import annotations

import json
import random
import socket
import threading
import time
from typing import Optional

_MAX_DGRAM = 60_000


class GossipTransport:
    def __init__(
        self,
        state,                       # ClusterState to keep in sync
        local_name: str,
        data_host: str,              # this node's cluster-API "host:port"
        bind_host: str = "127.0.0.1",
        bind_port: int = 0,
        advertise_host: Optional[str] = None,
        interval: float = 1.0,
        fanout: int = 2,
        suspect_after: float = 4.0,
        dead_after: float = 12.0,
        reap_after: Optional[float] = None,
    ):
        self.state = state
        self.local_name = local_name
        self.interval = interval
        self.fanout = fanout
        self.suspect_after = suspect_after
        self.dead_after = dead_after
        # dead entries are RETRIED (partition healing) until reaped, then
        # forgotten entirely (memberlist's dead-node reclaim)
        self.reap_after = reap_after if reap_after is not None else 10 * dead_after
        self._ticks = 0
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((bind_host, bind_port))
        self._sock.settimeout(0.5)
        port = self._sock.getsockname()[1]
        if advertise_host is None and bind_host == "0.0.0.0":
            # "all interfaces" is not dialable; advertise a concrete host
            try:
                advertise_host = socket.gethostbyname(socket.gethostname())
            except OSError:
                advertise_host = "127.0.0.1"
        self.gossip_addr = f"{advertise_host or bind_host}:{port}"
        # name -> {host, gossip, hb}; _seen maps name -> monotonic time the
        # heartbeat last ADVANCED (local observation, never gossiped)
        self._table: dict[str, dict] = {
            local_name: {"host": data_host, "gossip": self.gossip_addr, "hb": 0}
        }
        self._seen: dict[str, float] = {local_name: time.monotonic()}
        self._statuses: dict[str, str] = {local_name: "alive"}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._seeds: list[str] = []
        state.register(local_name, data_host)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        for fn, name in ((self._recv_loop, "gossip-recv"),
                         (self._tick_loop, "gossip-tick")):
            t = threading.Thread(target=fn, daemon=True, name=name)
            t.start()
            self._threads.append(t)

    def shutdown(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    def join(self, seeds: list[str]) -> None:
        """Contact seed gossip addresses ('host:port'); one reachable seed
        is enough for cluster-wide visibility. Seeds are remembered and
        re-contacted every tick while the table has no remote member — a
        dropped JOIN datagram (UDP) must not isolate the node forever."""
        self._seeds = list(seeds)
        for seed in seeds:
            self._send(seed, kind="join")

    # -- wire ----------------------------------------------------------------

    def _payload(self, kind: str) -> bytes:
        with self._lock:
            msg = {"t": kind, "from": self.gossip_addr, "nodes": self._table}
            return json.dumps(msg, separators=(",", ":")).encode()

    def _send(self, addr: str, kind: str = "sync") -> None:
        host, _, port = addr.rpartition(":")
        try:
            data = self._payload(kind)
            if len(data) <= _MAX_DGRAM:
                self._sock.sendto(data, (host, int(port)))
        except (OSError, ValueError):
            pass  # unreachable peers are what the failure detector is for

    def _recv_loop(self) -> None:
        while not self._stop.is_set():
            try:
                data, _ = self._sock.recvfrom(_MAX_DGRAM)
            except socket.timeout:
                continue
            except OSError:
                return  # socket closed on shutdown
            try:
                msg = json.loads(data)
                nodes = msg.get("nodes") or {}
                if not isinstance(nodes, dict):
                    continue
                self._merge(nodes)
                if msg.get("t") == "join" and msg.get("from"):
                    # push-pull: a joiner learns the whole table immediately
                    self._send(str(msg["from"]), kind="sync")
            except Exception:  # noqa: BLE001 — one bad datagram must not
                continue      # kill the recv thread (one-packet DoS)

    def _merge(self, nodes: dict) -> None:
        now = time.monotonic()
        with self._lock:
            for name, entry in nodes.items():
                if not isinstance(entry, dict):
                    continue
                if name == self.local_name:
                    # rejoin-after-restart: if the cluster remembers a higher
                    # heartbeat for us, jump past it so our fresh entries win
                    # immediately (memberlist's incarnation refutation)
                    me = self._table[name]
                    me["hb"] = max(me["hb"], int(entry.get("hb", 0)) + 1)
                    continue
                hb = int(entry.get("hb", 0))
                cur = self._table.get(name)
                if cur is None or hb > cur["hb"]:
                    new = {
                        "host": str(entry.get("host", "")),
                        "gossip": str(entry.get("gossip", "")),
                        "hb": hb,
                    }
                    self._table[name] = new
                    self._seen[name] = now
                    if cur is None:
                        self.state.register(name, new["host"])
                        self._statuses[name] = "alive"
                        self.state.mark(name, True)
                    elif cur.get("host") != new["host"]:
                        # a member rescheduled onto a new data address:
                        # ClusterState must resolve the CURRENT endpoint
                        self.state.register(name, new["host"])

    # -- failure detection + dissemination ------------------------------------

    def _tick_loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — gossip must survive anything
                pass

    def _tick(self) -> None:
        now = time.monotonic()
        self._ticks += 1
        with self._lock:
            me = self._table[self.local_name]
            me["hb"] += 1
            self._seen[self.local_name] = now
            # sweep: heartbeat age decides alive/suspect/dead/reaped
            for name in list(self._table):
                if name == self.local_name:
                    continue
                age = now - self._seen.get(name, 0.0)
                if age > self.reap_after:
                    # permanently gone: forget the entry so late joiners
                    # stop learning (and dialing) a node that will never
                    # answer; a genuine return re-joins like a new node
                    self._table.pop(name, None)
                    self._seen.pop(name, None)
                    self._statuses.pop(name, None)
                    self.state.remove(name)
                    continue
                if age > self.dead_after:
                    status = "dead"
                elif age > self.suspect_after:
                    status = "suspect"
                else:
                    status = "alive"
                if self._statuses.get(name) != status:
                    self._statuses[name] = status
                    self.state.mark(name, status == "alive")
            peers = [
                e["gossip"] for n, e in self._table.items()
                if n != self.local_name and e.get("gossip")
                and self._statuses.get(n) != "dead"
            ]
            dead = [
                e["gossip"] for n, e in self._table.items()
                if n != self.local_name and e.get("gossip")
                and self._statuses.get(n) == "dead"
            ]
        if not peers and not dead and self._seeds:
            # still alone: the initial JOIN datagram may have been lost —
            # keep knocking on the seeds until someone answers
            for seed in self._seeds:
                self._send(seed, kind="join")
        for addr in random.sample(peers, min(self.fanout, len(peers))):
            self._send(addr)
        if dead and self._ticks % 5 == 0:
            # periodic contact attempt to one dead member: a SYMMETRIC
            # partition longer than dead_after must still heal once the
            # network returns (both sides would otherwise ignore each other
            # forever)
            self._send(random.choice(dead))

    # -- introspection (tests, /v1/nodes debugging) ---------------------------

    def status(self, name: str) -> Optional[str]:
        with self._lock:
            return self._statuses.get(name)

    def members(self) -> dict[str, dict]:
        with self._lock:
            return {n: dict(e) for n, e in self._table.items()}
