"""What the host did around a window, to tell a server that does more
work from a host that runs it slower: the server process's CPU time over
the window, and a fixed piece of pure-Python work timed on this
process's cores before and after it. None of it is a metric; a run prints
it beside its path facts."""

from __future__ import annotations

import os
import time


def process_cpu_s(pid: int) -> float:
    """User plus system seconds of process `pid` and its threads."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return float("nan")


def calib_ms() -> float:
    """Milliseconds a fixed piece of pure-Python work takes here."""
    t = time.perf_counter()
    acc = 0
    for i in range(400_000):
        acc += i * i % 7
    return (time.perf_counter() - t) * 1e3


def server_cpu(pid: int, cpu_before: float, seconds: float, rows: int) -> dict:
    """The server's CPU over a window of `seconds` that began when its CPU
    time read `cpu_before` and did `rows` queries or objects: the cores it
    kept busy on average, and its CPU microseconds a row."""
    cpu = process_cpu_s(pid) - cpu_before
    return {"server_cores": cpu / seconds if seconds > 0 else None,
            "server_cpu_us_per_row": cpu / rows * 1e6 if rows else None}
