"""The parent's handle on the server child (`launcher.py`)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

from wbench.spec import HERE, ROOT


class ServerError(RuntimeError):
    pass


def split_cores() -> tuple[set, set]:
    """(the server's cores, the clients' cores): the clients take the last
    quarter of this process's cores (at least one), the server the rest, so
    the load generator does not run on the server's cores, as a user's
    clients run on other machines. One core: both share it."""
    cores = sorted(os.sched_getaffinity(0))
    n_client = max(1, len(cores) // 4)
    if len(cores) < 2:
        return set(cores), set(cores)
    return set(cores[:-n_client]), set(cores[-n_client:])


class Server:
    def __init__(self, spec: dict, env: dict, log_path: str, cores: set = None):
        self.log_path = log_path
        self._log = open(log_path, "wb")
        self.proc = subprocess.Popen(
            [sys.executable, str(HERE / "launcher.py"), json.dumps(spec)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self._log,
            cwd=str(ROOT), env=env, text=True,
            preexec_fn=(lambda: os.sched_setaffinity(0, cores)) if cores else None)
        self.info: dict = {}
        self.data_path = spec["data_path"]

    def _line(self, timeout: float) -> dict:
        out: list = []
        t = threading.Thread(target=lambda: out.append(self.proc.stdout.readline()),
                             daemon=True)
        t.start()
        t.join(timeout)
        if not out or not out[0]:
            raise ServerError(f"the server gave no answer within {timeout:.0f} s "
                              f"(exit code {self.proc.poll()}):\n{self.log_tail()}")
        return json.loads(out[0])

    def wait_ready(self, timeout: float) -> dict:
        self.info = self._line(timeout)
        return self.info

    def call(self, cmd: str, timeout: float = 120.0) -> dict:
        self.proc.stdin.write(json.dumps({"cmd": cmd}) + "\n")
        self.proc.stdin.flush()
        return self._line(timeout)

    def data_bytes(self) -> int:
        """Bytes of every file under the server's data directory."""
        total = 0
        for d, _, files in os.walk(self.data_path):
            for f in files:
                try:
                    total += os.stat(os.path.join(d, f)).st_size
                except FileNotFoundError:
                    pass  # a segment replaced between the listing and the stat
        return total

    def stop(self, timeout: float = 60.0) -> None:
        """Shut the server down and wait for it; kill it if it hangs."""
        try:
            if self.proc.poll() is None:
                try:
                    self.call("stop", timeout)
                except (ServerError, OSError, ValueError):
                    pass
            try:
                self.proc.wait(timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(30)
        finally:
            self._log.close()

    def log_tail(self, n: int = 4000) -> str:
        try:
            if not self._log.closed:
                self._log.flush()
            data = Path(self.log_path).read_bytes()
        except OSError:
            return ""
        return data[-n:].decode("utf-8", "replace")


def child_env(extra: dict) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + (
        [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.update({k: str(v) for k, v in extra.items()})
    return env
