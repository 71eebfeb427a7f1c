"""`python -m weaviate_tpu_torch`: the port's process entry point serves
REST and gRPC on the CPU when asked with `--device cpu`, answers
readiness, and stops cleanly on SIGTERM; without a card and without
`--device cpu` it exits non-zero with the device's message; and importing
the port's serving chain (App, REST, gRPC, the entry point) loads neither
jax nor anything of weaviate_tpu."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _sigterm_state_restored():
    """Each package's App chains its device-trace teardown onto SIGTERM.
    Put the handler and both packages' teardown state back after this
    module, so later tests in the same process find them as they were."""
    from weaviate_tpu.monitoring import profiling as jax_profiling
    from weaviate_tpu_torch.monitoring import profiling as torch_profiling

    mods, keys = (jax_profiling, torch_profiling), ("signal_installed", "prev_sigterm")
    handler = signal.getsignal(signal.SIGTERM)
    states = [{k: m._teardown_state[k] for k in keys} for m in mods]
    yield
    signal.signal(signal.SIGTERM, handler)
    for m, st in zip(mods, states):
        m._teardown_state.update(st)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env.update(extra)
    return env


def _wait_ready(proc, port, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/v1/.well-known/ready", timeout=2) as r:
                return r.status == 200
        except OSError:
            if proc.poll() is not None:
                raise AssertionError(f"server exited early:\n{proc.stdout.read()}")
            time.sleep(0.2)
    return False


def test_main_on_cpu_serves_and_stops_on_sigterm(tmp_path):
    port, gport = _free_port(), _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "weaviate_tpu_torch", "--device", "cpu",
         "--host", "127.0.0.1", "--port", str(port), "--grpc-port", str(gport),
         "--data-path", str(tmp_path / "data")],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        assert _wait_ready(proc, port), "server never became ready"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/meta", timeout=5) as r:
            assert "version" in json.loads(r.read())
        socket.create_connection(("127.0.0.1", gport), timeout=5).close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        out = proc.stdout.read()
        assert "serving on cpu" in out and "shutdown complete" in out
    finally:
        if proc.poll() is None:
            proc.kill()


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]], ids=["default", "cuda"])
def test_main_without_a_card_exits_nonzero(tmp_path, argv):
    out = subprocess.run(
        [sys.executable, "-m", "weaviate_tpu_torch", "--port", str(_free_port()),
         "--grpc-port", str(_free_port()), "--data-path", str(tmp_path / "data"), *argv],
        env=_env(CUDA_VISIBLE_DEVICES=""), cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "CUDA device" in out.stderr and "device='cpu'" in out.stderr
    assert not (tmp_path / "data").exists()


def test_serving_chain_imports_no_jax_or_reference_module():
    code = ("import sys\n"
            "before = set(sys.modules)\n"
            "import weaviate_tpu_torch.server, weaviate_tpu_torch.server.app, "
            "weaviate_tpu_torch.server.rest, weaviate_tpu_torch.server.grpc_server, "
            "weaviate_tpu_torch.server.reply_native, weaviate_tpu_torch.__main__, "
            "weaviate_tpu_torch.serving.coalescer, weaviate_tpu_torch.serving.controller, "
            "weaviate_tpu_torch.monitoring.profiling, weaviate_tpu_torch.graphql, "
            "weaviate_tpu_torch.usecases.backup, weaviate_tpu_torch.usecases.classification, "
            "weaviate_tpu_torch.auth.oidc\n"
            "bad = sorted(m for m in set(sys.modules) - before if m.startswith('jax') "
            "or m.split('.')[0] == 'weaviate_tpu')\n"
            "print(','.join(bad))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


@pytest.mark.parametrize("env, item", [
    ({"IVF_ENABLED": "true"}, "item 9"),
    ({"TPU_DEVICE_MESH_SHARDS": "2"}, "item 10"),
    ({"ENABLE_MODULES": "text2vec-local"}, "item 14"),
    ({"CLUSTER_HOSTNAME": "node-1"}, "item 15"),
], ids=["ivf", "mesh", "modules", "cluster"])
def test_app_refuses_what_the_port_does_not_serve_yet(tmp_path, env, item):
    from weaviate_tpu_torch.config import load_config
    from weaviate_tpu_torch.server import App

    with pytest.raises(ValueError, match=item):
        App(config=load_config(env), data_path=str(tmp_path), device="cpu")


def test_app_needs_a_card_or_an_explicit_cpu(tmp_path, monkeypatch):
    import torch

    from weaviate_tpu_torch.config import Config
    from weaviate_tpu_torch.server import App

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        App(config=Config(), data_path=str(tmp_path / "a"))
    app = App(config=Config(), data_path=str(tmp_path / "b"), device="cpu")
    try:
        assert app.device.type == "cpu" and app.db.device.type == "cpu"
    finally:
        app.shutdown()


@pytest.mark.parametrize("order", ["jax_first", "torch_first"])
def test_both_packages_sigterm_teardowns_chain_in_either_order(monkeypatch, order):
    """Two Apps of the two packages in one process each install their
    trace teardown on SIGTERM; whichever comes second chains the first,
    so one SIGTERM runs both teardowns and then the process's own
    handler."""
    from weaviate_tpu.monitoring import profiling as jax_profiling
    from weaviate_tpu_torch.monitoring import profiling as torch_profiling

    ran = []
    mods = [jax_profiling, torch_profiling]
    if order == "torch_first":
        mods.reverse()
    for m in mods:
        monkeypatch.setitem(m._teardown_state, "signal_installed", False)
        monkeypatch.setattr(m, "stop_active_trace",
                            lambda m=m: ran.append(m.__name__.split(".")[0]))
    signal.signal(signal.SIGTERM, lambda *a: ran.append("process"))
    for m in mods:
        assert m.install_trace_teardown() is True
    signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
    assert ran == [mods[1].__name__.split(".")[0], mods[0].__name__.split(".")[0], "process"]
