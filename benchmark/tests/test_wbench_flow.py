"""The harness as a whole on the CPU: a cell, a configuration, a traffic mix
and a metric added from files alone; nothing loads JAX or the JAX package;
the rehearsal of the run command; the controls and the broken paths come
out not correct."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from wbench import isolation, spec

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def test_a_cell_is_added_from_files_alone(tmp_path):
    (tmp_path / "benchmark" / "configs").mkdir(parents=True)
    (tmp_path / "benchmark" / "traffic").mkdir()
    (tmp_path / "benchmark" / "metrics").mkdir()
    (tmp_path / "benchmark" / "configs" / "tiny-conf.json").write_text(
        json.dumps({"name": "tiny-conf", "n_objects": 10}))
    (tmp_path / "benchmark" / "traffic" / "tiny-mix.json").write_text(
        json.dumps({"protocol": "grpc_batch_search", "clients": 5}))
    (tmp_path / "benchmark" / "metrics" / "answered.tiny.py").write_text(
        "def read(run):\n    return run.rows_done * 2\n")
    bench = {"configs": [{"name": "tiny-conf", "file": "benchmark/configs/tiny-conf.json"}],
             "workloads": [{"name": "tiny-conf.tiny-mix", "config": "tiny-conf",
                            "traffic": "tiny-mix", "chips": 1}],
             "end_to_end": [{"name": "setup_s"}],
             "per_layer": [{"name": "answered.tiny", "workloads": ["tiny-conf.tiny-mix"]},
                           {"name": "elsewhere", "workloads": ["other"]}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("tiny-conf.tiny-mix", root=tmp_path)
    assert cell.config["n_objects"] == 10 and cell.traffic["clients"] == 5
    assert [m["name"] for m in cell.per_layer] == ["answered.tiny"]
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]

    class Run:
        rows_done = 21
    assert spec.metric_reader("answered.tiny", root=tmp_path)(Run()) == 42


def test_every_cell_and_metric_of_the_benchmark_resolves():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert cell.config["class"]["class"]
        assert cell.traffic["protocol"] in ("grpc_batch_search", "rest_batch_import")
        assert set(cell.config["limits"][cell.traffic["protocol"]])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = isolation.imported_names(f) & set(isolation.FORBIDDEN)
        assert not bad, f"{f} imports {bad}"
    # whole names: the port is not the JAX package
    assert isolation.loaded(["weaviate_tpu_torch.server", "numpy"]) == []
    assert isolation.loaded(["weaviate_tpu.index", "jaxlib.xla"]) == ["jaxlib", "weaviate_tpu"]


def test_the_reference_imports_nothing_of_the_program():
    seen, todo = set(), ["reference"]
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        names = isolation.imported_names(BENCH / "wbench" / f"{mod}.py")
        assert "weaviate_tpu_torch" not in names and "weaviate_tpu" not in names
        todo += [n for n in names if (BENCH / "wbench" / f"{n}.py").exists()]
    code = ("import sys; sys.path.insert(0, %r); import wbench.reference; "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('weaviate')"
            " or m.split('.')[0] in ('jax', 'jaxlib', 'flax')))" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def run_cmd(*args, fault="", timeout=600):
    code = ("import sys; sys.path.insert(0, 'benchmark'); import run; "
            f"sys.exit(run.main({list(args)!r}, fault={fault!r}))")
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=timeout)


def last_json(out):
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "nytimes-256-cosine.grpc-batch256", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_the_run_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "nytimes-256-cosine.grpc-batch256", "--seed", "1", "--seconds", "1",
                          "--trace", "0", "--rehearse"], capture_output=True, text=True,
                         cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("workload,trace", [
    ("nytimes-256-cosine.grpc-batch256", 1),
    ("sphere-768-dot-pq96.grpc-batch256", 0),
    ("nytimes-256-cosine.import-batch100", 1),
])
def test_cpu_rehearsal_of_the_run_command(workload, trace):
    out = run_cmd("--workload", workload, "--seed", "3000000019", "--seconds", "1.5",
                  "--trace", str(trace), "--rehearse")
    assert out.returncode == 0, out.stderr[-3000:]
    res = last_json(out)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert res["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    names = set(res["metrics"])
    # no number from the CPU under a device metric's name
    assert not any(n.startswith(("device_idle_pct", "search_roofline")) for n in names)
    if not trace:
        assert "setup_s" in names
    for n, c in res["checks"].items():
        assert c["value"] <= c["limit"], n
    assert "check " in out.stderr.strip().splitlines()[-1]


@pytest.mark.parametrize("workload,fault", [
    ("nytimes-256-cosine.grpc-batch256", "alter"),
    ("nytimes-256-cosine.grpc-batch256", "drop_half"),
    ("sphere-768-dot-pq96.grpc-batch256", "short"),
    ("nytimes-256-cosine.grpc-batch256", "repeat"),
    ("sphere-768-dot-pq96.grpc-batch256", "reverse"),
    ("nytimes-256-cosine.import-batch100", "import_alter"),
    ("nytimes-256-cosine.import-batch100", "import_drop_half"),
])
def test_a_broken_timed_path_comes_out_not_correct(workload, fault):
    out = run_cmd("--workload", workload, "--seed", "77", "--seconds", "1.5", "--trace", "0",
                  "--rehearse", fault=fault)
    assert out.returncode == 0, out.stderr[-3000:]
    res = last_json(out)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("workload", ["nytimes-256-cosine.grpc-batch256",
                                      "sphere-768-dot-pq96.grpc-batch256",
                                      "nytimes-256-cosine.import-batch100"])
def test_the_control_fails_the_limits(workload):
    out = subprocess.run([sys.executable, "benchmark/control.py", "--workload", workload,
                          "--seeds", "5,6,7", "--rehearse"], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    cell = spec.load_cell(workload)
    limits = cell.config["limits"][cell.traffic["protocol"]]
    for line in out.stdout.strip().splitlines():
        r = json.loads(line)
        assert any(r[n] > limits[n] for n in limits), r


@pytest.mark.card
def test_a_short_run_on_the_card_is_correct(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "nytimes-256-cosine.grpc-batch256", "--seed", "4242", "--seconds",
                          "5", "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = last_json(out)
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert res["device"]["memory_peak_bytes"] > 0


@pytest.mark.card
def test_the_control_fails_on_the_card_at_the_cells_size(card):
    out = subprocess.run([sys.executable, "benchmark/control.py", "--workload",
                          "nytimes-256-cosine.grpc-batch256", "--seeds", "1,2,3"],
                         capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    limits = spec.load_cell("nytimes-256-cosine.grpc-batch256").config["limits"][
        "grpc_batch_search"]
    for line in out.stdout.strip().splitlines():
        r = json.loads(line)
        assert r["dist_gap"] > limits["dist_gap"] and r["kth_gap"] > limits["kth_gap"]
