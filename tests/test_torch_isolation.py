"""The port stands alone: weaviate_tpu_torch and chip_smoke.py import
neither jax nor anything of weaviate_tpu, and the port's entry points
refuse to run without a card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "weaviate_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "weaviate_tpu"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert not (_imported_roots(path) & FORBIDDEN), path


def test_import_loads_no_jax_or_reference_module():
    code = ("import sys\n"
            "before = set(sys.modules)\n"
            "import weaviate_tpu_torch.index, weaviate_tpu_torch.index.gpu, "
            "weaviate_tpu_torch.state, weaviate_tpu_torch.tools.profile_gmin, "
            "weaviate_tpu_torch.db.shard, weaviate_tpu_torch.monitoring.incidents\n"
            "bad = sorted(m for m in set(sys.modules) - before if m.startswith('jax') "
            "or m.split('.')[0] == 'weaviate_tpu')\n"
            "print(','.join(bad))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def test_entry_points_need_a_card_or_an_explicit_cpu(tmp_path, monkeypatch):
    from weaviate_tpu_torch import resolve_device
    from weaviate_tpu_torch.entities import vectorindex as vi
    from weaviate_tpu_torch.index import new_vector_index
    from weaviate_tpu_torch.state import state_from_arrays

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = vi.parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared"})
    with pytest.raises(RuntimeError, match="CUDA"):
        new_vector_index(cfg, str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="CUDA"):
        new_vector_index(cfg, str(tmp_path / "b"), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_arrays({"store": [[0.0]] * 16384, "sq_norms": [0.0] * 16384,
                           "tombs": [False] * 16384, "slot_to_doc": [-1] * 16384,
                           "n": 0, "capacity": 16384, "dim": 1})
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert new_vector_index(cfg, str(tmp_path / "c"), device="cpu").device.type == "cpu"
