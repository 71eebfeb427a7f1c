"""The names nothing the benchmark runs may load: JAX and the JAX package.
Compared by whole top-level module name, so `weaviate_tpu_torch` (the
port) is not `weaviate_tpu`."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "weaviate_tpu")


def loaded(modules=None) -> list:
    """Forbidden top-level names present in sys.modules (or `modules`)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def imported_names(path: Path) -> set:
    """Top-level names of every import statement in a Python file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".", 1)[0])
    return out
