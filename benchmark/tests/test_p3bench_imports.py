"""No module under benchmark/ imports JAX, flax, the JAX package or a
JAX-era file of the repository's root; nothing under benchmark/reference/
imports the port. Module names are compared by their top-level name,
whole (the port's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import os
import sys

from benchmark.harness import guard
from benchmark.harness.spec import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "pixelspointspolygons_tpu"}
# modules of the repository's root that belong to the JAX package's era
ROOT_MODULES = {os.path.splitext(f)[0] for f in os.listdir(ROOT) if f.endswith(".py")}


def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub: str = "") -> list[str]:
    out = []
    for d, _, files in os.walk(os.path.join(BENCH_DIR, sub)):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = _imports(path) & (FORBIDDEN | ROOT_MODULES)
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        assert "pixelspointspolygons_torch" not in _imports(path), path


def test_the_scan_compares_whole_top_level_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import pixelspointspolygons_torch.ops\nfrom jaxtyping import x\nimport jax.numpy\n")
    assert _imports(str(src)) & FORBIDDEN == {"jax"}


def test_the_run_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pixelspointspolygons_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", sys)
    assert not [m for m in guard.forbidden_modules() if m.endswith("_fake")]
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert "flax.linen" in guard.forbidden_modules()
