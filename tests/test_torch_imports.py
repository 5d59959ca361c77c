"""The PyTorch port stands alone: no file of `pixelspointspolygons_torch/`
and not `chip_smoke.py` imports JAX, flax, optax, orbax or the JAX package,
and a fresh process that imports every module of the port and takes a train
step on the CPU has none of them loaded."""

import ast
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "pixelspointspolygons_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pixelspointspolygons_tpu")


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module",
            "__import__",
        ):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value.split(".")[0], node.lineno


def test_sources_import_nothing_of_jax():
    files = _sources()
    assert len(files) > 20 and os.path.join(PORT, "ops", "afm.py") in files
    bad = [
        f"{os.path.relpath(path, ROOT)}:{line} imports {root}"
        for path in files
        for root, line in _imported_roots(path)
        if root in FORBIDDEN
    ]
    assert not bad, bad


def test_ast_scan_catches_an_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("def f():\n    from jax import numpy\n    import importlib\n    importlib.import_module('orbax.checkpoint')\n")
    assert {r for r, _ in _imported_roots(str(p))} >= {"jax", "orbax"}


_STEP = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    import numpy as np
    import torch
    import pixelspointspolygons_torch as port
    for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        importlib.import_module(m.name)
    from pixelspointspolygons_torch.models.hisup.model import HiSup
    from pixelspointspolygons_torch.models.hrnet import HRNetEncoder
    from pixelspointspolygons_torch.train.hisup_step import make_train_step
    from pixelspointspolygons_torch.train.state import TrainState, cosine_with_warmup, make_optimizer, make_scheduler

    S, B = 32, 2
    rng = np.random.RandomState(0)
    model = HiSup(HRNetEncoder(in_size=S, out_dim=8, width=4, stage1_planes=4, stage1_blocks=1,
                               num_blocks=1, num_modules=(1, 1, 1), stem_ch=8), dim=8, pred_size=S)
    opt = make_optimizer("adamw", model.parameters(), 1e-4)
    state = TrainState(model, opt, make_scheduler(opt, cosine_with_warmup(1e-4, 2), 1e-4))
    batch = {
        "images": torch.from_numpy(rng.normal(size=(B, S, S, 3)).astype(np.float32)),
        "junctions": torch.from_numpy(rng.uniform(0, S, (B, 6, 2)).astype(np.float32)),
        "junc_tags": torch.from_numpy(rng.randint(1, 3, (B, 6)).astype(np.int32)),
        "junc_valid": torch.ones(B, 6, dtype=torch.bool),
        "edges": torch.from_numpy(rng.uniform(0, S, (B, 6, 4)).astype(np.float32)),
        "edges_valid": torch.ones(B, 6, dtype=torch.bool),
        "mask": torch.from_numpy((rng.rand(B, S, S) < 0.3).astype(np.float32)),
    }
    out = make_train_step({k: 1.0 for k in ("loss_jloc", "loss_joff", "loss_mask", "loss_afm", "loss_remask")}, S)(state, batch)
    assert torch.isfinite(out["loss"]) and state.step == 1
    print(",".join(sorted({m.split(".")[0] for m in sys.modules})))
    """
)


def test_fresh_process_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-c", _STEP], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    loaded = set(proc.stdout.strip().splitlines()[-1].split(","))
    assert {"torch", "pixelspointspolygons_torch", "cv2"} <= loaded
    assert not loaded & set(FORBIDDEN), sorted(loaded & set(FORBIDDEN))
