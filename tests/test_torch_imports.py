"""The PyTorch port stands alone: no file of `pixelspointspolygons_torch/`
and not `chip_smoke.py`, `afm_bench.py`, `bench_torch.py`,
`hisup_resize_bench.py`, `graft_entry_torch.py` or `trained_run.py` imports JAX, flax, optax, orbax or the JAX package,
and a fresh process that imports every module of the port, takes a HiSup
and a Pix2Poly train step and decodes with a Pix2Poly on the CPU has none
of them loaded. Every `NotImplementedError` the port raises names a ROADMAP
'Port queue' item that ROADMAP.md still lists. Every script of the JAX
package has a twin in `cli/` or a reason in ROADMAP.md why it needs none."""

import ast
import os
import re
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "pixelspointspolygons_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pixelspointspolygons_tpu")


def _sources():
    files = [os.path.join(ROOT, name)
             for name in ("chip_smoke.py", "afm_bench.py", "bench_torch.py", "hisup_resize_bench.py",
                          "graft_entry_torch.py", "trained_run.py")]
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
    assert os.path.join(ROOT, "bench_torch.py") in files and os.path.join(ROOT, "graft_entry_torch.py") in files
    assert os.path.join(PORT, "utils", "pretrained.py") in files and os.path.join(PORT, "utils", "torch_port.py") in files
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


_ITEM = re.compile(r"ROADMAP\s+'Port\s+queue'\s+item\s+'([^'{]+)'")


def _roadmap_items() -> set[str]:
    """The item names of ROADMAP.md's port queue, each set in bold (`**'Name'`)."""
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        text = f.read()
    queue = text[text.index("### 1. Port queue"):text.index("### 2.")]
    return set(re.findall(r"\*\*'([^']+)'", queue))


def _named_items(source: str, tree: ast.AST) -> set[str]:
    """The items a module names: in its messages, and as the values of a
    `_DEFERRED` table (encoder name -> "'item'") that its messages format."""
    names = {" ".join(m.split()) for m in _ITEM.findall(source)}  # names may wrap in docstrings
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "_DEFERRED" for t in node.targets)):
            names |= {v.value.strip("'") for v in node.value.values}
    return names


def test_every_refusal_names_a_roadmap_item():
    """Each `raise NotImplementedError(...)` of the port names an item, and
    each item named anywhere in the port is one ROADMAP.md lists."""
    items = _roadmap_items()
    assert {"FFL", "LiDAR and fusion", "DDP and SyncBN"} <= items
    assert not {"bfloat16 (HiSup)", "Pretrained encoders"} & items
    named, bare = set(), []
    for path in _sources():
        with open(path) as f:
            source = f.read()
        tree = ast.parse(source, path)
        named |= {(m, os.path.relpath(path, ROOT)) for m in _named_items(source, tree)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Raise) and node.exc is not None:
                call = node.exc
                name = getattr(getattr(call, "func", None), "id", getattr(call, "id", None))
                segment = ast.get_source_segment(source, call) or ""
                if name == "NotImplementedError" and "ROADMAP 'Port queue' item" not in segment:
                    bare.append(f"{os.path.relpath(path, ROOT)}:{node.lineno}")
    assert named and not bare, bare
    unknown = sorted(f"{where}: {item}" for item, where in named if item not in items)
    assert not unknown, unknown


def _untwinned_table() -> dict[str, str]:
    """ROADMAP.md's "Still missing" table: each backticked script's file
    name and the reason in its row's second column."""
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        text = f.read()
    section = text[text.index("**Still missing from"):text.index("**Test-time budget.**")]
    reasons = {}
    for line in section.splitlines():
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if not line.startswith("|") or len(cells) != 2 or set(cells[1]) <= set("-"):
            continue
        for name in re.findall(r"`([^`]+\.py)`", cells[0]):
            reasons[os.path.basename(name)] = cells[1]
    return reasons


def test_every_script_has_a_twin_or_a_reason():
    """Each `scripts/*.py` and `data_preprocess/**/*.py` is a `cli/` module of
    the same stem (`test_wireframe_loader` is `wireframe_loader`) or stands
    in ROADMAP.md's "Still missing" table with its reason; never both."""
    scripts = [os.path.join(ROOT, "scripts", n) for n in os.listdir(os.path.join(ROOT, "scripts"))]
    for d, _, names in os.walk(os.path.join(ROOT, "data_preprocess")):
        scripts += [os.path.join(d, n) for n in names]
    scripts = sorted(p for p in scripts if p.endswith(".py"))
    twins = {n[:-3] for n in os.listdir(os.path.join(PORT, "cli")) if n.endswith(".py")}
    table = _untwinned_table()
    assert "collect_grid.py" in table and "inria_to_coco.py" in table and all(table.values())
    assert len(scripts) > 25 and {"postprocess_oracle", "profile", "droplidar50_ablation"} <= twins
    neither, both = [], []
    for path in scripts:
        name = os.path.basename(path)
        twinned = name[:-3].removeprefix("test_") in twins
        if twinned == (name in table):
            (both if twinned else neither).append(os.path.relpath(path, ROOT))
    assert not neither and not both, {"neither": neither, "both": both}
    assert set(table) <= {os.path.basename(p) for p in scripts}, "the table names a script that is not there"


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

    from pixelspointspolygons_torch.models.pix2poly import Pix2Poly, greedy_generate

    p2p = Pix2Poly(vocab_size=19, encoder_len=16, dim=32, num_heads=4, num_layers=2, max_len=12, pad_idx=18,
                   max_num_vertices=5, sinkhorn_iterations=10,
                   encoder_cfg={"name": "vit", "img_size": 16, "patch_size": 4, "dim": 32, "depth": 1, "num_heads": 2})
    with torch.no_grad():
        for eos in (None, 17):
            tokens, perm = greedy_generate(p2p.eval(), {"images": batch["images"][:, :16, :16]}, 16, 11, eos_code=eos)
            assert tokens.shape == (B, 11) and torch.isfinite(perm).all()

    from pixelspointspolygons_torch.train import pix2poly_step

    opt = make_optimizer("adamw", p2p.parameters(), 3e-4, b2=0.95)
    p2p_state = TrainState(p2p, opt, make_scheduler(opt, cosine_with_warmup(3e-4, 2), 3e-4))
    y = torch.full((B, 12), 18, dtype=torch.int32)
    y[:, 0], y[:, 1:5], y[:, 5] = 16, torch.from_numpy(rng.randint(0, 16, (B, 4)).astype(np.int32)), 17
    p2p_batch = {"images": batch["images"][:, :16, :16], "y": y, "y_perm": torch.eye(5).expand(B, 5, 5).contiguous()}
    out = pix2poly_step.make_train_step(1.0, 10.0, 18)(p2p_state, p2p_batch)
    assert torch.isfinite(out["loss"]) and p2p_state.step == 1
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
