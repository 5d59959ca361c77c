"""Line-DoF metric via the external `ldof` executable — the port's own copy
of pixelspointspolygons_tpu/eval/line_dof.py.

Capability parity with reference eval/line_dof.py:22-114: per predicted
image, dump every polygon edge as a line segment (x0 y0 x1 y1 rows), shell
out to `cfg.host.ldof_exe --input <file>`, parse the three reported numbers
("Number of degree of freedom", "Number segments", "Metric for DoF"), and
report dataset means (norm_line_dofs is divided by 100 like the reference).

The binary is not distributable; the Evaluator skips this mode with a warning
when `host.ldof_exe` is unset or missing — same behavior as the reference
without the executable (evaluator.py:240-246).
"""

from __future__ import annotations

import os
import re
import subprocess
import tempfile

import numpy as np

from ..utils.coco import CocoIndex

_PATTERNS = {
    "line_dofs": re.compile(r"Number of degree of freedom is\s*:\s*([\d.]+)"),
    "line_segs": re.compile(r"Number segments is\s*:\s*([\d.]+)"),
    "norm_line_dofs": re.compile(r"Metric for DoF\s*:\s*([\d.]+)"),
}


def _segments_for_image(anns: list[dict]) -> np.ndarray:
    lines = []
    for ann in anns:
        seg = ann["segmentation"][0] if ann.get("segmentation") else []
        pts = np.asarray(seg, np.float64).reshape(-1, 2)
        for i in range(len(pts) - 1):
            lines.append([pts[i][0], pts[i][1], pts[i + 1][0], pts[i + 1][1]])
    return np.asarray(lines, np.float64).reshape(-1, 4)


def run_ldof_once(ldof_exe: str, lines: np.ndarray) -> dict:
    """One `ldof` invocation on an (N, 4) segment array → the 3 parsed values."""
    with tempfile.NamedTemporaryFile(
        "w", suffix="_lines_image.txt", delete=False
    ) as f:
        np.savetxt(f, lines, fmt="%.6f", delimiter=" ")
        path = f.name
    try:
        result = subprocess.run(
            [ldof_exe, "--input", path],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            check=True,
        )
    finally:
        if os.path.exists(path):
            os.remove(path)
    out = {}
    for key, pat in _PATTERNS.items():
        m = pat.search(result.stdout)
        if not m:
            raise ValueError(f"ldof output missing {key!r}: {result.stdout!r}")
        out[key] = float(m.group(1))
    return out


def compute_line_dof(ldof_exe: str, coco_gt: CocoIndex, coco_dt: CocoIndex) -> dict:
    img_ids = [i for i, anns in coco_dt.imgToAnns.items() if anns]
    acc: dict[str, list[float]] = {k: [] for k in _PATTERNS}
    for img_id in img_ids:
        vals = run_ldof_once(ldof_exe, _segments_for_image(coco_dt.imgToAnns[img_id]))
        for k, v in vals.items():
            acc[k].append(v)
    return {
        "line_dofs": float(np.mean(acc["line_dofs"])) if acc["line_dofs"] else float("nan"),
        "line_segs": float(np.mean(acc["line_segs"])) if acc["line_segs"] else float("nan"),
        "norm_line_dofs": (
            float(np.mean(acc["norm_line_dofs"])) / 100.0
            if acc["norm_line_dofs"]
            else float("nan")
        ),
    }
