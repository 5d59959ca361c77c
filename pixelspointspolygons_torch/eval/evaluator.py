"""Evaluator: metric-mode dispatch + CSV output — port of
pixelspointspolygons_tpu/eval/evaluator.py (reference eval/evaluator.py:30-273).

Loads GT + prediction COCO jsons, dispatches on cfg.evaluation.modes
(iou / subset_iou / coco / boundary-coco / polis / hausdorff / chamfer /
mta / topdig / juncs / ldof / stats), returns a flat metric dict and writes
the CSV the entry points expect, with the stdlib `csv` module. `ldof`
(external binary) is skipped with a warning when no executable is
configured, matching evaluator.py:240-246.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Optional

from ..config.engine import Config
from ..utils.coco import CocoIndex
from ..utils.logger import make_logger
from .cocoeval import COCOEval
from .metrics import compute_iou_ciou, compute_point_metrics
from .mta import compute_mta


class Evaluator:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.logger = make_logger(self.__class__.__name__)
        self.coco_gt: Optional[CocoIndex] = None
        self.coco_dt: Optional[CocoIndex] = None

    def load_gt(self, ann_file: Optional[str] = None) -> None:
        split = self.cfg.evaluation.split
        ann_file = ann_file or self.cfg.experiment.dataset.annotations[split]
        self.coco_gt = CocoIndex(ann_file)

    def load_predictions(self, pred_file: Optional[str] = None) -> None:
        if self.coco_gt is None:
            raise RuntimeError("call load_gt first")
        pred_file = pred_file or self.cfg.evaluation.pred_file
        if not os.path.isfile(pred_file):
            raise FileNotFoundError(pred_file)
        with open(pred_file) as f:
            preds = json.load(f)
        self.coco_dt = self.coco_gt.load_res(preds)
        self._pred_file = pred_file

    def evaluate(self) -> dict:
        if self.coco_gt is None or self.coco_dt is None:
            raise RuntimeError("call load_gt and load_predictions first")
        results: dict = {}
        for mode in self.cfg.evaluation.modes:
            if mode == "iou":
                results.update(compute_iou_ciou(self.coco_gt, self.coco_dt))
            elif mode == "subset_iou":
                results.update(compute_iou_ciou(self.coco_gt, self.coco_dt, subset=True))
            elif mode == "coco":
                results.update(COCOEval(self.coco_gt, self.coco_dt).run())
            elif mode == "boundary-coco":
                # self-contained Boundary AP (the reference gates this on the
                # external boundary-iou package, evaluator.py:121-141)
                results.update(COCOEval(self.coco_gt, self.coco_dt, iou_type="boundary").run())
            elif mode in ("polis", "hausdorff", "chamfer"):
                if not any(k in results for k in ("polis", "hausdorff")):
                    results.update(compute_point_metrics(self.coco_gt, self.coco_dt))
            elif mode == "mta":
                results.update(compute_mta(self.coco_gt, self.coco_dt))
            elif mode == "topdig":
                from .topdig import compute_topdig_metrics

                results.update(compute_topdig_metrics(self.coco_gt, self.coco_dt))
            elif mode == "juncs":
                from .juncs import compute_junction_metrics

                results.update(compute_junction_metrics(self.coco_gt, self.coco_dt))
            elif mode == "ldof":
                exe = self.cfg.host.get("ldof_exe")
                if not exe or not os.path.isfile(str(exe)):
                    self.logger.warning(
                        "ldof_exe not configured/found — skipping DoF metric "
                        "(same as reference without the binary, evaluator.py:240-246)"
                    )
                else:
                    from .line_dof import compute_line_dof

                    results.update(compute_line_dof(str(exe), self.coco_gt, self.coco_dt))
            elif mode == "stats":
                results["num_gt_anns"] = len(self.coco_gt.anns)
                results["num_dt_anns"] = len(self.coco_dt.anns)
            else:
                self.logger.warning(f"unknown evaluation mode {mode!r} — skipped")
        # attach prediction timing if the predictor stored it
        time_file = getattr(self, "_pred_file", "").replace(".json", "_time.json")
        if time_file and os.path.isfile(time_file):
            with open(time_file) as f:
                results.update(json.load(f))
        return results

    def to_latex(self, results: dict, caption: str = "Results") -> str:
        """Compact LaTeX table of the metric dict (reference
        evaluator.py:405-539 generates the paper tables; this emits one row)."""
        keys = [k for k, v in results.items() if isinstance(v, (int, float))]
        header = " & ".join(k.replace("_", r"\_") for k in keys)
        row = " & ".join(
            f"{results[k]:.3f}" if isinstance(results[k], float) else str(results[k])
            for k in keys
        )
        return (
            "\\begin{table}\n\\centering\n\\caption{" + caption + "}\n"
            "\\begin{tabular}{" + "c" * len(keys) + "}\n\\toprule\n"
            + header + " \\\\\n\\midrule\n" + row + " \\\\\n\\bottomrule\n"
            "\\end{tabular}\n\\end{table}\n"
        )

    def to_latex_table(self, *args, **kwargs) -> str:
        """The multi-experiment paper tables of the ablation scripts."""
        raise NotImplementedError(
            "multi-experiment LaTeX tables: ROADMAP 'Port queue' item 'Remaining encoders and CLI'"
        )

    def to_csv(self, results: dict, out_file: Optional[str] = None) -> str:
        """One row: `experiment`, then the metrics in the dict's order (the
        columns the JAX package's pandas writer gives)."""
        out_file = out_file or os.path.join(
            self.cfg.output_dir,
            f"{self.cfg.evaluation.eval_file}_{self.cfg.evaluation.split}.csv",
        )
        os.makedirs(os.path.dirname(out_file), exist_ok=True)
        row = {"experiment": self.cfg.experiment.name, **results}
        with open(out_file, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(row))
            writer.writeheader()
            writer.writerow(row)
        self.logger.info(f"wrote {out_file}")
        return out_file
