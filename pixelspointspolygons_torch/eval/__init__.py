from .cocoeval import COCOEval
from .evaluator import Evaluator
from .metrics import calc_iou, compute_iou_ciou, compute_point_metrics
from .mta import compute_mta

__all__ = [
    "COCOEval",
    "Evaluator",
    "calc_iou",
    "compute_iou_ciou",
    "compute_point_metrics",
    "compute_mta",
]
