from .model import ECA, ConvStack3, HiSup, Predictor2, encode_targets, extract_junctions, hisup_losses, nms_2d

__all__ = [
    "ECA",
    "ConvStack3",
    "HiSup",
    "Predictor2",
    "encode_targets",
    "extract_junctions",
    "hisup_losses",
    "nms_2d",
]
