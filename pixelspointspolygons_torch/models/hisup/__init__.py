from .model import ECA, ConvStack3, HiSup, Predictor2, encode_targets, hisup_losses

__all__ = ["ECA", "ConvStack3", "HiSup", "Predictor2", "encode_targets", "hisup_losses"]
