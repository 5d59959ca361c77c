from .predictor import Predictor
from .predictor_hisup import HiSupPredictor

__all__ = ["Predictor", "HiSupPredictor"]
