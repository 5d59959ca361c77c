from .predictor import Predictor
from .predictor_ffl import FFLPredictor
from .predictor_hisup import HiSupPredictor
from .predictor_pix2poly import Pix2PolyPredictor

__all__ = ["Predictor", "FFLPredictor", "HiSupPredictor", "Pix2PolyPredictor"]
