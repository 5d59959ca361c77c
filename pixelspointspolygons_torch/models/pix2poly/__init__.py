from .factory import build_pix2poly, encoder_config
from .model import Decoder, DecoderLayer, Pix2Poly, ScoreNet, greedy_decode, greedy_generate
from .tokenizer import TOKEN_MODE, Tokenizer

__all__ = [
    "Decoder",
    "DecoderLayer",
    "Pix2Poly",
    "ScoreNet",
    "Tokenizer",
    "TOKEN_MODE",
    "build_pix2poly",
    "encoder_config",
    "greedy_decode",
    "greedy_generate",
]
