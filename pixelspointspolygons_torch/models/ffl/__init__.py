from .model import FFL, build_ffl, encoder_config

__all__ = ["FFL", "build_ffl", "encoder_config"]
