from .engine import Config, compose, default_config_dir, load_yaml

__all__ = ["Config", "compose", "default_config_dir", "load_yaml"]
