"""P3 port to PyTorch and CUDA for NVIDIA Hopper (H100).

A second package beside `pixelspointspolygons_tpu/`, which stays the
reference. It imports `torch` and never JAX, flax, optax, orbax or anything
of the JAX package: where it needs host code that has no JAX in it, it keeps
its own copy under the same module name. Entry points run on `cuda` unless
the caller passes `device="cpu"`.
"""

from .config.engine import Config, compose, default_config_dir

__version__ = "0.1.0"

__all__ = ["Config", "compose", "default_config_dir", "__version__"]
