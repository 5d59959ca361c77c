"""What a run checks and sets before and after its window: the cards the
cell asks for, the build and kernel caches inside the checkout, and that no
JAX module was loaded into the process."""

from __future__ import annotations

import os
import sys

# top-level module names a run may not load, compared whole (the port's own
# name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "pixelspointspolygons_tpu")


class NoChip(RuntimeError):
    pass


def require_chips(n: int) -> None:
    """Raise NoChip unless torch sees a CUDA card and at least `n` of them."""
    import torch

    if not torch.cuda.is_available():
        raise NoChip("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        raise NoChip(f"the cell asks for {n} cards; torch sees {torch.cuda.device_count()}")


def fix_cache_dirs(root: str) -> None:
    """The kernel caches at fixed paths inside the checkout (`build/`, where
    the port also builds its own CUDA libraries), so that only a
    checkout's first run compiles."""
    build = os.path.join(root, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})
