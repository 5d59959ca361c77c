from .dataset import P3Dataset, load_image_file
from .loader import Loader, build_loader, collate, device_prefetch, to_device
from .synthetic import ensure_synthetic_dataset, generate_tile, write_synthetic_dataset

__all__ = [
    "P3Dataset",
    "Loader",
    "build_loader",
    "collate",
    "device_prefetch",
    "to_device",
    "ensure_synthetic_dataset",
    "generate_tile",
    "write_synthetic_dataset",
    "load_image_file",
]
