from .logger import make_logger
from .seeding import seed_everything

__all__ = ["make_logger", "seed_everything"]
