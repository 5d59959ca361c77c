from .hrnet import HRNetEncoder

__all__ = ["HRNetEncoder"]
