"""Hand-written Hopper kernels of the port, one folder each:
``<name>/{csrc/*.cu, kernel.py, ops.py, ref.py}``, as ``repro.kernels``
lays out its Pallas kernels."""
from .build import build_all

__all__ = ["build_all"]
