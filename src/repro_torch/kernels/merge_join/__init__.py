from . import ops
from .ops import injectivity_mask, injectivity_mask_ref

__all__ = ["ops", "injectivity_mask", "injectivity_mask_ref"]
