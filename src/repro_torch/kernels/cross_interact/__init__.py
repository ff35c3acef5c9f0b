from . import ops
from .ops import cross_interact, cross_interact_ref

__all__ = ["ops", "cross_interact", "cross_interact_ref"]
