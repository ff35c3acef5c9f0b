from . import ops
from .ops import star_agg, star_agg_ref

__all__ = ["ops", "star_agg", "star_agg_ref"]
