from . import ops
from .ops import dominance_scan_pairs, dominance_scan_pairs_ref

__all__ = ["ops", "dominance_scan_pairs", "dominance_scan_pairs_ref"]
