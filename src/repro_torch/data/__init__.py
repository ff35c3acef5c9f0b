"""Synthetic, (seed, step)-addressed training data of the port (NumPy)."""
from .pipeline import GraphTaskData, LMSyntheticData, Prefetcher, RecsysSyntheticData

__all__ = ["LMSyntheticData", "RecsysSyntheticData", "GraphTaskData", "Prefetcher"]
