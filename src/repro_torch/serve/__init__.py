"""Serving front ends of the port: the LM decode engine and GNN-PE's
signature-keyed result cache."""
from .cache import CacheStats, ResultCache, canonical_matches, remap_matches
from .engine import DecodeEngine, ServeConfig

__all__ = [
    "DecodeEngine", "ServeConfig", "ResultCache", "CacheStats", "canonical_matches",
    "remap_matches",
]
