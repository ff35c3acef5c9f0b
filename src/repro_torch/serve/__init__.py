"""Serving front ends of the port: so far the LM decode engine."""
from .engine import DecodeEngine, ServeConfig

__all__ = ["DecodeEngine", "ServeConfig"]
