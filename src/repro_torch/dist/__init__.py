"""Partition-parallel probing on the card: the stacked index probe."""
from .probe import StackedProbe

__all__ = ["StackedProbe"]
