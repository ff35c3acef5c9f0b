"""Partition-parallel probing and the cluster tier on the card: the stacked
index probe, cost-ranked placement, checkpoints and scatter-gather
matching over partition-owner hosts."""
from .checkpoint import CheckpointManager, CorruptCheckpointError
from .cluster import (
    ClusterEngine,
    DirExchange,
    ExchangeHost,
    HostLostError,
    LocalHost,
    init_distributed,
    serve_exchange_host,
)
from .placement import (
    DEFAULT_WEIGHTS,
    PartitionCost,
    Placement,
    load_bound,
    partition_costs,
    place_partitions,
)
from .probe import StackedProbe

__all__ = [
    "StackedProbe", "PartitionCost", "Placement", "DEFAULT_WEIGHTS", "partition_costs",
    "place_partitions", "load_bound", "CheckpointManager", "CorruptCheckpointError",
    "HostLostError", "LocalHost", "ExchangeHost", "DirExchange", "serve_exchange_host",
    "ClusterEngine", "init_distributed",
]
