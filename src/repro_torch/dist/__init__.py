"""Partition-parallel probing, the cluster tier and the meshes on the card:
the stacked index probe, cost-ranked placement, checkpoints and
scatter-gather matching over partition-owner hosts; the placement specs,
the mesh context, the host-staged collectives and the GPipe schedule.

The names below load on first use, so that ``models`` can import
``dist.collectives`` without the cluster tier (which imports the engine)."""
import importlib

_EXPORTS = {
    "StackedProbe": "probe",
    "PartitionCost": "placement", "Placement": "placement", "DEFAULT_WEIGHTS": "placement",
    "partition_costs": "placement", "place_partitions": "placement", "load_bound": "placement",
    "CheckpointManager": "checkpoint", "CorruptCheckpointError": "checkpoint",
    "HostLostError": "cluster", "LocalHost": "cluster", "ExchangeHost": "cluster",
    "DirExchange": "cluster", "serve_exchange_host": "cluster", "ClusterEngine": "cluster",
    "init_distributed": "cluster",
    "pipeline_apply": "pipeline",
    "use_mesh": "context", "current_mesh": "context", "maybe_shard": "context",
    "is_dtensor": "context", "per_shard": "context",
    "use_devices": "context", "current_devices": "context", "mesh_devices": "context",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    globals()[name] = value
    return value
