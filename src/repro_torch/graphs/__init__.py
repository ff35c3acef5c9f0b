from .graph import (
    DeviceGraph,
    Graph,
    device_graph,
    erdos_renyi,
    from_edge_list,
    induced_subgraph,
    newman_watts_strogatz,
    random_connected_query,
    random_labels,
)
from .partition import Partitioning, expanded_partition, partition_graph
from .sampler import SampledBatch, SampledBlock, sample_fanout

__all__ = [
    "Graph",
    "DeviceGraph",
    "device_graph",
    "from_edge_list",
    "newman_watts_strogatz",
    "erdos_renyi",
    "random_labels",
    "induced_subgraph",
    "random_connected_query",
    "Partitioning",
    "partition_graph",
    "expanded_partition",
    "SampledBlock",
    "SampledBatch",
    "sample_fanout",
]
