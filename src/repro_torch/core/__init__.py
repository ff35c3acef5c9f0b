from .baselines import gql_match, match_count, quicksi_match, vf2_match
from .delta import DeltaIndex, GraphUpdate, apply_graph_update, probe_delta_multi
from .encoder import EncoderConfig, GATEncoder, MonotoneEncoder, make_encoder
from .engine import GnnPeConfig, GnnPeEngine, PartitionModel, QueryStats
from .grouping import attach_groups, group_paths
from .index import (
    PackedGroupIndex,
    PackedIndex,
    build_index,
    query_index,
    query_index_batch,
    query_index_batch_multi,
    reset_pair_counters,
)
from .matcher import (
    join_candidates,
    match_from_candidates,
    match_from_candidates_many,
    refine,
    sort_matches,
)
from .paths import concat_path_embeddings, enumerate_paths
from .planner import QueryPlan, candidate_plan_paths, canonical_form, plan_query
from .stacked import StackedIndex, build_stacked, plan_shards
from .stars import build_pair_dataset, build_star_tensors, subset_table
from .training import TrainConfig, TrainResult, dominance_violations, train_dominance

__all__ = [
    "GraphUpdate",
    "apply_graph_update",
    "probe_delta_multi",
    "DeltaIndex",
    "GnnPeConfig",
    "GnnPeEngine",
    "PartitionModel",
    "QueryStats",
    "EncoderConfig",
    "GATEncoder",
    "MonotoneEncoder",
    "make_encoder",
    "TrainConfig",
    "TrainResult",
    "train_dominance",
    "dominance_violations",
    "PackedIndex",
    "PackedGroupIndex",
    "build_index",
    "attach_groups",
    "group_paths",
    "query_index",
    "query_index_batch",
    "query_index_batch_multi",
    "reset_pair_counters",
    "QueryPlan",
    "plan_query",
    "candidate_plan_paths",
    "canonical_form",
    "StackedIndex",
    "build_stacked",
    "plan_shards",
    "enumerate_paths",
    "concat_path_embeddings",
    "build_star_tensors",
    "build_pair_dataset",
    "subset_table",
    "join_candidates",
    "refine",
    "match_from_candidates",
    "match_from_candidates_many",
    "sort_matches",
    "vf2_match",
    "quicksi_match",
    "gql_match",
    "match_count",
]
