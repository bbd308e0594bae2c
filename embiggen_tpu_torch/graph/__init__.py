"""Graph container, device export, generators, kernels, holdouts and
negative sampling."""
from .generators import erdos_renyi, planted_partition_edges, random_geometric
from .graph import Graph, TorchGraph, build_alias_tables
from .holdouts import connected_holdout, random_holdout
from .sampling import sample_negative_graph

__all__ = [
    "Graph", "TorchGraph", "build_alias_tables", "erdos_renyi",
    "planted_partition_edges", "random_geometric", "connected_holdout",
    "random_holdout", "sample_negative_graph",
]
