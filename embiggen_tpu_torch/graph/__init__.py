"""Graph container, device export, generators, loaders, kernels, holdouts,
negative sampling and the host edge metrics."""
from .generators import (
    barabasi_albert, erdos_renyi, planted_partition, planted_partition_edges,
    random_geometric,
)
from .graph import Graph, TorchGraph, build_alias_tables
from .holdouts import (
    connected_holdout, edge_label_holdout, edge_label_kfold, edge_prediction_kfold,
    node_label_holdout, node_label_kfold, random_holdout,
)
from .laplacians import KERNELS, kernel_coo
from .loaders import DatasetSpec, from_csv, from_pandas, get_dataset, karate_club, small_ppi
from .metrics import EDGE_METRIC_NAMES, all_edge_metrics, edge_metrics
from .sampling import sample_negative_graph, sample_positive_graph

__all__ = [
    "Graph", "TorchGraph", "build_alias_tables", "barabasi_albert",
    "erdos_renyi", "planted_partition", "planted_partition_edges", "random_geometric",
    "connected_holdout", "edge_prediction_kfold", "random_holdout",
    "node_label_holdout", "node_label_kfold", "edge_label_holdout", "edge_label_kfold",
    "DatasetSpec", "from_csv", "from_pandas", "get_dataset", "karate_club", "small_ppi",
    "sample_negative_graph", "sample_positive_graph", "KERNELS", "kernel_coo",
    "edge_metrics", "all_edge_metrics", "EDGE_METRIC_NAMES",
]
