"""Multi-device training over torch.distributed (one process per rank) and
holdout-level parallelism across workers — counterpart of
`embiggen_tpu/parallel`."""
from .mesh import Mesh, make_mesh, resolve_mesh
from .spmm import edge_shard_kernel, partition_coo, sharded_spmm
from .halo import (
    HaloPartition,
    build_halo_partition,
    halo_conv,
    halo_spmm,
    halo_spmm_local,
    shard_features,
)
from .embedder import (
    make_dp_skipgram_step,
    make_sharded_skipgram_step,
    shard_skipgram_params,
)
from .sharded_table import (
    make_row_sharded_skipgram_step,
    shard_rows_skipgram_params,
)
from . import sharded_table
from .gcn import init_sharded_gcn_params, make_sharded_gcn_edge_step
from .distributed import holdout_belongs_to_this_worker, initialize_distributed

__all__ = [
    "Mesh", "make_mesh", "resolve_mesh", "sharded_spmm", "partition_coo",
    "edge_shard_kernel", "HaloPartition", "build_halo_partition", "halo_spmm",
    "halo_spmm_local", "halo_conv", "shard_features",
    "make_dp_skipgram_step", "make_sharded_skipgram_step",
    "shard_skipgram_params", "make_row_sharded_skipgram_step",
    "shard_rows_skipgram_params", "sharded_table",
    "init_sharded_gcn_params", "make_sharded_gcn_edge_step",
    "initialize_distributed", "holdout_belongs_to_this_worker",
]
