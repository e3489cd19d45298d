"""Multi-GPU: launch, meshes and sharding strategies, tensor parallelism
(counterpart of efficientsam3_tpu/parallel)."""

from efficientsam3_tpu_torch.parallel.launch import global_mesh, initialize_distributed
from efficientsam3_tpu_torch.parallel.sharding import (
    frame_parallel,
    make_mesh,
    object_parallel,
    replicate,
    shard_batch,
)
from efficientsam3_tpu_torch.parallel.tensor_parallel import (
    count_sharded,
    shard_params,
    tp_param_spec,
)

__all__ = [
    "count_sharded",
    "frame_parallel",
    "global_mesh",
    "initialize_distributed",
    "make_mesh",
    "object_parallel",
    "replicate",
    "shard_batch",
    "shard_params",
    "tp_param_spec",
]
