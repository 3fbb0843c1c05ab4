"""Multi-GPU data parallelism over ``torch.distributed``: meshes of ranks,
batch sharding and process-group setup (the JAX package's ``parallel``)."""

from asvspoof2021_air_tpu_torch.parallel.distributed import (
    host_shard_range, initialize_distributed, make_global_batch)
from asvspoof2021_air_tpu_torch.parallel.mesh import (
    Mesh, ShardingError, batch_sharding, make_mesh, replicate, shard_batch)

__all__ = ["Mesh", "ShardingError", "batch_sharding", "host_shard_range",
           "initialize_distributed", "make_global_batch", "make_mesh",
           "replicate", "shard_batch"]
