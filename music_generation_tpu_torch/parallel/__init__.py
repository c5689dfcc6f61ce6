"""Multi-device training and serving (twin of the JAX package's
parallel/)."""

from .mesh import (ShardedParams, StepMesh, batch_sharding, init_distributed,
                   local_device, make_hybrid_mesh, make_mesh, mesh_shape,
                   param_partition_spec, param_shardings, put_global_batch,
                   shard_params)

__all__ = ["make_mesh", "make_hybrid_mesh", "batch_sharding",
           "param_partition_spec", "param_shardings", "put_global_batch",
           "shard_params", "init_distributed", "local_device", "mesh_shape",
           "ShardedParams", "StepMesh"]
