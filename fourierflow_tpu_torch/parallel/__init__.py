"""Data, tensor and spatial parallelism over ``torch.distributed``
(counterpart of ``fourierflow_tpu/parallel``): the meshes and the state and
batch layouts (``mesh.py``) and the collectives of the parallel layers
(``collectives.py``)."""

from .collectives import Axis, mesh_axis
from .mesh import (ShardedBatch, batch_sharding, gather_state, in_mesh, init_distributed,
                   is_rank0, make_mesh, make_sp_mesh, make_tp_mesh, mesh_shape, placement,
                   replicated, shard_batch, shard_state, shard_tensor, split_dims, tp_param_specs,
                   world_size)

__all__ = ["Axis", "mesh_axis", "ShardedBatch", "batch_sharding", "gather_state", "in_mesh",
           "init_distributed", "is_rank0", "make_mesh", "make_sp_mesh", "make_tp_mesh",
           "mesh_shape", "placement", "replicated", "shard_batch", "shard_state", "shard_tensor",
           "split_dims", "tp_param_specs", "world_size"]
