"""Data parallelism over ``torch.distributed`` (counterpart of the JAX
``parallel/``): ``init_distributed`` and ``device_info`` set the group up from
the JAX package's env names, ``create_mesh`` / ``local_mesh`` / ``MeshSpec``
build the ``data`` axis over it, ``shard_batch`` takes a rank's rows, and the
collectives of ``mesh.py`` make a step over the ranks equal to one rank's on
the whole batch. JAX's ``batch_sharding``, ``replicated`` and
``shard_map_compat`` name shardings of one SPMD program and have no
counterpart in a process-a-device port."""

from .distributed import device_info, init_distributed
from .mesh import (Mesh, MeshSpec, active_mesh, all_gather_rows, all_reduce_gradients,
                   all_reduce_mean, barrier, broadcast_module, create_mesh, data_parallel,
                   global_moments, global_sum, local_mesh, shard_batch, shards)

__all__ = ["Mesh", "MeshSpec", "active_mesh", "all_gather_rows", "all_reduce_gradients",
           "all_reduce_mean", "barrier", "broadcast_module", "create_mesh", "data_parallel",
           "device_info", "global_moments", "global_sum", "init_distributed", "local_mesh",
           "shard_batch", "shards"]
