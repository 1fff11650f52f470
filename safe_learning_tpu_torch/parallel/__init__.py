"""Grid-sharded verification over meshes and ``torch.distributed`` ranks.

Counterpart of ``safe_learning_tpu/parallel``: :mod:`.mesh` for the
meshes of one process, :mod:`.distributed` for one process per rank, and
:mod:`.dryrun`, the multi-process check of the whole loop
(``python -m safe_learning_tpu_torch.parallel.dryrun --nprocs 2``).
"""

from .mesh import (Mesh, ShardedArray, Sharding, grid_sharding, make_mesh,
                   replicated_sharding, shard_points,
                   sharded_safe_set_update)

__all__ = ["Mesh", "Sharding", "ShardedArray", "make_mesh", "grid_sharding",
           "replicated_sharding", "shard_points", "sharded_safe_set_update"]
