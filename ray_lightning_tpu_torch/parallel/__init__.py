"""Parallelism: the strategies that say how a train step syncs its
gradients, where the parameters and the optimizer state live and how
they are split (``parallel/strategy.py``: DDP, ZeRO-1, FSDP, SPMD over
``torch.distributed``), the mesh of named axes over the ranks
(``parallel/mesh.py``), the sharded parameters (``parallel/layout.py``),
tensor parallelism inside the models (``parallel/tensor.py``) and the
full arrays of a sharded state (``parallel/gather.py``)."""

from ray_lightning_tpu_torch.parallel.mesh import (Mesh, build_device_mesh,
                                                   get_current_mesh,
                                                   set_current_mesh)
from ray_lightning_tpu_torch.parallel.strategy import (DataParallelStrategy,
                                                       FullyShardedStrategy,
                                                       P, PartitionSpec,
                                                       ShardingStrategy,
                                                       SpmdStrategy,
                                                       Zero1Strategy,
                                                       resolve_strategy,
                                                       strategy_names)

__all__ = ["DataParallelStrategy", "FullyShardedStrategy", "Mesh", "P",
           "PartitionSpec", "ShardingStrategy", "SpmdStrategy",
           "Zero1Strategy", "build_device_mesh", "get_current_mesh",
           "resolve_strategy", "set_current_mesh", "strategy_names"]
