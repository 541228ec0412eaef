"""Parallelism: the strategies that say how a train step syncs its
gradients and where the optimizer state lives (``parallel/strategy.py``:
DDP and ZeRO-1 over ``torch.distributed``)."""

from ray_lightning_tpu_torch.parallel.strategy import (DataParallelStrategy,
                                                       ShardingStrategy,
                                                       Zero1Strategy,
                                                       resolve_strategy,
                                                       strategy_names)

__all__ = ["DataParallelStrategy", "ShardingStrategy", "Zero1Strategy",
           "resolve_strategy", "strategy_names"]
