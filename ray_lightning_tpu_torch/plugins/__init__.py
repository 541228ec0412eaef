"""Execution plugins: who runs the training loop, and where
(``LocalPlugin`` in-process; ``RayPlugin`` / ``RayShardedPlugin`` over
subprocess actors)."""

from ray_lightning_tpu_torch.plugins.base import ExecutionPlugin, LocalPlugin
from ray_lightning_tpu_torch.plugins.ray_ddp import (RayPlugin,
                                                     RayShardedPlugin)

__all__ = ["ExecutionPlugin", "LocalPlugin", "RayPlugin",
           "RayShardedPlugin"]
