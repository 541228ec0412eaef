"""Execution plugins: who runs the training loop, and where
(``LocalPlugin`` in-process; ``RayPlugin`` / ``RayShardedPlugin`` /
``RaySpmdPlugin`` over subprocess actors)."""

from ray_lightning_tpu_torch.plugins.base import ExecutionPlugin, LocalPlugin
from ray_lightning_tpu_torch.plugins.ray_ddp import (RayPlugin,
                                                     RayShardedPlugin,
                                                     RaySpmdPlugin)

__all__ = ["ExecutionPlugin", "LocalPlugin", "RayPlugin",
           "RayShardedPlugin", "RaySpmdPlugin"]
