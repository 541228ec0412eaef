"""Execution plugins: who runs the training loop, and where.

Counterpart of ``ray_lightning_tpu/plugins/base.py`` without the
telemetry plane.  ``LocalPlugin`` runs the loop in this process, at
world size 1, on the ``Trainer``'s device; the distributed plugins
(plugins/ray_ddp.py) ship the run into actor workers.  The plugin's
second job is carrying the strategy (parallel/strategy.py).
"""

from __future__ import annotations

from typing import Optional

from ray_lightning_tpu_torch.parallel.strategy import (ShardingStrategy,
                                                       resolve_strategy)


class ExecutionPlugin:
    strategy: Optional[ShardingStrategy] = None
    #: True when the stage runs in other processes, which choose their
    #: own device (the driver's ``Trainer`` then resolves none)
    remote: bool = False

    def run(self, trainer, module, datamodule, stage: str,
            ckpt_path: Optional[str]):
        raise NotImplementedError


class LocalPlugin(ExecutionPlugin):
    """In-process execution, the default when no distributed plugin is
    passed: the analog of running PL without any plugin.  Its strategy
    defaults to DDP, which at one rank syncs nothing."""

    def __init__(self, strategy=None):
        self.strategy = resolve_strategy(strategy)

    def run(self, trainer, module, datamodule, stage, ckpt_path):
        return trainer._run_stage(module, datamodule, stage, ckpt_path)


__all__ = ["ExecutionPlugin", "LocalPlugin"]
