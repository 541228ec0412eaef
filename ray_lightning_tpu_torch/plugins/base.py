"""Execution plugins: who runs the training loop, and where.

Counterpart of ``ray_lightning_tpu/plugins/base.py`` without the
telemetry plane.  ``LocalPlugin`` runs the loop in this process, at
world size 1, on the ``Trainer``'s device (or its Tune trial's leased
card); the distributed plugins
(plugins/ray_ddp.py) ship the run into actor workers, with the run's
data-check validator on the driver when ``RLT_DATA_CHECK=1``
(:func:`data_check_validator`, the JAX ``plugins/xla.py:469-505``).
The plugin's second job is carrying the strategy
(parallel/strategy.py).
"""

from __future__ import annotations

from typing import Optional

from ray_lightning_tpu_torch._device import resolve_device
from ray_lightning_tpu_torch.core import datacheck
from ray_lightning_tpu_torch.parallel.strategy import (ShardingStrategy,
                                                       resolve_strategy)
from ray_lightning_tpu_torch.tune.session import (get_trial_devices,
                                                  lease_declared)


def data_check_validator(worker_env: dict
                         ) -> "Optional[datacheck.DataCheckValidator]":
    """A run's driver-side validator (core/datacheck.py) when
    ``RLT_DATA_CHECK=1`` is set on the driver or in the workers'
    environment, else ``None``: the workers relay each batch's
    fingerprint and the driver's poll loop raises on a divergence."""
    if datacheck.enabled() or datacheck.enabled(worker_env):
        return datacheck.DataCheckValidator()
    return None


class ExecutionPlugin:
    strategy: Optional[ShardingStrategy] = None
    #: True when the stage runs in other processes, which choose their
    #: own device (the driver's ``Trainer`` then resolves none)
    remote: bool = False

    def initial_device(self, device):
        """The driver ``Trainer``'s device for ``Trainer(device=device)``
        of an in-process plugin (``None``: chosen when the stage
        starts)."""
        return resolve_device(device)

    def run(self, trainer, module, datamodule, stage: str,
            ckpt_path: Optional[str]):
        raise NotImplementedError


class LocalPlugin(ExecutionPlugin):
    """In-process execution, the default when no distributed plugin is
    passed: the analog of running PL without any plugin.  Its strategy
    defaults to DDP, which at one rank syncs nothing.

    A ``Trainer`` given no device inside a Tune trial that declares a GPU
    lease has ``device=None`` until here: the stage then runs on the
    first card of the trial's lease (``tune.session.get_trial_devices``,
    which may wait for a card to free, and raises when the trial asks
    for more cards than this process sees)."""

    def __init__(self, strategy=None):
        self.strategy = resolve_strategy(strategy)

    def initial_device(self, device):
        if device is None and lease_declared():
            return None
        return resolve_device(device)

    def run(self, trainer, module, datamodule, stage, ckpt_path):
        if trainer.device is None:
            leased = get_trial_devices()
            trainer.device = resolve_device(leased[0] if leased else None)
        return trainer._run_stage(module, datamodule, stage, ckpt_path)


__all__ = ["ExecutionPlugin", "LocalPlugin", "data_check_validator"]
