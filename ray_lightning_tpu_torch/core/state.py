"""Train state.

Counterpart of ``ray_lightning_tpu/core/state.py`` ``TrainState``.  A
torch module carries its own parameters, so the state holds what is left:
the step count, the optimizer state (with the fp32 master, ops/optim.py)
and the generator the step draws from.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class TrainState:
    step: int
    opt_state: Any
    generator: torch.Generator


__all__ = ["TrainState"]
