"""Deterministic seeding.

Counterpart of ``ray_lightning_tpu/utils/seed.py``: seeds Python's and
numpy's global generators and records the seed in ``RLT_GLOBAL_SEED``.
Like JAX, the port draws no random numbers from a global generator on
the training path: the ``Trainer`` makes explicit ``torch.Generator``\\ s
from the returned seed.
"""

from __future__ import annotations

import os
import random

import numpy as np

SEED_ENV_VAR = "RLT_GLOBAL_SEED"


def seed_everything(seed: "int | None" = None) -> int:
    """Seed ``random`` and numpy, record the seed in ``RLT_GLOBAL_SEED``
    and return it.  ``None`` takes the recorded seed, else a random
    one."""
    if seed is None:
        env = os.environ.get(SEED_ENV_VAR)
        seed = int(env) if env is not None else random.randint(0, 2**31 - 1)
    seed = int(seed)
    os.environ[SEED_ENV_VAR] = str(seed)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    return seed


def reset_seed() -> "int | None":
    """Re-apply the seed recorded in the env, if any."""
    env = os.environ.get(SEED_ENV_VAR)
    if env is None:
        return None
    return seed_everything(int(env))


__all__ = ["SEED_ENV_VAR", "reset_seed", "seed_everything"]
