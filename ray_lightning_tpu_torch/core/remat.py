"""Remat (activation recomputation) policies for the port's models.

Counterpart of ``ray_lightning_tpu/core/remat.py`` ``policy_object`` and
of ``models/gpt.py`` ``_remat_policy`` (the ``RLT_REMAT_POLICY``
override).  There a policy is a ``jax.checkpoint`` policy handed to
``nn.remat`` around each block; here it is a wrapper that runs one block
under ``torch.utils.checkpoint`` (or ``None``: no wrap).

Ported policies:

- ``"full"``: save nothing inside the block, recompute it in the
  backward pass (jax's default policy, ``None``):
  ``checkpoint(block, x, use_reentrant=False)``;
- ``"off"``: no wrap (``everything_saveable``).

``"dots"``, ``"dots_no_batch"`` and the MoE save lists keep chosen
intermediates (the matmul outputs, named MoE tensors).  In PyTorch that
is a selective-checkpoint policy over the ops a block runs, and the
attention kernels launch through ctypes, outside the dispatcher that
such a policy sees; they raise until the kernels are registered as
custom ops (ROADMAP.md queue 1).
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Optional

from torch.utils.checkpoint import checkpoint

#: the JAX package's policy ladder (no recompute -> max recompute) and
#: its MoE save lists: every name a config may carry
POLICY_LADDER = ("off", "dots", "dots_no_batch", "full")
MOE_POLICIES = ("dots_moe_act", "dots_moe")


def policy_object(name: str) -> Optional[Callable]:
    """The block wrapper for a policy name: ``None`` for ``"off"``, a
    ``(fn, *args) -> out`` running ``fn`` under a non-reentrant
    checkpoint for ``"full"``.  The RNG state is not stashed for the
    recompute: the port's blocks draw no random numbers (dropout is not
    ported and raises).  Raises ``NotImplementedError`` for the other
    JAX policies and ``ValueError`` for an unknown name."""
    if name == "off":
        return None
    if name == "full":
        return functools.partial(checkpoint, use_reentrant=False,
                                 preserve_rng_state=False)
    if name in POLICY_LADDER or name in MOE_POLICIES:
        raise NotImplementedError(
            f"remat_policy {name!r} is not ported yet (ROADMAP.md queue "
            f"1: it needs the attention kernels registered as torch "
            f"custom ops so a selective checkpoint can see them); the "
            f"port takes 'full' and 'off'")
    raise ValueError(f"remat_policy {name!r}; options: "
                     f"{sorted(POLICY_LADDER + MOE_POLICIES)}")


def model_policy(remat: bool, remat_policy: str) -> str:
    """The policy a model build uses: ``"off"`` without remat, else
    ``RLT_REMAT_POLICY`` when set, else the config's ``remat_policy``
    (``_remat_policy`` of the JAX GPT)."""
    if not remat:
        return "off"
    return os.environ.get("RLT_REMAT_POLICY") or remat_policy


__all__ = ["MOE_POLICIES", "POLICY_LADDER", "model_policy", "policy_object"]
