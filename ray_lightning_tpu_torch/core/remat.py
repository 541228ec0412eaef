"""Remat (activation recomputation) policies for the port's models.

Counterpart of ``ray_lightning_tpu/core/remat.py`` ``policy_object`` and
of ``models/gpt.py`` ``_remat_policy`` (the ``RLT_REMAT_POLICY``
override).  There a policy is a ``jax.checkpoint`` policy handed to
``nn.remat`` around each block; here it is a wrapper that runs one block
under ``torch.utils.checkpoint`` (or ``None``: no wrap), every policy
but "full" and "off" a selective checkpoint
(``create_selective_checkpoint_contexts``) whose policy function sees
each dispatcher op the block runs:

- ``"off"``: no wrap (``everything_saveable``);
- ``"dots"``: save the output of every matrix product (``mm``,
  ``addmm``, ``bmm``, ``baddbmm`` and the einsums and linears that lower
  to them), recompute the rest (``dots_saveable``);
- ``"dots_no_batch"``: save only the products without batch dims
  (``mm``, ``addmm``: a linear over ``[B, T, C]`` folds to one), so the
  plain attention's and the MoE layer's batched products are recomputed
  (``dots_with_no_batch_dims_saveable``);
- ``"dots_moe_act"`` / ``"dots_moe"``: ``"dots"`` plus the named MoE
  intermediates ``moe_hact`` / ``moe_hact``, ``moe_dispatch``,
  ``moe_combine`` (``save_from_both_policies`` with
  ``save_only_these_names``).  A name reaches the policy through
  :func:`checkpoint_name`, the custom op ``rlt::checkpoint_name``;
- ``"full"``: save nothing inside the block (jax's default policy,
  ``None``): ``checkpoint(block, x, use_reentrant=False)``.

The attention kernels are custom ops (``rlt::flash_fwd``,
ops/flash_attention.py), not products: every policy but "off" recomputes
them in the backward pass, as ``jax.checkpoint``'s dots policies
recompute a ``pallas_call``.  Neither policy stashes the RNG state: a
block's draws are keyed (ops/random.py), so the recompute draws them
again bit for bit.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

#: the JAX package's policy ladder (no recompute -> max recompute) and
#: its MoE save lists: every name a config may carry
POLICY_LADDER = ("off", "dots", "dots_no_batch", "full")
MOE_POLICIES = ("dots_moe_act", "dots_moe")

_aten = torch.ops.aten
#: matrix products without batch dims, and those with
_NO_BATCH_DOTS = frozenset({_aten.mm.default, _aten.addmm.default,
                            _aten.mv.default, _aten.addmv.default,
                            _aten.dot.default})
_BATCH_DOTS = frozenset({_aten.bmm.default, _aten.baddbmm.default})
#: the named intermediates each MoE save list adds to "dots"
MOE_NAMES = {"dots_moe_act": ("moe_hact",),
             "dots_moe": ("moe_hact", "moe_dispatch", "moe_combine")}


@torch.library.custom_op("rlt::checkpoint_name", mutates_args=())
def CHECKPOINT_NAME_OP(x: torch.Tensor, name: str) -> torch.Tensor:
    """``rlt::checkpoint_name``: a copy of ``x`` that carries ``name`` to
    a selective-checkpoint policy (a custom op may not return its
    input)."""
    return x.clone()


@CHECKPOINT_NAME_OP.register_fake
def _(x, name):
    return x.new_empty(x.shape)


def _name_setup(ctx, inputs, output):
    pass


CHECKPOINT_NAME_OP.register_autograd(lambda ctx, grad: (grad, None),
                                     setup_context=_name_setup)


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``jax.ad_checkpoint.checkpoint_name``: ``x``, tagged for the MoE
    save lists (callers tag only under those policies: the tag is a
    copy)."""
    return CHECKPOINT_NAME_OP(x, name)


def save_policy(name: str) -> Optional[Callable]:
    """The selective-checkpoint policy function of a policy name
    (``(ctx, op, *args, **kwargs) -> CheckpointPolicy``): ``MUST_SAVE``
    for the products and tags the policy keeps, ``PREFER_RECOMPUTE`` for
    every other op; ``None`` for "off" and "full", which need none.
    Raises ``ValueError`` for an unknown name."""
    if name in ("off", "full"):
        return None
    if name == "dots_no_batch":
        dots, names = _NO_BATCH_DOTS, ()
    elif name == "dots" or name in MOE_NAMES:
        dots, names = _NO_BATCH_DOTS | _BATCH_DOTS, MOE_NAMES.get(name, ())
    else:
        raise ValueError(f"remat_policy {name!r}; options: "
                         f"{sorted(POLICY_LADDER + MOE_POLICIES)}")

    def policy(ctx, op, *args, **kwargs):
        if op in dots or (op is torch.ops.rlt.checkpoint_name.default
                          and args[1] in names):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def policy_object(name: str) -> Optional[Callable]:
    """The block wrapper for a policy name: ``None`` for ``"off"``, else
    a ``(fn, *args) -> out`` running ``fn`` under a non-reentrant
    checkpoint ("full") or a selective one with :func:`save_policy`'s
    function (the rest; module docstring).  The RNG state is not stashed
    for the recompute: a block's draws are keyed (ops/random.py
    ``Key``), so the recompute draws them again bit for bit.  Raises
    ``ValueError`` for an unknown name."""
    if name == "off":
        return None
    policy = save_policy(name)
    context = {} if policy is None else {
        "context_fn": functools.partial(
            create_selective_checkpoint_contexts, policy)}
    return functools.partial(checkpoint, use_reentrant=False,
                             preserve_rng_state=False, **context)


def model_policy(remat: bool, remat_policy: str) -> str:
    """The policy a model build uses: ``"off"`` without remat, else
    ``RLT_REMAT_POLICY`` when set, else the config's ``remat_policy``
    (``_remat_policy`` of the JAX GPT)."""
    if not remat:
        return "off"
    return os.environ.get("RLT_REMAT_POLICY") or remat_policy


__all__ = ["CHECKPOINT_NAME_OP", "MOE_NAMES", "MOE_POLICIES",
           "POLICY_LADDER", "checkpoint_name", "model_policy",
           "policy_object", "save_policy"]
