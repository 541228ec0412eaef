"""Reshardable restore: a snapshot taken at N ranks restored onto M.

Counterpart of ``ray_lightning_tpu/elastic/reshard.py``.  The reader is
the trainer's own (core/trainer.py ``_restore_sharded`` over
utils/checkpoint.py): every rank reads the saved chunks that overlap
the blocks its layout wants, so params, buffers and the optimizer
state (ZeRO-1's flat shards included, cut anew for M ranks) move
between world sizes with no second reader.  This module holds what the
restore checks and re-buckets:

1. :func:`saved_residual_world` reads the saved comm-plane residual's
   stacked world size from the checkpoint metadata (no tensor data);
2. :func:`_verify_shapes` holds every tensor of the restore target to
   the saved global shape: a divergence (another model) raises naming
   the leaf, instead of a restore that reads the wrong chunks;
3. :func:`_rebucket` is the residual's N -> M rule: each new rank's row
   is the mean of the N saved rows.  What error feedback injects into
   the model is ``(1/world) * sum_i r_i`` (each rank adds its row before
   the mean-reduction), and the mean-broadcast keeps it exactly:
   ``(1/M) * sum_j mean_i(old) = (1/N) * sum_i old_i``.  The per-rank
   attribution of the error is lost, so the first step after the
   restore quantizes slightly other payloads than an uninterrupted run.
   ``CommState.load_residual`` applies the same rule row by row
   (comm/collectives.py ``load_residual``).
"""

from __future__ import annotations

import logging
from typing import Mapping, Optional

import torch

_log = logging.getLogger(__name__)

_RESIDUAL = "opt_state/residual/"


def saved_residual_world(md: Optional[Mapping]) -> Optional[int]:
    """The saved ``CommState`` residual's stacked world size, or None
    when the save holds no residual (the comm plane or its error
    feedback off).  ``md``: ``ShardedCheckpointer.saved_state_metadata``
    (``{key: (shape, dtype)}``)."""
    if not md:
        return None
    for key, (shape, _dtype) in md.items():
        if key.startswith(_RESIDUAL):
            return int(shape[0])
    return None


def _rebucket(old: "Mapping[str, torch.Tensor]", new_world: int
              ) -> "dict[str, torch.Tensor]":
    """``[N, ...]`` residual rows -> ``[M, ...]``: the mean over the old
    world axis, in fp32, broadcast to every new rank (module
    docstring)."""
    out = {}
    for k, r in old.items():
        m = r.float().mean(0, keepdim=True)
        out[k] = m.expand((new_world,) + tuple(m.shape[1:])).clone()
    return out


def _verify_shapes(md: Mapping, target: Mapping) -> None:
    """Every tensor of ``target`` (a flat ``{key: tensor or DTensor}``,
    global shapes) must be in the save at the same global shape; raise
    ``ValueError`` naming each leaf that is not."""
    problems = []
    for key, leaf in target.items():
        if not isinstance(leaf, torch.Tensor):
            continue
        got = md.get(key)
        if got is None:
            problems.append(f"{key}: missing from the checkpoint")
        elif tuple(got[0]) != tuple(leaf.shape):
            problems.append(f"{key}: saved shape {tuple(got[0])} != "
                            f"target {tuple(leaf.shape)}")
    if problems:
        raise ValueError("checkpoint does not reshard onto this "
                         "topology:\n  " + "\n  ".join(problems))


__all__ = ["saved_residual_world"]
