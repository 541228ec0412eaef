"""Language-model losses over the tied embedding.

Counterpart of ``ray_lightning_tpu/ops/losses.py``, in plain PyTorch
with the same rounding points (neither is a Pallas kernel there):

- :func:`fused_lm_cross_entropy`: logits in the compute dtype from the
  tied table, the row max taken without gradient (the JAX
  ``stop_gradient``), upcast to fp32 before the shift, the label logit
  gathered from the compute-dtype logits;
- :func:`chunked_softmax_cross_entropy`: fp32 logits a row chunk at a
  time, each chunk recomputed in the backward pass
  (``torch.utils.checkpoint``, the JAX ``jax.checkpoint`` under
  ``lax.scan``), so the full [B*T, V] logits never exist at once.

Both take ``tp`` (a ``parallel.tensor.TensorGroup``) when the tied table
is vocab-parallel (``gpt_partition_rules``' ``wte`` rule): ``table`` is
then this rank's rows and the logits its vocab slice; the row max, the
sum of the exponentials and the target logit are taken over the group
(three all-reduces a chunk), so the [B, T, V] logits are never gathered.
"""

from __future__ import annotations

import logging

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_lightning_tpu_torch.parallel.tensor import (column_parallel,
                                                     copy_to, reduce_from,
                                                     target_logit, vocab_max)

_log = logging.getLogger(__name__)


def fused_lm_cross_entropy(hidden, table, targets, tp=None):
    """Mean token cross-entropy of ``hidden @ table.T`` against targets.

    hidden: [B, T, D] compute dtype; table: [V, D] tied embedding (any
    float dtype, cast to the compute dtype; under ``tp`` this rank's
    rows); targets: [B, T] int labels.  Returns the fp32 scalar mean.
    """
    # the head is column-parallel: the hidden states' gradient is summed
    # over the group (in fp32)
    logits = column_parallel(hidden, table.to(hidden.dtype), None,
                             tp)                             # [B, T, V]
    m = vocab_max(logits, tp)
    # upcast before the shift: both casts are exact (m is one of the
    # logits), so the exp argument carries full fp32 precision
    shifted = logits.float() - m.float()[..., None]
    lse = torch.log(reduce_from(torch.exp(shifted).sum(dim=-1), tp)) \
        + m.float()
    return (lse - target_logit(logits, targets, tp)).mean()


def _chunk_ce_sum(h, table, y):
    logits = F.linear(h.float(), table.float())               # [rows, V]
    return (torch.logsumexp(logits, dim=-1)
            - logits.gather(-1, y[:, None])[:, 0]).sum()


def _chunk_ce_sum_tp(h, table, y, tp):
    """:func:`_chunk_ce_sum` over a vocab-parallel table, the rows'
    gradient summed over the group in fp32 (``copy_to`` after the
    upcast)."""
    logits = F.linear(copy_to(h.float(), tp), table.float())  # [rows, V/t]
    m = vocab_max(logits, tp)
    lse = torch.log(reduce_from(torch.exp(logits - m[:, None]).sum(-1),
                                tp)) + m
    return (lse - target_logit(logits, y, tp)).sum()


def chunked_softmax_cross_entropy(hidden, table, targets,
                                  n_chunks: int = 8, tp=None):
    """Mean token cross-entropy of ``hidden @ table.T`` over ``n_chunks``
    row chunks (fewer when the rows do not divide, with a warning, as
    in the JAX package).  Each chunk's logits are the fp32 product of
    the compute-dtype operands (bf16 values, fp32 accumulation:
    ``preferred_element_type=float32``)."""
    B, T, D = hidden.shape
    rows_total = B * T
    requested = n_chunks
    n_chunks = max(1, min(n_chunks, rows_total))
    while rows_total % n_chunks:
        n_chunks -= 1
    if n_chunks < min(requested, rows_total):
        _log.warning(
            "chunked CE: %d rows not divisible into %d chunks; using %d "
            "(peak logits memory grows by the same factor).",
            rows_total, requested, n_chunks)
    h = hidden.reshape(n_chunks, rows_total // n_chunks, D)
    y = targets.long().reshape(n_chunks, rows_total // n_chunks)
    table = table.to(hidden.dtype)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        total = total + (
            checkpoint(_chunk_ce_sum, h[i], table, y[i], use_reentrant=False)
            if tp is None else
            checkpoint(_chunk_ce_sum_tp, h[i], table, y[i], tp,
                       use_reentrant=False))
    return total / rows_total


__all__ = ["chunked_softmax_cross_entropy", "fused_lm_cross_entropy"]
