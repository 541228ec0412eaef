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
"""

from __future__ import annotations

import logging

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

_log = logging.getLogger(__name__)


def fused_lm_cross_entropy(hidden, table, targets):
    """Mean token cross-entropy of ``hidden @ table.T`` against targets.

    hidden: [B, T, D] compute dtype; table: [V, D] tied embedding (any
    float dtype, cast to the compute dtype); targets: [B, T] int labels.
    Returns the fp32 scalar mean.
    """
    logits = F.linear(hidden, table.to(hidden.dtype))        # [B, T, V]
    with torch.no_grad():
        m = logits.amax(dim=-1)
    # upcast before the shift: both casts are exact (m is one of the
    # logits), so the exp argument carries full fp32 precision
    shifted = logits.float() - m.float()[..., None]
    lse = torch.log(torch.exp(shifted).sum(dim=-1)) + m.float()
    logit_y = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (lse - logit_y.float()).mean()


def _chunk_ce_sum(h, table, y):
    logits = F.linear(h.float(), table.float())               # [rows, V]
    return (torch.logsumexp(logits, dim=-1)
            - logits.gather(-1, y[:, None])[:, 0]).sum()


def chunked_softmax_cross_entropy(hidden, table, targets,
                                  n_chunks: int = 8):
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
        total = total + checkpoint(_chunk_ce_sum, h[i], table, y[i],
                                   use_reentrant=False)
    return total / rows_total


__all__ = ["chunked_softmax_cross_entropy", "fused_lm_cross_entropy"]
