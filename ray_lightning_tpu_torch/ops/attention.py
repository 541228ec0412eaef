"""Attention dispatch + the shared multi-head attention block.

Counterpart of ``ray_lightning_tpu/ops/attention.py``:

- :func:`dot_product_attention` — plain attention (materialized scores,
  fp32 softmax);
- :func:`auto_attention` — a CUDA tensor takes the flash kernels
  (ops/flash_attention.py: forward and, under autograd, backward), a
  CPU tensor the plain attention (differentiable by autograd), as the
  JAX package picks the Pallas kernels on the TPU only;
- :func:`cached_attention` — single-query attention against the slot KV
  cache (the decode core): the flash-decode kernel or the dense path;
- :class:`MultiHeadAttention` — fused-QKV attention whose submodule
  names (``qkv``, ``proj``) match the JAX parameter paths.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ray_lightning_tpu_torch.ops.flash_attention import (NEG_INF,
                                                          flash_attention)
from ray_lightning_tpu_torch.ops.flash_decode import (
    flash_decode_attention, resolve_decode_impl)


def dot_product_attention(q, k, v, *, causal: bool = True,
                          dtype: torch.dtype = torch.bfloat16):
    """Plain attention over ``[B, T, H, D]``: fp32 scores, causal mask at
    ``finfo(float32).min``, fp32 softmax, probabilities cast to ``dtype``
    before the PV product (ops/attention.py:36-52 of the JAX package)."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(d)
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        keep = torch.ones(tq, tk, dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        scores = scores.masked_fill(~keep, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(torch.promote_types(dtype, v.dtype))


def auto_attention(q, k, v, **kw):
    """Device choice: CUDA -> the flash kernels, CPU -> plain attention."""
    if q.device.type == "cuda":
        return flash_attention(q, k, v, **kw)
    return dot_product_attention(q, k, v, **kw)


def resolve_attention(impl: str) -> Callable:
    if impl == "auto":
        return auto_attention
    if impl == "dot":
        return dot_product_attention
    if impl == "flash":
        return flash_attention
    if impl in ("ring", "local"):
        raise NotImplementedError(
            f"attention_impl={impl!r} is not ported yet")
    raise ValueError(f"Unknown attention_impl {impl!r}")


def cached_attention(q, k_cache, v_cache, positions, *,
                     dtype: torch.dtype = torch.bfloat16,
                     impl: "str | None" = None):
    """Single-token attention against a slot-indexed KV cache.

    ``q`` [S, 1, H, D] — one new token per slot; ``k_cache``/``v_cache``
    [S, L, H, D]; ``positions`` [S] int32 — slot s attends cache rows
    ``<= positions[s]`` (rows past it hold stale padding or a previous
    tenant's leftovers).  ``impl`` (explicit > ``RLT_DECODE_IMPL`` >
    ``auto``): ``flash_decode`` is the length-aware kernel
    (ops/flash_decode.py; its plain version on a CPU tensor), ``dense``
    the masked product below.  Every geometry the kernel takes goes to
    it: the JAX fallback to dense answered a TPU lane constraint.  The
    multi-query (speculative verify) form is not ported yet.
    """
    if q.shape[1] != 1 or positions.dim() != 1:
        raise NotImplementedError(
            "multi-query cached_attention (speculative verify) is not "
            "ported yet")
    impl = resolve_decode_impl(impl, q.device)
    if impl == "flash_decode":
        return flash_decode_attention(q, k_cache, v_cache,
                                      positions).to(dtype)
    d = q.shape[-1]
    scores = torch.einsum("sqhd,slhd->shql", q.float(), k_cache.float())
    scores = scores / math.sqrt(d)
    valid = (torch.arange(k_cache.shape[1], device=q.device)[None, :]
             <= positions[:, None])
    # NEG_INF (-1e30), not finfo.min: the flash kernels' NaN-free masking
    # constant, as in the JAX dense path
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("shql,slhd->sqhd", probs.float(), v_cache.float())
    return out.to(torch.promote_types(dtype, v_cache.dtype))


def linear(layer: nn.Linear, x, dtype: torch.dtype):
    """``layer`` with its weight, bias and input cast to the compute
    ``dtype``, as flax's ``Dense(dtype=...)`` promotes them (a no-op
    cast when the params already live in ``dtype``)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class MultiHeadAttention(nn.Module):
    """Fused-QKV multi-head attention: ``[B, T, C] -> [B, T, C]``.

    ``forward`` is the train/prefill branch and also returns the layer's
    ``(k, v)`` ([B, T, H, D] each), which the prefill step writes into
    the slot cache (the JAX package sows them into a ``kv_cache``
    collection).  :meth:`decode` is the serve decode branch.  Weights are
    cast to the compute ``dtype`` at use (:func:`linear`).
    """

    def __init__(self, n_embd: int, n_head: int, *, causal: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_impl: str = "auto"):
        super().__init__()
        if n_embd % n_head:
            raise ValueError(f"n_embd {n_embd} not divisible by n_head "
                             f"{n_head}")
        self.n_head = n_head
        self.causal = causal
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.qkv = nn.Linear(n_embd, 3 * n_embd)
        self.proj = nn.Linear(n_embd, n_embd)

    def _qkv(self, x):
        B, T, C = x.shape
        shape = (B, T, self.n_head, C // self.n_head)
        # split views of the fused projection, as jnp.split(qkv, 3, -1):
        # the flash kernel reads them by strides, with no copy
        q, k, v = linear(self.qkv, x, self.dtype).split(C, dim=-1)
        return q.view(shape), k.view(shape), v.view(shape)

    def forward(self, x):
        B, T, C = x.shape
        q, k, v = self._qkv(x)
        attend = resolve_attention(self.attention_impl)
        y = attend(q, k, v, causal=self.causal, dtype=self.dtype)
        return linear(self.proj, y.reshape(B, T, C), self.dtype), (k, v)

    def decode(self, x, k_cache, v_cache, positions,
               impl: "str | None" = None):
        """Serve decode: ``x`` [S, 1, C], caches [S, L, H, D] of this
        layer, ``positions`` [S] int32; ``impl`` as in
        :func:`cached_attention`.  Writes each slot's new k/v row at its
        position IN PLACE (``index_put_`` where the JAX package returns a
        new cache from ``.at[].set`` on a donated buffer), then attends
        over the updated cache.  Slots with no live request write a dummy
        row at position 0 that their admitting prefill overwrites (hence
        decode before prefill in ``ServeWorker.serve_step``)."""
        S, T, C = x.shape
        q, k, v = self._qkv(x)
        slots = torch.arange(S, device=x.device)
        idx = (slots, positions.long())
        k_cache.index_put_(idx, k[:, 0].to(k_cache.dtype))
        v_cache.index_put_(idx, v[:, 0].to(v_cache.dtype))
        y = cached_attention(q, k_cache, v_cache, positions,
                             dtype=self.dtype, impl=impl)
        return linear(self.proj, y.reshape(S, T, C), self.dtype)


__all__ = ["MultiHeadAttention", "auto_attention", "cached_attention",
           "dot_product_attention", "linear", "resolve_attention"]
