"""Attention dispatch + the shared multi-head attention block.

Counterpart of ``ray_lightning_tpu/ops/attention.py``:

- :func:`dot_product_attention` — plain attention (materialized scores,
  fp32 softmax);
- :func:`auto_attention` — a CUDA tensor takes the flash kernels
  (ops/flash_attention.py: forward and, under autograd, backward), a
  CPU tensor the plain attention (differentiable by autograd), as the
  JAX package picks the Pallas kernels on the TPU only;
- :func:`cached_attention` — attention against the slot KV cache (the
  decode core; its multi-query form is the speculative verify): the
  flash-decode kernel, its paged form, or the dense path;
- :class:`CacheWrite` — where a decode or verify forward's K/V rows
  land in the cache, dropping rows past its end as jax's scatter does;
- :class:`MultiHeadAttention` — fused-QKV attention whose submodule
  names (``qkv``, ``proj``) match the JAX parameter paths, with dropout
  after its output projection in training;
- :func:`dropout` — flax's ``nn.Dropout`` on a keyed draw
  (ops/random.py), and :func:`fold_in`, which derives one key per
  dropout site.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_lightning_tpu_torch.ops.flash_attention import (NEG_INF,
                                                          flash_attention)
from ray_lightning_tpu_torch.ops.flash_decode import (
    flash_decode_attention, flash_decode_paged_attention,
    resolve_decode_impl)
from ray_lightning_tpu_torch.ops.random import Key, as_key


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
                     impl: "str | None" = None, page_table=None):
    """Attention of new tokens against a slot-indexed KV cache.

    ``q`` [S, 1, H, D] — one new token per slot; ``k_cache``/``v_cache``
    [S, L, H, D]; ``positions`` [S] int32 — slot s attends cache rows
    ``<= positions[s]`` (rows past it hold stale padding or a previous
    tenant's leftovers).  ``impl`` (explicit > ``RLT_DECODE_IMPL`` >
    ``auto``): ``flash_decode`` is the length-aware kernel
    (ops/flash_decode.py; its plain version on a CPU tensor), ``paged``
    the same kernel walking ``page_table`` ([S, P] int32 on the cache's
    device, serve/fleet/pages.py) over the cache's page view
    ``[S * P, L / P, H, D]`` (without a table it is ``flash_decode``),
    ``dense`` the masked product below.  Every geometry the kernels take
    goes to them: the JAX fallback to dense answered a TPU lane
    constraint.  A table whose pages do not tile L raises.

    Multi-query form (speculative verify, core/steps.py
    ``build_verify_step``): ``q`` [S, T, H, D] with ``positions``
    [S, T], each query masked to its OWN position, lowered as T
    single-query calls as the JAX package lowers it, so every query
    takes the plain decode path's kernel and masking.
    """
    if positions.dim() == 2:
        if q.shape[1] == 1:
            positions = positions[:, 0]
        else:
            return torch.cat(
                [cached_attention(q[:, j:j + 1], k_cache, v_cache,
                                  positions[:, j].contiguous(), dtype=dtype,
                                  impl=impl, page_table=page_table)
                 for j in range(q.shape[1])], dim=1)
    if q.shape[1] != 1:
        raise ValueError(f"q [S, T, H, D] with T={q.shape[1]} needs "
                         f"positions [S, T], got {tuple(positions.shape)}")
    impl = resolve_decode_impl(impl, q.device)
    if impl == "paged" and page_table is None:
        impl = "flash_decode"    # no table plumbed: slot-contiguous kernel
    if impl == "paged":
        S, L = k_cache.shape[:2]
        n_pages = page_table.shape[-1]
        if L % n_pages:
            raise ValueError(
                f"page table with {n_pages} pages cannot tile L={L}")
        ps = L // n_pages
        # the page view of a slot-contiguous cache (a view, no copy)
        view = (S * n_pages, ps) + tuple(k_cache.shape[2:])
        return flash_decode_paged_attention(
            q, k_cache.view(view), v_cache.view(view), positions,
            page_table).to(dtype)
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


class CacheWrite:
    """Where one forward's K/V rows land in a layer's cache.

    ``positions`` [S] or [S, T] (consecutive per slot, as decode, draft
    and verify send them) on the cache's device; ``L`` the cache length.
    The JAX package scatters with ``.at[].set``, which DROPS a row whose
    position is past the cache end (a slot speculating past it, an idle
    slot's dummy row at ``L - 1`` plus a draft or verify offset);
    torch's ``index_put_`` would fault there instead.  With
    ``drop_past_end`` such a row is redirected, without a host sync, to
    a write that changes nothing: to the position of the slot's last
    in-range row with that row's own value (positions are consecutive,
    so the clamp lands there), or, when none of the slot's rows is in
    range, to row ``L - 1`` with the value it already holds.  Without
    it the positions must lie in the cache (the engine checks them on
    the host) and the write is one ``index_put_``."""

    def __init__(self, positions, L: int, drop_past_end: bool = False):
        pos = positions.long()
        self.two_d = pos.dim() == 2
        if not self.two_d:
            pos = pos[:, None]
        S, T = pos.shape
        self.slots = torch.arange(S, device=pos.device)[:, None].expand(S, T)
        self.drop = drop_past_end
        if not drop_past_end:
            self.idx = pos
            return
        inside = pos < L
        n_in = inside.sum(dim=1, keepdim=True)                  # [S, 1]
        last = (n_in - 1).clamp_min(0)
        #: which of the slot's rows each entry writes
        self.src = torch.where(inside, torch.arange(T, device=pos.device),
                               last)
        self.idx = pos.clamp_max(L - 1)
        #: slots with no row in range rewrite the row they land on
        self.none_in = (n_in == 0)[..., None, None]              # [S,1,1,1]

    def __call__(self, cache, rows):
        """Write ``rows`` [S, T, H, D] (or [S, H, D] for 1-D positions)
        into ``cache`` [S, L, H, D] in place."""
        if not self.two_d:
            rows = rows[:, None]
        rows = rows.to(cache.dtype)
        if self.drop:
            if rows.shape[1] > 1:
                rows = rows.gather(1, self.src[..., None, None].expand(
                    rows.shape))
            rows = torch.where(self.none_in, cache[self.slots, self.idx],
                               rows)
        cache.index_put_((self.slots, self.idx), rows)


def fold_in(seed: "Key | int | None", *path: int) -> "Key | int | None":
    """The key of the dropout site at ``path`` (layer, site) under the
    forward's ``seed``, as ``jax.random.fold_in`` derives a key: a
    :class:`~ray_lightning_tpu_torch.ops.random.Key` extends its site
    path (host ints: a graph freezes nothing that changes); an int seed
    folds to an int; ``None`` stays ``None`` (no dropout).  Either way a
    block recomputed under remat draws its masks again bit for bit."""
    if seed is None:
        return None
    if isinstance(seed, Key):
        return seed.fold_in(*path)
    return int(np.random.SeedSequence((seed, *path)).generate_state(
        1, np.uint64)[0])


def dropout_keep_mask(shape, keep_prob: float, seed: "Key | int",
                      device) -> torch.Tensor:
    """Bernoulli(``keep_prob``) keep-mask of ``shape`` on ``device``: the
    keyed uniform draw of ``seed`` (ops/random.py; an int seeds a key)
    below ``keep_prob`` (``jax.random.bernoulli``'s role; the numbers
    differ from JAX's).  On the card the draw is ``csrc/philox.cu``,
    which a CUDA graph replays with each step's key."""
    return as_key(seed, device).uniform(shape) < keep_prob


def dropout(x, rate: float, seed: "Key | int | None"):
    """flax ``nn.Dropout(rate)`` in training: ``where(keep, x / keep_prob,
    0)`` in ``x``'s dtype, the mask from ``seed``
    (:func:`dropout_keep_mask`); the identity when ``seed`` is ``None``
    (flax's ``deterministic=True``) or ``rate`` is 0."""
    if seed is None or rate <= 0:
        return x
    if rate >= 1:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = dropout_keep_mask(x.shape, keep_prob, seed, x.device)
    # divide, as flax does: x * (1 / keep_prob) rounds otherwise in bf16
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


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
    cast to the compute ``dtype`` at use (:func:`linear`).  ``dropout``
    applies to the output projection when ``forward`` is given a seed
    (training); the attention probabilities carry none.
    """

    def __init__(self, n_embd: int, n_head: int, *, causal: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_impl: str = "auto", dropout: float = 0.0):
        super().__init__()
        if n_embd % n_head:
            raise ValueError(f"n_embd {n_embd} not divisible by n_head "
                             f"{n_head}")
        self.n_head = n_head
        self.causal = causal
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.dropout = dropout
        self.qkv = nn.Linear(n_embd, 3 * n_embd)
        self.proj = nn.Linear(n_embd, n_embd)

    def _qkv(self, x):
        B, T, C = x.shape
        shape = (B, T, self.n_head, C // self.n_head)
        # split views of the fused projection, as jnp.split(qkv, 3, -1):
        # the flash kernel reads them by strides, with no copy
        q, k, v = linear(self.qkv, x, self.dtype).split(C, dim=-1)
        return q.view(shape), k.view(shape), v.view(shape)

    def forward(self, x, dropout_seed: "int | None" = None):
        B, T, C = x.shape
        q, k, v = self._qkv(x)
        attend = resolve_attention(self.attention_impl)
        y = attend(q, k, v, causal=self.causal, dtype=self.dtype)
        y = linear(self.proj, y.reshape(B, T, C), self.dtype)
        return dropout(y, self.dropout, dropout_seed), (k, v)

    def decode(self, x, k_cache, v_cache, positions,
               impl: "str | None" = None, page_table=None,
               write: "CacheWrite | None" = None):
        """Serve decode (T = 1) or speculative verify (T = k + 1): ``x``
        [S, T, C], caches [S, L, H, D] of this layer, ``positions`` [S]
        or [S, T] int32; ``impl`` and ``page_table`` as in
        :func:`cached_attention`; ``write`` places the K/V rows (default:
        a :class:`CacheWrite` of ``positions``).  Writes every query's
        k/v row IN PLACE (where the JAX package returns a new cache from
        ``.at[].set`` on a donated buffer), then attends each query over
        the updated cache under its own position bound (causal by the
        bound: query j never sees rows of queries after it).  Slots with
        no live request write a dummy row (position 0, or ``L - 1`` under
        paging) that no live query reads before it is overwritten
        (serve/worker.py ``serve_step``)."""
        S, T, C = x.shape
        q, k, v = self._qkv(x)
        if write is None:
            write = CacheWrite(positions, k_cache.shape[1])
        write(k_cache, k if T > 1 else k[:, 0])
        write(v_cache, v if T > 1 else v[:, 0])
        y = cached_attention(q, k_cache, v_cache, positions,
                             dtype=self.dtype, impl=impl,
                             page_table=page_table)
        return linear(self.proj, y.reshape(S, T, C), self.dtype)


__all__ = ["CacheWrite", "MultiHeadAttention", "auto_attention",
           "cached_attention", "dot_product_attention", "dropout",
           "dropout_keep_mask", "fold_in", "linear", "resolve_attention"]
