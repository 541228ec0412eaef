"""Serve-plane step builders: the prefill and decode programs.

Counterpart of ``ray_lightning_tpu/core/steps.py``
``build_prefill_step`` / ``build_decode_step``.  A torch module holds
its own parameters, so the builders close over the decode model (the
JAX builders take the params as an argument of the jitted program);
PyTorch runs eagerly, so there is nothing to trace or compile.  The
caches are updated IN PLACE where the JAX programs return new caches
from donated buffers.
"""

from __future__ import annotations

from typing import Callable

import torch


def build_prefill_step(model: torch.nn.Module,
                       bucket_len: int) -> Callable:
    """Prefill for ONE sequence-length bucket.

    ``(k_caches, v_caches, tokens, slot, length) -> first_token``:
    ``tokens`` [1, bucket_len] (right-padded) long on the model's
    device; ``slot``/``length`` python ints.  Runs the whole-sequence
    forward, takes the greedy token at ``length - 1`` and writes every
    layer's K/V block into rows ``[0, bucket_len)`` of ``slot``.  Rows
    ``>= length`` hold pad garbage that the causal mask keeps out of the
    first token and ``cached_attention``'s position bound out of every
    later one.  Returns a 0-d long tensor (not yet synced).
    """
    def step_fn(k_caches, v_caches, tokens, slot: int, length: int):
        if tokens.shape != (1, bucket_len):
            raise ValueError(f"prefill_{bucket_len} takes tokens "
                             f"[1, {bucket_len}], got {tuple(tokens.shape)}")
        x, kvs = model.hidden(tokens)
        # only row length-1 feeds the first token: no [T, V] logits
        logits = model.head(x[0, length - 1])
        for i, (k, v) in enumerate(kvs):
            k_caches[i, slot, :bucket_len] = k[0]
            v_caches[i, slot, :bucket_len] = v[0]
        return torch.argmax(logits, dim=-1)

    return step_fn


def build_decode_step(model: torch.nn.Module,
                      impl: "str | None" = None) -> Callable:
    """Continuous-batching decode: THE serving hot path.

    ``(k_caches, v_caches, tokens, positions) -> next_tokens``: advances
    every slot one token; ``tokens``/``positions`` [S] int32 on the
    model's device, caches [n_layer, S, L, H, D] written in place.
    ``impl`` is the decode attention (``dense`` | ``flash_decode``,
    ops/flash_decode.py ``resolve_decode_impl``).  Returns [S] long
    (not yet synced).
    """
    def step_fn(k_caches, v_caches, tokens, positions):
        logits = model.decode(tokens, positions, k_caches, v_caches,
                              impl=impl)
        return torch.argmax(logits, dim=-1)

    return step_fn


__all__ = ["build_decode_step", "build_prefill_step"]
