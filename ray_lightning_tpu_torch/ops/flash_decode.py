"""Flash-decode: the per-token serve kernel and its plain version.

Counterpart of ``ray_lightning_tpu/ops/flash_decode.py``
``flash_decode_attention`` -> ``flash_decode_kernel`` (``_decode_body``).
Decode is bandwidth-bound — one query token per slot against its cache
rows — so the win is bytes not read: the kernel (``csrc/flash_decode.cu``)
walks each slot's cache only up to ``positions[s]``.

:func:`flash_decode_attention` is the wrapper: a CUDA tensor launches
the kernel (or raises), a CPU tensor takes
:func:`flash_decode_attention_plain`.  :func:`resolve_decode_impl`
reads ``RLT_DECODE_IMPL`` as the JAX package does.
"""

from __future__ import annotations

import math
import os

import torch

from ray_lightning_tpu_torch.ops._kernels import Kernel
from ray_lightning_tpu_torch.ops.flash_attention import HEAD_DIMS, NEG_INF

VALID_DECODE_IMPLS = ("auto", "dense", "flash_decode", "paged")

KERNEL = Kernel("flash_decode", "flash_decode.cu", "rlt_flash_decode",
                "ppppp" + "i" * 12 + "f" + "i" + "p")


def resolve_decode_impl(value: "str | None" = None,
                        device: "torch.device | str" = "cuda") -> str:
    """Decode attention impl: explicit value > ``RLT_DECODE_IMPL`` env >
    ``auto`` (CUDA -> ``flash_decode``; elsewhere the dense path stays
    the default, as the JAX package keeps it off the TPU).  ``dense`` is
    an explicit choice on any device; ``paged`` is not ported yet."""
    v = (value or os.environ.get("RLT_DECODE_IMPL") or "auto").lower()
    if v not in VALID_DECODE_IMPLS:
        raise ValueError(
            f"RLT_DECODE_IMPL must be one of {VALID_DECODE_IMPLS}, "
            f"got {v!r}")
    if v == "paged":
        raise NotImplementedError(
            "the paged flash-decode kernel is not ported yet")
    if v == "auto":
        return ("flash_decode" if torch.device(device).type == "cuda"
                else "dense")
    return v


def _check(q, k_cache, v_cache, positions) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [S, 1, H, D], got {tuple(q.shape)}")
    S, _, H, D = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or (k_cache.shape[0], k_cache.shape[2], k_cache.shape[3]) \
            != (S, H, D):
        raise ValueError(
            f"caches must be [S, L, H, D] = [{S}, L, {H}, {D}], got "
            f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if positions.shape != (S,):
        raise ValueError(
            f"positions must be [S] = [{S}], got {tuple(positions.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(
            f"head_dim {D} not supported; the kernel takes {HEAD_DIMS}")
    if len({q.device, k_cache.device, v_cache.device,
            positions.device}) != 1:
        raise ValueError("q, caches and positions must be on one device")


def flash_decode_attention_plain(q, k_cache, v_cache, positions):
    """The kernel's function in plain PyTorch.

    Slot ``s`` attends cache rows ``<= positions[s]`` (clamped to the
    cache, as the kernel clamps): fp32 scores, ``NEG_INF`` masking, a
    max-shifted softmax whose unnormalized ``p`` is rounded to the cache
    dtype before the PV product (fp32 accumulation), divided by the fp32
    sum — the rounding points of ``_decode_body``.  Returns
    ``[S, 1, H, D]`` in ``q``'s dtype.
    """
    D = q.shape[-1]
    L = k_cache.shape[1]
    pos = positions.long().clamp(0, L - 1)
    qf = q.float().permute(0, 2, 1, 3)                      # [S, H, 1, D]
    kf = k_cache.float().permute(0, 2, 3, 1)                # [S, H, D, L]
    vf = v_cache.float().permute(0, 2, 1, 3)                # [S, H, L, D]
    s = torch.matmul(qf, kf) * (1.0 / math.sqrt(D))         # [S, H, 1, L]
    live = torch.arange(L, device=q.device)[None, :] <= pos[:, None]
    s = s.masked_fill(~live[:, None, None, :], NEG_INF)
    # the kernel never reads a row past the position: zero those rows so
    # that whatever they hold (even NaN) cannot reach the product
    vf = vf.masked_fill(~live[:, None, :, None], 0.0)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v_cache.dtype).float(), vf)     # [S, H, 1, D]
    return (acc / l).to(q.dtype).permute(0, 2, 1, 3).contiguous()


def flash_decode_attention(q, k_cache, v_cache, positions):
    """Length-aware decode attention over the slot cache.

    ``q`` [S, 1, H, D]; ``k_cache``/``v_cache`` [S, L, H, D];
    ``positions`` [S] int32 on the same device; returns [S, 1, H, D].
    A CUDA tensor launches ``csrc/flash_decode.cu`` (bf16, head_dim in
    :data:`HEAD_DIMS`, unit stride over D, 16-byte-aligned rows); a CPU
    tensor takes :func:`flash_decode_attention_plain`.  It has no
    backward (nor has the JAX kernel): under grad mode with an input that
    requires grad it raises rather than return an output that autograd
    would silently cut off from its inputs.
    """
    _check(q, k_cache, v_cache, positions)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k_cache, v_cache)):
        raise RuntimeError(
            "flash_decode_attention has no backward: call it under "
            "torch.no_grad() / torch.inference_mode(), or with inputs "
            "that do not require grad")
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k_cache, v_cache, positions)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention: unsupported device "
                         f"{q.device}")
    S, _, H, D = q.shape
    L = k_cache.shape[1]
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_decode kernel takes bf16, {name} is "
                            f"{x.dtype}")
        if x.stride(3) != 1 or x.data_ptr() % 16 \
                or any(st % 8 for st in x.stride()[:3]):
            raise ValueError(
                f"flash_decode kernel needs unit stride over D and "
                f"16-byte aligned rows; {name} has strides {x.stride()}")
        if max(x.stride()[:3]) >= 2 ** 31:
            raise ValueError(f"{name} strides overflow int32")
    if positions.dtype != torch.int32 or not positions.is_contiguous():
        raise TypeError("positions must be contiguous int32")
    o = torch.empty(S, 1, H, D, dtype=q.dtype, device=q.device)
    if S == 0:
        return o
    stream = torch.cuda.current_stream(q.device).cuda_stream
    KERNEL.launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  positions.data_ptr(), o.data_ptr(), S, L, H, D,
                  q.stride(0), q.stride(2),
                  k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
                  v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
                  1.0 / math.sqrt(D), q.device.index or 0, stream)
    return o


__all__ = ["KERNEL", "NEG_INF", "VALID_DECODE_IMPLS",
           "flash_decode_attention", "flash_decode_attention_plain",
           "resolve_decode_impl"]
