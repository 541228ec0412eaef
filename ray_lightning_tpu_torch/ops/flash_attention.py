"""Flash attention forward: the prefill kernel and its plain version.

Counterpart of ``ray_lightning_tpu/ops/flash_attention.py``
``flash_attention`` -> ``_fwd`` -> ``_fwd_packed`` ->
``_fwd_packed_kernel``, the Pallas forward every prefill bucket takes at
gpt2-small.  Here the kernel is ``csrc/flash_fwd.cu`` (CUDA C++ for
``sm_90a``), bound through :mod:`._kernels`.

:func:`flash_attention_fwd` is the wrapper: a CUDA tensor launches the
kernel (or raises on what the kernel does not take), a CPU tensor takes
:func:`flash_attention_fwd_plain`, which computes the same function
with the same rounding points in plain PyTorch.  Forward only: the
training backward is a later slice.
"""

from __future__ import annotations

import math

import torch

from ray_lightning_tpu_torch.ops._kernels import Kernel

#: large-negative instead of -inf: keeps exp/log NaN-free
NEG_INF = -1e30
#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)

KERNEL = Kernel("flash_fwd", "flash_fwd.cu", "rlt_flash_fwd",
                "ppppp" + "i" * 14 + "f" + "i" + "p")


def _check(q, k, v) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share one [B, T, H, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(
            f"head_dim {q.shape[-1]} not supported; the kernel takes "
            f"{HEAD_DIMS}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k, v must be on one device")


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              sm_scale: "float | None" = None):
    """The kernel's function in plain PyTorch: ``(o, lse)``.

    Scores in fp32 from the stored operands, ``NEG_INF`` masking, a
    max-shifted softmax whose unnormalized ``p`` is rounded to the input
    dtype before the PV product (fp32 accumulation), then divided by the
    fp32 row sum — the rounding points of ``_fwd_packed_kernel``.
    Returns ``o`` [B, T, H, D] in the input dtype and fp32 ``lse``
    [B, H, T].
    """
    T, D = q.shape[1], q.shape[3]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale     # [B,H,T,T]
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), vf)
    o = (acc / l).to(q.dtype).transpose(1, 2).contiguous()
    lse = (m + torch.log(l)).squeeze(-1)
    return o, lse


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        sm_scale: "float | None" = None):
    """Attention forward over ``[B, T, H, D]``: ``(o, lse)``.

    A CUDA tensor launches ``csrc/flash_fwd.cu``: bf16 only, head_dim in
    :data:`HEAD_DIMS`, unit stride over D and 16-byte-aligned rows (the
    split views of a fused qkv projection qualify, with no copy).  A CPU
    tensor takes :func:`flash_attention_fwd_plain`.
    """
    _check(q, k, v)
    B, T, H, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device "
                         f"{q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_fwd kernel takes bf16, {name} is "
                            f"{x.dtype}")
        if x.stride(3) != 1 or x.data_ptr() % 16 \
                or any(st % 8 for st in x.stride()[:3]):
            raise ValueError(
                f"flash_fwd kernel needs unit stride over D and 16-byte "
                f"aligned rows; {name} has strides {x.stride()}")
        if max(x.stride()[:3]) >= 2 ** 31:
            raise ValueError(f"{name} strides overflow int32")
    o = torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    if T == 0 or B == 0:
        return o, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), B, T, H, D,
                  q.stride(0), q.stride(1), q.stride(2),
                  k.stride(0), k.stride(1), k.stride(2),
                  v.stride(0), v.stride(1), v.stride(2),
                  int(bool(causal)), float(sm_scale), q.device.index or 0,
                  stream)
    return o, lse


def flash_attention(q, k, v, *, causal: bool = True,
                    dtype: torch.dtype = torch.bfloat16,
                    sm_scale: "float | None" = None):
    """Flash attention over ``[B, T, H, D]`` (BTHD in, BTHD out): the
    drop-in for :func:`~ray_lightning_tpu_torch.ops.attention.
    dot_product_attention`, as in the JAX package."""
    o, _ = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
    return o.to(dtype)


__all__ = ["HEAD_DIMS", "KERNEL", "NEG_INF", "flash_attention",
           "flash_attention_fwd", "flash_attention_fwd_plain"]
