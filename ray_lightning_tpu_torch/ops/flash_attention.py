"""Flash attention: the forward and backward kernels and their plain
versions.

Counterpart of ``ray_lightning_tpu/ops/flash_attention.py``
``flash_attention`` -> the ``_flash`` custom VJP, whose forward takes
``_fwd`` -> ``_fwd_packed`` -> ``_fwd_packed_kernel`` and whose backward
takes ``_bwd`` -> ``_bwd_packed`` -> ``_bwd_packed_kernel``: the Pallas
pair every prefill bucket and every training step at T <= 1024 run at
gpt2-small.  Here the kernels are ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu`` (CUDA C++ for ``sm_90a``), bound through
:mod:`._kernels`.

:func:`flash_attention_fwd` and :func:`flash_attention_bwd` are the
wrappers: a CUDA tensor launches the kernel (or raises on what the
kernel does not take), a CPU tensor takes the ``_plain`` version, which
computes the same function with the same rounding points in plain
PyTorch.  :class:`FlashAttentionFunction` ties the two into autograd, as
the custom VJP does in the JAX package.
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
BWD_KERNEL = Kernel("flash_bwd", "flash_bwd.cu", "rlt_flash_bwd",
                    "p" * 10 + "i" * 20 + "f" + "i" + "p")


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


def _check_kernel_operands(kernel: str, **tensors) -> None:
    """What the CUDA kernels take, or raise: a CUDA device, bf16, unit
    stride over D, 16-byte-aligned rows and int32 strides."""
    for name, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"{kernel}: unsupported device {x.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{kernel} kernel takes bf16, {name} is "
                            f"{x.dtype}")
        if x.stride(3) != 1 or x.data_ptr() % 16 \
                or any(st % 8 for st in x.stride()[:3]):
            raise ValueError(
                f"{kernel} kernel needs unit stride over D and 16-byte "
                f"aligned rows; {name} has strides {x.stride()}")
        if max(x.stride()[:3]) >= 2 ** 31:
            raise ValueError(f"{name} strides overflow int32")


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
    _check_kernel_operands("flash_fwd", q=q, k=k, v=v)
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


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              sm_scale: "float | None" = None):
    """The backward kernel's function in plain PyTorch: ``(dq, dk, dv)``.

    ``_single_block_bwd_math`` with its rounding points: fp32 scores
    under ``NEG_INF`` masking, ``p = exp(s - lse)`` from the forward's
    lse [B, H, T], ``dv = p^T dO`` with ``p`` rounded to the input dtype,
    ``dp = dO v^T``, ``ds = p (dp - delta)`` with ``delta = rowsum(dO o)``
    in fp32, ``ds`` rounded to the input dtype before both ``dk = ds^T q``
    and ``dq = ds k`` (each times ``sm_scale``); fp32 accumulation.
    Returns [B, T, H, D] tensors in the dtypes of q, k, v.
    """
    T, D = q.shape[1], q.shape[3]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    qf, kf, vf, of, dof = (x.float().transpose(1, 2)
                           for x in (q, k, v, o, do))          # [B,H,T,D]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    if causal:
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - lse.float().unsqueeze(-1))
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * of).sum(-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).float()
    dk = torch.matmul(ds.transpose(-1, -2), qf) * sm_scale
    dq = torch.matmul(ds, kf) * sm_scale
    return tuple(g.to(x.dtype).transpose(1, 2).contiguous()
                 for g, x in ((dq, q), (dk, k), (dv, v)))


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        sm_scale: "float | None" = None):
    """Attention backward over ``[B, T, H, D]``: ``(dq, dk, dv)`` from the
    forward's ``o`` and fp32 ``lse`` [B, H, T] and the output gradient
    ``do``.

    A CUDA tensor launches ``csrc/flash_bwd.cu`` (one launch: its delta,
    dk/dv and dq passes), on the same terms as the forward: bf16, head_dim
    in :data:`HEAD_DIMS`, unit stride over D and 16-byte-aligned rows for
    q, k, v, o and do.  A CPU tensor takes
    :func:`flash_attention_bwd_plain`.
    """
    _check(q, k, v)
    B, T, H, D = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, T):
        raise ValueError(
            f"o and do must be {tuple(q.shape)} and lse {(B, H, T)}, got "
            f"{tuple(o.shape)}, {tuple(do.shape)}, {tuple(lse.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         sm_scale=sm_scale)
    _check_kernel_operands("flash_bwd", q=q, k=k, v=v, o=o, do=do)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError("flash_bwd kernel takes a contiguous fp32 lse")
    dq, dk, dv = (torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    if T == 0 or B == 0:
        return dq, dk, dv
    delta = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    strides = [st for x in (q, k, v, o, do) for st in x.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    BWD_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, H,
                      D, *strides, int(bool(causal)), float(sm_scale),
                      q.device.index or 0, stream)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """``o = attention(q, k, v)`` with the flash kernels on both sides:
    the forward saves ``q, k, v, o, lse`` (the JAX ``_flash_fwd``
    residuals), the backward is :func:`flash_attention_bwd`.  q, k, v
    may be the split views of one fused projection: autograd sums their
    gradients into its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: "float | None"):
        o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal,
                                         sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    dtype: torch.dtype = torch.bfloat16,
                    sm_scale: "float | None" = None):
    """Flash attention over ``[B, T, H, D]`` (BTHD in, BTHD out): the
    drop-in for :func:`~ray_lightning_tpu_torch.ops.attention.
    dot_product_attention`, as in the JAX package, differentiable through
    :class:`FlashAttentionFunction`."""
    o = FlashAttentionFunction.apply(q, k, v, causal, sm_scale)
    return o.to(dtype)


__all__ = ["BWD_KERNEL", "FlashAttentionFunction", "HEAD_DIMS", "KERNEL",
           "NEG_INF", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_fwd",
           "flash_attention_fwd_plain"]
