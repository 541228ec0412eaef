"""Flash attention: the forward and backward kernels and their plain
versions.

Counterpart of ``ray_lightning_tpu/ops/flash_attention.py``
``flash_attention`` -> the ``_flash`` custom VJP, whose ``_fwd`` and
``_bwd`` pick a Pallas kernel by the shape (:func:`tpu_rows` is the
port's copy of those gates).  Heads that pack (``_head_pack(d, h) > 0``,
e.g. d=64 in packs of two: w = 128 lanes) take the packed kernels;
heads that do not (h % (128 // d) != 0: the ``tiny`` family's h=2,
d=32, or GPT-2 XL's 25 heads of 64), and every multi-block shape that
is not causal with square blocks, fold to ``[B*H, T, D]``:

==============================  =============================  ==========
JAX kernel (TPU kernel row)     reached at                     port
==============================  =============================  ==========
``_fwd_packed_kernel`` (1)      packed, one block: T <= 1024,  flash_fwd
                                causal or not (BERT)
``_fwd_rowres_kernel`` (3)      packed, causal, T > 1024,      flash_fwd
                                t*w <= 8192*128
``_fwd_tri_packed_kernel`` (2)  packed, causal, t*w > 8192*128 flash_fwd
                                or ``RLT_FLASH_ROWRES=0``
``_fwd_tri_kernel`` (4)         folded, causal, square blocks, flash_fwd
                                more than one (T > 1024)
``_fwd_kernel`` (5)             folded, any other shape: one   flash_fwd
                                block, non-causal multi-block,
                                uneven blocks, ``RLT_FLASH_
                                TRI=0``
``_bwd_packed_kernel`` (6)      packed, one block, causal or   flash_bwd
                                not
``_bwd_rowres_kernel`` (9)      packed, causal, T > 1024,      flash_bwd
                                t*w <= 2048*128
``_bwd_dkdv_tri_packed_kernel`` packed, causal, t*w > 2048*128 flash_bwd
(7), ``_bwd_dq_tri_packed_      or ``RLT_FLASH_ROWRES=0``      dk/dv, dq
kernel`` (8)                                                   passes
``_bwd_fused_kernel`` (10)      folded, one block              flash_bwd
``_bwd_dkdv_tri_kernel`` (11),  folded, causal, square blocks, flash_bwd
``_bwd_dq_tri_kernel`` (12)     more than one                  dk/dv, dq
``_bwd_dkdv_kernel`` (15),      folded, any other multi-block  flash_bwd
``_bwd_dq_kernel`` (16)         shape                          dk/dv, dq
==============================  =============================  ==========

(Blocks default to T up to 1024, else 512, halved until they divide T;
``RLT_FLASH_BLOCK_Q/K`` or :func:`tpu_rows`' arguments override them.)  The
TPU kernels differ in layout (packed or folded) and in what they keep
in VMEM (whole rows, resident k/v, triangular grids); they compute one
function: fp32 scores, a causal or full softmax under ``NEG_INF``
masking, ``p`` rounded to the input dtype before PV and dV, ``ds``
before dK and dQ.  The port computes that function with one CUDA
forward, ``csrc/flash_fwd.cu``, and one CUDA backward,
``csrc/flash_bwd.cu`` (CUDA C++ for ``sm_90a`` on wgmma and TMA, bound
through :mod:`._kernels`), for every T and head count: tiles read by
strides from ``[B, T, H, D]`` (no fold; the forward's blocks take 128 q
rows against 128-row k/v tiles, the backward's 128 resident rows against
64-row streamed tiles), causal tile skipping and masked ragged tails, so
no VMEM gate is carried over and the block sizes change only the route
that :func:`tpu_rows` names.  The backward is three passes of one call
(delta, dk/dv, dq) with no atomics, so two calls agree bit for bit.

:func:`flash_attention_fwd` and :func:`flash_attention_bwd` are the
wrappers: a CUDA tensor launches the kernel (or raises on what the
kernel does not take), a CPU tensor takes the ``_plain`` version, which
computes the same function with the same rounding points in plain
PyTorch.  Both go through torch custom ops, ``rlt::flash_fwd`` and its
gradient ``rlt::flash_bwd`` (:data:`FWD_OP`, :data:`BWD_OP`), as the
custom VJP ties them in the JAX package.
"""

from __future__ import annotations

import functools
import math
import os

import torch

from ray_lightning_tpu_torch.ops._kernels import Kernel

#: large-negative instead of -inf: keeps exp/log NaN-free
NEG_INF = -1e30
#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)

KERNEL = Kernel("flash_fwd", "flash_fwd.cu", "rlt_flash_fwd",
                "ppppp" + "i" * 14 + "f" + "i" + "p")
_BWD_SIGNATURE = "p" * 10 + "i" * 20 + "f" + "i" + "p"
BWD_KERNEL = Kernel("flash_bwd", "flash_bwd.cu", "rlt_flash_bwd",
                    _BWD_SIGNATURE)
#: each pass of ``flash_bwd`` alone, entry points of the same source and
#: build, taking its arguments: for timing a pass (``chip_smoke.py``);
#: the main path launches ``BWD_KERNEL``, so these count apart
BWD_PASS_KERNELS = {
    name: Kernel(f"flash_bwd_{name}", "flash_bwd.cu",
                 f"rlt_flash_bwd_{name}", _BWD_SIGNATURE)
    for name in ("delta", "dkdv", "dq")}


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


def _check_grid(kernel: str, B: int, T: int, H: int) -> None:
    """Both kernels run a block per (b * h, 128-row block of T): grid x
    is B * H (CUDA caps it at 2**31 - 1), grid y the row blocks (at
    65535)."""
    if B * H >= 2 ** 31 or -(-T // 128) > 65535:
        raise ValueError(f"{kernel} kernel takes B * H < 2**31 and T <= "
                         f"{65535 * 128}, got B={B} T={T} H={H}")


def _pick_block(t: int, preferred: int) -> int:
    """The JAX package's ``_pick_block``: ``preferred`` clamped to ``t``
    and halved until it divides ``t``."""
    b = min(preferred, t)
    while t % b:
        b //= 2
    return max(b, 1)


def _head_pack(d: int, h: int) -> int:
    """The JAX package's ``_head_pack``: heads per 128-lane block (0 =
    the layout does not pack, and the shape folds)."""
    if d <= 128 and 128 % d == 0:
        pack = 128 // d
    elif d % 128 == 0:
        pack = 1
    else:
        return 0
    return pack if h % pack == 0 else 0


def _flag(name: str) -> bool:
    return os.environ.get(name, "1") != "0"


def tpu_rows(T: int, H: int, D: int, causal: bool,
             block_q: "int | None" = None,
             block_k: "int | None" = None) -> "tuple[int, tuple[int, ...]]":
    """The TPU kernel rows (PERF.md's table) that the JAX package's
    ``flash_attention`` runs at this shape: ``(forward row, backward
    rows)``.

    A copy of its gates, in their order: the default blocks (T up to
    1024, else 512; ``RLT_FLASH_BLOCK_Q/K`` or the arguments override,
    clamped to T and halved until they divide it), ``_head_pack``,
    ``_use_tri`` (causal, square blocks, more than one;
    ``RLT_FLASH_TRI=0`` opts out), ``_use_row_resident_fwd`` /
    ``_use_row_resident`` (``RLT_FLASH_ROWRES=0`` opts out), then
    ``_fwd``'s and ``_bwd``'s branches.  The port runs every route on
    ``flash_fwd`` and ``flash_bwd``; this names the one the reference
    takes.  The ``RLT_FLASH_*`` variables are read here only: they change
    the rows named, never what the port's kernels run."""
    if T < 1:
        raise ValueError(f"T must be positive, got {T}")
    blocks = []
    for given, env in ((block_q, "RLT_FLASH_BLOCK_Q"),
                       (block_k, "RLT_FLASH_BLOCK_K")):
        if given is None:
            given = (int(os.environ[env]) if os.environ.get(env)
                     else (T if T <= 1024 else 512))
        blocks.append(_pick_block(T, min(given, T)))
    bq, bk = blocks
    nq, nk = T // bq, T // bk
    single = nq == 1 and nk == 1
    tri = causal and bq == bk and nq > 1 and _flag("RLT_FLASH_TRI")
    pack = _head_pack(D, H)
    if single and pack:
        return 1, (6,)
    if tri and pack:
        w, rowres = pack * D, _flag("RLT_FLASH_ROWRES")
        return (3 if rowres and T * w <= 8192 * 128 else 2,
                (9,) if rowres and T * w <= 2048 * 128 else (7, 8))
    if single:
        return 5, (10,)
    if tri:
        return 4, (11, 12)
    return 5, (15, 16)


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
    """Attention forward over ``[B, T, H, D]``: ``(o, lse)``, through the
    custom op ``rlt::flash_fwd`` (:data:`FWD_OP`).

    A CUDA tensor launches ``csrc/flash_fwd.cu``: bf16 only, head_dim in
    :data:`HEAD_DIMS`, unit stride over D and 16-byte-aligned rows (the
    split views of a fused qkv projection qualify, with no copy: the
    kernel reads them through TMA tensor maps built from these strides
    at each launch).  A CPU tensor takes
    :func:`flash_attention_fwd_plain`.  Differentiable: the op's
    gradient is ``rlt::flash_bwd``.
    """
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[3])
    return FWD_OP(q, k, v, bool(causal), float(sm_scale))


def _flash_fwd_cuda(q, k, v, causal: bool, sm_scale: float):
    """The CUDA implementation of ``rlt::flash_fwd``: one launch."""
    B, T, H, D = q.shape
    _check_kernel_operands("flash_fwd", q=q, k=k, v=v)
    _check_grid("flash_fwd", B, T, H)
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


def _bwd_check(q, k, v, o, lse, do, sm_scale) -> float:
    """The backward's shape checks; returns ``sm_scale`` or its
    default."""
    _check(q, k, v)
    B, T, H, D = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, T):
        raise ValueError(
            f"o and do must be {tuple(q.shape)} and lse {(B, H, T)}, got "
            f"{tuple(o.shape)}, {tuple(do.shape)}, {tuple(lse.shape)}")
    return 1.0 / math.sqrt(D) if sm_scale is None else sm_scale


def _bwd_kernel_args(q, k, v, o, lse, do, causal, sm_scale):
    """The checked arguments of a ``flash_bwd`` entry point (``None`` for
    an empty shape), the fp32 delta scratch they point at, and the
    outputs ``(dq, dk, dv)`` they fill."""
    B, T, H, D = q.shape
    _check_kernel_operands("flash_bwd", q=q, k=k, v=v, o=o, do=do)
    _check_grid("flash_bwd", B, T, H)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError("flash_bwd kernel takes a contiguous fp32 lse")
    grads = tuple(torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    if T == 0 or B == 0:
        return None, None, grads
    delta = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    strides = [st for x in (q, k, v, o, do) for st in x.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(g.data_ptr() for g in grads), B, T, H, D, *strides,
            int(bool(causal)), float(sm_scale), q.device.index or 0, stream)
    return args, delta, grads


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        sm_scale: "float | None" = None):
    """Attention backward over ``[B, T, H, D]``: ``(dq, dk, dv)`` from the
    forward's ``o`` and fp32 ``lse`` [B, H, T] and the output gradient
    ``do``, through the custom op ``rlt::flash_bwd`` (:data:`BWD_OP`).

    A CUDA tensor launches ``csrc/flash_bwd.cu`` (one launch: its delta,
    dk/dv and dq passes), on the same terms as the forward: bf16, head_dim
    in :data:`HEAD_DIMS`, unit stride over D and 16-byte-aligned rows for
    q, k, v, o and do.  A CPU tensor takes
    :func:`flash_attention_bwd_plain`.
    """
    sm_scale = _bwd_check(q, k, v, o, lse, do, sm_scale)
    return BWD_OP(q, k, v, o, lse, do, bool(causal), float(sm_scale))


def _flash_bwd_cuda(q, k, v, o, lse, do, causal: bool, sm_scale: float):
    """The CUDA implementation of ``rlt::flash_bwd``: one launch."""
    args, _delta, grads = _bwd_kernel_args(q, k, v, o, lse, do, causal,
                                           sm_scale)
    if args is not None:
        BWD_KERNEL.launch(*args)
    return grads


def flash_attention_bwd_passes(q, k, v, o, lse, do, *, causal: bool = True,
                               sm_scale: "float | None" = None):
    """The passes of :func:`flash_attention_bwd`'s kernel one by one, for
    timing each: ``({"delta": fn, "dkdv": fn, "dq": fn}, (dq, dk, dv))``,
    each ``fn()`` launching its pass alone (counted on
    :data:`BWD_PASS_KERNELS`, not on :data:`BWD_KERNEL`) on the shared
    scratch and outputs; called in that order they compute what one
    :func:`flash_attention_bwd` call does.  CUDA tensors only: the plain
    version has no passes."""
    sm_scale = _bwd_check(q, k, v, o, lse, do, sm_scale)
    if q.device.type != "cuda":
        raise ValueError("flash_attention_bwd_passes launches the kernel's "
                         f"passes: CUDA tensors only, got {q.device}")
    args, delta, grads = _bwd_kernel_args(q, k, v, o, lse, do, causal,
                                          sm_scale)

    def run(kern, delta=delta):   # delta: the scratch the args point at
        if args is not None:
            kern.launch(*args)

    return {name: functools.partial(run, kern)
            for name, kern in BWD_PASS_KERNELS.items()}, grads


# -- the kernels as torch custom ops ------------------------------------------
#
# Registered with the dispatcher, so a selective-checkpoint policy
# (core/remat.py), fake tensors and CUDA graph captures all see them as
# ops: ``rlt::flash_fwd`` (CUDA: the kernel; CPU: the plain version; meta
# and fake tensors: shapes only) with ``rlt::flash_bwd`` as its
# gradient, as the custom VJP ties the Pallas kernels in the JAX package.
# q, k, v may be the split views of one fused projection: autograd sums
# their gradients into its gradient.  Under a remat checkpoint the
# forward runs again in the backward pass; the kernels use no atomics,
# so the recompute gives the same ``o`` and ``lse`` bit for bit.


@torch.library.custom_op("rlt::flash_fwd", mutates_args=(),
                         device_types="cuda")
def FWD_OP(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           sm_scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    return _flash_fwd_cuda(q, k, v, causal, sm_scale)


@FWD_OP.register_kernel("cpu")
def _(q, k, v, causal, sm_scale):
    return flash_attention_fwd_plain(q, k, v, causal=causal,
                                     sm_scale=sm_scale)


@FWD_OP.register_fake
def _(q, k, v, causal, sm_scale):
    B, T, H, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((B, H, T), dtype=torch.float32))


@torch.library.custom_op("rlt::flash_bwd", mutates_args=(),
                         device_types="cuda")
def BWD_OP(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
           causal: bool, sm_scale: float
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _flash_bwd_cuda(q, k, v, o, lse, do, causal, sm_scale)


@BWD_OP.register_kernel("cpu")
def _(q, k, v, o, lse, do, causal, sm_scale):
    return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                     sm_scale=sm_scale)


@BWD_OP.register_fake
def _(q, k, v, o, lse, do, causal, sm_scale):
    return (q.new_empty(q.shape), k.new_empty(k.shape),
            v.new_empty(v.shape))


def _fwd_setup(ctx, inputs, output):
    q, k, v, causal, sm_scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.sm_scale = causal, sm_scale


def _fwd_backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = BWD_OP(q, k, v, o, lse, do.contiguous(), ctx.causal,
                        ctx.sm_scale)
    return dq, dk, dv, None, None


FWD_OP.register_autograd(_fwd_backward, setup_context=_fwd_setup)


def flash_attention(q, k, v, *, causal: bool = True,
                    dtype: torch.dtype = torch.bfloat16,
                    sm_scale: "float | None" = None):
    """Flash attention over ``[B, T, H, D]`` (BTHD in, BTHD out): the
    drop-in for :func:`~ray_lightning_tpu_torch.ops.attention.
    dot_product_attention`, as in the JAX package, differentiable through
    ``rlt::flash_fwd``'s gradient.  The JAX signature's ``block_q``/
    ``block_k`` are not taken: the port's kernels tile the same rows for
    every shape, and the blocks only pick the reference's route
    (:func:`tpu_rows`)."""
    o, _ = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
    return o.to(dtype)


__all__ = ["BWD_KERNEL", "BWD_OP", "BWD_PASS_KERNELS", "FWD_OP",
           "HEAD_DIMS", "KERNEL", "NEG_INF", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_passes",
           "flash_attention_bwd_plain", "flash_attention_fwd",
           "flash_attention_fwd_plain", "tpu_rows"]
