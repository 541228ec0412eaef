"""Ring attention: sequence parallelism over the mesh's ``sequence`` axis.

Counterpart of ``ray_lightning_tpu/parallel/ring.py``
(``_block_update``, ``blockwise_attention``, ``_ring_inner``,
``ring_attention``), with its math: q, k and v in fp32, scores masked
at ``NEG_INF = -1e30``, an online softmax over K/V blocks, the causal
offsets ``q_off = idx * Tq`` and ``k_off = src * Tk`` of the block that
started at ``src = (idx - i) mod ring``, the output ``acc / l`` cast to
``dtype``.  The JAX block math is ``jnp.einsum`` (no Pallas kernel), so
here it is plain torch products.

Each rank of the ``sequence`` group holds its ``T / ring`` slice of q, k
and v (``[B, T_local, H, D]``; under tensor parallelism its heads).
:class:`_Ring` is one ``torch.autograd.Function`` whose forward rotates
K/V around the ring (``parallel/mesh.py`` ``ppermute``, one hop a
step) and folds each block into the accumulators, and whose backward is
an explicit ring too: it recomputes each block's probabilities from the
saved row statistics (``lse = m + log l``), as ``jax.checkpoint``
recomputes each block, and rotates the dK/dV accumulators with their
K/V blocks, so they come home after ``ring`` hops.  Every rank issues
the same exchanges in an order the code fixes, not the autograd
engine's scheduling.  A block that causality masks whole (it starts
past every query of this rank) is not computed: its update changes no
accumulator bit, so the result equals the JAX loop's, which computes
it; its K/V still make their hop.

Without a ``sequence`` axis (or at size 1) ring attention is
:func:`blockwise_attention` on the rank's whole sequence, as in the JAX
package.  A sequence group never runs blockwise.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from ray_lightning_tpu_torch.parallel.mesh import axis_group, ppermute

NEG_INF = -1e30


def _mask(s: torch.Tensor, q_off: int, k_off: int) -> torch.Tensor:
    tq, tk = s.shape[-2], s.shape[-1]
    rows = q_off + torch.arange(tq, device=s.device)[:, None]
    cols = k_off + torch.arange(tk, device=s.device)[None, :]
    return s.masked_fill(rows < cols, NEG_INF)


def _block_update(carry, q, k_blk, v_blk, q_off, k_off, causal, scale):
    """Fold one K/V block into the online-softmax accumulators (the JAX
    function).  ``q`` [B, Tq, H, D]; ``k_blk`` / ``v_blk`` [B, Tk, H,
    D]; ``carry = (m, l, acc)`` with m, l [B, H, Tq, 1], acc [B, Tq, H,
    D], all fp32."""
    m, l, acc = carry
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk) * scale
    if causal:
        s = _mask(s, q_off, k_off)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l_new = alpha * l + p.sum(-1, keepdim=True)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v_blk)
    return m_new, l_new, acc * alpha.permute(0, 2, 1, 3) + pv


def _init_carry(q: torch.Tensor):
    b, t, h, _ = q.shape
    return (q.new_full((b, h, t, 1), NEG_INF), q.new_zeros((b, h, t, 1)),
            torch.zeros_like(q))


def blockwise_attention(q, k, v, *, causal: bool = True,
                        dtype: torch.dtype = torch.bfloat16,
                        sm_scale: "float | None" = None,
                        block_size: int = 512):
    """One rank's blockwise attention (the ring's size-1 case): K/V in
    blocks of ``block_size``, the online softmax, each block's update
    recomputed in the backward pass (``jax.checkpoint``'s role), no
    [T, T] scores."""
    b, t, h, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qf = q.float()
    nblk = max(1, t // max(1, min(block_size, t)))
    tk = t // nblk
    carry = _init_carry(qf)
    step = functools.partial(_block_update, causal=causal, scale=scale)
    for i in range(nblk):
        kb = k[:, i * tk:(i + 1) * tk].float()
        vb = v[:, i * tk:(i + 1) * tk].float()
        if torch.is_grad_enabled():
            carry = checkpoint(step, carry, qf, kb, vb, 0, i * tk,
                               use_reentrant=False)
        else:
            carry = step(carry, qf, kb, vb, 0, i * tk)
    m, l, acc = carry
    return (acc / l.permute(0, 2, 1, 3)).to(dtype)


def _skipped(causal: bool, idx: int, src: int, tq: int, tk: int) -> bool:
    """The block from ``src`` is masked whole for this rank's queries."""
    return causal and src * tk > idx * tq + tq - 1


class _Ring(torch.autograd.Function):
    """Ring attention over the sequence group ``g`` (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, g, causal, scale, dtype):
        n, idx = g.size, g.rank
        tq, tk = q.shape[1], k.shape[1]
        qf = q.float()
        kv = torch.stack([k.float(), v.float()])
        carry = _init_carry(qf)
        for i in range(n):
            src = (idx - i) % n
            if not _skipped(causal, idx, src, tq, tk):
                carry = _block_update(carry, qf, kv[0], kv[1], idx * tq,
                                      src * tk, causal, scale)
            if i < n - 1:
                kv = ppermute(kv, g)
        m, l, acc = carry
        out = acc / l.permute(0, 2, 1, 3)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.g, ctx.causal, ctx.scale = g, causal, scale
        return out.to(dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        g, causal, scale = ctx.g, ctx.causal, ctx.scale
        n, idx = g.size, g.rank
        tq, tk = q.shape[1], k.shape[1]
        qf, dof = q.float(), do.float()
        delta = (dof * out).sum(-1).permute(0, 2, 1)[..., None]
        dq = torch.zeros_like(qf)
        # K, V and their gradient accumulators ride the ring together
        kf = k.float()
        blk = torch.stack([kf, v.float(), torch.zeros_like(kf),
                           torch.zeros_like(kf)])
        for i in range(n):
            src = (idx - i) % n
            if not _skipped(causal, idx, src, tq, tk):
                kb, vb = blk[0], blk[1]
                s = torch.einsum("bqhd,bkhd->bhqk", qf, kb) * scale
                if causal:
                    s = _mask(s, idx * tq, src * tk)
                p = torch.exp(s - lse)
                blk[3] += torch.einsum("bhqk,bqhd->bkhd", p, dof)
                ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vb) - delta)
                dq += torch.einsum("bhqk,bkhd->bqhd", ds, kb) * scale
                blk[2] += torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
            if i < n - 1:
                blk = ppermute(blk, g)
        # the blocks held now started one rank on: one more hop home
        dkv = ppermute(blk[2:], g)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None)


def ring_attention(q, k, v, *, causal: bool = True,
                   dtype: torch.dtype = torch.bfloat16,
                   sm_scale: "float | None" = None,
                   axis_name: str = "sequence", mesh=None, group=None):
    """Sequence-parallel attention over this rank's ``[B, T_local, H,
    D]`` slice of q, k and v, over ``group`` (a ``parallel.tensor.
    TensorGroup``: the model's, which the sharded layout sets) or else
    along ``axis_name`` of ``mesh`` (default: the mesh the trainer
    publishes, parallel/mesh.py ``set_current_mesh``);
    :func:`blockwise_attention` when there is no such group."""
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    g = group if group is not None else axis_group(axis_name, mesh)
    if g is None:
        return blockwise_attention(q, k, v, causal=causal, dtype=dtype,
                                   sm_scale=scale)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ring attention takes q, k, v of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    return _Ring.apply(q, k, v, g, causal, scale, dtype)


__all__ = ["NEG_INF", "blockwise_attention", "ring_attention"]
