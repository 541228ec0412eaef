"""Tensor parallelism inside the models: the collectives GSPMD inserts
for the JAX package's ``gpt_partition_rules`` / ``bert_partition_rules``,
issued here by the model itself when the mesh's ``tensor`` axis is over
1 (Megatron's layout).

- :func:`copy_to` (Megatron's *f*): the identity forward, the gradient
  summed over the tensor group in the backward; it sits at the input of
  every column-parallel product, so the replicated activations upstream
  get the whole gradient;
- :func:`reduce_from` (*g*): the sum over the tensor group forward, the
  identity backward: the vocab-parallel lookup and loss;
- :func:`column_parallel` (``qkv``, ``fc``, the MLM head) and
  :func:`row_parallel` (``proj``, ``out``): the products whose sum over
  the group crosses a rank, *f* and *g* fused with them so the partial
  products are summed in fp32 (a bf16 product whose partial sums are
  each rounded to bf16 first drifts from the unsharded one by a few
  percent where they cancel, as in a LayerNorm's gradient): the
  row-parallel output is summed in fp32, then the bias added and the
  sum rounded once, as the unsharded product's epilogue rounds it; the
  column-parallel input gradient likewise;
- :func:`slice_of`: a replicated parameter's piece that this rank's
  columns use (the ``qkv`` and ``fc`` biases: the JAX rules shard only
  their kernels), its gradient put back in place and summed over the
  group, so every rank updates the whole bias alike;
- :func:`gather_from`: the pieces joined along a dim (the vocab-parallel
  logits, for a forward that returns them whole), the backward this
  rank's piece of the gradient;
- :func:`vocab_embed`: the vocab-parallel lookup: ids outside this
  rank's rows read zeros, and the rows are summed over the group.

Every rank of a tensor group holds the same batch and the same
replicated activations, so each computes the same loss; the data-axis
gradient sync then runs over the batch group only (parallel/layout.py).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ray_lightning_tpu_torch.parallel.mesh import all_gather_along, all_reduce


@dataclasses.dataclass(frozen=True, eq=False)
class TensorGroup:
    """This rank's group along one mesh axis (``tensor``; ``expert`` for
    the routed layers' expert parallelism, ``sequence`` for ring
    attention): ``size`` ranks, this one at ``rank`` (its coordinate on
    the axis); ``members`` their global ranks in axis order."""

    group: object
    size: int
    rank: int
    members: tuple = ()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.tp.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce(x.contiguous(), tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce(x.contiguous(), tp.group) / tp.size

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SliceOf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, tp, view, dim):
        ctx.tp, ctx.view, ctx.dim, ctx.shape = tp, view, dim, p.shape
        n = view[dim] // tp.size
        return p.reshape(view).narrow(dim, tp.rank * n, n).reshape(-1)

    @staticmethod
    def backward(ctx, g):
        tp, view, dim = ctx.tp, ctx.view, ctx.dim
        n = view[dim] // tp.size
        full = g.new_zeros(view)
        full.narrow(dim, tp.rank * n, n).copy_(g.reshape(
            view[:dim] + (n,) + view[dim + 1:]))
        return all_reduce(full, tp.group).reshape(ctx.shape), None, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return all_gather_along(x, dim, tp.group)

    @staticmethod
    def backward(ctx, g):
        tp, dim = ctx.tp, ctx.dim
        n = g.shape[dim] // tp.size
        return g.narrow(dim, tp.rank * n, n).contiguous(), None, None


def mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (``a`` [..., K], ``b`` [K, N]) in fp32 from operands of
    any float dtype: on the card a bf16 product accumulates and returns
    fp32 (``torch.mm(..., out_dtype=float32)``); elsewhere the operands
    are upcast."""
    a2 = a.reshape(-1, a.shape[-1])
    if a.is_cuda and a.dtype == b.dtype and a.dtype in (torch.bfloat16,
                                                         torch.float16):
        out = torch.mm(a2, b, out_dtype=torch.float32)
    else:
        out = a2.float() @ b.float()
    return out.reshape(*a.shape[:-1], b.shape[-1])


class _ColumnParallel(torch.autograd.Function):
    """``x @ w.T + b`` on this rank's output rows of ``w``; the input's
    gradient summed over the group in fp32, rounded once."""

    @staticmethod
    def forward(ctx, x, w, b, tp):
        ctx.tp = tp
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return F.linear(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = all_reduce(mm32(g, w), ctx.tp.group).to(x.dtype)
        g2 = g.reshape(-1, g.shape[-1])
        dw = g2.t() @ x.reshape(-1, x.shape[-1])
        db = g2.sum(0) if ctx.has_bias else None
        return dx, dw, db, None


class _RowParallel(torch.autograd.Function):
    """``x @ w.T`` on this rank's input columns, summed over the group in
    fp32 (returned in fp32); the backward is the local one."""

    @staticmethod
    def forward(ctx, x, w, tp):
        ctx.save_for_backward(x, w)
        return all_reduce(mm32(x, w.t()), tp.group)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        g2 = g.reshape(-1, g.shape[-1])
        return g @ w, g2.t() @ x.reshape(-1, x.shape[-1]), None


def column_parallel(x, w, b, tp: "TensorGroup | None"):
    """``F.linear(x, w, b)``; under ``tp`` a column-parallel product
    (``w`` and ``b`` this rank's output rows)."""
    if tp is None:
        return F.linear(x, w, b)
    return _ColumnParallel.apply(x, w, b, tp)


def row_parallel(x, w, b, tp: "TensorGroup | None"):
    """``F.linear(x, w, b)``; under ``tp`` a row-parallel product (``x``
    and ``w``'s columns this rank's piece): the fp32 sum over the group
    plus ``b``, rounded once to ``x``'s dtype."""
    if tp is None:
        return F.linear(x, w, b)
    y = _RowParallel.apply(x, w, tp)
    return (y + b.float() if b is not None else y).to(x.dtype)


def copy_to(x: torch.Tensor, tp: "TensorGroup | None") -> torch.Tensor:
    return x if tp is None else _CopyTo.apply(x, tp)


def reduce_from(x: torch.Tensor, tp: "TensorGroup | None") -> torch.Tensor:
    return x if tp is None else _ReduceFrom.apply(x, tp)


def mean_from(x: torch.Tensor, g: "TensorGroup | None") -> torch.Tensor:
    """The mean over the group forward, the identity backward: a
    sequence-parallel rank's loss over its slice becomes the whole
    sequence's mean (the slices are the same size), while each rank's
    gradient stays its own slice's, which the gradient sync then
    averages over the sequence ranks (parallel/layout.py)."""
    return x if g is None else _MeanFrom.apply(x, g)


def slice_of(p: torch.Tensor, tp: "TensorGroup | None", view: tuple,
             dim: int) -> torch.Tensor:
    """This rank's 1/size of the 1-d ``p`` seen as ``view`` along
    ``dim``, flat: a ``qkv`` bias [3C] seen as [3, C] along dim 1 gives
    this rank's heads of q, k and v."""
    return p if tp is None else _SliceOf.apply(p, tp, tuple(view), dim)


def gather_from(x: torch.Tensor, tp: "TensorGroup | None",
                dim: int = -1) -> torch.Tensor:
    return x if tp is None else _GatherFrom.apply(x, tp, dim % x.dim())


def vocab_embed(table: torch.Tensor, idx: torch.Tensor, dtype: torch.dtype,
                tp: "TensorGroup | None") -> torch.Tensor:
    """``table[idx]`` cast to ``dtype``; under tensor parallelism
    ``table`` is this rank's rows of the vocab, the rows another rank
    holds read zeros here and the sum over the group fills them (one
    term is nonzero: exact)."""
    if tp is None:
        return table[idx.long()].to(dtype)
    rows = table.shape[0]
    local = idx.long() - tp.rank * rows
    inside = (local >= 0) & (local < rows)
    got = table[local.clamp(0, rows - 1)].to(dtype)
    return reduce_from(torch.where(inside[..., None], got,
                                   torch.zeros((), dtype=dtype,
                                               device=got.device)), tp)


def vocab_max(x: torch.Tensor, tp: "TensorGroup | None") -> torch.Tensor:
    """The max over the last dim of the whole vocab, without gradient."""
    with torch.no_grad():
        m = x.amax(dim=-1)
        return m if tp is None else all_reduce(m, tp.group,
                                               dist.ReduceOp.MAX)


def target_logit(logits: torch.Tensor, targets: torch.Tensor,
                 tp: "TensorGroup | None") -> torch.Tensor:
    """``logits[..., targets]`` as fp32, ``logits`` this rank's vocab
    slice under tensor parallelism (the other ranks' targets read 0
    here, the sum over the group fills them)."""
    t = targets.long()
    if tp is None:
        return logits.gather(-1, t[..., None])[..., 0].float()
    cols = logits.shape[-1]
    local = t - tp.rank * cols
    inside = (local >= 0) & (local < cols)
    got = logits.gather(-1, local.clamp(0, cols - 1)[..., None])[..., 0]
    return reduce_from(torch.where(inside, got.float(),
                                   torch.zeros((), device=got.device)), tp)


__all__ = ["TensorGroup", "column_parallel", "copy_to", "gather_from",
           "mean_from", "mm32", "reduce_from", "row_parallel", "slice_of",
           "target_logit", "vocab_embed", "vocab_max"]
