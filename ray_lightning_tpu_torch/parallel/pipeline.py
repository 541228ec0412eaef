"""Pipeline parallelism: GPipe microbatching over a ``stage`` mesh axis.

Counterpart of ``ray_lightning_tpu/parallel/pipeline.py``
(``pipeline_forward``, ``PipelineStrategy``).  There the schedule is one
``lax.scan`` over time steps inside a ``shard_map``; here each rank of a
stage group runs its stage of it, and :class:`_Pipeline` is one
``torch.autograd.Function`` whose forward and backward each follow the
schedule step by step, so every rank's exchanges come in an order the
code fixes:

- forward, ``M + S - 1`` time steps (``M`` microbatches of the rank's
  batch, ``S`` stages): at step ``t`` stage ``s`` runs its layers on
  microbatch ``t - s`` (stage 0 feeds it from the batch, the others take
  what the stage before sent), then every rank sends its output one
  stage on and receives from the one before (``parallel/mesh.py``
  ``ppermute``, once a step even in a bubble, where nothing is computed
  and zeros are sent); the last stage keeps its outputs.  Each
  microbatch's graph is kept for the backward (GPipe's memory);
- the last stage's outputs are all-reduced over the stage group, the
  others contributing zeros: every stage holds them, and the head and
  loss downstream run replicated.  The all-reduce's backward is the
  identity: the last stage takes the gradient once;
- backward, the time steps in reverse: stage ``s`` runs the backward of
  microbatch ``t - s`` from the gradient of its output (the last stage:
  the gradient of the outputs; the others: what the next stage sent the
  step before) and sends the gradient of its input one stage back.  The
  parameters' gradients are summed over the microbatches in fp32.  The
  gradient of the fed batch (stage 0's; the other stages' are zero) is
  all-reduced over the stage group, as JAX transposes the stage-
  replicated input of its ``shard_map``: under a tied embedding (models/
  pipeline_gpt.py) every stage then holds the embedding's gradient.

Without a stage axis (or at size 1) :func:`pipeline_forward` is a plain
loop over the layers.  A stage mesh never runs the layers sequentially.
"""

from __future__ import annotations

import re
from typing import Callable, Mapping, Sequence

import torch

from ray_lightning_tpu_torch.parallel.mesh import (all_reduce, axis_group,
                                                   ppermute)
from ray_lightning_tpu_torch.parallel.strategy import P, SpmdStrategy


def _run_layers(stage_fn: Callable, names: Sequence[str],
                params: Sequence[torch.Tensor], h: torch.Tensor
                ) -> torch.Tensor:
    """``stage_fn`` once per leading-dim slice of the stacked params, in
    order (the JAX ``_scan_layers``)."""
    for j in range(params[0].shape[0]):
        h = stage_fn({n: p[j] for n, p in zip(names, params)}, h)
    return h


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule of one stage (module docstring)."""

    @staticmethod
    def forward(ctx, stage_fn, names, g, n_micro, x, *params):
        S, s, M = g.size, g.rank, n_micro
        needs = any(ctx.needs_input_grad[4:])
        leaves = [p.detach().requires_grad_(p.requires_grad)
                  for p in params]
        mb = x.shape[0] // M
        xs = x.detach().reshape((M, mb) + tuple(x.shape[1:]))
        zero = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        saved = {}
        recv = zero
        for t in range(M + S - 1):
            j = t - s
            send = zero
            if 0 <= j < M:
                inp = (xs[j] if s == 0 else recv).detach()
                if needs:
                    inp.requires_grad_()
                with torch.set_grad_enabled(needs):
                    out = _run_layers(stage_fn, names, leaves, inp)
                if needs:
                    saved[j] = (inp, out)
                send = out.detach()
                if s == S - 1:
                    outs[j] = send
            recv = ppermute(send, g, 1)
        ctx.g, ctx.n_micro, ctx.saved, ctx.leaves = g, M, saved, leaves
        if s != S - 1:
            outs = torch.zeros_like(outs)
        return all_reduce(outs, g.group).reshape(x.shape)

    @staticmethod
    def backward(ctx, grad):
        g, M, saved, leaves = ctx.g, ctx.n_micro, ctx.saved, ctx.leaves
        S, s = g.size, g.rank
        want = [p for p in leaves if p.requires_grad]
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in want]
        gouts = grad.reshape((M, -1) + tuple(grad.shape[1:]))
        zero = torch.zeros_like(gouts[0])
        gx = torch.zeros_like(gouts)
        g_next = zero
        for t in reversed(range(M + S - 1)):
            j = t - s
            send = zero
            if 0 <= j < M:
                inp, out = saved.pop(j)
                gout = gouts[j] if s == S - 1 else g_next
                got = torch.autograd.grad(out, [inp] + want, gout,
                                          allow_unused=True)
                for a, d in zip(acc, got[1:]):
                    if d is not None:
                        a.add_(d.float())
                if s == 0:
                    gx[j] = got[0]
                else:
                    send = got[0]
            g_next = ppermute(send, g, -1)
        ctx.saved = None
        gx = all_reduce(gx, g.group).reshape(grad.shape)
        it = iter(acc)
        pgrads = [next(it).to(p.dtype) if p.requires_grad else None
                  for p in leaves]
        return (None, None, None, None, gx, *pgrads)


def _stage_slice(p: torch.Tensor, S: int, s: int) -> "tuple[torch.Tensor, int]":
    """``(this stage's layers of p, the number of layers)``: a parameter
    the sharded layout cut (parallel/layout.py) is this stage's layers
    already; a whole stack is sliced here."""
    info = getattr(p, "_rlt_shard", None)
    if info is not None:
        return p, int(info.shape[0])
    n = int(p.shape[0])
    if n % S:
        return p, n
    return p.narrow(0, s * (n // S), n // S), n


def pipeline_forward(stage_fn: Callable[[dict, torch.Tensor], torch.Tensor],
                     stacked_params: "Mapping[str, torch.Tensor]",
                     x: torch.Tensor, *, n_microbatches: int = 4,
                     axis_name: str = "stage", mesh=None) -> torch.Tensor:
    """Apply ``n_layer`` layers to ``x`` (this rank's batch), pipelined
    over ``axis_name`` of ``mesh`` (default: the current mesh).

    ``stage_fn(layer_params, h) -> h`` applies ONE layer; every tensor of
    ``stacked_params`` has a leading layer dim: this stage's layers when
    the sharded layout cut it (``PipelineStrategy``), else the whole
    stack, of which the stage takes its slice.  Without a stage axis (or
    at size 1) it is a plain loop over the layers.  Raises
    ``ValueError`` when the layers do not divide over the stages or the
    microbatches do not divide the batch."""
    names = list(stacked_params)
    g = axis_group(axis_name, mesh)
    if g is None:
        return _run_layers(stage_fn, names,
                           [stacked_params[n] for n in names], x)
    params, layers = [], set()
    for n in names:
        p, total = _stage_slice(stacked_params[n], g.size, g.rank)
        params.append(p)
        layers.add(total)
    (n_layers,) = layers
    if n_layers % g.size:
        raise ValueError(f"{n_layers} layers do not divide over {g.size} "
                         f"pipeline stages")
    b_loc, rem = divmod(x.shape[0], n_microbatches)
    if rem or b_loc == 0:
        raise ValueError(f"per-data-shard batch {x.shape[0]} does not "
                         f"divide into {n_microbatches} microbatches")
    return _Pipeline.apply(stage_fn, names, g, n_microbatches, x, *params)


class PipelineStrategy(SpmdStrategy):
    """Sharding strategy of pipelined models (the JAX class): parameters
    whose flax path matches ``stage_param_regex`` (the layer-stacked
    blocks) split their leading layer dim on ``stage``, and so do their
    optimizer moments; everything else follows the ``SpmdStrategy``
    rules.  A rank holds its stage's layers and uses them as they are
    (parallel/layout.py); the batch is split on ``data``."""

    name = "pipeline"

    def __init__(self, stages: int,
                 stage_param_regex: str = r"(^|/)blocks/",
                 rules: Sequence = (),
                 axis_names: Sequence[str] = ("data", "stage"),
                 axis_sizes=None, **kw):
        sizes = dict(axis_sizes or {})
        sizes.setdefault("stage", stages)
        super().__init__(rules=rules, axis_names=axis_names,
                         axis_sizes=sizes, **kw)
        self.stages = stages
        self._stage_rx = re.compile(stage_param_regex)

    def _stage_spec(self, path: str) -> "P | None":
        if self._stage_rx.search(path):
            return P("stage")
        return None

    def param_spec(self, mesh, path: str, shape: Sequence[int]) -> P:
        spec = self._stage_spec(path)
        if spec is not None:
            return spec
        return super().param_spec(mesh, path, shape)

    def opt_spec(self, mesh, path: str, shape: Sequence[int]) -> P:
        spec = self._stage_spec(path)
        if spec is not None and len(shape) >= 1:
            return spec
        return super().opt_spec(mesh, path, shape)

    def __repr__(self):
        return f"PipelineStrategy({self.stages}, {self._axis_sizes})"


__all__ = ["PipelineStrategy", "pipeline_forward"]
