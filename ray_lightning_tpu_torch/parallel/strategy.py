"""Data-parallel strategies over ``torch.distributed``: DDP and ZeRO-1.

Counterpart of ``ray_lightning_tpu/parallel/strategy.py``'s
``DataParallelStrategy`` and ``Zero1Strategy``.  There a strategy is a
set of sharding annotations from which XLA compiles the gradient psum,
reduce-scatter and all-gather into the step.  Here a strategy says how
one eager step syncs its gradients and where the optimizer state lives,
and issues the collectives itself on the default process group (NCCL on
the card, gloo on the CPU), which the plugins (plugins/ray_ddp.py) set
up in each worker.  Without a process group (a local ``Trainer``) the
world is one rank and no collective runs.

- :class:`DataParallelStrategy` (``"ddp"``, ``"dp"``): every rank holds
  the params and the optimizer state; after the backward the gradients
  are laid into one fp32 buffer, summed over the ranks, divided by the
  world size and cast back to their dtypes (:func:`average_grads`), then
  every rank runs the same update.  ``DistributedDataParallel`` does not
  fit: its reducer hooks ``.grad`` accumulation, which the functional
  step (``torch.autograd.grad``) does not use.
- :class:`Zero1Strategy` (``"zero1"``, ``"sharded"``): every rank holds
  the params and 1/W of one flat, padded fp32 master and of the AdamW
  moments (:class:`Zero1Optimizer`): the gradients are reduce-scattered
  (summed, then divided by W), the rank updates its shard, and the
  updated shards are all-gathered into the resident params.  AdamW is
  elementwise, so without clipping ZeRO-1 equals DDP bit for bit.

Under either strategy a training BatchNorm (models/resnet.py) takes its
moments over the global batch, as the JAX step's BatchNorm does over
the batch it shards (:func:`batch_moments`): the per-channel sums are
all-reduced in the forward and their gradients in the backward, so the
running statistics stay equal on every rank.

With ``Trainer(steps_per_execution=k)`` on the card every collective
of the step (the gradient sync, ZeRO-1's reduce-scatter and all-gather,
the moments, :func:`mean_over_ranks` of the metrics) is captured into
the chunk's CUDA graph and replays with it (core/steps.py
``ChunkRunner``).  Each rank's stacked ``[k, B, ...]`` chunk and its
rows of the device-resident train set live on its own card; the set's
per-epoch repack in the loader's order is one all-to-all
(:func:`exchange_rows`).

Beyond data parallelism (parallel/layout.py, parallel/tensor.py):

- :class:`FullyShardedStrategy` (``"fsdp"``, ``"zero3"``): each rank
  holds 1/W of every parameter the JAX ``param_spec`` shards on
  ``data`` and of its optimizer state; a use site all-gathers it and
  the backward reduce-scatters its gradient.  Without a clip it equals
  DDP bit for bit.
- :class:`SpmdStrategy` (``"spmd"``): a mesh of ``data``, ``fsdp``,
  ``expert``, ``sequence`` and ``tensor`` axes and regex rules over the
  flax parameter paths (``gpt_partition_rules``,
  ``bert_partition_rules``): ``fsdp`` pieces are gathered at use as
  under FSDP, ``tensor`` pieces are computed on by the model (Megatron's
  column- and row-parallel products, the vocab-parallel embedding and
  loss), ``expert`` pieces are each rank's experts (ops/moe.py), the
  batch is split over ``data`` and ``fsdp`` and, with
  ``shard_sequence_dim``, its dim 1 over ``sequence`` (ring attention,
  parallel/ring.py; the gradients then averaged over data x sequence);
- :class:`~ray_lightning_tpu_torch.parallel.pipeline.PipelineStrategy`
  (parallel/pipeline.py): the layer-stacked blocks on ``stage``.

Each strategy answers the JAX package's ``param_spec`` / ``opt_spec`` /
``batch_spec`` as tuples equal to JAX's (:class:`PartitionSpec`), for
the flax path of a port parameter (``convert.flax_path``).  ``"auto"``
and ``"mpmd"`` raise ``NotImplementedError`` naming their ROADMAP.md
item; other names raise ``ValueError``, as in the JAX package.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ray_lightning_tpu_torch.ops.optim import (SGD, AdamW, EmptyState,
                                               add_decayed_weights, chain,
                                               clip_by_global_norm,
                                               fp32_master)


def group_active() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    return dist.get_world_size() if group_active() else 1


def global_rank() -> int:
    """This process's rank in the default process group (0 without
    one)."""
    return dist.get_rank() if group_active() else 0


def mean_over_ranks(values: "list[torch.Tensor]") -> "list[torch.Tensor]":
    """Each 0-d tensor's mean over the ranks: summed in fp32, divided by
    the world size, cast back to its dtype (at one rank the values come
    back unchanged).  Without a process group, ``values`` itself."""
    if not group_active() or not values:
        return values
    buf = torch.stack([v.detach().float().reshape(()) for v in values])
    dist.all_reduce(buf)
    buf.div_(dist.get_world_size())
    return [b.to(v.dtype) for b, v in zip(buf, values)]


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, into a new tensor (``t`` without a
    process group)."""
    if not group_active():
        return t
    t = t.clone()
    dist.all_reduce(t)
    return t


class _SumOverRanks(torch.autograd.Function):
    """``all_reduce`` (sum) whose backward sums the gradient over the
    ranks too: every rank's loss depends on every rank's share of the
    sum."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def batch_moments(x: torch.Tensor, dims: "tuple[int, ...]"
                  ) -> "tuple[torch.Tensor, torch.Tensor]":
    """``E[x]`` and ``E[x^2]`` over ``dims`` of the global batch, in fp32
    whatever ``x``'s dtype (flax's ``_compute_stats``).  Over more than
    one rank, each rank's ``[sum x, sum x^2, n]`` is summed over the
    ranks in one differentiable all-reduce; at one rank (or without a
    process group) they are the local means."""
    x = x.float()
    if world_size() == 1:
        return x.mean(dims), (x * x).mean(dims)
    n = x.numel() // math.prod(x.shape[d] for d in range(x.dim())
                               if d not in dims)
    s1 = x.sum(dims)
    sums = _SumOverRanks.apply(torch.stack(
        [s1, (x * x).sum(dims), torch.full_like(s1, float(n))]))
    return sums[0] / sums[2], sums[1] / sums[2]


def gather_objects(obj) -> list:
    """``obj`` of every rank, in rank order (``[obj]`` without a process
    group); pickled, so for small host-side values."""
    if not group_active():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def exchange_rows(flat: torch.Tensor, want: "list[np.ndarray]",
                  out: torch.Tensor) -> None:
    """``out[j]`` = row ``want[rank][j]`` of a set of rows spread over the
    ranks, rank r holding rows ``[r n, (r+1) n)`` as ``flat`` (``n =
    flat.shape[0]``): the per-epoch repack of the device-resident train
    set (core/loop_engine.py ``CachedSource``).  ``want`` is every
    rank's list (the same on every rank).  At one rank a local
    ``index_select``; across ranks one ``all_to_all_single`` brings
    each rank the rows it needs from each other (NCCL on the card, gloo
    on the CPU), so no rank holds more than its own rows and its own
    batches."""
    dev = flat.device
    if world_size() == 1:
        idx = torch.from_numpy(np.asarray(want[0], np.int64)).to(dev)
        torch.index_select(flat, 0, idx, out=out)
        return
    W, r, n = world_size(), global_rank(), flat.shape[0]
    owner = [np.asarray(w, np.int64) // n for w in want]
    send = np.concatenate([np.asarray(want[d], np.int64)[owner[d] == r]
                           - r * n for d in range(W)])
    send_sizes = [int((owner[d] == r).sum()) for d in range(W)]
    recv_pos = [np.flatnonzero(owner[r] == s) for s in range(W)]
    sendbuf = flat.index_select(0, torch.from_numpy(send).to(dev))
    recvbuf = out.new_empty(out.shape)
    dist.all_to_all_single(recvbuf, sendbuf, [len(p) for p in recv_pos],
                           send_sizes)
    out.index_copy_(0, torch.from_numpy(np.concatenate(recv_pos)).to(dev),
                    recvbuf)


def average_grads(grads: "list[torch.Tensor]") -> "list[torch.Tensor]":
    """DDP's gradient sync: the gradients laid end to end in one fp32
    buffer, summed over the ranks, divided by the world size and cast
    back to each gradient's dtype.  At one rank that is a sum over one
    rank and a divide by 1: the values come back unchanged."""
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    flat.div_(dist.get_world_size())
    out, off = [], 0
    for g in grads:
        n = g.numel()
        out.append(flat[off:off + n].view(g.shape).to(g.dtype))
        off += n
    return out


class PartitionSpec(tuple):
    """The port's copy of ``jax.sharding.PartitionSpec``: a tuple of one
    entry a dim, an axis name, a tuple of axis names (the first
    outermost) or ``None`` (whole); fewer entries than dims leave the
    rest whole."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __reduce__(self):
        return PartitionSpec, tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _best_shardable_axis(shape: Sequence[int], size: int,
                         taken: "set[int] | None" = None) -> "int | None":
    """Largest dim divisible by ``size`` (None if none): the JAX
    function."""
    best, best_dim = None, -1
    for i, d in enumerate(shape):
        if taken and i in taken:
            continue
        if size > 0 and d % size == 0 and d >= size and d > best_dim:
            best, best_dim = i, d
    return best


def _axis_spec(shape: Sequence[int], axis: str, size: int) -> P:
    """PartitionSpec sharding the best divisible dim of ``shape`` on
    ``axis``, replicated if nothing divides (the JAX function)."""
    i = _best_shardable_axis(shape, size)
    if i is None:
        return P()
    spec = [None] * len(shape)
    spec[i] = axis
    return P(*spec)


class ShardingStrategy:
    """Base: the mesh's axes, each parameter's spec, how a train step
    syncs its gradients (:meth:`grad_sync`) and where the optimizer state
    lives (:meth:`wrap_optimizer`)."""

    name: str = "base"
    #: outermost -> innermost mesh axis names
    axis_names: "tuple[str, ...]" = ("data",)
    #: axes the batch's leading dim is split over
    data_axis_names: "tuple[str, ...]" = ("data",)

    def axis_sizes(self, n_devices: int) -> dict:
        return {"data": n_devices}

    def build_mesh(self):
        """The mesh of the default process group (parallel/mesh.py):
        every rank takes part; one rank without a group."""
        from ray_lightning_tpu_torch.parallel.mesh import build_device_mesh
        return build_device_mesh(self.axis_names,
                                 self.axis_sizes(world_size()))

    # -- per-parameter specs (the JAX package's override points) -----------

    def param_spec(self, mesh, path: str, shape: Sequence[int]) -> P:
        """The spec of the parameter at flax ``path`` of flax-layout
        ``shape`` (``mesh`` needs ``axis_names`` and ``shape`` only)."""
        return P()

    def opt_spec(self, mesh, path: str, shape: Sequence[int]) -> P:
        return P()

    def batch_spec(self, mesh, ndim: int) -> P:
        if ndim == 0:
            return P()
        return P(self.data_axis_names
                 if len(self.data_axis_names) > 1 else self.data_axis_names[0])

    # -- the step ------------------------------------------------------------

    def layout(self, model, mesh):
        """The model's :class:`~ray_lightning_tpu_torch.parallel.layout.
        ShardLayout` on ``mesh``, or ``None``: every parameter whole on
        every rank."""
        return None

    def grad_sync(self, layout=None) -> Optional[Callable]:
        """``grads -> grads`` run between the backward and the update, or
        ``None``."""
        return None

    def wrap_optimizer(self, tx):
        """The optimizer the step runs, given the module's (chained with
        the clip when ``gradient_clip_val`` is set)."""
        return tx

    def __repr__(self):
        return f"{type(self).__name__}()"


class DataParallelStrategy(ShardingStrategy):
    """DDP: params and optimizer state on every rank, gradients averaged
    over the ranks before the update (module docstring)."""

    name = "ddp"

    def grad_sync(self, layout=None) -> Optional[Callable]:
        return average_grads if group_active() else None


class Zero1Strategy(ShardingStrategy):
    """ZeRO-1: params on every rank, the fp32 master and the optimizer's
    moments sharded 1/W a rank (:class:`Zero1Optimizer`).  Params with
    fewer than ``max(2, min_shard_elements)`` elements stay replicated:
    their gradients are all-reduced and every rank updates them whole."""

    name = "zero1"

    def __init__(self, min_shard_elements: int = 0):
        self.min_shard_elements = int(min_shard_elements)

    def opt_spec(self, mesh, path: str, shape: Sequence[int]) -> P:
        if math.prod(shape) < max(2, self.min_shard_elements):
            return P()
        return _axis_spec(shape, "data", mesh.shape["data"])

    def wrap_optimizer(self, tx):
        return Zero1Optimizer(tx, self.min_shard_elements)


class _ParamSharded(ShardingStrategy):
    """The strategies whose parameters live in pieces
    (parallel/layout.py): the layout, its gradient sync, the optimizer
    on the pieces."""

    def layout(self, model, mesh):
        from ray_lightning_tpu_torch.parallel.layout import ShardLayout
        return ShardLayout.of_model(model, self, mesh)

    def grad_sync(self, layout=None) -> Optional[Callable]:
        return None if layout is None else layout.grad_sync()

    def wrap_optimizer(self, tx):
        from ray_lightning_tpu_torch.parallel.layout import ShardedOptimizer
        return ShardedOptimizer(tx)


class FullyShardedStrategy(_ParamSharded, Zero1Strategy):
    """ZeRO-3 / FSDP (``"fsdp"``, ``"zero3"``): params and optimizer state
    both sharded on ``data``, gathered at their use sites in the forward
    and (under remat) again in the backward, the gradient
    reduce-scattered (module docstring; parallel/layout.py).  Params
    with fewer than ``max(2, min_shard_elements)`` elements, or no dim
    that W divides, stay whole on every rank (the JAX spec)."""

    name = "fsdp"

    def param_spec(self, mesh, path: str, shape: Sequence[int]) -> P:
        if math.prod(shape) < max(2, self.min_shard_elements):
            return P()
        return _axis_spec(shape, "data", mesh.shape["data"])

    def __repr__(self):
        return f"FullyShardedStrategy({self.min_shard_elements})"


class SpmdStrategy(_ParamSharded):
    """General SPMD over a multi-axis mesh with regex partition rules
    (the JAX class).  ``rules`` is an ordered list of ``(regex,
    PartitionSpec)`` searched in the ``/``-joined flax parameter path;
    the first match wins, a rule naming only axes the mesh lacks is
    skipped; no match: whole, or split on ``fsdp`` when that axis is
    over 1.  On an ``expert`` axis over 1 the routed layers' experts
    are split (``moe_partition_rules``; the batch is not), on a
    ``sequence`` axis over 1 the batch's dim 1 (module docstring)."""

    name = "spmd"

    def __init__(self, rules: Sequence = (),
                 axis_names: Sequence[str] = ("data", "fsdp", "expert",
                                              "sequence", "tensor"),
                 axis_sizes: "dict | None" = None,
                 shard_sequence_dim: bool = True,
                 min_shard_elements: int = 0):
        self.rules = [(re.compile(r), P(*spec)) for r, spec in rules]
        self.axis_names = tuple(axis_names)
        self._axis_sizes = dict(axis_sizes or {})
        self.shard_sequence_dim = shard_sequence_dim and (
            "sequence" in self.axis_names)
        self.min_shard_elements = min_shard_elements
        self.data_axis_names = tuple(
            a for a in ("data", "fsdp") if a in self.axis_names)

    def axis_sizes(self, n_devices: int) -> dict:
        sizes = dict(self._axis_sizes)
        for a in self.axis_names:
            sizes.setdefault(a, 1 if a != "data" else None)
        if sizes.get("data") is None:
            sizes["data"] = -1
        return sizes

    def _rule_spec(self, mesh, path: str) -> "P | None":
        for rx, spec in self.rules:
            if rx.search(path):
                pruned = self._prune_spec(mesh, spec)
                if any(e is not None for e in spec) and \
                        not any(e is not None for e in pruned):
                    # the rule names only axes this mesh lacks: treat it
                    # as unmatched, so later rules and the fsdp fallback
                    # still see the parameter
                    continue
                return pruned
        return None

    @staticmethod
    def _prune_spec(mesh, spec: P) -> P:
        """Drop the axes the mesh does not have, so one rule set works on
        any sub-mesh."""
        def keep(entry):
            if entry is None:
                return None
            if isinstance(entry, (tuple, list)):
                kept = tuple(a for a in entry if a in mesh.axis_names)
                return kept if kept else None
            return entry if entry in mesh.axis_names else None
        return P(*(keep(e) for e in spec))

    def _fsdp_fallback(self, mesh, shape: Sequence[int]) -> P:
        if "fsdp" in mesh.axis_names and mesh.shape["fsdp"] > 1 \
                and math.prod(shape) >= max(2, self.min_shard_elements):
            return _axis_spec(shape, "fsdp", mesh.shape["fsdp"])
        return P()

    def param_spec(self, mesh, path: str, shape: Sequence[int]) -> P:
        spec = self._rule_spec(mesh, path)
        if spec is not None:
            return spec
        return self._fsdp_fallback(mesh, shape)

    def opt_spec(self, mesh, path: str, shape: Sequence[int]) -> P:
        spec = self._rule_spec(mesh, path)
        if spec is not None and len(spec) == len(shape):
            return spec
        return self._fsdp_fallback(mesh, shape)

    def batch_spec(self, mesh, ndim: int) -> P:
        if ndim == 0:
            return P()
        data = (self.data_axis_names if len(self.data_axis_names) > 1
                else self.data_axis_names[0])
        if (self.shard_sequence_dim and ndim >= 2
                and mesh.shape.get("sequence", 1) > 1):
            return P(data, "sequence")
        return P(data)

    def __repr__(self):
        return (f"SpmdStrategy({len(self.rules)} rules, "
                f"{self.axis_names}, {self._axis_sizes})")


class _Flat:
    """Parameters laid end to end in one vector, padded to a multiple of
    ``shards``; this rank holds ``[lo, hi)`` of it."""

    def __init__(self, names: "list[str]", shapes: list, shards: int,
                 rank: int):
        self.names = names
        self.shapes = [torch.Size(s) for s in shapes]
        self.numels = [math.prod(s) for s in self.shapes]
        self.offsets = [sum(self.numels[:i]) for i in range(len(names))]
        self.n = sum(self.numels)
        self.shards = shards
        self.size = -(-self.n // shards)
        self.lo, self.hi = rank * self.size, (rank + 1) * self.size

    def flatten(self, tensors, dtype=torch.float32) -> torch.Tensor:
        """The tensors in ``dtype`` laid end to end, zero-padded to
        ``size * shards``."""
        flat = tensors[0].new_zeros(self.size * self.shards, dtype=dtype)
        torch.cat([t.reshape(-1).to(dtype) for t in tensors],
                  out=flat[:self.n])
        return flat

    def shard_of(self, tensors, dtype=torch.float32) -> torch.Tensor:
        """This rank's piece of :meth:`flatten`, in storage of its own."""
        flat = self.flatten(tensors, dtype)
        return flat if self.shards == 1 else flat[self.lo:self.hi].clone()

    def unflatten(self, full: torch.Tensor) -> "dict[str, torch.Tensor]":
        """The whole vector (every shard) back into tensors by name."""
        return {k: full[o:o + n].view(s) for k, o, n, s in
                zip(self.names, self.offsets, self.numels, self.shapes)}

    def pieces(self):
        """``(i, a, b)`` for each parameter ``i`` with elements in this
        rank's shard: they are ``shard[a:b]``."""
        for i, (o, n) in enumerate(zip(self.offsets, self.numels)):
            a, b = max(o, self.lo), min(o + n, self.hi)
            if a < b:
                yield i, a - self.lo, b - self.lo


class Zero1State:
    """The state of :class:`Zero1Optimizer`: per group of parameters its
    layout, this rank's shard of the fp32 master (``None`` when the
    params are their own fp32 master) and the inner optimizer's state
    over that shard, keyed ``"flat"``.  :meth:`state_dict` and
    :meth:`load_state_dict` speak the single-device layout (the state
    of the unwrapped optimizer, keyed by parameter name), so a
    checkpoint moves between world sizes; both are collective."""

    def __init__(self, opt: "Zero1Optimizer", groups: "list[_Flat]",
                 masters: list, inners: list):
        self.opt = opt
        self.groups = groups
        self.masters = masters
        self.inners = inners

    def _full(self, g: _Flat, shard: torch.Tensor) -> torch.Tensor:
        if g.shards == 1:
            return shard
        full = shard.new_empty(g.size * g.shards)
        dist.all_gather_into_tensor(full, shard)
        return full

    def _by_name(self, shards) -> "dict[str, torch.Tensor]":
        out = {}
        for g, s in zip(self.groups, shards):
            out.update({k: v.clone() for k, v in
                        g.unflatten(self._full(g, s)).items()})
        return {k: out[k] for k in self.opt.names}

    def state_dict(self) -> dict:
        inner = self.opt.inner
        if isinstance(inner, AdamW):
            sd = {"count": self.inners[0].count,
                  "mu": self._by_name([s.mu["flat"] for s in self.inners]),
                  "nu": self._by_name([s.nu["flat"] for s in self.inners])}
        elif inner.momentum is not None:
            sd = {"trace": self._by_name([s.trace["flat"]
                                          for s in self.inners])}
        else:
            sd = {}
        if self.opt.has_master:
            sd = {"inner": sd, "master": self._by_name(self.masters)}
        return _nest(self.opt.tx, sd)

    def load_state_dict(self, state: dict) -> None:
        state = _unnest(self.opt.tx, state)
        if self.opt.has_master:
            master = _named(state["master"], self.opt.names, "master")
            self.masters = [g.shard_of([master[k] for k in g.names])
                            for g in self.groups]
            state = state["inner"]
        inner = self.opt.inner
        if isinstance(inner, SGD) and inner.momentum is None:
            EmptyState().load_state_dict(state)
            return
        if isinstance(inner, SGD):
            trace = _named(state["trace"], self.opt.names, "trace")
            for g, s in zip(self.groups, self.inners):
                s.trace = {"flat": g.shard_of([trace[k] for k in g.names],
                                              s.trace["flat"].dtype)}
            return
        mu = _named(state["mu"], self.opt.names, "mu")
        nu = _named(state["nu"], self.opt.names, "nu")
        for g, s in zip(self.groups, self.inners):
            s.count = int(state["count"])
            s.mu = {"flat": g.shard_of([mu[k] for k in g.names],
                                       s.mu["flat"].dtype)}
            s.nu = {"flat": g.shard_of([nu[k] for k in g.names])}


def _transforms(tx) -> list:
    """``tx``'s transforms in the order they run, nested chains laid
    flat."""
    if isinstance(tx, chain):
        return [t for sub in tx.transforms for t in _transforms(sub)]
    return [tx]


def _nest(tx, sd: dict) -> dict:
    """The last transform's state dict ``sd`` inside ``tx``'s chains, as
    the unsharded optimizer's ``state_dict`` nests it (a gradient map's
    state is empty)."""
    if not isinstance(tx, chain):
        return sd
    *maps, last = tx.transforms
    return {**{str(i): {} for i in range(len(maps))},
            str(len(maps)): _nest(last, sd)}


def _unnest(tx, state: dict) -> dict:
    """The inverse of :func:`_nest`, checking the chain's entries."""
    if not isinstance(tx, chain):
        return state
    n = len(tx.transforms)
    if sorted(state) != sorted(str(i) for i in range(n)) \
            or any(state[str(i)] for i in range(n - 1)):
        raise ValueError(f"a chain of {n} transforms: the state has "
                         f"{sorted(state)}")
    return _unnest(tx.transforms[-1], state[str(n - 1)])


def _named(saved: Mapping, names: "list[str]", what: str) -> dict:
    if set(saved) != set(names):
        raise ValueError(
            f"{what}: the saved state names other parameters (missing "
            f"{sorted(set(names) - set(saved))[:4]}, unexpected "
            f"{sorted(set(saved) - set(names))[:4]})")
    return dict(saved)


class Zero1Optimizer:
    """ZeRO-1 around the optimizer the ``Trainer`` builds: ``AdamW``,
    ``SGD`` (with or without momentum) or ``fp32_master`` of either,
    behind an optional ``clip_by_global_norm`` and any number of
    ``add_decayed_weights`` (a :class:`chain`, nested or not, in that
    order).

    Per step: the gradients (in their dtype ``d``) are laid into one fp32
    vector and reduce-scattered (summed, then divided by W) and the
    rank's shard is rounded to ``d``, which is what DDP's mean is cast
    back to; the clip, if any, scales the shard by a norm taken from the
    per-parameter sums of squares, all-reduced (the pad left out), then
    rounded to ``d`` and summed in parameter order as the clip sums them
    (a parameter whole on one rank gets the unsharded clip's sum
    exactly); the weight decay adds ``wd`` times the rank's shard of the
    resident params; the inner optimizer updates the rank's shard of the
    fp32 master (the params themselves when they are fp32 and there is
    no ``fp32_master``); the shards are all-gathered and copied into the
    resident params, which casts them to their dtype.  Every step but
    the clip is elementwise, so without a clip ZeRO-1 equals DDP bit
    for bit."""

    def __init__(self, tx, min_shard_elements: int = 0):
        self.tx = tx
        *maps, last = _transforms(tx)
        self.clip = None
        if maps and isinstance(maps[0], clip_by_global_norm):
            self.clip = maps.pop(0)
        if not all(isinstance(m, add_decayed_weights) for m in maps):
            raise NotImplementedError(
                "ZeRO-1 takes chain(clip_by_global_norm, "
                "add_decayed_weights..., optimizer) only, got "
                f"{[type(t).__name__ for t in _transforms(tx)]}")
        self.maps = maps
        self.has_master = isinstance(last, fp32_master)
        self.inner = last.inner if self.has_master else last
        if not isinstance(self.inner, (AdamW, SGD)):
            raise NotImplementedError(
                f"ZeRO-1 shards AdamW and SGD states, not "
                f"{type(self.inner).__name__}")
        self.min_shard_elements = min_shard_elements
        self.names: "list[str]" = []

    def init(self, params: Mapping[str, torch.Tensor]) -> Zero1State:
        self.names = list(params)
        small = max(2, self.min_shard_elements)
        W, rank = world_size(), global_rank()
        groups = []
        for shards, r, keep in ((W, rank, lambda n: n >= small),
                                (1, 0, lambda n: n < small)):
            names = [k for k in self.names if keep(params[k].numel())]
            if names:
                groups.append(_Flat(names, [params[k].shape for k in names],
                                    shards, r))
        masters, inners = [], []
        for g in groups:
            shard = g.shard_of([params[k].detach() for k in g.names])
            masters.append(shard if self.has_master else None)
            inners.append(self.inner.init({"flat": shard}))
        return Zero1State(self, groups, masters, inners)

    def host_scalars(self, state: Zero1State, ahead: int = 0):
        """The inner optimizer's (every group's state counts alike)."""
        return self.inner.host_scalars(state.inners[0], ahead)

    def advance(self, state: Zero1State, n: int) -> None:
        for s in state.inners:
            self.inner.advance(s, n)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: Zero1State,
               params: Mapping[str, torch.Tensor],
               scalars: "torch.Tensor | None" = None) -> None:
        dtypes = {g.dtype for g in grads.values()}
        if len(dtypes) != 1:
            raise ValueError(f"ZeRO-1 takes gradients of one dtype, got "
                             f"{sorted(map(str, dtypes))}")
        d = dtypes.pop()
        if not self.has_master and any(p.dtype != torch.float32
                                       for p in params.values()):
            raise ValueError("ZeRO-1 updates an fp32 master: wrap the "
                             "optimizer of low-precision params in "
                             "fp32_master")
        W = world_size()
        shards = []
        for g in state.groups:
            flat = g.flatten([grads[k] for k in g.names])
            if group_active() and g.shards > 1:
                out = flat.new_empty(g.size)
                dist.reduce_scatter_tensor(out, flat)
            else:
                out = flat
                if group_active():
                    dist.all_reduce(out)
            shards.append(out.div_(W).to(d))
        if self.clip is not None:
            shards = self._clip(state.groups, shards, d)
        for i, (g, gs) in enumerate(zip(state.groups, shards)):
            resident = None
            if self.maps or not self.has_master:
                resident = g.shard_of([params[k] for k in g.names],
                                      params[g.names[0]].dtype)
            for m in self.maps:
                gs = m.update({"flat": gs}, EmptyState(),
                              {"flat": resident})["flat"]
            master = state.masters[i] if self.has_master else resident
            self.inner.update({"flat": gs.float()}, state.inners[i],
                              {"flat": master}, scalars)
            for k, v in g.unflatten(state._full(g, master)).items():
                params[k].copy_(v)

    def _clip(self, groups, shards, d):
        """``clip_by_global_norm`` on the shards (class docstring)."""
        index = {k: i for i, k in enumerate(self.names)}
        sq = torch.zeros(len(self.names), dtype=torch.float32,
                         device=shards[0].device)
        for g, s in zip(groups, shards):
            if g.shards == 1 and global_rank() != 0:
                continue                # replicated: rank 0 counts it
            for i, a, b in g.pieces():
                piece = s[a:b]
                # a whole parameter's sum as the unsharded clip takes it
                # (in d, accumulated in fp32), a part's in fp32
                sq[index[g.names[i]]] = (
                    torch.sum(piece * piece) if b - a == g.numels[i]
                    else (piece * piece).sum(dtype=torch.float32))
        sq = sum_over_ranks(sq).to(d)
        norm = torch.sqrt(sum(sq.unbind()))
        trigger = norm < self.clip.max_norm
        return [torch.where(trigger, s, (s / norm) * self.clip.max_norm)
                for s in shards]


_STRATEGIES = {
    "ddp": DataParallelStrategy,
    "dp": DataParallelStrategy,
    "zero1": Zero1Strategy,
    "sharded": Zero1Strategy,       # the reference's name (RayShardedPlugin)
    "fsdp": FullyShardedStrategy,
    "zero3": FullyShardedStrategy,
    "spmd": SpmdStrategy,
}

#: strategy names of the JAX package not ported yet -> their ROADMAP.md
#: queue 1 item
_NOT_PORTED = {"auto": 12, "mpmd": 11}


def strategy_names() -> "list[str]":
    """Every ported ``Trainer(strategy=...)`` string, sorted."""
    return sorted(_STRATEGIES)


def resolve_strategy(strategy: "str | ShardingStrategy | None"
                     ) -> ShardingStrategy:
    """``Trainer(strategy=...)`` as a :class:`ShardingStrategy`: an
    instance passes through, ``None`` means DDP, a string selects by name
    (module docstring)."""
    if strategy is None:
        return DataParallelStrategy()
    if isinstance(strategy, ShardingStrategy):
        return strategy
    if isinstance(strategy, str):
        key = strategy.lower()
        if key in _NOT_PORTED:
            raise NotImplementedError(
                f"strategy {strategy!r} is not ported yet (ROADMAP.md "
                f"queue 1 item {_NOT_PORTED[key]}); ported: "
                f"{strategy_names()}")
        if key not in _STRATEGIES:
            raise ValueError(
                f"Unknown strategy {strategy!r}; valid strategy names: "
                f"{strategy_names()}")
        return _STRATEGIES[key]()
    raise TypeError(f"Bad strategy: {strategy!r}")


__all__ = ["DataParallelStrategy", "FullyShardedStrategy", "P",
           "PartitionSpec", "ShardingStrategy", "SpmdStrategy",
           "Zero1Optimizer",
           "Zero1State", "Zero1Strategy", "average_grads", "batch_moments",
           "exchange_rows", "gather_objects",
           "global_rank", "group_active", "mean_over_ranks", "resolve_strategy", "strategy_names",
           "sum_over_ranks", "world_size"]
