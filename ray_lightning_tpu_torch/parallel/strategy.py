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
``batch_spec`` / ``kv_cache_spec`` as tuples equal to JAX's
(:class:`PartitionSpec`), for the flax path of a port parameter
(``convert.flax_path``); ``kv_cache_block`` is the serve engine's block
of slots and heads on one rank (serve/engine.py).  ``"auto"`` is
:class:`AutoStrategy`, the sentinel the planner plane (plan/) resolves
inside ``Trainer`` into a concrete strategy; each strategy describes
the meshes it can plan over (``plan_mesh_options`` / ``from_plan``).
``"mpmd"`` raises ``NotImplementedError`` naming its ROADMAP.md item;
other names raise ``ValueError``, as in the JAX package.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ray_lightning_tpu_torch.comm import audit
from ray_lightning_tpu_torch.ops.optim import (EmptyState, chain,
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
    audit.note("all-reduce", buf, None, "metrics")
    buf.div_(dist.get_world_size())
    return [b.to(v.dtype) for b, v in zip(buf, values)]


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, into a new tensor (``t`` without a
    process group)."""
    if not group_active():
        return t
    t = t.clone()
    dist.all_reduce(t)
    audit.note("all-reduce", t, None, "metrics")
    return t


class _SumOverRanks(torch.autograd.Function):
    """``all_reduce`` (sum) whose backward sums the gradient over the
    ranks too: every rank's loss depends on every rank's share of the
    sum."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t)
        audit.note("all-reduce", t, None, "moments")
        return t

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.clone()
        dist.all_reduce(grad)
        audit.note("all-reduce", grad, None, "moments")
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
                  out: torch.Tensor, group=None) -> None:
    """``out[j]`` = row ``want[rank][j]`` of a set of rows spread over the
    ranks, rank r holding rows ``[r n, (r+1) n)`` as ``flat`` (``n =
    flat.shape[0]``): the per-epoch repack of the device-resident train
    set (core/loop_engine.py ``CachedSource``).  ``want`` is every
    rank's list (the same on every rank).  At one rank a local
    ``index_select``; across ranks one ``all_to_all_single`` brings
    each rank the rows it needs from each other (NCCL on the card, gloo
    on the CPU), so no rank holds more than its own rows and its own
    batches.  ``group`` (default: every rank) is the ranks that share
    the set, one a batch shard: on a mesh with a tensor, expert,
    sequence or stage axis over 1, the group of the batch axes, in
    whose rank numbers ``want`` and the row ranges are read."""
    dev = flat.device
    W = len(want)
    if W == 1:
        idx = torch.from_numpy(np.asarray(want[0], np.int64)).to(dev)
        torch.index_select(flat, 0, idx, out=out)
        return
    r, n = dist.get_rank(group), flat.shape[0]
    owner = [np.asarray(w, np.int64) // n for w in want]
    send = np.concatenate([np.asarray(want[d], np.int64)[owner[d] == r]
                           - r * n for d in range(W)])
    send_sizes = [int((owner[d] == r).sum()) for d in range(W)]
    recv_pos = [np.flatnonzero(owner[r] == s) for s in range(W)]
    sendbuf = flat.index_select(0, torch.from_numpy(send).to(dev))
    recvbuf = out.new_empty(out.shape)
    dist.all_to_all_single(recvbuf, sendbuf, [len(p) for p in recv_pos],
                           send_sizes, group=group)
    out.index_copy_(0, torch.from_numpy(np.concatenate(recv_pos)).to(dev),
                    recvbuf)


def average_grads(grads: "list[torch.Tensor]") -> "list[torch.Tensor]":
    """DDP's gradient sync: the gradients laid end to end in one fp32
    buffer, summed over the ranks, divided by the world size and cast
    back to each gradient's dtype.  At one rank that is a sum over one
    rank and a divide by 1: the values come back unchanged."""
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    audit.note("all-reduce", flat, None, "ddp")
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
    #: whether the gradient sync can route through the comm plane's
    #: compressed collectives (comm/collectives.py): params whole on
    #: every rank
    comm_compressible: bool = False

    def axis_sizes(self, n_devices: int) -> dict:
        return {"data": n_devices}

    @classmethod
    def plan_mesh_options(cls, n_devices: int) -> tuple:
        """The mesh factorizations of ``n_devices`` this strategy can be
        planned over, as axis-size dicts (the planner enumerates one
        candidate each).  Single-axis strategies have one."""
        return ({"data": n_devices},)

    @classmethod
    def from_plan(cls, axis_sizes: dict) -> "ShardingStrategy":
        """The strategy for one :meth:`plan_mesh_options` entry."""
        del axis_sizes
        return cls()

    def build_mesh(self, batch_hint: "int | None" = None):
        """The mesh of the default process group (parallel/mesh.py):
        every rank takes part; one rank without a group.  ``batch_hint``
        (a global batch: the serve engine's slots) must divide by the
        data shards (:meth:`mesh_shape`)."""
        from ray_lightning_tpu_torch.parallel.mesh import build_device_mesh
        shape = self.mesh_shape(world_size(), batch_hint)
        return build_device_mesh(self.axis_names, shape)

    def mesh_shape(self, n_ranks: int, batch_hint: "int | None" = None
                   ) -> dict:
        """Axis name -> size of this strategy's mesh over ``n_ranks``
        ranks.  With ``batch_hint`` the batch must divide by the data
        shards (the axes in ``data_axis_names``): the JAX ``build_mesh``
        clamps the data axis in a single process, where the port's one
        rank has one data shard and nothing to clamp, and over several
        processes spans them all, so here it raises, naming both
        numbers."""
        from ray_lightning_tpu_torch.parallel.mesh import _infer_axis_sizes
        shape = dict(zip(self.axis_names, _infer_axis_sizes(
            n_ranks, dict(self.axis_sizes(n_ranks)), self.axis_names)))
        shards = math.prod(shape.get(a, 1) for a in self.data_axis_names)
        if batch_hint is not None and int(batch_hint) % shards:
            raise ValueError(
                f"global batch {batch_hint} does not divide across "
                f"{shards} data shards of the mesh {shape}: make it a "
                f"multiple of {shards}")
        return shape

    def kv_cache_spec(self, mesh, ndim: int = 5) -> P:
        """The serve plane's slot-indexed KV cache ``[n_layer, slot, pos,
        head, dim]`` as the JAX package shards it (its two
        ``kv_cache_spec``\\s in one): the slots over the data axes, as
        the batch's leading dim, and the heads over ``tensor`` when the
        mesh has that axis over 1 (the decode attention is head-parallel
        as the training attention is)."""
        if ndim < 2:
            return P()
        spec: list = [None] * ndim
        spec[1] = (self.data_axis_names if len(self.data_axis_names) > 1
                   else self.data_axis_names[0])
        if ndim >= 4 and mesh.shape.get("tensor", 1) > 1:
            spec[3] = "tensor"
        return P(*spec)

    def kv_cache_block(self, mesh, slots: int, heads: int
                       ) -> "tuple[tuple[int, int], tuple[int, int]]":
        """What this rank of ``mesh`` holds of a KV cache of ``slots``
        slots and ``heads`` heads (:meth:`kv_cache_spec`): ``((slot_lo,
        slot_hi), (head_lo, head_hi))``, its block of slots by its
        coordinates on the data axes (row-major, the first outermost)
        and its block of heads by its coordinate on ``tensor``.  Each
        must divide evenly."""
        spec = tuple(self.kv_cache_spec(mesh))
        out = []
        for dim, total in ((1, slots), (3, heads)):
            names = spec[dim]
            names = () if names is None else (
                tuple(names) if isinstance(names, tuple) else (names,))
            names = tuple(a for a in names if a in mesh.axis_names)
            n = mesh.size(*names)
            if total % n:
                raise ValueError(
                    f"{('slots', 'heads')[dim == 3]}={total} do not "
                    f"divide across {n} shards of {names} on the mesh "
                    f"{mesh.shape}")
            per = total // n
            i = mesh.index(*names)
            out.append((i * per, (i + 1) * per))
        return out[0], out[1]

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

    def wrap_optimizer(self, tx, comm=None):
        """The optimizer the step runs, given the module's (chained with
        the clip when ``gradient_clip_val`` is set) and the comm plane's
        ``GradSync`` (``None``: off)."""
        return tx

    # -- the comm plane ------------------------------------------------------

    def grad_transform(self, mesh, policy, local: "int | None" = None,
                       hosts: "int | None" = None):
        """Resolve a comm policy against this strategy on this mesh: a
        ``comm.GradSync`` the step routes the gradient reduction
        through, or ``None`` (the uncompressed step: the same
        collectives as without a policy); comm/collectives.py
        ``build_grad_sync`` has the rules."""
        if policy is None:
            return None
        from ray_lightning_tpu_torch.comm.collectives import build_grad_sync
        return build_grad_sync(self, mesh, policy, local=local, hosts=hosts)

    def data_parallel_size(self, mesh) -> int:
        return mesh.size(*(a for a in self.data_axis_names
                           if a in mesh.axis_names))

    @staticmethod
    def _tree_bytes(params: Mapping) -> int:
        from ray_lightning_tpu_torch.comm.collectives import (_itemsize,
                                                              _numel)
        return sum(_numel(p) * _itemsize(p.dtype) for p in params.values())

    @staticmethod
    def _tree_elements(params: Mapping) -> int:
        from ray_lightning_tpu_torch.comm.collectives import _numel
        return sum(_numel(p) for p in params.values())

    def step_collective_bytes(self, mesh, params: Mapping,
                              comm=None) -> dict:
        """op -> logical payload bytes ONE optimizer step moves (the JAX
        declaration; ``params`` maps names to anything with ``shape``
        and ``dtype``).  DDP: one gradient all-reduce the size of the
        params; with an active comm plane the compressed wire payload,
        split by link tier (``_dcn`` / ``_ici``) when hierarchical."""
        if self.data_parallel_size(mesh) <= 1:
            return {}
        if comm is not None:
            n = self._tree_elements(params)
            if comm.hierarchical:
                link = comm.psum_link_bytes(n)
                return {"grad_all_reduce_dcn": link["dcn"],
                        "grad_all_reduce_ici": link["ici"]}
            return {"grad_all_reduce": comm.psum_wire_bytes(n)}
        return {"grad_all_reduce": self._tree_bytes(params)}

    def __repr__(self):
        return f"{type(self).__name__}()"


class DataParallelStrategy(ShardingStrategy):
    """DDP: params and optimizer state on every rank, gradients averaged
    over the ranks before the update (module docstring)."""

    name = "ddp"
    comm_compressible = True

    def grad_sync(self, layout=None) -> Optional[Callable]:
        return average_grads if group_active() else None


class Zero1Strategy(ShardingStrategy):
    """ZeRO-1: params on every rank, the fp32 master and the optimizer's
    moments sharded 1/W a rank (:class:`Zero1Optimizer`).  Params with
    fewer than ``max(2, min_shard_elements)`` elements stay replicated:
    their gradients are all-reduced and every rank updates them whole."""

    name = "zero1"
    comm_compressible = True

    def __init__(self, min_shard_elements: int = 0):
        self.min_shard_elements = int(min_shard_elements)

    def opt_spec(self, mesh, path: str, shape: Sequence[int]) -> P:
        if math.prod(shape) < max(2, self.min_shard_elements):
            return P()
        return _axis_spec(shape, "data", mesh.shape["data"])

    def wrap_optimizer(self, tx, comm=None):
        return Zero1Optimizer(tx, self.min_shard_elements, comm=comm)

    def step_collective_bytes(self, mesh, params: Mapping,
                              comm=None) -> dict:
        """ZeRO-1's step traffic (the JAX declaration): the gradient
        reduce-scatter and the updated-param all-gather, each one
        params' worth; with an active comm plane the gather at
        ``param_gather``'s payload, keyed ``param_all_gather_bucketed``
        when bucketed (same bytes, another schedule), and the gradient
        phase at the codec's payload (per link when hierarchical).  One
        difference on purpose: the JAX compressed step all-reduces the
        gradients (reduce-scatter and all-gather, both declared) and
        then slices its shard, where the port's ZeRO-1 reduce-scatters
        over its shard layout and moves no gradient all-gather, so
        ``grad_all_gather`` is not declared and a hierarchical sync
        declares the reduce-scatter's phases only."""
        if self.data_parallel_size(mesh) <= 1:
            return {}
        if comm is not None:
            gather_key = ("param_all_gather_bucketed"
                          if comm.policy.gather_bucket_bytes > 0
                          and not comm.policy.barrier_sync
                          else "param_all_gather")
            n = self._tree_elements(params)
            gather = comm.param_gather_wire_bytes(params)
            if comm.hierarchical:
                link = comm.reduce_scatter_link_bytes(n)
                return {"grad_sync_dcn": link["dcn"],
                        "grad_sync_ici": link["ici"], gather_key: gather}
            return {"grad_reduce_scatter": comm.reduce_scatter_wire_bytes(n),
                    gather_key: gather}
        b = self._tree_bytes(params)
        return {"grad_reduce_scatter": b, "param_all_gather": b}


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
    comm_compressible = False       # params sharded: the plane declines

    def param_spec(self, mesh, path: str, shape: Sequence[int]) -> P:
        if math.prod(shape) < max(2, self.min_shard_elements):
            return P()
        return _axis_spec(shape, "data", mesh.shape["data"])

    def step_collective_bytes(self, mesh, params: Mapping,
                              comm=None) -> dict:
        """FSDP's step traffic (the JAX declaration): params gathered at
        their use sites in the forward and the backward, the gradient
        reduce-scattered; the comm plane declines FSDP."""
        del comm
        if self.data_parallel_size(mesh) <= 1:
            return {}
        b = self._tree_bytes(params)
        return {"param_all_gather": 2 * b, "grad_reduce_scatter": b}

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

    @classmethod
    def plan_mesh_options(cls, n_devices: int) -> tuple:
        """Every ``data x fsdp`` factorization with an fsdp axis over 1
        (fsdp=1 would repeat the DDP candidate); the planner's SPMD
        candidate is rule-less, so its parameters take the fsdp
        fallback (the JAX hooks)."""
        return tuple({"data": n_devices // f, "fsdp": f}
                     for f in range(2, n_devices + 1) if n_devices % f == 0)

    @classmethod
    def from_plan(cls, axis_sizes: dict) -> "SpmdStrategy":
        return cls(axis_names=("data", "fsdp"),
                   axis_sizes={"fsdp": int(axis_sizes.get("fsdp", 1))})

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

    def step_collective_bytes(self, mesh, params: Mapping,
                              comm=None) -> dict:
        """The JAX approximation: an ``fsdp`` axis over 1 gathers params
        in the forward and the backward and reduce-scatters gradients, a
        ``data`` axis over 1 all-reduces them; the comm plane declines
        SPMD."""
        del comm
        out: dict = {}
        b = self._tree_bytes(params)
        if mesh.shape.get("fsdp", 1) > 1:
            out["param_all_gather"] = 2 * b
            out["grad_reduce_scatter"] = b
        if mesh.shape.get("data", 1) > 1:
            out["grad_all_reduce"] = b
        return out

    def __repr__(self):
        return (f"SpmdStrategy({len(self.rules)} rules, "
                f"{self.axis_names}, {self._axis_sizes})")


class _Flat:
    """Parameters laid end to end in one vector, padded to a multiple of
    ``shards``; this rank holds ``[lo, hi)`` of it.  ``itemsize``: the
    bytes of an element of the resident params' shard (ZeRO-1's gather
    dtype)."""

    def __init__(self, names: "list[str]", shapes: list, shards: int,
                 rank: int, itemsize: int = 4):
        self.names = names
        self.shapes = [torch.Size(s) for s in shapes]
        self.numels = [math.prod(s) for s in self.shapes]
        self.offsets = [sum(self.numels[:i]) for i in range(len(names))]
        self.n = sum(self.numels)
        self.shards = shards
        self.size = -(-self.n // shards)
        self.lo, self.hi = rank * self.size, (rank + 1) * self.size
        self.itemsize = itemsize

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


#: the keys of :class:`Zero1Optimizer`'s two groups in the state of the
#: transforms it runs: the sharded parameters and the small whole ones
_SHARD, _WHOLE = "zero1/shard", "zero1/whole"


def _regroup(tree, match, fn):
    """``tree`` (a nested state dict) with every dict whose keys
    ``match`` replaced by ``fn(that dict)``."""
    if isinstance(tree, dict):
        if tree and match(set(tree)):
            return fn(tree)
        return {k: _regroup(v, match, fn) for k, v in tree.items()}
    return tree


class Zero1State:
    """The state of :class:`Zero1Optimizer`: per group of parameters its
    layout (``groups``: the sharded ones, then the small whole ones) and
    the optimizer's state over the groups' flat vectors (``inner``: the
    module optimizer's own state, whose per-parameter dicts are keyed by
    group, each entry this rank's shard).  :meth:`state_dict` and
    :meth:`load_state_dict` speak the single-device layout (the state
    of the unwrapped optimizer, keyed by parameter name), so a
    checkpoint moves between world sizes; both are collective."""

    def __init__(self, names: "list[str]", groups: "list[_Flat]",
                 keys: "list[str]", inner):
        self.names = list(names)
        self.groups = groups
        self.keys = keys
        self.inner = inner

    @property
    def masters(self) -> list:
        """Each group's fp32 master shard, where the optimizer holds one
        (an ``fp32_master``'s), else ``None``."""
        found = _find_master(self.inner)
        return [None if found is None else found.get(k) for k in self.keys]

    def _full(self, g: _Flat, shard: torch.Tensor) -> torch.Tensor:
        if g.shards == 1:
            return shard
        full = shard.new_empty(g.size * g.shards)
        dist.all_gather_into_tensor(full, shard)
        return full

    def _by_name(self, entry: dict) -> "dict[str, torch.Tensor]":
        out = {}
        for g, k in zip(self.groups, self.keys):
            out.update({n: v.clone() for n, v in
                        g.unflatten(self._full(g, entry[k])).items()})
        return {k: out[k] for k in self.names}

    def state_dict(self) -> dict:
        keys = set(self.keys)
        return _regroup(self.inner.state_dict(), lambda ks: ks == keys,
                        self._by_name)

    def load_state_dict(self, state: dict) -> None:
        names = set(self.names)

        def shard(entry: dict) -> dict:
            if set(entry) != names:
                raise ValueError(
                    f"the saved state names other parameters (missing "
                    f"{sorted(names - set(entry))[:4]}, unexpected "
                    f"{sorted(set(entry) - names)[:4]})")
            dtype = entry[self.names[0]].dtype
            return {k: g.shard_of([entry[n] for n in g.names], dtype)
                    for g, k in zip(self.groups, self.keys)}

        self.inner.load_state_dict(_regroup(
            state, lambda ks: bool(ks & names), shard))


def _find_master(state):
    """The ``master`` dict of the first ``FP32MasterState`` inside an
    optimizer state, else ``None``."""
    if hasattr(state, "master") and hasattr(state, "inner"):
        return state.master
    for attr in ("states", "inner"):
        sub = getattr(state, attr, None)
        for s in (sub if isinstance(sub, tuple) else (sub,)):
            if s is not None:
                found = _find_master(s)
                if found is not None:
                    return found
    return None


class _Zero1Clip:
    """``clip_by_global_norm`` on ZeRO-1's shards: the norm is taken from
    the per-parameter sums of squares, all-reduced (the pad left out),
    rounded to the gradients' dtype and summed in parameter order as
    the unsharded clip sums them (a parameter whole on one rank gets
    the unsharded clip's sum exactly); each shard scaled as the clip
    scales a gradient."""

    def __init__(self, clip: clip_by_global_norm, opt: "Zero1Optimizer"):
        self.max_norm = clip.max_norm
        self.opt = opt

    def init(self, params):
        return EmptyState()

    @torch.no_grad()
    def update(self, grads, state, params=None):
        opt = self.opt
        index = {k: i for i, k in enumerate(opt.names)}
        first = next(iter(grads.values()))
        d = first.dtype
        sq = torch.zeros(len(opt.names), dtype=torch.float32,
                         device=first.device)
        for g, k in zip(opt.groups, opt.keys):
            if g.shards == 1 and global_rank() != 0:
                continue                # replicated: rank 0 counts it
            s = grads[k]
            for i, a, b in g.pieces():
                piece = s[a:b]
                # a whole parameter's sum as the unsharded clip takes it
                # (in d, accumulated in fp32), a part's in fp32
                sq[index[g.names[i]]] = (
                    torch.sum(piece * piece) if b - a == g.numels[i]
                    else (piece * piece).sum(dtype=torch.float32))
        sq = sum_over_ranks(sq).to(d)
        norm = torch.sqrt(sum(sq.unbind()))
        trigger = norm < self.max_norm
        return {k: torch.where(trigger, s, (s / norm) * self.max_norm)
                for k, s in grads.items()}


def _swap_clips(tx, fn):
    """``tx`` with every ``clip_by_global_norm`` inside its chains and
    ``fp32_master`` wraps replaced by ``fn(clip)``."""
    if isinstance(tx, clip_by_global_norm):
        return fn(tx)
    if isinstance(tx, chain):
        return chain(*(_swap_clips(t, fn) for t in tx.transforms))
    if isinstance(tx, fp32_master):
        return fp32_master(_swap_clips(tx.inner, fn))
    return tx


class Zero1Optimizer:
    """ZeRO-1 around any chain of the port's transforms (ops/optim.py:
    ``AdamW``, ``SGD``, ``fp32_master`` of anything, ``chain`` nested or
    not, ``add_decayed_weights``, ``clip_by_global_norm`` at any place,
    or a transform of the caller's with ``init`` / ``update`` and
    per-parameter tensors in its state).  Each group of parameters is
    one flat vector and the whole optimizer runs on this rank's shard of
    it, as on one parameter per group, so every per-parameter state
    tensor is sharded and anything else (a count) is held by every rank
    (the JAX ``opt_spec`` walk over any optax state).  A transform must
    act element by element, as every optax transform but the clip does;
    the clip is swapped for :class:`_Zero1Clip`, which takes the global
    norm.

    Per step: the gradients (in their dtype ``d``) are laid into one fp32
    vector and reduce-scattered (summed, then divided by W) and the
    rank's shard is rounded to ``d``, which is what DDP's mean is cast
    back to.  With an active comm plane (``comm``, a ``GradSync``) the
    same reduce-scatter runs compressed, over the same shard boundaries:
    the vector plus the error-feedback residual, cut into the W shards
    and each zero-padded to whole blocks, goes through
    ``GradSync.zero1_reduce_scatter`` (a small whole group through the
    compressed psum), and the quantization error becomes the next
    residual.  The optimizer
    updates the rank's shard of the resident params (in their dtype; an
    ``fp32_master`` inside keeps its fp32 master shard in its state and
    writes it back cast), and the shards are all-gathered into the
    resident params: one ``all_gather_into_tensor``, or with the comm
    plane's ``param_gather`` / ``gather_bucket_bytes`` its explicit
    gather (``GradSync.regather_params``).  Every step but the clip is
    elementwise, so without a clip ZeRO-1 equals DDP bit for bit."""

    def __init__(self, tx, min_shard_elements: int = 0, comm=None):
        self.tx = tx
        self._tx = _swap_clips(tx, lambda c: _Zero1Clip(c, self))
        self.min_shard_elements = min_shard_elements
        self.comm = comm
        self.names: "list[str]" = []
        self.groups: "list[_Flat]" = []
        self.keys: "list[str]" = []
        self._dtype = torch.float32
        self._plans: list = []

    def init(self, params: Mapping[str, torch.Tensor]) -> Zero1State:
        self.names = list(params)
        dtypes = {p.dtype for p in params.values()}
        self._dtype = dtypes.pop() if len(dtypes) == 1 else torch.float32
        small = max(2, self.min_shard_elements)
        W, rank = world_size(), global_rank()
        item = torch.empty((), dtype=self._dtype).element_size()
        self.groups, self.keys = [], []
        for shards, r, keep, key in ((W, rank, lambda n: n >= small, _SHARD),
                                     (1, 0, lambda n: n < small, _WHOLE)):
            names = [k for k in self.names if keep(params[k].numel())]
            if names:
                self.groups.append(_Flat(names, [params[k].shape
                                                 for k in names],
                                         shards, r, item))
                self.keys.append(key)
        self._plans = [
            self.comm.zero1_gather_plan(g)
            if self.comm is not None and self.comm.explicit_gather
            and g.shards > 1 else None for g in self.groups]
        pseudo = {k: g.shard_of([params[n].detach() for n in g.names])
                  for g, k in zip(self.groups, self.keys)}
        return Zero1State(self.names, self.groups, self.keys,
                          self._tx.init(pseudo))

    def host_scalars(self, state: Zero1State, ahead: int = 0):
        return self._tx.host_scalars(state.inner, ahead)

    def advance(self, state: Zero1State, n: int) -> None:
        self._tx.advance(state.inner, n)

    def _grad_shards(self, grads, d) -> "dict[str, torch.Tensor]":
        if self.comm is not None:
            return self._comm_grad_shards(grads, d)
        W = world_size()
        out = {}
        for g, k in zip(self.groups, self.keys):
            flat = g.flatten([grads[n] for n in g.names])
            if group_active() and g.shards > 1:
                shard = flat.new_empty(g.size)
                dist.reduce_scatter_tensor(shard, flat)
                audit.note("reduce-scatter", flat, None, "zero1")
            else:
                shard = flat
                if group_active():
                    dist.all_reduce(shard)
                    audit.note("all-reduce", shard, None, "zero1")
            out[k] = shard.div_(W).to(d)
        return out

    def _comm_grad_shards(self, grads, d) -> "dict[str, torch.Tensor]":
        """The comm plane's sync (class docstring): each sharded group's
        gradients plus residual, as rows of the shard layout, through
        ``GradSync.zero1_reduce_scatter``, divided by W; a whole group's
        through the compressed psum; the new errors back into the
        residual."""
        comm = self.comm
        residual, key = comm.take()
        W = comm.world
        out = {}
        for i, (g, k) in enumerate(zip(self.groups, self.keys)):
            xs = [grads[n].float() + residual[n] if residual
                  else grads[n].float() for n in g.names]
            flat = g.flatten(xs)
            gkey = comm.group_key(key, i)
            if g.shards > 1:
                rows = flat.new_zeros(W, comm.zero1_chunk(g.size))
                rows[:, :g.size] = flat.view(W, g.size)
                shard, err = comm.zero1_reduce_scatter(rows, gkey,
                                                       bool(residual))
                out[k] = (shard[:g.size] / W).to(d)
                if residual:
                    err = err[:, :g.size].reshape(-1)
            else:
                res = comm.mean_psum(flat[:g.n], gkey, bool(residual))
                mean, err = res if residual else (res, None)
                out[k] = mean.to(d)
            if residual:
                for n, e in g.unflatten(err).items():
                    residual[n].copy_(e)
        return out

    def comm_wire_bytes(self) -> "dict[str, int]":
        """What one step of the comm plane records, by tag: the gradient
        sync (``"grad_sync"``) and, with an explicit gather,
        ``"param_gather"``; else the plain gather (``"zero1"``)."""
        comm = self.comm
        grads = comm.zero1_grad_wire_bytes([(g.shards, g.size)
                                            for g in self.groups])
        out = {"grad_sync": grads["ici"] + grads["dcn"],
               "param_gather": 0, "zero1": 0}
        for g, plan in zip(self.groups, self._plans):
            if plan is not None:
                out["param_gather"] += comm.zero1_gather_wire_bytes(g, plan)
            elif g.shards > 1:
                out["zero1"] += g.size * g.shards * g.itemsize
        return out

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: Zero1State,
               params: Mapping[str, torch.Tensor],
               scalars: "torch.Tensor | None" = None) -> None:
        dtypes = {g.dtype for g in grads.values()}
        if len(dtypes) != 1:
            raise ValueError(f"ZeRO-1 takes gradients of one dtype, got "
                             f"{sorted(map(str, dtypes))}")
        d = dtypes.pop()
        resident = {k: g.shard_of([params[n] for n in g.names], self._dtype)
                    for g, k in zip(self.groups, self.keys)}
        self._tx.update(self._grad_shards(grads, d), state.inner, resident,
                        scalars)
        for g, k, plan in zip(self.groups, self.keys, self._plans):
            shard = resident[k]
            if plan is None:
                full = state._full(g, shard)
                if g.shards > 1:
                    audit.note("all-gather", full, None, "zero1")
            else:
                full = shard.new_empty(g.size * g.shards)
                self.comm.regather_params(g, plan, shard, full)
            for n, v in g.unflatten(full).items():
                params[n].copy_(v)


class AutoStrategy(ShardingStrategy):
    """``Trainer(strategy="auto")``: the planner plane (plan/) resolves
    it into a concrete strategy, plus a comm policy, a microbatch and a
    remat policy, once the module, example batch and world are known
    (core/trainer.py ``_resolve_auto_strategy``).  Carries an optional
    ``PlanConfig`` override and nothing else, so it pickles to the
    workers; used unresolved it raises."""

    name = "auto"

    def __init__(self, plan=None):
        self.plan = plan

    def mesh_shape(self, n_ranks: int, batch_hint: "int | None" = None
                   ) -> dict:
        raise RuntimeError(
            "strategy='auto' must be resolved by the planner before a "
            "mesh can be built (Trainer._resolve_auto_strategy); "
            "constructing AutoStrategy outside a Trainer is unsupported")

    def build_mesh(self, batch_hint: "int | None" = None):
        return self.mesh_shape(0, batch_hint)

    def __repr__(self):
        return f"AutoStrategy({self.plan!r})"


_STRATEGIES = {
    "auto": AutoStrategy,
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
_NOT_PORTED = {"mpmd": 11}


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


__all__ = ["AutoStrategy", "DataParallelStrategy", "FullyShardedStrategy", "P",
           "PartitionSpec", "ShardingStrategy", "SpmdStrategy",
           "Zero1Optimizer",
           "Zero1State", "Zero1Strategy", "average_grads", "batch_moments",
           "exchange_rows", "gather_objects",
           "global_rank", "group_active", "mean_over_ranks", "resolve_strategy", "strategy_names",
           "sum_over_ranks", "world_size"]
