"""Sharded parameters: where each rank's piece of every parameter lives,
how a use site gathers it, and how its gradient goes back.

Counterpart of what the JAX package's ``state_shardings`` asks of XLA
(``ray_lightning_tpu/parallel/strategy.py:111-123``): there a
``NamedSharding`` per leaf and GSPMD does the rest.  Here
:class:`ShardLayout` answers each parameter's spec on its flax path
(``convert.flax_path``, so one rule set serves both packages), in the
flax layout, and lays it onto the torch tensor:

- a spec entry names the mesh axes a dim is split over, the first axis
  outermost; this rank holds the block its coordinates on those axes
  select, and only that block (:meth:`ShardLayout.apply` slices the
  model's full-size init in place, so the weights equal the unsharded
  init of the same seed);
- the fused ``attn.qkv`` weight [3C, C] and bias [3C] are seen as
  [3, C, C] and [3, C] (their *storage* shape), the split falling on
  the C of each third: a rank holds whole heads of each of q, k and v,
  under FSDP as under tensor parallelism, so both are one chunk at a
  global offset of the same storage shape and a checkpoint moves
  between them;
- at a use site (:func:`gathered`) the pieces on the batch axes
  (``data``, ``fsdp``) are all-gathered, through an autograd function
  whose backward is the gradient's reduce-scatter: summed in fp32 over
  those axes (and all-reduced over the batch axes the parameter is not
  split over), divided by the number of batch shards and cast back, as
  DDP's mean (parallel/strategy.py ``average_grads``).  Under remat the
  recompute gathers again: nothing gathered outlives its block.  The
  ``tensor`` axis is not gathered: the model computes on its piece
  (parallel/tensor.py), and raises at set-up (:meth:`ShardLayout.
  check_tensor_plan`) when a rule set splits anything it cannot.  Nor
  are the ``expert`` and ``stage`` axes: a rank holds its experts
  (ops/moe.py) or its stage's layers (parallel/pipeline.py) and uses
  them as they are;
- :meth:`grad_sync` averages the gradients of the parameters that are
  not gathered (whole on every batch shard) over the batch group in one
  fp32 buffer, as DDP does.  On a ``sequence`` axis over 1 the mean
  runs over the batch axes and the sequence: each sequence rank's
  gradient is its slice's share of the whole sequence's (the loss is
  averaged over the sequence ranks forward, the identity backward,
  parallel/tensor.py ``mean_from``).  Over ``expert``, ``tensor`` and
  ``stage`` no gradient is averaged: their ranks compute the same
  gradients of what they share (the routed layer's and the pipeline's
  collectives sum the parts in their backward).

So without a clip ``"fsdp"`` equals ``"ddp"`` bit for bit: at W=2 every
gradient element is ``(a + b) / 2`` of the same two fp32 terms either
way, and the update is elementwise on identical values.

:class:`ShardedOptimizer` runs the module's optimizer on the rank's
pieces: the fp32 master and the moments are sharded as the parameters
are (the JAX ``opt_spec``), and a ``clip_by_global_norm`` takes the
norm over the whole model (each piece counted once).  Its state speaks
the single-device layout to ``state_dict`` / ``load_state_dict``
(collective), so a ``.ckpt`` file moves between strategies and world
sizes, and the sharded checkpoint (utils/checkpoint.py) takes every
piece with its global offsets (:meth:`ShardLayout.dtensor`).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from ray_lightning_tpu_torch.convert import flax_path
from ray_lightning_tpu_torch.ops.optim import chain, clip_by_global_norm
from ray_lightning_tpu_torch.parallel.mesh import (Mesh, all_gather_along,
                                                   all_reduce,
                                                   reduce_scatter_along)

#: parameters whose leading dim is three heads' worth of columns (q|k|v)
#: (a layer-stacked ``blocks.`` tensor's leading dim is its layers)
_FUSED_QKV = re.compile(r"^(?!blocks\.)(.*\.)?attn\.qkv\.(weight|bias)$")
#: the ROADMAP.md queue 1 item the unported parts belong to
ITEM = 9
#: axes a rank's piece is used on as it is (never gathered): its
#: experts, its pipeline stage's layers
LOCAL_AXES = ("expert", "stage")
#: the parameters whose dim 0 is a routed layer's experts
_EXPERTS = re.compile(r"(^|\.)moe\.w[12]$")


def _entries(spec, ndim: int) -> "list[tuple[str, ...]]":
    """A spec as one tuple of axis names per dim (padded with ``()``)."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        out.append(() if e is None else
                   tuple(e) if isinstance(e, (tuple, list)) else (e,))
    return out


@dataclasses.dataclass(eq=False)
class ParamShard:
    """One parameter's place on the mesh (module docstring).  Shapes are
    the torch layout's: ``shape`` the whole parameter, ``storage`` its
    storage shape, ``local_storage`` this rank's block of it,
    ``use_storage`` the block after the use site's gather (whole but on
    ``tensor``); ``axes[d]`` the mesh axes storage dim ``d`` is split
    over; ``gather`` the ``(axis, dim)`` pairs gathered at use."""

    name: str
    path: str
    spec: tuple
    shape: tuple
    storage: tuple
    axes: "list[tuple[str, ...]]"
    local_storage: tuple
    use_storage: tuple
    gather: "list[tuple[str, int]]"
    #: storage dim split on ``tensor`` (``None``: whole on every tensor
    #: rank)
    tensor_dim: "int | None"
    #: this rank counts its block once in a model-wide sum (coordinate 0
    #: on every axis the parameter is not split over)
    owner: bool
    groups: dict = dataclasses.field(default_factory=dict, repr=False)
    grad_group: object = dataclasses.field(default=None, repr=False)
    denom: int = 1

    @property
    def local_shape(self) -> tuple:
        """The torch parameter's shape on this rank."""
        return _torch_shape(self.shape, self.storage, self.local_storage)

    @property
    def use_shape(self) -> tuple:
        return _torch_shape(self.shape, self.storage, self.use_storage)

    @property
    def sharded(self) -> bool:
        return self.local_storage != self.storage


def _seq(mesh: Mesh) -> "tuple[str, ...]":
    """``("sequence",)`` when the mesh has that axis: the one axis
    beside the batch's that a gradient is averaged over."""
    return ("sequence",) if "sequence" in mesh.axis_names else ()


def _torch_shape(shape: tuple, storage: tuple, block: tuple) -> tuple:
    """A storage block in the torch layout: a fused qkv block [3, c, ...]
    as [3c, ...]."""
    if len(storage) == len(shape):
        return tuple(block)
    return (block[0] * block[1],) + tuple(block[2:])


class _Gather(torch.autograd.Function):
    """The use-site all-gather of a parameter's pieces (module
    docstring); its backward is the gradient's reduce-scatter."""

    @staticmethod
    def forward(ctx, local, info: ParamShard):
        ctx.info = info
        x = local.reshape(info.local_storage)
        for axis, dim in reversed(info.gather):
            x = all_gather_along(x, dim, info.groups[axis])
        return x.reshape(info.use_shape)

    @staticmethod
    def backward(ctx, g):
        info = ctx.info
        x = g.float().reshape(info.use_storage)
        for axis, dim in info.gather:
            x = reduce_scatter_along(x, dim, info.groups[axis])
        x = all_reduce(x, info.grad_group)
        return x.div_(info.denom).to(g.dtype).reshape(info.local_shape), None


def gathered(p: torch.Tensor) -> torch.Tensor:
    """``p`` as its use site takes it: the parameter itself, or, for a
    parameter split over batch axes, its pieces gathered (differentiably:
    :class:`_Gather`)."""
    info = getattr(p, "_rlt_shard", None)
    if info is None or not info.gather:
        return p
    return _Gather.apply(p, info)


class ShardLayout:
    """Every parameter's :class:`ParamShard` under ``strategy`` on
    ``mesh``, from ``shapes`` (name -> torch shape; an abstract mesh
    gives the specs and sizes without a process group)."""

    def __init__(self, shapes: "Mapping[str, tuple]", strategy, mesh: Mesh):
        self.mesh = mesh
        self.params: "dict[str, ParamShard]" = {}
        for name, shape in shapes.items():
            self.params[name] = self._place(name, tuple(shape), strategy)
        self.names = list(self.params)

    @classmethod
    def of_model(cls, model: nn.Module, strategy, mesh: Mesh
                 ) -> "ShardLayout":
        return cls({k: tuple(p.shape) for k, p in model.named_parameters()},
                   strategy, mesh)

    def _place(self, name: str, shape: tuple, strategy) -> ParamShard:
        mesh = self.mesh
        path, perm = flax_path(name)
        jshape = list(shape)
        if perm is not None:
            for i, p in enumerate(perm):
                jshape[p] = shape[i]
        spec = tuple(strategy.param_spec(mesh, path, tuple(jshape)))
        flax_axes = _entries(spec, len(shape))
        axes = [flax_axes[perm[i]] if perm is not None else flax_axes[i]
                for i in range(len(shape))]
        storage = shape
        if _FUSED_QKV.search(name):
            if shape[0] % 3:
                raise ValueError(f"{name}: {shape} is not three thirds")
            storage = (3, shape[0] // 3) + shape[1:]
            axes = [()] + axes
        for d, names in enumerate(axes):
            for a in names:
                if a not in mesh.axis_names:
                    raise ValueError(f"{name}: spec {spec} names axis {a!r}, "
                                     f"which the mesh {mesh.axis_names} "
                                     f"lacks")
            if list(names) != [a for a in mesh.axis_names if a in names]:
                raise ValueError(
                    f"{name}: spec {spec} splits a dim over {names}, not in "
                    f"the mesh's order {mesh.axis_names}")
            n = mesh.size(*names)
            if storage[d] % n:
                raise ValueError(
                    f"{name}: dim of {storage[d]} does not split over "
                    f"{names} ({n} pieces); the port takes even pieces")
        local, use, gather, tensor_dim = [], [], [], None
        for d, names in enumerate(axes):
            n = mesh.size(*names)
            local.append(storage[d] // n)
            use.append(storage[d] // mesh.size(*(a for a in names
                                                 if a == "tensor")))
            for a in names:
                if mesh.shape[a] <= 1:
                    continue
                if a == "tensor":
                    if len([b for b in names if mesh.shape[b] > 1]) > 1:
                        raise NotImplementedError(
                            f"{name}: a dim split over 'tensor' and "
                            f"another axis ({names}) is not ported "
                            f"(ROADMAP.md queue 1 item {ITEM})")
                    tensor_dim = d
                elif a in mesh.batch_axes:
                    gather.append((a, d))
                elif a not in LOCAL_AXES:
                    raise ValueError(
                        f"{name}: spec {spec} splits a parameter over "
                        f"{a!r}; an {a!r} axis splits activations only")
        split = {a for names in axes for a in names}
        owner = all(mesh.coords.get(a, 0) == 0 for a in mesh.axis_names
                    if a not in split and mesh.shape[a] > 1)
        info = ParamShard(name, path, spec, shape, tuple(storage), axes,
                          tuple(local), tuple(use), gather, tensor_dim,
                          owner)
        if mesh._groups or mesh.world == 1:
            info.groups = {a: mesh.group(a) for a, _ in gather}
            rest = [a for a in mesh.batch_axes + _seq(mesh)
                    if a not in {g for g, _ in gather}]
            info.grad_group = mesh.group(*rest) if gather else None
            info.denom = mesh.batch_size * mesh.size(*_seq(mesh))
        return info

    # -- the model ---------------------------------------------------------

    @property
    def any_sharded(self) -> bool:
        return any(i.sharded for i in self.params.values())

    @property
    def tensor_parallel(self) -> bool:
        return any(i.tensor_dim is not None for i in self.params.values())

    def check_tensor_plan(self, model: nn.Module) -> None:
        """Raise unless the parameters split on ``tensor`` are exactly the
        ones the model computes on in pieces, each on its dim
        (``model.tensor_parallel_dims()``, flax layout); none split is
        fine (every tensor rank then holds the whole model)."""
        split = {n: i for n, i in self.params.items()
                 if i.tensor_dim is not None}
        if not split:
            return
        plan = getattr(model, "tensor_parallel_dims", None)
        if plan is None:
            raise NotImplementedError(
                f"{type(model).__name__} has no tensor-parallel forward; "
                f"the rules split {sorted(split)[:4]} on 'tensor'")
        want = plan()
        for name, info in split.items():
            flax_dim = next(d for d, e in enumerate(
                _entries(info.spec, len(info.shape))) if "tensor" in e)
            if name not in want or want[name] != flax_dim:
                raise ValueError(
                    f"the rule set splits {name} (flax {info.path}) on "
                    f"'tensor' along dim {flax_dim}; the model's forward "
                    f"takes only {sorted(want.items())[:6]}...")
        missing = sorted(set(want) - set(split))
        if missing:
            raise ValueError(
                f"the rule set splits {sorted(split)[:3]} on 'tensor' but "
                f"not {missing[:4]}: the model's forward needs all of "
                f"{len(want)} split, or none")

    def check_local_plan(self, model: nn.Module) -> None:
        """Raise unless every parameter split on ``expert`` or ``stage``
        (over 1) is one the model uses in pieces along dim 0: a routed
        layer's ``w1`` / ``w2`` (its experts, ops/moe.py), a pipelined
        model's stacked ``blocks.`` tensors (its layers,
        models/pipeline_gpt.py)."""
        for name, info in self.params.items():
            for d, names in enumerate(info.axes):
                for a in names:
                    if a not in LOCAL_AXES or self.mesh.shape[a] <= 1:
                        continue
                    ok = d == 0 and (
                        _EXPERTS.search(name) if a == "expert" else
                        name.startswith("blocks.")
                        and getattr(model, "stacked_blocks", False))
                    if not ok:
                        raise ValueError(
                            f"the rule set splits {name} (flax "
                            f"{info.path}) on {a!r} along dim {d}; "
                            f"{type(model).__name__} uses pieces on "
                            f"{a!r} only of "
                            + ("its routed layers' w1 / w2, dim 0"
                               if a == "expert" else
                               "a pipelined model's stacked blocks, "
                               "dim 0"))

    def apply(self, model: nn.Module) -> None:
        """Cut every parameter of ``model`` (full size, initialised) to
        this rank's block in place, tag it for :func:`gathered`, and give
        the model's tensor-parallel, sequence-parallel and routed modules
        their groups (``tp``, ``sp``, ``ep``)."""
        if self.any_sharded and not getattr(model, "shardable", False):
            raise NotImplementedError(
                f"{type(model).__name__} does not gather sharded "
                f"parameters at its use sites; shard GPT, PipelinedGPT, BERT or the "
                f"test models (ROADMAP.md queue 1 item {ITEM})")
        self.check_tensor_plan(model)
        self.check_local_plan(model)
        with torch.no_grad():
            for name, p in model.named_parameters():
                info = self.params[name]
                p.data = self.local_of(name, p.data)
                p._rlt_shard = info
        from ray_lightning_tpu_torch.parallel.mesh import axis_group
        if self.tensor_parallel:
            tp = axis_group("tensor", self.mesh)
            for mod in model.modules():
                if hasattr(mod, "tp"):
                    mod.tp = tp
        sp = axis_group("sequence", self.mesh)
        for mod in model.modules():
            if hasattr(mod, "sp"):
                mod.sp = sp
        ep = axis_group("expert", self.mesh)
        for prefix, mod in model.named_modules():
            # a routed layer whose experts this rank holds a part of
            if hasattr(mod, "ep") and any(
                    "expert" in names for names in
                    self.params[f"{prefix}.w1"].axes):
                mod.ep = ep

    def local_of(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``full`` (a copy)."""
        info = self.params[name]
        if not info.sharded:
            return full.clone()
        x = full.reshape(info.storage)
        for d, names in enumerate(info.axes):
            n = info.local_storage[d]
            if n != info.storage[d]:
                x = x.narrow(d, self.mesh.index(*names) * n, n)
        return x.reshape(info.local_shape).clone()

    def full_tensor(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block (collective over the
        axes it is split on; the block itself when it is whole)."""
        info = self.params[name]
        if not info.sharded:
            return local
        x = local.reshape(info.local_storage)
        for d in range(len(info.axes) - 1, -1, -1):
            for a in reversed(info.axes[d]):
                x = all_gather_along(x, d, self.mesh.group(a))
        return x.reshape(info.shape)

    @torch.no_grad()
    def load_full_state_dict(self, model: nn.Module,
                             state: "Mapping[str, torch.Tensor]") -> None:
        """``model.load_state_dict`` of whole tensors: each parameter
        takes this rank's block."""
        live = dict(model.named_parameters())
        local = {k: (self.local_of(k, v) if k in live else v)
                 for k, v in state.items()}
        model.load_state_dict(local)

    # -- sums over the model ----------------------------------------------

    def grad_sync(self) -> Optional[Callable]:
        """``grads -> grads`` for the parameters :func:`gathered` leaves
        whole: their mean over the batch shards (and the sequence ranks)
        in one fp32 buffer, as DDP's (the gathered ones are synced in
        their gather's backward); ``None`` with one batch shard and one
        sequence rank."""
        mesh = self.mesh
        group = mesh.group(*mesh.batch_axes + _seq(mesh))
        if group is None:
            return None
        whole = [not self.params[n].gather for n in self.names]
        denom = mesh.batch_size * mesh.size(*_seq(mesh))

        def sync(grads):
            idx = [i for i, w in enumerate(whole) if w]
            if not idx:
                return grads
            flat = torch.cat([grads[i].reshape(-1).float() for i in idx])
            flat = all_reduce(flat, group).div_(denom)
            out, off = list(grads), 0
            for i in idx:
                n = grads[i].numel()
                out[i] = flat[off:off + n].view(grads[i].shape).to(
                    grads[i].dtype)
                off += n
            return out

        return sync

    def global_sum(self, values: "Mapping[str, torch.Tensor]"
                   ) -> torch.Tensor:
        """``sum`` over the whole model of a per-parameter fp32 scalar
        computed on this rank's blocks, each block counted once."""
        dev = next(iter(values.values())).device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for k, v in values.items():
            if self.params[k].owner:
                total = total + v
        if self.mesh.world > 1:
            total = all_reduce(total, dist.group.WORLD)
        return total

    def local_bytes(self, dtypes: "Mapping[str, int] | int") -> int:
        """Bytes of this rank's blocks at ``dtypes`` bytes an element (a
        name -> size map, or one size)."""
        out = 0
        for k, i in self.params.items():
            b = dtypes if isinstance(dtypes, int) else dtypes[k]
            out += math.prod(i.local_storage) * b
        return out

    # -- checkpoints -------------------------------------------------------

    def dtensor(self, name: str, local: torch.Tensor):
        """``local`` (this rank's block, on the CPU) as a DTensor of the
        storage shape over the checkpoint mesh, for
        ``torch.distributed.checkpoint`` (each block with its global
        offsets); the tensor itself at one rank."""
        info = self.params[name]
        if self.mesh.world == 1:
            return local.reshape(info.storage)
        from torch.distributed.tensor import DTensor, Replicate, Shard
        ckpt_mesh, _ = self.mesh.checkpoint_mesh()
        placements = []
        for a in self.mesh.axis_names:
            dims = [d for d, names in enumerate(info.axes) if a in names]
            placements.append(Shard(dims[0]) if dims else Replicate())
        stride = [1] * len(info.storage)
        for d in range(len(info.storage) - 2, -1, -1):
            stride[d] = stride[d + 1] * info.storage[d + 1]
        return DTensor.from_local(local.reshape(info.local_storage),
                                  ckpt_mesh, placements, run_check=False,
                                  shape=torch.Size(info.storage),
                                  stride=tuple(stride))

    def from_storage(self, name: str, value) -> torch.Tensor:
        """A checkpoint's restored :meth:`dtensor` as this rank's block in
        the torch layout."""
        local = value.to_local() if hasattr(value, "to_local") else value
        return local.reshape(self.params[name].local_shape)


def map_param_dicts(tree, names, fn):
    """``tree`` (an optimizer's nested state dict) with ``fn(name,
    tensor)`` applied inside every dict keyed by exactly the parameter
    ``names`` (the moments, the master, the trace)."""
    if isinstance(tree, dict):
        if tree and set(tree) == set(names):
            return {k: fn(k, v) for k, v in tree.items()}
        return {k: map_param_dicts(v, names, fn) for k, v in tree.items()}
    return tree


# -- the optimizer on the pieces ------------------------------------------

class _ShardedClip:
    """``clip_by_global_norm`` over sharded gradients: the norm is the
    square root of the model-wide sum of ``g * g`` (each block counted
    once, in fp32, then the sum over every rank), each gradient scaled
    as the unsharded clip scales it."""

    def __init__(self, clip: clip_by_global_norm, layout: ShardLayout):
        self.max_norm = clip.max_norm
        self.layout = layout

    def init(self, params):
        return clip_by_global_norm(self.max_norm).init(params)

    @torch.no_grad()
    def update(self, grads, state, params=None):
        sq = {k: (g.float() * g.float()).sum() for k, g in grads.items()}
        norm = torch.sqrt(self.layout.global_sum(sq))
        trigger = norm < self.max_norm
        return {k: torch.where(trigger, g,
                               (g / norm.to(g.dtype)) * self.max_norm)
                for k, g in grads.items()}


class ShardedOptState:
    """The state of :class:`ShardedOptimizer`: the module optimizer's
    state over the rank's blocks (``inner``); :meth:`state_dict` and
    :meth:`load_state_dict` speak the single-device layout (collective),
    :meth:`sharded_state_dict` / :meth:`load_sharded_state_dict` the
    checkpoint's (each block with its offsets)."""

    def __init__(self, inner, layout: ShardLayout):
        self.inner = inner
        # bound methods: a graph capture's walk over the state's tensors
        # (core/steps.py ``_state_tensors``) skips callables
        self._full = layout.full_tensor
        self._local = layout.local_of
        self._dtensor = layout.dtensor
        self._from_storage = layout.from_storage
        self._names = frozenset(layout.names)

    def _map(self, tree, fn):
        return map_param_dicts(tree, self._names, fn)

    def state_dict(self) -> dict:
        return self._map(self.inner.state_dict(),
                         lambda k, v: self._full(k, v))

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(self._map(state, self._local))

    def sharded_state_dict(self, stage: Callable) -> dict:
        """The state with every per-parameter tensor ``stage``d (a host
        copy) and wrapped as its storage-shaped DTensor."""
        return self._map(self.inner.state_dict(),
                         lambda k, v: self._dtensor(k, stage(v)))

    def load_sharded_state_dict(self, state: dict, device) -> None:
        self.inner.load_state_dict(self._map(
            state, lambda k, v: self._from_storage(k, v).to(device)))


class ShardedOptimizer:
    """The module's optimizer over the rank's parameter blocks (module
    docstring); its :meth:`bind` takes the layout once the parameters
    are cut, before :meth:`init`."""

    def __init__(self, tx):
        self.tx = tx
        self.layout: "ShardLayout | None" = None

    def bind(self, layout: ShardLayout) -> None:
        self.layout = layout
        tx = self.tx
        if isinstance(tx, chain) and isinstance(tx.transforms[0],
                                                clip_by_global_norm):
            self.tx = chain(_ShardedClip(tx.transforms[0], layout),
                            *tx.transforms[1:])

    def init(self, params: "Mapping[str, torch.Tensor]") -> ShardedOptState:
        if self.layout is None:
            raise RuntimeError("ShardedOptimizer.init before bind(layout)")
        return ShardedOptState(self.tx.init(params), self.layout)

    def host_scalars(self, state: ShardedOptState, ahead: int = 0):
        return self.tx.host_scalars(state.inner, ahead)

    def advance(self, state: ShardedOptState, n: int) -> None:
        self.tx.advance(state.inner, n)

    def update(self, grads, state: ShardedOptState, params,
               scalars: "torch.Tensor | None" = None) -> None:
        self.tx.update(grads, state.inner, params, scalars)


__all__ = ["ParamShard", "ShardLayout", "ShardedOptState",
           "ShardedOptimizer", "gathered", "map_param_dicts"]
