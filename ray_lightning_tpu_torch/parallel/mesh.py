"""The process group's ranks shaped into named axes, and the collectives
the sharded strategies issue along them.

Counterpart of ``ray_lightning_tpu/parallel/mesh.py``
(``_infer_axis_sizes``, ``build_device_mesh``, ``mesh_axis_size``,
``data_and_tensor_axes``, ``set_current_mesh`` / ``get_current_mesh``).
There a mesh is a ``jax.sharding.Mesh`` over every chip and XLA lowers
the sharding annotations to collectives along its axes.  Here one rank is
one card (or one CPU worker): :func:`build_device_mesh` lays the ranks of
the default process group out row-major over the axes, outermost first,
so the innermost axis (``tensor``) joins consecutive ranks, which are
one node's cards on its NVLink.  Each axis gets its process group from
``torch.distributed.device_mesh.init_device_mesh`` (``"cuda"`` under
NCCL, ``"cpu"`` under gloo); the axes a batch is split over (``data``,
``fsdp``) get one more group together.  Without a process group the
mesh is one rank with every axis 1.

The collectives (:func:`all_gather_along`, :func:`reduce_scatter_along`,
:func:`all_reduce`) take the form the group's backend runs: NCCL's
``all_gather_into_tensor`` / ``reduce_scatter_tensor``; under gloo the
list ``all_gather``, and on CUDA tensors the reduce-scatter composed as
an ``all_reduce`` and the rank's slice (gloo has no reduce-scatter of
CUDA tensors; the JAX package's CPU lowering composes it the same way,
``ray_lightning_tpu/parallel/strategy.py:289-293``).  Gloo reduces
bf16 and fp16 in fp32.  :func:`ppermute_along` is ``lax.ppermute``'s
ring shift along one axis (ring attention, the pipeline's hops): under
NCCL one ``batch_isend_irecv`` of the send and the receive, so a ring of
two cannot deadlock; under gloo the same pair on host copies (gloo's
``send`` / ``recv`` take CPU tensors).  Each form is logged once, when
it first runs.

The axes follow the JAX order, ``("data", "fsdp", "expert",
"sequence", "tensor")`` for ``SpmdStrategy`` and ``("data", "stage")``
for the pipeline; the batch axes and ``sequence`` get one more group
together, the group a sequence-parallel gradient is averaged over.
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_log = logging.getLogger(__name__)

#: the axes a batch's leading dim may be split over, outermost first
BATCH_AXES = ("data", "fsdp")


def _infer_axis_sizes(n_devices: int, axis_sizes: dict,
                      axis_names: Sequence[str]) -> "list[int]":
    """Fill in at most one -1/None axis so the product equals
    ``n_devices`` (the JAX function)."""
    sizes = [axis_sizes.get(name, None) for name in axis_names]
    known = [s for s in sizes if s not in (None, -1)]
    unknown = [i for i, s in enumerate(sizes) if s in (None, -1)]
    prod = math.prod(known) if known else 1
    if len(unknown) > 1:
        raise ValueError(f"At most one axis may be inferred, got {axis_sizes}")
    if unknown:
        if n_devices % prod != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes {axis_sizes}")
        sizes[unknown[0]] = n_devices // prod
    elif prod != n_devices:
        raise ValueError(
            f"Mesh axes {dict(zip(axis_names, sizes))} need {prod} devices, "
            f"have {n_devices}")
    return [int(s) for s in sizes]


class Mesh:
    """Named axes over the ranks: ``axis_names`` (outermost first),
    ``shape`` (name -> size), and for this rank its ``rank`` and
    ``coords`` (name -> index).  :meth:`group` is the process group of
    the ranks that differ from this one along the named axes only
    (``None`` when they are this rank alone).  A mesh made by
    :meth:`abstract` has sizes and no groups: the sharding specs read
    nothing else."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int],
                 rank: int = 0, groups: "dict | None" = None,
                 backend: "str | None" = None, device_mesh=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.rank = int(rank)
        idx = np.unravel_index(self.rank, tuple(self.shape.values())) \
            if self.shape else ()
        self.coords = {a: int(i) for a, i in zip(self.axis_names, idx)}
        self._groups = dict(groups or {})
        self.backend = backend
        #: ``torch.distributed.device_mesh.DeviceMesh`` of the compute
        #: groups (``None`` at one rank)
        self.device_mesh = device_mesh
        self._ckpt = None

    @classmethod
    def abstract(cls, axis_names: Sequence[str], sizes: dict) -> "Mesh":
        """Axes and sizes only, for the specs (and the tests that compare
        them with the JAX package's)."""
        names = tuple(axis_names)
        return cls(names, [int(sizes.get(a, 1)) for a in names])

    @property
    def world(self) -> int:
        return math.prod(self.shape.values())

    def size(self, *names: str) -> int:
        """The product of the named axes' sizes (absent axes count 1)."""
        return math.prod(self.shape.get(n, 1) for n in names)

    def index(self, *names: str) -> int:
        """This rank's row-major index over the named axes (in mesh
        order)."""
        out = 0
        for a in self.axis_names:
            if a in names:
                out = out * self.shape[a] + self.coords[a]
        return out

    def members(self, *names: str, rank: "int | None" = None
                ) -> "list[int]":
        """The global ranks that share ``rank``'s coordinates on every
        axis but ``names``, in row-major order over ``names``."""
        sizes = tuple(self.shape.values())
        base = np.unravel_index(self.rank if rank is None else rank, sizes)
        grid = np.arange(self.world).reshape(sizes)
        sel = tuple(slice(None) if a in names else int(base[i])
                    for i, a in enumerate(self.axis_names))
        return [int(r) for r in grid[sel].reshape(-1)]

    def group(self, *names: str):
        """The process group along ``names`` (``None`` when its size is
        1: nothing to communicate)."""
        names = tuple(a for a in self.axis_names
                      if a in names and self.shape[a] > 1)
        if not names:
            return None
        try:
            return self._groups[names]
        except KeyError:
            raise RuntimeError(f"mesh {self.shape} has no group along "
                               f"{names}") from None

    # -- the batch ---------------------------------------------------------

    @property
    def batch_axes(self) -> "tuple[str, ...]":
        return tuple(a for a in BATCH_AXES if a in self.axis_names)

    @property
    def batch_size(self) -> int:
        """How many shards a global batch is split into."""
        return self.size(*self.batch_axes)

    @property
    def batch_index(self) -> int:
        """This rank's shard of the global batch."""
        return self.index(*self.batch_axes)

    def batch_leaders(self) -> "list[int]":
        """One global rank per batch shard (the one at coordinate 0 on
        every other axis), in batch order: the ranks whose predictions
        are kept (the others hold the same rows)."""
        return self.members(*self.batch_axes, rank=0)

    # -- checkpoints -------------------------------------------------------

    def checkpoint_mesh(self):
        """``(DeviceMesh over the CPU, gloo group of every rank)`` for
        ``torch.distributed.checkpoint`` (utils/checkpoint.py): the
        DTensors of a save's host copies live on the mesh, its planner's
        collectives run on the group, which is the checkpoints' own, so
        a save's thread never shares a group with the training steps.
        Under gloo the compute mesh serves (DCP reads only its
        coordinates); under NCCL gloo twins of the axis groups are made.
        Made on first use, a collective call: every rank makes them in
        the same order."""
        if self._ckpt is None:
            if self.backend == "gloo":
                mesh = self.device_mesh
            else:
                from torch.distributed.device_mesh import DeviceMesh
                groups = [_axis_groups(self, (a,), backend="gloo")[(a,)]
                          for a in self.axis_names]
                mesh = DeviceMesh.from_group(
                    groups, "cpu", mesh=torch.arange(self.world).reshape(
                        tuple(self.shape.values())),
                    mesh_dim_names=self.axis_names)
            self._ckpt = (mesh, dist.new_group(backend="gloo"))
        return self._ckpt

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _axis_groups(mesh: Mesh, names: "tuple[str, ...]",
                 backend: "str | None" = None) -> dict:
    """``{names: group}`` of this rank along ``names``: every rank makes
    every group of that partition, in the same order (``new_group`` is
    collective)."""
    mine = None
    seen = set()
    for r in range(mesh.world):
        ranks = tuple(mesh.members(*names, rank=r))
        if ranks in seen:
            continue
        seen.add(ranks)
        g = dist.new_group(list(ranks), backend=backend)
        if mesh.rank in ranks:
            mine = g
    return {tuple(names): mine}


def build_device_mesh(axis_names: Sequence[str] = ("data",),
                      axis_sizes: "dict | None" = None) -> Mesh:
    """The mesh of the default process group (module docstring): one
    axis may be -1/absent to take the rest of the ranks; without a
    process group every axis must be 1 (one rank)."""
    from ray_lightning_tpu_torch.parallel.strategy import (global_rank,
                                                           group_active,
                                                           world_size)
    names = tuple(axis_names)
    sizes = _infer_axis_sizes(world_size(), dict(axis_sizes or {}), names)
    if not group_active():
        return Mesh(names, sizes)
    backend = str(dist.get_backend())
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                          tuple(sizes), mesh_dim_names=names)
    mesh = Mesh(names, sizes, global_rank(), backend=backend,
                device_mesh=dm)
    groups = {(a,): dm.get_group(a) for a in names}
    batch = tuple(a for a in BATCH_AXES if a in names and mesh.shape[a] > 1)
    if len(batch) > 1:
        groups.update(_axis_groups(mesh, batch))
    if mesh.shape.get("sequence", 1) > 1:
        # a sequence-parallel gradient's mean runs over the batch axes
        # and the sequence (with those a use site gathered left out)
        for sub in ((batch[:1], batch[1:], batch) if len(batch) > 1
                    else (batch,) if batch else ()):
            groups.update(_axis_groups(mesh, sub + ("sequence",)))
    mesh._groups = {k: v for k, v in groups.items()
                    if mesh.size(*k) > 1}
    return mesh


def mesh_axis_size(mesh: Mesh, *names: str) -> int:
    """Product of the sizes of the given axes present in the mesh."""
    return mesh.size(*(n for n in names if n in mesh.axis_names))


def data_and_tensor_axes(mesh: Mesh):
    """``(data_axes, tensor_axis)`` present in ``mesh``: the batch and
    head layout of the tensor-parallel attention."""
    dp = tuple(a for a in BATCH_AXES if a in mesh.axis_names) or None
    tensor = "tensor" if "tensor" in mesh.axis_names else None
    return dp, tensor


# The trainer publishes its mesh here for the stage; thread-local, as
# concurrent Tune trials each run a Trainer in a thread of their own.
_MESH_TLS = threading.local()


def set_current_mesh(mesh: Optional[Mesh]) -> None:
    _MESH_TLS.mesh = mesh


def get_current_mesh() -> Optional[Mesh]:
    return getattr(_MESH_TLS, "mesh", None)


def axis_group(axis: str, mesh: "Mesh | None" = None):
    """This rank's group along ``axis`` of ``mesh`` (default: the current
    mesh) as a ``parallel.tensor.TensorGroup`` (group, size, this rank's
    coordinate), or ``None`` when there is no mesh, no such axis or it
    has size 1."""
    from ray_lightning_tpu_torch.parallel.tensor import TensorGroup
    mesh = get_current_mesh() if mesh is None else mesh
    if mesh is None or mesh.shape.get(axis, 1) <= 1:
        return None
    return TensorGroup(mesh.group(axis), mesh.shape[axis],
                       mesh.coords[axis], tuple(mesh.members(axis)))


# -- collectives ---------------------------------------------------------

_LOGGED: "set[tuple]" = set()


def _note(op: str, form: str, t: torch.Tensor, group) -> None:
    key = (op, form, t.device.type, dist.get_backend(group))
    if key not in _LOGGED:
        _LOGGED.add(key)
        _log.info("%s runs as %s (%s, %s tensors)", op, form, key[3],
                  t.device.type)


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _wide(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as a collective's operand: gloo reduces half types in
    fp32."""
    if _gloo(group) and t.dtype in (torch.bfloat16, torch.float16):
        return t.float()
    return t


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``t`` reduced over ``group`` into a new tensor (``t`` itself when
    the group is ``None``)."""
    if group is None:
        return t
    w = _wide(t, group)
    out = w.clone() if w is t else w
    dist.all_reduce(out, op=op, group=group)
    return out if out.dtype == t.dtype else out.to(t.dtype)


def all_gather_along(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` joined along ``dim`` in group-rank
    order."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    if _gloo(group):
        _note("all_gather", "list all_gather", t, group)
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts)
    else:
        _note("all_gather", "all_gather_into_tensor", t, group)
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def reduce_scatter_along(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``t`` summed over ``group``, this rank's 1/n of it along ``dim``
    (which n divides)."""
    if group is None:
        return t
    n, r = dist.get_world_size(group), dist.get_rank(group)
    src = t.movedim(dim, 0).contiguous()
    if _gloo(group) and src.is_cuda:
        _note("reduce_scatter", "all_reduce + slice", t, group)
        out = all_reduce(src, group).chunk(n)[r].contiguous()
    else:
        _note("reduce_scatter", "reduce_scatter_tensor", t, group)
        w = _wide(src, group)
        out = w.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, w, group=group)
        out = out.to(src.dtype)
    return out.movedim(0, dim)


def ppermute(t: torch.Tensor, g, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` over ``g`` (a ``parallel.tensor.TensorGroup``,
    :func:`axis_group`'s): this rank sends ``t`` to the rank ``shift``
    places on, cyclically, and returns what the rank ``shift`` places
    back sent (``t`` itself when ``g`` is ``None``).  Every rank of the
    group calls it with tensors of one shape and dtype."""
    if g is None:
        return t
    dst = g.members[(g.rank + shift) % g.size]
    src = g.members[(g.rank - shift) % g.size]
    if _gloo(g.group):
        # gloo's isend / irecv take host tensors only
        _note("ppermute", "isend / irecv of host tensors", t, g.group)
        send = t.contiguous().cpu()
        out = torch.empty_like(send)
        reqs = [dist.isend(send, dst, group=g.group),
                dist.irecv(out, src, group=g.group)]
    else:
        _note("ppermute", "batch_isend_irecv", t, g.group)
        send = t.contiguous()
        out = torch.empty_like(send)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dst, g.group),
            dist.P2POp(dist.irecv, out, src, g.group)])
    for r in reqs:
        r.wait()
    return out.to(t.device)


def ppermute_along(t: torch.Tensor, axis: str, shift: int = 1,
                   mesh: "Mesh | None" = None) -> torch.Tensor:
    """:func:`ppermute` along ``axis`` of ``mesh`` (default: the current
    mesh)."""
    return ppermute(t, axis_group(axis, mesh), shift)


__all__ = ["BATCH_AXES", "Mesh", "all_gather_along", "all_reduce",
           "axis_group", "ppermute", "ppermute_along",
           "build_device_mesh", "data_and_tensor_axes", "get_current_mesh",
           "mesh_axis_size", "reduce_scatter_along", "set_current_mesh"]
