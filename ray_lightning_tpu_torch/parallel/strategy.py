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

``"fsdp"``, ``"zero3"``, ``"spmd"``, ``"auto"`` and ``"mpmd"`` raise
``NotImplementedError`` naming their ROADMAP.md item; other names raise
``ValueError``, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Optional

import torch
import torch.distributed as dist

from ray_lightning_tpu_torch.ops.optim import (SGD, AdamW, EmptyState,
                                               chain, clip_by_global_norm,
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


def gather_objects(obj) -> list:
    """``obj`` of every rank, in rank order (``[obj]`` without a process
    group); pickled, so for small host-side values."""
    if not group_active():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


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


class ShardingStrategy:
    """Base: how a train step syncs its gradients (:meth:`grad_sync`)
    and where the optimizer state lives (:meth:`wrap_optimizer`)."""

    name: str = "base"

    def grad_sync(self) -> Optional[Callable]:
        """``grads -> grads`` run between the backward and the update, or
        ``None``."""
        return None

    def wrap_optimizer(self, tx):
        """The optimizer the step runs, given the module's (chained with
        the clip when ``gradient_clip_val`` is set)."""
        return tx


class DataParallelStrategy(ShardingStrategy):
    """DDP: params and optimizer state on every rank, gradients averaged
    over the ranks before the update (module docstring)."""

    name = "ddp"

    def grad_sync(self) -> Optional[Callable]:
        return average_grads if group_active() else None


class Zero1Strategy(ShardingStrategy):
    """ZeRO-1: params on every rank, the fp32 master and the optimizer's
    moments sharded 1/W a rank (:class:`Zero1Optimizer`).  Params with
    fewer than ``max(2, min_shard_elements)`` elements stay replicated:
    their gradients are all-reduced and every rank updates them whole."""

    name = "zero1"

    def __init__(self, min_shard_elements: int = 0):
        self.min_shard_elements = int(min_shard_elements)

    def wrap_optimizer(self, tx):
        return Zero1Optimizer(tx, self.min_shard_elements)


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
        if isinstance(self.opt.inner, AdamW):
            sd = {"count": self.inners[0].count,
                  "mu": self._by_name([s.mu["flat"] for s in self.inners]),
                  "nu": self._by_name([s.nu["flat"] for s in self.inners])}
        else:
            sd = {}
        if self.opt.has_master:
            sd = {"inner": sd, "master": self._by_name(self.masters)}
        if self.opt.clip is not None:
            sd = {"0": {}, "1": sd}
        return sd

    def load_state_dict(self, state: dict) -> None:
        if self.opt.clip is not None:
            if sorted(state) != ["0", "1"] or state["0"]:
                raise ValueError(f"chain(clip, ...): the state has "
                                 f"{sorted(state)}")
            state = state["1"]
        if self.opt.has_master:
            master = _named(state["master"], self.opt.names, "master")
            self.masters = [g.shard_of([master[k] for k in g.names])
                            for g in self.groups]
            state = state["inner"]
        if not isinstance(self.opt.inner, AdamW):
            EmptyState().load_state_dict(state)
            return
        mu = _named(state["mu"], self.opt.names, "mu")
        nu = _named(state["nu"], self.opt.names, "nu")
        for g, s in zip(self.groups, self.inners):
            s.count = int(state["count"])
            s.mu = {"flat": g.shard_of([mu[k] for k in g.names],
                                       s.mu["flat"].dtype)}
            s.nu = {"flat": g.shard_of([nu[k] for k in g.names])}


def _named(saved: Mapping, names: "list[str]", what: str) -> dict:
    if set(saved) != set(names):
        raise ValueError(
            f"{what}: the saved state names other parameters (missing "
            f"{sorted(set(names) - set(saved))[:4]}, unexpected "
            f"{sorted(set(saved) - set(names))[:4]})")
    return dict(saved)


class Zero1Optimizer:
    """ZeRO-1 around the optimizer the ``Trainer`` builds: ``AdamW``,
    ``SGD`` or ``fp32_master(AdamW)``, optionally chained behind
    ``clip_by_global_norm``.

    Per step: the gradients (in their dtype ``d``) are laid into one fp32
    vector and reduce-scattered (summed, then divided by W) and the
    rank's shard is rounded to ``d``, which is what DDP's mean is cast
    back to; the clip, if any, scales the shard by a norm taken from the
    per-parameter sums of squares, all-reduced (the pad left out), then
    rounded to ``d`` and summed in parameter order as the clip sums them
    (a parameter whole on one rank gets the unsharded clip's sum
    exactly);
    the inner optimizer updates the rank's shard of the fp32 master (the
    params themselves when they are fp32 and there is no
    ``fp32_master``); the shards are all-gathered and copied into the
    resident params, which casts them to their dtype."""

    def __init__(self, tx, min_shard_elements: int = 0):
        self.clip = None
        if isinstance(tx, chain):
            *maps, tx = tx.transforms
            if len(maps) != 1 or not isinstance(maps[0],
                                                clip_by_global_norm):
                raise NotImplementedError(
                    "ZeRO-1 takes chain(clip_by_global_norm, optimizer) "
                    "only")
            self.clip = maps[0]
        self.has_master = isinstance(tx, fp32_master)
        self.inner = tx.inner if self.has_master else tx
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

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: Zero1State,
               params: Mapping[str, torch.Tensor]) -> None:
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
            master = (state.masters[i] if self.has_master else
                      g.shard_of([params[k] for k in g.names]))
            self.inner.update({"flat": gs.float()}, state.inners[i],
                              {"flat": master})
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
}

#: strategy names of the JAX package not ported yet -> their ROADMAP.md
#: queue 1 item
_NOT_PORTED = {"fsdp": 9, "zero3": 9, "spmd": 9, "auto": 12, "mpmd": 11}


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


__all__ = ["DataParallelStrategy", "ShardingStrategy", "Zero1Optimizer",
           "Zero1State", "Zero1Strategy", "average_grads", "gather_objects",
           "global_rank", "group_active", "mean_over_ranks", "resolve_strategy", "strategy_names",
           "sum_over_ranks", "world_size"]
