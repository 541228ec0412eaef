"""Compressed cross-replica collectives and the strategy->step GradSync.

Counterpart of ``ray_lightning_tpu/comm/collectives.py`` on
``torch.distributed`` groups.  The JAX functions run inside a
``shard_map`` region over a named axis; here each rank calls them with
its own tensor and the process group of the axis (``group``; ``None``
is the default group), and every rank of the group calls them in the
same order.

- :func:`compressed_reduce_scatter`: pad the flat payload to ``[world,
  chunk]`` rows (``chunk`` a multiple of the block), compress, send one
  ``all_to_all_single`` of the payload and one of the scales, then
  dequantize the W received rows and SUM THEM IN FP32, in rank order
  from zero (an int8 sum would wrap; an NCCL reduce would pick its own
  order).  Each rank ends with its fp32 ``[chunk]`` shard of the sum.
- :func:`compressed_all_gather`: re-compress the shard, all-gather the
  compressed rows, dequantize.
- :func:`compressed_psum`: the pair composed (both wire phases
  compressed), ``mean`` and the phase-1 error (``with_error``, in SUM
  units) as in JAX.
- :func:`hierarchical_psum`: fp32 reduce-scatter inside each fast group,
  :func:`compressed_psum` across the groups on the 1/fast shard, fp32
  all-gather back inside the group.

Arithmetic: the JAX package runs these inside its jitted step, so they
compute as that program does, bit for bit: the codec's block scale is
``max|x|`` times the fp32 reciprocal of the levels (:func:`_compress`),
and each received row's ``level * scale`` is added to the sum, and each
error's ``x - level * scale`` taken, with one rounding (the fused
multiply-adds XLA emits; here exact fp64 products rounded once: the
cost of bit parity, ROADMAP.md queue 2).

Wire dtypes: every payload travels as a ``uint8`` view of its bytes
(NCCL has no fp8 or int4 type; int4 is nibble-packed, so its payload
is half the elements); the records of comm/audit.py name the codec's
element type.  Under gloo a CUDA payload goes through a host copy (gloo
takes no CUDA tensor in its all-to-all), so one card can run W ranks.

Error feedback: each rank keeps its own ``[*param_shape]`` fp32
residual in the optimizer state (:class:`CommState`, the port's form of
the JAX ``[world, *param_shape]`` leaf sharded on the compressed axes),
adds it to the next step's local gradient and stores the new phase-1
quantization error.  Stochastic rounding draws from the step's keyed
Philox (ops/random.py ``Key``), folded per bucket and phase, so a
graphed chunk replays fresh draws each step.
"""

from __future__ import annotations

import logging
import math
import re
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ray_lightning_tpu_torch.comm import audit
from ray_lightning_tpu_torch.comm.policy import CommPolicy
from ray_lightning_tpu_torch.comm.quant import (LEVELS, _block_view,
                                                _encode, _ftz, compress_cast,
                                                decode_levels,
                                                decompress_cast,
                                                payload_bytes)

_log = logging.getLogger(__name__)

#: the fold-in path root of the quantizer's draws (a step's keyed draws
#: use small call indices: ``StepContext.make_key``)
COMM_STREAM = 1 << 40


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous, last dim whole) as a uint8 view ``[..., n *
    itemsize]``."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype != torch.uint8 else t


def _all_to_all(rows: torch.Tensor, group, tag: str) -> torch.Tensor:
    """Row i of ``rows`` [W, c] to group rank i; returns [W, c] whose row
    j came from group rank j, in ``rows``' dtype and device."""
    send = _bytes_of(rows)
    host = send.is_cuda and _gloo(group)
    if host:
        send = send.cpu()
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=group)
    out = out.view(rows.dtype).reshape(rows.shape)
    audit.note("all-to-all", out, group, tag)
    return out.to(rows.device) if host else out


def _all_gather(row: torch.Tensor, world: int, group,
                tag: str) -> torch.Tensor:
    """Every group rank's ``row`` [1, c] stacked to [W, c] in group-rank
    order, in ``row``'s dtype and device."""
    send = _bytes_of(row)
    if send.is_cuda and not _gloo(group):
        out = send.new_empty((world,) + tuple(send.shape[1:]))
        dist.all_gather_into_tensor(out, send, group=group)
    else:
        host = send.cpu()
        parts = [torch.empty_like(host) for _ in range(world)]
        dist.all_gather(parts, host, group=group)
        out = torch.cat(parts).to(row.device)
    out = out.view(row.dtype).reshape((world,) + tuple(row.shape[1:]))
    audit.note("all-gather", out, group, tag)
    return out


def _gather_uneven(piece: torch.Tensor, lens: "list[int]",
                   group) -> torch.Tensor:
    """Every group rank's 1-D ``piece`` (rank r's of ``lens[r]``
    elements) joined in group-rank order: an all-gather of uneven
    pieces, as one ``all_to_all_single`` (this rank's piece sent to each
    rank, each rank's received once).  Recorded as the all-gather it
    is."""
    W = len(lens)
    item = piece.element_size()
    send = _bytes_of(piece).repeat(W)
    host = send.is_cuda and _gloo(group)
    if host:
        send = send.cpu()
    out = send.new_empty(sum(lens) * item)
    dist.all_to_all_single(out, send, [n * item for n in lens],
                           [piece.numel() * item] * W, group=group)
    out = out.view(piece.dtype)
    audit.note("all-gather", out, group, "param_gather")
    return out.to(piece.device) if host else out


def _sum_rows(rows: torch.Tensor) -> torch.Tensor:
    """The rows of ``rows`` [W, c] summed in fp32 in rank order from zero
    (the JAX ``jnp.sum(..., axis=0)``; the same order on every device)."""
    acc = torch.zeros_like(rows[0], dtype=torch.float32)
    for r in rows.unbind(0):
        acc = acc + r
    return acc


def _sum_dequantized(q: torch.Tensor, scale: torch.Tensor, mode: str,
                     block_size: int) -> torch.Tensor:
    """The W received rows of a scaled codec dequantized and summed in
    rank order from zero, each row's ``level * scale`` added to the sum
    with one rounding: the fused multiply-add the JAX program compiles
    ``jnp.sum(decompress_cast(...), axis=0)`` to.  The product of a
    codec level and an fp32 scale is exact in fp64, so ``(acc + level *
    scale)`` in fp64 rounded to fp32 is that multiply-add (subnormal
    sums flushed to zero, as XLA flushes them)."""
    levels = decode_levels(q, mode)
    W, n = levels.shape
    blocks = levels.reshape(W, n // block_size, block_size).double()
    prods = (blocks * scale.double()[..., None]).reshape(W, n)
    acc = torch.zeros(n, dtype=torch.float32, device=q.device)
    for p in prods.unbind(0):
        acc = _ftz((acc.double() + p).to(torch.float32))
    return acc


def _quant_error(rows: torch.Tensor, q: torch.Tensor, scale, mode: str,
                 block_size: int) -> torch.Tensor:
    """``rows - decompress_cast(q, scale)`` with each element's ``rows -
    level * scale`` rounded once: the fused multiply-add the JAX program
    compiles the error term to (exact products in fp64, as in
    :func:`_sum_dequantized`)."""
    if scale is None:
        return rows - q.to(torch.float32)
    levels = decode_levels(q, mode)
    blocks = levels.reshape(tuple(levels.shape[:-1]) + (
        levels.shape[-1] // block_size, block_size)).double()
    prods = (blocks * scale.double()[..., None]).reshape(levels.shape)
    return _ftz((rows.double() - prods).to(torch.float32))


def _compress(x: torch.Tensor, mode: str, block_size: int,
              stochastic: bool = False, key=None):
    """``compress_cast`` with the block scale as the jitted JAX program
    computes it: ``max|x|`` times the fp32 reciprocal of the levels (XLA
    rewrites the division by a constant so; the eager codec divides)."""
    if mode == "bf16":
        return x.to(torch.bfloat16), None
    blocks = _block_view(_ftz(x.to(torch.float32)), block_size)
    # a Python scalar multiplies in the tensor's fp32, and 1 / levels
    # rounds to the same fp32 from the double as XLA's fp32 constant (no
    # device tensor is made: a graph capture may be running)
    scale = _ftz(blocks.abs().amax(dim=-1) * (1.0 / LEVELS[mode]))
    return _encode(blocks, scale, mode, x.shape, stochastic, key), scale


def _fold(key, *path):
    return None if key is None else key.fold_in(*path)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


def _pad_rows(x: torch.Tensor, world: int, block_size: int):
    """Flatten ``x`` (fp32) and zero-pad to ``[world, chunk]`` rows with
    ``chunk`` a multiple of ``block_size``; returns (rows, n) with n the
    true element count (the JAX function)."""
    flat = x.to(torch.float32).reshape(-1)
    n = flat.numel()
    chunk = -(-n // world)
    chunk = -(-chunk // block_size) * block_size
    flat = torch.nn.functional.pad(flat, (0, world * chunk - n))
    return flat.reshape(world, chunk), n


def padded_elements(n: int, world: int, block_size: int) -> int:
    """The elements of :func:`_pad_rows`' rows for an ``n``-element
    payload: what the wire carries."""
    chunk = -(-n // world)
    return world * (-(-chunk // block_size) * block_size)


def compressed_reduce_scatter(x: torch.Tensor, group, world: int, *,
                              mode: str = "int8", block_size: int = 64,
                              stochastic: bool = False, key=None,
                              with_error: bool = False, tag: str = "comm"):
    """Reduce-scatter ``x`` (any shape) over ``group`` (``world`` ranks)
    in the compressed dtype.  Returns ``(shard, n)``: this rank's fp32
    ``[chunk]`` shard of the SUM and the true element count, plus the
    local quantization error shaped like ``x`` when ``with_error``."""
    rows, n = _pad_rows(x, world, block_size)
    shard, err_rows = _reduce_scatter_rows(
        rows, group, mode=mode, block_size=block_size,
        stochastic=stochastic, key=key, with_error=with_error, tag=tag)
    if not with_error:
        return shard, n
    return shard, n, err_rows.reshape(-1)[:n].reshape(x.shape)


def _reduce_scatter_rows(rows: torch.Tensor, group, *, mode: str,
                         block_size: int, stochastic: bool, key,
                         with_error: bool, tag: str):
    """The compressed reduce-scatter of ``rows`` [W, chunk] (fp32, chunk
    a multiple of the block): row i goes to group rank i; returns this
    rank's fp32 SUM ``[chunk]`` and, with ``with_error``, the
    quantization error ``[W, chunk]`` (else ``None``)."""
    q, scale = _compress(rows, mode, block_size, stochastic, key)
    qt = _all_to_all(q, group, tag)
    if scale is not None:
        st = _all_to_all(scale, group, tag)
        shard = _sum_dequantized(qt, st, mode, block_size)
    else:
        shard = _sum_rows(qt.to(torch.float32))
    err = _quant_error(rows, q, scale, mode, block_size) if with_error \
        else None
    return shard, err


def compressed_all_gather(shard: torch.Tensor, group, world: int, *,
                          mode: str = "int8", block_size: int = 64,
                          stochastic: bool = False, key=None,
                          tag: str = "comm") -> torch.Tensor:
    """All-gather a per-rank ``[chunk]`` shard over ``group`` in the
    compressed dtype: the flat fp32 ``[world * chunk]`` result."""
    q, scale = _compress(shard[None], mode, block_size, stochastic, key)
    qg = _all_gather(q, world, group, tag)
    if scale is not None:
        sg = _all_gather(scale, world, group, tag)
        full = decompress_cast(qg, sg, mode, block_size)
    else:
        full = qg.to(torch.float32)
    return full.reshape(-1)


def compressed_psum(x: torch.Tensor, group, world: int, *,
                    mode: str = "int8", block_size: int = 64,
                    mean: bool = False, stochastic: bool = False,
                    key=None, with_error: bool = False, tag: str = "comm"):
    """All-reduce ``x`` over ``group`` with both wire phases compressed
    (reduce-scatter + all-gather).  Returns the reduced tensor shaped
    like ``x`` (fp32), and the local phase-1 quantization error when
    ``with_error``, in SUM units (not divided by ``world`` under
    ``mean``: what error feedback needs)."""
    out = compressed_reduce_scatter(x, group, world, mode=mode,
                                    block_size=block_size,
                                    stochastic=stochastic,
                                    key=_fold(key, 0),
                                    with_error=with_error, tag=tag)
    shard, n = out[0], out[1]
    if mean:
        shard = shard / world
    full = compressed_all_gather(shard, group, world, mode=mode,
                                 block_size=block_size,
                                 stochastic=stochastic, key=_fold(key, 1),
                                 tag=tag)
    res = full[:n].reshape(x.shape)
    if with_error:
        return res, out[2]
    return res


# ---------------------------------------------------------------------------
# two-level (fast x slow) reduction
# ---------------------------------------------------------------------------


def hierarchy_groups(ici: int, dcn: int) -> "tuple[list, list]":
    """``(ici_groups, dcn_groups)`` over a ``world = ici * dcn`` axis
    under the contiguous-block layout ``rank = host * ici + local``
    (the JAX function): the fast groups are the blocks, the slow groups
    collect the ranks with one local index across blocks.  Indices are
    positions along the axis."""
    ici_groups = [[h * ici + j for j in range(ici)] for h in range(dcn)]
    dcn_groups = [[h * ici + j for h in range(dcn)] for j in range(ici)]
    return ici_groups, dcn_groups


class Tiers:
    """This rank's groups of a two-level reduction: ``fast`` (its block
    of ``ici`` ranks), ``slow`` (its ``dcn`` peers at the same local
    index) and ``local`` (its index inside the block).  :meth:`make`
    creates every group of both partitions on every rank, in one
    order (``new_group`` is collective)."""

    def __init__(self, fast, slow, ici: int, dcn: int, local: int):
        self.fast, self.slow = fast, slow
        self.ici, self.dcn, self.local = ici, dcn, local

    @classmethod
    def make(cls, ici: int, dcn: int, members: "list[list[int]]",
             position: int, rank: int, backend=None) -> "Tiers":
        """``members``: every row of the axis as global ranks (each a
        list of ``ici * dcn``, in axis order); ``position`` this rank's
        index along the axis."""
        ici_groups, dcn_groups = hierarchy_groups(ici, dcn)
        fast = slow = None
        for parts, is_fast in ((ici_groups, True), (dcn_groups, False)):
            for row in members:
                for part in parts:
                    ranks = [row[i] for i in part]
                    g = dist.new_group(ranks, backend=backend)
                    if rank in ranks:
                        if is_fast:
                            fast = g
                        else:
                            slow = g
        return cls(fast, slow, ici, dcn, position % ici)


def hierarchical_psum(x: torch.Tensor, tiers: Tiers, *,
                      mode: str = "int8", block_size: int = 64,
                      mean: bool = False, stochastic: bool = False,
                      key=None, with_error: bool = False,
                      tag: str = "comm"):
    """Two-level all-reduce of ``x`` over ``tiers.ici * tiers.dcn``
    ranks (module docstring).  ``with_error`` returns the level-2
    quantization error scattered back to ``x``'s shape (zeros outside
    this rank's chunk), so the residual keeps the flat path's layout:
    level 1 is an exact sum, so injecting the error into one rank of
    the block next step compensates exactly."""
    ici, dcn = tiers.ici, tiers.dcn
    world = ici * dcn
    rows, n = _pad_rows(x, ici, block_size)
    rows_t = _all_to_all(rows, tiers.fast, tag)
    shard = _sum_rows(rows_t)                  # fp32 [chunk] of the block
    out = compressed_psum(shard, tiers.slow, dcn, mode=mode,
                          block_size=block_size, stochastic=stochastic,
                          key=key, with_error=with_error, tag=tag)
    reduced, err = (out if with_error else (out, None))
    if mean:
        reduced = reduced / world
    full = _all_gather(reduced[None], ici, tiers.fast, tag).reshape(-1)
    res = full[:n].reshape(x.shape)
    if not with_error:
        return res
    chunk = shard.numel()
    err_flat = torch.zeros(ici * chunk, dtype=torch.float32,
                           device=x.device)
    err_flat[tiers.local * chunk:(tiers.local + 1) * chunk] = \
        err.reshape(-1)
    return res, err_flat[:n].reshape(x.shape)


# ---------------------------------------------------------------------------
# buckets
# ---------------------------------------------------------------------------


def partition_buckets(leaf_bytes, bucket_bytes: int) -> "list[list[int]]":
    """Greedy contiguous partition of leaf indices into buckets whose
    cumulative payload reaches ``bucket_bytes`` (the last may be
    smaller; an oversized leaf gets its own).  Every index once, in
    order (the JAX function)."""
    if bucket_bytes <= 0:
        return [[i] for i in range(len(leaf_bytes))]
    buckets: "list[list[int]]" = []
    cur: "list[int]" = []
    acc = 0
    for i, b in enumerate(leaf_bytes):
        cur.append(i)
        acc += int(b)
        if acc >= bucket_bytes:
            buckets.append(cur)
            cur, acc = [], 0
    if cur:
        buckets.append(cur)
    return buckets


def _consumption_order(paths: "list[str]") -> "list[int]":
    """Indices of ``paths`` (flax paths) in the next forward's
    consumption order: embeddings, blocks by numeric layer index, the
    final norm, the rest; ties on the path (the JAX function)."""
    def key(item):
        _, pstr = item
        head = pstr.split("/", 1)[0].lower()
        if head in ("wte", "wpe", "embed", "embedding", "embeddings"):
            return (0, 0, pstr)
        m = re.fullmatch(r"[a-z_]*?(\d+)", head)
        if m:
            return (1, int(m.group(1)), pstr)
        if head.startswith("ln_f") or head in ("final_norm", "norm_f"):
            return (2, 0, pstr)
        return (3, 0, pstr)

    return [i for i, _ in sorted(enumerate(paths), key=key)]


def flax_paths(names: Sequence[str]) -> "list[str]":
    """The flax path of each torch parameter name (convert.py)."""
    from ray_lightning_tpu_torch.convert import flax_path
    return [flax_path(n)[0] for n in names]


# ---------------------------------------------------------------------------
# the residual's carrier
# ---------------------------------------------------------------------------


class CommState:
    """The optimizer state with each rank's error-feedback residual:
    ``residual`` (parameter name -> this rank's fp32 ``[*shape]``; empty
    with error feedback off) and ``inner`` (the wrapped optimizer's
    state).  :meth:`state_dict` gathers every rank's residual to ``[W,
    *shape]`` (collective), the JAX checkpoint's layout; a
    :meth:`load_state_dict` takes this rank's row, or the rows' mean
    when the saved world differs (module ``load_residual``)."""

    def __init__(self, residual: "dict[str, torch.Tensor]", inner,
                 sync: "GradSync"):
        self.residual = residual
        self.inner = inner
        # bound methods: the capture's walk over state tensors skips them
        self._gather = sync.gather_residual
        self._row = sync.residual_row
        self.world = sync.world

    def state_dict(self) -> dict:
        return {"residual": {k: self._gather(v)
                             for k, v in self.residual.items()},
                "inner": self.inner.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        """A saved state with or without a residual (module docstring of
        :func:`load_residual`)."""
        if is_comm_state_dict(state):
            self.load_residual(state["residual"])
            self.inner.load_state_dict(state["inner"])
        else:
            self.zero_residual()
            self.inner.load_state_dict(state)

    def load_residual(self, saved: Mapping[str, torch.Tensor]) -> None:
        if not self.residual:
            return
        if set(saved) != set(self.residual):
            _log.warning("comm residual: the saved one names other "
                         "parameters; error feedback restarts from zero")
            self.zero_residual()
            return
        with torch.no_grad():
            for k, r in self.residual.items():
                r.copy_(self._row(saved[k]).to(r.device))

    def zero_residual(self) -> None:
        with torch.no_grad():
            for r in self.residual.values():
                r.zero_()


def is_comm_state_dict(state) -> bool:
    """Whether an optimizer state dict is a :class:`CommState`'s."""
    return isinstance(state, Mapping) and set(state) == {"residual",
                                                         "inner"}


def inner_state_dict(state):
    """An optimizer state dict without its comm residual (a comm-on save
    restored where the plane is inert: the residual is dropped)."""
    if is_comm_state_dict(state):
        _log.warning("comm residual dropped: the plane is inert here")
        return state["inner"]
    return state


class CommTx:
    """The outermost optimizer wrap (the JAX ``GradSync.wrap_tx``): its
    state is a :class:`CommState`; ``update`` runs the wrapped one on the
    inner state.  The step writes the residual itself, after the sync
    (core/steps.py)."""

    def __init__(self, tx, sync: "GradSync"):
        self.tx = tx
        self.sync = sync

    def init(self, params: Mapping[str, torch.Tensor]) -> CommState:
        residual = {}
        if self.sync.error_feedback:
            residual = {k: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                        for k, p in params.items()}
        return CommState(residual, self.tx.init(params), self.sync)

    def host_scalars(self, state: CommState, ahead: int = 0):
        return self.tx.host_scalars(state.inner, ahead)

    def advance(self, state: CommState, n: int) -> None:
        self.tx.advance(state.inner, n)

    def update(self, grads, state: CommState, params,
               scalars: "torch.Tensor | None" = None) -> None:
        self.tx.update(grads, state.inner, params, scalars)


# ---------------------------------------------------------------------------
# GradSync
# ---------------------------------------------------------------------------


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return int(np.dtype(dtype).itemsize)


def _numel(leaf) -> int:
    return int(math.prod(tuple(getattr(leaf, "shape", ()))))


class GradSync:
    """Everything the step needs to route its gradient sync through the
    compressed collectives for one (mesh, policy, strategy) resolution
    (the JAX class).  Stateless across steps: the residual lives in the
    optimizer state.

    ``zero1``: the strategy is ZeRO-1, whose updated-param gather takes
    ``param_gather`` / ``gather_bucket_bytes`` (:meth:`regather_params`).
    ``local``: the ranks of one host, for ``HIER_AUTO`` (default: read
    from the group at :meth:`setup`)."""

    def __init__(self, mesh, axes: tuple, policy: CommPolicy,
                 data_axis_names: tuple, zero1: bool = False,
                 local: "int | None" = None):
        self.mesh = mesh
        self.axes = tuple(axes)
        self.policy = policy
        self.world = int(math.prod(mesh.shape[a] for a in self.axes))
        self.ici_size, self.dcn_size = policy.resolved_hierarchy(
            self.world, local)
        self.plain_axes = tuple(
            a for a in data_axis_names
            if a in mesh.axis_names and a not in self.axes
            and mesh.shape[a] > 1)
        self.data_axis_names = tuple(
            a for a in data_axis_names if a in mesh.axis_names)
        self.zero1 = zero1
        self._tiers: "Tiers | None" = None
        self._ready = False
        self._deferred = None

    # -- descriptors -----------------------------------------------------

    @property
    def error_feedback(self) -> bool:
        return bool(self.policy.error_feedback)

    @property
    def hierarchical(self) -> bool:
        return self.ici_size > 1 and self.dcn_size > 1

    @property
    def explicit_gather(self) -> bool:
        """ZeRO-1's gather goes through :meth:`regather_params`."""
        return self.zero1 and (self.policy.param_gather != "none"
                               or self.policy.gather_bucket_bytes > 0)

    def describe(self) -> str:
        """Short tag, e.g. ``int8[data]`` or ``fp8[data]/hier2x2/bkt32M``
        (the JAX format)."""
        tag = f"{self.policy.compress}[{','.join(self.axes)}]"
        if self.hierarchical:
            tag += f"/hier{self.ici_size}x{self.dcn_size}"
        if self.policy.bucket_bytes > 0:
            tag += f"/bkt{self.policy.bucket_bytes >> 20}M"
        if self.policy.gather_bucket_bytes > 0:
            tag += f"/gbkt{self.policy.gather_bucket_bytes >> 20}M"
        return tag

    def _comm_kw(self) -> dict:
        return dict(mode=self.policy.compress,
                    block_size=self.policy.block_size,
                    stochastic=self.policy.stochastic_rounding)

    # -- groups ------------------------------------------------------------

    @property
    def group(self):
        """The process group along the compressed axes."""
        return self.mesh.group(*self.axes)

    @property
    def index(self) -> int:
        """This rank's position along the compressed axes."""
        return self.mesh.index(*self.axes)

    def setup(self, device: "torch.device | None" = None) -> None:
        """Make the two-level groups (every rank, one order) and run one
        tiny collective on each group this sync uses, on ``device``, so
        every communicator exists before a CUDA graph captures the step
        (NCCL cannot create one inside a capture).  Collective."""
        if self._ready:
            return
        if self.hierarchical:
            rows, seen = [], set()
            for r in range(self.mesh.world):
                row = tuple(self.mesh.members(*self.axes, rank=r))
                if row not in seen:
                    seen.add(row)
                    rows.append(list(row))
            self._tiers = Tiers.make(self.ici_size, self.dcn_size, rows,
                                     self.index, self.mesh.rank)
        if device is not None:
            probe = torch.zeros(1, device=device)
            groups = [self.group]
            if self._tiers is not None:
                groups += [self._tiers.fast, self._tiers.slow]
            if self.plain_axes:
                groups.append(self.mesh.group(*self.plain_axes))
            for g in groups:
                t = probe.cpu() if probe.is_cuda and _gloo(g) else probe
                dist.all_reduce(t, group=g)
            if probe.is_cuda:
                torch.cuda.synchronize(device)
        self._ready = True

    # -- the sync ----------------------------------------------------------

    def mean_psum(self, x: torch.Tensor, key, with_error: bool):
        """One mean-all-reduce of an fp32 payload: two-level when the
        hierarchy is active, flat compressed otherwise."""
        self.setup()
        kw = self._comm_kw()
        if self.hierarchical:
            return hierarchical_psum(x, self._tiers, mean=True, key=key,
                                     with_error=with_error,
                                     tag="grad_sync", **kw)
        return compressed_psum(x, self.group, self.world, mean=True,
                               key=key, with_error=with_error,
                               tag="grad_sync", **kw)

    def _plain_mean(self, t: torch.Tensor) -> torch.Tensor:
        g = self.mesh.group(*self.plain_axes)
        out = t.clone()
        dist.all_reduce(out, group=g)
        audit.note("all-reduce", out, g, "grad_sync")
        return out / dist.get_world_size(g)

    def _keys(self, key, count: int) -> list:
        if not self.policy.stochastic_rounding:
            return [None] * count
        if key is None:
            raise ValueError("stochastic rounding needs a key")
        return [key.fold_in(COMM_STREAM, i) for i in range(count)]

    def sync(self, grads: "list[torch.Tensor]",
             residual: "list[torch.Tensor] | None", key=None):
        """Compressed mean of the local gradients, one collective a
        gradient.  ``residual``: this rank's tensors, one a gradient
        (``None`` with error feedback off).  Returns ``(synced,
        new_residual)``, the synced gradients in their dtypes."""
        ef = self.error_feedback
        keys = self._keys(key, len(grads))
        synced, new_res = [], []
        for i, (g, k) in enumerate(zip(grads, keys)):
            x = g.to(torch.float32)
            if ef:
                x = x + residual[i]
            out = self.mean_psum(x, k, with_error=ef)
            res, err = out if ef else (out, None)
            if self.plain_axes:
                res = self._plain_mean(res)
            synced.append(res.to(g.dtype))
            new_res.append(err)
        return synced, (new_res if ef else None)

    def sync_bucketed(self, grads: "list[torch.Tensor]",
                      residual: "list[torch.Tensor] | None", key=None,
                      barrier: "bool | None" = None):
        """Like :meth:`sync` with the gradients coalesced into buckets of
        about ``policy.bucket_bytes`` fp32 bytes, one collective a bucket.
        Each bucket's collective is issued right after its payload is
        built; ``barrier`` (default ``policy.barrier_sync``, the A/B
        side) builds every payload before the first collective."""
        barrier = self.policy.barrier_sync if barrier is None else barrier
        ef = self.error_feedback
        buckets = partition_buckets([g.numel() * 4 for g in grads],
                                    self.policy.bucket_bytes)
        keys = self._keys(key, len(buckets))

        def payload(idxs):
            parts = []
            for i in idxs:
                x = grads[i].to(torch.float32)
                if ef:
                    x = x + residual[i]
                parts.append(x.reshape(-1))
            return parts[0] if len(parts) == 1 else torch.cat(parts)

        payloads = [payload(b) for b in buckets] if barrier else None
        synced: list = [None] * len(grads)
        new_res: list = [None] * len(grads)
        for j, (idxs, k) in enumerate(zip(buckets, keys)):
            p = payloads[j] if barrier else payload(idxs)
            out = self.mean_psum(p, k, with_error=ef)
            res, err = out if ef else (out, None)
            off = 0
            for i in idxs:
                g = grads[i]
                piece = res[off:off + g.numel()].reshape(g.shape)
                if self.plain_axes:
                    piece = self._plain_mean(piece)
                synced[i] = piece.to(g.dtype)
                if ef:
                    new_res[i] = err[off:off + g.numel()].reshape(g.shape)
                off += g.numel()
        return synced, (new_res if ef else None)

    def sync_step(self, grads, residual, key=None):
        """The step builder's entry point: bucketed when
        ``policy.bucket_bytes > 0``, one collective a gradient
        otherwise."""
        if self.policy.bucket_bytes > 0:
            return self.sync_bucketed(grads, residual, key=key)
        return self.sync(grads, residual, key=key)

    # -- ZeRO-1's gradient reduce-scatter ------------------------------------

    def defer(self, residual: "dict | None", key) -> None:
        """Under ZeRO-1 the step hands the optimizer the residual and the
        key (:meth:`take`): the sync is ZeRO-1's own compressed
        reduce-scatter over its shard layout
        (parallel/strategy.py ``Zero1Optimizer``)."""
        self._deferred = (residual, key)

    def take(self):
        """The step's ``(residual, key)``, once."""
        out, self._deferred = self._deferred, None
        if out is None:
            raise RuntimeError("ZeRO-1's compressed sync needs the step's "
                               "residual (core/steps.py hands it over)")
        return out

    def group_key(self, key, i: int):
        if not self.policy.stochastic_rounding:
            return None
        if key is None:
            raise ValueError("stochastic rounding needs a key")
        return key.fold_in(COMM_STREAM, i)

    def zero1_reduce_scatter(self, rows: torch.Tensor, key,
                             with_error: bool):
        """ZeRO-1's compressed gradient reduce-scatter: ``rows`` [W,
        chunk] fp32 (row r rank r's shard of the flat gradients plus
        residual, zero-padded to whole blocks), each rank ending with the
        fp32 SUM of its row, and with ``with_error`` the quantization
        error ``[W, chunk]`` to keep as the residual.  Flat: one
        compressed reduce-scatter over the axis.  Hierarchical: an fp32
        all-to-all inside the fast group sums each member's rows over
        the group (level 1), then a compressed reduce-scatter across
        the slow group hands each rank its row (level 2); the error is
        level 2's, on the rows this rank quantized (level 1 is exact,
        so one rank of the group compensating is exact)."""
        self.setup()
        kw = self._comm_kw()
        if not self.hierarchical:
            return _reduce_scatter_rows(rows, self.group, key=key,
                                        with_error=with_error,
                                        tag="grad_sync", **kw)
        t = self._tiers
        chunk = rows.shape[1]
        by_local = rows.reshape(t.dcn, t.ici, chunk).transpose(0, 1)
        got = _all_to_all(by_local.contiguous(), t.fast, "grad_sync")
        partial = _sum_rows(got)                      # [dcn, chunk]
        shard, err = _reduce_scatter_rows(partial, t.slow, key=key,
                                          with_error=with_error,
                                          tag="grad_sync", **kw)
        if not with_error:
            return shard, None
        full = rows.new_zeros(t.dcn, t.ici, chunk)
        full[:, t.local] = err
        return shard, full.reshape(self.world, chunk)

    def zero1_chunk(self, size: int) -> int:
        """The row length of ZeRO-1's compressed reduce-scatter for a
        shard of ``size`` elements: whole blocks."""
        bs = self.policy.block_size
        return -(-size // bs) * bs

    def zero1_grad_wire_bytes(self, sizes: "Sequence[tuple[int, int]]"
                              ) -> "dict[str, int]":
        """What ZeRO-1's gradient sync records, by link, for its groups
        ``(shards, size)``: a sharded group's compressed reduce-scatter
        (hierarchical: the fp32 level 1 inside the fast group and the
        compressed level 2 across), a whole group's compressed psum
        (:meth:`step_wire_bytes` of one payload)."""
        mode, bs = self.policy.compress, self.policy.block_size
        out = {"ici": 0, "dcn": 0}
        for shards, size in sizes:
            if shards == 1:
                for k, v in self.step_wire_bytes([size],
                                                 bucketed=False).items():
                    out[k] += v
                continue
            chunk = self.zero1_chunk(size)
            if self.hierarchical:
                out["ici"] += 4 * self.world * chunk
                out["dcn"] += payload_bytes(self.dcn_size * chunk, mode, bs)
            else:
                out["dcn"] += payload_bytes(self.world * chunk, mode, bs)
        return out

    # -- ZeRO-1's updated-param gather -------------------------------------

    def zero1_gather_plan(self, flat) -> "list[list[tuple]]":
        """The buckets of ZeRO-1's explicit gather of one flat group
        (parallel/strategy.py ``_Flat``): its parameters in the next
        forward's consumption order, partitioned by
        ``gather_bucket_bytes`` (one bucket under ``barrier_sync`` or
        without buckets).  A bucket is, per rank, its ``(i, a, b)``
        pieces: parameter ``i``'s elements at ``[a, b)`` of that rank's
        shard."""
        order = _consumption_order(flax_paths(flat.names))
        gb = self.policy.gather_bucket_bytes
        if gb <= 0 or self.policy.barrier_sync:
            groups = [order]
        else:
            sizes = [flat.numels[i] * flat.itemsize for i in order]
            groups = [[order[j] for j in idxs]
                      for idxs in partition_buckets(sizes, gb)]
        plan = []
        for members in groups:
            per_rank = []
            for r in range(flat.shards):
                lo, hi = r * flat.size, (r + 1) * flat.size
                pieces = []
                for i in members:
                    o, n = flat.offsets[i], flat.numels[i]
                    a, b = max(o, lo), min(o + n, hi)
                    if a < b:
                        pieces.append((i, a - lo, b - lo))
                per_rank.append(pieces)
            plan.append(per_rank)
        return plan

    def _piece_lens(self, per_rank) -> "list[int]":
        """Each rank's element count in one gather bucket, padded to
        whole blocks under the int8 codec."""
        bs = self.policy.block_size
        lens = [sum(b - a for _, a, b in p) for p in per_rank]
        if self.policy.param_gather == "int8":
            lens = [-(-n // bs) * bs for n in lens]
        return lens

    def regather_params(self, flat, plan, shard: torch.Tensor,
                        out: torch.Tensor) -> None:
        """ZeRO-1's explicit gather: for each bucket of ``plan``, this
        rank's pieces of ``shard`` laid end to end, at ``param_gather``
        dtype, go to every rank in one uneven all-gather (an
        ``all_to_all_single`` whose input is the pieces once a rank and
        whose output is every rank's pieces, so no rank's row is padded
        to the longest; int8: its payload and its scales, one each);
        each rank's pieces are written to their places in ``out``, the
        whole flat vector.  Without ``barrier_sync`` a bucket's gather
        follows its own payload; with it every payload is built first
        (the monolithic A/B side)."""
        mode = self.policy.param_gather
        bs = self.policy.block_size
        me = self.index
        group = self.group

        def payload(per_rank):
            buf = shard.new_zeros(self._piece_lens(per_rank)[me])
            off = 0
            for _, a, b in per_rank[me]:
                buf[off:off + b - a] = shard[a:b]
                off += b - a
            return buf

        bufs = [payload(p) for p in plan] if self.policy.barrier_sync \
            else None
        for j, per_rank in enumerate(plan):
            buf = bufs[j] if bufs is not None else payload(per_rank)
            lens = self._piece_lens(per_rank)
            if mode == "none":
                got = _gather_uneven(buf, lens, group)
            elif mode == "bf16":
                got = _gather_uneven(buf.to(torch.bfloat16), lens, group)
            else:
                q, sc = compress_cast(buf.to(torch.float32), "int8", bs)
                got = decompress_cast(
                    _gather_uneven(q, lens, group),
                    _gather_uneven(sc, [n // bs for n in lens], group),
                    "int8", bs)
            got = got.to(out.dtype)
            off = 0
            for r, pieces in enumerate(per_rank):
                base, o = r * flat.size, off
                for _, a, b in pieces:
                    out[base + a:base + b] = got[o:o + b - a]
                    o += b - a
                off += lens[r]

    def zero1_gather_wire_bytes(self, flat, plan) -> int:
        """The wire bytes :meth:`regather_params` records for one group:
        every rank's pieces of each bucket once, at ``param_gather``
        dtype (int8: the payload and its scales)."""
        total = 0
        for per_rank in plan:
            n = sum(self._piece_lens(per_rank))
            mode = self.policy.param_gather
            if mode == "none":
                total += n * flat.itemsize
            else:
                total += payload_bytes(n, mode, self.policy.block_size)
        return total

    # -- the residual in checkpoints ---------------------------------------

    def gather_residual(self, r: torch.Tensor) -> torch.Tensor:
        """Every rank's ``r`` stacked to ``[W, *shape]`` along the
        compressed axes (collective)."""
        self.setup()
        g = self.group
        if self.world == 1 or g is None:
            return r.detach()[None].clone()
        if r.is_cuda and not _gloo(g):
            out = r.new_empty((self.world,) + tuple(r.shape))
            dist.all_gather_into_tensor(out, r.detach().contiguous(),
                                        group=g)
            return out
        host = r.detach().cpu().contiguous()
        parts = [torch.empty_like(host) for _ in range(self.world)]
        dist.all_gather(parts, host, group=g)
        return torch.stack(parts).to(r.device)

    def residual_row(self, saved: torch.Tensor) -> torch.Tensor:
        """This rank's residual from a saved ``[N, *shape]``: its own row
        when N is this world, else the rows' mean on every rank (the
        JAX reshard's mean-broadcast, exact in the injected sum
        ``(1/W) sum_i r_i``)."""
        return load_residual(saved, self.world, self.index)

    # -- the byte model ------------------------------------------------------

    def reduce_scatter_wire_bytes(self, n_elements: int) -> int:
        return payload_bytes(n_elements, self.policy.compress,
                             self.policy.block_size)

    def all_gather_wire_bytes(self, n_elements: int) -> int:
        return payload_bytes(n_elements, self.policy.compress,
                             self.policy.block_size)

    def psum_wire_bytes(self, n_elements: int) -> int:
        return (self.reduce_scatter_wire_bytes(n_elements)
                + self.all_gather_wire_bytes(n_elements))

    def psum_link_bytes(self, n_elements: int) -> dict:
        """Per-rank wire bytes of ONE mean-psum of ``n_elements`` by link
        tier (the JAX function): flat, both compressed phases on the
        slow tier; hierarchical, the level-2 phases on the 1/ici shard
        cross, levels 1 and 3 move fp32 inside the fast group."""
        if not self.hierarchical:
            return {"dcn": self.psum_wire_bytes(n_elements), "ici": 0}
        shard = -(-n_elements // self.ici_size)
        dcn = 2 * payload_bytes(shard, self.policy.compress,
                                self.policy.block_size)
        ici = 4 * n_elements + 4 * shard * self.ici_size
        return {"dcn": dcn, "ici": ici}

    def param_gather_wire_bytes(self, params: Mapping) -> int:
        """The JAX model of ZeRO-1's updated-param gather: each
        parameter whole at its dtype, or at ``param_gather``'s."""
        total = 0
        for leaf in params.values():
            n = _numel(leaf)
            if self.policy.param_gather == "none":
                total += n * _itemsize(leaf.dtype)
            else:
                total += payload_bytes(n, self.policy.param_gather,
                                       self.policy.block_size)
        return total

    def reduce_scatter_link_bytes(self, n_elements: int) -> dict:
        """Per-rank wire bytes of ONE compressed reduce-scatter of
        ``n_elements`` by link tier (ZeRO-1's gradient phase): flat, the
        codec payload on the slow tier; hierarchical, the level-2 payload
        of the 1/ici shard across, the fp32 level 1 inside."""
        if not self.hierarchical:
            return {"dcn": self.reduce_scatter_wire_bytes(n_elements),
                    "ici": 0}
        shard = -(-n_elements // self.ici_size)
        return {"dcn": payload_bytes(shard, self.policy.compress,
                                     self.policy.block_size),
                "ici": 4 * n_elements}

    def step_wire_bytes(self, numels: "Sequence[int]",
                        bucketed: bool = True) -> "dict[str, int]":
        """What :meth:`sync_step` records for gradients of ``numels``
        elements, by link (``"ici"``: inside a fast group; ``"dcn"``:
        across groups; a flat sync's groups span the whole axis): the
        JAX model's terms at the payloads the wire really carries, the
        rows padded to whole blocks."""
        bs, mode = self.policy.block_size, self.policy.compress
        if bucketed and self.policy.bucket_bytes > 0:
            sizes = [sum(numels[i] for i in b) for b in partition_buckets(
                [n * 4 for n in numels], self.policy.bucket_bytes)]
        else:
            sizes = list(numels)
        out = {"ici": 0, "dcn": 0}
        for n in sizes:
            if not self.hierarchical:
                out["dcn"] += 2 * payload_bytes(
                    padded_elements(n, self.world, bs), mode, bs)
                continue
            rows = padded_elements(n, self.ici_size, bs)
            chunk = rows // self.ici_size
            out["ici"] += 2 * 4 * rows           # fp32 levels 1 and 3
            out["dcn"] += 2 * payload_bytes(
                padded_elements(chunk, self.dcn_size, bs), mode, bs)
        if self.plain_axes:
            out["dcn"] += 2 * 4 * sum(numels)
        return out


def load_residual(saved: torch.Tensor, world: int,
                  index: int) -> torch.Tensor:
    """This rank's residual from a saved ``[N, *shape]`` (module
    ``GradSync.residual_row``)."""
    if saved.shape[0] == world:
        return saved[index]
    return saved.float().mean(0)


def build_grad_sync(strategy, mesh, policy, local: "int | None" = None,
                    hosts: "int | None" = None) -> Optional[GradSync]:
    """``(strategy, mesh, policy) -> GradSync`` or ``None`` (inert): the
    policy is off, the strategy does not compress (FSDP, SPMD, the
    pipeline: their params are sharded), the mesh has a non-data axis
    over 1, or no compressible axis remains (the JAX function).
    ``hosts`` / ``local``: the ranks' host layout (default: read from
    the group, a collective)."""
    policy = CommPolicy.resolve(policy)
    if not policy.enabled:
        return None
    if not getattr(strategy, "comm_compressible", False):
        _log.debug("comm policy inert: strategy %s does not support "
                   "compressed gradient collectives", strategy.name)
        return None
    extra = set(mesh.axis_names) - set(strategy.data_axis_names)
    if any(mesh.shape[a] > 1 for a in extra):
        _log.debug("comm policy inert: mesh has non-data axes %s",
                   sorted(extra))
        return None
    axes = policy.resolved_axes(mesh, strategy.data_axis_names, hosts)
    if not axes:
        return None
    return GradSync(mesh, axes, policy, strategy.data_axis_names,
                    zero1=getattr(strategy, "name", "") == "zero1",
                    local=local)


__all__ = ["COMM_STREAM", "CommState", "CommTx", "GradSync", "Tiers",
           "build_grad_sync", "compressed_all_gather", "compressed_psum",
           "compressed_reduce_scatter", "flax_paths", "hierarchical_psum",
           "hierarchy_groups", "inner_state_dict", "is_comm_state_dict",
           "load_residual", "padded_elements", "partition_buckets"]
