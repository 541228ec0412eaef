"""Collective wire-byte accounting over a record of the collectives run.

Counterpart of ``ray_lightning_tpu/comm/audit.py``.  The JAX audit reads
the collectives out of the compiled HLO text; an eager PyTorch step has
no program text, so here each rank *records* what it issues: the comm
layer (comm/collectives.py), the strategies (parallel/strategy.py) and
the mesh collectives that ``parallel/{layout,tensor,ring,pipeline}.py``
run on (parallel/mesh.py) call :func:`note` at each collective, and
while a :class:`CollectiveLog` is active (:func:`recording`) each call
appends one :class:`CollectiveRecord`: the op kind (the HLO names,
:data:`COLLECTIVE_OPS`), the wire element type (HLO spelling: ``s8``,
``u8``, ``bf16``, ``f32``...), the bytes and the group's global ranks.
With no log active a call costs one global read.

Bytes are charged as the JAX audit charges an HLO definition (per-rank
bytes on the wire under the ring cost, the common (N-1)/N factor
dropped):

==================  =========================================
op                  wire bytes charged
==================  =========================================
all-reduce          2 x bytes(result)
reduce-scatter      bytes(input)
all-gather          bytes(result)  (each rank receives the full output)
all-to-all          bytes(result)
collective-permute  bytes(result)  (one neighbour hop)
==================  =========================================

Per-link attribution (:func:`wire_bytes_by_link`) follows the JAX
function over each record's group: a group inside one block of
``ici_size`` consecutive ranks rides the fast link (``"ici"``: NVLink
between the cards of one host), a group spanning blocks the slow one
(``"dcn"``: the NIC between hosts).  The link constants are the H100's
published figures (:data:`NVLINK4_GBPS`, :data:`NIC_GBPS`); no TPU
figure carries over.

:func:`collective_kind` and :func:`event_link` classify torch.profiler
events (NCCL's ``ncclDevKernel_*`` / ``ncclKernel_*`` kernels, gloo's
``gloo:*`` record functions, c10d's ``nccl:*``), for the trace anatomy
to come (ROADMAP.md queue 1 item 13).
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Dict, Iterable, Optional, Tuple

import torch

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute")

#: torch dtype -> the HLO element-type name the JAX audit reports
DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
    torch.int16: "s16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64",
}

#: result-bytes multiplier a kind is charged (``None``: input bytes)
_WIRE_FACTOR = {
    "all-reduce": 2,
    "all-gather": 1,
    "reduce-scatter": None,
    "all-to-all": 1,
    "collective-permute": 1,
}


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective this rank issued (module docstring)."""

    op: str
    dtype: str
    nbytes: int
    group: "tuple[int, ...]"
    #: who issued it: ``"grad_sync"`` and ``"param_gather"`` (the comm
    #: plane), ``"ddp"`` / ``"zero1"`` (the strategies' own syncs),
    #: ``"metrics"``, ``"mesh"`` (the axis collectives), ...
    tag: str = ""


class CollectiveLog:
    """The records of one recording window, in issue order."""

    def __init__(self):
        self.records: "list[CollectiveRecord]" = []


_ACTIVE: "Optional[CollectiveLog]" = None


@contextlib.contextmanager
def recording(log: "Optional[CollectiveLog]" = None):
    """Record this process's collectives into ``log`` (a new one by
    default) for the ``with`` block; yields the log.  Windows do not
    nest: the inner one replaces the outer until it ends."""
    global _ACTIVE
    log = CollectiveLog() if log is None else log
    prev, _ACTIVE = _ACTIVE, log
    try:
        yield log
    finally:
        _ACTIVE = prev


def group_ranks(group) -> "tuple[int, ...]":
    """The global ranks of ``group`` (the default group's for ``None``);
    ``(0,)`` without a process group."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return (0,)
    if group is None:
        return tuple(range(dist.get_world_size()))
    return tuple(dist.get_process_group_ranks(group))


def note(op: str, tensor: torch.Tensor, group=None, tag: str = ""
         ) -> None:
    """Record one collective of kind ``op`` over ``group`` when a log is
    active.  ``tensor`` is the op's result (its input for a
    reduce-scatter), in the wire's element type."""
    log = _ACTIVE
    if log is None:
        return
    factor = _WIRE_FACTOR[op]
    nbytes = tensor.numel() * tensor.element_size()
    if factor is not None:
        nbytes *= factor
    name = DTYPE_NAMES.get(tensor.dtype, str(tensor.dtype))
    log.records.append(CollectiveRecord(op, name, int(nbytes),
                                        group_ranks(group), tag))


def _records(log) -> "Iterable[CollectiveRecord]":
    return log.records if isinstance(log, CollectiveLog) else log


def collective_wire_bytes(log) -> "Dict[Tuple[str, str], int]":
    """``(op, dtype) -> wire bytes`` over the records (the JAX function
    over HLO definitions)."""
    out: "Dict[Tuple[str, str], int]" = {}
    for r in _records(log):
        out[(r.op, r.dtype)] = out.get((r.op, r.dtype), 0) + r.nbytes
    return out


def total_wire_bytes(log, *, ops=None, dtypes=None, tags=None) -> int:
    """Sum of the records' bytes, optionally filtered to the given op
    kinds, element types and issuers."""
    return sum(r.nbytes for r in _records(log)
               if (ops is None or r.op in ops)
               and (dtypes is None or r.dtype in dtypes)
               and (tags is None or r.tag in tags))


# -- per-link attribution (hierarchical collectives) -----------------------


def crosses_dcn(groups, ici_size: int) -> bool:
    """Whether a collective's groups span blocks of ``ici_size``
    consecutive ranks (the JAX function).  Group-less (full-span)
    collectives cross by definition."""
    if not groups:
        return True
    return any(len({r // ici_size for r in g}) > 1 for g in groups)


def wire_bytes_by_link(log, ici_size: int, *, ops=None, dtypes=None,
                       tags=None) -> "Dict[str, int]":
    """``{"ici": bytes, "dcn": bytes}`` over the records: a collective
    whose group stays within one ``ici_size``-rank block charges the
    fast tier, anything spanning blocks the slow one.  Filters as in
    :func:`total_wire_bytes`."""
    out = {"ici": 0, "dcn": 0}
    for r in _records(log):
        if (ops is not None and r.op not in ops) \
                or (dtypes is not None and r.dtype not in dtypes) \
                or (tags is not None and r.tag not in tags):
            continue
        out["dcn" if crosses_dcn([r.group], ici_size) else "ici"] \
            += r.nbytes
    return out


def declared_dcn_bytes(op_bytes: dict, multi_host: bool) -> int:
    """Slow-link bytes of a ``step_collective_bytes`` declaration: the
    ``_dcn``-suffixed ops when a hierarchical sync attributed them,
    else (ranks on more than one host) everything not pinned to the
    fast tier; one host has no slow hop (the JAX function, whose
    ``multi_process`` is the port's ``multi_host``)."""
    dcn = sum(b for op, b in (op_bytes or {}).items()
              if op.endswith("_dcn"))
    if dcn == 0 and multi_host:
        dcn = sum(b for op, b in (op_bytes or {}).items()
                  if not op.endswith("_ici"))
    return int(dcn)


# -- trace-event classification --------------------------------------------

#: event-name spellings of each kind: NCCL kernels
#: (``ncclDevKernel_AllReduce_Sum_f32_RING_LL``), c10d's record functions
#: (``nccl:all_reduce``, ``gloo:all_to_all``) and the HLO names
_KIND_SPELLINGS = (
    ("reduce-scatter", ("reducescatter", "reduce_scatter",
                        "reduce-scatter", "_reduce_scatter_base")),
    ("all-reduce", ("allreduce", "all_reduce", "all-reduce")),
    ("all-gather", ("allgather", "all_gather", "all-gather")),
    ("all-to-all", ("alltoall", "all_to_all", "all-to-all")),
    ("collective-permute", ("sendrecv", "collective-permute", ":send",
                            ":recv", "_send", "_recv")),
)


def collective_kind(name: str) -> "str | None":
    """The :data:`COLLECTIVE_OPS` kind of a torch.profiler event name,
    or ``None`` for a non-collective event.  Only NCCL / gloo / c10d
    events and HLO-style names count; a compute kernel named after its
    data (``flash``, ``philox``) never does."""
    n = name.lower()
    if "flash" in n or "philox" in n:
        return None
    comm = (n.startswith(("nccl", "gloo:", "c10d")) or "nccl" in n
            or any(op in n for op in COLLECTIVE_OPS))
    if not comm:
        return None
    for kind, spellings in _KIND_SPELLINGS:
        if any(s in n for s in spellings):
            return kind
    return None


_RANKS_RE = re.compile(r"\[([0-9, ]*)\]")


def event_link(args: dict, ici_size: int, multi_host: bool) -> str:
    """``"ici"`` or ``"dcn"`` for one collective trace event: the ranks
    its ``args`` name (c10d's ``Process Group Ranks``, or
    ``group_ranks``) decide through :func:`crosses_dcn`; without them
    the topology does: a multi-host run's group-less collective crosses,
    one host has no slow hop (the JAX function's rule)."""
    for key in ("Process Group Ranks", "group_ranks"):
        raw = (args or {}).get(key)
        if raw is None:
            continue
        if isinstance(raw, str):
            m = _RANKS_RE.search(raw)
            raw = ([int(x) for x in m.group(1).split(",") if x.strip()]
                   if m else None)
        if raw:
            return "dcn" if crosses_dcn([list(raw)], ici_size) else "ici"
    return "dcn" if multi_host else "ici"


# -- byte -> seconds ---------------------------------------------------------

#: H100 SXM: NVLink 4, 18 links of 25 GB/s a direction: 450 GB/s a
#: direction a card (900 GB/s both ways), NVIDIA's published figure
NVLINK4_GBPS = 450.0
#: one ConnectX-7 NIC a card, 400 Gbit/s = 50 GB/s (the DGX H100's
#: compute fabric), NVIDIA's published figure
NIC_GBPS = 50.0
#: the fast and the slow link a collective can ride, as the planner
#: will read them (``ici`` / ``dcn`` name the two tiers)
INTRA_HOST_GBPS = NVLINK4_GBPS
INTER_HOST_GBPS = NIC_GBPS


def bytes_to_seconds(nbytes, gbps: float) -> float:
    """Seconds the given wire payload occupies a ``gbps``-GB/s link;
    ``nbytes`` may be an int or an op -> bytes mapping (summed).
    Strictly monotone in bytes (the JAX function)."""
    if isinstance(nbytes, dict):
        nbytes = sum(nbytes.values())
    if gbps <= 0:
        raise ValueError(f"bandwidth must be positive, got {gbps}")
    return float(nbytes) / (gbps * 1e9)


__all__ = ["COLLECTIVE_OPS", "CollectiveLog", "CollectiveRecord",
           "DTYPE_NAMES", "INTER_HOST_GBPS", "INTRA_HOST_GBPS", "NIC_GBPS",
           "NVLINK4_GBPS", "bytes_to_seconds", "collective_kind",
           "collective_wire_bytes", "crosses_dcn", "declared_dcn_bytes",
           "event_link", "group_ranks", "note", "recording",
           "total_wire_bytes", "wire_bytes_by_link"]
