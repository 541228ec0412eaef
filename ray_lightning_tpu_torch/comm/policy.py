"""Per-axis compression policy for the gradient collectives.

Counterpart of ``ray_lightning_tpu/comm/policy.py``: the same fields,
defaults, validation, construction paths and ``RLT_COMM*`` knobs.
``CommPolicy`` decides WHICH mesh axes carry compressed reductions and
how.

Construction paths (first match wins):

- ``Trainer(comm_policy=CommPolicy(...))`` — full control;
- ``Trainer(comm_policy="int8")`` — compress with defaults;
- ``Trainer(comm_policy={...})`` — kwargs dict;
- ``RLT_COMM=int8`` (+ ``RLT_COMM_AXES=data``, ``RLT_COMM_BLOCK=64``,
  ``RLT_COMM_SR=1``, ``RLT_COMM_EF=0``, ``RLT_COMM_PARAM_GATHER=bf16``,
  ``RLT_COMM_HIER=auto|K``, ``RLT_COMM_BUCKET_BYTES=N``,
  ``RLT_COMM_BARRIER=1``, ``RLT_ZERO1_GATHER_BUCKET_BYTES=N``) — env
  knobs, read when the Trainer argument is ``None``.

The two topology rules, as the port reads them.  In the JAX package a
process holds many chips and ``axes=None`` compresses only when the run
spans processes, whose hop is the slow datacenter link.  Here every rank
is a process, so the counterpart of "across processes" is **across
hosts**: ``axes=None`` compresses the strategy's data axes only when the
ranks run on more than one host (``NODE_RANK``, which the plugins set);
on one box the auto policy stays inert and the fp32 NVLink traffic is
left alone.  ``hierarchy=HIER_AUTO`` sizes the fast tier from the ranks
one host runs (the JAX package reads ``jax.local_device_count()``, the
chips of one host): the ranks of a host are consecutive, so the fast
groups are the per-host blocks.

The resolved policy is a frozen dataclass that pickles with the trainer
to the workers; :meth:`CommPolicy.worker_env` carries the knobs too
(``RayPlugin`` adds it to each worker's environment), so a nested fit in
a worker resolves the same policy.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

VALID_COMPRESS = ("none", "int8", "bf16", "fp8", "int4")
VALID_PARAM_GATHER = ("none", "bf16", "int8")

#: ``hierarchy`` sentinel: size the fast tier from the ranks one host
#: runs (module docstring)
HIER_AUTO = -1


def _env_flag(name: str, default: bool) -> bool:
    raw = os.environ.get(name, "").strip()
    if raw in ("0", "false", "False"):
        return False
    if raw in ("1", "true", "True"):
        return True
    return default


def host_layout() -> "tuple[int, int]":
    """``(hosts, ranks_per_host)`` of the default process group, from
    each rank's ``NODE_RANK`` (a collective when a group is active:
    every rank calls it); ``(1, 1)`` without a group.  Hosts holding
    unequal rank counts report the smallest count."""
    from ray_lightning_tpu_torch.parallel.strategy import gather_objects
    nodes = gather_objects(int(os.environ.get("NODE_RANK", "0") or 0))
    counts: "dict[int, int]" = {}
    for n in nodes:
        counts[n] = counts.get(n, 0) + 1
    return len(counts), min(counts.values())


@dataclasses.dataclass(frozen=True)
class CommPolicy:
    """How cross-replica gradient collectives compress (the JAX class's
    fields, module docstring for the topology rules).

    compress: payload dtype of the gradient reduction over the selected
        axes: ``"int8"`` (blockwise scales), ``"fp8"`` (e4m3, one byte,
        relative error bound), ``"int4"`` (nibble-packed), ``"bf16"``
        (plain cast) or ``"none"`` (off; the default: the step issues
        exactly the uncompressed collectives).
    axes: mesh axes whose reduction compresses; ``None`` = auto (the
        strategy's data axes when the ranks span hosts).
    block_size: scale-block length (int8/fp8/int4; even for int4).
    stochastic_rounding: unbiased quantizer, one uniform draw an
        element, from the step's keyed Philox (ops/random.py).
    error_feedback: carry each rank's quantization error in the
        optimizer state and add it to the next step's gradients.
    param_gather: dtype of ZeRO-1's updated-param all-gather
        (``"none"``: the parameter dtype; ``"bf16"`` / ``"int8"``).
    hierarchy: two-level reduction: ``0`` flat, ``HIER_AUTO`` the
        ranks of one host, ``K >= 2`` an explicit fast-group size; fp32
        within each group, the codec only across groups.
    bucket_bytes: ``0`` one collective a gradient; ``> 0`` gradients
        coalesced into buckets of about this many fp32 bytes, one
        collective a bucket.
    barrier_sync: A/B knob: every bucket waits for the whole gradient
        tree (and with ``gather_bucket_bytes`` the gather for the whole
        updated tree).
    gather_bucket_bytes: ``> 0`` makes ZeRO-1's updated-param gather
        explicit and bucketed in the next forward's consumption order.
    """

    compress: str = "none"
    axes: Optional[tuple] = None
    block_size: int = 64
    stochastic_rounding: bool = False
    error_feedback: bool = True
    param_gather: str = "none"
    hierarchy: int = 0
    bucket_bytes: int = 0
    barrier_sync: bool = False
    gather_bucket_bytes: int = 0

    def __post_init__(self):
        if self.compress not in VALID_COMPRESS:
            raise ValueError(
                f"comm_policy compress {self.compress!r}; "
                f"options: {VALID_COMPRESS}")
        if self.param_gather not in VALID_PARAM_GATHER:
            raise ValueError(
                f"comm_policy param_gather {self.param_gather!r}; "
                f"options: {VALID_PARAM_GATHER}")
        if self.block_size <= 0:
            raise ValueError("comm_policy block_size must be positive")
        if self.compress == "int4" and self.block_size % 2:
            raise ValueError("comm_policy int4 needs an even block_size "
                             "(two values pack per byte)")
        if self.hierarchy < HIER_AUTO or self.hierarchy == 1:
            raise ValueError(
                f"comm_policy hierarchy {self.hierarchy!r}: 0 (flat), "
                f"{HIER_AUTO} (auto: the ranks of one host) or a fast "
                f"group size >= 2")
        if self.bucket_bytes < 0:
            raise ValueError("comm_policy bucket_bytes must be >= 0")
        if self.gather_bucket_bytes < 0:
            raise ValueError(
                "comm_policy gather_bucket_bytes must be >= 0")
        if self.axes is not None:
            object.__setattr__(self, "axes", tuple(self.axes))

    # -- construction ----------------------------------------------------

    @classmethod
    def resolve(cls, value) -> "CommPolicy":
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls(compress=value)
        if isinstance(value, dict):
            return cls(**value)
        if value is not None:
            raise TypeError(f"bad comm_policy: {value!r}")
        compress = os.environ.get("RLT_COMM", "none").strip() or "none"
        axes_raw = os.environ.get("RLT_COMM_AXES", "").strip()
        axes = tuple(a for a in axes_raw.split(",") if a) or None
        hier_raw = os.environ.get("RLT_COMM_HIER", "0").strip() or "0"
        hierarchy = HIER_AUTO if hier_raw == "auto" else int(hier_raw)
        return cls(
            compress=compress,
            axes=axes,
            block_size=int(os.environ.get("RLT_COMM_BLOCK", "64")),
            stochastic_rounding=_env_flag("RLT_COMM_SR", False),
            error_feedback=_env_flag("RLT_COMM_EF", True),
            param_gather=os.environ.get(
                "RLT_COMM_PARAM_GATHER", "none").strip() or "none",
            hierarchy=hierarchy,
            bucket_bytes=int(os.environ.get("RLT_COMM_BUCKET_BYTES", "0")),
            barrier_sync=_env_flag("RLT_COMM_BARRIER", False),
            gather_bucket_bytes=int(os.environ.get(
                "RLT_ZERO1_GATHER_BUCKET_BYTES", "0")),
        )

    # -- queries ---------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self.compress != "none"

    def resolved_axes(self, mesh, data_axis_names,
                      hosts: "int | None" = None) -> tuple:
        """Which of ``mesh``'s axes this policy compresses: the explicit
        ``axes``, else (auto) the strategy's data axes only when the
        ranks span more than one host (``hosts``; default
        :func:`host_layout`'s, a collective).  Only data axes of size
        > 1 qualify."""
        if not self.enabled:
            return ()
        if self.axes is not None:
            candidates = self.axes
        else:
            if hosts is None:
                hosts = host_layout()[0]
            candidates = tuple(data_axis_names) if hosts > 1 else ()
        return tuple(a for a in candidates
                     if a in data_axis_names and a in mesh.axis_names
                     and mesh.shape[a] > 1)

    def resolved_hierarchy(self, world: int,
                           local: "int | None" = None) -> "tuple[int, int]":
        """``(fast, slow)`` sizes of the two-level reduction over a
        ``world``-rank axis product: ``(1, world)`` = flat (off, invalid,
        or the whole axis on one tier).  ``HIER_AUTO`` takes ``local``
        (default :func:`host_layout`'s ranks a host, a collective); the
        ranks of a host are consecutive (rank = host * local + index),
        as the plugins number them."""
        h = self.hierarchy
        if h == HIER_AUTO:
            h = host_layout()[1] if local is None else int(local)
        if h <= 1 or h >= world or world % h:
            return (1, world)
        return (h, world // h)

    # -- env round-trip --------------------------------------------------

    def worker_env(self) -> dict:
        """Env mapping reproducing this policy via :meth:`resolve` in a
        worker process."""
        if not self.enabled:
            return {}
        env = {
            "RLT_COMM": self.compress,
            "RLT_COMM_BLOCK": str(self.block_size),
            "RLT_COMM_SR": "1" if self.stochastic_rounding else "0",
            "RLT_COMM_EF": "1" if self.error_feedback else "0",
            "RLT_COMM_PARAM_GATHER": self.param_gather,
            "RLT_COMM_HIER": ("auto" if self.hierarchy == HIER_AUTO
                              else str(self.hierarchy)),
            "RLT_COMM_BUCKET_BYTES": str(self.bucket_bytes),
            "RLT_COMM_BARRIER": "1" if self.barrier_sync else "0",
            "RLT_ZERO1_GATHER_BUCKET_BYTES":
                str(self.gather_bucket_bytes),
        }
        if self.axes is not None:
            env["RLT_COMM_AXES"] = ",".join(self.axes)
        return env


__all__ = ["CommPolicy", "HIER_AUTO", "VALID_COMPRESS",
           "VALID_PARAM_GATHER", "host_layout"]
