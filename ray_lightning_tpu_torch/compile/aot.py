"""Kernel builds overlapped with fit set-up, and the planner's verify.

Counterpart of ``ray_lightning_tpu/compile/aot.py``.  What a first step
waits on in the port is not an XLA compile but the ``nvcc`` builds of
the kernels it launches (ops/_kernels.py): :class:`AotPrecompiler`
runs them on one background thread while state init, the rendezvous
and the dataset upload run, and ``barrier()`` comes before the first
step.  As in the JAX package it engages only with the compile cache
active (compile/cache.py: the builds then land where every later
process finds them) and ``RLT_AOT_PRECOMPILE=0`` turns it off; a
failed build is soft (the step builds at its first launch, as
without the precompiler).

The planner's verify step (:func:`compile_scored`) takes the place of
the JAX package's AOT compiles of the top-k candidates: each runs ONE
training step of its candidate in fake-tensor mode
(``torch._subclasses.fake_tensor.FakeTensorMode``: no card memory, no
launch) and reads two things from it:

- the peak memory of the step, from
  ``torch.distributed._tools.mem_tracker.MemTracker`` over the state's
  tensors and everything the step makes (the stand-in for XLA's
  ``memory_analysis``);
- the wire bytes of its collectives, from the port's
  ``CollectiveLog`` (comm/audit.py: every collective notes itself
  there before it runs), with the collectives themselves answered at
  once by a fake process group (:func:`fake_collectives`; the stand-in
  for the HLO audit).

Both are pure functions of the config and the shapes, so every rank
agrees on one winner without a collective; the wall seconds are
recorded and never rank.  A program with a ``key`` is verified once a
process: re-planning the same shapes reads its earlier result (the
JAX re-plan is a compile-cache hit the same way).
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

_log = logging.getLogger(__name__)

#: kill switch: RLT_AOT_PRECOMPILE=0 leaves every build to its first use
ENV_AOT = "RLT_AOT_PRECOMPILE"


class AotPrecompiler:
    """Runs submitted kernel builds in order on one daemon thread;
    ``barrier()`` waits for everything submitted so far."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.results: "dict[str, Any]" = {}   # name -> seconds | exception
        self._queue: "list[tuple[str, Callable]]" = []
        self._pending = 0
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def resolve(cls) -> "AotPrecompiler":
        """Enabled only with the compile cache active and
        ``RLT_AOT_PRECOMPILE`` not ``0`` (module docstring)."""
        from ray_lightning_tpu_torch.compile import cache as _cache
        enabled = (os.environ.get(ENV_AOT, "").strip() != "0"
                   and _cache.active_dir() is not None)
        return cls(enabled=enabled)

    def submit(self, name: str, build: Callable[[], Any]) -> None:
        """Queue ``build()`` under ``name``; no-op when disabled."""
        if not self.enabled:
            return
        with self._cond:
            self._queue.append((name, build))
            self._pending += 1
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="rlt-aot-precompile")
                self._thread.start()

    def submit_kernels(self, name: str, kernels=None) -> None:
        """Queue the nvcc builds of ``kernels`` (default: every kernel
        the package defines) when a card is present (nothing launches on
        the CPU)."""
        import torch
        if not torch.cuda.is_available():
            return
        from ray_lightning_tpu_torch.ops import _kernels
        self.submit(name, lambda: _kernels.build(kernels))

    def _run(self) -> None:
        while True:
            with self._cond:
                if not self._queue:
                    return
                name, build = self._queue.pop(0)
            t0 = time.monotonic()
            try:
                build()
                self.results[name] = time.monotonic() - t0
            except Exception as e:   # noqa: BLE001 - soft fallback
                self.results[name] = e
                _log.info("precompile of %s failed (%s: %s); it builds at "
                          "its first use", name, type(e).__name__, e)
            finally:
                with self._cond:
                    self._pending -= 1
                    self._cond.notify_all()

    def barrier(self, timeout: Optional[float] = None) -> "dict[str, Any]":
        """Wait for every submitted build; returns the results map."""
        with self._cond:
            self._cond.wait_for(lambda: self._pending == 0, timeout=timeout)
        return dict(self.results)

    def succeeded(self, name: str) -> bool:
        return isinstance(self.results.get(name), float)


# -- the planner's verify step ---------------------------------------------

class _DoneWork:
    """A finished collective's work handle."""

    def wait(self, timeout=None) -> bool:
        return True

    def is_completed(self) -> bool:
        return True


_FAKE_OPS = ("all_reduce", "all_gather", "all_gather_into_tensor",
             "reduce_scatter_tensor", "all_to_all_single", "broadcast",
             "isend", "irecv", "send", "recv", "barrier")


@contextlib.contextmanager
def fake_collectives():
    """A fake process group for the ``with`` block: every collective
    entry point of ``torch.distributed`` the port calls returns at once
    (a finished work when asked for one) and moves nothing; the port's
    own audit notes (comm/audit.py) are taken before each call, so a
    ``CollectiveLog`` still records what the step issues."""
    import torch.distributed as dist
    saved = {name: getattr(dist, name) for name in _FAKE_OPS
             + ("batch_isend_irecv",) if hasattr(dist, name)}

    def done(*_a, **_k):
        return _DoneWork()

    try:
        for name in saved:
            setattr(dist, name, done)
        dist.batch_isend_irecv = lambda ops: [_DoneWork() for _ in ops]
        yield
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


@dataclass
class FakeProgram:
    """One candidate's step for :func:`compile_scored`: ``build()`` runs
    inside a fresh fake mode and returns ``(step, args, state)``, the
    step to call once on ``args`` and the tensors that exist before it
    (parameters, optimizer state, batch); ``ici_size`` (hierarchical
    comm candidates) splits the wire bytes by link."""

    name: str
    build: Callable
    ici_size: int = 0
    #: what the result depends on (the planner's: module config,
    #: candidate, batch shapes, world, device); None: never memoized
    key: Optional[tuple] = None


#: verify results by program key, this process
_SCORED: "dict[tuple, ScoredCompile]" = {}


def clear_scored() -> None:
    """Forget the memoized verify results (tests)."""
    _SCORED.clear()


@dataclass
class ScoredCompile:
    """What one verified candidate yields (the JAX fields: the
    ``*_bytes`` of ``memory_analysis`` become the fake step's state and
    transient bytes, ``seconds`` the step's host wall)."""

    name: str
    seconds: float = 0.0
    argument_bytes: int = 0        # the state before the step
    output_bytes: int = 0
    temp_bytes: int = 0            # the step's peak beyond the state
    alias_bytes: int = 0
    wire_bytes: int = 0
    wire_bytes_dcn: int = 0
    wire_bytes_ici: int = 0
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None

    @property
    def peak_bytes(self) -> int:
        return max(0, self.argument_bytes + self.output_bytes
                   + self.temp_bytes - self.alias_bytes)

    def to_dict(self) -> dict:
        return {
            "compile_seconds": round(self.seconds, 6),
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "alias_bytes": self.alias_bytes,
            "peak_bytes": self.peak_bytes,
            "wire_bytes": self.wire_bytes,
            "wire_bytes_dcn": self.wire_bytes_dcn,
            "wire_bytes_ici": self.wire_bytes_ici,
            "error": self.error,
        }


#: collective issuers whose bytes the strategies' declarations leave out
UNDECLARED_TAGS = ("metrics",)


def _nbytes(tensors) -> int:
    seen: set = set()
    total = 0
    for t in tensors:
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def score_one(program: FakeProgram) -> ScoredCompile:
    """Run one :class:`FakeProgram` (module docstring); soft on
    failure."""
    import torch
    from torch.distributed._tools.mem_tracker import MemTracker

    from ray_lightning_tpu_torch.comm import audit
    from ray_lightning_tpu_torch.core.remat import fake_mode

    t0 = time.monotonic()
    out = ScoredCompile(name=program.name)
    try:
        with fake_mode(), fake_collectives():
            step, args, state = program.build()
            state = [t for t in state if isinstance(t, torch.Tensor)]
            tracker = MemTracker()
            tracker.track_external(*state)
            with audit.recording() as log, tracker:
                step(*args)
            snap = tracker.get_tracker_snapshot("peak")
        peak = max((int(v["Total"]) for v in snap.values()), default=0)
        out.argument_bytes = _nbytes(state)
        out.temp_bytes = max(0, peak - out.argument_bytes)
        records = [r for r in log.records if r.tag not in UNDECLARED_TAGS]
        out.wire_bytes = audit.total_wire_bytes(records)
        if program.ici_size > 1:
            link = audit.wire_bytes_by_link(records, program.ici_size)
            out.wire_bytes_dcn, out.wire_bytes_ici = link["dcn"], link["ici"]
    except Exception as e:   # noqa: BLE001 - per-candidate soft fail
        _log.debug("verify of %s failed", program.name, exc_info=True)
        out.error = f"{type(e).__name__}: {e}"
    out.seconds = time.monotonic() - t0
    return out


def compile_scored(programs: "list[FakeProgram]"
                   ) -> "dict[str, ScoredCompile]":
    """Verify each candidate program in turn (one process, no card),
    reading a keyed program's earlier result (module docstring);
    failure is per program, as an error entry (never memoized)."""
    out = {}
    for p in programs:
        hit = _SCORED.get(p.key) if p.key is not None else None
        if hit is None:
            hit = score_one(p)
            if p.key is not None and hit.ok:
                _SCORED[p.key] = hit
        out[p.name] = hit
    return out


# -- abstract-shape helpers ------------------------------------------------

def batch_like(host_batch, device="meta", lead: int = 1):
    """``host_batch``'s leaves (tensors or arrays, in tuples, lists and
    dicts) as empty tensors of their dtypes on ``device``, each leading
    dim times ``lead``: shapes only (the meta device, or a fake mode's
    device for the verify step)."""
    import numpy as np
    import torch

    def leaf(x):
        if isinstance(x, torch.Tensor):
            shape, dtype = tuple(x.shape), x.dtype
        else:
            a = np.asarray(x)
            shape = a.shape
            dtype = torch.from_numpy(np.zeros((), a.dtype)).dtype
        if lead > 1 and shape:
            shape = (shape[0] * lead,) + tuple(shape[1:])
        return torch.empty(shape, dtype=dtype, device=device)

    return _map_leaves(leaf, host_batch)


def _map_leaves(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def global_batch_abstract(host_batch, process_count: int):
    """The global batch's shapes as meta tensors: a rank's batch with
    its leading dim times ``process_count`` (the JAX function; each
    rank's step then takes its 1/W shard of it)."""
    return batch_like(host_batch, "meta", process_count)


def stack_abstract(abstract_batch, k: int):
    """Shapes of ``k`` stacked batches (a ``steps_per_execution`` chunk:
    one leading dim)."""
    import torch
    return _map_leaves(lambda t: torch.empty((k,) + tuple(t.shape),
                                             dtype=t.dtype, device="meta"),
                       abstract_batch)


__all__ = ["AotPrecompiler", "ENV_AOT", "FakeProgram", "ScoredCompile",
           "UNDECLARED_TAGS", "batch_like", "clear_scored", "compile_scored",
           "fake_collectives",
           "global_batch_abstract", "score_one", "stack_abstract"]
