"""Deterministic fault injection for the elastic plane.

Counterpart of ``ray_lightning_tpu/elastic/faults.py``, kept as the
port's own copy.  Chaos tests of a fault-tolerance subsystem need
reproducible faults: "kill rank 1 at step 5" means exactly that, every
run.  A :class:`FaultSpec` names one fault:

- ``kill:rank=K,step=S[,code=C]``: hard process exit (``os._exit``: no
  exception, no teardown; the preemption model);
- ``wedge:rank=K,step=S``: the rank stops making progress without dying
  (it sleeps forever and its connection stays open).  Until the
  heartbeat watchdog is ported (ROADMAP.md queue 1 item 13) the
  plugin's ``timeout_s`` catches it;
- ``slow:rank=K,step=S[,seconds=T,count=N]``: the rank stalls ``T``
  seconds on every step from ``S`` on (a straggler); ``count=N`` (N >
  1) bounds it to steps ``[S, S+N)``, so it clears;
- ``snapkill:rank=K,step=S[,code=C]``: hard exit in the middle of an
  async snapshot write: it fires in ``Snapshotter.maybe_snapshot``
  right after the save is dispatched, so the step's directory never
  commits (elastic/driver.py ``latest_snapshot_step`` must not list
  it);
- ``peerdrop:rank=K,step=S[,count=N]``: drop the next N inbound
  peer-channel frames on the rank (cluster/worker_state.py), which the
  parity tick's skip-and-continue must absorb.  A ``FleetServer``
  reads it as N dropped KV ships (serve/fleet/router.py).

``RLT_FAULT`` takes a semicolon-separated list of specs
(``kill:rank=1,step=5;kill:rank=2,step=9``); a parse error names the
offending clause.  Every spec also takes ``restart=R``: armed only
during elastic attempt R (a replayed segment crosses the fault step
again, so ``restart=0`` keeps "exactly one preemption" expressible).

:class:`FaultInjector` is a callback armed with the specs; a worker's
``Trainer`` installs it when ``RLT_FAULT`` is in its environment
(``Trainer._run_stage``), so a test arms faults with
``RayPlugin(..., worker_env={"RLT_FAULT": "kill:rank=1,step=5"})``
alone.  kill, wedge and snapkill take the whole process down: arm them
only on actor workers (an in-process fit would kill the driver).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import List, Optional

from ray_lightning_tpu_torch.core.callbacks import Callback

_log = logging.getLogger(__name__)

ENV_FAULT = "RLT_FAULT"

VALID_KINDS = ("kill", "wedge", "slow", "snapkill", "peerdrop")

#: distinctive default exit code so a driver log line can tell an
#: injected kill from a real crash
DEFAULT_EXIT_CODE = 43


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault: ``kind`` at (``rank``, ``step``)."""

    kind: str
    rank: int
    step: int
    exit_code: int = DEFAULT_EXIT_CODE
    seconds: float = 1.0
    count: int = 1
    #: arm only on this elastic restart (None = every attempt).  A
    #: replayed segment re-crosses the fault step; ``restart=0`` makes
    #: "one preemption" expressible in a deterministic harness.
    restart: Optional[int] = None

    def __post_init__(self):
        if self.kind not in VALID_KINDS:
            raise ValueError(
                f"fault kind {self.kind!r}; options: {VALID_KINDS}")
        if self.rank < 0:
            raise ValueError("fault rank must be >= 0")
        if self.step < 1:
            raise ValueError("fault step must be >= 1 (steps are "
                             "counted post-increment)")
        if self.seconds <= 0:
            raise ValueError("fault seconds must be positive")
        if self.count < 1:
            raise ValueError("fault count must be >= 1")

    def should_fire(self, rank: int, step: int,
                    restarts: int = 0) -> bool:
        """kill/wedge/snapkill/peerdrop fire once at the first step >=
        ``step`` on the target rank; slow fires on every such step —
        bounded to steps ``[step, step + count)`` when ``count > 1``,
        so a straggler that CLEARS (the incident plane's close path)
        is expressible; the ``count=1`` default keeps the legacy
        unbounded straggler.  With ``restart=R`` set, only during
        elastic attempt R."""
        if self.restart is not None and restarts != self.restart:
            return False
        if rank != self.rank or step < self.step:
            return False
        if self.kind == "slow" and self.count > 1 \
                and step >= self.step + self.count:
            return False
        return True

    def describe(self) -> str:
        extra = ""
        if self.kind in ("kill", "snapkill"):
            extra = f",code={self.exit_code}"
        elif self.kind == "slow":
            extra = f",seconds={self.seconds}"
            if self.count > 1:
                extra += f",count={self.count}"
        elif self.kind == "peerdrop":
            extra = f",count={self.count}"
        if self.restart is not None:
            extra += f",restart={self.restart}"
        return f"{self.kind}:rank={self.rank},step={self.step}{extra}"


def parse_fault(spec: str) -> FaultSpec:
    """``"kill:rank=1,step=5"`` → :class:`FaultSpec`.  Raises
    ``ValueError`` on malformed input (the selfcheck pins this)."""
    spec = spec.strip()
    if ":" not in spec:
        raise ValueError(
            f"fault spec {spec!r} must look like "
            f"'kill:rank=K,step=S' (kinds: {VALID_KINDS})")
    kind, _, rest = spec.partition(":")
    kw: dict = {}
    for part in rest.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"fault spec field {part!r} is not key=value")
        key, _, val = part.partition("=")
        key = key.strip()
        if key in ("rank", "step", "code", "exit_code", "count",
                   "restart"):
            kw["exit_code" if key == "code" else key] = int(val)
        elif key == "seconds":
            kw["seconds"] = float(val)
        else:
            raise ValueError(f"unknown fault spec field {key!r}")
    if "rank" not in kw or "step" not in kw:
        raise ValueError(f"fault spec {spec!r} needs rank= and step=")
    return FaultSpec(kind=kind.strip(), **kw)


def parse_faults(raw: str) -> List[FaultSpec]:
    """Semicolon-separated fault list → specs; a bad clause raises
    naming ITSELF, not the whole string (the chaos matrix's parse
    contract)."""
    specs = []
    for clause in raw.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        try:
            specs.append(parse_fault(clause))
        except ValueError as e:
            raise ValueError(
                f"bad fault clause {clause!r} in {ENV_FAULT}: {e}"
            ) from e
    if not specs:
        raise ValueError(f"{ENV_FAULT} is set but names no fault")
    return specs


def _die(spec: FaultSpec, step: int, where: str) -> None:
    _log.warning("fault injector: killing rank %d at step %d %s "
                 "(exit %d)", spec.rank, step, where, spec.exit_code)
    # flush the log line before the no-cleanup exit
    logging.shutdown()
    os._exit(spec.exit_code)


class FaultInjector(Callback):
    """Callback arming one or more :class:`FaultSpec` against the run."""

    needs_batch = False   # fires on (rank, step) alone

    def __init__(self, specs):
        if isinstance(specs, FaultSpec):
            specs = [specs]
        self.specs = list(specs)
        self._fired: set = set()

    @property
    def spec(self) -> FaultSpec:
        """First spec (back-compat for single-fault callers)."""
        return self.specs[0]

    def on_train_batch_end(self, trainer, module, outputs, batch,
                           batch_idx) -> None:
        rank, step = trainer.global_rank, trainer.global_step
        restarts = _elastic_restarts(trainer)
        for i, spec in enumerate(self.specs):
            if spec.kind == "snapkill" \
                    or not spec.should_fire(rank, step, restarts):
                continue   # snapkill fires from the snapshot path
            if spec.kind == "slow":
                _log.warning("fault injector: slowing rank %d at step %d "
                             "for %.2fs", spec.rank, step, spec.seconds)
                time.sleep(spec.seconds)
                continue
            if i in self._fired:
                continue
            self._fired.add(i)
            if spec.kind == "kill":
                _die(spec, step, "")
            elif spec.kind == "peerdrop":
                from ray_lightning_tpu_torch.cluster import worker_state
                _log.warning(
                    "fault injector: dropping the next %d inbound peer "
                    "frames on rank %d (step %d)", spec.count, spec.rank,
                    step)
                worker_state.arm_peer_drop(spec.count)
            else:
                # wedge: stop making progress without dying; the
                # connection stays open, so only a timeout names it
                _log.warning("fault injector: wedging rank %d at step %d",
                             spec.rank, step)
                while True:
                    time.sleep(3600)


def _elastic_restarts(trainer) -> int:
    return (getattr(trainer, "_elastic_state", None) or {}).get(
        "restarts", 0)


def maybe_snapkill(rank: int, step: int, restarts: int = 0) -> None:
    """Snapshot-path hook (elastic/snapshot.py): hard-exit now if an
    armed ``snapkill`` spec matches; called while the async write is in
    flight, so the save never commits."""
    raw = os.environ.get(ENV_FAULT, "").strip()
    if not raw or "snapkill" not in raw:
        return
    for spec in parse_faults(raw):
        if spec.kind == "snapkill" \
                and spec.should_fire(rank, step, restarts):
            _die(spec, step, "mid-async-snapshot write")


def maybe_injector_from_env() -> Optional[FaultInjector]:
    """The ``RLT_FAULT`` auto-install hook (``Trainer._run_stage``): a
    malformed spec raises at once (a chaos test whose fault never arms
    must fail loudly, not pass vacuously)."""
    raw = os.environ.get(ENV_FAULT, "").strip()
    if not raw:
        return None
    return FaultInjector(parse_faults(raw))
