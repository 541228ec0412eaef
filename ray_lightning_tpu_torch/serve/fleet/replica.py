"""One serve replica in a fleet: an unmodified :class:`Server` plus the
router's bookkeeping around it (a copy of
``ray_lightning_tpu/serve/fleet/replica.py``).

A replica is NOT a new execution engine — it wraps one
:class:`~ray_lightning_tpu_torch.serve.server.Server` (itself an SPMD fleet
of worker actors placed through the existing cluster backends) and adds
what the front-door router needs: a lifecycle state machine, cheap load
probes for routing, and the withdraw/failover surface.

States::

    starting ──► serving ──► draining ──► stopped
        │            │
        └────────────┴──────► dead    (mid-serve fleet failure)

``starting`` replicas receive no traffic (the grow actuator flips them
to ``serving`` once ``Server.start()`` returns with warm programs);
``draining`` replicas finish their in-flight requests but receive no
new ones (the serve analog of shrink-to-continue); ``dead`` replicas
had a mid-serve failure — their in-flight requests were failed by the
server pump (cause + flight-recorder dumps in
``server.failure_report``) and the router fails over what it can.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class FleetReplica:
    """Router-side handle on one serve replica."""

    def __init__(self, rid: int, server, role: str = "pooled"):
        self.id = int(rid)
        self.server = server
        #: disaggregation pool (config.py roles): "prefill" replicas
        #: take admissions, "decode" replicas finish shipped requests,
        #: "pooled" does both (the router fails back to pooled routing
        #: when a dedicated pool empties)
        self.role = str(role)
        self.state = "starting"
        self.created_at = time.time()
        self.started_at: Optional[float] = None
        #: set by the grow/start actuator on failure (distinct from a
        #: mid-serve death, which lands in server.failure_report)
        self.start_error: Optional[BaseException] = None
        self._lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FleetReplica":
        """Blocking ``Server.start()`` (spawn actors, compile, warm);
        flips to ``serving``.  Run from the grow actuator thread — the
        router pump never blocks on this."""
        try:
            self.server.start()
        except BaseException as e:
            self.start_error = e
            self.state = "dead"
            raise
        self.started_at = time.time()
        self.state = "serving"
        return self

    def mark_draining(self) -> None:
        with self._lock:
            if self.state == "serving":
                self.state = "draining"

    def mark_dead(self) -> None:
        with self._lock:
            self.state = "dead"

    def shutdown(self, graceful: bool = True) -> None:
        try:
            self.server.shutdown(graceful=graceful)
        finally:
            if self.state != "dead":
                self.state = "stopped"

    # -- probes ------------------------------------------------------------

    @property
    def failed(self) -> bool:
        """A mid-serve fleet failure surfaced on this replica's pump."""
        return getattr(self.server, "_error", None) is not None

    @property
    def routable(self) -> bool:
        return self.state == "serving" and not self.failed

    @property
    def active(self) -> int:
        return self.server.scheduler.active_count

    @property
    def queued(self) -> int:
        return self.server.scheduler.queued_count

    @property
    def slots(self) -> int:
        return self.server.scheduler.allocator.slots

    def idle(self) -> bool:
        return self.server.scheduler.idle()

    def load_row(self) -> dict:
        """The routing-policy view of this replica
        (serve/fleet/router.py pick_replica)."""
        return {"rid": self.id, "active": self.active,
                "queued": self.queued, "slots": self.slots,
                "role": self.role}

    def status(self) -> dict:
        sched = self.server.scheduler
        doc = {
            "state": self.state,
            "role": self.role,
            "active": sched.active_count,
            "queued": sched.queued_count,
            "slots": sched.allocator.slots,
            "completed": sched.completed,
            "failed": sched.failed,
        }
        if sched.pages is not None:
            doc["pages"] = sched.pages.stats()
        report = getattr(self.server, "failure_report", None)
        if report is not None:
            doc["failure"] = report
        return doc


__all__ = ["FleetReplica"]
