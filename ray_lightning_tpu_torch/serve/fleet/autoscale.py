"""Signal-driven replica autoscaling: the decision state machine (a copy
of ``ray_lightning_tpu/serve/fleet/autoscale.py``).

The :class:`Autoscaler` is deliberately PURE policy — it consumes a
signals dict (queue depth, active slots, recent TTFT p99, from the
router's ``signals()``) and returns grow/shrink decisions; the
:class:`~ray_lightning_tpu_torch.serve.fleet.router.FleetServer` pump is the
actuator (spawn a replica via the cluster backends; drain one via the
serve analog of shrink-to-continue).  Keeping decide separate from
actuate is what makes the cooldown/patience state machine testable
without a fleet (tests/test_torch_fleet.py drives it with scripted
signals beside the JAX one).

State machine:

- each ``tick(signals)`` evaluates the grow and shrink predicates;
- a predicate must hold for ``patience_ticks`` CONSECUTIVE ticks
  before the decision fires (debounce: one bursty tick must not scale);
- after a decision fires, no new decision until the actuator reports
  completion via :meth:`note_actuated` AND ``cooldown_s`` elapses —
  actuation takes seconds (a grow compiles a fleet), and deciding again
  from signals measured mid-actuation would oscillate;
- every decision and its measured actuation seconds land in
  :attr:`events`, surfaced by the router's ``status()``.
"""

from __future__ import annotations

import time
from typing import Optional

from ray_lightning_tpu_torch.serve.fleet.config import FleetConfig


class Autoscaler:
    """Grow/shrink decisions between ``min_replicas``/``max_replicas``."""

    def __init__(self, cfg: FleetConfig, clock=time.monotonic):
        self.cfg = cfg
        self._clock = clock
        self._grow_streak = 0
        self._shrink_streak = 0
        #: monotonic time before which no decision may fire
        self._cooldown_until = 0.0
        #: a fired decision not yet note_actuated (blocks new decisions)
        self._in_flight: Optional[dict] = None
        #: decision log: {action, reason, at, seconds, ok}
        self.events: list[dict] = []

    # -- predicates --------------------------------------------------------

    def _grow_reason(self, s: dict) -> Optional[str]:
        replicas = max(1, int(s.get("replicas", 1)))
        if replicas >= self.cfg.max_replicas:
            return None
        queued = float(s.get("queued", 0))
        per_replica = queued / replicas
        if per_replica > self.cfg.grow_queue_depth:
            return (f"queue_depth {queued:.0f} over {replicas} replica(s)"
                    f" > {self.cfg.grow_queue_depth:g}/replica")
        ttft = s.get("ttft_p99_ms")
        if self.cfg.grow_ttft_p99_ms is not None and ttft is not None \
                and float(ttft) > self.cfg.grow_ttft_p99_ms:
            return (f"ttft_p99 {float(ttft):.1f}ms"
                    f" > {self.cfg.grow_ttft_p99_ms:g}ms")
        return None

    def _shrink_reason(self, s: dict) -> Optional[str]:
        replicas = int(s.get("replicas", 1))
        if replicas <= self.cfg.min_replicas:
            return None
        if float(s.get("queued", 0)) > 0:
            return None
        slots = max(1, int(s.get("slots_total", 1)))
        occupancy = float(s.get("active", 0)) / slots
        if occupancy < self.cfg.shrink_occupancy:
            return (f"occupancy {occupancy:.2f}"
                    f" < {self.cfg.shrink_occupancy:g} with empty queue")
        return None

    # -- the tick ----------------------------------------------------------

    def tick(self, signals: dict) -> Optional[dict]:
        """Evaluate one tick; returns ``{"action": "grow"|"shrink",
        "reason": ...}`` when a decision fires, else None."""
        if self._in_flight is not None:
            return None
        now = self._clock()
        grow = self._grow_reason(signals)
        shrink = self._shrink_reason(signals)
        self._grow_streak = self._grow_streak + 1 if grow else 0
        self._shrink_streak = self._shrink_streak + 1 if shrink else 0
        if now < self._cooldown_until:
            return None
        action = reason = None
        # grow wins ties: under-capacity hurts users, over-capacity
        # only hurts the bill
        if grow and self._grow_streak >= self.cfg.patience_ticks:
            action, reason = "grow", grow
        elif shrink and self._shrink_streak >= self.cfg.patience_ticks:
            action, reason = "shrink", shrink
        if action is None:
            return None
        self._grow_streak = self._shrink_streak = 0
        event = {"action": action, "reason": reason,
                 "at": time.time(), "seconds": None, "ok": None}
        self.events.append(event)
        self._in_flight = event
        return {"action": action, "reason": reason}

    def note_actuated(self, seconds: float, ok: bool = True) -> None:
        """The actuator reports the fired decision finished (or failed);
        the cooldown clock starts HERE, not at decide time."""
        if self._in_flight is None:
            return
        self._in_flight["seconds"] = round(float(seconds), 3)
        self._in_flight["ok"] = bool(ok)
        self._in_flight = None
        self._cooldown_until = self._clock() + self.cfg.cooldown_s

    # -- evidence ----------------------------------------------------------

    @property
    def in_cooldown(self) -> bool:
        return self._clock() < self._cooldown_until

    @property
    def actuating(self) -> bool:
        return self._in_flight is not None

    def stats(self) -> dict:
        return {
            "events": [dict(e) for e in self.events],
            "grows": sum(1 for e in self.events if e["action"] == "grow"),
            "shrinks": sum(1 for e in self.events
                           if e["action"] == "shrink"),
            "in_cooldown": self.in_cooldown,
            "actuating": self.actuating,
        }


__all__ = ["Autoscaler"]
