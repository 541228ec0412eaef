"""Machine-readable plan report.

Counterpart of ``ray_lightning_tpu/plan/report.py``, the same dict
schema: ``PlanReport`` is the planner's one output, every enumerated
combination with its status (``pruned`` / ``rejected`` / ``scored`` /
``compiled`` / ``winner``), a named reason for the pruned and rejected
ones, the winner, and the planning cost (seconds, kernel-cache misses).
It lands on ``trainer._plan_report`` (its dict form) and, inside a
Tune trial, on ``Trial.plan_report``.  ``compiled`` keeps the JAX name:
in the port it counts the candidates the verify step ran in fake mode
(compile/aot.py ``compile_scored``).  plan/selfcheck.py pins the
schema.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

#: top-level keys every ``PlanReport.to_dict()`` carries (schema pinned
#: by plan/selfcheck.py; the tests and chip_smoke.py read these).
#: ``remat`` is the per-policy ladder summary at the winner's other
#: axes (None when the module has no configure_remat() ladder).
REPORT_KEYS = ("winner", "topk", "plan_seconds", "cache_misses",
               "reused", "enumerated", "pruned", "rejected", "scored",
               "compiled", "candidates", "remat", "observed")

#: keys every per-candidate entry carries
ENTRY_KEYS = ("label", "strategy", "mesh", "comm", "donate",
              "microbatch", "remat", "status", "reason")

STATUSES = ("pruned", "rejected", "scored", "compiled", "winner")


@dataclasses.dataclass
class PlanReport:
    """The planner's verdict (plan/planner.py builds it)."""

    entries: list                      # per-candidate dicts (ENTRY_KEYS
    #                                    + optional modeled/measured)
    winner_label: Optional[str]
    topk: int
    plan_seconds: float = 0.0
    cache_misses: int = 0
    reused: bool = False
    #: the winning Candidate / CommPolicy objects (not serialized —
    #: the trainer applies them; the dict form carries the label)
    winner_candidate: object = None
    winner_policy: object = None

    def _count(self, status: str) -> int:
        return sum(1 for e in self.entries if e["status"] == status)

    def _remat_summary(self) -> "Optional[dict]":
        """Per-policy ladder at the winner's OTHER axes: the one-look
        answer to "what did each remat policy model to" — modeled HBM
        peak / activation bytes / remat seconds per policy, with the
        winner's policy named.  ``None`` when the module declared no
        remat ladder (no candidate carries a policy)."""
        win = next((e for e in self.entries if e["status"] == "winner"),
                   None)
        if win is None or not win.get("remat"):
            return None

        def axes(e):
            return (e.get("strategy"), str(e.get("mesh")), e.get("comm"),
                    e.get("donate"), e.get("microbatch"))

        policies = {}
        for e in self.entries:
            if not e.get("remat") or axes(e) != axes(win):
                continue
            m = e.get("modeled") or {}
            policies[e["remat"]] = {
                "status": e["status"],
                "peak_bytes": m.get("peak_bytes"),
                "act_bytes": m.get("act_bytes"),
                "remat_seconds": m.get("remat_seconds"),
                "reason": e.get("reason"),
            }
        return {"winner": win["remat"], "policies": policies}

    def to_dict(self) -> dict:
        compiled = sum(1 for e in self.entries
                       if e["status"] in ("compiled", "winner")
                       and e.get("measured") is not None)
        return {
            "winner": self.winner_label,
            "topk": self.topk,
            "plan_seconds": round(self.plan_seconds, 6),
            "cache_misses": self.cache_misses,
            "reused": self.reused,
            "enumerated": len(self.entries),
            "pruned": self._count("pruned"),
            "rejected": self._count("rejected"),
            "scored": sum(1 for e in self.entries
                          if e["status"] != "pruned"),
            "compiled": compiled,
            "candidates": list(self.entries),
            "remat": self._remat_summary(),
            # measured-vs-modeled divergence for the winner: None until
            # a run measures it (the trace anatomy, ROADMAP.md queue 1
            # item 13, is not ported)
            "observed": None,
        }

    def summary(self) -> str:
        d = self.to_dict()
        return (f"winner={d['winner']} from {d['enumerated']} candidates "
                f"({d['pruned']} pruned, {d['rejected']} rejected, "
                f"{d['compiled']} verified/top-{d['topk']}) in "
                f"{d['plan_seconds']:.2f}s"
                + (" [reused]" if d["reused"] else ""))


def make_entry(candidate, status: str, reason: Optional[str] = None,
               modeled: Optional[dict] = None,
               measured: Optional[dict] = None) -> dict:
    """One report row (candidate may be a Candidate or a bare label for
    pruned subtrees that never became full candidates)."""
    if hasattr(candidate, "to_dict"):
        entry = candidate.to_dict()
    else:
        entry = {"label": str(candidate), "strategy": None, "mesh": None,
                 "comm": None, "donate": None, "microbatch": None,
                 "remat": None}
    entry["status"] = status
    entry["reason"] = reason
    entry["modeled"] = modeled
    entry["measured"] = measured
    return entry
