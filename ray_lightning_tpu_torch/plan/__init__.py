"""Planner plane: cost-model-driven auto-parallelism.

Counterpart of ``ray_lightning_tpu/plan/``.  ``Trainer(strategy=
"auto")`` routes here: enumerate candidate plans (strategy x mesh x
comm x donation x microbatch x remat policy), score them from the byte
and memory models without running anything, verify the top-k with one
fake-tensor step each (compile/aot.py), and pick deterministically,
leaving a :class:`PlanReport` on ``trainer._plan_report``.
"""

from ray_lightning_tpu_torch.plan.candidates import (Candidate,
                                                     enumerate_candidates,
                                                     policy_for_candidate,
                                                     resolve_remat_options)
from ray_lightning_tpu_torch.plan.config import ENV_KNOBS, PlanConfig
from ray_lightning_tpu_torch.plan.cost import (Estimate, estimate_candidate,
                                               rank_key, remat_terms,
                                               sharded_bytes)
from ray_lightning_tpu_torch.plan.planner import Planner, clear_plan_memo
from ray_lightning_tpu_torch.plan.report import (ENTRY_KEYS, REPORT_KEYS,
                                                 PlanReport, make_entry)

__all__ = [
    "Candidate",
    "ENTRY_KEYS",
    "ENV_KNOBS",
    "Estimate",
    "Planner",
    "PlanConfig",
    "PlanReport",
    "REPORT_KEYS",
    "clear_plan_memo",
    "enumerate_candidates",
    "estimate_candidate",
    "make_entry",
    "policy_for_candidate",
    "rank_key",
    "remat_terms",
    "resolve_remat_options",
    "sharded_bytes",
]
