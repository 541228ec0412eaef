"""Candidate-plan enumeration.

Counterpart of ``ray_lightning_tpu/plan/candidates.py``: a candidate is
one complete configuration the trainer could run, strategy x mesh
factorization x comm on/off x donation x microbatch x remat policy,
enumerated combinatorially from the strategies' own ``plan_mesh_options``
/ ``from_plan`` hooks (parallel/strategy.py), with the statically
infeasible combinations pruned up front under a named reason.

One difference on purpose: donation has no counterpart in the port.
The optimizer updates the parameters and its state in place, so there
is no second state copy to give back; every ``nodonate`` combination
is listed as ``pruned`` with the reason ``donation_inapplicable``, so
the report keeps the JAX package's candidate count.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from ray_lightning_tpu_torch.plan.config import PlanConfig

#: why the port lists every un-donated candidate as pruned
NODONATE_REASON = (
    "donation_inapplicable: the port's optimizer updates parameters and "
    "state in place, so no second state copy exists to give back "
    "(plan/candidates.py)")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One enumerated plan (hashable; the labels are the JAX ones)."""

    strategy: str                 # canonical name ("ddp"/"zero1"/...)
    axis_sizes: tuple             # sorted ((axis, size), ...) pairs
    comm: bool = False            # compressed gradient collectives on?
    donate: bool = True           # the JAX donation flag (module docs)
    microbatch: int = 1           # accumulate_grad_batches
    remat: str = ""               # remat policy ("" = no ladder)

    @property
    def label(self) -> str:
        mesh = "x".join(f"{a}{s}" for a, s in self.axis_sizes)
        parts = [f"{self.strategy}[{mesh}]"]
        if self.comm:
            parts.append("comm")
        if not self.donate:
            parts.append("nodonate")
        if self.microbatch > 1:
            parts.append(f"mb{self.microbatch}")
        if self.remat:
            parts.append(f"rm-{self.remat}")
        return ":".join(parts)

    @property
    def mesh_sizes(self) -> dict:
        return dict(self.axis_sizes)

    def data_parallel_size(self) -> int:
        """Product of the batch-sharding axes (data x fsdp)."""
        sizes = self.mesh_sizes
        return sizes.get("data", 1) * sizes.get("fsdp", 1)

    def build_strategy(self):
        from ray_lightning_tpu_torch.parallel.strategy import _STRATEGIES
        return _STRATEGIES[self.strategy].from_plan(self.mesh_sizes)

    def to_dict(self) -> dict:
        return {
            "label": self.label,
            "strategy": self.strategy,
            "mesh": self.mesh_sizes,
            "comm": self.comm,
            "donate": self.donate,
            "microbatch": self.microbatch,
            "remat": self.remat or None,
        }


def policy_for_candidate(candidate: Candidate, base_policy=None):
    """The ``CommPolicy`` a comm-on candidate runs under: the user's own
    when one is active, else int8 on the data axis with the two-level
    hierarchy armed (``HIER_AUTO``).  ``None`` for comm-off ones."""
    if not candidate.comm:
        return None
    from ray_lightning_tpu_torch.comm.policy import HIER_AUTO, CommPolicy
    if base_policy is not None and base_policy.enabled:
        return base_policy
    return CommPolicy(compress="int8", axes=("data",), hierarchy=HIER_AUTO)


def resolve_remat_options(spec, config: PlanConfig
                          ) -> "tuple[tuple, list[tuple[str, str]]]":
    """The remat-policy axis: ``(options, pruned)``.  No spec: ``("",)``
    with a named ``remat_unsupported`` prune when a sweep was asked for;
    with one, ``config.remat`` (default: the whole ladder) checked
    against the ladder, and a set ``RLT_REMAT_POLICY`` pins the axis to
    that policy (the model build forces it anyway)."""
    pruned: "list[tuple[str, str]]" = []
    env = os.environ.get("RLT_REMAT_POLICY", "").strip()
    if spec is None:
        if config.remat or env:
            pruned.append((
                "remat",
                "remat_unsupported: module declares no configure_remat() "
                "ladder (core/module.py hook); the remat axis is skipped"))
        return ("",), pruned
    requested = (env,) if env else (tuple(config.remat)
                                    or tuple(spec.policies))
    options: list = []
    for p in requested:
        if p not in spec.policies:
            pruned.append((
                f"rm-{p}",
                f"remat_unsupported: policy {p!r} is not in this "
                f"module's ladder {tuple(spec.policies)}"))
            continue
        if p not in options:
            options.append(p)
    if not options:
        options = [spec.default]
    return tuple(options), pruned


def enumerate_candidates(
    n_devices: int,
    global_batch: Optional[int],
    config: PlanConfig,
    process_count: int = 1,
    microbatch_options: Optional[tuple] = None,
    comm_enabled_hint: bool = False,
    remat_options: tuple = ("",),
) -> "tuple[list[Candidate], list[tuple[str, str]]]":
    """All statically feasible candidates and the pruned combinations,
    ``(candidates, [(label, reason), ...])``, in the JAX order; every
    un-donated combination is pruned (module docstring)."""
    from ray_lightning_tpu_torch.parallel.strategy import _STRATEGIES

    microbatch = tuple(microbatch_options or config.microbatch)
    candidates: "list[Candidate]" = []
    pruned: "list[tuple[str, str]]" = []

    for name in config.strategies:
        cls = _STRATEGIES[name]
        for sizes in cls.plan_mesh_options(n_devices):
            axis_sizes = tuple(sorted(sizes.items()))
            base = Candidate(strategy=name, axis_sizes=axis_sizes)
            dp = base.data_parallel_size()
            if global_batch is not None and global_batch % dp:
                pruned.append((base.label,
                               f"batch_indivisible: global batch "
                               f"{global_batch} does not divide across "
                               f"{dp} data shards"))
                continue
            comm_options = [False]
            if cls.comm_compressible:
                if process_count > 1 or comm_enabled_hint:
                    comm_options.append(True)
                else:
                    pruned.append((
                        f"{base.label}:comm",
                        "comm_no_dcn: single-process mesh is all-ICI; "
                        "nothing to compress (pass an explicit "
                        "CommPolicy(axes=...) to opt in)"))
            elif process_count > 1 or comm_enabled_hint:
                pruned.append((
                    f"{base.label}:comm",
                    f"comm_unsupported: strategy {name!r} keeps params "
                    f"sharded across the reduction axes (comm plane "
                    f"declines, parallel/strategy.py comm_compressible)"))
            for comm in comm_options:
                for mb in microbatch:
                    if mb > 1 and global_batch is not None \
                            and global_batch % (dp * mb):
                        pruned.append((
                            dataclasses.replace(
                                base, comm=comm, microbatch=mb).label,
                            f"microbatch_indivisible: global batch "
                            f"{global_batch} does not split into "
                            f"{mb} microbatches over {dp} data shards"))
                        continue
                    for donate in (True, False):
                        for rp in remat_options:
                            cand = dataclasses.replace(
                                base, comm=comm, donate=donate,
                                microbatch=mb, remat=rp)
                            if donate:
                                candidates.append(cand)
                            else:
                                pruned.append((cand.label,
                                               NODONATE_REASON))
    return candidates, pruned


__all__ = ["Candidate", "NODONATE_REASON", "enumerate_candidates",
           "policy_for_candidate", "resolve_remat_options"]
