"""The planner: enumerate -> score -> verify -> pick.

Counterpart of ``ray_lightning_tpu/plan/planner.py`` (``Planner.plan``,
JAX ``:182-420``).  ``Planner.plan`` turns (module, example batch,
world) into one winning :class:`Candidate` and a :class:`PlanReport`:

1. **Enumerate** (plan/candidates.py): strategy x mesh x comm x
   donation x microbatch x remat policy, the remat axis priced per
   policy first (core/remat.py probes), infeasible combinations pruned
   by name.
2. **Score without running** (plan/cost.py): comm seconds from each
   strategy's declared bytes, the memory peak from the state's shapes
   under the candidate's layout plus the policy's kept bytes, the remat
   seconds; over-budget candidates rejected by name.
3. **Verify the top-k** (compile/aot.py ``compile_scored``): one
   training step of each in fake-tensor mode (no card memory, no
   launch): its ``MemTracker`` peak and its ``CollectiveLog`` wire
   bytes re-rank them; a candidate whose verify fails is rejected
   (``compile_error``), one over budget ``hbm_over_budget_measured``.
   The steps run over this process's world, so a plan asked for
   another device count (``n_devices``) is modeled only.

Every ranking key is a pure function of the pickled config and the
shapes (wall seconds are recorded, never ranked), so every rank of a
fleet agrees on one winner without a collective.  Inside a Tune trial
the report is memoized by (module class, batch shapes, world, config):
a same-shaped trial reuses it (``reused``).
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.plan.candidates import (Candidate,
                                                     enumerate_candidates,
                                                     policy_for_candidate,
                                                     resolve_remat_options)
from ray_lightning_tpu_torch.plan.config import PlanConfig
from ray_lightning_tpu_torch.plan.cost import (abstract_state,
                                               estimate_candidate, rank_key)
from ray_lightning_tpu_torch.plan.report import PlanReport, make_entry

_log = logging.getLogger(__name__)

#: memoized reports for per-trial reuse (Tune experiments only; guarded:
#: the local Tune runner runs trials in threads)
_MEMO: dict = {}
_MEMO_LOCK = threading.Lock()


def clear_plan_memo() -> None:
    """Drop memoized plans (tests; a new experiment's config or world
    keys differently anyway)."""
    with _MEMO_LOCK:
        _MEMO.clear()


def _tune_session_active() -> bool:
    try:
        from ray_lightning_tpu_torch.tune.session import _get
        return _get() is not None
    except Exception:   # noqa: BLE001 - the Tune plane is optional here
        return False


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _batch_fingerprint(batch) -> tuple:
    return tuple((tuple(np.shape(x)), str(getattr(x, "dtype", type(x))))
                 for x in _leaves(batch))


def _batch_bytes(batch) -> int:
    total = 0
    for x in _leaves(batch):
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        else:
            total += int(np.asarray(x).nbytes)
    return total


class _Infeasible(Exception):
    """A candidate that cannot be materialized (named reason)."""


@dataclasses.dataclass
class _Built:
    """What scoring made for one candidate and the verify reuses."""

    candidate: Candidate
    strategy: object
    mesh: object
    grad_sync: object
    estimate: object
    module: object = None


def fake_step_program(name: str, module, strategy, comm_policy, tx_factory,
                      batch, device, microbatch: int = 1,
                      ici_size: int = 0, local: "int | None" = None,
                      hosts: "int | None" = None,
                      key: "tuple | None" = None):
    """The verify step of one candidate (compile/aot.py ``FakeProgram``):
    the strategy's mesh over the current world (its groups made here,
    for real), then inside the verify's fake mode the module's model
    made on ``device``, cut to the strategy's layout on that mesh, the
    optimizer wrapped as ``Trainer`` wraps it, its
    state made from the parameters (no weight init: values do not
    matter), and the train step ``Trainer`` would build, called once on
    ``batch``'s shapes."""
    from ray_lightning_tpu_torch.comm.collectives import CommTx
    from ray_lightning_tpu_torch.compile.aot import FakeProgram, batch_like
    from ray_lightning_tpu_torch.core.state import TrainState
    from ray_lightning_tpu_torch.core.steps import (_state_tensors,
                                                    build_train_step)
    from ray_lightning_tpu_torch.parallel import strategy as _parallel

    # the mesh's groups and the comm plane's resolution are made for
    # real, outside the fake mode
    mesh = strategy.build_mesh()
    sync = strategy.grad_transform(mesh, comm_policy, local=local,
                                   hosts=hosts) \
        if comm_policy is not None else None

    def build():
        mod = copy.copy(module)
        mod.model = None
        mod.setup_model(device)
        tx = tx_factory(None)
        if sync is None:
            tx = strategy.wrap_optimizer(tx)
        else:
            sync.setup(torch.device(device))
            tx = CommTx(strategy.wrap_optimizer(tx, comm=sync), sync)
        layout = strategy.layout(mod.model, mesh)
        if layout is not None:
            layout.apply(mod.model)
            tx.bind(layout)
        opt_state = tx.init(dict(mod.model.named_parameters()))
        pd = getattr(mod, "param_dtype", None)
        if pd is not None:
            for sub in mod.model.modules():
                for n, p in list(sub._parameters.items()):
                    if p is not None and p.is_floating_point():
                        new = torch.nn.Parameter(p.detach().to(pd))
                        for attr in ("_rlt_shard",):
                            if hasattr(p, attr):
                                setattr(new, attr, getattr(p, attr))
                        sub._parameters[n] = new
        state = TrainState(step=0, opt_state=opt_state,
                           generator=torch.Generator(device=device))
        step = build_train_step(
            mod, tx, microbatch, grad_sync=strategy.grad_sync(layout),
            rank=mesh.batch_index if mesh.batch_size > 1 else None,
            metric_sync=_parallel.mean_over_ranks, comm=sync)
        fb = batch_like(batch, device)
        held = (list(mod.model.parameters()) + _state_tensors(opt_state)
                + [t for t in _leaves(fb) if isinstance(t, torch.Tensor)])
        return step, (state, fb), held

    return FakeProgram(name=name, build=build, ici_size=ici_size, key=key)


class Planner:
    """Cost-model-driven choice of strategy, comm, microbatch and remat
    (module docstring)."""

    def __init__(self, config=None):
        self.config = PlanConfig.resolve(config)

    @staticmethod
    def _module_for_policy(module, spec, policy: str, cache: dict):
        """The module a candidate runs: for a policy other than the
        default, a ``copy.copy`` clone reconfigured by its own
        ``configure_remat().apply`` (the caller's module keeps its
        default until the trainer applies the winner)."""
        if spec is None or not policy or policy == spec.default:
            return module
        if policy not in cache:
            clone = copy.copy(module)
            clone.model = None
            clone.configure_remat().apply(policy)
            cache[policy] = clone
        return cache[policy]

    def plan(self, module, example_batch, *, n_devices: Optional[int] = None,
             batch_hint: Optional[int] = None,
             process_count: Optional[int] = None,
             base_comm_policy=None, tx_factory: Optional[Callable] = None,
             microbatch_options: Optional[tuple] = None,
             device=None) -> PlanReport:
        """Pick a plan for training ``module`` over ``n_devices`` ranks
        (default: the world).  ``example_batch`` is a rank's batch (after
        the trainer's cast); ``batch_hint`` the global batch;
        ``tx_factory(grad_sync)`` the module's optimizer before the
        strategy wraps it (the trainer passes its own, clip included);
        ``device`` where the verify's fake tensors claim to live (the
        trainer's device; default: the card when there is one).  Raises
        ``ValueError`` naming every reason when nothing survives."""
        from ray_lightning_tpu_torch.comm.policy import host_layout
        from ray_lightning_tpu_torch.core.remat import probe_device
        from ray_lightning_tpu_torch.parallel import strategy as _parallel
        from ray_lightning_tpu_torch.parallel.mesh import Mesh

        t0 = time.monotonic()
        cfg = self.config
        world = _parallel.world_size()
        n = int(n_devices) if n_devices is not None else world
        pc = int(process_count) if process_count is not None else world
        device = torch.device(device) if device is not None \
            else probe_device()
        if tx_factory is None:
            def tx_factory(_gs):
                tx = module.configure_optimizers()
                return tx["optimizer"] if isinstance(tx, dict) else tx

        memo_key = None
        if cfg.reuse and _tune_session_active():
            memo_key = (type(module).__qualname__,
                        _batch_fingerprint(example_batch), n, pc,
                        batch_hint, cfg)
            with _MEMO_LOCK:
                hit = _MEMO.get(memo_key)
            if hit is not None:
                report = dataclasses.replace(
                    hit, reused=True, cache_misses=0,
                    plan_seconds=time.monotonic() - t0)
                self._note_tune(report)
                return report

        # the remat axis, priced per policy before enumeration
        spec = module.configure_remat()
        remat_options, remat_pruned = resolve_remat_options(spec, cfg)
        probes: dict = {}
        if spec is not None:
            options = []
            for p in remat_options:
                try:
                    probes[p] = spec.probe(p, example_batch)
                    options.append(p)
                except Exception as e:   # noqa: BLE001 - per-policy soft
                    remat_pruned.append((
                        f"rm-{p}",
                        f"remat_probe_error: {type(e).__name__}: {e}"))
            remat_options = tuple(options) or ("",)

        comm_hint = base_comm_policy is not None and base_comm_policy.enabled
        candidates, pruned = enumerate_candidates(
            n, batch_hint, cfg, process_count=pc,
            microbatch_options=microbatch_options,
            comm_enabled_hint=comm_hint, remat_options=remat_options)
        entries = [make_entry(label, "pruned", reason)
                   for label, reason in list(remat_pruned) + list(pruned)]
        if len(candidates) > cfg.max_candidates:
            for cand in candidates[cfg.max_candidates:]:
                entries.append(make_entry(
                    cand, "pruned",
                    f"max_candidates: enumeration capped at "
                    f"{cfg.max_candidates} scored candidates"))
            candidates = candidates[:cfg.max_candidates]

        batch_bytes = _batch_bytes(example_batch) * pc
        hosts, local = host_layout() if world > 1 else (1, 1)

        # -- score (nothing runs) -----------------------------------------
        abstract = abstract_state(module, tx_factory(None))
        policy_modules: dict = {}
        built: "list[_Built]" = []
        for cand in candidates:
            cand_module = self._module_for_policy(module, spec, cand.remat,
                                                  policy_modules)
            try:
                strategy = cand.build_strategy()
                mesh = Mesh.abstract(strategy.axis_names,
                                     strategy.mesh_shape(n, batch_hint))
                policy = policy_for_candidate(cand, base_comm_policy)
                gs = strategy.grad_transform(mesh, policy, local=local,
                                             hosts=hosts) \
                    if policy is not None else None
                if cand.comm and gs is None:
                    raise _Infeasible(
                        "comm_inert: the comm policy resolves to no "
                        "compressible axis on this mesh "
                        "(comm/collectives.py build_grad_sync)")
                est = estimate_candidate(
                    cand, strategy, mesh, abstract, batch_bytes, cfg, pc,
                    grad_sync=gs, remat_probe=probes.get(cand.remat),
                    device=device)
            except _Infeasible as e:
                entries.append(make_entry(cand, "rejected", str(e)))
                continue
            except Exception as e:   # noqa: BLE001 - per-candidate soft
                entries.append(make_entry(
                    cand, "rejected",
                    f"build_error: {type(e).__name__}: {e}"))
                continue
            if not est.fits:
                entries.append(make_entry(cand, "rejected", est.reason,
                                          modeled=est.to_dict()))
                continue
            built.append(_Built(cand, strategy, mesh, gs, est,
                                module=cand_module))
        built.sort(key=lambda b: rank_key(b.candidate, b.estimate))

        # -- verify the top-k in fake mode --------------------------------
        from ray_lightning_tpu_torch.comm.audit import bytes_to_seconds
        from ray_lightning_tpu_torch.compile import cache as compile_cache
        from ray_lightning_tpu_torch.compile.aot import compile_scored
        # the verify steps run over this process's world: a plan for
        # another device count is modeled only
        top = built[:cfg.topk] if cfg.topk > 0 and n == world else []
        rest = built[len(top):]
        misses_before = compile_cache.stats().misses
        programs = [fake_step_program(
            b.candidate.label, b.module, b.strategy,
            policy_for_candidate(b.candidate, base_comm_policy), tx_factory,
            example_batch, device, b.candidate.microbatch,
            ici_size=(getattr(b.grad_sync, "ici_size", 0)
                      if getattr(b.grad_sync, "hierarchical", False) else 0),
            local=local, hosts=hosts,
            key=(type(b.module).__qualname__,
                 repr(getattr(b.module, "config", None)), b.candidate,
                 _batch_fingerprint(example_batch), world, str(device),
                 repr(base_comm_policy)))
            for b in top]
        scored = compile_scored(programs)
        cache_misses = compile_cache.stats().misses - misses_before

        verified: list = []
        for b in top:
            sc = scored[b.candidate.label]
            if not sc.ok:
                entries.append(make_entry(
                    b.candidate, "rejected", f"compile_error: {sc.error}",
                    modeled=b.estimate.to_dict(), measured=sc.to_dict()))
                continue
            budget = b.estimate.budget
            if budget is not None and sc.peak_bytes > cfg.headroom * budget:
                entries.append(make_entry(
                    b.candidate, "rejected",
                    f"hbm_over_budget_measured: fake-step peak "
                    f"{sc.peak_bytes >> 20} MiB > "
                    f"{int(cfg.headroom * budget) >> 20} MiB budget",
                    modeled=b.estimate.to_dict(), measured=sc.to_dict()))
                continue
            gbps = cfg.dcn_gbps if pc > 1 else cfg.ici_gbps
            if sc.wire_bytes_dcn or sc.wire_bytes_ici:
                audited_seconds = (
                    bytes_to_seconds(sc.wire_bytes_dcn, gbps)
                    + bytes_to_seconds(sc.wire_bytes_ici, cfg.ici_gbps))
            else:
                audited_seconds = bytes_to_seconds(sc.wire_bytes, gbps)
            mismatch = 0 if b.candidate.donate \
                == b.estimate.donate_preferred else 1
            key = (audited_seconds + b.estimate.remat_seconds, mismatch,
                   sc.peak_bytes, b.candidate.label)
            measured = sc.to_dict()
            measured["audited_seconds"] = audited_seconds
            verified.append((key, b, measured))

        verified.sort(key=lambda t: t[0])
        winner: Optional[_Built] = None
        winner_measured = None
        if verified:
            winner, winner_measured = verified[0][1], verified[0][2]
            for _, b, measured in verified[1:]:
                entries.append(make_entry(b.candidate, "compiled",
                                          modeled=b.estimate.to_dict(),
                                          measured=measured))
        elif rest:
            # the verify produced nothing usable (or did not run): the
            # best remaining modeled candidate
            winner, rest = rest[0], rest[1:]
            if top:
                _log.warning(
                    "plan: all top-%d verify candidates failed; falling "
                    "back to the best unverified modeled candidate %s",
                    cfg.topk, winner.candidate.label)
        for b in rest:
            entries.append(make_entry(b.candidate, "scored",
                                      modeled=b.estimate.to_dict()))

        if winner is None:
            reasons = "; ".join(f"{e['label']}: {e['reason']}"
                                for e in entries if e.get("reason"))
            raise ValueError(
                "strategy='auto' found no feasible plan — every "
                f"candidate was pruned or rejected: {reasons}")

        entries.append(make_entry(winner.candidate, "winner",
                                  modeled=winner.estimate.to_dict(),
                                  measured=winner_measured))
        report = PlanReport(
            entries=entries, winner_label=winner.candidate.label,
            topk=cfg.topk, plan_seconds=time.monotonic() - t0,
            cache_misses=cache_misses, winner_candidate=winner.candidate,
            winner_policy=policy_for_candidate(winner.candidate,
                                               base_comm_policy))
        if memo_key is not None:
            with _MEMO_LOCK:
                _MEMO[memo_key] = report
        self._note_tune(report)
        return report

    @staticmethod
    def _note_tune(report: PlanReport) -> None:
        try:
            from ray_lightning_tpu_torch.tune.session import note_plan_report
            note_plan_report(report.to_dict())
        except Exception:   # noqa: BLE001 - the Tune plane is optional
            pass


__all__ = ["Planner", "clear_plan_memo", "fake_step_program"]
