"""Planner-plane selfcheck: ``python -m ray_lightning_tpu_torch.plan.selfcheck``.

Counterpart of ``ray_lightning_tpu/plan/selfcheck.py``, the same
contract as the comm / compile / serve / elastic selfchecks: cheap,
deterministic, no pytest, on the CPU; it checks the invariants that
would otherwise only fail deep inside a planning run:

1. ``PlanConfig`` validation + ``RLT_PLAN*`` env round-trip
   (``worker_env`` → ``resolve`` reproduces the config);
2. enumeration sanity: the canonical inventory appears, spmd mesh
   factorizations are exact divisors, statically-infeasible combos are
   pruned with named reasons (every un-donated one as
   ``donation_inapplicable``), labels are unique;
3. remat axis: option resolution (no-ladder collapse, unknown-policy
   prunes, ``RLT_REMAT_POLICY`` pin), enumeration multiplication with
   unique labels, and ``remat_terms`` score monotonicity;
4. score monotonicity: ``bytes_to_seconds`` is strictly monotone in
   bytes and inversely so in bandwidth (the ranking invariant);
5. report schema: ``PlanReport.to_dict()`` carries every pinned key
   and candidate entries carry the entry schema;
6. every ``rlt_plan_*`` metric name is Prometheus-clean.
"""

from __future__ import annotations


def _check_config() -> None:
    import os
    from ray_lightning_tpu_torch.plan.config import PlanConfig

    cfg = PlanConfig(topk=2, ici_gbps=42.0, dcn_gbps=3.5,
                     strategies=("ddp", "zero1"), microbatch=(1, 4),
                     remat=("dots", "off"), hbm_gbps=500.0,
                     device_tflops=90.0,
                     hbm_budget_bytes=1 << 30, headroom=0.8)
    saved = {k: os.environ.get(k) for k in list(os.environ)
             if k.startswith("RLT_PLAN")}
    try:
        for k in saved:
            os.environ.pop(k, None)
        os.environ.update(cfg.worker_env())
        got = PlanConfig.resolve(None)
        assert got == cfg, f"env round-trip drifted: {got} != {cfg}"
    finally:
        for k in list(os.environ):
            if k.startswith("RLT_PLAN"):
                os.environ.pop(k, None)
        os.environ.update({k: v for k, v in saved.items() if v is not None})
    assert PlanConfig.resolve(None) == PlanConfig()
    for bad in (dict(topk=-1), dict(ici_gbps=0), dict(headroom=0),
                dict(headroom=1.5), dict(strategies=("warp",)),
                dict(microbatch=(0,)), dict(max_candidates=0),
                dict(hbm_gbps=0), dict(device_tflops=-1),
                dict(remat=("",))):
        try:
            PlanConfig(**bad)
        except ValueError:
            pass
        else:
            raise AssertionError(f"expected ValueError for {bad}")
    print("plan selfcheck: config validation + env round-trip OK")


def _check_enumeration() -> None:
    from ray_lightning_tpu_torch.plan.candidates import enumerate_candidates
    from ray_lightning_tpu_torch.plan.config import PlanConfig

    cfg = PlanConfig(microbatch=(1, 2))
    cands, pruned = enumerate_candidates(8, 16, cfg, process_count=2)
    labels = [c.label for c in cands]
    assert len(set(labels)) == len(labels), "duplicate candidate labels"
    strategies = {c.strategy for c in cands}
    assert strategies == {"ddp", "zero1", "fsdp", "spmd"}, strategies
    spmd_meshes = {c.mesh_sizes["fsdp"] for c in cands
                   if c.strategy == "spmd"}
    assert spmd_meshes == {2, 4, 8}, spmd_meshes
    assert any(c.comm for c in cands if c.strategy == "ddp")
    assert not any(c.comm for c in cands if c.strategy == "fsdp")
    reasons = {r for _, r in pruned}
    assert any(r.startswith("comm_unsupported") for r in reasons), reasons
    assert not any(not c.donate for c in cands), "a nodonate candidate"
    assert any(r.startswith("donation_inapplicable") for r in reasons)
    # microbatch 2 over 8 shards needs batch 16 to split 16/(8*2)=1: ok;
    # a batch of 12 cannot divide across 8 shards at all
    cands12, pruned12 = enumerate_candidates(8, 12, cfg, process_count=2)
    assert any(r.startswith("batch_indivisible")
               for _, r in pruned12), pruned12
    # single-process: comm pruned with the no-DCN reason
    _, pruned1p = enumerate_candidates(8, 16, cfg, process_count=1)
    assert any(r.startswith("comm_no_dcn") for _, r in pruned1p)
    print("plan selfcheck: enumeration coverage + pruning reasons OK")


def _check_remat_axis() -> None:
    """Remat-axis invariants: option resolution (no-ladder collapse +
    named prunes, unknown-policy prunes, env pin), enumeration
    multiplication with unique labels, and remat_terms score
    monotonicity (more saved bytes → more peak + traffic seconds, more
    recompute FLOPs → more seconds, "off" pays no region overhead,
    microbatching divides residency but not traffic)."""
    import os

    from ray_lightning_tpu_torch.core.remat import RematProbe, RematSpec
    from ray_lightning_tpu_torch.plan.candidates import (enumerate_candidates,
                                                   resolve_remat_options)
    from ray_lightning_tpu_torch.plan.config import PlanConfig
    from ray_lightning_tpu_torch.plan.cost import remat_terms

    spec = RematSpec(policies=("off", "dots", "full"), default="off",
                     apply=lambda p: None,
                     probe=lambda p, b: None)
    cfg = PlanConfig()
    opts, pruned = resolve_remat_options(spec, cfg)
    assert opts == ("off", "dots", "full") and not pruned, (opts, pruned)
    opts, pruned = resolve_remat_options(
        spec, PlanConfig(remat=("dots", "warp")))
    assert opts == ("dots",), opts
    assert any(r.startswith("remat_unsupported") for _, r in pruned)
    opts, pruned = resolve_remat_options(None, PlanConfig(remat=("dots",)))
    assert opts == ("",), opts
    assert any(r.startswith("remat_unsupported") for _, r in pruned)
    saved = os.environ.get("RLT_REMAT_POLICY")
    try:
        os.environ["RLT_REMAT_POLICY"] = "full"
        opts, _ = resolve_remat_options(spec, cfg)
        assert opts == ("full",), opts
    finally:
        if saved is None:
            os.environ.pop("RLT_REMAT_POLICY", None)
        else:
            os.environ["RLT_REMAT_POLICY"] = saved

    flat, flat_pruned = enumerate_candidates(8, 16, cfg)
    swept, swept_pruned = enumerate_candidates(
        8, 16, cfg, remat_options=("off", "dots"))
    assert len(swept) == 2 * len(flat), (len(swept), len(flat))
    assert len(swept) + len(swept_pruned) \
        > len(flat) + len(flat_pruned), "the remat axis must multiply"
    labels = [c.label for c in swept]
    assert len(set(labels)) == len(labels), "duplicate remat labels"
    assert any(lb.endswith("rm-dots") for lb in labels)

    def terms(saved_b=1 << 24, flops=1 << 30, policy="dots", mb=1):
        return remat_terms(RematProbe(saved_bytes=saved_b,
                                      recompute_flops=flops,
                                      n_blocks=4, batch=8),
                           policy, cfg, process_count=1, dp=1,
                           microbatch=mb)

    act1, sec1 = terms()
    act2, sec2 = terms(saved_b=2 << 24)
    assert act2 > act1 and sec2 > sec1, "saved bytes must raise both"
    _, sec3 = terms(flops=2 << 30)
    assert sec3 > sec1, "recompute flops must raise seconds"
    _, sec_off = terms(policy="off", flops=0)
    _, sec_dots = terms(flops=0)
    assert sec_dots > sec_off, "'off' must skip the region overhead"
    act_mb, sec_mb = terms(mb=4)
    assert act_mb < act1, "microbatching must divide residency"
    assert sec_mb > sec1, "microbatching must not divide traffic"
    print("plan selfcheck: remat axis enumeration + score monotonicity OK")


def _check_monotonicity() -> None:
    from ray_lightning_tpu_torch.comm.audit import bytes_to_seconds

    prev = -1.0
    for nbytes in (0, 1, 1024, 1 << 20, 1 << 30, 1 << 40):
        s = bytes_to_seconds(nbytes, 12.5)
        assert s > prev or nbytes == 0, (nbytes, s, prev)
        prev = s
    assert bytes_to_seconds(1 << 30, 100.0) \
        < bytes_to_seconds(1 << 30, 12.5), "faster link must score lower"
    assert bytes_to_seconds({"a": 512, "b": 512}, 1.0) \
        == bytes_to_seconds(1024, 1.0), "dict form must sum"
    print("plan selfcheck: byte→seconds monotone in bytes and bandwidth")


def _check_report_schema() -> None:
    from ray_lightning_tpu_torch.plan.candidates import Candidate
    from ray_lightning_tpu_torch.plan.report import (ENTRY_KEYS, REPORT_KEYS,
                                               PlanReport, make_entry)

    cand = Candidate(strategy="ddp", axis_sizes=(("data", 8),))
    entries = [
        make_entry("zz:pruned", "pruned", "batch_indivisible: …"),
        make_entry(cand, "rejected", "hbm_over_budget: …"),
        make_entry(cand, "winner", modeled={"comm_seconds": 0.0},
                   measured={"compile_seconds": 0.1}),
    ]
    d = PlanReport(entries=entries, winner_label=cand.label,
                   topk=3, plan_seconds=0.5, cache_misses=1).to_dict()
    for k in REPORT_KEYS:
        assert k in d, f"report missing {k!r}"
    for e in d["candidates"]:
        for k in ENTRY_KEYS:
            assert k in e, f"entry missing {k!r}: {e}"
    assert d["enumerated"] == 3 and d["pruned"] == 1 \
        and d["rejected"] == 1 and d["compiled"] == 1
    assert d["winner"] == cand.label
    assert d["observed"] is None, \
        "observed divergence must be None until a run measures it"
    print("plan selfcheck: report schema pinned")


def _check_metric_names() -> None:
    from ray_lightning_tpu_torch.telemetry.metrics import validate_metric_name
    for name in ("rlt_plan_candidates_total", "rlt_plan_pruned_total",
                 "rlt_plan_rejected_total", "rlt_plan_compiled_total",
                 "rlt_plan_seconds"):
        validate_metric_name(name)
    print("plan selfcheck: metric names Prometheus-clean")


def _main(argv: list) -> int:
    _check_config()
    _check_enumeration()
    _check_remat_axis()
    _check_monotonicity()
    _check_report_schema()
    _check_metric_names()
    return 0


if __name__ == "__main__":   # pragma: no cover - run as a module
    import sys
    sys.exit(_main(sys.argv[1:]))
