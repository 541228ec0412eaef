"""PyTorch/CUDA port, the planner plane (plan/): enumeration, the
launch-free cost model, the fake-tensor verify and ``Trainer(strategy=
"auto")``, held against the JAX package's planner on the same inputs.

- Enumeration: for the same device count, global batch and
  ``PlanConfig``, ``enumerate_candidates`` gives the JAX labels in the
  JAX order and the JAX prune reasons; the one difference is donation,
  which the port has no counterpart for: every ``nodonate``
  combination is pruned as ``donation_inapplicable``.
- The model-only planner (``topk=0``, budget and link rates explicit):
  the JAX winner (its donation flag aside), the JAX status of every
  shared label, and the modeled comm bytes of every shared label equal,
  for BoringModel and tiny GPT on 8 devices, and for the JAX test's
  hand-measured picks (tiny "off", gpt2-medium "dots", gpt2-moe-8e
  "dots", ``tests/test_plan.py``) given the JAX model's two constants
  (residency 0.3, 5e-6 s a region: plan/cost.py's constants patched)
  and rates (819 GB/s, 65 TFLOP/s): the port's defaults are the
  card's.
- ``strategy="auto"``: losses and parameters equal to the hand-picked
  fit in process, over two gloo ``RayPlugin`` workers (each rank plans
  alone; the ranks' winners are gathered and equal), the report reused
  inside a Tune trial, ``topk`` bounding the verify, nothing fitting
  raising with every reason named.

The bars: labels, statuses and bytes are exact; parameters after a fit
bit for bit.  Classes that ride to workers live here, so JAX is
imported inside the functions only.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch import Trainer
from ray_lightning_tpu_torch.core.callbacks import Callback
from ray_lightning_tpu_torch.models.boring import BoringModel
from ray_lightning_tpu_torch.models.gpt import GPTLightningModule
from ray_lightning_tpu_torch.plan import (Candidate, PlanConfig, Planner,
                                          clear_plan_memo,
                                          enumerate_candidates,
                                          resolve_remat_options)
from ray_lightning_tpu_torch.plan.candidates import NODONATE_REASON
from ray_lightning_tpu_torch.plugins.ray_ddp import RayPlugin

BATCH = 16
#: the JAX model's rates and (patched in, ``_jax_constants``) constants,
#: for the parity cases
JAX_MODEL = dict(hbm_gbps=819.0, device_tflops=65.0)


@pytest.fixture
def _jax_constants(monkeypatch):
    from ray_lightning_tpu.plan import cost as jax_cost
    from ray_lightning_tpu_torch.plan import cost
    monkeypatch.setattr(cost, "REMAT_RESIDENCY_FACTOR",
                        jax_cost.REMAT_RESIDENCY_FACTOR)
    monkeypatch.setattr(cost, "REMAT_BLOCK_OVERHEAD_S",
                        jax_cost.REMAT_BLOCK_OVERHEAD_S)


@pytest.fixture(autouse=True)
def _fresh_memo():
    clear_plan_memo()
    yield
    clear_plan_memo()


def _jax_cfg(**kw):
    from ray_lightning_tpu.plan import PlanConfig as JaxPlanConfig
    return JaxPlanConfig(**kw)


def _batch(module):
    return next(iter(module.train_dataloader()))


def _jax_batch(module):
    import jax
    return jax.tree_util.tree_map(np.asarray,
                                  next(iter(module.train_dataloader())))


# -- enumeration -----------------------------------------------------------

ENUM_CASES = {
    "mb2-2proc": (8, 16, dict(microbatch=(1, 2)), 2, False, ("",)),
    "mb4-batch8": (8, 8, dict(microbatch=(1, 4)), 2, False, ("",)),
    "batch12": (8, 12, dict(microbatch=(1, 4)), 2, False, ("",)),
    "remat-1proc": (8, 16, {}, 1, False, ("off", "dots")),
    "comm-hint": (4, 16, dict(strategies=("ddp", "spmd")), 1, True, ("",)),
    "one-device": (1, 8, {}, 1, False, ("off", "dots", "full")),
}


@pytest.mark.parametrize("case", list(ENUM_CASES))
def test_enumeration_matches_jax(case):
    from ray_lightning_tpu.plan import (
        enumerate_candidates as jax_enumerate)
    n, batch, kw, pc, hint, remat = ENUM_CASES[case]
    jc, jp = jax_enumerate(n, batch, _jax_cfg(**kw), process_count=pc,
                           comm_enabled_hint=hint, remat_options=remat)
    tc, tp = enumerate_candidates(n, batch, PlanConfig(**kw),
                                  process_count=pc, comm_enabled_hint=hint,
                                  remat_options=remat)
    assert [c.label for c in tc] == [c.label for c in jc if c.donate]
    nodonate = [(c.label, NODONATE_REASON) for c in jc if not c.donate]
    assert [e for e in tp if e[1] != NODONATE_REASON] == list(jp)
    assert sorted(e for e in tp if e[1] == NODONATE_REASON) \
        == sorted(nodonate)
    # the report keeps the JAX count
    assert len(tc) + len(tp) == len(jc) + len(jp)


def test_remat_options_match_jax(monkeypatch):
    from ray_lightning_tpu.models.gpt import GPTLightningModule as JaxGPT
    from ray_lightning_tpu.plan import (
        resolve_remat_options as jax_resolve)
    jspec = JaxGPT("tiny").configure_remat()
    tspec = GPTLightningModule("tiny").configure_remat()
    for kw in ({}, dict(remat=("dots", "warp")), dict(remat=("full",))):
        assert resolve_remat_options(tspec, PlanConfig(**kw)) \
            == jax_resolve(jspec, _jax_cfg(**kw))
    assert resolve_remat_options(None, PlanConfig(remat=("dots",))) \
        == jax_resolve(None, _jax_cfg(remat=("dots",)))
    monkeypatch.setenv("RLT_REMAT_POLICY", "full")
    assert resolve_remat_options(tspec, PlanConfig()) == (("full",), [])


# -- the model-only planner against the JAX one ----------------------------

def _normalized(entries):
    """label (donated form) -> JAX status, a nodonate winner naming its
    donated twin's status (the port prunes every nodonate twin)."""
    out = {}
    for e in entries:
        label = e["label"].replace(":nodonate", "")
        if e["status"] == "winner" or label not in out:
            out[label] = e["status"]
    return out


def _plan_pair(jax_module, port_module, jax_batch, port_batch, hint, kw,
               n=8):
    from ray_lightning_tpu.plan import Planner as JaxPlanner
    jr = JaxPlanner(_jax_cfg(topk=0, **kw)).plan(jax_module, jax_batch,
                                                 batch_hint=hint)
    tr = Planner(PlanConfig(topk=0, **kw)).plan(
        port_module, port_batch, n_devices=n, batch_hint=hint,
        device="cpu")
    return jr.to_dict(), tr.to_dict(), jr, tr


def _assert_plans_agree(jd, td):
    assert td["winner"] == jd["winner"].replace(":nodonate", "")
    jstatus = _normalized(jd["candidates"])
    tstatus = {e["label"]: e["status"] for e in td["candidates"]
               if ":nodonate" not in e["label"]}
    shared = sorted(set(jstatus) & set(tstatus))
    assert shared and {k: tstatus[k] for k in shared} \
        == {k: jstatus[k] for k in shared}
    # the modeled comm bytes of every scored label equal
    jbytes = {e["label"]: e["modeled"]["comm_bytes"]
              for e in jd["candidates"] if e.get("modeled")}
    tbytes = {e["label"]: e["modeled"]["comm_bytes"]
              for e in td["candidates"] if e.get("modeled")}
    both = set(jbytes) & set(tbytes)
    assert both and {k: tbytes[k] for k in both} \
        == {k: jbytes[k] for k in both}
    return shared


def test_model_only_planner_matches_jax_boring():
    from ray_lightning_tpu.models.boring import BoringModel as JaxBoring
    jm = JaxBoring(batch_size=BATCH, dataset_length=4 * BATCH)
    jm.prepare_data()
    jm.setup("fit")
    jm.setup_model()
    tm = BoringModel(batch_size=BATCH, dataset_length=4 * BATCH)
    jd, td, _, _ = _plan_pair(jm, tm, _jax_batch(jm), _batch(tm), BATCH,
                              dict(hbm_budget_bytes=1 << 30))
    assert td["winner"] == "ddp[data8]"
    shared = _assert_plans_agree(jd, td)
    assert any(s.startswith("spmd[") for s in shared)


@pytest.mark.parametrize("name,expected", [
    ("tiny", "off"),
    ("gpt2-medium", "dots"),
    ("gpt2-moe-8e", "dots"),
])
def test_model_only_planner_matches_jax_hand_picks(name, expected,
                                                   _jax_constants):
    """The JAX test's fixture (``test_cost_model_reproduces_hand_measured
    _picks``: ddp only, B=8, a 16 GiB budget) with its model's constants
    and rates given explicitly: the same winner, statuses and bytes."""
    from ray_lightning_tpu.models.gpt import GPTLightningModule as JaxGPT
    jm = JaxGPT(name, dataset_size=32, batch_size=8)
    jm.setup_model()
    tm = GPTLightningModule(name, dataset_size=32, batch_size=8)
    kw = dict(strategies=("ddp",), hbm_budget_bytes=16 << 30, **JAX_MODEL)
    jd, td, _, tr = _plan_pair(jm, tm, _jax_batch(jm), _batch(tm), 8, kw)
    assert jd["remat"]["winner"] == td["remat"]["winner"] == expected
    assert tr.winner_candidate.remat == expected
    _assert_plans_agree(jd, td)
    if name == "gpt2-moe-8e":
        pol = td["remat"]["policies"]
        assert pol["dots"]["remat_seconds"] \
            < pol["dots_moe_act"]["remat_seconds"] \
            < pol["dots_moe"]["remat_seconds"]


def test_port_defaults_are_the_cards():
    """The port's default constants name no TPU figure: the H100's HBM
    rate, a measured recompute rate, eager autograd's residency and the
    measured region cost (plan/config.py, plan/cost.py)."""
    from ray_lightning_tpu.plan import cost as jax_cost
    from ray_lightning_tpu_torch.comm.audit import (INTER_HOST_GBPS,
                                                    INTRA_HOST_GBPS)
    from ray_lightning_tpu_torch.plan import cost
    cfg = PlanConfig()
    assert cfg.hbm_gbps == 3350.0 and cost.REMAT_RESIDENCY_FACTOR == 1.0
    assert (cfg.ici_gbps, cfg.dcn_gbps) == (INTRA_HOST_GBPS,
                                            INTER_HOST_GBPS)
    assert cfg.device_tflops != _jax_cfg().device_tflops
    assert cost.REMAT_BLOCK_OVERHEAD_S != jax_cost.REMAT_BLOCK_OVERHEAD_S


# -- scoring, ranking, reporting -------------------------------------------

def test_over_budget_rejected_and_nothing_fitting_raises():
    module = BoringModel(batch_size=BATCH, dataset_length=4 * BATCH)
    with pytest.raises(ValueError, match="hbm_over_budget") as ei:
        Planner(PlanConfig(hbm_budget_bytes=1024, topk=0)).plan(
            module, _batch(module), n_devices=8, batch_hint=BATCH,
            device="cpu")
    msg = str(ei.value)
    for label in ("ddp[data8]", "zero1[data8]", "fsdp[data8]",
                  "spmd[data4xfsdp2]"):
        assert label in msg, msg
    assert "donation_inapplicable" in msg and "comm_no_dcn" in msg
    ok = Planner(PlanConfig(hbm_budget_bytes=1 << 30, topk=0)).plan(
        module, _batch(module), n_devices=8, batch_hint=BATCH,
        device="cpu")
    assert ok.winner_label == "ddp[data8]"


def test_ranking_deterministic_and_reports_everything():
    module = GPTLightningModule("tiny", dataset_size=4 * BATCH,
                                batch_size=BATCH)
    r1 = Planner(PlanConfig(topk=0)).plan(module, _batch(module),
                                          n_devices=8, batch_hint=BATCH,
                                          device="cpu")
    r2 = Planner(PlanConfig(topk=0)).plan(module, _batch(module),
                                          n_devices=8, batch_hint=BATCH,
                                          device="cpu")
    d1, d2 = r1.to_dict(), r2.to_dict()
    assert d1["winner"] == d2["winner"] == "ddp[data8]:rm-off"
    assert [e["label"] for e in d1["candidates"]] \
        == [e["label"] for e in d2["candidates"]]
    for e in d1["candidates"]:
        if e["status"] in ("pruned", "rejected"):
            assert e["reason"], e
    pol = d1["remat"]["policies"]
    assert set(pol) == {"off", "full", "dots", "dots_no_batch"}
    assert pol["off"]["act_bytes"] > pol["dots"]["act_bytes"] \
        > pol["full"]["act_bytes"] == 0
    assert module.config.remat is False     # planning applied nothing


def test_topk_bounds_the_verify():
    """At most ``topk`` candidates run the fake-tensor step; each gets
    its ``MemTracker`` peak and ``CollectiveLog`` bytes, the winner
    too; nothing is launched or built (no kernel-cache miss)."""
    module = GPTLightningModule("tiny", dataset_size=4 * BATCH,
                                batch_size=BATCH)
    for topk in (1, 2):
        d = Planner(PlanConfig(topk=topk, strategies=("ddp", "fsdp"))).plan(
            module, _batch(module), n_devices=1, batch_hint=BATCH,
            device="cpu").to_dict()
        verified = [e for e in d["candidates"] if e.get("measured")]
        assert d["compiled"] == len(verified) <= topk
        assert d["cache_misses"] == 0
        for e in verified:
            m = e["measured"]
            assert m["error"] is None and m["peak_bytes"] > 0
            assert m["wire_bytes"] == 0       # one rank: no collective
            assert m["peak_bytes"] >= m["argument_bytes"] > 0
        assert not any((e["reason"] or "").startswith(
            ("compile_error", "build_error")) for e in d["candidates"])


def test_fake_verify_collectives_are_logged():
    """Under the fake process group the step's collectives move nothing
    and the ``CollectiveLog`` records what it issues: a two-rank DDP
    step's gradient all-reduce is its declared bytes."""
    import torch.distributed as dist

    from ray_lightning_tpu_torch.comm import audit
    from ray_lightning_tpu_torch.compile.aot import fake_collectives
    from ray_lightning_tpu_torch.core.remat import fake_mode
    with fake_mode(), fake_collectives():
        t = torch.empty(1000)
        with audit.recording() as log:
            audit.note("all-reduce", t, None, tag="ddp")
            work = dist.all_reduce(t, async_op=True)
        assert work.wait()
    assert audit.total_wire_bytes(log) == 2 * 4000


def test_auto_resolves_to_a_sentinel():
    from ray_lightning_tpu_torch.parallel.strategy import resolve_strategy
    auto = resolve_strategy("auto")
    assert auto.name == "auto"
    with pytest.raises(RuntimeError, match="planner"):
        auto.build_mesh()


def test_plan_config_env_round_trip(monkeypatch):
    for k in list(__import__("os").environ):
        if k.startswith("RLT_PLAN"):
            monkeypatch.delenv(k)
    cfg = PlanConfig(topk=2, remat=("dots", "off"), hbm_gbps=500.0,
                     device_tflops=90.0, hbm_budget_bytes=1 << 30)
    for k, v in cfg.worker_env().items():
        monkeypatch.setenv(k, v)
    assert PlanConfig.resolve(None) == cfg
    monkeypatch.setenv("RLT_REMAT_POLICY", "dots")
    env = RayPlugin(num_workers=2, platform="cpu")._worker_env_base()
    assert env["RLT_REMAT_POLICY"] == "dots"


def test_link_gbps_per_op_attribution():
    from ray_lightning_tpu.plan.cost import link_gbps as jax_link
    from ray_lightning_tpu_torch.plan.cost import link_gbps
    cfg = PlanConfig(ici_gbps=100.0, dcn_gbps=10.0)
    jcfg = _jax_cfg(ici_gbps=100.0, dcn_gbps=10.0)
    for op in ("grad_all_reduce_ici", "grad_all_reduce_dcn",
               "grad_all_reduce", "param_all_gather"):
        for pc in (1, 2):
            assert link_gbps(op, cfg, pc) == jax_link(op, jcfg, pc)


# -- strategy="auto" end to end --------------------------------------------

def _trainer(tmp_path, name, **kw):
    return Trainer(default_root_dir=str(tmp_path / name), max_epochs=1,
                   enable_checkpointing=False, num_sanity_val_steps=0,
                   limit_val_batches=0, log_every_n_steps=10**9, seed=0,
                   logger=False, **kw)


def _assert_same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_auto_end_to_end_matches_hand_picked(tmp_path):
    auto = _trainer(tmp_path, "auto", strategy="auto", max_steps=4,
                    device="cpu")
    m_auto = BoringModel(batch_size=BATCH, dataset_length=4 * BATCH)
    auto.fit(m_auto)
    assert auto.global_step == 4
    d = auto._plan_report
    assert d["winner"] == "ddp[data1]" and auto.strategy.name == "ddp"
    assert auto.time_to_first_step is not None
    hand = _trainer(tmp_path, "hand", strategy="ddp", max_steps=4,
                    device="cpu")
    m_hand = BoringModel(batch_size=BATCH, dataset_length=4 * BATCH)
    hand.fit(m_hand)
    assert hand._plan_report is None
    _assert_same_state(m_auto._trained_state, m_hand._trained_state)


def test_auto_gpt_applies_the_remat_winner(tmp_path):
    """tiny GPT: the winner is its default "off" (the losses equal the
    hand-picked fit's); a sweep restricted to "dots" reconfigures the
    module in place and trains to the same parameters (remat never
    changes the arithmetic)."""
    def module():
        return GPTLightningModule("tiny", dataset_size=4 * BATCH,
                                  batch_size=BATCH)
    auto = _trainer(tmp_path, "auto", strategy="auto", max_steps=3,
                    plan={"topk": 1}, device="cpu")
    m_auto = module()
    auto.fit(m_auto)
    assert auto._plan_report["winner"] == "ddp[data1]:rm-off"
    assert m_auto.config.remat is False
    hand = _trainer(tmp_path, "hand", max_steps=3, device="cpu")
    m_hand = module()
    hand.fit(m_hand)
    _assert_same_state(m_auto._trained_state, m_hand._trained_state)
    forced = _trainer(tmp_path, "forced", strategy="auto", max_steps=3,
                      plan={"topk": 0, "remat": ("dots",)}, device="cpu")
    m_forced = module()
    forced.fit(m_forced)
    assert forced._plan_report["winner"] == "ddp[data1]:rm-dots"
    assert m_forced.config.remat and m_forced.config.remat_policy == "dots"
    _assert_same_state(m_forced._trained_state, m_hand._trained_state)


class WinnersAgree(Callback):
    """In each worker: every rank's plan winner, gathered; they must
    agree (no collective decided them)."""

    def setup(self, trainer, module, stage):
        from ray_lightning_tpu_torch.parallel.strategy import gather_objects
        winners = gather_objects(trainer._plan_report["winner"])
        assert len(set(winners)) == 1, winners


def test_auto_two_workers_plan_alike(tmp_path):
    """Two gloo workers: each rank plans alone (the ranks' winners are
    gathered and equal), the top three are verified by a fake step
    whose collectives the log records (the two-rank DDP step's gradient
    all-reduce charged 2 x its bytes, as the audit charges it), and the
    fit equals the winning plan hand-picked.  The JAX package's winner
    here is ``ddp[data2]``: its HLO audit charges the int8 codec more
    than the port's log does (its scales and padding), so the port may
    pick a compressed candidate; the pick is the verify's, from bytes
    both ranks compute alike."""
    from ray_lightning_tpu_torch.plan.candidates import policy_for_candidate
    auto = _trainer(tmp_path, "auto", strategy="auto",
                    plugins=[RayPlugin(num_workers=2, platform="cpu")],
                    callbacks=[WinnersAgree()])
    m_auto = BoringModel(batch_size=BATCH, dataset_length=4 * BATCH)
    auto.fit(m_auto)
    assert auto.global_step == 2          # 64 samples over 2 workers
    d = auto._plan_report
    entries = {e["label"]: e for e in d["candidates"]}
    reasons = [e["reason"] for e in d["candidates"]
               if e["status"] == "pruned"]
    assert any(r.startswith("comm_unsupported") for r in reasons)
    assert d["compiled"] == 3
    assert entries["ddp[data2]"]["measured"]["wire_bytes"] \
        == 2 * entries["ddp[data2]"]["modeled"]["comm_bytes"]
    win = entries[d["winner"]]
    assert win["status"] == "winner" and win["measured"]["error"] is None
    cand = Candidate(win["strategy"], tuple(sorted(win["mesh"].items())),
                     comm=win["comm"])
    hand = _trainer(tmp_path, "hand", strategy=win["strategy"],
                    comm_policy=policy_for_candidate(cand),
                    plugins=[RayPlugin(num_workers=2, platform="cpu")])
    m_hand = BoringModel(batch_size=BATCH, dataset_length=4 * BATCH)
    hand.fit(m_hand)
    _assert_same_state(m_auto._trained_state, m_hand._trained_state)


def test_auto_reuses_the_plan_inside_a_tune_trial(tmp_path):
    from ray_lightning_tpu_torch.tune.runner import Trial
    from ray_lightning_tpu_torch.tune.session import (TrialSession,
                                                      set_session)
    module = BoringModel(batch_size=BATCH, dataset_length=4 * BATCH)
    trial = Trial("t0", {}, str(tmp_path))
    set_session(TrialSession(trial, lambda t, m: None))
    try:
        kw = dict(n_devices=8, batch_hint=BATCH, device="cpu")
        r1 = Planner(PlanConfig(topk=0)).plan(module, _batch(module), **kw)
        assert not r1.reused
        r2 = Planner(PlanConfig(topk=0)).plan(module, _batch(module), **kw)
        assert r2.reused and r2.winner_label == r1.winner_label
        assert trial.plan_report["winner"] == r1.winner_label
        assert trial.plan_report["reused"]
    finally:
        set_session(None)


def test_candidate_labels_and_strategies():
    cand = Candidate("spmd", (("data", 2), ("fsdp", 4)), microbatch=2,
                     remat="dots")
    assert cand.label == "spmd[data2xfsdp4]:mb2:rm-dots"
    strat = cand.build_strategy()
    assert strat.name == "spmd" and strat.axis_sizes(8)["fsdp"] == 4
    assert dataclasses.replace(cand, donate=False).label \
        == "spmd[data2xfsdp4]:nodonate:mb2:rm-dots"


def test_plan_selfcheck_runs():
    from ray_lightning_tpu_torch.plan import selfcheck
    assert selfcheck._main([]) == 0
