"""PyTorch/CUDA port, KV shipping and what it stands on: the engine's
``export_kv`` / ``kv_import_{b}``, the scheduler's ship and adoption
hooks, the worker's export and import, ``Server(paged=...)`` over two
ranks, the int8-resident draft, and disaggregated fleets over CPU serve
actors, each against the JAX package.

- engines: a prompt prefilled on one port engine, its whole pages
  exported and imported into another, resumes with the JAX engine's
  greedy tokens (fp32, exact up to a 2e-5 near-tie);
- scheduler: ship-bound plans, the kv outbox, ``withdraw_queued`` and
  ``adopt_imported`` / ``adopt_commit`` / ``adopt_abort`` on fabricated
  results equal the JAX scheduler's, step by step;
- ``Server(paged=..., num_workers=2)`` serves the JAX engine's tokens,
  each reuse inside its rank's block;
- an int8-resident draft: the JAX int8 spec engine's tokens and drafts,
  equal ``draft_resident_bytes`` and program counts;
- a prefill and a decode replica (``fleet={"roles": ...}``) over CPU
  workers: tokens equal a pooled fleet's with ``raw`` and ``fp8`` on
  the wire, 3 ships, one chaos failover after 2 retries, compression
  1.0 and >= 3.0, a sub-page prompt pooled (tests/test_fleet.py's
  bar).

JAX is imported inside the tests and fixtures only, so that importing
this module (as a worker does to unpickle a name of it) stays free of
JAX.
"""

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch import (FleetServer, GPTLightningModule,
                                     Scheduler, ServeEngine, ServeWorker,
                                     Server, flax_to_torch)
from ray_lightning_tpu_torch.models.gpt import GPTConfig
from ray_lightning_tpu_torch.serve import PageConfig, SpecConfig

TINY = dict(vocab_size=128, block_size=32, n_layer=2, n_head=2, n_embd=32,
            remat=False)
BUCKETS = (16, 32)
PAGE = 8
SHARED = np.arange(1, 17)                      # two whole pages
PROMPTS = [np.concatenate([SHARED, [20 + i]]) for i in range(4)] \
    + [np.arange(40, 45), np.concatenate([SHARED[:8], [70, 71, 72]])]
NEW_TOKENS = 6
WAIT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the CPU workers take."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_engine(**kw):
    import jax.numpy as jnp

    from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
    from ray_lightning_tpu.models.gpt import GPTLightningModule as JaxModule
    from ray_lightning_tpu.parallel.strategy import DataParallelStrategy
    from ray_lightning_tpu.serve.engine import ServeEngine as JaxEngine
    module = JaxModule(JaxConfig(**TINY, dtype=jnp.float32))
    return module, JaxEngine(module, DataParallelStrategy(), buckets=BUCKETS,
                             slots=4, max_seq_len=TINY["block_size"],
                             seed=0, **kw).setup()


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX engine's fp32 params, its greedy tokens for each prompt
    (one request at a time, dense decode) and its whole-sequence
    forward's logits over a prompt and its tokens."""
    import jax

    from ray_lightning_tpu.serve.scheduler import Scheduler as JaxScheduler
    from ray_lightning_tpu.serve.worker import ServeWorker as JaxWorker

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RLT_BF16_PARAMS", "0")
        mp.setenv("RLT_DECODE_IMPL", "dense")
        module, eng = _jax_engine()
        worker = JaxWorker()
        worker._engine = eng
        worker._rank = 0
        tokens = []
        for p in PROMPTS:
            sched = JaxScheduler(buckets=BUCKETS, slots=4,
                                 max_seq_len=TINY["block_size"],
                                 default_max_new_tokens=NEW_TOKENS)
            r = sched.submit(p)
            while not sched.idle():
                plan = sched.plan()
                sched.apply(plan, worker.serve_step(plan))
            tokens.append(r.result(1).tolist())
    params = jax.device_get(eng.params)
    jmodel = module.configure_decode_model()

    def logits(prompt, gen):
        seq = np.asarray([list(prompt) + list(gen[:-1])], np.int32)
        out = np.asarray(jmodel.apply({"params": params}, seq, True),
                         np.float32)
        return out[0, len(prompt) - 1:]

    return params, tokens, logits


def assert_tokens(got, want, prompt, logits, tol=2e-5):
    """fp32: the JAX engine's tokens up to the first step whose two
    greedy choices lie within ``tol`` (teacher-forced)."""
    ref = logits(prompt, got)
    for i, tok in enumerate(got):
        best = int(np.argmax(ref[i]))
        assert tok == best or ref[i][tok] >= ref[i][best] - tol, \
            (prompt, i, tok, best)
    n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             len(got))
    assert got[:n] == want[:n]
    if n < len(got):
        assert abs(ref[n][got[n]] - ref[n][want[n]]) <= tol, (got, want)


def _module(params=None, **cfg):
    module = GPTLightningModule(GPTConfig(**{**TINY, **cfg},
                                          dtype=torch.float32))
    if params is not None:
        module._trained_state = flax_to_torch(params)
    return module


def _engine(params, **kw):
    return ServeEngine(_module(), BUCKETS, 4, TINY["block_size"],
                       weights=flax_to_torch(params), device="cpu",
                       paged=PageConfig(True, PAGE), **kw).setup()


def _drain(sched, worker):
    while not sched.idle():
        plan = sched.plan()
        sched.apply(plan, worker.serve_step(plan))


# -- engines ------------------------------------------------------------------

def test_export_import_resumes_the_jax_engines_tokens(jax_reference,
                                                      monkeypatch):
    """Disaggregation by hand: engine A prefills each prompt (a
    ship-bound leg of one token, its whole pages exported with the step
    result), engine B adopts the rows (``adopt_imported``, the worker's
    ``serve_import_kv``, ``adopt_commit``) bit for bit and serves prompt
    + first token through a reuse of them: the JAX engine's tokens."""
    monkeypatch.setenv("RLT_BF16_PARAMS", "0")
    params, want, logits = jax_reference
    a, b = _engine(params, kvship=True), _engine(params, kvship=True)
    assert a.stats()["programs"] == 2 + 2 + 2 + 2
    pages = PageConfig(True, PAGE)
    for prompt, w in zip(PROMPTS[:4], want):
        sched_a = Scheduler(BUCKETS, 4, TINY["block_size"], paged=pages,
                            default_max_new_tokens=1)
        leg1 = sched_a.submit(prompt, ship_kv=True)
        _drain(sched_a, ServeWorker(a))
        k_rows, v_rows, matched = sched_a.pop_kv_export(leg1.id)
        assert sched_a.pop_kv_export(leg1.id) is None      # claimed once
        assert matched == 16 and tuple(k_rows.shape) == (2, 1, 16, 2, 16)
        assert torch.equal(k_rows[:, 0], a._k[:, leg1.slot, :16])
        sched_b = Scheduler(BUCKETS, 4, TINY["block_size"], paged=pages,
                            default_max_new_tokens=NEW_TOKENS - 1)
        slot = sched_b.adopt_imported(prompt)
        ServeWorker(b).serve_import_kv(slot, k_rows, v_rows)
        sched_b.adopt_commit(slot, prompt)
        assert torch.equal(b._k[:, slot, :16], a._k[:, leg1.slot, :16])
        assert torch.equal(b._v[:, slot, :16], a._v[:, leg1.slot, :16])
        t1 = int(leg1.result(0)[0])
        leg2 = sched_b.submit(np.concatenate([prompt, [t1]]))
        _drain(sched_b, ServeWorker(b))
        st = sched_b.pages.stats()
        assert st["remote_imports"] == 1 and st["reused_prefills"] == 1
        assert st["federated_tokens_reused"] == 16
        assert_tokens([t1] + leg2.result(0).tolist(), w, prompt, logits)
    assert b.stats()["calls"]["kv_import"] == 4
    # the worker's export answers from the rank that owns the slot
    rows = ServeWorker(a).serve_export_kv(leg1.slot, 16)
    assert torch.equal(rows[0], k_rows)
    with pytest.raises(ValueError, match="bad import"):
        b.import_kv(0, k_rows[:, :, :8], v_rows[:, :, :8])
    with pytest.raises(RuntimeError, match="kvship"):
        _engine(params).import_kv(0, k_rows, v_rows)


# -- scheduler hooks ------------------------------------------------------------

def _plan_view(plan):
    if plan is None:
        return None
    out = {"prefills": [{k: (v.tolist() if isinstance(v, np.ndarray)
                             else v)
                         for k, v in p.items() if k != "trace"}
                        for p in plan["prefills"]], "decode": None}
    d = plan["decode"]
    if d is not None:
        out["decode"] = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                         for k, v in d.items() if k != "traces"}
    return out


def _fabricate(plan, rows):
    result = {"prefill": {p["slot"]: 7 for p in plan["prefills"]},
              "decode": {}}
    for p in plan["prefills"]:
        if p.get("export_kv") is not None:
            result.setdefault("kv_export", {})[p["slot"]] = rows
    if plan["decode"] is not None:
        result["decode"] = {s: 9 for s in plan["decode"]["slots"]}
    return result


def test_scheduler_ship_and_adoption_hooks_equal_jax():
    """One random script of ship-bound and plain submits, steps on
    fabricated results, outbox claims, withdraws and adoptions (commit
    and abort) through the JAX scheduler and the port's: equal plans,
    claims, withdrawn ids, adopted slots and page stats throughout; the
    outbox keeps at most 64 entries."""
    from ray_lightning_tpu.serve.fleet.pages import PageConfig as JaxPage
    from ray_lightning_tpu.serve.scheduler import Scheduler as JaxScheduler
    rng = np.random.default_rng(0)
    rows = ("k", "v")
    scheds = [JaxScheduler(BUCKETS, 4, 32, max_prefills_per_step=2,
                           default_max_new_tokens=3,
                           paged=JaxPage(True, PAGE)),
              Scheduler(BUCKETS, 4, 32, max_prefills_per_step=2,
                        default_max_new_tokens=3,
                        paged=PageConfig(True, PAGE))]
    heads = [rng.integers(1, 90, 16) for _ in range(3)]
    reqs = [[], []]
    for step in range(300):
        op = rng.choice(["submit", "step", "claim", "withdraw", "adopt"],
                        p=[.35, .35, .15, .05, .1])
        toks = np.concatenate([heads[rng.integers(0, 3)][
            :int(rng.integers(0, 17))], rng.integers(1, 90, 3)])
        if op == "submit":
            ship, new = bool(rng.random() < .5), int(rng.integers(1, 4))
            for s, r in zip(scheds, reqs):
                r.append(s.submit(toks, max_new_tokens=new, ship_kv=ship))
        elif op == "step":
            plans = [s.plan() for s in scheds]
            assert _plan_view(plans[0]) == _plan_view(plans[1]), step
            if plans[0] is not None:
                for s, p in zip(scheds, plans):
                    s.apply(p, _fabricate(p, rows))
        elif op == "claim" and reqs[0]:
            i = int(rng.integers(0, len(reqs[0])))
            got = [s.pop_kv_export(r[i].id) for s, r in zip(scheds, reqs)]
            assert got[0] == got[1], step
        elif op == "withdraw":
            out = [[r.id for r in s.withdraw_queued()] for s in scheds]
            assert out[0] == out[1]
        elif op == "adopt":
            slots = [s.adopt_imported(toks) for s in scheds]
            assert slots[0] == slots[1], step
            if slots[0] is not None:
                commit = rng.random() < .7
                for s in scheds:
                    if commit:
                        s.adopt_commit(slots[0], toks)
                    else:
                        s.adopt_abort(slots[0])
        assert scheds[0].pages.stats() == scheds[1].pages.stats(), step
        assert scheds[0].stats()["completed"] == scheds[1].stats()[
            "completed"]
        assert len(scheds[1]._kv_outbox) == len(scheds[0]._kv_outbox) <= 64
    st = scheds[1].pages.stats()
    assert st["remote_imports"] > 3 and st["prefix_hits"] > 10, st


def test_scheduler_keeps_a_reuse_inside_its_ranks_block():
    """``ranks=2``: a donor in rank 0's block is reused only by an
    admission that finds a free slot there; with rank 0's block full
    the admission goes cold to rank 1 (the page copy cannot cross
    ranks), where ``ranks=1`` would have reused."""
    out = {}
    for ranks in (1, 2):
        sched = Scheduler(BUCKETS, 4, 32, default_max_new_tokens=2,
                          max_prefills_per_step=1,
                          paged=PageConfig(True, PAGE), ranks=ranks)
        donor = sched.submit(np.concatenate([SHARED, [50]]))
        while not donor.done():
            sched.apply(p := sched.plan(), _fabricate(p, None))
        assert donor.slot == 0 and sched.pages.donor_count == 1
        hog = sched.submit(np.arange(60, 70), max_new_tokens=20)
        sched.apply(p := sched.plan(), _fabricate(p, None))
        assert hog.slot == 1
        sched.submit(np.concatenate([SHARED, [51]]))
        plan = sched.plan()
        out[ranks] = plan["prefills"][0]
    assert out[1].get("reuse") == {"src": 0, "matched": 16}
    assert out[1]["slot"] == 2 and out[2]["slot"] == 2
    assert "reuse" not in out[2]
    with pytest.raises(ValueError, match="ranks"):
        Scheduler(BUCKETS, 4, 32, ranks=3)


# -- Server over two ranks with paging ---------------------------------------------

def test_paged_server_over_two_ranks_serves_the_jax_tokens(jax_reference,
                                                           monkeypatch):
    """``Server(paged=..., num_workers=2)``: prefix reuse on both ranks,
    each inside its block, and the JAX engine's tokens; its KV-ship
    surface exports a donor's rows from the rank that owns it."""
    monkeypatch.setenv("RLT_BF16_PARAMS", "0")
    params, want, logits = jax_reference
    server = Server(_module(params), platform="cpu", buckets=BUCKETS,
                    max_batch_slots=4, max_new_tokens=NEW_TOKENS,
                    num_workers=2, paged=PageConfig(True, PAGE),
                    kvship=True)
    with server:
        got = []
        for wave in (PROMPTS[:3], PROMPTS[3:]):
            reqs = [server.submit(p) for p in wave]
            got += [r.result(WAIT_S).tolist() for r in reqs]
        assert server.can_ship_kv() and server.can_adopt_kv()
        k_rows, v_rows, matched = server.export_kv(PROMPTS[0])
        stats = server.stats()
    for p, g, w in zip(PROMPTS, got, want):
        assert_tokens(g, w, p, logits)
    pages = stats["scheduler"]["pages"]
    assert pages["reused_prefills"] >= 1, pages
    assert matched == 16 and tuple(k_rows.shape) == (2, 1, 16, 2, 16)
    assert [w["slot_block"] for w in stats["workers"]] == [[0, 2], [2, 4]]
    assert [w["calls"]["kv_export"] for w in stats["workers"]].count(1) == 1


# -- the int8-resident draft ----------------------------------------------------------

def test_int8_draft_equals_the_jax_int8_spec_engine(jax_reference,
                                                    monkeypatch):
    """``SpecConfig(draft_quant="int8")`` on the JAX engine and the
    port's, paged with KV shipping: equal ``draft_fp_bytes`` and
    ``draft_resident_bytes``, equal program counts, equal drafts from
    the same prefilled prompts, and the emitted tokens are the JAX
    engine's (the target decides them)."""
    from ray_lightning_tpu.serve.fleet.pages import PageConfig as JaxPage
    from ray_lightning_tpu.serve.spec import SpecConfig as JaxSpec
    monkeypatch.setenv("RLT_BF16_PARAMS", "0")
    monkeypatch.setenv("RLT_DECODE_IMPL", "dense")
    params, want, logits = jax_reference
    _, jeng = _jax_engine(paged=JaxPage(True, PAGE), kvship=True,
                          spec=JaxSpec(True, k=2, draft_quant="int8"))
    eng = _engine(params, kvship=True,
                  spec=SpecConfig(True, k=2, draft_quant="int8"))
    js, ts = jeng.stats(), eng.stats()
    assert ts["programs"] == js["programs"]
    for key in ("draft_quant", "draft_fp_bytes", "draft_resident_bytes",
                "draft_hbm_delta_bytes", "k", "draft_layers"):
        assert ts["spec"][key] == js["spec"][key], key
    from ray_lightning_tpu_torch.serve.buckets import pad_to_bucket
    toks, pos = np.zeros(4, np.int32), np.zeros(4, np.int32)
    for slot, p in enumerate(PROMPTS[:4]):
        ids = pad_to_bucket(p, 32)
        for e in (jeng, eng):
            e.draft_prefill(slot, ids, len(p), 32)
        toks[slot], pos[slot] = p[-1], len(p) - 1
    jd = np.asarray(jeng.draft(toks, pos))
    assert np.array_equal(eng.draft(toks, pos), jd), jd
    sched = Scheduler(BUCKETS, 4, 32, default_max_new_tokens=NEW_TOKENS,
                      paged=PageConfig(True, PAGE),
                      spec=SpecConfig(True, k=2, draft_quant="int8"))
    reqs = [sched.submit(p) for p in PROMPTS]
    _drain(sched, ServeWorker(eng))
    for r, p, w in zip(reqs, PROMPTS, want):
        assert_tokens(r.result(0).tolist(), w, p, logits)
    assert sched.stats()["spec"]["drafted"] > 0


# -- disaggregated fleets over CPU serve actors -----------------------------------

def test_disaggregated_fleet_ships_pages_and_fails_over(monkeypatch):
    """A prefill and a decode replica serve every request with a pooled
    fleet's tokens (sequential requests: each ship sees its own fresh
    pages): ``raw`` ships fp32 on the wire (ratio 1.0), ``fp8`` at a
    ratio >= 3.0; 3 ships each, the sub-page prompt pooled (on the
    decode pool, no ship), and a chaos-dropped ship fails over after
    ``RLT_PEER_RETRIES`` to a local prefill with the same tokens."""
    monkeypatch.setenv("RLT_BF16_PARAMS", "0")
    monkeypatch.setenv("RLT_PEER_RETRIES", "2")
    monkeypatch.setenv("RLT_PEER_BACKOFF_S", "0.01")
    monkeypatch.setenv("RLT_KVSHIP_TIMEOUT_S", "0.05")
    prompts = PROMPTS[:3] + [np.arange(1, 7)]

    def serve(cfg):
        fleet = FleetServer(_module(), replicas=2, autoscale=False,
                            fleet=cfg, paged={"page_size": PAGE},
                            num_workers=1, platform="cpu", buckets=BUCKETS,
                            max_batch_slots=4,
                            max_new_tokens=NEW_TOKENS).start()
        try:
            reqs = []
            outs = []
            for p in prompts:
                reqs.append(fleet.submit(p))
                outs.append(reqs[-1].result(WAIT_S).tolist())
            if cfg:
                fleet.arm_kvship_drop(1)
                reqs.append(fleet.submit(prompts[0]))
                outs.append(reqs[-1].result(WAIT_S).tolist())
            kv = fleet.status()["fleet"].get("kvship")
            log = list(fleet.ship_log)
        finally:
            fleet.shutdown()
        return outs, kv, log, reqs

    want, kv, _, _ = serve(None)
    assert kv is None
    for codec in ("raw", "fp8"):
        outs, kv, log, reqs = serve({"roles": ("prefill", "decode"),
                                     "kvship_codec": codec})
        assert outs[:len(prompts)] == want, codec
        assert outs[-1] == want[0], codec
        assert kv["ships"] == 3 and kv["failovers"] == 1, kv
        assert kv["retries"] == 2 and kv["skipped"] == 0, kv
        assert kv["compression_ratio"] == 1.0 if codec == "raw" \
            else kv["compression_ratio"] >= 3.0, kv
        assert [r["status"] for r in log] == ["ok"] * 3 + ["timeout"]
        assert {r["bucket"] for r in log} == {16}
        assert reqs[3].id not in {r["fid"] for r in log}
        assert reqs[3].replica == 1                 # the decode pool
        # raw: fp32 on the wire, 4 bytes an element of K and V
        if codec == "raw":
            assert kv["bytes_wire"] == kv["bytes_raw"] \
                == 3 * 2 * (2 * 16 * 2 * 16) * 4


def test_adoption_waits_for_the_planned_step_that_copies_its_donor(
        monkeypatch):
    """A planned prefix reuse copies donor slot D; an adoption that runs
    before that step is broadcast must not evict D and install other
    rows there first (the worker runs its calls in arrival order).  The
    pump holds the dispatch lock from the plan to its broadcast, so the
    adoption lands after the step: the reuse serves the in-process
    engine's tokens, and the adopted rows are installed."""
    import threading
    monkeypatch.setenv("RLT_BF16_PARAMS", "0")
    pages = PageConfig(True, PAGE)
    donor, reuser = PROMPTS[0], PROMPTS[1]
    eng = ServeEngine(_module(), BUCKETS, 2, TINY["block_size"],
                      device="cpu", paged=pages).setup()
    sched = Scheduler(BUCKETS, 2, TINY["block_size"], paged=pages,
                      default_max_new_tokens=NEW_TOKENS)
    for p in (donor, reuser):
        r = sched.submit(p)
        _drain(sched, ServeWorker(eng))
    want = r.result(0).tolist()
    server = Server(_module(), platform="cpu", buckets=BUCKETS,
                    max_batch_slots=2, max_new_tokens=NEW_TOKENS,
                    paged=pages, kvship=True)
    rows = torch.randn(2, 1, 16, 2, 16, generator=torch.Generator()
                       .manual_seed(0))
    adopted, race = [], []
    with server:
        server.generate(donor, timeout=WAIT_S)          # slot 0: donor
        plan0 = server.scheduler.plan

        def plan():
            p = plan0()
            if p and any("reuse" in e for e in p["prefills"]) and not race:
                race.append(threading.Thread(target=lambda: adopted.append(
                    server.import_kv(np.arange(90, 107), rows, rows))))
                race[0].start()
                race[0].join(1.0)       # blocks on the dispatch lock
            return p

        monkeypatch.setattr(server.scheduler, "plan", plan)
        got = server.generate(reuser, timeout=WAIT_S).tolist()
        race[0].join(WAIT_S)
        st = server.scheduler.pages.stats()
    assert race and adopted == [True]
    assert st["reused_prefills"] == 1 and st["remote_imports"] == 1
    assert got == want
