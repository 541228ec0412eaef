"""PyTorch/CUDA port, the paged serving slice: the row-14 decode kernel's
plain version against the JAX package's Pallas ``flash_decode_paged_
kernel``, the copied paged-KV host accounting and the paged
``Scheduler`` against the JAX package's, and prefix reuse through the
port's ``ServeEngine(paged=...)`` against the JAX engine on converted
weights.

The JAX decode kernels call ``pltpu.TPUCompilerParams``, which jax 0.9
renamed ``CompilerParams`` (ROADMAP.md queue 3, R1).  The ``pallas``
fixture below puts the old name back for the length of one test
(``monkeypatch``, nothing in the JAX package changes), so the real
Pallas kernels run in interpret mode here.  Tolerances: fp32 2e-5 and
bf16 2e-2 (``atol = rtol``, tests/test_ops.py); greedy tokens equal in
fp32, the teacher-forced near-tie rule at 2e-2 in bf16.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
from ray_lightning_tpu.models.gpt import GPTLightningModule as JaxModule
from ray_lightning_tpu.ops.flash_decode import (
    flash_decode_attention as jax_flash_decode)
from ray_lightning_tpu.parallel.strategy import DataParallelStrategy
from ray_lightning_tpu.serve.engine import ServeEngine as JaxEngine
from ray_lightning_tpu.serve.fleet.pages import PageConfig as JaxPageConfig
from ray_lightning_tpu.serve.fleet.pages import PagedKV as JaxPagedKV
from ray_lightning_tpu.serve.scheduler import Scheduler as JaxScheduler
from ray_lightning_tpu.serve.worker import ServeWorker as JaxWorker
from ray_lightning_tpu_torch import (GPTLightningModule, Scheduler,
                                     ServeEngine, ServeWorker,
                                     flax_to_torch)
from ray_lightning_tpu_torch.models.gpt import GPTConfig
from ray_lightning_tpu_torch.ops.attention import cached_attention
from ray_lightning_tpu_torch.ops.flash_decode import (
    flash_decode_attention_plain, flash_decode_paged_attention,
    flash_decode_paged_attention_plain, flash_decode_split_plain,
    resolve_decode_impl)
from ray_lightning_tpu_torch.serve import PageConfig, PagedKV
from ray_lightning_tpu_torch.serve.fleet import identity_page_table

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes (as tests/test_torch_serve.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas(monkeypatch):
    """The JAX decode kernels under this jax: the name they compile with,
    put back for one test."""
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)


# -- row 14 against the Pallas kernel -----------------------------------------

def _decode_inputs(S, L, H, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((S, L, H, D)).astype(np.float32)
    v = rng.standard_normal((S, L, H, D)).astype(np.float32)
    return rng, q, k, v


def _to(x, tdt):
    return torch.from_numpy(np.asarray(x)).to(tdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page_size", [16, 64])
def test_paged_plain_matches_pallas_paged_kernel(dtype, page_size, pallas):
    """The Pallas ``flash_decode_paged_kernel`` (interpret mode) and the
    port's paged plain version on one page view walked through a
    RANDOMLY PERMUTED table, positions on and around page boundaries."""
    jdt, tdt, tol = DTYPES[dtype]
    H, D, ps = 2, 32, page_size
    L = 3 * ps
    P = L // ps
    pos = np.array([ps - 1, ps, 2 * ps + 1, L - 1, 0], np.int32)
    S = len(pos)
    rng, q, pages_k, pages_v = _decode_inputs(S, L, H, D, page_size)
    table = rng.permutation(S * P).astype(np.int32).reshape(S, P)
    # the JAX kernel takes the cache whose page view holds the pages
    got = jax_flash_decode(
        jnp.asarray(q, jdt), jnp.asarray(pages_k, jdt),
        jnp.asarray(pages_v, jdt), jnp.asarray(pos), dtype=jdt,
        page_table=jnp.asarray(table), interpret=True)
    want_jax = np.asarray(jnp.asarray(got, jnp.float32))
    view = (S * P, ps, H, D)
    mine = flash_decode_paged_attention(
        _to(q, tdt), _to(pages_k, tdt).view(view),
        _to(pages_v, tdt).view(view), torch.from_numpy(pos),
        torch.from_numpy(table)).float().numpy()
    np.testing.assert_allclose(mine, want_jax, atol=tol, rtol=tol)
    # and it is attention over each slot's logical rows
    k_log = np.stack([pages_k.reshape(view)[table[s]].reshape(L, H, D)
                      for s in range(S)])
    v_log = np.stack([pages_v.reshape(view)[table[s]].reshape(L, H, D)
                      for s in range(S)])
    flat = flash_decode_attention_plain(
        _to(q, tdt), _to(k_log, tdt), _to(v_log, tdt),
        torch.from_numpy(pos)).float().numpy()
    np.testing.assert_array_equal(mine, flat)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_plain_matches_pallas_decode_kernel(dtype, pallas):
    """Row 13 held against the real Pallas ``flash_decode_kernel``
    (until now only against the dense ``cached_attention``)."""
    jdt, tdt, tol = DTYPES[dtype]
    S, L, H, D = 5, 96, 2, 32
    _, q, k, v = _decode_inputs(S, L, H, D, 13)
    pos = np.array([0, 31, 32, 65, L - 1], np.int32)
    got = jax_flash_decode(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                           jnp.asarray(v, jdt), jnp.asarray(pos), dtype=jdt,
                           block_k=32, interpret=True)
    mine = flash_decode_attention_plain(_to(q, tdt), _to(k, tdt),
                                        _to(v, tdt), torch.from_numpy(pos))
    np.testing.assert_allclose(mine.float().numpy(),
                               np.asarray(jnp.asarray(got, jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_plain_matches_pallas_decode_kernel(dtype, pallas):
    """The CUDA kernels' split-and-merge arithmetic
    (``flash_decode_split_plain``: 64- and 128-row splits, each of 16-row
    groups with their own running max, merged by e^(m_j - M)) held
    against the Pallas ``flash_decode_kernel`` in interpret mode (128-row
    blocks, one running max a slot) and against the one-pass plain
    version, positions on each side of the split edges and at both
    ends."""
    jdt, tdt, tol = DTYPES[dtype]
    S, L, H, D = 8, 256, 2, 32
    _, q, k, v = _decode_inputs(S, L, H, D, 17)
    pos = np.array([0, 63, 64, 65, 127, 128, 191, L - 1], np.int32)
    got = jax_flash_decode(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                           jnp.asarray(v, jdt), jnp.asarray(pos), dtype=jdt,
                           interpret=True)
    want_jax = np.asarray(jnp.asarray(got, jnp.float32))
    tq, tk, tv = _to(q, tdt), _to(k, tdt), _to(v, tdt)
    tpos = torch.from_numpy(pos)
    plain = flash_decode_attention_plain(tq, tk, tv, tpos).float().numpy()
    for chunk in (64, 128):
        mine = flash_decode_split_plain(tq, tk, tv, tpos, chunk)
        assert mine.dtype == tdt
        mine = mine.float().numpy()
        np.testing.assert_allclose(mine, want_jax, atol=tol, rtol=tol)
        np.testing.assert_allclose(mine, plain, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_over_identity_table_equals_flat(dtype):
    """Over the identity table of the slot cache the paged path is the
    flat one bit for bit (ops/selfcheck.py holds the JAX package so),
    through the wrapper and through ``cached_attention``."""
    _, tdt, _ = DTYPES[dtype]
    S, L, H, D, ps = 4, 64, 2, 16, 8
    _, q, k, v = _decode_inputs(S, L, H, D, 3)
    q, k, v = _to(q, tdt), _to(k, tdt), _to(v, tdt)
    pos = torch.tensor([0, 7, 8, 63], dtype=torch.int32)
    table = torch.from_numpy(identity_page_table(S, L, ps))
    flat = flash_decode_attention_plain(q, k, v, pos)
    view = (S * L // ps, ps, H, D)
    paged = flash_decode_paged_attention(q, k.view(view), v.view(view), pos,
                                         table)
    assert torch.equal(paged, flat)
    a = cached_attention(q, k, v, pos, dtype=tdt, impl="paged",
                         page_table=table)
    b = cached_attention(q, k, v, pos, dtype=tdt, impl="flash_decode")
    assert torch.equal(a, b)
    # without a table, "paged" is the slot-contiguous kernel
    assert torch.equal(cached_attention(q, k, v, pos, dtype=tdt,
                                        impl="paged"), b)


def test_paged_wrapper_validates_and_clamps():
    S, L, H, D = 2, 32, 2, 16
    q = torch.zeros(S, 1, H, D)
    k = torch.zeros(S, L, H, D)
    pos = torch.zeros(S, dtype=torch.int32)
    with pytest.raises(ValueError, match="cannot tile L=32"):
        cached_attention(q, k, k, pos, impl="paged",
                         page_table=torch.zeros(S, 5, dtype=torch.int32))
    pages = k.view(S * 4, 8, H, D)
    with pytest.raises(ValueError, match="page table must be"):
        flash_decode_paged_attention(q, pages, pages, pos,
                                     torch.zeros(S + 1, 4,
                                                 dtype=torch.int32))
    with pytest.raises(ValueError, match="page views"):
        flash_decode_paged_attention(q, pages, pages[:, :, :1], pos,
                                     torch.zeros(S, 4, dtype=torch.int32))
    with pytest.raises(TypeError, match="contiguous int32"):
        flash_decode_paged_attention(q, pages, pages, pos.long(),
                                     torch.zeros(S, 4, dtype=torch.int32))
    with pytest.raises(TypeError, match="contiguous int32"):
        flash_decode_paged_attention(
            q, pages, pages, pos,
            torch.zeros(4, S, dtype=torch.int32).t())
    with pytest.raises(ValueError, match="head_dim 24"):
        qq = torch.zeros(S, 1, H, 24)
        pp = torch.zeros(8, 8, H, 24)
        flash_decode_paged_attention(qq, pp, pp, pos,
                                     torch.zeros(S, 4, dtype=torch.int32))
    # a page id outside the view is clamped into it, as the kernel does
    _, qn, kn, vn = _decode_inputs(S, L, H, D, 5)
    kp, vp = _to(kn, torch.float32), _to(vn, torch.float32)
    kp, vp = kp.view(S * 4, 8, H, D), vp.view(S * 4, 8, H, D)
    bad = torch.tensor([[-3, 1, 2, 99], [0, 1, 2, 7]], dtype=torch.int32)
    good = bad.clamp(0, S * 4 - 1)
    qt = _to(qn, torch.float32)
    p31 = torch.tensor([31, 31], dtype=torch.int32)
    assert torch.equal(
        flash_decode_paged_attention_plain(qt, kp, vp, p31, bad),
        flash_decode_paged_attention_plain(qt, kp, vp, p31, good))
    assert resolve_decode_impl("paged", "cpu") == "paged"


# -- host accounting parity ---------------------------------------------------

def _kv_state(p):
    return (p.stats(), p.pool.free, p.pool.allocated, p.donor_count,
            p.index.registered())


def test_paged_kv_accounting_matches_jax():
    """The same random admit/advance/retain/evict/pin/drop sequence into
    the JAX ``PagedKV`` and the port's copy, each bound to its package's
    fleet ``PrefixDirectory`` (``bind_federation``): equal ``stats()``,
    page counts, donors, ``match()`` results and directory lookups after
    every operation; then imported donors (``mark_remote``) count
    alike."""
    from ray_lightning_tpu.serve.fleet.federation import (
        PrefixDirectory as JaxDirectory)
    from ray_lightning_tpu_torch.serve.fleet import PrefixDirectory
    rng = np.random.default_rng(0)
    S, L, ps = 5, 48, 4
    jax_kv = JaxPagedKV(JaxPageConfig(True, ps), S, L)
    mine = PagedKV(PageConfig(True, ps), S, L)
    jax_dir, my_dir = JaxDirectory(ps), PrefixDirectory(ps)
    jax_kv.bind_federation(3, jax_dir)
    mine.bind_federation(3, my_dir)
    prefixes = [rng.integers(0, 50, 20) for _ in range(3)]
    live: dict = {}
    donors: set = set()

    def prompt():
        base = prefixes[rng.integers(len(prefixes))]
        cut = int(rng.integers(1, len(base) + 1))
        return np.concatenate([base[:cut],
                               rng.integers(0, 50, rng.integers(0, 9))])

    for step in range(400):
        op = rng.choice(["admit", "advance", "finish", "evict", "match",
                         "pin", "drop"], p=[.3, .25, .15, .1, .15, .04,
                                            .01])
        if op == "admit":
            free = [s for s in range(S) if s not in live]
            if not free:
                continue
            slot = int(rng.choice(free))
            toks = prompt()
            hits = [kv.match(toks) for kv in (jax_kv, mine)]
            assert hits[0] == hits[1], (step, hits)
            hit = hits[0]
            computed, src = len(toks), None
            if hit is not None and hit[0] != slot and hit[1] >= ps:
                src, computed = hit[0], max(1, len(toks) - hit[1])
            for kv in (jax_kv, mine):
                kv.on_admit(slot, toks, computed, src=src)
            donors.discard(slot)
            live[slot] = len(toks)
        elif op == "advance" and live:
            slot = int(rng.choice(sorted(live)))
            live[slot] = min(live[slot] + int(rng.integers(1, 6)), L - 1)
            for kv in (jax_kv, mine):
                kv.on_advance(slot, live[slot])
        elif op == "finish" and live:
            slot = int(rng.choice(sorted(live)))
            kept = {jax_kv.retain(slot), mine.retain(slot)}
            assert len(kept) == 1
            del live[slot]
            if kept.pop():
                donors.add(slot)
        elif op == "evict":
            ex = int(rng.integers(S)) if rng.random() < .5 else None
            out = {jax_kv.evict_lru_donor(exclude=ex),
                   mine.evict_lru_donor(exclude=ex)}
            assert len(out) == 1
            donors.discard(out.pop())
        elif op == "match":
            toks = prompt()
            assert jax_kv.match(toks) == mine.match(toks)
            assert jax_dir.lookup(toks) == my_dir.lookup(toks)
        elif op == "pin" and donors:
            slot = int(rng.choice(sorted(donors)))
            fn = "pin" if rng.random() < .6 else "unpin"
            getattr(jax_kv, fn)(slot)
            getattr(mine, fn)(slot)
        elif op == "drop":
            jax_kv.drop_all()
            mine.drop_all()
            live.clear()
            donors.clear()
        assert _kv_state(jax_kv) == _kv_state(mine), (step, op)
        mine.pool.check()
        assert jax_dir.stats() == my_dir.stats(), (step, op)
    st = mine.stats()
    assert st["prefix_hits"] > 10 and st["reused_prefills"] > 5, st
    assert my_dir.stats()["hits"] > 2 and my_dir.stats()["invalidations"] > 2
    # an imported donor: registered, retained, marked remote; a reuse
    # from it counts as federated
    jax_kv = JaxPagedKV(JaxPageConfig(True, ps), S, L)
    mine = PagedKV(PageConfig(True, ps), S, L)
    jax_dir, my_dir = JaxDirectory(ps), PrefixDirectory(ps)
    jax_kv.bind_federation(3, jax_dir)
    mine.bind_federation(3, my_dir)
    toks = np.concatenate([prefixes[0], [7]])
    for kv in (jax_kv, mine):
        kv.on_admit(0, toks, len(toks))
        assert kv.retain(0)
        kv.mark_remote(0)
        kv.on_admit(1, toks, 1, src=0)
    assert _kv_state(jax_kv) == _kv_state(mine)
    assert jax_dir.stats() == my_dir.stats()
    assert mine.stats()["remote_imports"] == 1
    assert mine.stats()["federated_tokens_reused"] == len(toks) - 1


def _plan_view(plan):
    """A plan with trace ids (random per scheduler) dropped and arrays as
    lists, for equality."""
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


def _fake_result(plan, step):
    result = {"prefill": {p["slot"]: (7 * p["slot"] + step) % 50
                          for p in plan["prefills"]}, "decode": {}}
    if plan["decode"] is not None:
        result["decode"] = {s: (3 * s + step) % 50
                            for s in plan["decode"]["slots"]}
    return result


def test_paged_scheduler_plans_match_jax():
    """The JAX ``Scheduler(paged=...)`` and the port's over the same
    prompts with shared prefixes and the same fabricated results: equal
    plans at every step — reuse ``src``/``matched``, the dummy-write
    fill at ``max_seq_len - 1``, donor eviction under slot pressure —
    and equal page stats."""
    rng = np.random.default_rng(1)
    kw = dict(buckets=(8, 16, 32), slots=3, max_seq_len=32,
              max_prefills_per_step=2, default_max_new_tokens=3)
    jax_s = JaxScheduler(paged=JaxPageConfig(True, 4), **kw)
    mine = Scheduler(paged=PageConfig(True, 4), **kw)
    shared = [rng.integers(1, 50, 12), rng.integers(1, 50, 9)]
    fills = evictions = reuses = 0
    step = 0
    for wave in range(4):
        for i in range(4):
            p = np.concatenate([shared[(wave + i) % 2],
                                rng.integers(1, 50, int(rng.integers(0, 6)))])
            tenant = ("alice", "bob")[i % 2]
            jax_s.submit(p, tenant=tenant)
            mine.submit(p, tenant=tenant)
        for _ in range(60):
            donors = mine.pages.donor_count
            a, b = jax_s.plan(), mine.plan()
            assert _plan_view(a) == _plan_view(b), step
            if b is None:
                break
            reuses += sum("reuse" in p for p in b["prefills"])
            if b["decode"] is not None:
                idle = set(range(3)) - set(b["decode"]["slots"])
                fills += sum(b["decode"]["positions"][s] == 31
                             for s in idle)
            result = _fake_result(b, step)
            jax_s.apply(a, result)
            mine.apply(b, result)
            evictions += mine.pages.donor_count < donors and bool(
                b["prefills"])
            assert jax_s.pages.stats() == mine.pages.stats(), step
            step += 1
        assert jax_s.idle() and mine.idle()
    assert reuses >= 4 and fills >= 1 and evictions >= 1, \
        (reuses, fills, evictions)
    assert jax_s.stats()["pages"] == mine.stats()["pages"]
    mine.fail_all(RuntimeError("x"))
    assert mine.pages.stats()["donors"] == 0


# -- engine parity on tiny with converted weights -----------------------------

TINY = dict(vocab_size=128, block_size=32, n_layer=2, n_head=2, n_embd=32,
            remat=False)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def jax_paged_engine(request):
    """The JAX engine with paging (page size 8) and its dense decode: the
    reference for the port's paged engine, built once per dtype."""
    jdt, _, _ = DTYPES[request.param]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RLT_BF16_PARAMS",
                  "1" if request.param == "bfloat16" else "0")
        mp.setenv("RLT_DECODE_IMPL", "dense")
        module = JaxModule(JaxConfig(**TINY, dtype=jdt))
        eng = JaxEngine(module, DataParallelStrategy(), buckets=(16, 32),
                        slots=4, max_seq_len=32, seed=0,
                        paged=JaxPageConfig(True, 8)).setup()
    return request.param, eng


def _torch_paged_engine(dtype, params, monkeypatch):
    _, tdt, _ = DTYPES[dtype]
    monkeypatch.setenv("RLT_BF16_PARAMS",
                       "1" if dtype == "bfloat16" else "0")
    monkeypatch.setenv("RLT_DECODE_IMPL", "paged")
    eng = ServeEngine(GPTLightningModule(GPTConfig(**TINY, dtype=tdt)),
                      buckets=(16, 32), slots=4, max_seq_len=32,
                      weights=flax_to_torch(params), device="cpu",
                      paged=PageConfig(True, 8)).setup()
    assert eng.decode_kernel == "paged"
    assert eng.page_table.shape == (4, 4)
    return eng


def _serve(sched, worker, prompts_or_reqs):
    reqs = [sched.submit(p, tenant=("alice", "bob")[i % 2])
            if isinstance(p, np.ndarray) else p
            for i, p in enumerate(prompts_or_reqs)]
    reused = 0
    for _ in range(300):
        plan = sched.plan()
        if plan is None:
            break
        reused += sum(1 for p in plan["prefills"] if "reuse" in p)
        sched.apply(plan, worker.serve_step(plan))
    assert all(r.done() for r in reqs)
    return reqs, reused


def _jax_worker(eng):
    w = JaxWorker()
    w._engine = eng
    w._rank = 0
    return w


def _check_tokens(dtype, jax_eng, prompts, mine, theirs):
    """fp32: equal tokens.  bf16: the teacher-forced near-tie rule (2e-2)
    against the JAX whole-sequence forward, for both engines."""
    if dtype == "float32":
        assert mine == theirs
        return
    model = jax_eng.module.configure_decode_model()
    params = jax.device_get(jax_eng.params)
    for prompt, toks in zip(prompts, mine):
        seq = list(prompt) + toks[:-1]
        logits = np.asarray(jnp.asarray(model.apply(
            {"params": params}, np.asarray([seq], np.int32), True),
            jnp.float32))[0, len(prompt) - 1:]
        for i, tok in enumerate(toks):
            best = int(np.argmax(logits[i]))
            assert tok == best or logits[i, tok] >= logits[i, best] - 2e-2


def test_prefix_reuse_token_parity_vs_cold_prefill(jax_paged_engine,
                                                   monkeypatch):
    """tests/test_fleet.py's prefix-reuse case on both packages: prompts
    sharing a 2-page system prefix, admitted through prefix-cache hits
    (page copy + suffix-only compute) amid concurrent decodes, donor
    retention and idle-slot dummy writes, generate what the JAX engine
    generates; the page accounting is the same."""
    dtype, jax_eng = jax_paged_engine
    eng = _torch_paged_engine(dtype, jax.device_get(jax_eng.params),
                              monkeypatch)
    shared = np.arange(1, 17)
    prompts = [np.concatenate([shared, np.array([30 + i, 40 + i])])
               for i in range(5)]
    prompts.append(np.arange(100, 107))
    kw = dict(buckets=(16, 32), slots=4, max_seq_len=32,
              max_prefills_per_step=1, default_max_new_tokens=5)
    jax_sched = JaxScheduler(paged=JaxPageConfig(True, 8), **kw)
    sched = Scheduler(paged=PageConfig(True, 8), **kw)
    theirs, _ = _serve(jax_sched, _jax_worker(jax_eng), prompts)
    calls0 = dict(eng.calls)
    mine, reused = _serve(sched, ServeWorker(eng), prompts)
    assert reused >= 3, "prefix cache never hit"
    st = sched.pages.stats()
    assert st == jax_sched.pages.stats()
    assert st["reused_prefills"] == reused
    assert st["prefill_tokens_computed"] < st["prefill_tokens_requested"]
    sched.pages.pool.check()
    assert eng.calls["kv_copy"] - calls0["kv_copy"] == reused
    assert eng.calls["suffix"] > calls0["suffix"]
    _check_tokens(dtype, jax_eng, prompts,
                  [r.result(1).tolist() for r in mine],
                  [r.result(1).tolist() for r in theirs])


def test_retained_donor_survives_dummy_write_traffic(jax_paged_engine,
                                                     monkeypatch):
    """tests/test_fleet.py's cross-wave case: a donor retained after its
    request finished still donates correct pages after a wave of
    unrelated traffic whose idle-slot dummy writes aim at the last row."""
    dtype, jax_eng = jax_paged_engine
    eng = _torch_paged_engine(dtype, jax.device_get(jax_eng.params),
                              monkeypatch)
    shared = np.arange(3, 19)
    kw = dict(buckets=(32,), slots=4, max_seq_len=32,
              max_prefills_per_step=1, default_max_new_tokens=4)
    outs = []
    for make_sched, worker, page_cfg in (
            (JaxScheduler, _jax_worker(jax_eng), JaxPageConfig(True, 8)),
            (Scheduler, ServeWorker(eng), PageConfig(True, 8))):
        sched = make_sched(paged=page_cfg, **kw)
        r1, _ = _serve(sched, worker, [np.concatenate([shared, [77]])])
        assert sched.pages.donor_count == 1
        other, _ = _serve(sched, worker,
                          [np.arange(50, 60) + i for i in range(3)])
        hits0 = sched.pages.stats()["prefix_hits"]
        r2, reused = _serve(sched, worker,
                            [np.concatenate([shared, [88, 89]])])
        assert sched.pages.stats()["prefix_hits"] > hits0 and reused == 1
        reqs = r1 + other + r2
        outs.append(([r.tokens for r in reqs],
                     [r.result(1).tolist() for r in reqs]))
    (prompts, theirs), (_, mine) = outs
    _check_tokens(dtype, jax_eng, prompts, mine, theirs)


def test_paged_engine_degrades_and_rejects(monkeypatch):
    """``paged`` needs a page size that tiles ``max_seq_len``: otherwise
    (or with paging off) the engine takes the slot-contiguous kernel,
    as the JAX engine does.  The reuse entry point needs ``paged=``."""
    monkeypatch.setenv("RLT_DECODE_IMPL", "paged")
    mod = GPTLightningModule(GPTConfig(**TINY, dtype=torch.float32))
    ragged = ServeEngine(mod, (16, 32), 2, 32, device="cpu",
                         paged=PageConfig(True, 5)).setup()
    assert ragged.decode_kernel == "flash_decode"
    assert ragged.page_table is None and ragged._suffix is not None
    off = ServeEngine(mod, (16, 32), 2, 32, device="cpu").setup()
    assert off.decode_kernel == "flash_decode"
    with pytest.raises(RuntimeError, match="without paged"):
        off.prefill_reused(1, 0, np.arange(1, 17), 16, 8)
    with pytest.raises(ValueError, match="bad reuse"):
        ragged.prefill_reused(1, 1, np.arange(1, 17), 16, 8)
