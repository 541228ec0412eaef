"""PyTorch/CUDA port, speculative decoding: the port's ``GPT.verify``
against the JAX package's, the draft/verify fold of the copied
``Scheduler`` against the JAX one, and the port's ``ServeEngine(spec=
...)`` against its plain decode.

Tolerances: verify logits and caches in fp32 within 2e-5 (``atol =
rtol``, tests/test_ops.py); speculative tokens equal to plain greedy
decode in fp32, whatever the draft.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
from ray_lightning_tpu.models.gpt import GPTLightningModule as JaxModule
from ray_lightning_tpu.serve.scheduler import Scheduler as JaxScheduler
from ray_lightning_tpu.serve.spec import SpecConfig as JaxSpecConfig
from ray_lightning_tpu_torch import (GPT, GPTLightningModule,
                                     LightningModule, Scheduler,
                                     ServeEngine, ServeWorker,
                                     flax_to_torch)
from ray_lightning_tpu_torch.models.gpt import GPTConfig
from ray_lightning_tpu_torch.ops.attention import CacheWrite
from ray_lightning_tpu_torch.serve import PageConfig, SpecConfig

TINY = dict(vocab_size=128, block_size=32, n_layer=2, n_head=2, n_embd=32,
            remat=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the fold (host only) -----------------------------------------------------

def _spec_round(sched, slot, draft, verify):
    """One fabricated speculative round: k draft tokens + k+1 verify
    tokens for ``slot``, applied through the real fold."""
    plan = sched.plan()
    assert plan["decode"]["spec"] is True, plan["decode"]
    sched.apply(plan, {"prefill": {}, "decode": {
        slot: {"draft": list(draft), "verify": list(verify)}}})


def test_spec_scheduler_ragged_fold_and_fallback():
    """tests/test_serve.py's fold invariants on the port's scheduler: the
    identity ``emitted == accepted + corrected`` across accept-k,
    accept-0 and mid-prefix rounds, ``max_new`` truncation mid-round,
    and the rolling acceptance floor falling back to plain decode."""
    spec = SpecConfig(enabled=True, k=3, window=4, min_accept=0.5)
    sched = Scheduler(buckets=(8, 16), slots=2, max_seq_len=32,
                      default_max_new_tokens=7, spec=spec)
    req = sched.submit(np.arange(1, 5))
    plan = sched.plan()
    assert plan["prefills"] and plan["prefills"][0]["draft"], plan
    slot = plan["prefills"][0]["slot"]
    sched.apply(plan, {"prefill": {slot: 7}, "decode": {}})
    _spec_round(sched, slot, [10, 11, 12], [10, 11, 12, 13])  # accept-k
    _spec_round(sched, slot, [20, 21, 22], [30, 31, 32, 33])  # accept-0
    _spec_round(sched, slot, [40, 41, 42], [40, 50, 51, 52])  # mid-prefix
    assert req.done() and list(req.generated) == \
        [7, 10, 11, 12, 13, 30, 40], list(req.generated)
    s = sched.stats()["spec"]
    assert s["emitted"] == s["accepted"] + s["corrected"] == 6, s
    assert (s["accepted"], s["corrected"], s["drafted"]) == (4, 2, 9), s
    assert s["slot_steps"] == 3 and s["tokens_per_target_forward"] == 2.0

    req2 = sched.submit(np.arange(1, 5))
    plan = sched.plan()
    slot = plan["prefills"][0]["slot"]
    sched.apply(plan, {"prefill": {slot: 7}, "decode": {}})
    for i in range(2):
        assert not req2.spec_off, i
        _spec_round(sched, slot, [60 + i, 61, 62], [70 + i, 71, 72, 73])
    assert req2.spec_off, "acceptance floor did not trip"
    assert sched.stats()["spec"]["fallbacks"] == 1
    plan = sched.plan()
    assert plan["decode"].get("spec") is not True, plan["decode"]


def test_spec_scheduler_plans_match_jax():
    """The same prompts and fabricated draft/verify results through the
    JAX scheduler and the port's, with paging on: equal plans and equal
    spec and page stats at every step."""
    rng = np.random.default_rng(2)
    kw = dict(buckets=(8, 16, 32), slots=3, max_seq_len=32,
              default_max_new_tokens=9, max_prefills_per_step=2)
    spec = dict(enabled=True, k=3, window=4, min_accept=0.3)
    jax_s = JaxScheduler(spec=JaxSpecConfig(**spec),
                         paged=_jax_pages(4), **kw)
    mine = Scheduler(spec=SpecConfig(**spec), paged=PageConfig(True, 4),
                     **kw)
    prefix = rng.integers(1, 50, 8)
    for i in range(7):
        p = np.concatenate([prefix, rng.integers(1, 50, 1 + i % 4)])
        jax_s.submit(p, tenant=("a", "b")[i % 2])
        mine.submit(p, tenant=("a", "b")[i % 2])
    for step in range(200):
        a, b = jax_s.plan(), mine.plan()
        assert _view(a) == _view(b), step
        if b is None:
            break
        result = {"prefill": {p["slot"]: 5 for p in b["prefills"]},
                  "decode": {}}
        if b["decode"] is not None:
            for s in b["decode"]["slots"]:
                d = rng.integers(0, 4, 3).tolist()
                g = [x if rng.random() < .6 else 9 for x in d] + [7]
                result["decode"][s] = ({"draft": d, "verify": g}
                                       if b["decode"].get("spec") else 3)
        jax_s.apply(a, result)
        mine.apply(b, result)
    assert mine.idle() and jax_s.idle()
    assert jax_s.stats()["spec"] == mine.stats()["spec"]
    assert jax_s.stats()["pages"] == mine.stats()["pages"]
    assert mine.stats()["spec"]["fallbacks"] >= 1


def _jax_pages(ps):
    from ray_lightning_tpu.serve.fleet.pages import PageConfig as JaxPage
    return JaxPage(True, ps)


def _view(plan):
    if plan is None:
        return None
    conv = (lambda v: v.tolist() if isinstance(v, np.ndarray) else v)
    d = plan["decode"]
    return {"prefills": [{k: conv(v) for k, v in p.items() if k != "trace"}
                         for p in plan["prefills"]],
            "decode": None if d is None else
            {k: conv(v) for k, v in d.items() if k != "traces"}}


def test_spec_config_copy_matches_jax(monkeypatch):
    for value in (None, True, 3, {"k": 2, "draft_layers": 1,
                                  "min_accept": 0.25, "window": 8}):
        a, b = JaxSpecConfig.resolve(value), SpecConfig.resolve(value)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.worker_env() == b.worker_env()
    for k, v in SpecConfig.resolve({"k": 5, "window": 6}).worker_env(
            ).items():
        monkeypatch.setenv(k, v)
    assert SpecConfig.resolve(None) == SpecConfig(True, k=5, window=6)
    with pytest.raises(ValueError, match="k must be"):
        SpecConfig(k=0)


# -- GPT.verify against the JAX package ------------------------------------

@pytest.mark.parametrize("impl", ["dense", "paged"])
def test_verify_logits_and_cache_writes_match_jax(impl):
    """``GPT.verify`` on converted weights against the JAX ``GPT.verify``
    in fp32: logits and the written caches within 2e-5.  The cache is
    shorter than the model's context, and the slots' query positions
    run: inside it, up to its last row, two rows past it (those K/V rows
    are dropped, as the JAX scatter drops them) and wholly past it but
    for the first (the idle slot's dummy row at L - 1 under paging)."""
    cfg = JaxConfig(**TINY, dtype=jnp.float32)
    jmodel = JaxModule(cfg).configure_decode_model()
    params = jmodel.init(jax.random.PRNGKey(0),
                         np.zeros((1, 8), np.int32))["params"]
    S, T, L, ps = 4, 4, 24, 8
    H, D = TINY["n_head"], TINY["n_embd"] // TINY["n_head"]
    rng = np.random.default_rng(0)
    starts = np.array([3, L - T, L - 2, L - 1], np.int32)
    positions = starts[:, None] + np.arange(T, dtype=np.int32)[None, :]
    tokens = rng.integers(0, TINY["vocab_size"], (S, T)).astype(np.int32)
    kc = rng.standard_normal((2, S, L, H, D)).astype(np.float32)
    vc = rng.standard_normal((2, S, L, H, D)).astype(np.float32)
    want, jk, jv = jmodel.apply({"params": params}, tokens, positions,
                                jnp.asarray(kc), jnp.asarray(vc),
                                method="verify")
    model = GPT(GPTConfig(**TINY, dtype=torch.float32), device="cpu")
    model.load_state_dict(flax_to_torch(jax.device_get(params)))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    table = (torch.arange(S * L // ps, dtype=torch.int32).view(S, L // ps)
             if impl == "paged" else None)
    with torch.inference_mode():
        got = model.verify(torch.from_numpy(tokens),
                           torch.from_numpy(positions), tk, tv, impl=impl,
                           page_table=table)
    assert got.shape == (S, T, TINY["vocab_size"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=2e-5,
                               rtol=2e-5)
    # rows past the end were dropped, nothing else moved
    untouched = np.ones((S, L), bool)
    for s in range(S):
        untouched[s, positions[s][positions[s] < L]] = False
    np.testing.assert_array_equal(tk.numpy()[:, untouched],
                                  kc[:, untouched])


def test_cache_write_drops_rows_past_the_end():
    """``CacheWrite`` against jax's ``.at[].set`` (which drops an
    out-of-range row), for one-query and multi-query positions."""
    rng = np.random.default_rng(3)
    S, L, H, D = 3, 6, 1, 2
    for pos in (np.array([[1, 2, 3], [4, 5, 6], [6, 7, 8]], np.int32),
                np.array([5, 6, 9], np.int32)):
        cache = rng.standard_normal((S, L, H, D)).astype(np.float32)
        rows = rng.standard_normal(pos.shape + (H, D)).astype(np.float32)
        slots = np.arange(S)[:, None] if pos.ndim == 2 else np.arange(S)
        want = jnp.asarray(cache).at[slots, pos].set(rows)
        got = torch.from_numpy(cache.copy())
        CacheWrite(torch.from_numpy(pos), L, drop_past_end=True)(
            got, torch.from_numpy(rows))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the spec engine against plain decode -------------------------------------

PROMPTS = [np.arange(1, 4 + (i % 5)) for i in range(4)] + [np.arange(5, 20)]


def _serve(eng, spec, paged, max_new):
    sched = Scheduler(buckets=(8, 16), slots=4, max_seq_len=32,
                      default_max_new_tokens=max_new, spec=spec,
                      paged=paged)
    worker = ServeWorker(eng)
    reqs = [sched.submit(p, tenant=("alice", "bob")[i % 2])
            for i, p in enumerate(PROMPTS)]
    for _ in range(300):
        plan = sched.plan()
        if plan is None:
            break
        sched.apply(plan, worker.serve_step(plan))
    assert all(r.done() for r in reqs)
    return [r.result(1).tolist() for r in reqs], sched.stats()


@pytest.fixture(scope="module")
def fp32_weights():
    module = JaxModule(JaxConfig(**TINY, dtype=jnp.float32))
    params = module.configure_decode_model().init(
        jax.random.PRNGKey(1), np.zeros((1, 8), np.int32))["params"]
    return flax_to_torch(jax.device_get(params))


def _engine(monkeypatch, weights, impl, paged=None, spec=None):
    monkeypatch.setenv("RLT_DECODE_IMPL", impl)
    mod = GPTLightningModule(GPTConfig(**TINY, dtype=torch.float32))
    return ServeEngine(mod, (8, 16), 4, 32, weights=weights, device="cpu",
                       paged=paged, spec=spec).setup()


@pytest.mark.parametrize("draft_layers", [0, TINY["n_layer"]],
                         ids=["default-draft", "full-clone"])
def test_spec_engine_tokens_equal_plain_decode(draft_layers, fp32_weights,
                                               monkeypatch):
    """k=3 speculative rounds (draft, verify, fold) emit exactly the
    plain greedy tokens in fp32, on the paged and the slot-contiguous
    decode kernels (their plain versions here).  The full-clone draft
    agrees with the target on every drafted token: acceptance 1.0 with
    ``max_new - 1`` a multiple of k + 1, so no round is cut short."""
    monkeypatch.setenv("RLT_BF16_PARAMS", "0")
    max_new = 9
    plain, _ = _serve(_engine(monkeypatch, fp32_weights, "dense"), None,
                      None, max_new)
    spec = SpecConfig(enabled=True, k=3, draft_layers=draft_layers)
    for impl, paged in (("paged", PageConfig(True, 8)),
                        ("flash_decode", None)):
        eng = _engine(monkeypatch, fp32_weights, impl, paged, spec)
        assert eng.decode_kernel == impl
        out, stats = _serve(eng, spec, paged, max_new)
        assert out == plain, (impl, out, plain)
        sp = stats["spec"]
        assert sp["emitted"] == sp["accepted"] + sp["corrected"]
        assert sp["rounds"] == eng.calls["verify"] == eng.calls["draft"]
        assert eng.calls["decode"] == 0
        assert eng.calls["draft_prefill"] == eng.calls["prefill"] \
            + eng.calls["kv_copy"] == len(PROMPTS)
        es = eng.stats()["spec"]
        assert es["draft_shares_weights"]
        assert es["draft_layers"] == (draft_layers or 1)
        if draft_layers == TINY["n_layer"]:
            assert sp["acceptance_rate"] == 1.0, sp
            assert sp["tokens_per_target_forward"] == 4.0, sp


def test_draft_model_and_engine_refusals(fp32_weights, monkeypatch):
    monkeypatch.setenv("RLT_BF16_PARAMS", "0")
    mod = GPTLightningModule(GPTConfig(**TINY, dtype=torch.float32))
    assert mod.configure_draft(device="cpu").config.n_layer == 1
    assert mod.configure_draft(2, device="meta").wpe.device.type == "meta"
    with pytest.raises(ValueError, match="must be in"):
        mod.configure_draft(3, device="cpu")
    eng = _engine(monkeypatch, fp32_weights, "dense",
                  spec=SpecConfig(True, k=2))
    shared = {p.data_ptr() for p in eng.model.parameters()}
    draft = dict(eng.draft_model.named_parameters())
    assert set(draft) == {n for n in dict(eng.model.named_parameters())
                          if not n.startswith("h.1.")}
    assert all(p.data_ptr() in shared for p in draft.values())
    assert eng.draft_kv_spec.shape == (1, 4, 32, 2, 16)
    # the int8-resident draft (tests/test_torch_kvship.py holds it
    # against the JAX one): its own (payload, scale) pairs, half the bytes
    q8 = ServeEngine(mod, (8,), 2, 32, device="cpu",
                     spec=SpecConfig(True, draft_quant="int8")).setup()
    sp = q8.stats()["spec"]
    assert sp["draft_quant"] == "int8" and set(q8._draft_q) == set(draft)
    assert 0 < sp["draft_resident_bytes"] < sp["draft_fp_bytes"]

    class NoDraft(LightningModule):
        def configure_decode_model(self, device=None):
            return mod.configure_decode_model(device)

    with pytest.raises(ValueError, match="configure_draft"):
        ServeEngine(NoDraft(), (8,), 2, 32, device="cpu",
                    spec=SpecConfig(True)).setup()
