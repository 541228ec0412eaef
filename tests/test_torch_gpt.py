"""PyTorch/CUDA port, model and steps: ``ray_lightning_tpu_torch``
``GPT`` / ``build_prefill_step`` / ``build_decode_step`` against the
JAX package on weights converted with ``convert.flax_to_torch``.

Two configs: the serve tests' TINY model, and one full-width gpt2-small
block (n_layer=1, n_embd 768, 12 heads, vocab 50304) at T=64.  fp32
(config dtype float32, fp32 params) within 2e-5; bf16 (bf16 compute,
bf16-resident params, as the JAX engine serves them) within 2e-2.  The
JAX side is the plain ``apply``, the whole-sequence reference of the JAX
package's own serve tests: on this CPU its jitted forward rounds bf16
differently (beyond 2e-2 on many logits of the same input), while the
port matches the plain ``apply`` bit for bit on TINY.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.steps import build_decode_step as jax_decode_step
from ray_lightning_tpu.core.steps import (
    build_prefill_step as jax_prefill_step)
from ray_lightning_tpu.core.steps import kv_layer_pairs
from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
from ray_lightning_tpu.models.gpt import (
    GPTLightningModule as JaxModule)
from ray_lightning_tpu_torch.convert import flax_to_torch
from ray_lightning_tpu_torch.core.steps import (build_decode_step,
                                                build_prefill_step)
from ray_lightning_tpu_torch.models.gpt import (CONFIGS, GPT, GPTConfig,
                                                GPTLightningModule)

TINY = dict(vocab_size=128, block_size=32, n_layer=2, n_head=2, n_embd=32,
            remat=False)
SMALL_BLOCK = dict(vocab_size=50304, block_size=64, n_layer=1, n_head=12,
                   n_embd=768, remat=False)
MODELS = {"tiny": (TINY, 16), "gpt2-small-block": (SMALL_BLOCK, 64)}
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and torch's default of a thread per core would crowd the
    other workers' time-bounded distributed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(name, dtype, seed=0):
    """The same weights in both packages: a JAX init, cast to the
    compute dtype when it is bf16 (the serve engines' bf16-resident
    params), converted for the port.  Cached per (name, dtype): no test
    mutates the models or the params."""
    fields, T = MODELS[name]
    jdt, tdt, tol = DTYPES[dtype]
    jcfg = JaxConfig(**fields, dtype=jdt)
    jmodel = JaxGPT(jcfg)

    @jax.jit
    def init(rng):
        params = jmodel.init(rng, jnp.zeros((1, T), jnp.int32))["params"]
        return jax.tree_util.tree_map(lambda a: a.astype(jdt), params)

    params = jax.device_get(init(jax.random.PRNGKey(seed)))
    model = GPT(GPTConfig(**fields, dtype=tdt), device="cpu")
    model.load_state_dict(flax_to_torch(params))
    model.to(dtype=tdt).eval().requires_grad_(False)
    return jmodel, params, model, T, tol


def _jax(fn, dtype):
    """The JAX side of a comparison: in fp32 under ``jax.jit`` (it agrees
    with the plain call to ~1e-7 and compiles once instead of op by op);
    in bf16 the plain call, whose per-op rounding the port reproduces
    (the jitted program rounds differently, ROADMAP queue 3 F1)."""
    return jax.jit(fn) if dtype == "float32" else fn


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


def test_configs_match_the_jax_package():
    from ray_lightning_tpu.models.gpt import CONFIGS as JAX_CONFIGS
    assert set(CONFIGS) == set(JAX_CONFIGS)
    for name, cfg in CONFIGS.items():
        jcfg = JAX_CONFIGS[name]
        for f in dataclasses.fields(cfg):
            if f.name != "dtype":
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), \
                    (name, f.name)


def test_flax_to_torch_maps_every_param_by_path():
    _, params, model, _, _ = _models("tiny", "bfloat16")
    state = flax_to_torch({"params": params})
    assert set(state) == set(model.state_dict())
    assert all(t.dtype == torch.bfloat16 for t in state.values())
    np.testing.assert_array_equal(
        _np(state["h.1.attn.qkv.weight"]),
        _np(params["h1"]["attn"]["qkv"]["kernel"]).T)
    np.testing.assert_array_equal(_np(state["ln_f.weight"]),
                                  _np(params["ln_f"]["scale"]))
    with pytest.raises(KeyError, match="no mapping"):
        flax_to_torch({"h0": {"attn": {"qkv": {"weird": np.zeros(2)}}}})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["tiny", "gpt2-small-block"])
def test_forward_logits_match_jax(name, dtype):
    jmodel, params, model, T, tol = _models(name, dtype)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jmodel.config.vocab_size, (2, T)).astype(
        np.int32)
    want = _np(_jax(lambda p, t: jmodel.apply({"params": p}, t, True),
                    dtype)(params, toks))
    with torch.inference_mode():
        got = model(torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == want.shape
    if (name, dtype) != ("gpt2-small-block", "bfloat16"):
        np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)
        return
    # At full width the bf16 logits sit at the rounding floor: the JAX
    # package's own two attention routes (dot and the Pallas flash
    # kernel) disagree beyond 2e-2 on some logits of this very input.
    # The port is held to that spread: no larger a worst error and no
    # more logits past the 2e-2 bar than the reference's own routes.
    flash = JaxGPT(dataclasses.replace(jmodel.config,
                                       attention_impl="flash"))
    spread = np.abs(_np(flash.apply({"params": params}, toks, True)) - want)
    diff = np.abs(got.numpy() - want)
    bar = tol + tol * np.abs(want)
    assert spread.max() > tol          # the floor this branch is for
    assert diff.max() <= spread.max(), (diff.max(), spread.max())
    assert (diff > bar).sum() <= (spread > bar).sum()


def _jax_caches(jmodel, params, toks, n_slots, L, dtype):
    """Slot caches holding each prompt row's K/V at slot s, from the JAX
    prefill capture (the numerics of the prefill step)."""
    jdt = DTYPES[dtype][0]
    _, cap = _jax(lambda p, t: jmodel.apply({"params": p}, t, True,
                                            mutable=["kv_cache"]),
                  dtype)(params, toks)
    pairs = kv_layer_pairs(cap["kv_cache"])
    nl = len(pairs)
    _, T, H, D = pairs[0][0].shape
    k = np.zeros((nl, n_slots, L, H, D), np.float32)
    v = np.zeros_like(k)
    for i, (ck, cv) in enumerate(pairs):
        k[i, :, :T] = _np(ck)
        v[i, :, :T] = _np(cv)
    return jnp.asarray(k, jdt), jnp.asarray(v, jdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["tiny", "gpt2-small-block"])
def test_decode_logits_and_cache_writes_match_jax(name, dtype, monkeypatch):
    """One decode step over 3 slots at different positions (the first
    row, mid-context, the last row) from the same prefilled caches:
    logits and the written K/V rows agree."""
    monkeypatch.delenv("RLT_DECODE_IMPL", raising=False)
    jmodel, params, model, T, tol = _models(name, dtype)
    tdt = DTYPES[dtype][1]
    S, L = 3, jmodel.config.block_size
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, jmodel.config.vocab_size, (S, T // 2)).astype(
        np.int32)
    jk, jv = _jax_caches(jmodel, params, prompt, S, L, dtype)
    tokens = rng.integers(0, jmodel.config.vocab_size, S).astype(np.int32)
    positions = np.array([0, T // 2, L - 1], np.int32)
    want, wk, wv = _jax(lambda p, *a: jmodel.apply(
        {"params": p}, *a, method="decode"), dtype)(
            params, tokens, positions, jk, jv)
    tk = torch.tensor(_np(jk)).to(tdt)
    tv = torch.tensor(_np(jv)).to(tdt)
    with torch.inference_mode():
        got = model.decode(torch.from_numpy(tokens),
                           torch.from_numpy(positions), tk, tv)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=tol, rtol=tol)
    slots = np.arange(S)
    for mine, theirs in ((tk, wk), (tv, wv)):
        np.testing.assert_allclose(
            mine.float().numpy()[:, slots, positions],
            _np(theirs)[:, slots, positions], atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_steps_match_jax(dtype, monkeypatch):
    """core/steps.py: the prefill step writes every layer's K/V block at
    the slot and returns the greedy token at ``length - 1``; the decode
    step advances every slot.  Same first tokens, caches and next tokens
    as the JAX programs."""
    monkeypatch.delenv("RLT_DECODE_IMPL", raising=False)
    monkeypatch.setenv("RLT_BF16_PARAMS", "0" if dtype == "float32" else "1")
    _, params, model, _, tol = _models("tiny", dtype)
    jdt, tdt, _ = DTYPES[dtype]
    bucket, S, L = 8, 4, TINY["block_size"]
    jmod = JaxModule(JaxConfig(**TINY, dtype=jdt))
    shape = (TINY["n_layer"], S, L, TINY["n_head"],
             TINY["n_embd"] // TINY["n_head"])
    jk = jv = jnp.zeros(shape, jdt)
    tk, tv = torch.zeros(shape, dtype=tdt), torch.zeros(shape, dtype=tdt)
    jpre = _jax(jax_prefill_step(jmod, bucket), dtype)
    pre = build_prefill_step(model, bucket)
    prompts = {1: [5, 9, 2, 7, 11], 3: [4, 8, 15, 16, 23, 42, 1]}
    firsts = {}
    with torch.inference_mode():
        for slot, p in prompts.items():
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :len(p)] = p
            jk, jv, jfirst = jpre(params, jk, jv, padded, np.int32(slot),
                                  np.int32(len(p)))
            first = pre(tk, tv, torch.from_numpy(padded).long(),
                        torch.tensor([slot]), torch.tensor([len(p)]))
            assert int(first) == int(jfirst), slot
            firsts[slot] = int(first)
        np.testing.assert_allclose(tk.float().numpy(), _np(jk), atol=tol,
                                   rtol=0)
        toks = np.zeros(S, np.int32)
        pos = np.zeros(S, np.int32)
        for slot, p in prompts.items():
            toks[slot], pos[slot] = firsts[slot], len(p)
        jk, jv, jnext = _jax(jax_decode_step(jmod), dtype)(params, jk, jv,
                                                          toks, pos)
        nxt = build_decode_step(model)(tk, tv, torch.from_numpy(toks),
                                       torch.from_numpy(pos))
    for slot in prompts:
        assert int(nxt[slot]) == int(jnext[slot]), slot
    np.testing.assert_allclose(tv.float().numpy(), _np(jv), atol=tol,
                               rtol=0)


def test_decode_model_rejects_moe_and_honours_bf16_params(monkeypatch):
    with pytest.raises(ValueError, match="MoE"):
        GPTLightningModule("moe-tiny").configure_decode_model("cpu")
    monkeypatch.setenv("RLT_BF16_PARAMS", "0")
    assert GPTLightningModule("tiny").param_dtype is None
    monkeypatch.setenv("RLT_BF16_PARAMS", "1")
    assert GPTLightningModule("tiny").param_dtype == torch.bfloat16
    dec = GPTLightningModule("tiny").configure_decode_model("cpu")
    assert dec.config.dropout == 0.0 and dec.config.remat is False


def test_seeded_init_is_reproducible_from_the_generator():
    cfg = GPTConfig(**TINY)
    a, b = GPT(cfg, device="cpu"), GPT(cfg, device="cpu")
    a.init_weights(torch.Generator().manual_seed(3))
    b.init_weights(torch.Generator().manual_seed(3))
    for (name, x), (_, y) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        torch.testing.assert_close(x, y, atol=0, rtol=0, msg=name)
    w = a.h[0].attn.qkv.weight.detach()
    assert 0.5 / np.sqrt(32) < float(w.std()) < 2.0 / np.sqrt(32)
