"""PyTorch/CUDA port, training path: ``ray_lightning_tpu_torch`` against
the JAX package on the same numpy-seeded inputs and converted weights.

- (a) attention backward: the port's plain backward (the kernel's
  function on a CPU tensor) and ``flash_attention`` under
  autograd against ``jax.vjp`` of the Pallas ``flash_attention`` under
  the interpreter, which takes ``_bwd_packed_kernel`` at T=128 (one
  block) and T=512 (the 256-row staircase);
- (b) the fused and chunked LM cross-entropies, values and gradients;
- (c) one AdamW + fp32-master update against optax's, from a state
  converted with ``flax_opt_state_to_torch``;
- (d) ``build_train_step`` over 4 steps (warmup 2), with and without
  gradient accumulation;
- (e) ``Trainer.fit``: per-step losses and ``callback_metrics``.

Tolerances: fp32 2e-5 and bf16 2e-2 as ``atol = rtol`` (the JAX
package's own, tests/test_ops.py), except where a test states another.
The model is ``tiny``-sized and attention is ``dot`` on both sides for
(d) and (e), so the file runs in under a minute on one core.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
from ray_lightning_tpu.core.steps import build_init_fn as jax_init_fn
from ray_lightning_tpu.core.steps import build_train_step as jax_train_step
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
from ray_lightning_tpu.models.gpt import GPTLightningModule as JaxModule
from ray_lightning_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention)
from ray_lightning_tpu.ops.losses import (
    chunked_softmax_cross_entropy as jax_chunked_ce)
from ray_lightning_tpu.ops.losses import fused_lm_cross_entropy as jax_fused_ce
from ray_lightning_tpu.ops.optim import fp32_master as jax_fp32_master
from ray_lightning_tpu_torch import Callback, Trainer
from ray_lightning_tpu_torch.convert import (flax_opt_state_to_torch,
                                             flax_to_torch)
from ray_lightning_tpu_torch.core.module import StepContext
from ray_lightning_tpu_torch.core.steps import (build_init_fn,
                                                build_train_step)
from ray_lightning_tpu_torch.models.gpt import GPTConfig, GPTLightningModule
from ray_lightning_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_fwd)
from ray_lightning_tpu_torch.ops.flash_decode import flash_decode_attention
from ray_lightning_tpu_torch.ops.losses import (
    chunked_softmax_cross_entropy, fused_lm_cross_entropy)
from ray_lightning_tpu_torch.ops.optim import AdamW, fp32_master

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
#: the training tests' model: tiny's widths, dot attention on both sides
TINY = dict(vocab_size=512, block_size=64, n_layer=2, n_head=2, n_embd=64,
            remat=False, attention_impl="dot")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and torch's default of a thread per core would crowd the
    other workers' time-bounded distributed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x, jnp.float32)))


def _pair(rng, shape, dtype, scale=1.0):
    """One numpy draw as a JAX array and a torch tensor holding the same
    values in ``dtype``."""
    jdt, tdt, _ = DTYPES[dtype]
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


# -- (a) attention backward ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [128, 512])
def test_flash_backward_matches_jax_pallas_kernel(T, dtype):
    """dq, dk, dv of the port's plain backward (from its own forward's o
    and lse) and of ``flash_attention`` under autograd, against
    the JAX custom VJP through ``_bwd_packed_kernel`` (interpret mode)."""
    rng = np.random.default_rng(T + 1)
    B, H, D = 1, 2, 64
    shape = (B, T, H, D)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _pair(rng, shape, dtype) for _ in range(4))
    jdt, tdt, tol = DTYPES[dtype]
    _, vjp = jax.vjp(lambda q, k, v: jax_flash_attention(
        q, k, v, causal=True, dtype=jdt, interpret=True), jq, jk, jv)
    want = vjp(jdo)

    o, lse = flash_attention_fwd(tq, tk, tv, causal=True)
    plain = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal=True)
    wrapped = flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(plain, wrapped))
    qs = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = flash_attention(*qs, causal=True, dtype=tdt)
    autograd = torch.autograd.grad(out, qs, tdo)
    for name, a, b, w in zip(("dq", "dk", "dv"), plain, autograd, want):
        assert a.dtype == tdt and a.shape == shape
        np.testing.assert_allclose(_np(a), _np(w), atol=tol, rtol=tol,
                                   err_msg=name)
        np.testing.assert_allclose(_np(b), _np(w), atol=tol, rtol=tol,
                                   err_msg=name)


def test_flash_attention_gradients_reach_qkv_on_cpu():
    """The CPU route of the fault: ``flash_attention`` of the split views
    of one fused projection yields the plain attention's gradient for the
    projection (fp32, 2e-5)."""
    from ray_lightning_tpu_torch.ops.attention import dot_product_attention
    rng = np.random.default_rng(3)
    B, T, H, D = 2, 37, 2, 16
    x = torch.from_numpy(rng.standard_normal((B, T, 3 * H * D)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((B, T, H, D)).astype(np.float32))

    def grad(attend):
        qkv = x.clone().requires_grad_()
        q, k, v = (y.view(B, T, H, D) for y in qkv.split(H * D, dim=-1))
        out = attend(q, k, v, causal=True, dtype=torch.float32)
        return torch.autograd.grad((out * w).sum(), qkv)[0]

    got, want = grad(flash_attention), grad(dot_product_attention)
    assert got.abs().min() >= 0 and got[..., :H * D].abs().max() > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)


def test_flash_decode_refuses_autograd():
    """The decode kernel has no backward: under grad mode with an input
    that requires grad it raises; without grad it runs."""
    q = torch.zeros(2, 1, 2, 16, requires_grad=True)
    kc = torch.zeros(2, 8, 2, 16)
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_decode_attention(q, kc, kc, pos)
    with torch.no_grad():
        assert flash_decode_attention(q, kc, kc, pos).shape == (2, 1, 2, 16)


# -- (b) losses ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("loss", ["fused", "chunked"])
def test_lm_losses_match_jax(loss, dtype):
    """Value and gradients w.r.t. hidden and the tied table; the table is
    fp32 (the master's dtype) and cast to the compute dtype inside."""
    rng = np.random.default_rng(11)
    B, T, D, V = 2, 16, 32, 512
    jh, th = _pair(rng, (B, T, D), dtype)
    jw, tw = _pair(rng, (V, D), "float32", scale=0.5)
    y = rng.integers(0, V, (B, T)).astype(np.int32)
    tol = DTYPES[dtype][2]
    if loss == "fused":
        jfn, tfn = jax_fused_ce, fused_lm_cross_entropy
    else:
        jfn = functools.partial(jax_chunked_ce, n_chunks=4)
        tfn = functools.partial(chunked_softmax_cross_entropy, n_chunks=4)
    want, (wdh, wdw) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jh, jw, jnp.asarray(y))
    th.requires_grad_()
    tw.requires_grad_()
    got = tfn(th, tw, torch.from_numpy(y))
    gdh, gdw = torch.autograd.grad(got, (th, tw))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), atol=tol, rtol=tol)
    assert gdh.dtype == th.dtype and gdw.dtype == torch.float32
    np.testing.assert_allclose(_np(gdh), _np(wdh), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(gdw), _np(wdw), atol=tol, rtol=tol)


# -- (c) optimizer --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _seeded_params(**config):
    """Seeded fp32 params of the JAX ``GPTConfig(**config)`` in the JAX
    package's tree (the same in every compute dtype): LayerNorm scales 1,
    biases 0, every other leaf N(0, 0.02) from numpy.  The tree comes
    from ``jax.eval_shape`` of the JAX init, which compiles nothing."""
    jcfg = JaxConfig(**config, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda r: JaxGPT(jcfg).init(
        r, jnp.zeros((1, 8), jnp.int32))["params"], jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def leaf(path, x):
        name = path[-1].key
        if name in ("scale", "bias"):
            return np.full(x.shape, name == "scale", np.float32)
        return (rng.standard_normal(x.shape) * 0.02).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _tiny_init(dtype: str = "bfloat16"):
    """TINY's config in the given compute dtype and its params."""
    return JaxConfig(**TINY, dtype=DTYPES[dtype][0]), _seeded_params(**TINY)


@pytest.mark.parametrize("count", [0, 3])
def test_adamw_fp32_master_step_matches_optax(count):
    """From the same bf16 resident params, bf16 grads and optimizer state
    (optax's after ``count`` updates, converted), one update of the
    port's ``fp32_master(AdamW)`` lands on the moments of optax's eager
    update bit for bit and on its master within a few fp32 ulps
    (atol 1e-8, rtol 1e-6: the same ops in the same order, but the
    vectorized loops of the two libraries round the odd last bit
    apart; the jitted update rounds the bf16 moment differently), and
    the resident params equal ``master.to(bf16)`` bit for bit (optax's
    within one bf16 ulp).  ``count=0`` is step 0 (lr 0: the params do
    not move), ``count=3`` past the 2-step warmup."""
    _, tiny = _tiny_init()
    # a few leaves of every kind the path map knows
    params = {"wpe": tiny["wpe"], "ln_f": tiny["ln_f"],
              "h0": {"attn": {"qkv": tiny["h0"]["attn"]["qkv"]}}}
    rng = np.random.default_rng(count)
    resident = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16),
                                      params)

    def grads_like():
        return jax.tree_util.tree_map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32) * 1e-2,
            jnp.bfloat16), params)

    tx = jax_fp32_master(optax.adamw(optax.linear_schedule(0.0, 3e-3, 2),
                                     b1=0.9, b2=0.95, weight_decay=0.01,
                                     mu_dtype=jnp.bfloat16))
    state = tx.init(params)
    for _ in range(count):
        upd, state = tx.update(grads_like(), state, resident)
        resident = optax.apply_updates(resident, upd)
    g = grads_like()
    upd, new_state = tx.update(g, state, resident)
    new_resident = flax_to_torch(jax.device_get(
        optax.apply_updates(resident, upd)))

    mine = flax_opt_state_to_torch(jax.device_get(state))
    assert mine.inner.count == count
    tparams = flax_to_torch(jax.device_get(resident))
    before = {k: v.clone() for k, v in tparams.items()}
    opt = fp32_master(AdamW(3e-3, warmup_steps=2, weight_decay=0.01,
                            mu_dtype=torch.bfloat16))
    opt.update(flax_to_torch(jax.device_get(g)), mine, tparams)

    want = flax_opt_state_to_torch(jax.device_get(new_state))
    assert mine.inner.count == want.inner.count == count + 1
    for k in tparams:
        assert mine.inner.mu[k].dtype == torch.bfloat16
        for a, b in ((mine.inner.mu[k], want.inner.mu[k]),
                     (mine.inner.nu[k], want.inner.nu[k]),
                     (tparams[k], mine.master[k].to(torch.bfloat16))):
            assert torch.equal(a, b), k
        np.testing.assert_allclose(_np(mine.master[k]), _np(want.master[k]),
                                   atol=1e-8, rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(_np(tparams[k]), _np(new_resident[k]),
                                   atol=0, rtol=2 ** -8, err_msg=k)
        assert torch.equal(tparams[k], before[k]) == (count == 0), k


# -- (d) train step --------------------------------------------------------------

class _JaxFixed(JaxModule):
    """The JAX module with given initial params."""

    def __init__(self, params, **kw):
        super().__init__(**kw)
        self._params = params

    def init_params(self, rng, batch):
        return {"params": jax.tree_util.tree_map(jnp.asarray, self._params)}


class _TorchFixed(GPTLightningModule):
    """The port's module loading the same params, converted."""

    def __init__(self, params, **kw):
        super().__init__(**kw)
        self._state = flax_to_torch(params)

    def init_params(self, generator):
        self.setup_model(generator.device)
        self.model.load_state_dict(self._state)
        return self.model.state_dict()


def _batches(n, B, cfg, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg["vocab_size"], (n, B, 33)).astype(np.int32)
    return [(t[:, :-1], t[:, 1:]) for t in toks]


@pytest.mark.parametrize("dtype,accumulate", [("float32", 1),
                                              ("bfloat16", 1),
                                              ("bfloat16", 2)])
def test_train_step_matches_jax(dtype, accumulate, monkeypatch):
    """4 optimizer steps (warmup 2, so step 0 moves nothing) from the same
    init and batches: the per-step losses and the final params agree.
    fp32 compute with fp32-resident params (``RLT_BF16_PARAMS=0``) within
    2e-5; the default bf16 compute with bf16-resident params and an fp32
    master within 2e-2.  The JAX step runs jitted, as its Trainer runs
    it."""
    monkeypatch.setenv("RLT_BF16_PARAMS", "0" if dtype == "float32" else "1")
    jdt, tdt, tol = DTYPES[dtype]
    jcfg, params = _tiny_init(dtype)
    kw = dict(warmup_steps=2, batch_size=4)
    jmod = _JaxFixed(params, config=jcfg, **kw)
    jmod.setup_model()
    tmod = _TorchFixed(params, config=GPTConfig(**TINY, dtype=tdt), **kw)
    batches = _batches(4, 4, TINY)

    jtx = jmod.configure_optimizers()
    jstate = jax_init_fn(jmod, jtx)(jax.random.PRNGKey(0), batches[0])
    jstep = jax.jit(jax_train_step(jmod, jtx, accumulate))
    ttx = tmod.configure_optimizers()
    tmod.setup_model("cpu")
    tstate = build_init_fn(tmod, ttx)(torch.Generator().manual_seed(0))
    tstep = build_train_step(tmod, ttx, accumulate)
    assert next(tmod.model.parameters()).dtype == (
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)

    for i, (x, y) in enumerate(batches):
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        tstate, tm = tstep(tstate, (torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=tol, rtol=tol, err_msg=f"step {i}")
    assert tstate.step == int(jstate.step) == 4
    want = flax_to_torch(jax.device_get(jstate.params))
    got = tmod.model.state_dict()
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        if k.endswith("attn.qkv.bias"):
            continue
        np.testing.assert_allclose(_np(v), _np(want[k]), atol=tol, rtol=tol,
                                   err_msg=k)
    # The k third of the qkv bias has an identically zero gradient (it
    # shifts every score of a row alike), so each side's Adam turns its
    # own rounding noise there into updates of up to lr a step, each in
    # its own direction: that slice is held to 2 x lr x steps, the q and v
    # thirds to the tolerance.
    C = TINY["n_embd"]
    for i in range(TINY["n_layer"]):
        k = f"h.{i}.attn.qkv.bias"
        a, b = _np(got[k]), _np(want[k])
        np.testing.assert_allclose(a[C:2 * C], b[C:2 * C], rtol=0,
                                   atol=2 * tmod.lr * len(batches), err_msg=k)
        for sl in (slice(0, C), slice(2 * C, 3 * C)):
            np.testing.assert_allclose(a[sl], b[sl], atol=tol, rtol=tol,
                                       err_msg=k)


# -- (e) fit ------------------------------------------------------------------------

#: a sanity pass, epochs cut by limit_train_batches, gradients
#: accumulated over 2 microbatches a step, validation after each epoch,
#: and a stop at max_steps in the middle of the second epoch
FIT = dict(max_epochs=3, max_steps=5, limit_train_batches=3,
           accumulate_grad_batches=2, num_sanity_val_steps=1,
           limit_val_batches=2)


def test_fit_matches_jax_trainer(tmp_path):
    """``Trainer.fit`` of TINY (bf16 params, fp32 master, fused CE):
    per-batch losses, ``callback_metrics`` (the epoch's mean loss,
    val_loss), global_step and current_epoch as the JAX trainer's, within
    2e-2."""
    jcfg, params = _tiny_init()
    kw = dict(lr=3e-3, warmup_steps=2, batch_size=4, dataset_size=32)
    jmod = _JaxFixed(params, config=jcfg, **kw)
    tmod = _TorchFixed(params, config=GPTConfig(**TINY), **kw)
    common = dict(enable_checkpointing=False, seed=0, **FIT)

    class JaxLosses(JaxCallback):
        def __init__(self):
            self.losses = []

        def on_train_batch_end(self, trainer, module, outputs, batch, i):
            self.losses.append(float(outputs["loss"]))

    class TorchLosses(Callback):
        def __init__(self):
            self.losses = []

        def on_train_batch_end(self, trainer, module, outputs, batch, i):
            self.losses.append(float(outputs["loss"]))

    jrec, trec = JaxLosses(), TorchLosses()
    jt = JaxTrainer(callbacks=[jrec], logger=False,
                    default_root_dir=str(tmp_path), **common)
    jt.fit(jmod)
    tt = Trainer(callbacks=[trec], device="cpu",
                 default_root_dir=str(tmp_path), **common)
    out = tt.fit(tmod)
    assert len(trec.losses) == len(jrec.losses) == 5
    np.testing.assert_allclose(trec.losses, jrec.losses, atol=2e-2,
                               rtol=2e-2)
    assert min(trec.losses[3:]) < trec.losses[0]
    assert (tt.global_step, tt.current_epoch) == (jt.global_step,
                                                  jt.current_epoch)
    assert tt.global_step == 5
    assert set(tt.callback_metrics) == set(jt.callback_metrics) \
        == {"loss", "val_loss"}
    for k, v in jt.callback_metrics.items():
        np.testing.assert_allclose(tt.callback_metrics[k], v, atol=2e-2,
                                   rtol=2e-2, err_msg=k)
    assert out == {"callback_metrics": tt.callback_metrics}


@pytest.mark.parametrize("route", ["chunked", "fp32_logits"])
def test_lm_loss_routes_agree(route, monkeypatch):
    """``GPTLightningModule._loss``'s other routes (``chunked_ce > 0``;
    ``RLT_FUSED_CE=0``: fp32 logits from the full forward) compute the
    fused CE's value and gradients in fp32 compute (2e-5)."""
    _, params = _tiny_init("float32")
    batch = tuple(torch.from_numpy(a) for a in _batches(1, 2, TINY)[0])

    def loss_and_grads(cfg):
        mod = _TorchFixed(params, config=cfg)
        mod.init_params(torch.Generator())
        ctx = StepContext(mod, training=True)
        loss = mod._loss(ctx, batch)
        return loss, torch.autograd.grad(loss, list(mod.model.parameters()))

    cfg = GPTConfig(**TINY, dtype=torch.float32)
    want, wgrads = loss_and_grads(cfg)
    if route == "chunked":
        cfg = dataclasses.replace(cfg, chunked_ce=4)
    else:
        monkeypatch.setenv("RLT_FUSED_CE", "0")
    got, grads = loss_and_grads(cfg)
    np.testing.assert_allclose(float(got), float(want), atol=2e-5,
                               rtol=2e-5)
    for g, w in zip(grads, wgrads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5,
                                   rtol=2e-5)


def test_trainer_refuses_what_is_not_ported():
    """Arguments of the JAX Trainer that the port does not honour yet
    raise instead of being ignored: the planner's and MPMD's strategies
    and the telemetry, compile-cache and planner planes.
    (The strategies beyond DDP and ZeRO-1,
    ``"fsdp"`` and ``"spmd"``, are ported: tests/test_torch_sharded.py;
    so is ``comm_policy``: tests/test_torch_comm.py; so is ``elastic``:
    tests/test_torch_elastic.py, tests/test_torch_failure.py.)
    (gpt2-medium's remat "dots" is ported: tests/test_torch_remat.py.)
    Checkpointing,
    clipping, the bf16 batch cast, dropout, the plugins and the loop
    engine's ``steps_per_execution`` and ``cache_train_dataset`` are
    honoured (tests/test_torch_checkpoint.py,
    tests/test_torch_trainer.py, tests/test_torch_plugin*.py,
    tests/test_torch_loop_engine.py)."""
    for kw in (dict(strategy="auto"), dict(strategy="mpmd"),
               dict(telemetry=True), dict(compile_cache=True),
               dict(plan=True)):
        with pytest.raises(NotImplementedError, match="not ported"):
            Trainer(device="cpu", **kw)


@pytest.mark.parametrize("precision", ["32", "32-true", "64", "bf16",
                                       "16-mixed", "bogus"])
def test_trainer_precision_spellings_match_jax(precision, tmp_path,
                                               monkeypatch):
    """Each precision spelling does in the port what it does in the JAX
    ``Trainer``: every known one constructs and fits, with the model's
    params left fp32 (the bf16 ones cast a batch's floating leaves only,
    and TINY's batches are token ids, so every spelling gives the losses
    of the default ``"32"``); a spelling neither package knows raises
    ``ValueError`` in both."""
    kw = dict(enable_checkpointing=False, seed=0, max_steps=2,
              limit_train_batches=2, num_sanity_val_steps=0,
              limit_val_batches=0)
    try:
        JaxTrainer(logger=False, default_root_dir=str(tmp_path),
                   precision=precision, **kw)
    except ValueError:
        with pytest.raises(ValueError, match="Unknown precision"):
            Trainer(device="cpu", precision=precision,
                    default_root_dir=str(tmp_path), **kw)
        assert precision == "bogus"
        return
    monkeypatch.setenv("RLT_BF16_PARAMS", "0")
    jcfg, params = _tiny_init("float32")

    def losses(p):
        class Losses(Callback):
            def __init__(self):
                self.losses = []

            def on_train_batch_end(self, trainer, module, outputs, batch,
                                   i):
                self.losses.append(float(outputs["loss"]))

        rec = Losses()
        mod = _TorchFixed(params, config=GPTConfig(**TINY,
                                                   dtype=torch.float32),
                          warmup_steps=2, batch_size=4, dataset_size=16)
        Trainer(callbacks=[rec], device="cpu", precision=p,
                default_root_dir=str(tmp_path), **kw).fit(mod)
        assert {x.dtype for x in mod.model.parameters()} == {torch.float32}
        return rec.losses

    got = losses(precision)
    assert len(got) == 2 and np.isfinite(got).all()
    assert got == losses("32")
    assert Trainer(device="cpu", precision=precision,
                   default_root_dir=str(tmp_path), **kw).batch_float_dtype == (
        torch.bfloat16 if precision.startswith(("bf16", "16")) else None)
