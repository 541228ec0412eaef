"""PyTorch/CUDA port, the BERT slice: ``ray_lightning_tpu_torch.models.
bert`` against the JAX package's ``models/bert.py`` on the same
numpy-seeded weights (converted with ``flax_to_torch``) and inputs.

- (a) masked LM, the ``tiny`` config (h=2, d=32: heads that do not pack)
  and a narrow one (h=2, d=64: packable): encoder hidden states, MLM
  logits, ``_mlm_loss`` at a mask drawn by ``jax.random.bernoulli`` and
  handed to the port, every gradient.  In fp32 both sides run flash
  attention (the JAX Pallas kernels under the interpreter: rows 5 + 10
  at ``tiny``, rows 1 + 6 non-causal at the narrow config, asserted by
  the kernel bodies ``pallas_call`` receives; the port's
  ``flash_attention`` over its plain versions); in bf16 the plain
  attention;
- (b) the classifier: logits, loss, accuracy, every gradient;
- (c) the optimizers: one ``BertMLMModule`` AdamW step (a constant rate,
  b2 = 0.999, an fp32 first moment) against eager ``optax.adamw(lr)``
  from a state converted with ``flax_opt_state_to_torch``; the
  documented ``warmup_steps=0`` case (the rate is 0.0, as in optax);
- (d) ``StepContext.make_rng`` and the routes ``tpu_rows`` names for
  the BERT shapes; remat "full" against "off"; what is not ported raises;
- (e) ``Trainer.fit`` of both modules against the JAX ``Trainer``; the
  MLM masks come from numpy on both sides (test-side subclasses carry
  them in the dataset), since the two RNGs give different bits.

Tolerances: fp32 2e-5 forward and 5e-5 gradients, bf16 2e-2, as
``atol = rtol`` (tests/test_ops.py).  Two layers at widths 64-128, so the
file runs in about a minute on one core.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
from ray_lightning_tpu.core.data import ArrayDataset as JaxArrayDataset
from ray_lightning_tpu.core.data import DataLoader as JaxDataLoader
from ray_lightning_tpu.core.module import StepContext as JaxStepContext
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu_torch import Callback, Trainer
from ray_lightning_tpu_torch.convert import (flax_opt_state_to_torch,
                                             flax_to_torch)
from ray_lightning_tpu_torch.core.data import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.core.module import StepContext
from ray_lightning_tpu_torch.ops.flash_attention import tpu_rows
from ray_lightning_tpu_torch.ops.optim import AdamW

jbert = importlib.import_module("ray_lightning_tpu.models.bert")
tbert = importlib.import_module("ray_lightning_tpu_torch.models.bert")
jfa = importlib.import_module("ray_lightning_tpu.ops.flash_attention")

#: dtype -> (jax, torch, forward tol, gradient tol)
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5, 5e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2, 2e-2)}
#: the tiny config's widths, and a narrow one whose heads pack (d=64)
WIDTHS = {"tiny": dict(vocab_size=512, max_len=64, n_layer=2, n_head=2,
                       n_embd=64, intermediate=128),
          "narrow": dict(vocab_size=512, max_len=64, n_layer=2, n_head=2,
                         n_embd=128, intermediate=256)}
HEADS = {"mlm": (jbert.BertForMaskedLM, tbert.BertForMaskedLM),
         "cls": (jbert.BertClassifier, tbert.BertClassifier)}


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


@functools.lru_cache(maxsize=None)
def _seeded_params(head: str, width: str):
    """Seeded fp32 params of the JAX model in its tree: LayerNorm scales
    1, biases 0, every other leaf N(0, 0.02) from numpy.  The tree comes
    from ``jax.eval_shape`` of the JAX init, which compiles nothing."""
    cfg = jbert.BertConfig(**WIDTHS[width], dtype=jnp.float32)
    shapes = jax.eval_shape(lambda r: HEADS[head][0](cfg).init(
        r, jnp.zeros((1, 8), jnp.int32))["params"], jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def leaf(path, x):
        name = path[-1].key
        if name in ("scale", "bias"):
            return np.full(x.shape, name == "scale", np.float32)
        return (rng.standard_normal(x.shape) * 0.02).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _torch_model(head, width, dtype, impl="auto"):
    cfg = tbert.BertConfig(**WIDTHS[width], dtype=dtype,
                           attention_impl=impl)
    model = HEADS[head][1](cfg, device="cpu")
    model.load_state_dict(flax_to_torch(_seeded_params(head, width)))
    return model


def _tokens(B=2, T=64, seed=1, vocab=511):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def _pallas_rows(monkeypatch) -> "list[str]":
    seen = []
    real = jfa.pl.pallas_call

    def spy(kernel, *args, **kwargs):
        seen.append(getattr(kernel, "func", kernel).__name__)
        return real(kernel, *args, **kwargs)

    monkeypatch.setattr(jfa.pl, "pallas_call", spy)
    return seen


# -- (a) masked LM --------------------------------------------------------------

#: (width, dtype, attention, the Pallas kernels of the flash cases)
MLM_CASES = [
    ("tiny", "float32", "flash", {"_fwd_kernel", "_bwd_fused_kernel"}),
    ("narrow", "float32", "flash",
     {"_fwd_packed_kernel", "_bwd_packed_kernel"}),
    ("tiny", "bfloat16", "dot", set()),
    ("narrow", "bfloat16", "dot", set()),
]


@pytest.mark.parametrize("width,dtype,impl,kernels", MLM_CASES)
def test_mlm_matches_jax(width, dtype, impl, kernels, monkeypatch):
    """Encoder hidden states, fp32 MLM logits, the masked-LM loss at the
    JAX package's own Bernoulli mask, and every gradient."""
    jdt, tdt, tol, gtol = DTYPES[dtype]
    params = _seeded_params("mlm", width)
    jcfg = jbert.BertConfig(**WIDTHS[width], dtype=jdt, attention_impl=impl)
    jmod = jbert.BertMLMModule(jcfg)
    jmod.setup_model()
    toks = _tokens()
    key = jax.random.PRNGKey(3)
    mask = np.asarray(jax.random.bernoulli(key, jmod.mask_prob, toks.shape))
    assert 0 < mask.sum() < mask.size
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    seen = _pallas_rows(monkeypatch)

    def jloss(p):
        ctx = JaxStepContext(jmod, p, {}, None, training=True)
        return jmod._mlm_loss(ctx, jnp.asarray(toks), key)

    def jfwd(p):
        return (jbert.BertEncoder(jcfg).apply({"params": p["encoder"]},
                                              jnp.asarray(toks)),
                jmod.model.apply({"params": p}, jnp.asarray(toks)))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(jparams)
    assert set(seen) == kernels
    # in bf16 the plain apply, which the port follows op for op: under
    # jit XLA's fusions keep fp32 between bf16 ops (ROADMAP queue 3 F1)
    want_h, want_logits = (jax.jit(jfwd) if dtype == "float32"
                           else jfwd)(jparams)

    tmod = tbert.BertMLMModule(tbert.BertConfig(
        **WIDTHS[width], dtype=tdt, attention_impl=impl))
    tmod.setup_model("cpu")
    tmod.model.load_state_dict(flax_to_torch(params))
    x = torch.from_numpy(toks)
    with torch.no_grad():
        h = tmod.model.encoder(x)
        logits = tmod.model(x)
    assert h.dtype == tdt and logits.dtype == torch.float32
    np.testing.assert_allclose(_np(h), _np(want_h), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(logits), _np(want_logits), atol=tol,
                               rtol=tol)
    ps = dict(tmod.model.named_parameters())
    loss = tmod._mlm_loss(StepContext(tmod, training=True), x,
                          mask=torch.from_numpy(mask.copy()))
    grads = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=tol,
                               rtol=tol)
    want = flax_to_torch(jax.device_get(want_grads))
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        assert g.dtype == torch.float32, k
        np.testing.assert_allclose(_np(g), _np(want[k]), atol=gtol,
                                   rtol=gtol, err_msg=k)


# -- (b) classifier ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_classifier_matches_jax(dtype):
    """fp32 classifier logits, the mean CE, the accuracy, every
    gradient, from ``ClassificationModule._logits_loss_acc``."""
    jdt, tdt, tol, gtol = DTYPES[dtype]
    params = _seeded_params("cls", "tiny")
    jmod = jbert.BertLightningModule(jbert.BertConfig(**WIDTHS["tiny"],
                                                      dtype=jdt))
    jmod.setup_model()
    rng = np.random.default_rng(4)
    toks = _tokens(B=8, seed=4)
    labels = rng.integers(0, 2, 8).astype(np.int32)

    def jloss(p):
        ctx = JaxStepContext(jmod, p, {}, None, training=True)
        logits, loss, acc = jmod._logits_loss_acc(
            ctx, (jnp.asarray(toks), jnp.asarray(labels)))
        return loss, (logits, acc)

    (want_loss, (want_logits, want_acc)), want_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))

    tmod = tbert.BertLightningModule(tbert.BertConfig(**WIDTHS["tiny"],
                                                      dtype=tdt))
    tmod.setup_model("cpu")
    tmod.model.load_state_dict(flax_to_torch(params))
    ps = dict(tmod.model.named_parameters())
    logits, loss, acc = tmod._logits_loss_acc(
        StepContext(tmod, training=True),
        (torch.from_numpy(toks), torch.from_numpy(labels)))
    grads = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))
    assert logits.dtype == loss.dtype == torch.float32
    np.testing.assert_allclose(_np(logits), _np(want_logits), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=tol,
                               rtol=tol)
    assert acc.item() == float((logits.argmax(-1).numpy() == labels).mean())
    if dtype == "float32":
        assert acc.item() == float(want_acc)
    want = flax_to_torch(jax.device_get(want_grads))
    assert grads.keys() == want.keys() and "pooler.weight" in grads
    for k, g in grads.items():
        np.testing.assert_allclose(_np(g), _np(want[k]), atol=gtol,
                                   rtol=gtol, err_msg=k)


# -- (c) optimizers -----------------------------------------------------------------

@pytest.mark.parametrize("count", [0, 2])
def test_adamw_constant_rate_matches_optax(count):
    """``BertMLMModule.configure_optimizers`` against the JAX module's
    (eager ``optax.adamw(lr, weight_decay)``): from optax's state after
    ``count`` updates, converted (a schedule-free state, its count read
    from the adam state), one update lands on optax's moments bit for
    bit (mu in fp32) and on its params within a few fp32 ulps (the
    same ops in the same order; the two libraries' vectorized loops
    round the odd last bit apart).  At a constant rate even the first
    update moves the params."""
    tiny = _seeded_params("mlm", "tiny")
    enc = tiny["encoder"]
    params = {"encoder": {"wpe": enc["wpe"], "ln_f": enc["ln_f"],
                          "h0": {"fc": enc["h0"]["fc"]}},
              "mlm_head": tiny["mlm_head"]}
    params = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.default_rng(count)

    def grads_like():
        return jax.tree_util.tree_map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32) * 1e-2), params)

    jmod = jbert.BertMLMModule("tiny", lr=3e-3)
    tx = jmod.configure_optimizers()
    state = tx.init(params)
    for _ in range(count):
        upd, state = tx.update(grads_like(), state, params)
        params = optax.apply_updates(params, upd)
    g = grads_like()
    upd, new_state = tx.update(g, state, params)
    new_params = flax_to_torch(jax.device_get(
        optax.apply_updates(params, upd)))

    mine = flax_opt_state_to_torch(jax.device_get(state))
    assert mine.count == count
    tparams = flax_to_torch(jax.device_get(params))
    before = {k: v.clone() for k, v in tparams.items()}
    opt = tbert.BertMLMModule("tiny", lr=3e-3).configure_optimizers()
    assert (opt.b1, opt.b2, opt.mu_dtype) == (0.9, 0.999, None)
    opt.update(flax_to_torch(jax.device_get(g)), mine, tparams)

    want = flax_opt_state_to_torch(jax.device_get(new_state))
    assert mine.count == want.count == count + 1
    for k in tparams:
        assert mine.mu[k].dtype == torch.float32
        assert torch.equal(mine.mu[k], want.mu[k]), k
        assert torch.equal(mine.nu[k], want.nu[k]), k
        np.testing.assert_allclose(_np(tparams[k]), _np(new_params[k]),
                                   atol=1e-8, rtol=1e-6, err_msg=k)
        assert not torch.equal(tparams[k], before[k]), k


def test_warmup_zero_is_a_zero_rate():
    """The documented trap: ``AdamW(lr, warmup_steps=0)`` is
    ``adamw(linear_schedule(0, lr, 0))``, a constant rate of 0.0, in the
    port as in optax: an update moves the moments and never the params.
    The constant-rate form is ``warmup_steps=None``."""
    p = {"w": jnp.asarray(np.linspace(-1, 1, 8, dtype=np.float32))}
    g = {"w": jnp.full(8, 0.5, jnp.float32)}
    tx = optax.adamw(optax.linear_schedule(0.0, 1e-2, 0), weight_decay=0.01)
    upd, _ = tx.update(g, tx.init(p), p)
    assert not np.any(np.asarray(upd["w"]))

    for warmup, moves in ((0, False), (None, True)):
        opt = AdamW(1e-2, warmup_steps=warmup, weight_decay=0.01)
        tp = {"w": torch.linspace(-1, 1, 8)}
        before = tp["w"].clone()
        state = opt.init(tp)
        for _ in range(3):
            opt.update({"w": torch.full((8,), 0.5)}, state, tp)
        assert state.count == 3 and state.mu["w"].abs().min() > 0
        assert torch.equal(tp["w"], before) != moves


# -- (d) rng, routes, remat, what raises ------------------------------------------

def test_make_rng_is_explicit_and_deterministic():
    """``make_rng`` gives a generator per call from (seed, step,
    microbatch, call index): the same entropy gives the same draws, any
    other entropy other draws; the global RNG state is untouched; a
    context without entropy (an eval step) raises, as the JAX one."""
    def draws(rng, calls=2):
        ctx = StepContext(None, training=True, rng=rng)
        return [torch.rand(16, generator=ctx.make_rng()) for _ in
                range(calls)]

    state = torch.get_rng_state()
    a, b = draws((0, 5, 0)), draws((0, 5, 0))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
    others = [draws(e)[0] for e in ((1, 5, 0), (0, 6, 0), (0, 5, 1))]
    assert not any(torch.equal(a[0], o) for o in others)
    assert torch.equal(torch.get_rng_state(), state)
    with pytest.raises(RuntimeError, match="PRNG"):
        StepContext(None, training=False).make_rng()


def test_bert_routes_and_not_ported(monkeypatch):
    """The TPU kernel rows the BERT shapes take (the JAX package's
    dispatch, ``tpu_rows``): bert-base rows 1 + 6 (non-causal, packed),
    ``tiny`` rows 5 + 10, bert-base under ``RLT_FLASH_BLOCK_Q=K=128``
    rows 5 + 15 + 16.  Remat "full" gives the gradients of "off" bit for
    bit; dropout runs in training only (the forward without a seed is
    the dropout-free one bit for bit); remat "dots" builds
    (tests/test_torch_remat.py holds its gradients); SPMD rules and an
    unknown flax path raise."""
    base = tbert.CONFIGS["bert-base"]
    tiny = tbert.CONFIGS["tiny"]
    assert tpu_rows(base.max_len, base.n_head, base.head_dim, False) \
        == (1, (6,))
    assert tpu_rows(tiny.max_len, tiny.n_head, tiny.head_dim, False) \
        == (5, (10,))
    monkeypatch.setenv("RLT_FLASH_BLOCK_Q", "128")
    monkeypatch.setenv("RLT_FLASH_BLOCK_K", "128")
    assert tpu_rows(base.max_len, base.n_head, base.head_dim, False) \
        == (5, (15, 16))

    x = torch.from_numpy(_tokens())
    grads = []
    for policy in ("off", "full"):
        model = _torch_model("mlm", "tiny", torch.float32, "flash")
        cfg = dataclasses.replace(model.config, remat=True,
                                  remat_policy=policy)
        remat = tbert.BertForMaskedLM(cfg, device="cpu")
        remat.load_state_dict(model.state_dict())
        assert remat.remat_policy == policy
        loss = remat(x).logsumexp(-1).mean()
        grads.append(torch.autograd.grad(loss, list(remat.parameters())))
    assert all(torch.equal(a, b) for a, b in zip(*grads))

    model = _torch_model("mlm", "tiny", torch.float32, "flash")
    drop = tbert.BertForMaskedLM(dataclasses.replace(model.config,
                                                     dropout=0.1),
                                 device="cpu")
    drop.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert torch.equal(drop(x), model(x))
        assert not torch.equal(drop(x, dropout_seed=7), model(x))
    dots = tbert.BertMLMModule(dataclasses.replace(
        tiny, remat=True, remat_policy="dots")).configure_model("cpu")
    assert dots.remat_policy == "dots"
    with pytest.raises(NotImplementedError, match="SpmdStrategy"):
        tbert.bert_partition_rules()
    with pytest.raises(KeyError, match="no mapping"):
        flax_to_torch({"encoder": {"h0": {"mlp": {"fc": {
            "kernel": np.zeros((2, 2), np.float32)}}}}})


# -- (e) fit --------------------------------------------------------------------------

#: a sanity pass, epochs cut by limit_train_batches, validation after
#: each epoch, a stop at max_steps in the middle of the second epoch
FIT = dict(max_epochs=3, max_steps=5, limit_train_batches=3,
           num_sanity_val_steps=1, limit_val_batches=2)
MASK_PROB = 0.15


def _mlm_data(n, seed, cfg):
    """Tokens as the modules' loaders draw them (the last id is the mask
    token) and a numpy Bernoulli mask per sample."""
    toks = np.random.default_rng(seed).integers(
        0, cfg["vocab_size"] - 1, (n, cfg["max_len"])).astype(np.int32)
    mask = np.random.default_rng(seed + 100).random(toks.shape) < MASK_PROB
    return toks, mask


class _JaxMLM(jbert.BertMLMModule):
    """The JAX module with given params and the masks in its data: the
    loss is ``_mlm_loss``'s with the given mask in place of the drawn
    one."""

    def __init__(self, params, **kw):
        super().__init__(**kw)
        self._params = params

    def init_params(self, rng, batch):
        return {"params": jax.tree_util.tree_map(jnp.asarray, self._params)}

    def _masked_loss(self, ctx, batch):
        tokens, mask = batch
        inputs = jnp.where(mask, self.config.vocab_size - 1, tokens)
        logits = ctx.apply(inputs, not ctx.training)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, tokens)
        w = mask.astype(jnp.float32)
        return (ce * w).sum() / jnp.maximum(w.sum(), 1.0)

    def training_step(self, ctx, batch):
        loss = self._masked_loss(ctx, batch)
        ctx.log("loss", loss)
        return loss

    def validation_step(self, ctx, batch):
        ctx.log("val_loss", self._masked_loss(ctx, batch))

    def _loader(self, n, seed, shuffle=False):
        return JaxDataLoader(JaxArrayDataset(*_mlm_data(n, seed,
                                                        WIDTHS["tiny"])),
                             batch_size=self.batch_size, shuffle=shuffle,
                             drop_last=True)


class _TorchMLM(tbert.BertMLMModule):
    """The port's module loading the same params, the masks from its
    data handed to ``_mlm_loss``."""

    def __init__(self, params, **kw):
        super().__init__(**kw)
        self._state = flax_to_torch(params)

    def init_params(self, generator):
        self.setup_model(generator.device)
        self.model.load_state_dict(self._state)
        return self.model.state_dict()

    def training_step(self, ctx, batch):
        loss = self._mlm_loss(ctx, batch[0], mask=batch[1])
        ctx.log("loss", loss)
        return loss

    def validation_step(self, ctx, batch):
        ctx.log("val_loss", self._mlm_loss(ctx, batch[0], mask=batch[1]))

    def _loader(self, n, seed, shuffle=False):
        return DataLoader(ArrayDataset(*_mlm_data(n, seed, WIDTHS["tiny"])),
                          batch_size=self.batch_size, shuffle=shuffle,
                          drop_last=True)


class _JaxCls(jbert.BertLightningModule):
    def __init__(self, params, **kw):
        super().__init__(**kw)
        self._params = params

    def init_params(self, rng, batch):
        return {"params": jax.tree_util.tree_map(jnp.asarray, self._params)}


class _TorchCls(tbert.BertLightningModule):
    def __init__(self, params, **kw):
        super().__init__(**kw)
        self._state = flax_to_torch(params)

    def init_params(self, generator):
        self.setup_model(generator.device)
        self.model.load_state_dict(self._state)
        return self.model.state_dict()


def _losses(callback_base):
    class Losses(callback_base):
        def __init__(self):
            self.losses = []

        def on_train_batch_end(self, trainer, module, outputs, batch, i):
            self.losses.append(float(outputs["loss"]))

    return Losses()


#: case -> (JAX module, port module, compute dtype, logged metrics)
FITS = {"mlm": (_JaxMLM, _TorchMLM, "bfloat16", {"loss", "val_loss"}),
        "mlm_fp32": (_JaxMLM, _TorchMLM, "float32", {"loss", "val_loss"}),
        "cls": (_JaxCls, _TorchCls, "float32",
                {"loss", "train_accuracy", "val_loss", "val_accuracy"})}


@pytest.mark.parametrize("which", list(FITS))
def test_fit_matches_jax_trainer(which, tmp_path):
    """``Trainer.fit`` of ``tiny``: the masked LM in bf16 and in fp32 at
    its constant rate (fp32 params, no master), the classifier in fp32
    under its 2-step warmup; per-batch losses, ``callback_metrics``,
    global_step and current_epoch as the JAX trainer's, within the
    dtype's tolerance; in fp32 also every parameter after the fit."""
    jcls, tcls, dtype, metrics = FITS[which]
    jdt, tdt, tol, _ = DTYPES[dtype]
    head = "cls" if which == "cls" else "mlm"
    params = _seeded_params(head, "tiny")
    kw = dict(lr=3e-3, batch_size=4, train_size=16, val_size=8)
    if which == "cls":
        kw["warmup_steps"] = 2
    jmod = jcls(params, config=jbert.BertConfig(**WIDTHS["tiny"],
                                                dtype=jdt), **kw)
    tmod = tcls(params, config=tbert.BertConfig(**WIDTHS["tiny"],
                                                dtype=tdt), **kw)
    common = dict(enable_checkpointing=False, seed=0, **FIT)
    jrec, trec = _losses(JaxCallback), _losses(Callback)
    jt = JaxTrainer(callbacks=[jrec], logger=False,
                    default_root_dir=str(tmp_path), **common)
    jt.fit(jmod)
    tt = Trainer(callbacks=[trec], device="cpu",
                 default_root_dir=str(tmp_path), **common)
    tt.fit(tmod)
    assert len(trec.losses) == len(jrec.losses) == 5
    np.testing.assert_allclose(trec.losses, jrec.losses, atol=tol, rtol=tol)
    assert min(trec.losses[3:]) < trec.losses[0]
    assert (tt.global_step, tt.current_epoch) == (jt.global_step,
                                                  jt.current_epoch)
    assert set(tt.callback_metrics) == set(jt.callback_metrics) == metrics
    for k, v in jt.callback_metrics.items():
        np.testing.assert_allclose(tt.callback_metrics[k], v, atol=tol,
                                   rtol=tol, err_msg=k)
    assert all(p.dtype == torch.float32 for p in tmod.model.parameters())
    if dtype != "float32":
        return
    # Adam divides each gradient by its own running RMS, so an entry whose
    # gradient is near zero (a sum that almost cancels; the k third of
    # the qkv bias, whose gradient is identically zero since it shifts
    # every score of a row alike) turns each side's rounding into steps
    # of up to lr.  Each tensor is held in per-tensor relative L2 to the
    # tolerance, the k-bias slice apart, and no entry may move more than
    # 2 x lr x steps from the JAX one.
    want = flax_to_torch(jax.device_get(jt.state.params))
    got = tmod.model.state_dict()
    assert set(got) == set(want)
    C = WIDTHS["tiny"]["n_embd"]
    for k, v in got.items():
        a, b = _np(v).ravel(), _np(want[k]).ravel()
        assert np.abs(a - b).max() <= 2 * kw["lr"] * 5, k
        if k.endswith("attn.qkv.bias"):
            a, b = np.delete(a, np.s_[C:2 * C]), np.delete(b, np.s_[C:2 * C])
        assert np.linalg.norm(a - b) <= tol * np.linalg.norm(b), k
