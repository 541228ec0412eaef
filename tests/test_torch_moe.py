"""PyTorch/CUDA port, mixture of experts: ``ray_lightning_tpu_torch.ops.
moe.MoEMLP`` and the routed GPT against the JAX package on the same
numpy-seeded inputs and converted weights.

- (a) the layer at ``moe-tiny`` width (M=64, E=4, d_ff=256) in fp32:
  output, load-balance loss and every gradient (params and input)
  against the JAX ``MoEMLP`` at 2e-5, for top-2, top-1 and an
  overflowing capacity;
- (b) the JAX ``test_moe.py`` cases that need no mesh: one expert is
  the dense FFN, top-2 combine weights sum to one, capacity overflow
  drops tokens, the aux loss is bounded, every expert parameter gets a
  gradient, top-1 keeps the router's task gradient;
- (c) the slice: a ``moe-tiny`` GPT train step under remat "dots"
  against the JAX step (loss, ``moe_aux``, gradients at 2e-5, and two
  optimizer steps' losses), a fit whose loss falls, a checkpoint round
  trip, and what stays refused (serving, a router split on
  ``expert``).

Tolerance: fp32 2e-5 as ``atol = rtol`` (the JAX package's own,
tests/test_ops.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.module import StepContext as JaxStepContext
from ray_lightning_tpu.core.steps import build_init_fn as jax_init_fn
from ray_lightning_tpu.core.steps import build_train_step as jax_train_step
from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
from ray_lightning_tpu.models.gpt import GPTLightningModule as JaxModule
from ray_lightning_tpu.ops.moe import MoEMLP as JaxMoE
from ray_lightning_tpu.ops.moe import total_aux_loss as jax_total_aux_loss
from ray_lightning_tpu_torch import Callback, Trainer
from ray_lightning_tpu_torch.convert import flax_to_torch
from ray_lightning_tpu_torch.core.module import StepContext
from ray_lightning_tpu_torch.core.steps import (build_init_fn,
                                                build_train_step)
from ray_lightning_tpu_torch.models.gpt import (CONFIGS, GPTConfig,
                                                GPTLightningModule,
                                                gelu_tanh)
from ray_lightning_tpu_torch.ops.moe import (MoEMLP, moe_partition_rules,
                                             total_aux_loss)

TOL = 2e-5
M, E, FF = 64, 4, 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL, err_msg=what)


def _layers(top_k, cf, n_experts=E, d_ff=FF, seed=0):
    """The JAX layer with seeded numpy params (router scaled so routing
    is not uniform) and the port's layer holding the same params."""
    rng = np.random.default_rng(seed)
    params = {
        "router": (rng.standard_normal((M, n_experts)) * 0.5).astype(
            np.float32),
        "w1": (rng.standard_normal((n_experts, M, d_ff)) * 0.1).astype(
            np.float32),
        "w2": (rng.standard_normal((n_experts, d_ff, M)) * 0.1).astype(
            np.float32)}
    jl = JaxMoE(n_experts=n_experts, d_ff=d_ff, top_k=top_k,
                capacity_factor=cf, dtype=jnp.float32)
    tl = MoEMLP(M, n_experts, d_ff, top_k, cf, torch.float32)
    with torch.no_grad():
        for k, v in params.items():
            getattr(tl, k).copy_(torch.from_numpy(v))
    return jl, tl, params


def _x(shape=(2, 16, M), seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- (a) the layer against JAX ------------------------------------------------

@pytest.mark.parametrize("top_k,cf", [(2, 1.25), (1, 2.0), (2, 0.5)],
                         ids=["top2", "top1", "overflow"])
def test_moe_layer_matches_jax(top_k, cf):
    """Output, aux and the gradients of ``sum(out * r) + aux`` with
    respect to router, w1, w2 and the input, fp32, within 2e-5."""
    jl, tl, params = _layers(top_k, cf)
    x = _x()
    r = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        out, state = jl.apply({"params": p}, xx, mutable=["losses"])
        aux = jax_total_aux_loss(state)
        return jnp.sum(out * r) + aux, (out, aux)

    (jl_val, (jout, jaux)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = tl(tx)
    loss = (out * torch.from_numpy(r)).sum() + aux
    grads = torch.autograd.grad(loss, [tl.router, tl.w1, tl.w2, tx])
    _close(out.detach(), jout, "out")
    _close(float(aux.detach()), float(jaux), "aux")
    _close(float(loss.detach()), float(jl_val), "loss")
    for name, g in zip(("router", "w1", "w2"), grads):
        _close(g, jg[name], name)
    _close(grads[3], jgx, "input")
    # the capacity the JAX layer computes
    assert tl.capacity(16) == min(16, int(np.ceil(cf * top_k * 16 / E)))


# -- (b) the JAX package's layer cases that need no mesh ----------------------

def test_single_expert_matches_dense_ffn():
    """One expert, top-1, capacity S: routing is the identity and the
    combine weight the softmax of one logit, 1, so the layer is the
    plain tanh-GELU FFN with the same weights."""
    _, tl, params = _layers(1, 1.0, n_experts=1, d_ff=32)
    x = torch.from_numpy(_x((2, 8, M), seed=3))
    with torch.no_grad():
        out, _ = tl(x)
        dense = gelu_tanh(x @ tl.w1[0]) @ tl.w2[0]
    torch.testing.assert_close(out, dense, atol=1e-5, rtol=1e-5)


def test_top2_combine_weights_sum_to_one():
    """With capacity >= k S nothing is dropped: each token's combine
    weights over (expert, slot) sum to 1, and each token is dispatched to
    exactly two slots."""
    _, tl, _ = _layers(2, 4.0)
    with torch.no_grad():
        dispatch, combine, _ = tl.route(torch.from_numpy(_x()))
    torch.testing.assert_close(combine.sum(dim=(2, 3)),
                               torch.ones(2, 16), atol=1e-6, rtol=0)
    assert torch.equal(dispatch.sum(dim=(2, 3)), torch.full((2, 16), 2.0))


def test_capacity_overflow_drops_tokens():
    """capacity_factor -> 0 leaves one slot an expert: at most 2 of the
    16 tokens survive, the rest come out exactly zero."""
    _, tl, _ = _layers(1, 0.01, n_experts=2, d_ff=16)
    assert tl.capacity(16) == 1
    with torch.no_grad():
        out, _ = tl(torch.from_numpy(_x((1, 16, M), seed=4)))
    norms = out[0].norm(dim=-1)
    assert int((norms == 0).sum()) >= 16 - 2


def test_aux_loss_bounded_and_grads_reach_every_param():
    """The Switch loss lies in [0.5, E] and is finite; ``sum(out**2) +
    aux`` sends a finite, non-zero gradient to router, w1 and w2."""
    _, tl, _ = _layers(2, 2.0)
    out, aux = tl(torch.from_numpy(_x((2, 32, M), seed=5)))
    assert 0.5 <= float(aux.detach()) <= E + 1e-3
    grads = torch.autograd.grad((out ** 2).sum() + aux,
                                [tl.router, tl.w1, tl.w2])
    for g in grads:
        assert torch.isfinite(g).all() and g.abs().sum() > 0


def test_top1_router_gets_task_gradient():
    """Top-1 scales the expert's output by the raw gate probability, so
    the router learns from the task loss alone (no aux term)."""
    _, tl, _ = _layers(1, 2.0)
    out, _ = tl(torch.from_numpy(_x(seed=6)))
    (g,) = torch.autograd.grad((out ** 2).sum(), [tl.router])
    assert float(g.abs().sum()) > 1e-3


# -- (c) the slice: the routed GPT -------------------------------------------

#: moe-tiny with dot attention on both sides, fp32, remat "dots"
MOE_TINY = dict(vocab_size=512, block_size=64, n_layer=2, n_head=2,
                n_embd=64, n_experts=4, attention_impl="dot", remat=True,
                remat_policy="dots")


class _JaxFixed(JaxModule):
    def __init__(self, params, **kw):
        super().__init__(**kw)
        self._params = params

    def init_params(self, rng, batch):
        self.setup_model()
        variables = self.model.init(rng, jnp.asarray(batch[0]))
        return {"params": self._params,
                **{k: v for k, v in variables.items() if k != "params"}}


class _TorchFixed(GPTLightningModule):
    def __init__(self, params, **kw):
        super().__init__(**kw)
        self._state = flax_to_torch(params)

    def init_params(self, generator):
        self.setup_model(generator.device)
        self.model.load_state_dict(self._state)
        return self.model.state_dict()


def _moe_params():
    """Seeded numpy params of the moe-tiny GPT, by the JAX init's tree
    (router scaled up so the routing is not uniform)."""
    jmod = JaxModule(JaxConfig(**MOE_TINY, dtype=jnp.float32))
    jmod.setup_model()
    shapes = jax.eval_shape(jmod.model.init, jax.random.PRNGKey(0),
                            jnp.zeros((2, 16), jnp.int32))["params"]
    rng = np.random.default_rng(11)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return np.ones(x.shape, np.float32)
        scale = 0.5 if "router" in name else 0.05
        return (rng.standard_normal(x.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_moe_tiny_train_step_matches_jax(monkeypatch):
    """The routed GPT's training step under remat "dots", fp32: the loss
    (task + 0.01 x aux), the logged ``moe_aux`` and every gradient agree
    with the JAX step's within 2e-5, and so do two jitted optimizer
    steps' losses (the second depends on the first update)."""
    monkeypatch.setenv("RLT_BF16_PARAMS", "0")
    params = _moe_params()
    rng = np.random.default_rng(12)
    toks = rng.integers(0, 512, (2, 4, 17)).astype(np.int32)
    batches = [(t[:, :-1], t[:, 1:]) for t in toks]
    x, y = batches[0]

    jmod = JaxModule(JaxConfig(**MOE_TINY, dtype=jnp.float32))
    jmod.setup_model()
    variables = jmod.model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    losses_state = {"losses": variables["losses"]}

    def jloss(p):
        ctx = JaxStepContext(jmod, p, losses_state, jax.random.PRNGKey(0),
                             training=True)
        loss = jmod.training_step(ctx, (jnp.asarray(x), jnp.asarray(y)))
        return loss, ctx.logged["moe_aux"]

    (want, want_aux), wgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))

    tmod = GPTLightningModule(GPTConfig(**MOE_TINY, dtype=torch.float32))
    tmod.setup_model("cpu")
    assert tmod.model.remat_policy == "dots"
    assert [hasattr(b, "moe") for b in tmod.model.h] == [False, True]
    tmod.model.load_state_dict(flax_to_torch(params))
    named = dict(tmod.model.named_parameters())
    ctx = StepContext(tmod, training=True, rng=(0, 0, 0))
    loss = tmod.training_step(ctx, (torch.from_numpy(x),
                                    torch.from_numpy(y)))
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    _close(float(loss), float(want), "loss")
    _close(float(ctx.logged["moe_aux"]), float(want_aux), "moe_aux")
    wgrads = flax_to_torch(jax.device_get(wgrads))
    assert set(grads) == set(wgrads)
    for k, g in grads.items():
        _close(g.numpy(), wgrads[k].float().numpy(), k)

    kw = dict(warmup_steps=0, batch_size=4, lr=1e-3)
    jfix = _JaxFixed(params, config=JaxConfig(**MOE_TINY,
                                              dtype=jnp.float32), **kw)
    jfix.setup_model()
    jtx = jfix.configure_optimizers()
    jstate = jax_init_fn(jfix, jtx)(jax.random.PRNGKey(0), batches[0])
    jstep = jax.jit(jax_train_step(jfix, jtx))
    tfix = _TorchFixed(params, config=GPTConfig(**MOE_TINY,
                                                dtype=torch.float32), **kw)
    ttx = tfix.configure_optimizers()
    tfix.setup_model("cpu")
    tstate = build_init_fn(tfix, ttx)(torch.Generator().manual_seed(0))
    tstep = build_train_step(tfix, ttx)
    for i, (bx, by) in enumerate(batches):
        jstate, jm = jstep(jstate, (jnp.asarray(bx), jnp.asarray(by)))
        tstate, tm = tstep(tstate, (torch.from_numpy(bx),
                                    torch.from_numpy(by)))
        _close(float(tm["loss"]), float(jm["loss"]), f"step {i}")
        _close(float(tm["moe_aux"]), float(jm["moe_aux"]), f"aux {i}")


class _Track(Callback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, outputs, batch, idx):
        self.losses.append(float(outputs["loss"]))


def test_moe_tiny_fit_loss_falls_and_checkpoint_roundtrips(tmp_path):
    """The JAX ``test_moe_gpt_loss_decreases`` and
    ``test_moe_checkpoint_roundtrip`` on the port: two epochs of
    moe-tiny at lr 1e-2 take the mean of the last 4 losses 0.3 below the
    first 4's, ``moe_aux`` reaches ``callback_metrics``; a saved fit
    resumes and trains on with a finite loss."""
    track = _Track()
    module = GPTLightningModule("moe-tiny", dataset_size=128, batch_size=8,
                                lr=1e-2)
    trainer = Trainer(max_epochs=2, enable_checkpointing=False, logger=False,
                      num_sanity_val_steps=0, limit_val_batches=0,
                      callbacks=[track], device="cpu")
    trainer.fit(module)
    assert np.mean(track.losses[-4:]) < np.mean(track.losses[:4]) - 0.3, \
        track.losses
    assert 0.5 <= float(trainer.callback_metrics["moe_aux"]) <= 8.0
    assert total_aux_loss(module.model) is not None

    small = GPTLightningModule("moe-tiny", dataset_size=32, batch_size=8)
    t1 = Trainer(max_epochs=1, max_steps=2, enable_checkpointing=False,
                 logger=False, num_sanity_val_steps=0, limit_val_batches=0,
                 device="cpu")
    t1.fit(small)
    path = str(tmp_path / "moe.ckpt")
    t1.save_checkpoint(path)
    saved = {k: v.clone() for k, v in small.model.state_dict().items()}
    assert any(k.endswith("moe.w1") for k in saved)
    again = GPTLightningModule("moe-tiny", dataset_size=32, batch_size=8)
    t2 = Trainer(max_epochs=2, enable_checkpointing=False, logger=False,
                 num_sanity_val_steps=0, limit_val_batches=0, device="cpu",
                 max_steps=3)
    t2.fit(again, ckpt_path=path)
    assert t2.global_step == 3
    assert np.isfinite(float(t2.callback_metrics["loss"]))


def test_moe_configs_build_and_what_stays_refused():
    """gpt2-moe-8e builds (meta device: no storage) with its routed
    blocks every second layer and "dots"; serving and speculation reject
    MoE, as in the JAX package; ``moe_partition_rules`` are the JAX
    function's (patterns and specs), and a rule set that splits the
    router on ``expert`` (expert parallelism is tests/test_torch_expert.
    py's) raises at set-up."""
    cfg = CONFIGS["gpt2-moe-8e"]
    module = GPTLightningModule("gpt2-moe-8e")
    model = module.configure_model("meta")
    assert model.remat_policy == "dots"
    assert [hasattr(b, "moe") for b in model.h] == [i % 2 == 1 for i in
                                                    range(cfg.n_layer)]
    assert tuple(model.h[1].moe.w1.shape) == (8, 768, 3072)
    with pytest.raises(ValueError, match="MoE"):
        module.configure_decode_model("cpu")
    with pytest.raises(ValueError, match="MoE"):
        module.configure_draft(device="cpu")
    from ray_lightning_tpu.ops.moe import moe_partition_rules as jax_rules
    from ray_lightning_tpu_torch.parallel.strategy import SpmdStrategy
    assert [(r, tuple(spec)) for r, spec in moe_partition_rules()] == \
        [(r, tuple(spec)) for r, spec in jax_rules()]
    from ray_lightning_tpu_torch.parallel.layout import ShardLayout
    from ray_lightning_tpu_torch.parallel.mesh import Mesh
    tiny = GPTLightningModule("moe-tiny").configure_model("meta")
    names = ("data", "expert")
    with pytest.raises(ValueError, match="expert"):
        ShardLayout({k: tuple(p.shape) for k, p in tiny.named_parameters()},
                    SpmdStrategy([("moe/router$", (None, "expert"))]
                                 + moe_partition_rules(), names,
                                 {"expert": 2}),
                    Mesh.abstract(names, {"data": 1, "expert": 2})
                    ).check_local_plan(tiny)
    with pytest.raises(ValueError, match="top_k"):
        MoEMLP(8, 2, 16, top_k=3)
    tagged = GPTLightningModule(dataclasses.replace(
        CONFIGS["moe-tiny"], remat=True, remat_policy="dots_moe"))
    assert tagged.configure_model("cpu").h[1].moe.tag_names
