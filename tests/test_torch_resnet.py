"""PyTorch/CUDA port, the ResNet slice: ``ray_lightning_tpu_torch.models.
resnet`` against the JAX package's ``models/resnet.py`` on the same
weights (flax variables from numpy draws, converted with
``flax_to_torch``) and inputs.

- (a) forward: train-mode logits and the new ``batch_stats``, then
  eval-mode logits from the running statistics, for the basic block,
  the bottleneck and the ImageNet stem (at 64x64: its (2, 3) padding and
  the -inf max pool), in fp32 and bf16; each block alone at stride 2
  (flax's SAME pads (0, 1) there, which torch's ``padding=1`` does not
  give); SAME's pads against ``lax.padtype_to_pads``; one ``resnet50``
  forward at full width, B=2, fp32;
- (b) the optimizer: ``chain(add_decayed_weights, SGD(momentum,
  nesterov))`` against eager optax bit for bit, its state carried from
  JAX to the port mid-run (``flax_opt_state_to_torch``) and back
  (``torch_to_flax``);
- (c) ``Trainer.fit`` (2 epochs of 3 steps) against the JAX ``Trainer``
  from the same weights: losses, params and running statistics, in fp32,
  in bf16, and with ``accumulate_grad_batches=2`` (the statistics move
  once per microbatch, as the JAX scan threads ``model_state``); a JAX
  checkpoint carried across by ``jax_checkpoint_to_torch`` resumes as
  the JAX resume does;
- (d) the JAX ResNet tests' behaviours (tests/test_models.py): the
  running means move, eval ignores the batch mix, the model learns on
  ``synthetic_cifar10``, ``resnet50`` is the default config, the data
  are separable and equal to the JAX draws; ``predict`` is the eval
  forward.

Tolerances: fp32 2e-5 and bf16 2e-2, as ``atol = rtol``
(tests/test_ops.py).  The models are 2 stages of width 8 but for the one
full-width forward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models import resnet as jres
from ray_lightning_tpu_torch import Callback, Trainer, jax_checkpoint_to_torch
from ray_lightning_tpu_torch.convert import (flax_opt_state_to_torch,
                                             flax_to_torch, torch_to_flax)
from ray_lightning_tpu_torch.models import resnet as tres
from ray_lightning_tpu_torch.ops.optim import (SGD, ChainState,
                                               add_decayed_weights, chain)

#: dtype name -> (JAX dtype, torch dtype, atol = rtol)
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
#: the tiny configs: 2 stages of width 8 (stage 1 opens at stride 2)
TINY = dict(stage_sizes=(1, 1), width=8)
#: 3 steps an epoch (12 samples at batch 4), a validation batch after
#: each epoch
MODULE_KW = dict(lr=0.05, batch_size=4, train_size=12, val_size=8)
FIT = dict(max_epochs=2, limit_val_batches=1, num_sanity_val_steps=0,
           log_every_n_steps=1, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(dtype: str = "float32", **kw):
    """The JAX and the port's ``ResNetConfig`` of the same shape."""
    jdt, tdt, _ = DTYPES[dtype]
    return (jres.ResNetConfig(**{**TINY, **kw}, dtype=jdt),
            tres.ResNetConfig(**{**TINY, **kw}, dtype=tdt))


def seeded_variables(model: fnn.Module, x: np.ndarray, *args,
                     seed: int = 0, last_scale: float = 1.0) -> dict:
    """The flax variables of ``model`` (its tree from ``jax.eval_shape``,
    which compiles nothing), every leaf drawn from numpy: kernels at
    lecun scale, BatchNorm scales near 1, biases and means near 0,
    variances near 1, so no statistic is trivial.  ``last_scale``
    scales the last BatchNorm of each bottleneck block (flax's init
    zeroes it) and so each residual branch."""
    shapes = jax.eval_shape(lambda r: model.init(r, jnp.asarray(x), *args),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        noise = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return noise / np.sqrt(np.prod(s.shape[:-1]))
        if name in ("scale", "var"):
            last = name == "scale" and path[-2].key == "BatchNorm_2"
            return (1.0 + 0.2 * np.abs(noise)) * (last_scale if last
                                                  else 1.0)
        return 0.1 * noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def images(n: int, size: int = 32, channels: int = 3, seed: int = 1):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, channels)).astype(np.float32)


def assert_close(got: torch.Tensor, want, tol: float, what: str = ""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def assert_stats_close(model: torch.nn.Module, stats: dict, tol: float):
    """Each running buffer of ``model`` against the JAX ``batch_stats``."""
    want = flax_to_torch({"params": {}, "batch_stats": jax.device_get(
        stats)})
    got = {k: v for k, v in model.state_dict().items() if "running" in k}
    assert set(got) == set(want)
    for k, v in want.items():
        assert_close(got[k], v, tol, k)


# -- (a) forward -------------------------------------------------------------

#: case -> (config keywords, image size)
FORWARD = {"basic": (dict(bottleneck=False), 32),
           "bottleneck": (dict(bottleneck=True), 32),
           "imagenet_stem": (dict(bottleneck=False, cifar_stem=False), 64)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(FORWARD))
def test_forward_and_batch_stats_match_jax(case, dtype):
    """Train-mode logits and the updated ``batch_stats`` (moments of the
    batch in fp32, the biased variance into the running one), then
    eval-mode logits from the given running statistics."""
    kw, size = FORWARD[case]
    jcfg, tcfg = configs(dtype, **kw)
    _, _, tol = DTYPES[dtype]
    x = images(4, size)
    jm = jres.ResNet(jcfg)
    variables = seeded_variables(jm, x, False)
    logits, new = jax.jit(lambda v, x: jm.apply(
        v, x, True, mutable=["batch_stats"]))(variables, x)
    eval_logits = jax.jit(lambda v, x: jm.apply(v, x, False))(variables, x)

    tm = tres.ResNet(tcfg, device="cpu")
    state = flax_to_torch(variables)
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state)
    got = tm(torch.from_numpy(x), True)
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    assert_close(got, logits, tol, "train logits")
    assert_stats_close(tm, new["batch_stats"], tol)
    tm.load_state_dict(state)
    with torch.no_grad():
        assert_close(tm(torch.from_numpy(x), False), eval_logits, tol,
                     "eval logits")


@pytest.mark.parametrize("block", ["ResNetBlock", "BottleneckBlock"])
def test_block_at_stride_2_matches_jax(block):
    """One block at stride 2 on 32x32 (the 3x3 conv pads (0, 1), the
    projection nothing): output and ``batch_stats`` in fp32.  Torch's
    symmetric ``padding=1`` would shift every window by one row and
    column: the test sees that."""
    x = images(4, 32, channels=16)
    jb = getattr(jres, block)(8, 2, jnp.float32)
    variables = seeded_variables(jb, x, True)
    out, new = jb.apply(variables, jnp.asarray(x), True,
                        mutable=["batch_stats"])
    tb = getattr(tres, block)(16, 8, 2, torch.float32)
    state = flax_to_torch(variables)
    tb.load_state_dict(state)
    got = tb(torch.from_numpy(x).permute(0, 3, 1, 2), True)
    want = np.asarray(out).transpose(0, 3, 1, 2)
    assert_close(got, want, 2e-5, "block output")
    assert_stats_close(tb, new["batch_stats"], 2e-5)

    conv = tb.Conv_0 if block == "ResNetBlock" else tb.Conv_1
    sym = torch.nn.functional.conv2d
    conv.forward = lambda t, c=conv: sym(t, c.weight, stride=2, padding=1)
    tb.load_state_dict(state)
    moved = tb(torch.from_numpy(x).permute(0, 3, 1, 2), True)
    assert np.abs(moved.detach().numpy() - want).max() > 1e-2


@pytest.mark.parametrize("size,kernel,stride", [
    (32, 3, 2), (32, 3, 1), (32, 1, 2), (224, 7, 2), (112, 3, 2),
    (64, 7, 2), (7, 3, 2), (33, 3, 2)])
def test_same_pads_match_lax(size, kernel, stride):
    want = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert tres.same_pads(size, kernel, stride) == tuple(want[0])


def test_max_pool_pads_with_neg_inf():
    """The ImageNet stem's 3x3 stride-2 SAME max pool on an all-negative
    map: a zero pad would show up as 0 on the high border."""
    x = -1.0 - np.abs(images(2, 16, channels=4))
    want = fnn.max_pool(jnp.asarray(x), (3, 3), (2, 2), padding="SAME")
    t, pad = tres._pad_same(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2,
                            value=-float("inf"))
    got = torch.nn.functional.max_pool2d(t, 3, 2, padding=pad)
    assert_close(got.permute(0, 2, 3, 1), want, 0.0)
    assert float(got.max()) < 0


def test_resnet50_full_width_forward_fp32():
    """``resnet50`` at full width (CIFAR stem, 16 blocks, 2048 features),
    B=2, fp32: train logits and every running statistic.  The residual
    branches enter at a tenth (the last BatchNorm's scale, which flax
    starts at 0): at full weight the stream grows over the 16 blocks,
    ``E[x^2] - E[x]^2`` over 32 values a channel cancels in fp32, and
    the two packages' summation orders put the logits up to 1.1e-4
    apart."""
    jcfg = dataclasses.replace(jres.CONFIGS["resnet50"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tres.CONFIGS["resnet50"],
                               dtype=torch.float32)
    x = images(2)
    jm = jres.ResNet(jcfg)
    variables = seeded_variables(jm, x, False, last_scale=0.1)
    logits, new = jax.jit(lambda v, x: jm.apply(
        v, x, True, mutable=["batch_stats"]))(variables, x)
    tm = tres.ResNet(tcfg, device="cpu")
    tm.load_state_dict(flax_to_torch(variables))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), True)
    assert sum(p.numel() for p in tm.parameters()) == sum(
        np.prod(a.shape) for a in jax.tree_util.tree_leaves(
            variables["params"]))
    assert_close(got, logits, 2e-5, "logits")
    assert_stats_close(tm, new["batch_stats"], 2e-5)


# -- (b) the optimizer -------------------------------------------------------

@pytest.mark.parametrize("momentum,nesterov", [(0.9, True), (0.9, False),
                                               (None, False)])
def test_resnet_optimizer_matches_optax_both_ways(momentum, nesterov):
    """``chain(add_decayed_weights(1e-4), SGD(0.1, momentum, nesterov))``
    against eager optax on the same fp32 params and gradients, bit for
    bit: 2 optax steps, the state converted to the port, 2 steps on both,
    the port's state converted back, 2 more steps on both."""
    rng = np.random.default_rng(0)
    params = {"stem": {"kernel": rng.standard_normal(
        (3, 3, 3, 8)).astype(np.float32)},
        "head": {"kernel": rng.standard_normal((8, 10)).astype(np.float32),
                 "bias": rng.standard_normal(10).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        for _ in range(6)]
    jtx = optax.chain(optax.add_decayed_weights(1e-4),
                      optax.sgd(0.1, momentum=momentum, nesterov=nesterov))
    ttx = chain(add_decayed_weights(1e-4),
                SGD(0.1, momentum=momentum, nesterov=nesterov))

    def jstep(p, s, g):
        u, s = jtx.update(g, s, p)
        return optax.apply_updates(p, u), s

    p = jax.tree_util.tree_map(jnp.asarray, params)
    s = jtx.init(p)
    for g in grads[:2]:
        p, s = jstep(p, s, g)
    tp = flax_to_torch(jax.device_get(p))
    ts = flax_opt_state_to_torch(jax.device_get(s))
    assert isinstance(ts, ChainState)
    assert ts.state_dict().keys() == ttx.init(tp).state_dict().keys()
    for g in grads[2:4]:
        p, s = jstep(p, s, g)
        ttx.update(flax_to_torch(g), ts, tp)
    for k, v in flax_to_torch(jax.device_get(p)).items():
        assert torch.equal(tp[k], v), k
    if momentum is not None:
        for k, v in flax_to_torch(jax.device_get(s[1][0].trace)).items():
            assert torch.equal(ts.states[1].trace[k], v), k
        back = (optax.EmptyState(), (optax.TraceState(
            trace=torch_to_flax(ts.states[1].trace, params)),
            optax.EmptyState()))
    else:
        back = jtx.init(params)
    p2 = torch_to_flax(tp, params)
    for g in grads[4:]:
        p, s = jstep(p, s, g)
        p2, back = jstep(p2, back, g)
    for a, b in zip(jax.tree_util.tree_leaves(p),
                    jax.tree_util.tree_leaves(p2)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


# -- (c) fits against the JAX Trainer ------------------------------------------

class JaxFixedResNet(jres.ResNetLightningModule):
    """The JAX module starting from given variables."""

    def __init__(self, variables, **kw):
        super().__init__(**kw)
        self._variables = variables

    def init_params(self, rng, batch):
        return jax.tree_util.tree_map(jnp.asarray, self._variables)


class FixedResNet(tres.ResNetLightningModule):
    """The port's module starting from the same variables."""

    def __init__(self, variables, **kw):
        super().__init__(**kw)
        self._state = flax_to_torch(variables)

    def init_params(self, generator):
        self.setup_model(generator.device)
        self.model.load_state_dict(self._state)
        return self.model.state_dict()


def _losses(base):
    class Losses(base):
        def __init__(self):
            self.losses = []

        def on_train_batch_end(self, trainer, module, outputs, batch, i):
            self.losses.append(float(outputs["loss"]))

    return Losses()


def _fit_pair(dtype: str, root, accumulate: int = 1, ckpt: bool = False):
    """A 2-epoch fit of the tiny basic-block ResNet in both packages
    from the same variables."""
    jcfg, tcfg = configs(dtype, bottleneck=False)
    variables = seeded_variables(jres.ResNet(jcfg), images(1), False)
    batch = MODULE_KW["batch_size"] * accumulate
    kw = {**MODULE_KW, "batch_size": batch,
          "train_size": 3 * batch}
    common = dict(**FIT, accumulate_grad_batches=accumulate,
                  enable_checkpointing=ckpt)
    jrec, trec = _losses(JaxCallback), _losses(Callback)
    jt = JaxTrainer(callbacks=[jrec], logger=False,
                    default_root_dir=str(root / "jax"), **common)
    jmod = JaxFixedResNet(variables, config=jcfg, **kw)
    jt.fit(jmod)
    tt = Trainer(callbacks=[trec], logger=False, device="cpu",
                 default_root_dir=str(root / "torch"), **common)
    tmod = FixedResNet(variables, config=tcfg, **kw)
    tt.fit(tmod)
    return dict(jt=jt, jmod=jmod, jrec=jrec, tt=tt, tmod=tmod, trec=trec,
                variables=variables, config=(jcfg, tcfg), kw=kw)


def assert_fits_close(run: dict, tol: float) -> None:
    jt, tt = run["jt"], run["tt"]
    assert len(run["trec"].losses) == len(run["jrec"].losses) == 6
    np.testing.assert_allclose(run["trec"].losses, run["jrec"].losses,
                               atol=tol, rtol=tol)
    assert (tt.global_step, tt.current_epoch) == (jt.global_step,
                                                  jt.current_epoch) == (6, 2)
    assert set(tt.callback_metrics) == set(jt.callback_metrics)
    for k, v in jt.callback_metrics.items():
        np.testing.assert_allclose(tt.callback_metrics[k], v, atol=tol,
                                   rtol=tol, err_msg=k)
    want = flax_to_torch(jax.device_get(run["jmod"]._trained_variables[
        "params"]))
    got = run["tmod"]._trained_state
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert_close(got[k], v, tol, k)
    assert_stats_close(run["tmod"].model, run["jmod"]._trained_variables[
        "model_state"]["batch_stats"], tol)


@pytest.fixture(scope="module")
def fp32_fits(tmp_path_factory):
    return _fit_pair("float32", tmp_path_factory.mktemp("fp32"), ckpt=True)


def test_fit_matches_jax_trainer_fp32(fp32_fits):
    """2 epochs of 3 steps in fp32, each package's checkpointing on:
    per-step losses, metrics, counters, every parameter and running
    statistic within 2e-5."""
    assert_fits_close(fp32_fits, 2e-5)


@pytest.mark.parametrize("dtype,accumulate", [("bfloat16", 1),
                                              ("float32", 2)])
def test_fit_matches_jax_trainer(dtype, accumulate, tmp_path):
    """bf16 compute within 2e-2; and ``accumulate_grad_batches=2`` in
    fp32 within 2e-5: two microbatch forwards a step, each moving the
    running statistics, as the JAX step's scan does."""
    assert_fits_close(_fit_pair(dtype, tmp_path, accumulate),
                      DTYPES[dtype][2])


def test_jax_checkpoint_resumes_as_jax_does(fp32_fits, tmp_path):
    """The JAX fit's checkpoint (params, ``batch_stats``, the ``chain(
    add_decayed_weights, sgd)`` state with its trace), decoded with
    flax's msgpack reader and converted by ``jax_checkpoint_to_torch``,
    resumes in the port (``max_epochs=3``) as the JAX resume does:
    losses, counters, params and running statistics within 2e-5."""
    best = fp32_fits["jt"].checkpoint_callback.best_model_path
    ckpt = jax_checkpoint_to_torch(JaxTrainer.load_checkpoint_dict(best))
    assert sorted(ckpt["state"]["opt_state"]) == ["0", "1"]
    assert sorted(ckpt["state"]["opt_state"]["1"]) == ["trace"]
    assert set(ckpt["state"]["model_state"]) == {
        k for k in fp32_fits["tmod"].model.state_dict() if "running" in k}
    path = str(tmp_path / "from_jax.ckpt")
    torch.save(ckpt, path)
    jcfg, tcfg = fp32_fits["config"]
    kw = fp32_fits["kw"]
    common = dict(FIT, max_epochs=3, enable_checkpointing=False)
    jrec, trec = _losses(JaxCallback), _losses(Callback)
    jt = JaxTrainer(callbacks=[jrec], logger=False,
                    default_root_dir=str(tmp_path / "jax"), **common)
    jmod = jres.ResNetLightningModule(jcfg, **kw)
    jt.fit(jmod, ckpt_path=best)
    tt = Trainer(callbacks=[trec], logger=False, device="cpu",
                 default_root_dir=str(tmp_path / "torch"), **common)
    tmod = tres.ResNetLightningModule(tcfg, **kw)
    tt.fit(tmod, ckpt_path=path)
    assert len(trec.losses) == len(jrec.losses) > 0
    np.testing.assert_allclose(trec.losses, jrec.losses, atol=2e-5,
                               rtol=2e-5)
    assert (tt.global_step, tt.current_epoch) == (jt.global_step,
                                                  jt.current_epoch)
    for k, v in flax_to_torch(jax.device_get(
            jmod._trained_variables["params"])).items():
        assert_close(tmod._trained_state[k], v, 2e-5, k)
    assert_stats_close(tmod.model, jmod._trained_variables["model_state"][
        "batch_stats"], 2e-5)


# -- (d) behaviours -------------------------------------------------------------

def tiny_module(**kw):
    kw.setdefault("lr", 0.05)
    return tres.ResNetLightningModule(configs("bfloat16",
                                              bottleneck=False)[1],
                                      batch_size=8, train_size=64,
                                      val_size=32, **kw)


def small_trainer(tmp_path, max_epochs=1, **kw):
    kw.setdefault("limit_train_batches", 6)
    kw.setdefault("limit_val_batches", 2)
    return Trainer(max_epochs=max_epochs, num_sanity_val_steps=0,
                   enable_checkpointing=False, logger=False, seed=0,
                   device="cpu", default_root_dir=str(tmp_path), **kw)


def test_resnet_trains_and_running_means_move(tmp_path):
    """The running means leave their zero init (the variances start at
    1, so only the means tell), and the driver's state carries them."""
    module = tiny_module()
    trainer = small_trainer(tmp_path, max_epochs=2)
    trainer.fit(module)
    assert np.isfinite(trainer.callback_metrics["loss"])
    means = [v for k, v in module._trained_state.items()
             if k.endswith("running_mean")]
    assert len(means) == 6
    assert sum(float(m.abs().sum()) for m in means) > 0


def test_resnet_learns(tmp_path):
    module = tiny_module(lr=0.2)
    trainer = small_trainer(tmp_path, max_epochs=10,
                            limit_train_batches=None)
    trainer.fit(module)
    assert trainer.callback_metrics["train_accuracy"] > 0.5


def test_eval_uses_running_stats_and_predict_is_the_eval_forward(tmp_path):
    """In eval an image's logits do not depend on the batch it rides in;
    ``predict`` over 2 batches is the argmax of ``ResNet(x, train=False)``
    on the trained weights."""
    module = tiny_module()
    trainer = small_trainer(tmp_path, limit_predict_batches=2)
    trainer.fit(module)
    model = module.model
    x = torch.from_numpy(tres.synthetic_cifar10(8, seed=3).take(
        np.arange(8))[0])
    with torch.no_grad():
        solo = model(x[:1], False)
        mixed = model(x, False)[:1]
    np.testing.assert_allclose(solo.numpy(), mixed.numpy(), rtol=2e-2,
                               atol=2e-2)
    preds = trainer.predict(module)
    xs = torch.from_numpy(tres.synthetic_cifar10(32, seed=2).take(
        np.arange(16))[0])
    with torch.no_grad():
        want = model(xs, False).argmax(-1)
    assert torch.equal(torch.cat(preds), want)


def test_resnet50_config_is_default():
    m = tres.ResNetLightningModule()
    assert m.config.stage_sizes == (3, 4, 6, 3) and m.config.bottleneck
    assert m.config == tres.CONFIGS["resnet50"]
    assert m.config.dtype == torch.bfloat16
    for name, cfg in jres.CONFIGS.items():
        ours = tres.CONFIGS[name]
        assert (ours.stage_sizes, ours.bottleneck, ours.num_classes,
                ours.width, ours.cifar_stem) == (
            cfg.stage_sizes, cfg.bottleneck, cfg.num_classes, cfg.width,
            cfg.cifar_stem)


def test_synthetic_cifar_is_separable_and_the_jax_draws():
    """The JAX dataset element for element; nearest-class-mean on
    held-out draws beats chance by a wide margin."""
    for n, seed in ((512, 0), (128, 9)):
        a = tres.synthetic_cifar10(n, seed).take(np.arange(n))
        b = jres.synthetic_cifar10(n, seed).take(np.arange(n))
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    xtr, ytr = tres.synthetic_cifar10(512, seed=0).take(np.arange(512))
    xte, yte = tres.synthetic_cifar10(128, seed=9).take(np.arange(128))
    assert xtr.shape == (512, 32, 32, 3)
    means = np.stack([xtr[ytr == c].mean(axis=0) for c in range(10)])
    d = ((xte[:, None] - means[None]) ** 2).sum(axis=(2, 3, 4))
    assert (d.argmin(axis=1) == yte).mean() > 0.8
