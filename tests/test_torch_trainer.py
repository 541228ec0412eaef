"""PyTorch/CUDA port, the rest of the single-device ``Trainer``: the
behaviours of ``tests/test_trainer_local.py`` that the port covers, on
the port's ``BoringModel`` / ``LightningMNISTClassifier`` against the JAX
ones on the same numpy-seeded weights.

- fit (per-batch losses, ``callback_metrics``, the loss falls),
  validate / test, predict, ``max_steps``, gradient accumulation, the
  MNIST classifier's learning signal;
- ``gradient_clip_val``: ``chain(clip_by_global_norm, ...)`` against
  ``optax.chain(optax.clip_by_global_norm, ...)``, with a norm that
  triggers and one that does not;
- the bf16 batch cast against the JAX ``Trainer._host_cast``, every
  precision spelling;
- the global steps at which ``val_check_interval`` validates;
- ``datamodule=`` on fit, validate, test and predict;
- ``metrics.csv``: header and rows against the JAX ``CSVLogger``;
- dropout: one train step's loss and gradients against the JAX module
  with the same keep-masks injected on both sides, and the eval forward
  at dropout 0.1 equal to the one at 0.0;
- ``Trainer(device="cpu").fit(...)`` with its defaults (checkpoint and
  CSV logger on).

Tolerances: fp32 2e-5 and bf16 2e-2 as ``atol = rtol``, except where a
test states another.
"""

import csv
import os
import types

import flax.linen.stochastic
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
from ray_lightning_tpu.core.data import DataLoader as JaxDataLoader
from ray_lightning_tpu.core.datamodule import (
    LightningDataModule as JaxDataModule)
from ray_lightning_tpu.core.module import StepContext as JaxStepContext
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.boring import BoringModel as JaxBoring
from ray_lightning_tpu.models.boring import RandomDataset as JaxRandomDataset
from ray_lightning_tpu.models.boring import (
    LightningMNISTClassifier as JaxMNIST)
from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
from ray_lightning_tpu.models.gpt import GPTLightningModule as JaxModule
from ray_lightning_tpu.ops.optim import fp32_master as jax_fp32_master
from ray_lightning_tpu.utils.logger import CSVLogger as JaxCSVLogger
from ray_lightning_tpu_torch import (BoringModel, Callback, CSVLogger,
                                     DataLoader, LightningDataModule,
                                     LightningMNISTClassifier, Trainer)
from ray_lightning_tpu_torch.convert import flax_to_torch
from ray_lightning_tpu_torch.core.data import to_device
from ray_lightning_tpu_torch.core.module import StepContext
from ray_lightning_tpu_torch.models.boring import RandomDataset
from ray_lightning_tpu_torch.models.gpt import GPTConfig, GPTLightningModule
from ray_lightning_tpu_torch.ops import attention as tattention
from ray_lightning_tpu_torch.ops.optim import (AdamW, chain,
                                               clip_by_global_norm,
                                               fp32_master)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
#: test_trainer_local.py's ``get_trainer`` settings
LOCAL = dict(limit_val_batches=2, num_sanity_val_steps=0,
             log_every_n_steps=1, seed=0)
FP32 = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense_params(sizes, seed=1):
    """Seeded flax ``Dense_{i}`` params: kernels N(0, 1/fan_in), biases
    N(0, 0.01)."""
    rng = np.random.default_rng(seed)
    return {f"Dense_{i}": {
        "kernel": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(
            np.float32),
        "bias": (rng.standard_normal(b) * 0.1).astype(np.float32)}
        for i, (a, b) in enumerate(zip(sizes, sizes[1:]))}


def _fixed(base, params, jax_side: bool):
    """``base`` (a module class of either package) starting from
    ``params`` (a flax tree; converted for the port)."""
    if jax_side:
        class Fixed(base):
            def init_params(self, rng, batch):
                return {"params": jax.tree_util.tree_map(jnp.asarray,
                                                         params)}
    else:
        state = flax_to_torch(params)

        class Fixed(base):
            def init_params(self, generator):
                self.setup_model(generator.device)
                self.model.load_state_dict(state)
                return self.model.state_dict()
    return Fixed


def _boring(jax_side: bool, **kw):
    base = JaxBoring if jax_side else BoringModel
    return _fixed(base, _dense_params((32, 2)), jax_side)(**kw)


def _mnist(jax_side: bool, **kw):
    base = JaxMNIST if jax_side else LightningMNISTClassifier
    return _fixed(base, _dense_params((784, 128, 256, 10)), jax_side)(**kw)


def _recorder(jax_side: bool):
    """A callback recording each train step's loss and the global step of
    each validation outside the sanity check."""
    class Record(JaxCallback if jax_side else Callback):
        def __init__(self):
            self.losses, self.val_steps = [], []

        def on_train_batch_end(self, trainer, module, outputs, batch, i):
            self.losses.append(float(outputs["loss"]))

        def on_validation_end(self, trainer, module):
            if not trainer.sanity_checking:
                self.val_steps.append(trainer.global_step)

    return Record()


def _both(make, root, stage="fit", **kw):
    """``make(jax_side)`` through each package's Trainer: per side the
    trainer, the module, the recorder and the stage's result."""
    out = {}
    for side in ("jax", "torch"):
        rec = _recorder(side == "jax")
        extra = (dict(logger=False) if side == "jax"
                 else dict(device="cpu"))
        t = (JaxTrainer if side == "jax" else Trainer)(
            callbacks=[rec], default_root_dir=str(root / side),
            enable_checkpointing=False, **{**LOCAL, **kw}, **extra)
        mod = make(side == "jax")
        res = getattr(t, stage)(mod)
        out[side] = types.SimpleNamespace(trainer=t, module=mod, rec=rec,
                                          result=res)
    return out["jax"], out["torch"]


def _close(got, want, tol=FP32, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=tol, err_msg=msg)


# -- fit, stages, max_steps, accumulation -------------------------------------

def test_fit_matches_jax_and_loss_falls(tmp_path):
    """3 epochs of 16 steps at lr 0.05 (test_loss_decreases): the same
    per-batch losses and ``callback_metrics``, and the epoch's mean loss
    below 1.0."""
    j, t = _both(lambda s: _boring(s, lr=0.05), tmp_path, max_epochs=3,
                 limit_train_batches=16)
    assert len(t.rec.losses) == len(j.rec.losses) == 48
    _close(t.rec.losses, j.rec.losses)
    assert set(t.trainer.callback_metrics) == set(
        j.trainer.callback_metrics) == {"loss", "val_loss"}
    for k, v in j.trainer.callback_metrics.items():
        _close(t.trainer.callback_metrics[k], v, msg=k)
    assert t.trainer.callback_metrics["loss"] < 1.0
    assert (t.trainer.global_step, t.trainer.current_epoch) == (48, 3)


def test_validate_test_predict_match_jax(tmp_path):
    """After a fit, ``validate``, ``test`` and ``predict`` on the fitted
    module: the same metrics, and predictions of shape [2, 2] a batch
    (``limit_predict_batches=3``) equal to the JAX ones."""
    j, t = _both(lambda s: _boring(s), tmp_path, max_epochs=1,
                 limit_train_batches=10, limit_predict_batches=3)
    for stage, key in (("validate", "val_loss"), ("test", "test_loss")):
        got = getattr(t.trainer, stage)(t.module)
        want = getattr(j.trainer, stage)(j.module)
        assert len(got) == len(want) == 1 and set(got[0]) == {key}
        _close(got[0][key], want[0][key], msg=stage)
    got, want = t.trainer.predict(t.module), j.trainer.predict(j.module)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert tuple(g.shape) == np.asarray(w).shape == (2, 2)
        _close(g.numpy(), w)


@pytest.mark.parametrize("kw", [dict(max_epochs=10, max_steps=5),
                                dict(max_epochs=1, limit_train_batches=6,
                                     accumulate_grad_batches=2)],
                         ids=["max_steps", "accumulate"])
def test_max_steps_and_accumulation_match_jax(kw, tmp_path):
    """``max_steps`` stops at step 5; ``accumulate_grad_batches=2`` over
    batches of 4 takes one step a batch from two microbatches: the same
    losses and counters as the JAX trainer's."""
    j, t = _both(lambda s: _boring(s, batch_size=4), tmp_path, **kw)
    _close(t.rec.losses, j.rec.losses)
    assert (t.trainer.global_step, t.trainer.current_epoch) == (
        j.trainer.global_step, j.trainer.current_epoch)
    assert t.trainer.global_step == kw.get("max_steps", 6)


def test_mnist_learns_and_predicts_as_jax(tmp_path):
    """The MNIST classifier (Adam) over 3 epochs of 16 steps: the same
    per-batch losses as the JAX one's (fp32), prediction accuracy above
    0.5 on both (predict_test), and the two packages' predicted classes
    agreeing on 99% of the rows."""
    j, t = _both(lambda s: _mnist(s), tmp_path, max_epochs=3,
                 limit_train_batches=16, limit_val_batches=4)
    assert len(t.rec.losses) == 48
    _close(t.rec.losses, j.rec.losses)
    preds = {}
    for side, r in (("jax", j), ("torch", t)):
        out = r.trainer.predict(r.module)
        preds[side] = np.concatenate([np.asarray(o) for o in out])
        labels = np.concatenate([np.asarray(b[1]) for b in
                                 r.module.predict_dataloader()])
        assert (preds[side] == labels[:len(preds[side])]).mean() >= 0.5
    assert (preds["torch"] == preds["jax"]).mean() >= 0.99


# -- gradient clipping --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("triggers", [True, False])
def test_clip_step_matches_optax_chain(dtype, triggers):
    """One step of ``chain(clip_by_global_norm(m), tx)`` against eager
    ``optax.chain(optax.clip_by_global_norm(m), tx)``: AdamW on fp32
    params and gradients, and in bf16 ``fp32_master(AdamW)`` (mu in bf16)
    on bf16 params and gradients, clipped in bf16 before the master
    upcasts them.  ``m`` is half the gradients' norm (the clip scales
    them) or twice it (they pass as they are).  The clipped gradients,
    the params and the moments agree within the dtype's tolerance."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(3)
    shapes = {"a": (8, 16), "b": (16,), "c": (4, 4, 2)}
    p32 = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()}
    g32 = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()}
    jp = {k: jnp.asarray(v, jdt) for k, v in p32.items()}
    jg = {k: jnp.asarray(v, jdt) for k, v in g32.items()}
    norm = float(optax.global_norm(jg))
    max_norm = norm * (0.5 if triggers else 2.0)
    bf16 = dtype == "bfloat16"

    def adamw(mod):
        kw = dict(weight_decay=0.01, b1=0.9, b2=0.95)
        if mod is optax:
            inner = optax.adamw(1e-2, mu_dtype=jnp.bfloat16 if bf16
                                else None, **kw)
            return jax_fp32_master(inner) if bf16 else inner
        inner = AdamW(1e-2, mu_dtype=torch.bfloat16 if bf16 else None, **kw)
        return fp32_master(inner) if bf16 else inner

    jclip = optax.clip_by_global_norm(max_norm)
    want_g, _ = jclip.update(jg, jclip.init(jp))
    jtx = optax.chain(jclip, adamw(optax))
    upd, jstate = jtx.update(jg, jtx.init(jp), jp)
    want_p = optax.apply_updates(jp, upd)

    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p32.items()}
    tg = {k: torch.from_numpy(v).to(tdt) for k, v in g32.items()}
    clip = clip_by_global_norm(max_norm)
    got_g = clip.update(tg, clip.init(tp))
    tx = chain(clip, adamw(torch))
    state = tx.init(tp)
    tx.update(tg, state, tp)
    for k in shapes:
        assert got_g[k].dtype == tdt
        _close(got_g[k].float().numpy(), np.asarray(want_g[k], np.float32),
               tol, f"clipped {k}")
        if not triggers:
            assert torch.equal(got_g[k], tg[k])
        _close(tp[k].float().numpy(), np.asarray(want_p[k], np.float32),
               tol, f"param {k}")
    inner = state.states[1].inner if bf16 else state.states[1]
    jadam = (jstate[1].inner if bf16 else jstate[1])[0]
    for k in shapes:
        _close(inner.mu[k].float().numpy(),
               np.asarray(jadam.mu[k], np.float32), tol, f"mu {k}")
        _close(inner.nu[k].float().numpy(),
               np.asarray(jadam.nu[k], np.float32), tol, f"nu {k}")
    assert sorted(state.state_dict()) == ["0", "1"]


def test_gradient_clip_val_trains_as_jax(tmp_path):
    """``Trainer(gradient_clip_val=0.1)`` (test_gradient_clipping): the
    same per-batch losses as the JAX trainer's, finite, and other than
    the unclipped run's."""
    j, t = _both(lambda s: _boring(s), tmp_path, max_epochs=1,
                 limit_train_batches=10, gradient_clip_val=0.1)
    _close(t.rec.losses, j.rec.losses)
    assert np.isfinite(t.trainer.callback_metrics["loss"])
    _, free = _both(lambda s: _boring(s), tmp_path / "free", max_epochs=1,
                    limit_train_batches=10)
    assert free.rec.losses[1:] != t.rec.losses[1:]


# -- precision: the bf16 batch cast -------------------------------------------

@pytest.mark.parametrize("precision", ["32", "32-true", "64", "bf16",
                                       "bf16-mixed", "bf16-true", "16",
                                       "16-mixed", "16-true"])
def test_batch_cast_matches_host_cast(precision, tmp_path):
    """The port's batch on the device under each precision spelling
    equals the JAX ``Trainer._host_cast`` of the same numpy batch, bit
    for bit and in dtype: floating leaves in bf16 under the bf16
    spellings, integer leaves untouched."""
    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((4, 8)).astype(np.float32),
             {"ids": rng.integers(0, 9, (4, 3)).astype(np.int32),
              "w": rng.random(4).astype(np.float32)})
    jt = JaxTrainer(precision=precision, logger=False,
                    default_root_dir=str(tmp_path))
    want = jax.tree_util.tree_leaves(jt._host_cast(batch))
    t = Trainer(precision=precision, device="cpu", logger=False,
                default_root_dir=str(tmp_path))
    got = jax.tree_util.tree_leaves(
        to_device(batch, t.device, t.batch_float_dtype),
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert str(g.dtype).split(".")[-1] == w.dtype.name
        g = g.view(torch.int16) if g.dtype == torch.bfloat16 else g
        assert np.array_equal(g.numpy(), np.asarray(w).view(
            np.int16) if w.dtype.name == "bfloat16" else w)


# -- val_check_interval -------------------------------------------------------

@pytest.mark.parametrize("interval", [2, 3])
def test_val_check_interval_steps_match_jax(interval, tmp_path):
    """The global steps at which a validation runs: every ``interval``
    steps inside an epoch and at each epoch's end, as the JAX trainer
    runs them, and the same metrics after."""
    j, t = _both(lambda s: _boring(s), tmp_path, max_epochs=2,
                 limit_train_batches=5, val_check_interval=interval)
    want = sorted([s for s in range(1, 11) if s % interval == 0] + [5, 10])
    assert t.rec.val_steps == j.rec.val_steps == want
    for k, v in j.trainer.callback_metrics.items():
        _close(t.trainer.callback_metrics[k], v, msg=k)


# -- datamodules --------------------------------------------------------------

def _datamodule(jax_side: bool):
    """A datamodule of both packages over other data than the module's
    own loaders (seeds 11-14), counting its lifecycle calls."""
    base = JaxDataModule if jax_side else LightningDataModule
    loader, data = ((JaxDataLoader, JaxRandomDataset) if jax_side
                    else (DataLoader, RandomDataset))

    class DM(base):
        def __init__(self):
            super().__init__()
            self.calls = []

        def prepare_data(self):
            self.calls.append("prepare_data")

        def setup(self, stage):
            self.calls.append(f"setup {stage}")

        def _loader(self, seed):
            return loader(data(32, 8, seed), batch_size=2)

        def train_dataloader(self):
            return self._loader(11)

        def val_dataloader(self):
            return self._loader(12)

        def test_dataloader(self):
            return self._loader(13)

        def predict_dataloader(self):
            return self._loader(14)

    return DM()


@pytest.mark.parametrize("stage", ["fit", "validate", "test", "predict"])
def test_datamodule_stages_match_jax(stage, tmp_path):
    """Each stage with ``datamodule=``: the datamodule's loaders run (the
    result differs from the module's own loaders') and the result is the
    JAX trainer's on the same datamodule."""
    out = {}
    for side in ("jax", "torch"):
        jax_side = side == "jax"
        rec = _recorder(jax_side)
        extra = dict(logger=False) if jax_side else dict(device="cpu")
        t = (JaxTrainer if jax_side else Trainer)(
            callbacks=[rec], max_epochs=1, enable_checkpointing=False,
            default_root_dir=str(tmp_path / side), **LOCAL, **extra)
        dm = _datamodule(jax_side)
        res = getattr(t, stage)(_boring(jax_side), datamodule=dm)
        own = getattr(t, stage)(_boring(jax_side)) if not jax_side else None
        out[side] = (res, rec.losses, dm.calls, own)
    (jres, jlosses, jcalls, _), (tres, tlosses, tcalls, own) = (
        out["jax"], out["torch"])
    assert tcalls == jcalls == ["prepare_data", f"setup {stage}"]
    if stage == "fit":
        assert len(tlosses) == 4
        _close(tlosses, jlosses)
    elif stage == "predict":
        _close(torch.cat(tres).numpy(),
               np.concatenate([np.asarray(o) for o in jres]))
        assert not torch.equal(torch.cat(tres), torch.cat(own)[:8])
    else:
        (key,) = tres[0]
        _close(tres[0][key], jres[0][key])
        assert tres[0][key] != own[0][key]


# -- the CSV logger -----------------------------------------------------------

def test_csv_logger_writes_as_jax(tmp_path):
    """One sequence of ``log_metrics`` calls, with columns that appear
    late (the header rewrite) and rows that leave some out, through
    both packages' ``CSVLogger``: the same ``metrics.csv``, byte for
    byte; a new logger on the same directory starts the file anew."""
    calls = [({"loss": 0.5}, 1), ({"loss": 0.25, "acc": 0.5}, 2),
             ({"val_loss": 0.75}, 2), ({"loss": 0.125}, 3),
             ({"loss_epoch": 0.3, "skip": "x"}, 3)]
    text = {}
    for side, cls in (("jax", JaxCSVLogger), ("torch", CSVLogger)):
        logger = cls(str(tmp_path / side))
        for metrics, step in calls:
            logger.log_metrics(metrics, step)
        with open(logger.path) as f:
            text[side] = f.read()
        again = cls(str(tmp_path / side))
        again.log_metrics({"loss": 1.0}, 7)
        with open(again.path) as f:
            assert f.read() == "step,loss\n7,1.0\n"
    assert text["torch"] == text["jax"]
    assert text["torch"].splitlines()[0] == "step,loss,acc,val_loss," \
                                            "loss_epoch"
    assert len(text["torch"].splitlines()) == 1 + len(calls)
    assert os.listdir(tmp_path / "torch" / "logs") == ["metrics.csv"]


def test_trainer_metrics_csv_matches_jax(tmp_path):
    """A fit, then validate and test, each package with its default
    logger: ``metrics.csv`` has the same header and, row by row, the same
    steps and the same values within fp32's tolerance."""
    tables = {}
    for side in ("jax", "torch"):
        jax_side = side == "jax"
        kw = {} if jax_side else dict(device="cpu")
        t = (JaxTrainer if jax_side else Trainer)(
            max_epochs=2, limit_train_batches=3, enable_checkpointing=False,
            default_root_dir=str(tmp_path / side), **LOCAL, **kw)
        mod = _boring(jax_side)
        t.fit(mod)
        t.validate(mod)
        t.test(mod)
        with open(os.path.join(str(tmp_path / side), "logs",
                               "metrics.csv")) as f:
            tables[side] = list(csv.reader(f))
    want, got = tables["jax"], tables["torch"]
    assert got[0] == want[0] == ["step", "loss", "loss_epoch", "val_loss",
                                 "test_loss"]
    assert len(got) == len(want) == 1 + 6 + 2 + 3 + 1
    for g, w in zip(got[1:], want[1:]):
        assert [c == "" for c in g] == [c == "" for c in w]
        _close([float(c) for c in g if c], [float(c) for c in w if c])


# -- dropout ------------------------------------------------------------------

TINY = dict(vocab_size=512, block_size=64, n_layer=2, n_head=2, n_embd=64,
            remat=False, attention_impl="dot")


def _gpt_params():
    shapes = jax.eval_shape(lambda r: JaxGPT(JaxConfig(**TINY)).init(
        r, jnp.zeros((1, 8), jnp.int32))["params"], jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def leaf(path, x):
        name = path[-1].key
        if name in ("scale", "bias"):
            return np.full(x.shape, name == "scale", np.float32)
        return (rng.standard_normal(x.shape) * 0.02).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_step_matches_jax_with_injected_masks(dtype, monkeypatch):
    """One train step's loss and every gradient of the tiny GPT at dropout
    0.1, against the JAX module's, with the same keep-masks handed to
    both (the JAX side through flax's ``random.bernoulli``, the port's
    through ``dropout_keep_mask``), one per site in forward order: each
    layer's attention output, then its MLP."""
    jdt, tdt, tol = DTYPES[dtype]
    B, T, C, L = 2, 32, TINY["n_embd"], TINY["n_layer"]
    params = _gpt_params()
    rng = np.random.default_rng(5)
    toks = rng.integers(0, TINY["vocab_size"], (B, T + 1)).astype(np.int32)
    x, y = toks[:, :-1], toks[:, 1:]
    masks = [rng.random((B, T, C)) < 0.9 for _ in range(2 * L)]

    jqueue = list(masks)

    def bernoulli(key, p, shape):
        assert abs(p - 0.9) < 1e-12 and tuple(shape) == (B, T, C)
        return jnp.asarray(jqueue.pop(0))

    monkeypatch.setattr(flax.linen.stochastic, "random",
                        types.SimpleNamespace(bernoulli=bernoulli))
    jmod = JaxModule(JaxConfig(**TINY, dtype=jdt, dropout=0.1))
    jmod.setup_model()

    def jloss(p):
        ctx = JaxStepContext(jmod, p, {}, jax.random.PRNGKey(0),
                             training=True)
        return jmod.training_step(ctx, (jnp.asarray(x), jnp.asarray(y)))

    want, wgrads = jax.value_and_grad(jloss)(
        jax.tree_util.tree_map(jnp.asarray, params))
    assert not jqueue

    tqueue = [torch.from_numpy(m) for m in masks]

    def keep_mask(shape, keep_prob, seed, device):
        assert abs(keep_prob - 0.9) < 1e-12 and tuple(shape) == (B, T, C)
        return tqueue.pop(0)

    monkeypatch.setattr(tattention, "dropout_keep_mask", keep_mask)
    tmod = GPTLightningModule(GPTConfig(**TINY, dtype=tdt, dropout=0.1))
    tmod.setup_model("cpu")
    tmod.model.load_state_dict(flax_to_torch(params))
    named = dict(tmod.model.named_parameters())
    loss = tmod.training_step(StepContext(tmod, training=True,
                                          rng=(0, 0, 0)),
                              (torch.from_numpy(x), torch.from_numpy(y)))
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    assert not tqueue
    _close(float(loss.detach()), float(want), tol)
    wgrads = flax_to_torch(jax.device_get(wgrads))
    assert set(grads) == set(wgrads)
    for k, g in grads.items():
        _close(g.float().numpy(), wgrads[k].float().numpy(), tol, k)


def test_dropout_is_off_outside_training():
    """At dropout 0.1 the eval forward (no seed: validation, predict) is
    the forward at dropout 0.0 bit for bit, and the training forward
    differs from it."""
    params = flax_to_torch(_gpt_params())
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, TINY["vocab_size"], (2, 16)))
    out = {}
    for rate in (0.0, 0.1):
        mod = GPTLightningModule(GPTConfig(**TINY, dropout=rate))
        mod.setup_model("cpu")
        mod.model.load_state_dict(params)
        with torch.no_grad():
            out[rate] = (mod.model(x),
                         mod.predict_step(StepContext(mod, False), (x,)),
                         mod.model(x, StepContext(
                             mod, True, rng=(0, 1, 0)).dropout_seed(rate)))
    assert torch.equal(out[0.1][0], out[0.0][0])
    assert torch.equal(out[0.1][1], out[0.0][1])
    assert torch.equal(out[0.0][2], out[0.0][0])
    assert not torch.equal(out[0.1][2], out[0.0][0])


def test_dropout_under_remat_draws_the_same_masks():
    """Under remat "full" each block's dropout masks are drawn again in
    the backward pass's recompute from the same seeds: the loss and
    every gradient equal those without remat, bit for bit."""
    params = flax_to_torch(_gpt_params())
    toks = np.random.default_rng(4).integers(0, TINY["vocab_size"], (2, 17))
    batch = (torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:]))
    out = []
    for remat in (False, True):
        mod = GPTLightningModule(GPTConfig(**{**TINY, "remat": remat},
                                           dropout=0.1))
        mod.setup_model("cpu")
        mod.model.load_state_dict(params)
        assert mod.model.remat_policy == ("full" if remat else "off")
        named = dict(mod.model.named_parameters())
        loss = mod.training_step(StepContext(mod, True, rng=(0, 3, 0)),
                                 batch)
        out.append((loss.detach(), torch.autograd.grad(
            loss, list(named.values()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# -- the defaults -------------------------------------------------------------

def test_trainer_defaults_checkpoint_and_log(tmp_path, monkeypatch):
    """``Trainer(device="cpu").fit(module)`` with its defaults writes a
    checkpoint under ``<cwd>/rlt_logs/checkpoints`` (the default
    ``ModelCheckpoint``) and ``<cwd>/rlt_logs/logs/metrics.csv``, as the
    JAX trainer does; the checkpoint loads with the JAX file's
    top-level keys."""
    monkeypatch.chdir(tmp_path)
    t = Trainer(device="cpu", max_epochs=1, limit_train_batches=4)
    t.fit(BoringModel())
    root = os.path.join(str(tmp_path), "rlt_logs")
    best = t.checkpoint_callback.best_model_path
    assert best == os.path.join(root, "checkpoints", "epoch=0-step=4.ckpt")
    ckpt = Trainer.load_checkpoint_dict(best)
    assert set(ckpt) == {"epoch", "global_step", "state", "hparams",
                         "callbacks", "world_size", "strategy"}
    assert set(ckpt["state"]) == {"step", "params", "model_state",
                                  "opt_state", "rng"}
    assert os.path.exists(os.path.join(root, "logs", "metrics.csv"))
