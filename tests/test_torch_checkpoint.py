"""PyTorch/CUDA port, checkpoint and resume: ``ray_lightning_tpu_torch``'s
``Trainer`` checkpoints, ``ModelCheckpoint`` and ``EarlyStopping``
against the JAX package's on the same numpy-seeded weights and data.

- (a) resume parity with the JAX ``Trainer``: a 1-epoch fit with the
  default ``ModelCheckpoint``, then a resume with ``max_epochs=2`` from
  its ``best_model_path`` (which reruns epoch 0, as in the JAX package):
  per-batch losses, ``callback_metrics``, ``global_step``,
  ``current_epoch`` and the checkpoint file names, on the tiny GPT (bf16
  params, the fp32 master, clipping; within 2e-2) and on
  ``BoringModel`` (fp32; within 2e-5);
- (b) the port's resume after ``save_checkpoint`` against an
  uninterrupted fit, bit for bit (``torch.equal``) on the params, the
  fp32 master, both moments and the count, in fp32 and bf16, under
  dropout, and under another ``Trainer(seed=)``;
- (c) a resume at ``max_steps`` runs nothing; ``ckpt_path`` takes
  precedence over the weights of an earlier fit;
- (d) ``ModelCheckpoint`` and ``EarlyStopping`` of both packages driven
  by one metric sequence: the same files saved and evicted, the same
  best path and score, stop epoch and ``state_dict``;
- (e) a JAX checkpoint carried across by ``jax_checkpoint_to_torch``
  continues as the JAX resume does.

The GPT is ``tiny``-sized with ``dot`` attention on both sides, so the
file runs in about a minute on one core (mostly the JAX trainer's jit
compiles).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
from ray_lightning_tpu.core.callbacks import EarlyStopping as JaxEarlyStopping
from ray_lightning_tpu.core.callbacks import ModelCheckpoint as JaxCheckpoint
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.boring import BoringModel as JaxBoring
from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
from ray_lightning_tpu.models.gpt import GPTLightningModule as JaxModule
from ray_lightning_tpu_torch import (BoringModel, Callback, EarlyStopping,
                                     ModelCheckpoint, Trainer,
                                     jax_checkpoint_to_torch)
from ray_lightning_tpu_torch.convert import flax_to_torch
from ray_lightning_tpu_torch.models.gpt import GPTConfig, GPTLightningModule

#: tiny's widths, dot attention on both sides
TINY = dict(vocab_size=512, block_size=64, n_layer=2, n_head=2, n_embd=64,
            remat=False, attention_impl="dot")
GPT_KW = dict(lr=3e-3, warmup_steps=2, batch_size=4, dataset_size=16)
#: 3 steps an epoch, a validation of one batch after each, a sanity pass
FIT = dict(limit_train_batches=3, limit_val_batches=1,
           num_sanity_val_steps=1, log_every_n_steps=1, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gpt_params():
    """Seeded fp32 params of the JAX tiny GPT's tree: LayerNorm scales 1,
    biases 0, every other leaf N(0, 0.02) from numpy (the tree from
    ``jax.eval_shape``, which compiles nothing)."""
    jcfg = JaxConfig(**TINY, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda r: JaxGPT(jcfg).init(
        r, jnp.zeros((1, 8), jnp.int32))["params"], jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def leaf(path, x):
        name = path[-1].key
        if name in ("scale", "bias"):
            return np.full(x.shape, name == "scale", np.float32)
        return (rng.standard_normal(x.shape) * 0.02).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _boring_params():
    rng = np.random.default_rng(1)
    return {"Dense_0": {
        "kernel": (rng.standard_normal((32, 2)) / np.sqrt(32)).astype(
            np.float32),
        "bias": (rng.standard_normal(2) * 0.1).astype(np.float32)}}


class _JaxGPT(JaxModule):
    def __init__(self, params, **kw):
        super().__init__(config=JaxConfig(**TINY), **kw)
        self._params = params

    def init_params(self, rng, batch):
        return {"params": jax.tree_util.tree_map(jnp.asarray, self._params)}


class _TorchGPT(GPTLightningModule):
    def __init__(self, params, dropout: float = 0.0, **kw):
        super().__init__(config=GPTConfig(**TINY, dropout=dropout), **kw)
        self._state = flax_to_torch(params)

    def init_params(self, generator):
        self.setup_model(generator.device)
        self.model.load_state_dict(self._state)
        return self.model.state_dict()


class _JaxBoring(JaxBoring):
    def __init__(self, params, **kw):
        super().__init__(**kw)
        self._params = params

    def init_params(self, rng, batch):
        return {"params": jax.tree_util.tree_map(jnp.asarray, self._params)}


class _TorchBoring(BoringModel):
    def __init__(self, params, **kw):
        super().__init__(**kw)
        self._state = flax_to_torch(params)

    def init_params(self, generator):
        self.setup_model(generator.device)
        self.model.load_state_dict(self._state)
        return self.model.state_dict()


class _JaxLosses(JaxCallback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, outputs, batch, i):
        self.losses.append(float(outputs["loss"]))


class _TorchLosses(Callback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, outputs, batch, i):
        self.losses.append(float(outputs["loss"]))


#: model -> (JAX module, port module, Trainer kwargs, tolerance)
MODELS = {
    "gpt": (lambda p: _JaxGPT(p, **GPT_KW), lambda p: _TorchGPT(p, **GPT_KW),
            dict(gradient_clip_val=1.0), 2e-2),
    "boring": (lambda p: _JaxBoring(p, dataset_length=12),
               lambda p: _TorchBoring(p, dataset_length=12), {}, 2e-5),
}


def _jax_fit_and_resume(which, root):
    """The JAX trainer's 1-epoch fit and its resume from
    ``best_model_path`` with ``max_epochs=2``."""
    make_jax, _, kw, _ = MODELS[which]
    params = _gpt_params() if which == "gpt" else _boring_params()
    out = {}
    for name, epochs, ckpt in (("first", 1, None), ("resumed", 2, "best")):
        rec = _JaxLosses()
        t = JaxTrainer(max_epochs=epochs, callbacks=[rec], logger=False,
                       default_root_dir=str(root / name), **FIT, **kw)
        mod = make_jax(params)
        t.fit(mod, ckpt_path=out["first"]["best"] if ckpt else None)
        out[name] = dict(losses=rec.losses, trainer=t, module=mod,
                         best=t.checkpoint_callback.best_model_path)
    return out


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Each model's JAX fit and resume, run once for the tests below."""
    return {w: _jax_fit_and_resume(w, tmp_path_factory.mktemp(w))
            for w in MODELS}


def _torch_fit(make, params, root, epochs, ckpt=None, **kw):
    rec = _TorchLosses()
    t = Trainer(max_epochs=epochs, callbacks=[rec], device="cpu",
                default_root_dir=str(root), **{**FIT, **kw})
    mod = make(params)
    t.fit(mod, ckpt_path=ckpt)
    return t, mod, rec.losses


# -- (a) resume parity with the JAX Trainer -----------------------------------

@pytest.mark.parametrize("which", sorted(MODELS))
def test_resume_from_best_matches_jax_trainer(which, jax_runs, tmp_path):
    """The resume reruns epoch 0 (``epoch`` in a ``ModelCheckpoint`` file
    is the epoch it was saved in), then runs epoch 1, in both packages:
    the same losses, metrics, counters and checkpoint names."""
    _, make, kw, tol = MODELS[which]
    params = _gpt_params() if which == "gpt" else _boring_params()
    jax_run = jax_runs[which]
    t1, _, losses1 = _torch_fit(make, params, tmp_path / "first", 1, **kw)
    best = t1.checkpoint_callback.best_model_path
    assert os.path.basename(best) == os.path.basename(
        jax_run["first"]["best"]) == "epoch=0-step=3.ckpt"
    t2, _, losses2 = _torch_fit(make, params, tmp_path / "resumed", 2,
                                ckpt=best, **kw)
    for name, got, t in (("first", losses1, t1), ("resumed", losses2, t2)):
        jt = jax_run[name]["trainer"]
        np.testing.assert_allclose(got, jax_run[name]["losses"], atol=tol,
                                   rtol=tol, err_msg=name)
        assert (t.global_step, t.current_epoch) == (jt.global_step,
                                                    jt.current_epoch)
        assert set(t.callback_metrics) == set(jt.callback_metrics)
        for k, v in jt.callback_metrics.items():
            np.testing.assert_allclose(t.callback_metrics[k], v, atol=tol,
                                       rtol=tol, err_msg=f"{name} {k}")
        assert sorted(os.listdir(os.path.join(t.default_root_dir,
                                              "checkpoints"))) == sorted(
            os.listdir(os.path.join(jt.default_root_dir, "checkpoints")))
    assert len(losses2) == 6 and (t2.global_step, t2.current_epoch) == (9, 2)


# -- (b) the port's resume is the uninterrupted fit, bit for bit --------------

def _state_tensors(trainer, module) -> dict:
    """Params, and the optimizer's master and moments, by name."""
    opt = trainer.state.opt_state.state_dict()
    if "0" in opt:                                  # chain(clip, tx)
        opt = opt["1"]
    inner = opt.get("inner", opt)
    out = {f"param {k}": v for k, v in module.model.state_dict().items()}
    for part in ("mu", "nu"):
        out.update({f"{part} {k}": v for k, v in inner[part].items()})
    out.update({f"master {k}": v for k, v in opt.get("master", {}).items()})
    return out, inner["count"]


def _assert_same_state(a, b) -> None:
    (ta, ca), (tb, cb) = a, b
    assert ca == cb and set(ta) == set(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k


#: the arguments of the resume checks: clipping, a validation every 2
#: steps, the bf16 batch cast, dropout (so the restored seed matters)
RESUME = dict(gradient_clip_val=0.5, val_check_interval=2, precision="bf16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resume_after_save_checkpoint_is_bit_exact(dtype, tmp_path,
                                                   monkeypatch):
    """Fit 1 epoch, ``save_checkpoint``, resume with ``max_epochs=2`` in
    a new Trainer: params, master, mu, nu and the count equal an
    uninterrupted 2-epoch fit's bit for bit, and so do the counters."""
    monkeypatch.setenv("RLT_BF16_PARAMS", "1" if dtype == "bfloat16"
                       else "0")
    params = _gpt_params()

    def make(p):
        return _TorchGPT(p, dropout=0.1, **GPT_KW)

    whole, wmod, wlosses = _torch_fit(make, params, tmp_path / "whole", 2,
                                      **RESUME)
    half, hmod, _ = _torch_fit(make, params, tmp_path / "half", 1, **RESUME)
    path = str(tmp_path / "half.ckpt")
    half.save_checkpoint(path)
    resumed, rmod, rlosses = _torch_fit(make, params, tmp_path / "resumed",
                                        2, ckpt=path, **RESUME)
    assert (resumed.global_step, resumed.current_epoch) == (
        whole.global_step, whole.current_epoch) == (6, 2)
    assert rlosses == wlosses[3:]
    want = _state_tensors(whole, wmod)
    _assert_same_state(_state_tensors(resumed, rmod), want)
    assert {v.dtype for k, v in want[0].items() if k.startswith("param")} \
        == {torch.bfloat16 if dtype == "bfloat16" else torch.float32}


def test_resume_under_another_seed_draws_the_same(tmp_path):
    """The checkpoint carries the steps' seed: a resume under
    ``Trainer(seed=7)`` draws the dropout masks the uninterrupted
    ``seed=0`` fit draws, so it ends bit for bit where that fit ends."""
    params = _gpt_params()

    def make(p):
        return _TorchGPT(p, dropout=0.1, **GPT_KW)

    whole, wmod, _ = _torch_fit(make, params, tmp_path / "whole", 2,
                                **RESUME)
    half, _, _ = _torch_fit(make, params, tmp_path / "half", 1, **RESUME)
    path = str(tmp_path / "half.ckpt")
    half.save_checkpoint(path)
    resumed, rmod, _ = _torch_fit(make, params, tmp_path / "resumed", 2,
                                  ckpt=path, **{**RESUME, "seed": 7})
    _assert_same_state(_state_tensors(resumed, rmod),
                       _state_tensors(whole, wmod))
    other, omod, _ = _torch_fit(make, params, tmp_path / "other", 2,
                                **{**RESUME, "seed": 7})
    assert not torch.equal(omod.model.wte.weight, wmod.model.wte.weight)


# -- (c) resume at max_steps; ckpt_path over the trained weights --------------

def test_resume_at_max_steps_is_inert(tmp_path):
    """A fit resumed from a checkpoint saved at ``max_steps`` runs no
    step, and its ``current_epoch`` stays the saved one (it does not
    drift up with each save and resume)."""
    params = _boring_params()
    kw = dict(max_steps=4, enable_checkpointing=False)
    t, mod, _ = _torch_fit(lambda p: _TorchBoring(p, dataset_length=12),
                           params, tmp_path / "a", 5, **kw)
    path = str(tmp_path / "at_max.ckpt")
    t.save_checkpoint(path)
    saved = Trainer.load_checkpoint_dict(path)
    assert (saved["global_step"], saved["epoch"]) == (4, 2)
    for round_ in range(2):
        t2, mod2, losses = _torch_fit(
            lambda p: _TorchBoring(p, dataset_length=12), params,
            tmp_path / f"b{round_}", 5, ckpt=path, **kw)
        assert losses == [] and (t2.global_step, t2.current_epoch) == (4, 2)
        for k, v in mod2.model.state_dict().items():
            assert torch.equal(v, saved["state"]["params"][k]), k
        t2.save_checkpoint(path)


def test_ckpt_path_takes_precedence_over_trained_weights(tmp_path):
    """A module that carries the weights of an earlier fit, run with
    ``ckpt_path``, starts from the checkpoint's weights."""
    params = _boring_params()
    mod = _TorchBoring(params, dataset_length=12)
    t = Trainer(max_epochs=1, device="cpu", default_root_dir=str(tmp_path),
                **FIT)
    t.fit(mod)
    path = t.checkpoint_callback.best_model_path
    Trainer(max_epochs=1, device="cpu", enable_checkpointing=False,
            default_root_dir=str(tmp_path), **FIT).fit(mod)
    saved = Trainer.load_checkpoint_dict(path)["state"]["params"]
    trained = mod._trained_state
    assert not torch.equal(trained["Dense_0.weight"],
                           saved["Dense_0.weight"])
    seen = {}

    class Snapshot(Callback):
        def on_test_start(self, trainer, module):
            seen.update({k: v.clone() for k, v in
                         module.model.state_dict().items()})

    Trainer(device="cpu", callbacks=[Snapshot()], logger=False,
            default_root_dir=str(tmp_path), **FIT).test(mod, ckpt_path=path)
    for k, v in saved.items():
        assert torch.equal(seen[k], v), k


# -- (d) the callbacks against the JAX ones -----------------------------------

class _FakeTrainer:
    """What the callbacks read and call on a trainer; a save writes the
    path's name into the file."""

    def __init__(self, root, num_val_batches):
        self.default_root_dir = str(root)
        self.num_val_batches = num_val_batches
        self.callback_metrics = {}
        self.current_epoch = self.global_step = 0
        self.sanity_checking = self.should_stop = False
        self.is_global_zero = True

    def save_checkpoint(self, path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(os.path.basename(path))


#: one monitored-metric sequence, one value an epoch (4 steps each)
METRICS = [0.9, 0.7, 0.8, 0.75, 0.5, 0.6, 0.6, 0.55]

CALLBACK_CASES = {
    "ckpt_min_top1": (ModelCheckpoint, JaxCheckpoint,
                      dict(monitor="val_loss", mode="min", save_top_k=1)),
    "ckpt_max_top2": (ModelCheckpoint, JaxCheckpoint,
                      dict(monitor="val_loss", mode="max", save_top_k=2)),
    "ckpt_all": (ModelCheckpoint, JaxCheckpoint,
                 dict(monitor="val_loss", save_top_k=-1)),
    "ckpt_last": (ModelCheckpoint, JaxCheckpoint,
                  dict(monitor="val_loss", save_top_k=1, save_last=True)),
    "ckpt_every_2": (ModelCheckpoint, JaxCheckpoint,
                     dict(monitor="val_loss", save_top_k=2,
                          every_n_epochs=2)),
    "ckpt_no_monitor": (ModelCheckpoint, JaxCheckpoint, {}),
    "stop_patience_2": (EarlyStopping, JaxEarlyStopping, dict(patience=2)),
    "stop_min_delta": (EarlyStopping, JaxEarlyStopping,
                       dict(patience=1, min_delta=0.15)),
    "stop_max": (EarlyStopping, JaxEarlyStopping,
                 dict(patience=3, mode="max")),
    "stop_on_train_epoch_end": (EarlyStopping, JaxEarlyStopping,
                                dict(patience=2,
                                     check_on_train_epoch_end=True)),
}


def _drive(cb, trainer, validate: bool) -> list:
    """The metric sequence through ``cb`` as the trainers call it: per
    epoch a train-epoch end, then (with validation) a validation end;
    stops where the callback stops the fit.  Returns the files after
    each epoch."""
    cb.setup(trainer, None, "fit")
    seen = []
    for epoch, value in enumerate(METRICS):
        trainer.current_epoch, trainer.global_step = epoch, 4 * (epoch + 1)
        trainer.callback_metrics = {"val_loss": value, "loss": 1.0 + value}
        cb.on_train_epoch_end(trainer, None)
        if validate:
            cb.on_validation_end(trainer, None)
        ckpts = os.path.join(trainer.default_root_dir, "checkpoints")
        seen.append(sorted(os.listdir(ckpts)) if os.path.isdir(ckpts)
                    else [])
        if trainer.should_stop:
            break
    return seen


def _plain(obj, root):
    """A callback's state as comparable plain data: tuples as lists,
    ``root`` cut from paths."""
    if isinstance(obj, dict):
        return {k: _plain(v, root) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v, root) for v in obj]
    if isinstance(obj, str):
        return obj.replace(str(root), "<root>")
    return obj


@pytest.mark.parametrize("case", sorted(CALLBACK_CASES))
@pytest.mark.parametrize("validate", [True, False])
def test_callbacks_match_jax(case, validate, tmp_path):
    """Both packages' callback, driven by one metric sequence with and
    without validation: the same files after every epoch, the same best
    path and score, stop and ``state_dict``."""
    cls, jax_cls, kw = CALLBACK_CASES[case]
    out = []
    for side, make in (("port", cls), ("jax", jax_cls)):
        root = tmp_path / side
        trainer = _FakeTrainer(root, num_val_batches=int(validate))
        cb = make(**kw)
        files = _drive(cb, trainer, validate)
        out.append(dict(
            files=files, stop=trainer.should_stop,
            state=_plain(cb.state_dict(), root),
            best=_plain(getattr(cb, "best_model_path", None), root),
            score=getattr(cb, "best_model_score", None),
            last=_plain(getattr(cb, "last_model_path", None), root),
            stopped_epoch=getattr(cb, "stopped_epoch", None)))
        if cls is EarlyStopping:
            fresh = make(**kw)
            fresh.load_state_dict(cb.state_dict())
            assert fresh.state_dict() == cb.state_dict()
    assert out[0] == out[1]
    if cls is ModelCheckpoint:
        assert any(out[0]["files"])


# -- (e) a JAX checkpoint carried across --------------------------------------

def test_jax_checkpoint_resumes_as_jax_does(jax_runs, tmp_path):
    """The JAX trainer's ``best_model_path`` after its 1-epoch tiny-GPT fit
    (bf16 params, the fp32 master, clipping: an ``optax.chain(clip,
    fp32_master(adamw))`` state), decoded with flax's msgpack reader and
    converted by ``jax_checkpoint_to_torch``, resumes in the port with
    ``max_epochs=2`` as the JAX resume does: the same losses and
    counters, and the same params after it, within 2e-2 (bf16)."""
    run = jax_runs["gpt"]
    ckpt = jax_checkpoint_to_torch(
        JaxTrainer.load_checkpoint_dict(run["first"]["best"]))
    assert set(ckpt) == {"epoch", "global_step", "state", "hparams",
                         "callbacks", "world_size", "strategy"}
    assert sorted(ckpt["state"]["opt_state"]) == ["0", "1"]
    path = str(tmp_path / "from_jax.ckpt")
    torch.save(ckpt, path)
    _, make, kw, tol = MODELS["gpt"]
    t, mod, losses = _torch_fit(make, _gpt_params(), tmp_path / "resumed", 2,
                                ckpt=path, **kw)
    jt = run["resumed"]["trainer"]
    np.testing.assert_allclose(losses, run["resumed"]["losses"], atol=tol,
                               rtol=tol)
    assert (t.global_step, t.current_epoch) == (jt.global_step,
                                                jt.current_epoch)
    want = flax_to_torch(jax.device_get(jt.state.params))
    for k, v in mod.model.state_dict().items():
        assert v.dtype == want[k].dtype == torch.bfloat16, k
        if k.endswith("attn.qkv.bias"):
            continue        # its k third: Adam on rounding noise (F5)
        np.testing.assert_allclose(v.float().numpy(),
                                   want[k].float().numpy(), atol=tol,
                                   rtol=tol, err_msg=k)
