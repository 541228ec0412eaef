"""PyTorch/CUDA port, the epoch engine: ``steps_per_execution`` and
``cache_train_dataset`` (core/loop_engine.py, core/steps.py
``ChunkRunner``), on the CPU, where a chunk is k eager steps.

- every dispatch shape against the JAX ``Trainer`` with the same knobs on
  the same numpy-seeded data and converted weights: the step count, the
  per-step losses, the callback events (starts per batch, one end a
  chunk) and the final weights, at ``rtol=1e-5, atol=1e-6`` as
  ``tests/test_loop_engine.py`` holds its shapes to each other (fp32):
  chunked, cached, cached and chunked, cached with a shuffling loader
  over 3 epochs, a partial tail batch, ``max_steps``, the
  ``val_check_interval`` boundaries, ``limit_train_batches``;
- the behaviours of ``tests/test_loop_engine.py`` and the knob tests of
  ``tests/test_trainer_local.py:114-225`` on the port: every shape equal
  to the streamed fit bit for bit, shuffle really re-drawing, a
  generator loader streaming every epoch, the cached path collating no
  host batch for the default callbacks, a loader that changes its order
  without ``shuffle``, a subclass's batch hook getting the real batch,
  ``limit_train_batches`` counting positions, the cache learning over
  epochs;
- the compositions of ``tests/test_compose.py:33-66``: ``strategy="ddp"``
  and ``"zero1"`` (one process), ``accumulate_grad_batches``, the bf16
  batch cast and clipping, each with k=2 (and the cache), against the
  JAX ``Trainer``.

Every fit writes under a temporary ``default_root_dir``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
from ray_lightning_tpu.core.data import ArrayDataset as JaxArrayDataset
from ray_lightning_tpu.core.data import DataLoader as JaxDataLoader
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.boring import BoringModel as JaxBoring
from ray_lightning_tpu.models.boring import (
    LightningMNISTClassifier as JaxMNIST)
from ray_lightning_tpu_torch import (BoringModel, Callback,
                                     LightningMNISTClassifier, Trainer)
from ray_lightning_tpu_torch.convert import flax_to_torch
from ray_lightning_tpu_torch.core import loop_engine
from ray_lightning_tpu_torch.core.data import ArrayDataset, DataLoader

RTOL, ATOL = 1e-5, 1e-6
#: ``tests/test_loop_engine.py``'s fit settings
QUIET = dict(enable_checkpointing=False, num_sanity_val_steps=0,
             limit_val_batches=0, logger=False, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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
    """``base`` (either package's module class) starting from ``params``
    (a flax tree; converted for the port)."""
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


class _Loaded:
    """A train loader over seeded 32-wide rows (``tests/test_loop_engine.
    py``'s ``ShuffledBoring``), in either package's classes."""

    def _make_loader(self, jax_side: bool):
        rng = np.random.default_rng(3)
        rows = rng.standard_normal((self.dataset_length, 32),
                                   dtype=np.float32)
        ds_cls, dl_cls = ((JaxArrayDataset, JaxDataLoader) if jax_side
                          else (ArrayDataset, DataLoader))
        loader_cls = self._loader_cls.get(jax_side, dl_cls)
        return loader_cls(ds_cls(rows), batch_size=self.batch_size,
                          shuffle=self._shuffle, seed=11,
                          drop_last=self._drop_last)


def _boring(jax_side: bool, shuffle=False, n=16, batch_size=2,
            drop_last=True, loader_cls=None, **kw):
    """A BoringModel from fixed weights over the seeded loader."""
    base = _fixed(JaxBoring if jax_side else BoringModel,
                  _dense_params((32, 2)), jax_side)

    class Boring(_Loaded, base):
        def train_dataloader(self):
            return self._make_loader(jax_side)

    m = Boring(dataset_length=n, batch_size=batch_size, **kw)
    m._shuffle, m._drop_last = shuffle, drop_last
    m._loader_cls = {jax_side: loader_cls} if loader_cls else {}
    return m


def _mnist(jax_side: bool, n: int = 64, batch_size: int = 8):
    """The MNIST classifier (Adam) at hidden widths 16, from fixed
    weights: the AdamW path, whose scalars ride the step's feed."""
    base = JaxMNIST if jax_side else LightningMNISTClassifier
    return _fixed(base, _dense_params((784, 16, 16, 10)), jax_side)(
        config={"batch_size": batch_size, "layer_1": 16, "layer_2": 16,
                "lr": 1e-2}, train_size=n, val_size=16)


def _recorder(jax_side: bool):
    """Records the event sequence of a fit, its per-step losses (a
    chunk's ``[k]`` flattened) and the steps it validated at."""
    class Recorder(JaxCallback if jax_side else Callback):
        def __init__(self):
            self.events, self.losses, self.val_steps = [], [], []

        def on_train_batch_start(self, trainer, module, batch, idx):
            self.events.append(("start", trainer.global_step, idx))

        def on_train_batch_end(self, trainer, module, metrics, batch, idx):
            self.events.append(("end", trainer.global_step, idx))
            self.losses.extend(np.atleast_1d(
                np.asarray(metrics["loss"], np.float64)).tolist())

        def on_validation_end(self, trainer, module):
            if not trainer.sanity_checking:
                self.val_steps.append(trainer.global_step)

    return Recorder()


def _weights(side, module) -> "list[np.ndarray]":
    """The fit's weights as numpy, in ``Dense_i`` kernel/bias order (the
    torch weight transposed to flax's kernel)."""
    if side == "jax":
        params = module._trained_variables["params"]
        return [np.asarray(params[layer][name], np.float32)
                for layer in sorted(params) for name in ("bias", "kernel")]
    out = []
    for layer in sorted(n for n, _ in module.model.named_children()):
        lin = getattr(module.model, layer)
        out += [lin.bias.detach().float().numpy(),
                lin.weight.detach().float().numpy().T]
    return out


def _fit(side, make, root, epochs=2, **kw):
    rec = _recorder(side == "jax")
    kw = {**QUIET, **kw}
    if side == "torch":
        kw["device"] = "cpu"
    t = (JaxTrainer if side == "jax" else Trainer)(
        max_epochs=epochs, callbacks=[rec], default_root_dir=str(root / side),
        **kw)
    module = make(side == "jax")
    t.fit(module)
    if side == "torch" and kw.get("cache_train_dataset"):
        assert not t._cache_disabled, "the cache fell back to streaming"
    return types.SimpleNamespace(trainer=t, module=module, rec=rec)


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def _same_run(t, j, events=True):
    assert t.trainer.global_step == j.trainer.global_step
    if events:
        assert t.rec.events == j.rec.events
    assert t.rec.val_steps == j.rec.val_steps
    _close(t.rec.losses, j.rec.losses, "losses")
    for a, b in zip(_weights("torch", t.module), _weights("jax", j.module)):
        _close(a, b, "weights")


# -- every dispatch shape against the JAX Trainer ----------------------------

SHAPES = {
    "chunked": (dict(), dict(steps_per_execution=4)),
    "cached": (dict(), dict(cache_train_dataset=True)),
    "cached_chunked": (dict(), dict(steps_per_execution=4,
                                    cache_train_dataset=True)),
    "cached_shuffle": (dict(shuffle=True), dict(epochs=3,
                                                cache_train_dataset=True)),
    "partial_tail": (dict(drop_last=False, n=20, batch_size=3),
                     dict(cache_train_dataset=True)),
    "partial_tail_chunked": (dict(drop_last=False, n=20, batch_size=3),
                             dict(steps_per_execution=3,
                                  cache_train_dataset=True)),
    "max_steps": (dict(batch_size=8, n=128),
                  dict(epochs=10, max_steps=6, steps_per_execution=4,
                       cache_train_dataset=True)),
    "val_interval": (dict(batch_size=8, n=128),
                     dict(epochs=1, limit_train_batches=12,
                          val_check_interval=3, steps_per_execution=8,
                          limit_val_batches=1)),
    "limit_positions": (dict(batch_size=8, n=68),
                        dict(epochs=1, limit_train_batches=6,
                             steps_per_execution=4)),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_dispatch_shape_matches_jax(shape, tmp_path):
    """The port's fit with the knobs equals the JAX Trainer's with the
    same knobs: steps, callback events, validation steps, per-step
    losses, weights."""
    model_kw, kw = SHAPES[shape]
    j = _fit("jax", lambda s: _boring(s, **model_kw), tmp_path, **kw)
    t = _fit("torch", lambda s: _boring(s, **model_kw), tmp_path, **kw)
    _same_run(t, j)
    if shape == "val_interval":
        assert t.rec.val_steps[:4] == [3, 6, 9, 12]
    if shape == "partial_tail":
        assert t.trainer.global_step == 14      # 2 epochs x (6 + 1)
    if shape == "max_steps":
        assert t.trainer.global_step == 6


@pytest.mark.parametrize("knobs", [dict(steps_per_execution=4),
                                   dict(cache_train_dataset=True),
                                   dict(steps_per_execution=3,
                                        cache_train_dataset=True)],
                         ids=["chunked", "cached", "cached_chunked"])
def test_adam_chunks_match_jax(knobs, tmp_path):
    """The MNIST classifier (Adam: the bias corrections ride the
    optimizer's scalar feed) over 2 shuffled epochs of 8 batches, with
    each knob, equals the JAX streamed fit."""
    j = _fit("jax", _mnist, tmp_path)
    t = _fit("torch", _mnist, tmp_path, **knobs)
    _same_run(t, j, events=False)


# -- the behaviours of tests/test_loop_engine.py, within the port -------------

def _port(root, model_kw=None, **kw):
    return _fit("torch", lambda s: _boring(s, **(model_kw or {})), root,
                **kw)


def _equal_runs(a, b):
    assert a.trainer.global_step == b.trainer.global_step
    assert a.rec.losses == b.rec.losses
    for x, y in zip(_weights("torch", a.module),
                    _weights("torch", b.module)):
        assert np.array_equal(x, y)


def test_every_shape_equals_streamed_bit_for_bit(tmp_path):
    """On the CPU a chunk is k eager steps and a cached batch holds the
    streamed batch's samples: every shape trains exactly as the streamed
    fit does, and the chunk's callback cadence is one end per chunk."""
    for shuffle in (False, True):
        mkw = dict(shuffle=shuffle)
        base = _port(tmp_path / f"s{shuffle}", mkw, epochs=3)
        for kw in (dict(steps_per_execution=4), dict(cache_train_dataset=True),
                   dict(steps_per_execution=4, cache_train_dataset=True)):
            run = _port(tmp_path / f"s{shuffle}{len(kw)}", mkw, epochs=3,
                        **kw)
            _equal_runs(run, base)
            if "steps_per_execution" in kw:
                ends = [e for e in run.rec.events if e[0] == "end"]
                starts = [e for e in run.rec.events if e[0] == "start"]
                assert len(starts) == len(base.rec.losses)
                assert len(ends) == len(base.rec.losses) // 4
            else:
                assert run.rec.events == base.rec.events
    # shuffle really re-draws (else the shuffled case proves nothing)
    fixed = _port(tmp_path / "f", dict(shuffle=False), epochs=3)
    shuffled = _port(tmp_path / "t", dict(shuffle=True), epochs=3)
    assert not np.allclose(fixed.rec.losses, shuffled.rec.losses)


class _Generator(BoringModel):
    """A generator 'loader' the cache cannot introspect."""

    def train_dataloader(self):
        data = np.random.default_rng(3).standard_normal((8, 2, 32),
                                                        dtype=np.float32)
        return (torch.from_numpy(b) for b in data)


def test_unusable_cache_streams_every_epoch(tmp_path):
    """A foreign loader turns the cache off with a warning and streams:
    the fit still trains every batch."""
    rec = _recorder(False)
    t = Trainer(max_epochs=1, callbacks=[rec], device="cpu",
                cache_train_dataset=True, default_root_dir=str(tmp_path),
                **QUIET)
    t.fit(_Generator())
    assert t.global_step == 8 and len(rec.losses) == 8
    assert t._cache_disabled


def test_cached_default_callbacks_skip_host_collation(monkeypatch,
                                                      tmp_path):
    """No callback overrides a batch hook: no cached item ever
    materializes its host batch.  With one that reads it, they flow."""
    calls = {"batch": 0}
    orig = loop_engine.Item.batch

    def counting(self):
        calls["batch"] += 1
        return orig(self)

    monkeypatch.setattr(loop_engine.Item, "batch", counting)
    t = Trainer(max_epochs=2, device="cpu", cache_train_dataset=True,
                default_root_dir=str(tmp_path), **QUIET)
    t.fit(_boring(False, shuffle=True))
    assert t.global_step == 16 and calls["batch"] == 0
    run = _port(tmp_path / "rec", dict(shuffle=True),
                cache_train_dataset=True)
    assert calls["batch"] > 0 and len(run.rec.events) == 2 * 16


class _SneakyLoader(DataLoader):
    """Varies its order each epoch while claiming ``shuffle=False``."""

    def _indices(self):
        idx = super()._indices()
        return idx if self._epoch % 2 == 0 else idx[::-1].copy()


class _JaxSneakyLoader(JaxDataLoader):
    def _indices(self):
        idx = super()._indices()
        return idx if self._epoch % 2 == 0 else idx[::-1].copy()


def test_cached_unstable_indices_without_shuffle_flag(tmp_path):
    """The flat upload is dropped on the ``shuffle=False`` promise; a
    loader that breaks it gets one warned re-upload and trains as the
    streamed fit does, and as the JAX cached fit does."""
    def make(s):
        return _boring(s, loader_cls=_JaxSneakyLoader if s
                       else _SneakyLoader)

    streamed = _fit("torch", make, tmp_path / "s", epochs=3)
    cached = _fit("torch", make, tmp_path / "c", epochs=3,
                  cache_train_dataset=True)
    _equal_runs(cached, streamed)
    j = _fit("jax", make, tmp_path / "j", epochs=3,
             cache_train_dataset=True)
    _same_run(cached, j)


class _QuietBase(Callback):
    needs_batch = False     # this class's hook never reads the batch

    def on_train_batch_end(self, trainer, module, outputs, batch,
                           batch_idx):
        pass


class _NaiveSub(_QuietBase):    # overrides, does not restate the flag
    def __init__(self):
        self.batches = []

    def on_train_batch_end(self, trainer, module, outputs, batch,
                           batch_idx):
        self.batches.append(batch)


class _DeclaredSub(_NaiveSub):  # restates the promise at its own level
    needs_batch = False


def test_subclass_overriding_batch_hook_gets_real_batch(tmp_path):
    """``needs_batch = False`` belongs to the class that declares it: a
    subclass overriding the hook without restating it gets the real
    (host) batch, one restating it gets ``None``, and so does nothing
    an instance-assigned hook outranks."""
    def fit(cb):
        Trainer(max_epochs=1, callbacks=[cb], device="cpu",
                cache_train_dataset=True, default_root_dir=str(tmp_path),
                **QUIET).fit(_boring(False, n=8))

    naive = _NaiveSub()
    fit(naive)
    assert len(naive.batches) == 4
    assert all(isinstance(b, torch.Tensor) and b.shape == (2, 32)
               for b in naive.batches)
    declared = _DeclaredSub()
    fit(declared)
    assert len(declared.batches) == 4
    assert all(b is None for b in declared.batches)
    grabbed = []
    patched = _QuietBase()
    patched.on_train_batch_end = (
        lambda trainer, module, outputs, batch, idx: grabbed.append(batch))
    fit(patched)
    assert len(grabbed) == 4 and all(b is not None for b in grabbed)


def test_limit_counts_loader_positions(tmp_path):
    """68 rows in batches of 8: 8 full batches and a short one of 4.
    ``limit_train_batches=9`` counts positions, so k=1 and k=4 run the
    same 9 steps (the short batch rides the single-step path) with the
    same losses."""
    runs = [_port(tmp_path / str(k), dict(batch_size=8, n=68,
                                          drop_last=False), epochs=1,
                  limit_train_batches=9, steps_per_execution=k)
            for k in (1, 4)]
    assert runs[0].trainer.global_step == runs[1].trainer.global_step == 9
    _equal_runs(runs[1], runs[0])


def test_cache_learns_over_epochs(tmp_path):
    """3 epochs of 16 cached steps in chunks of 4 at lr 0.05: the step
    count is exact and the epoch's mean loss falls below 1.0."""
    run = _port(tmp_path, dict(batch_size=8, n=128, lr=0.05), epochs=3,
                limit_train_batches=16, steps_per_execution=4,
                cache_train_dataset=True)
    assert run.trainer.global_step == 48
    assert run.trainer.callback_metrics["loss"] < 1.0


# -- compositions (tests/test_compose.py:33-66) -----------------------------

COMPOSE = {
    "ddp_chunked": dict(strategy="ddp", steps_per_execution=2),
    "zero1_chunked": dict(strategy="zero1", steps_per_execution=2),
    "ddp_cached": dict(strategy="ddp", steps_per_execution=2,
                       cache_train_dataset=True),
    "zero1_cached": dict(strategy="zero1", steps_per_execution=2,
                         cache_train_dataset=True),
    "accumulate_chunked": dict(steps_per_execution=2,
                               accumulate_grad_batches=2),
    "bf16_cached": dict(precision="bf16", steps_per_execution=2,
                        cache_train_dataset=True),
    "clip_cached": dict(gradient_clip_val=0.05, steps_per_execution=2,
                        cache_train_dataset=True),
}


@pytest.mark.parametrize("case", sorted(COMPOSE))
def test_composition_matches_jax(case, tmp_path):
    """Each knob composed with a strategy, accumulation, the bf16 batch
    cast or clipping: 4 steps of BoringModel at B=8 with
    ``log_every_n_steps=1`` against the JAX Trainer's fit with the same
    arguments."""
    kw = dict(COMPOSE[case], epochs=1, limit_train_batches=4,
              log_every_n_steps=1)
    j = _fit("jax", lambda s: _boring(s, batch_size=8, n=64), tmp_path,
             **kw)
    t = _fit("torch", lambda s: _boring(s, batch_size=8, n=64), tmp_path,
             **kw)
    assert t.trainer.global_step == 4
    assert np.isfinite(t.trainer.callback_metrics["loss"])
    _same_run(t, j)
    _close(t.trainer.callback_metrics["loss"],
           j.trainer.callback_metrics["loss"])
