"""PyTorch/CUDA port, sharded checkpoints (utils/checkpoint.py over
``torch.distributed.checkpoint``, the ``ShardedCheckpoint`` callback,
``Trainer.save_sharded_checkpoint`` / ``wait_for_checkpoints`` and a
sharded ``ckpt_path=``): the behaviours of tests/test_sharded_checkpoint.py
but its comm-plane ones (the CommState reshards and
``test_sharded_meta_records_comm_world``, ROADMAP.md item 7), and fsspec
``memory://`` paths.

- the round trip: the restored params and optimizer state equal the live
  ones, the meta holds the global step;
- a save at W=4 (fsdp=2, tensor=2) over CPU workers restores into W=2
  (tensor=2) and into one process bit for bit, and resumed to step 5;
- the callback's step cadence, its default directory and epoch cadence,
  one step saved twice by two cadences, a specific step directory,
  resuming at ``max_steps`` (inert: no step, no epoch drift), callback
  state through the meta, ``max_to_keep``, an in-flight save durable
  when the fit raises, a missing directory, detection;
- ``memory://``: ``save_checkpoint`` and a resume bit for bit, and a
  sharded save and restore.

Workers import this module's callbacks by path: no JAX at its top (it
imports none at all).
"""

import os

import pytest
import torch

from ray_lightning_tpu_torch import (BoringModel, Callback, EarlyStopping,
                                     GPTLightningModule, RaySpmdPlugin,
                                     ShardedCheckpoint, Trainer)
from ray_lightning_tpu_torch.models.gpt import GPTConfig, gpt_partition_rules
from ray_lightning_tpu_torch.parallel.strategy import SpmdStrategy
from ray_lightning_tpu_torch.utils.checkpoint import (ShardedCheckpointer,
                                                      abstract_like)

RUN_TIMEOUT_S = 120
TINY = dict(vocab_size=512, block_size=64, n_layer=2, n_head=2, n_embd=64,
            remat=False, attention_impl="dot")


def _fit(tmp, strategy=None, max_steps=3, module=None, resume=None,
         callbacks=None, plugins=None, **kw):
    where = dict(plugins=plugins) if plugins else dict(device="cpu",
                                                       strategy=strategy)
    trainer = Trainer(max_epochs=10, max_steps=max_steps,
                      enable_checkpointing=False, logger=False,
                      num_sanity_val_steps=0, limit_val_batches=0,
                      log_every_n_steps=1, callbacks=callbacks or [],
                      default_root_dir=str(tmp), seed=0,
                      resume_from_checkpoint=resume, **where, **kw)
    trainer.fit(module or BoringModel())
    return trainer


def _same(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    return [tree]


class SaveAtEnd(Callback):
    """Every rank saves a sharded checkpoint when the fit ends."""

    def __init__(self, path: str):
        self.path = path

    def on_fit_end(self, trainer, module):
        trainer.save_sharded_checkpoint(self.path)


def test_save_restore_roundtrip(tmp_path):
    trainer = _fit(tmp_path)
    ckdir = str(tmp_path / "sharded")
    trainer.save_sharded_checkpoint(ckdir)
    trainer.wait_for_checkpoints()
    ck = ShardedCheckpointer(ckdir)
    assert ck.latest_step() == trainer.global_step == 3
    live = trainer.sharded_state_dict()
    state, meta = ck.restore(abstract_like(live))
    ck.close()
    assert meta["global_step"] == trainer.global_step
    assert meta["strategy"] == "ddp"
    got, want = _tensors(state), _tensors(live)
    assert len(got) == len(want) and all(
        (torch.equal(g, w) if isinstance(g, torch.Tensor) else g == w)
        for g, w in zip(got, want))


def test_restore_into_different_mesh(tmp_path, monkeypatch):
    """Save under (fsdp=2, tensor=2) over 4 workers, restore under
    (tensor=2) over 2 and in one process: each reads the chunks of its
    blocks, the weights equal the saved ones bit for bit, and the fit
    resumes at step 3 and runs to 5."""
    monkeypatch.setenv("RLT_BF16_PARAMS", "0")

    def module():
        return GPTLightningModule(GPTConfig(**TINY, dtype=torch.float32),
                                  dataset_size=32, batch_size=8)

    def plugin(n, **sizes):
        return RaySpmdPlugin(num_workers=n, platform="cpu",
                             timeout_s=RUN_TIMEOUT_S,
                             strategy=SpmdStrategy(
                                 gpt_partition_rules(),
                                 ("data", "fsdp", "tensor"), sizes))

    ckdir = str(tmp_path / "sharded")
    m1 = module()
    _fit(tmp_path / "a", module=m1, plugins=[plugin(4, fsdp=2, tensor=2)],
         callbacks=[SaveAtEnd(ckdir)])
    t2 = _fit(tmp_path / "b", module=module(), max_steps=5, resume=ckdir,
              plugins=[plugin(2, tensor=2)])
    assert t2.global_step == 5
    for plugins in ([plugin(2, tensor=2)], None):
        m3 = module()
        t3 = _fit(tmp_path / "c", module=m3, max_steps=3, resume=ckdir,
                  plugins=plugins, strategy="fsdp")
        assert t3.global_step == 3
        assert _same(m3._trained_state, m1._trained_state)


def test_sharded_checkpoint_callback(tmp_path):
    cb = ShardedCheckpoint(dirpath=str(tmp_path / "cks"),
                           every_n_train_steps=2, every_n_epochs=0)
    _fit(tmp_path, max_steps=5, callbacks=[cb])
    ck = ShardedCheckpointer(str(tmp_path / "cks"))
    assert ck.all_steps() == [2, 4]
    ck.close()


def test_callback_default_dir_and_epoch_cadence(tmp_path):
    cb = ShardedCheckpoint()
    trainer = Trainer(max_epochs=2, enable_checkpointing=False,
                      logger=False, num_sanity_val_steps=0,
                      limit_val_batches=0, limit_train_batches=2,
                      callbacks=[cb], default_root_dir=str(tmp_path),
                      seed=0, device="cpu")
    trainer.fit(BoringModel())
    ck = ShardedCheckpointer(str(tmp_path / "sharded_checkpoints"))
    assert ck.all_steps() == [2, 4]
    ck.close()


def test_same_step_saved_twice_is_noop(tmp_path):
    """Two cadences landing on one global step: the second save is a
    silent no-op."""
    cb = ShardedCheckpoint(dirpath=str(tmp_path / "cks"),
                           every_n_train_steps=2)
    trainer = Trainer(max_epochs=1, enable_checkpointing=False,
                      logger=False, num_sanity_val_steps=0,
                      limit_val_batches=0, limit_train_batches=4,
                      callbacks=[cb], default_root_dir=str(tmp_path),
                      seed=0, device="cpu")
    trainer.fit(BoringModel())
    ck = ShardedCheckpointer(str(tmp_path / "cks"))
    assert ck.all_steps() == [2, 4]
    ck.close()


def test_restore_specific_step_dir(tmp_path):
    cb = ShardedCheckpoint(dirpath=str(tmp_path / "cks"),
                           every_n_train_steps=2, every_n_epochs=0)
    _fit(tmp_path, max_steps=4, callbacks=[cb])
    step_dir = str(tmp_path / "cks" / "2")
    assert ShardedCheckpointer.is_sharded_checkpoint(step_dir)
    t2 = _fit(tmp_path / "b", max_steps=3, resume=step_dir)
    assert t2.global_step == 3


def test_resume_at_max_steps_is_inert(tmp_path):
    module = BoringModel()
    trainer = _fit(tmp_path, max_steps=3, module=module)
    ckdir = str(tmp_path / "sharded")
    trainer.save_sharded_checkpoint(ckdir)
    trainer.wait_for_checkpoints()
    m2 = BoringModel()
    t2 = _fit(tmp_path / "b", max_steps=3, resume=ckdir, module=m2)
    assert t2.global_step == 3
    assert t2.current_epoch == trainer.current_epoch
    assert _same(m2._trained_state, module._trained_state)


def test_callback_state_roundtrips_through_sharded_meta(tmp_path):
    es = EarlyStopping(monitor="loss", patience=3, mode="min")
    trainer = _fit(tmp_path, max_steps=3, callbacks=[es])
    es._mon.best = 0.123
    es.wait_count = 2
    ckdir = str(tmp_path / "sharded")
    trainer.save_sharded_checkpoint(ckdir)
    trainer.wait_for_checkpoints()
    es2 = EarlyStopping(monitor="loss", patience=3, mode="min")
    _fit(tmp_path / "b", max_steps=3, resume=ckdir, callbacks=[es2])
    assert es2._mon.best == pytest.approx(0.123)
    assert es2.wait_count == 2


def test_max_to_keep_evicts_oldest(tmp_path):
    trainer = _fit(tmp_path, max_steps=1)
    ck = ShardedCheckpointer(str(tmp_path / "cks"), max_to_keep=2)
    for step in (1, 2, 3):
        ck.save(step, trainer.sharded_state_dict(), {"global_step": step})
    ck.wait()
    assert ck.all_steps() == [2, 3]
    _, meta = ck.restore(abstract_like(trainer.sharded_state_dict()))
    assert meta["global_step"] == 3
    assert ck.saved_state_metadata()["params/Dense_0.weight"][0] == (2, 32)
    ck.close()


class SaveThenBoom(Callback):
    def __init__(self, path: str):
        self.path = path

    def on_train_batch_end(self, trainer, module, outputs, batch, idx):
        if trainer.global_step == 2:
            trainer.save_sharded_checkpoint(self.path)
            raise RuntimeError("post-save boom")


def test_inflight_save_durable_when_fit_raises(tmp_path):
    """A save started right before an exception lands: the stage waits
    for and closes its checkpointers while unwinding."""
    trainer = Trainer(max_epochs=1, enable_checkpointing=False,
                      logger=False, num_sanity_val_steps=0,
                      limit_val_batches=0,
                      callbacks=[SaveThenBoom(str(tmp_path / "cks"))],
                      default_root_dir=str(tmp_path), seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="post-save boom"):
        trainer.fit(BoringModel())
    assert trainer._sharded_checkpointers == {}
    ck = ShardedCheckpointer(str(tmp_path / "cks"))
    assert ck.all_steps() == [2]
    ck.close()


def test_restore_missing_dir_raises(tmp_path):
    ck = ShardedCheckpointer(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        ck.restore({})
    ck.close()


def test_is_sharded_checkpoint_detection(tmp_path):
    assert not ShardedCheckpointer.is_sharded_checkpoint(
        str(tmp_path / "nope"))
    f = tmp_path / "flat.ckpt"
    f.write_bytes(b"x")
    assert not ShardedCheckpointer.is_sharded_checkpoint(str(f))
    d = tmp_path / "cks" / "7"
    d.mkdir(parents=True)
    assert ShardedCheckpointer.is_sharded_checkpoint(str(tmp_path / "cks"))
    assert not ShardedCheckpointer.is_sharded_checkpoint(str(d))
    (d / "meta.json").write_text("{}")
    assert ShardedCheckpointer.is_sharded_checkpoint(str(d))


def test_memory_fs_checkpoints(tmp_path):
    """fsspec ``memory://``: a ``save_checkpoint`` file and a sharded
    save, each after a first epoch of two steps, resume the fit bit for
    bit with an uninterrupted one (the tiny GPT in bf16 with its fp32
    master, under ``"fsdp"``)."""
    pytest.importorskip("fsspec")
    url = f"memory://rlt-{os.getpid()}-{tmp_path.name}"

    def module():
        return GPTLightningModule(GPTConfig(**TINY), dataset_size=32,
                                  batch_size=4)

    epochs = dict(strategy="fsdp", limit_train_batches=2)
    full = module()
    _fit(tmp_path / "a", max_steps=4, module=full, **epochs)
    half = _fit(tmp_path / "b", max_steps=2, module=module(), **epochs)
    half.save_checkpoint(f"{url}/half.ckpt")
    half.save_sharded_checkpoint(f"{url}/sharded")
    half.wait_for_checkpoints()
    assert ShardedCheckpointer.is_sharded_checkpoint(f"{url}/sharded")
    assert Trainer.load_checkpoint_dict(f"{url}/half.ckpt")[
        "global_step"] == 2
    for resume in (f"{url}/half.ckpt", f"{url}/sharded"):
        m = module()
        t = _fit(tmp_path / "c", max_steps=4, module=m, resume=resume,
                 **epochs)
        assert t.global_step == 4
        assert _same(m._trained_state, full._trained_state), resume
    import fsspec
    fsspec.filesystem("memory").rm(url.split("://")[1], recursive=True)
