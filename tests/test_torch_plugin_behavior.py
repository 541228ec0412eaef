"""PyTorch/CUDA port, the behaviours of tests/test_plugin_behavior.py with
``RayPlugin(platform="cpu")`` workers on gloo:

- the driver of a distributed fit never initialises CUDA (the
  reference's CPU-only driver and ``DelayedGPUAccelerator``,
  util.py:11-37): a subprocess driver whose CUDA initialisation raises
  fits, and ``torch.cuda.is_initialized()`` is still false after; it
  never imports JAX either;
- each rank trains on a disjoint shard of the data (test_ddp.py:177-209);
- ``EarlyStopping`` inside the workers ends the fit before
  ``max_epochs`` and the epoch comes back to the driver
  (test_ddp.py:287-306);
- a distributed fit's checkpoint fine-tunes in a local ``Trainer`` and
  feeds ``test(ckpt_path=)`` (test_ddp_sharded.py:67-105);
- the weights back on the driver differ from their init
  (tests/utils.py ``train_test``).

Workers unpickle this module's callbacks and modules by import path, so
it imports no JAX.  Every run carries its bound (``timeout_s``).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from ray_lightning_tpu_torch import (BoringModel, Callback, EarlyStopping,
                                     RayPlugin, Trainer)

#: a run's bound: the driver's wait for its workers and each collective
RUN_TIMEOUT_S = 90
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cpu_plugin(n: int = 2) -> RayPlugin:
    return RayPlugin(num_workers=n, platform="cpu", timeout_s=RUN_TIMEOUT_S)


# -- worker-side helpers (module level: the workers import them) ------------

class ShardRecorder(Callback):
    """Writes, per rank, the first column of every training batch it saw
    (BoringModel's rows are told apart by it)."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self.seen: list = []

    def on_train_batch_end(self, trainer, module, outputs, batch,
                           batch_idx):
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        self.seen.extend(x[:, 0].tolist())

    def on_train_end(self, trainer, module):
        path = os.path.join(self.out_dir,
                            f"shard_rank{trainer.global_rank}.json")
        with open(path, "w") as f:
            json.dump({"world_size": trainer.world_size,
                       "rank": trainer.global_rank, "seen": self.seen}, f)


class PlateauModel(BoringModel):
    """lr 0: the weights never move, so ``val_loss`` is flat."""

    def __init__(self):
        super().__init__(lr=0.0)


# -- the behaviours -------------------------------------------------------------

DRIVER = textwrap.dedent("""
    import sys
    import torch

    def refuse(*args, **kwargs):
        raise RuntimeError("the driver initialised CUDA")

    torch.cuda._lazy_init = refuse
    torch.cuda.init = refuse

    from ray_lightning_tpu_torch import BoringModel, RayPlugin, Trainer

    trainer = Trainer(plugins=[RayPlugin(num_workers=2, platform="cpu",
                                         timeout_s=%d)],
                      max_epochs=1, limit_train_batches=2,
                      limit_val_batches=1, num_sanity_val_steps=0,
                      enable_checkpointing=False, logger=False, seed=0)
    model = BoringModel()
    trainer.fit(model)
    assert model._trained_state is not None
    assert not torch.cuda.is_initialized()
    assert not any(m.split(".")[0] in ("jax", "ray_lightning_tpu")
                   for m in sys.modules)
    print("DRIVER_OK", trainer.global_step)
""" % RUN_TIMEOUT_S)


def test_driver_never_initialises_cuda(tmp_path):
    """A subprocess driver whose CUDA initialisation raises (so a touch
    of the card there fails the fit, whatever the machine has) fits under
    ``RayPlugin``; CUDA is still uninitialised after, and no JAX
    module was imported."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    proc = subprocess.run([sys.executable, "-c", DRIVER],
                          capture_output=True, text=True,
                          timeout=3 * RUN_TIMEOUT_S, env=env,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert "DRIVER_OK 2" in proc.stdout


def test_distributed_sampler_shards_are_disjoint(tmp_path):
    trainer = Trainer(plugins=[cpu_plugin(2)], max_epochs=1,
                      limit_val_batches=0, num_sanity_val_steps=0,
                      enable_checkpointing=False, logger=False, seed=0,
                      default_root_dir=str(tmp_path),
                      callbacks=[ShardRecorder(str(tmp_path))])
    trainer.fit(BoringModel(dataset_length=16, batch_size=4))
    shards = []
    for rank in range(2):
        with open(tmp_path / f"shard_rank{rank}.json") as f:
            rec = json.load(f)
        assert (rec["world_size"], rec["rank"]) == (2, rank)
        shards.append(set(rec["seen"]))
    assert len(shards[0]) == len(shards[1]) == 8
    assert shards[0].isdisjoint(shards[1])


def test_early_stopping_under_actors(tmp_path):
    """A flat ``val_loss``: the first epoch sets the best, the second
    trips ``patience=1``; the stop epoch comes back to the driver."""
    trainer = Trainer(plugins=[cpu_plugin(2)], max_epochs=10,
                      limit_train_batches=2, limit_val_batches=1,
                      num_sanity_val_steps=0, enable_checkpointing=False,
                      logger=False, seed=0, default_root_dir=str(tmp_path),
                      callbacks=[EarlyStopping(monitor="val_loss",
                                               patience=1, min_delta=1e-9)])
    trainer.fit(PlateauModel())
    assert trainer.current_epoch == 1
    assert trainer.global_step == 4


def test_finetune_from_distributed_checkpoint(tmp_path):
    """The best checkpoint of a 2-worker fit resumes in a local
    ``Trainer`` (its epoch rerun, then the next) and is what a local
    ``test(ckpt_path=)`` evaluates."""
    trainer = Trainer(plugins=[cpu_plugin(2)], max_epochs=1,
                      limit_train_batches=4, limit_val_batches=1,
                      num_sanity_val_steps=0, seed=0,
                      default_root_dir=str(tmp_path / "dist"))
    trainer.fit(BoringModel())
    best = trainer.checkpoint_callback.best_model_path
    assert best and os.path.exists(best)
    ckpt = Trainer.load_checkpoint_dict(best, "cpu")
    assert (ckpt["world_size"], ckpt["global_step"]) == (2, 4)

    local = Trainer(max_epochs=2, limit_train_batches=4,
                    limit_val_batches=1, num_sanity_val_steps=0,
                    enable_checkpointing=False, seed=0, device="cpu",
                    resume_from_checkpoint=best,
                    default_root_dir=str(tmp_path / "local"))
    tuned = BoringModel()
    local.fit(tuned)
    assert local.current_epoch == 2
    assert tuned._trained_state is not None

    evaluator = Trainer(limit_test_batches=2, enable_checkpointing=False,
                        num_sanity_val_steps=0, seed=0, device="cpu",
                        default_root_dir=str(tmp_path / "eval"))
    results = evaluator.test(BoringModel(), ckpt_path=best)
    assert len(results) == 1 and np.isfinite(results[0]["test_loss"])
    weights = {k: v for k, v in ckpt["state"]["params"].items()}
    evaluated = BoringModel()
    Trainer(limit_test_batches=2, enable_checkpointing=False, seed=0,
            device="cpu", logger=False,
            default_root_dir=str(tmp_path / "eval2")).test(
                evaluated, ckpt_path=best)
    for k, v in evaluated.model.state_dict().items():
        assert torch.equal(v, weights[k]), k


def test_weights_round_trip_differs_from_init(tmp_path):
    """The driver's weights after a 2-worker fit are the trained ones:
    far from the init the same seed gives."""
    init = BoringModel()
    init.init_params(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in init.model.state_dict().items()}
    trainer = Trainer(plugins=[cpu_plugin(2)], max_epochs=1,
                      limit_train_batches=8, limit_val_batches=0,
                      num_sanity_val_steps=0, enable_checkpointing=False,
                      logger=False, seed=0, default_root_dir=str(tmp_path))
    module = BoringModel()
    trainer.fit(module)
    after = module._trained_state
    assert set(after) == set(before)
    delta = sum(float(torch.linalg.norm(after[k] - before[k]))
                for k in before)
    assert delta > 0.1
