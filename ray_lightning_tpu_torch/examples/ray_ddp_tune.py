"""A Tune sweep with a ``LightningDataModule`` and a worker ``init_hook``.

    python -m ray_lightning_tpu_torch.examples.ray_ddp_tune \
        [--num-workers 1] [--platform cpu] [--smoke-test]

Counterpart of ``ray_lightning_tpu/examples/ray_ddp_tune.py`` (the
reference's ``examples/ray_ddp_tune.py``: Tune with an MNIST datamodule
and an ``init_hook`` that downloads the data under a FileLock,
:22-25).  Here the datamodule writes its synthetic dataset once per
node in ``prepare_data`` (an atomic rename), and the ``init_hook`` does
the same on every worker before training (``RayPlugin`` runs the hook
on each actor first).  Workers train on the card unless
``--platform cpu``; trials write under ``--local-dir`` (default
``<cwd>/rlt_tune``).
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional

import numpy as np

from ray_lightning_tpu_torch import (DataLoader, LightningDataModule,
                                     LightningMNISTClassifier, RayPlugin,
                                     Trainer, tune)
from ray_lightning_tpu_torch.core.data import ArrayDataset
from ray_lightning_tpu_torch.models.boring import synthetic_mnist
from ray_lightning_tpu_torch.tune import (TuneReportCallback,
                                          get_tune_resources)

CACHE = os.path.join(tempfile.gettempdir(), "rlt_torch_mnist_cache.npz")


def download_data() -> None:
    """Write the dataset once per node (the reference guards its
    download with a FileLock, :22-25; here an atomic rename makes a
    concurrent second write merely redundant)."""
    if os.path.exists(CACHE):
        return
    train = synthetic_mnist(512, seed=0)
    val = synthetic_mnist(128, seed=1)
    train_x, train_y = train.take(np.arange(len(train)))
    val_x, val_y = val.take(np.arange(len(val)))
    tmp = CACHE.replace(".npz", f".tmp.{os.getpid()}.npz")
    np.savez(tmp, train_x=train_x, train_y=train_y, val_x=val_x, val_y=val_y)
    os.replace(tmp, CACHE)


class MNISTDataModule(LightningDataModule):
    def __init__(self, batch_size: int = 32):
        super().__init__()
        self.batch_size = batch_size
        self._train = self._val = None

    def prepare_data(self):
        download_data()

    def setup(self, stage):
        data = np.load(CACHE)
        self._train = ArrayDataset(data["train_x"], data["train_y"])
        self._val = ArrayDataset(data["val_x"], data["val_y"])

    def train_dataloader(self):
        return DataLoader(self._train, batch_size=self.batch_size,
                          shuffle=True)

    def val_dataloader(self):
        return DataLoader(self._val, batch_size=self.batch_size)


def train_mnist(config: dict,
                num_epochs: int = 10,
                num_workers: int = 1,
                use_gpu: bool = True,
                platform: Optional[str] = None,
                limit_train_batches: Optional[int] = None,
                limit_val_batches: Optional[int] = None) -> None:
    model = LightningMNISTClassifier(config)
    dm = MNISTDataModule(batch_size=int(config.get("batch_size", 32)))
    plugin = RayPlugin(num_workers=num_workers, use_gpu=use_gpu,
                       platform=platform, init_hook=download_data)
    trainer = Trainer(
        max_epochs=num_epochs,
        plugins=[plugin],
        callbacks=[TuneReportCallback(
            {"loss": "ptl/val_loss", "mean_accuracy": "ptl/val_accuracy"},
            on="validation_end")],
        limit_train_batches=limit_train_batches,
        limit_val_batches=limit_val_batches,
        num_sanity_val_steps=0,
        enable_checkpointing=False,
        default_root_dir=tune.get_trial_dir(),
    )
    trainer.fit(model, dm)


def tune_mnist(num_samples: int = 10,
               num_epochs: int = 10,
               num_workers: int = 1,
               use_gpu: bool = True,
               platform: Optional[str] = None,
               limit_train_batches: Optional[int] = None,
               limit_val_batches: Optional[int] = None,
               local_dir: Optional[str] = None):
    config = {
        "layer_1": tune.choice([32, 64, 128]),
        "layer_2": tune.choice([64, 128, 256]),
        "lr": tune.loguniform(1e-4, 1e-1),
        "batch_size": tune.choice([32, 64, 128]),
    }

    def trainable(cfg):
        train_mnist(cfg, num_epochs=num_epochs, num_workers=num_workers,
                    use_gpu=use_gpu, platform=platform,
                    limit_train_batches=limit_train_batches,
                    limit_val_batches=limit_val_batches)

    analysis = tune.run(
        trainable,
        config=config,
        num_samples=num_samples,
        metric="loss",
        mode="min",
        resources_per_trial=get_tune_resources(
            num_workers=num_workers, use_gpu=use_gpu and platform != "cpu"),
        local_dir=local_dir,
        name="tune_mnist_datamodule",
    )
    print("Best hyperparameters found were:", analysis.best_config)
    return analysis


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-workers", type=int, default=1)
    parser.add_argument("--platform", choices=("cuda", "cpu"),
                        default="cuda",
                        help="Where the workers train (cpu: gloo).")
    parser.add_argument("--num-samples", type=int, default=10)
    parser.add_argument("--num-epochs", type=int, default=10)
    parser.add_argument("--local-dir", type=str, default=None,
                        help="Where the trials write.")
    parser.add_argument("--smoke-test", action="store_true", default=False,
                        help="One epoch of a few batches, one trial.")
    args = parser.parse_args(argv)

    kwargs: dict = dict(num_workers=args.num_workers,
                        use_gpu=args.platform == "cuda",
                        platform=args.platform)
    if args.smoke_test:
        kwargs.update(limit_train_batches=4, limit_val_batches=2)
        args.num_epochs = 1
        args.num_samples = 1

    tune_mnist(num_samples=args.num_samples, num_epochs=args.num_epochs,
               local_dir=args.local_dir, **kwargs)


if __name__ == "__main__":
    # run under the module's import name: the workers unpickle its
    # ``init_hook`` and datamodule by that path (stdlib pickle)
    from ray_lightning_tpu_torch.examples import ray_ddp_tune
    ray_ddp_tune.main()
