"""MNIST data-parallel training, optionally as a Tune sweep.

    python -m ray_lightning_tpu_torch.examples.ray_ddp_example \
        [--num-workers 1] [--tune] [--platform cpu] [--smoke-test]

Counterpart of ``ray_lightning_tpu/examples/ray_ddp_example.py`` (the
reference's ``examples/ray_ddp_example.py``: ``train_mnist`` /
``tune_mnist`` and the CLI, :118-173) with ``RayPlugin`` workers: the
driver builds the module and the ``Trainer``, the workers train, and a
sweep's trials relay their metrics through the worker queue.  Workers
train on the card unless ``--platform cpu``; a sweep's trials write
under ``--local-dir`` (default ``<cwd>/rlt_tune``).
"""

from __future__ import annotations

import argparse
from typing import Optional

from ray_lightning_tpu_torch import (LightningMNISTClassifier, RayPlugin,
                                     Trainer, tune)
from ray_lightning_tpu_torch.tune import (TuneReportCallback,
                                          get_tune_resources)


def train_mnist(config: dict,
                data_dir: str = "",
                num_epochs: int = 10,
                num_workers: int = 1,
                use_gpu: bool = True,
                platform: Optional[str] = None,
                callbacks: Optional[list] = None,
                limit_train_batches: Optional[int] = None,
                limit_val_batches: Optional[int] = None) -> Trainer:
    """Train the MNIST classifier once (the reference's ``train_mnist``,
    :41-58)."""
    model = LightningMNISTClassifier(config, data_dir)
    plugin = RayPlugin(num_workers=num_workers, use_gpu=use_gpu,
                       platform=platform)
    trainer = Trainer(
        max_epochs=num_epochs,
        callbacks=list(callbacks or []),
        plugins=[plugin],
        limit_train_batches=limit_train_batches,
        limit_val_batches=limit_val_batches,
        num_sanity_val_steps=0,
        enable_checkpointing=False,
        default_root_dir=tune.get_trial_dir(),
    )
    trainer.fit(model)
    return trainer


def tune_mnist(data_dir: str = "",
               num_samples: int = 10,
               num_epochs: int = 10,
               num_workers: int = 1,
               use_gpu: bool = True,
               platform: Optional[str] = None,
               limit_train_batches: Optional[int] = None,
               limit_val_batches: Optional[int] = None,
               local_dir: Optional[str] = None):
    """Random search over the widths, lr and batch size (the reference's
    ``tune_mnist``, :81-115)."""
    config = {
        "layer_1": tune.choice([32, 64, 128]),
        "layer_2": tune.choice([64, 128, 256]),
        "lr": tune.loguniform(1e-4, 1e-1),
        "batch_size": tune.choice([32, 64, 128]),
    }

    def trainable(cfg):
        train_mnist(
            cfg, data_dir, num_epochs=num_epochs, num_workers=num_workers,
            use_gpu=use_gpu, platform=platform,
            limit_train_batches=limit_train_batches,
            limit_val_batches=limit_val_batches,
            callbacks=[TuneReportCallback(
                {"loss": "ptl/val_loss", "mean_accuracy": "ptl/val_accuracy"},
                on="validation_end")],
        )

    analysis = tune.run(
        trainable,
        config=config,
        num_samples=num_samples,
        metric="loss",
        mode="min",
        resources_per_trial=get_tune_resources(
            num_workers=num_workers, use_gpu=use_gpu and platform != "cpu"),
        local_dir=local_dir,
        name="tune_mnist",
    )
    print("Best hyperparameters found were:", analysis.best_config)
    return analysis


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-workers", type=int, default=1,
                        help="Number of training workers.")
    parser.add_argument("--platform", choices=("cuda", "cpu"),
                        default="cuda",
                        help="Where the workers train (cpu: gloo).")
    parser.add_argument("--tune", action="store_true", default=False,
                        help="Run a Tune hyperparameter sweep.")
    parser.add_argument("--num-samples", type=int, default=10,
                        help="Number of Tune trials.")
    parser.add_argument("--num-epochs", type=int, default=10)
    parser.add_argument("--local-dir", type=str, default=None,
                        help="Where a sweep's trials write.")
    parser.add_argument("--smoke-test", action="store_true", default=False,
                        help="One epoch of a few batches (two trials).")
    args = parser.parse_args(argv)

    kwargs: dict = dict(num_workers=args.num_workers,
                        use_gpu=args.platform == "cuda",
                        platform=args.platform)
    if args.smoke_test:
        kwargs.update(limit_train_batches=4, limit_val_batches=2)
        args.num_epochs = 1
        args.num_samples = 2

    if args.tune:
        tune_mnist(num_samples=args.num_samples, num_epochs=args.num_epochs,
                   local_dir=args.local_dir, **kwargs)
    else:
        trainer = train_mnist({}, num_epochs=args.num_epochs, **kwargs)
        print("Final metrics:", dict(trainer.callback_metrics))


if __name__ == "__main__":
    main()
