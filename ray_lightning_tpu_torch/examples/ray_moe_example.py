"""Mixture-of-experts GPT over a (data x expert x tensor) mesh of
workers: each rank of an expert group holds ``E / expert`` experts of
every routed layer (ops/moe.py) and the same tokens, each expert's FFN
Megatron-split over ``tensor``; the router's load-balance loss joins the
training loss and surfaces as the ``moe_aux`` metric.

    python -m ray_lightning_tpu_torch.examples.ray_moe_example \
        [--expert 2] [--tensor 2] [--data 1] [--model-size gpt2-moe-8e] \
        [--num-epochs 1] [--batch-size 8] [--platform cpu] [--smoke-test]

Counterpart of ``ray_lightning_tpu/examples/ray_moe_example.py`` (its
arguments and defaults; the JAX example's data axis takes the devices
left over, here ``--data`` says how many).  ``RaySpmdPlugin`` starts
``data x expert x tensor`` workers, one a card (NCCL on the card;
``--platform cpu``: CPU workers on gloo).  ``--batch-size`` is each data
shard's.  ``--smoke-test`` runs moe-tiny in fp32 at (data 2, expert 2,
tensor 2), eight CPU workers, batch 4, for two steps.
"""

from __future__ import annotations

import argparse
from typing import Optional

from ray_lightning_tpu_torch import RaySpmdPlugin, Trainer
from ray_lightning_tpu_torch.models.gpt import (CONFIGS, GPTLightningModule,
                                                gpt_partition_rules)
from ray_lightning_tpu_torch.parallel.strategy import SpmdStrategy


def train(expert: int = 2,
          tensor: int = 2,
          model_size: str = "gpt2-moe-8e",
          num_epochs: int = 1,
          batch_size: int = 8,
          dataset_size: int = 64,
          precision: str = "bf16",
          data: int = 1,
          platform: Optional[str] = None,
          limit_train_batches: Optional[int] = None,
          max_steps: int = -1,
          callbacks=(),
          default_root_dir: Optional[str] = None) -> Trainer:
    """One fit of ``model_size`` over ``data x expert x tensor``
    workers."""
    module = GPTLightningModule(CONFIGS[model_size],
                                dataset_size=dataset_size,
                                batch_size=batch_size)
    strategy = SpmdStrategy(rules=gpt_partition_rules(),
                            axis_names=("data", "expert", "tensor"),
                            axis_sizes={"data": data, "expert": expert,
                                        "tensor": tensor})
    trainer = Trainer(
        max_epochs=num_epochs,
        max_steps=max_steps,
        plugins=[RaySpmdPlugin(num_workers=data * expert * tensor,
                               platform=platform, strategy=strategy)],
        precision=precision,
        limit_train_batches=limit_train_batches,
        limit_val_batches=0,
        num_sanity_val_steps=0,
        enable_checkpointing=False,
        log_every_n_steps=1,
        callbacks=list(callbacks),
        default_root_dir=default_root_dir,
    )
    trainer.fit(module)
    return trainer


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--expert", type=int, default=2,
                        help="Expert-parallel axis size.")
    parser.add_argument("--tensor", type=int, default=2,
                        help="Tensor-parallel axis size within experts.")
    parser.add_argument("--data", type=int, default=1,
                        help="Data-parallel axis size.")
    parser.add_argument("--model-size", type=str, default="gpt2-moe-8e",
                        choices=sorted(CONFIGS))
    parser.add_argument("--num-epochs", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--platform", choices=("cuda", "cpu"),
                        default=None, help="cpu: CPU workers on gloo.")
    parser.add_argument("--smoke-test", action="store_true", default=False)
    args = parser.parse_args(argv)

    kwargs: dict = dict(expert=args.expert, tensor=args.tensor,
                        data=args.data, model_size=args.model_size,
                        num_epochs=args.num_epochs,
                        batch_size=args.batch_size, platform=args.platform)
    if args.smoke_test:
        kwargs.update(platform="cpu", model_size="moe-tiny", data=2,
                      batch_size=4, dataset_size=8, limit_train_batches=2,
                      precision="32")

    trainer = train(**kwargs)
    metrics = dict(trainer.callback_metrics)
    print("Final metrics:", metrics)
    assert "moe_aux" in metrics, "router aux loss did not surface"


if __name__ == "__main__":
    main()
