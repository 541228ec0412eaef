"""Train a GPT language model over a (data, fsdp, tensor) mesh of
workers: FSDP parameter sharding and Megatron tensor parallelism under
``gpt_partition_rules``, one rank a card.

    python -m ray_lightning_tpu_torch.examples.ray_spmd_example \
        [--data 1] [--fsdp 1] [--tensor 2] [--model-size gpt2-small] \
        [--num-epochs 1] [--batch-size 8] [--platform cpu] [--smoke-test]

Counterpart of ``ray_lightning_tpu/examples/ray_spmd_example.py``.  There
one process drives many local devices; here ``RaySpmdPlugin`` starts
``data x fsdp x tensor`` workers joined by ``torch.distributed`` (NCCL
on the card; ``--platform cpu``: CPU workers on gloo), and the strategy
(parallel/strategy.py ``SpmdStrategy``) cuts the model into each rank's
blocks.  ``--batch-size`` is each batch shard's (a tensor group's ranks
share one).  ``--smoke-test`` runs the tiny GPT in fp32 for two steps
on CPU workers at (fsdp 2, tensor 2) unless the axes are given.
"""

from __future__ import annotations

import argparse
from typing import Optional

from ray_lightning_tpu_torch import RaySpmdPlugin, Trainer
from ray_lightning_tpu_torch.models.gpt import (CONFIGS, GPTLightningModule,
                                                gpt_partition_rules)
from ray_lightning_tpu_torch.parallel.strategy import SpmdStrategy


def train(data: int = 1,
          fsdp: int = 1,
          tensor: int = 2,
          model_size: str = "gpt2-small",
          num_epochs: int = 1,
          batch_size: int = 8,
          dataset_size: int = 64,
          precision: str = "bf16",
          platform: Optional[str] = None,
          limit_train_batches: Optional[int] = None,
          default_root_dir: Optional[str] = None) -> Trainer:
    """One fit of ``model_size`` over ``data * fsdp * tensor`` workers."""
    module = GPTLightningModule(CONFIGS[model_size],
                                dataset_size=dataset_size,
                                batch_size=batch_size)
    strategy = SpmdStrategy(rules=gpt_partition_rules(),
                            axis_names=("data", "fsdp", "tensor"),
                            axis_sizes={"data": data, "fsdp": fsdp,
                                        "tensor": tensor})
    trainer = Trainer(
        max_epochs=num_epochs,
        plugins=[RaySpmdPlugin(num_workers=data * fsdp * tensor,
                               platform=platform, strategy=strategy)],
        precision=precision,
        limit_train_batches=limit_train_batches,
        limit_val_batches=0,
        num_sanity_val_steps=0,
        enable_checkpointing=False,
        default_root_dir=default_root_dir,
    )
    trainer.fit(module)
    return trainer


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=int, default=None,
                        help="Data-parallel axis size.")
    parser.add_argument("--fsdp", type=int, default=None,
                        help="FSDP (ZeRO-3 parameter sharding) axis size.")
    parser.add_argument("--tensor", type=int, default=None,
                        help="Megatron-style tensor-parallel axis size.")
    parser.add_argument("--model-size", type=str, default="gpt2-small",
                        choices=sorted(CONFIGS))
    parser.add_argument("--num-epochs", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--platform", choices=("cuda", "cpu"),
                        default=None, help="cpu: CPU workers on gloo.")
    parser.add_argument("--smoke-test", action="store_true", default=False)
    args = parser.parse_args(argv)

    axes = {"data": args.data, "fsdp": args.fsdp, "tensor": args.tensor}
    defaults = ({"data": 1, "fsdp": 2, "tensor": 2} if args.smoke_test
                else {"data": 1, "fsdp": 1, "tensor": 2})
    kwargs: dict = dict({a: v if v is not None else defaults[a]
                         for a, v in axes.items()},
                        model_size=args.model_size,
                        num_epochs=args.num_epochs,
                        batch_size=args.batch_size, platform=args.platform)
    if args.smoke_test:
        kwargs.update(platform="cpu", model_size="tiny", batch_size=4,
                      dataset_size=16, limit_train_batches=2,
                      precision="32")

    trainer = train(**kwargs)
    print("Final metrics:", dict(trainer.callback_metrics))


if __name__ == "__main__":
    main()
