"""Long-context GPT training with ring attention: the sequence dimension
split over a ``sequence`` axis of workers, K/V blocks rotating around
the ring (parallel/ring.py), so no rank holds the [T, T] scores of the
whole context.

    python -m ray_lightning_tpu_torch.examples.ray_longcontext_example \
        [--sequence 4] [--seq-len 8192] [--model-size gpt2-small] \
        [--num-epochs 1] [--batch-size 1] [--platform cpu] [--smoke-test]

Counterpart of ``ray_lightning_tpu/examples/ray_longcontext_example.py``
(its arguments and defaults).  ``RaySpmdPlugin`` starts ``sequence``
workers, one a card, joined by ``torch.distributed`` (NCCL on the card;
``--platform cpu``: CPU workers on gloo); ``SpmdStrategy(axis_names=(
"data", "sequence"))`` gives each rank its ``seq_len / sequence`` slice
of every sequence.  ``--smoke-test`` runs the tiny GPT in fp32 at
``seq_len`` 256, batch 2, for two steps on CPU workers.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from ray_lightning_tpu_torch import RaySpmdPlugin, Trainer
from ray_lightning_tpu_torch.models.gpt import (CONFIGS, GPTLightningModule,
                                                gpt_partition_rules)
from ray_lightning_tpu_torch.parallel.strategy import SpmdStrategy


def train(sequence: int = 4,
          model_size: str = "gpt2-small",
          seq_len: int = 8192,
          num_epochs: int = 1,
          batch_size: int = 1,
          dataset_size: int = 8,
          precision: str = "bf16",
          platform: Optional[str] = None,
          limit_train_batches: Optional[int] = None,
          max_steps: int = -1,
          callbacks=(),
          default_root_dir: Optional[str] = None) -> Trainer:
    """One fit of ``model_size`` at context ``seq_len`` over a ring of
    ``sequence`` workers."""
    cfg = dataclasses.replace(CONFIGS[model_size], block_size=seq_len,
                              attention_impl="ring")
    module = GPTLightningModule(cfg, dataset_size=dataset_size,
                                batch_size=batch_size)
    strategy = SpmdStrategy(rules=gpt_partition_rules(),
                            axis_names=("data", "sequence"),
                            axis_sizes={"sequence": sequence})
    trainer = Trainer(
        max_epochs=num_epochs,
        max_steps=max_steps,
        plugins=[RaySpmdPlugin(num_workers=sequence, platform=platform,
                               strategy=strategy)],
        precision=precision,
        limit_train_batches=limit_train_batches,
        limit_val_batches=0,
        num_sanity_val_steps=0,
        enable_checkpointing=False,
        callbacks=list(callbacks),
        default_root_dir=default_root_dir,
    )
    trainer.fit(module)
    return trainer


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--sequence", type=int, default=4,
                        help="Ring size (sequence-parallel axis).")
    parser.add_argument("--seq-len", type=int, default=8192,
                        help="Total context length across the ring.")
    parser.add_argument("--model-size", type=str, default="gpt2-small",
                        choices=sorted(CONFIGS))
    parser.add_argument("--num-epochs", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--platform", choices=("cuda", "cpu"),
                        default=None, help="cpu: CPU workers on gloo.")
    parser.add_argument("--smoke-test", action="store_true", default=False)
    args = parser.parse_args(argv)

    kwargs: dict = dict(sequence=args.sequence, seq_len=args.seq_len,
                        model_size=args.model_size,
                        num_epochs=args.num_epochs,
                        batch_size=args.batch_size, platform=args.platform)
    if args.smoke_test:
        kwargs.update(platform="cpu", model_size="tiny", seq_len=256,
                      batch_size=2, dataset_size=4, limit_train_batches=2,
                      precision="32")

    trainer = train(**kwargs)
    print("Final metrics:", dict(trainer.callback_metrics))


if __name__ == "__main__":
    main()
