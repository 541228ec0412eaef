"""Pipeline-parallel GPT: GPipe microbatching over a (data x stage) mesh
of workers.  The blocks' parameters are layer-stacked and split over the
``stage`` axis, activations hop between stages, and each microbatch's
backward runs in the reverse schedule (parallel/pipeline.py).  Raise
``--microbatches`` to shrink the bubble ((S-1)/(M+S-1)).

    python -m ray_lightning_tpu_torch.examples.ray_pipeline_example \
        [--stages 4] [--microbatches 4] [--data 1] \
        [--model-size gpt2-small] [--num-epochs 1] [--batch-size 8] \
        [--platform cpu] [--smoke-test]

Counterpart of ``ray_lightning_tpu/examples/ray_pipeline_example.py``
(its arguments and defaults; the JAX example's data axis takes the
devices left over, here ``--data`` says how many pipelines run, each
over ``--stages`` workers).  ``RaySpmdPlugin`` starts ``data x stages``
workers, one a card (NCCL on the card; ``--platform cpu``: CPU workers
on gloo).  ``--batch-size`` is each pipeline's.  ``--smoke-test`` runs
the tiny GPT in fp32 at two stages of two microbatches, batch 4, over
two pipelines (four CPU workers) for two steps.
"""

from __future__ import annotations

import argparse
from typing import Optional

from ray_lightning_tpu_torch import RaySpmdPlugin, Trainer
from ray_lightning_tpu_torch.models.gpt import CONFIGS
from ray_lightning_tpu_torch.models.pipeline_gpt import PipelinedGPT
from ray_lightning_tpu_torch.parallel.pipeline import PipelineStrategy


def train(stages: int = 4,
          microbatches: int = 4,
          model_size: str = "gpt2-small",
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
    """One fit of ``PipelinedGPT(model_size)`` over ``data x stages``
    workers."""
    module = PipelinedGPT(model_size, n_microbatches=microbatches,
                          dataset_size=dataset_size, batch_size=batch_size)
    trainer = Trainer(
        max_epochs=num_epochs,
        max_steps=max_steps,
        plugins=[RaySpmdPlugin(num_workers=data * stages, platform=platform,
                               strategy=PipelineStrategy(stages=stages))],
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
    parser.add_argument("--stages", type=int, default=4,
                        help="Pipeline stages (must divide n_layer).")
    parser.add_argument("--microbatches", type=int, default=4)
    parser.add_argument("--data", type=int, default=1,
                        help="Data-parallel pipelines.")
    parser.add_argument("--model-size", type=str, default="gpt2-small",
                        choices=sorted(CONFIGS))
    parser.add_argument("--num-epochs", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--platform", choices=("cuda", "cpu"),
                        default=None, help="cpu: CPU workers on gloo.")
    parser.add_argument("--smoke-test", action="store_true", default=False)
    args = parser.parse_args(argv)

    kwargs: dict = dict(stages=args.stages, microbatches=args.microbatches,
                        data=args.data, model_size=args.model_size,
                        num_epochs=args.num_epochs,
                        batch_size=args.batch_size, platform=args.platform)
    if args.smoke_test:
        kwargs.update(platform="cpu", model_size="tiny", stages=2,
                      microbatches=2, data=2, batch_size=4, dataset_size=8,
                      limit_train_batches=2, precision="32")

    trainer = train(**kwargs)
    print("Final metrics:", dict(trainer.callback_metrics))


if __name__ == "__main__":
    main()
