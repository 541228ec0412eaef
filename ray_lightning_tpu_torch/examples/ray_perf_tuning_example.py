"""Throughput tuning for a small model, where the host is the bottleneck.

    python -m ray_lightning_tpu_torch.examples.ray_perf_tuning_example \
        [--smoke-test] [--num-workers N] [--platform cpu]

Counterpart of ``ray_lightning_tpu/examples/ray_perf_tuning_example.py``.
For a small model (the MNIST classifier at B=128) a step is a few
hundred microseconds of device work behind tens of launches, so the
host's per-step work and the batch's copy set the pace, not the card.
The example walks the three knobs that cut them, each on top of the
last:

1. ``Trainer(steps_per_execution=k)``: k optimizer steps ride one
   dispatch, on the card one CUDA graph replay of k captured steps, so
   the host launches once per k steps.
2. ``Trainer(cache_train_dataset=True)``: the train set is uploaded once
   and stays on the device; each epoch it is repacked in the loader's
   own order (shuffle included) and each step gathers its batch by
   index, so no batch crosses the host link.  Under a distributed
   plugin each worker holds its own rows of the set.
3. ``Trainer(precision="bf16")``: floating batch leaves cast to bf16 on
   the host, halving whatever copy remains.

Also on by default: the double-buffered stream (``RLT_STREAM_PREFETCH``:
the next two batches copied from pinned memory on a copy stream while a
step runs) and bf16-resident params with an fp32 master for GPT
(``RLT_BF16_PARAMS``).

Fits run on the card unless ``--platform cpu``; with ``--num-workers N``
they run in ``RayPlugin`` workers.  Each line prints the fit's steps/s,
set-up and the first chunk's capture included.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

from ray_lightning_tpu_torch import (LightningMNISTClassifier, RayPlugin,
                                     Trainer)


def run(steps_per_execution: int = 1, cache: bool = False,
        precision: str = "32", num_workers: int = 0,
        platform: Optional[str] = None, max_epochs: int = 2,
        train_size: int = 2048) -> "tuple[float, int]":
    """One fit with the given knobs: (seconds, steps)."""
    where = (dict(plugins=[RayPlugin(num_workers=num_workers,
                                     platform=platform)])
             if num_workers > 0 else dict(device=platform))
    model = LightningMNISTClassifier(config={"batch_size": 128},
                                     train_size=train_size)
    trainer = Trainer(
        max_epochs=max_epochs,
        steps_per_execution=steps_per_execution,
        cache_train_dataset=cache,
        precision=precision,
        enable_checkpointing=False,
        logger=False,
        num_sanity_val_steps=0,
        limit_val_batches=0,
        log_every_n_steps=10**9,
        seed=0,
        **where,
    )
    t0 = time.monotonic()
    trainer.fit(model)
    return time.monotonic() - t0, trainer.global_step


CONFIGS = [
    ("streamed (baseline)", dict()),
    ("steps_per_execution=8", dict(steps_per_execution=8)),
    ("+ cache_train_dataset", dict(steps_per_execution=8, cache=True)),
    ("+ precision=bf16", dict(steps_per_execution=8, cache=True,
                              precision="bf16")),
]


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--smoke-test", action="store_true",
                        help="one epoch of 4 batches per config")
    parser.add_argument("--num-workers", type=int, default=0,
                        help=">0: run in RayPlugin workers (the cache "
                             "splits across them)")
    parser.add_argument("--platform", choices=("cpu", "cuda"),
                        default=None,
                        help="cpu: train on the CPU (gloo workers with "
                             "--num-workers); default: the card")
    args = parser.parse_args()

    kw = dict(num_workers=args.num_workers, platform=args.platform)
    if args.smoke_test:
        kw.update(max_epochs=1, train_size=512)
    for name, knobs in CONFIGS:
        secs, steps = run(**{**kw, **knobs})
        print(f"{name:28s} {steps / secs:8.1f} steps/s "
              f"({steps} steps in {secs:.1f}s)")


if __name__ == "__main__":
    main()
