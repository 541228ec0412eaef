"""Train a GPT language model under ZeRO-1 (``RayShardedPlugin``),
printing each epoch's wall time and peak device memory.

    python -m ray_lightning_tpu_torch.examples.ray_ddp_sharded_example \
        [--num-workers 1] [--model-size gpt2-small] [--num-epochs 1] \
        [--batch-size 8] [--platform cpu] [--smoke-test]

Counterpart of ``ray_lightning_tpu/examples/ray_ddp_sharded_example.py``
(the reference's ``examples/ray_ddp_sharded_example.py``: ImageGPT under
``RayShardedPlugin`` with ``CUDACallback``, :16-45).  The model is the
in-tree GPT family (models/gpt.py) and the sharding the port's ZeRO-1
(parallel/strategy.py): gradients reduce-scattered, the fp32 master and
the moments sharded, params all-gathered.  :class:`GPUPerfCallback` is
the package's ``ThroughputMonitor`` plus the reference's console line.
Workers train on the card unless ``--platform cpu`` (or
``--no-use-gpu``); ``--smoke-test`` cuts the run to two steps of the
tiny GPT in fp32 on CPU workers.
"""

from __future__ import annotations

import argparse
import functools
import time
from typing import Optional

from ray_lightning_tpu_torch import RayShardedPlugin, Trainer, session
from ray_lightning_tpu_torch.models.gpt import CONFIGS, GPTLightningModule
from ray_lightning_tpu_torch.utils.profiling import (ThroughputMonitor,
                                                     peak_device_memory_bytes)


class GPUPerfCallback(ThroughputMonitor):
    """Epoch wall time and peak device memory (the reference's
    ``CUDACallback``): the measurement is ``ThroughputMonitor``'s, whose
    metrics ride rank 0's result relay; this adds the console line,
    printed on the driver (a worker sends it through the queue)."""

    def on_train_epoch_end(self, trainer, module):
        t0 = self._epoch_t0
        super().on_train_epoch_end(trainer, module)
        if trainer.is_global_zero and t0 is not None:
            peak = peak_device_memory_bytes(trainer.device)
            mem = f", peak memory {peak / 1e6:.0f}MB" if peak else ""
            line = (f"Epoch {trainer.current_epoch}: "
                    f"{time.monotonic() - t0:.2f}s{mem}")
            if trainer.plugin.remote:
                session.put_queue(functools.partial(print, line,
                                                    flush=True))
            else:
                print(line, flush=True)


def train(num_workers: int = 1,
          use_gpu: bool = True,
          platform: Optional[str] = None,
          model_size: str = "gpt2-small",
          num_epochs: int = 1,
          batch_size: int = 8,
          dataset_size: int = 256,
          precision: str = "bf16",
          limit_train_batches: Optional[int] = None,
          callbacks: Optional[list] = None,
          default_root_dir: Optional[str] = None,
          timeout_s: Optional[float] = None) -> Trainer:
    """One ZeRO-1 fit of ``model_size`` (the reference's ``train``);
    ``callbacks`` run beside :class:`GPUPerfCallback`."""
    module = GPTLightningModule(CONFIGS[model_size],
                                dataset_size=dataset_size,
                                batch_size=batch_size)
    plugin_kw = {} if timeout_s is None else {"timeout_s": timeout_s}
    plugin = RayShardedPlugin(num_workers=num_workers, use_gpu=use_gpu,
                              platform=platform, **plugin_kw)
    trainer = Trainer(
        max_epochs=num_epochs,
        plugins=[plugin],
        callbacks=[GPUPerfCallback(), *(callbacks or [])],
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
    parser.add_argument("--num-workers", type=int, default=1)
    parser.add_argument("--use-gpu", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="Workers train on the card (--no-use-gpu: "
                             "CPU workers).")
    parser.add_argument("--platform", choices=("cuda", "cpu"),
                        default=None,
                        help="cpu: CPU workers on gloo, whatever "
                             "--use-gpu says.")
    parser.add_argument("--model-size", type=str, default="gpt2-small",
                        choices=sorted(CONFIGS))
    parser.add_argument("--num-epochs", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--smoke-test", action="store_true", default=False)
    args = parser.parse_args(argv)

    kwargs: dict = dict(num_workers=args.num_workers, use_gpu=args.use_gpu,
                        platform=args.platform, model_size=args.model_size,
                        num_epochs=args.num_epochs,
                        batch_size=args.batch_size)
    if args.smoke_test:
        kwargs.update(platform="cpu", use_gpu=False, model_size="tiny",
                      num_epochs=1, batch_size=2, dataset_size=8,
                      limit_train_batches=2, precision="32")

    trainer = train(**kwargs)
    print("Final metrics:", dict(trainer.callback_metrics))


if __name__ == "__main__":
    # run under the module's import name: the workers unpickle its
    # callback by that path (stdlib pickle)
    from ray_lightning_tpu_torch.examples import ray_ddp_sharded_example
    ray_ddp_sharded_example.main()
