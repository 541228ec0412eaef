"""Runnable example scripts (the reference's ``ray_lightning/examples``).

Counterpart of ``ray_lightning_tpu/examples``: ``ray_ddp_example`` (MNIST
under ``RayPlugin``, ``--tune`` for a sweep), ``ray_ddp_tune`` (a
sweep with a datamodule and a worker ``init_hook``) and
``ray_ddp_sharded_example`` (GPT under ``RayShardedPlugin``, each
epoch's wall time and peak memory), ``ray_spmd_example`` (GPT over a
(data, fsdp, tensor) mesh under ``RaySpmdPlugin``) and
``ray_perf_tuning_example``
(``steps_per_execution``, ``cache_train_dataset`` and the bf16 batch
cast, each on top of the last, steps/s a fit).  They train on the
card by default; ``--platform cpu`` gives CPU workers on gloo, and
``--smoke-test`` cuts a run to one epoch of a few batches (what the
tests run, with both flags).
"""
