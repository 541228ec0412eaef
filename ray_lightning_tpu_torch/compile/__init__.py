"""Compile plane: the kernel libraries as a cached, shared resource.

Counterpart of ``ray_lightning_tpu/compile/``:

- ``cache.py`` — where the nvcc-built kernel libraries live (a
  namespaced directory of a root every process of a run can share),
  hits, misses and compile seconds (nvcc plus CUDA-graph capture);
- ``aot.py`` — the kernel builds on a background thread during fit
  set-up, and the planner's verify step (one fake-tensor train step a
  candidate);
- ``shipping.py`` — packing a cache root for workers without the
  driver's disk.

Wired through ``core/trainer.py`` (activation, the precompiler,
time-to-first-step), ``plugins/ray_ddp.py`` (the worker env),
``tune/runner.py`` (one cache an experiment) and ``serve/`` (the
engine's stats).
"""

from ray_lightning_tpu_torch.compile.aot import (AotPrecompiler,
                                                 global_batch_abstract,
                                                 stack_abstract)
from ray_lightning_tpu_torch.compile.cache import (CacheStats,
                                                   CompileCacheConfig,
                                                   DEFAULT_ROOT, activate,
                                                   active_dir, deactivate,
                                                   namespace_dir,
                                                   note_first_step,
                                                   publish_metrics,
                                                   reset_stats, stats,
                                                   status_word)

__all__ = [
    "AotPrecompiler",
    "CacheStats",
    "CompileCacheConfig",
    "DEFAULT_ROOT",
    "activate",
    "active_dir",
    "deactivate",
    "global_batch_abstract",
    "namespace_dir",
    "note_first_step",
    "publish_metrics",
    "reset_stats",
    "stack_abstract",
    "stats",
    "status_word",
]
