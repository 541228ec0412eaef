"""Serving plane (port of ``ray_lightning_tpu/serve/``):

- ``buckets.py``   — sequence-length buckets
- ``kvcache.py``   — slot-indexed KV cache spec + slot free-list
- ``scheduler.py`` — request queue: tenant quota, fair share,
  continuous batch formation
- ``engine.py``    — per-bucket prefill + one decode step on one device;
  with ``paged=`` the prefix-reuse copy and suffix step, with ``spec=``
  the speculative draft plane; each program one CUDA graph on the card
  (the counterpart of the JAX engine's AOT warm-up)
- ``worker.py``    — ``ServeWorker``: the persistent serve actor
  (``setup_serve``, ``serve_step``, ``serve_stats``, ``teardown_serve``)
  over its block of slots, or one plan on an engine in process
- ``server.py``    — ``Server``: the serving front door (scheduler pump
  on the driver, serve actors through ``cluster/``)
- ``spec.py``      — ``SpecConfig``, the speculative-decode knobs
- ``fleet/``        — ``FleetServer``: N ``Server`` replicas behind one
  front door (router, replicas, autoscaler, prefix federation), and
  ``pages.py``'s ``PageConfig`` and paged-KV accounting behind prefix
  reuse
"""

from ray_lightning_tpu_torch.serve.buckets import (  # noqa: F401
    DEFAULT_BUCKETS,
    bucket_for,
    pad_to_bucket,
    resolve_buckets,
)
from ray_lightning_tpu_torch.serve.engine import ServeEngine  # noqa: F401
from ray_lightning_tpu_torch.serve.fleet.pages import (  # noqa: F401
    PageConfig,
    PagedKV,
)
from ray_lightning_tpu_torch.serve.kvcache import (  # noqa: F401
    KVCacheSpec,
    SlotAllocator,
)
from ray_lightning_tpu_torch.serve.scheduler import (  # noqa: F401
    Scheduler,
    ServeRequest,
)
from ray_lightning_tpu_torch.serve.server import (  # noqa: F401
    ServeSpec,
    Server,
)
from ray_lightning_tpu_torch.serve.spec import SpecConfig  # noqa: F401
from ray_lightning_tpu_torch.serve.worker import ServeWorker  # noqa: F401

__all__ = [
    "DEFAULT_BUCKETS",
    "KVCacheSpec",
    "PageConfig",
    "PagedKV",
    "Scheduler",
    "ServeEngine",
    "ServeRequest",
    "ServeSpec",
    "ServeWorker",
    "Server",
    "SlotAllocator",
    "SpecConfig",
    "bucket_for",
    "pad_to_bucket",
    "resolve_buckets",
]
