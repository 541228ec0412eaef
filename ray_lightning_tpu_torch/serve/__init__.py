"""Serving plane (port of ``ray_lightning_tpu/serve/``):

- ``buckets.py``   — sequence-length buckets
- ``kvcache.py``   — slot-indexed KV cache spec + slot free-list
- ``scheduler.py`` — request queue: tenant quota, fair share,
  continuous batch formation
- ``engine.py``    — per-bucket prefill + one decode step on one device
- ``worker.py``    — ``ServeWorker.serve_step``: one plan on the engine

``Server`` and the actor fleet are not ported yet.
"""

from ray_lightning_tpu_torch.serve.buckets import (  # noqa: F401
    DEFAULT_BUCKETS,
    bucket_for,
    pad_to_bucket,
    resolve_buckets,
)
from ray_lightning_tpu_torch.serve.engine import ServeEngine  # noqa: F401
from ray_lightning_tpu_torch.serve.kvcache import (  # noqa: F401
    KVCacheSpec,
    SlotAllocator,
)
from ray_lightning_tpu_torch.serve.scheduler import (  # noqa: F401
    Scheduler,
    ServeRequest,
)
from ray_lightning_tpu_torch.serve.worker import ServeWorker  # noqa: F401

__all__ = [
    "DEFAULT_BUCKETS",
    "KVCacheSpec",
    "Scheduler",
    "ServeEngine",
    "ServeRequest",
    "ServeWorker",
    "SlotAllocator",
    "bucket_for",
    "pad_to_bucket",
    "resolve_buckets",
]
