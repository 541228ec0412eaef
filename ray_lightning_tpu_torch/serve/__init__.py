"""Serving plane (port of ``ray_lightning_tpu/serve/``):

- ``buckets.py``   — sequence-length buckets
- ``kvcache.py``   — slot-indexed KV cache spec + slot free-list
- ``scheduler.py`` — request queue: tenant quota, fair share,
  continuous batch formation
- ``engine.py``    — per-bucket prefill + one decode step on one device;
  with ``paged=`` the prefix-reuse copy and suffix step, with ``spec=``
  the speculative draft plane
- ``worker.py``    — ``ServeWorker.serve_step``: one plan on the engine
- ``spec.py``      — ``SpecConfig``, the speculative-decode knobs
- ``fleet/pages.py`` — ``PageConfig`` and the paged-KV accounting behind
  prefix reuse

``Server``, the actor fleet and its router are not ported yet.
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
    "ServeWorker",
    "SlotAllocator",
    "SpecConfig",
    "bucket_for",
    "pad_to_bucket",
    "resolve_buckets",
]
