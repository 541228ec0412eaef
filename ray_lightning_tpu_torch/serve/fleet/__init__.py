"""Fleet serving plane (port of ``ray_lightning_tpu/serve/fleet/``).

Ported so far: ``pages.py`` — paged KV accounting and the prefix-hash
index behind "shared system prompts prefill once per replica".  The
router, replicas, autoscaler and prefix federation are not ported yet.
"""

from ray_lightning_tpu_torch.serve.fleet.pages import (  # noqa: F401
    PageConfig,
    PagedKV,
    PagePool,
    PrefixIndex,
    identity_page_table,
)

__all__ = ["PageConfig", "PagePool", "PagedKV", "PrefixIndex",
           "identity_page_table"]
