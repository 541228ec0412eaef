"""Fleet serving plane (port of ``ray_lightning_tpu/serve/fleet/``): a
front-door router over N serve replicas.

- ``router.py``     — :class:`FleetServer`: least-loaded + tenant-sticky
  routing, fleet-wide quotas, failover, autoscale grow and shrink,
  drain; disaggregated prefill/decode pools with codec-compressed KV
  shipping; federated prefix fetches
- ``replica.py``    — :class:`FleetReplica`: lifecycle + load probes
  around one unmodified :class:`~ray_lightning_tpu_torch.serve.server.
  Server`
- ``autoscale.py``  — :class:`Autoscaler`: queue-depth / TTFT-p99-driven
  grow & shrink with patience + cooldown debouncing
- ``pages.py``      — paged KV accounting + the prefix-hash index behind
  "shared system prompts prefill once per replica"
- ``federation.py`` — :class:`PrefixDirectory`: the router-resident
  fleet-wide donor registry behind "prefill once per fleet"
- ``config.py``     — :class:`FleetConfig` (+ the ``RLT_FLEET*`` env
  round trip)

The JAX package's ``selfcheck.py`` is not ported yet.
"""

from ray_lightning_tpu_torch.serve.fleet.autoscale import (  # noqa: F401
    Autoscaler,
)
from ray_lightning_tpu_torch.serve.fleet.config import (  # noqa: F401
    FleetConfig,
)
from ray_lightning_tpu_torch.serve.fleet.federation import (  # noqa: F401
    PrefixDirectory,
)
from ray_lightning_tpu_torch.serve.fleet.pages import (  # noqa: F401
    PageConfig,
    PagedKV,
    PagePool,
    PrefixIndex,
    identity_page_table,
)
from ray_lightning_tpu_torch.serve.fleet.replica import (  # noqa: F401
    FleetReplica,
)
from ray_lightning_tpu_torch.serve.fleet.router import (  # noqa: F401
    FleetReplicaLost,
    FleetRequest,
    FleetServer,
    pick_replica,
)

__all__ = [
    "FleetServer",
    "FleetRequest",
    "FleetReplica",
    "FleetReplicaLost",
    "FleetConfig",
    "Autoscaler",
    "PageConfig",
    "PagedKV",
    "PagePool",
    "PrefixDirectory",
    "PrefixIndex",
    "identity_page_table",
    "pick_replica",
]
