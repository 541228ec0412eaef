"""The actor core: subprocess actors (``LocalBackend``), their RPC and
queue (``protocol``, ``worker_main``, ``worker_state``), the executor
each actor runs (``RLTExecutor``) and the worker-side queue handle.

Counterpart of ``ray_lightning_tpu/cluster/`` without the Ray backend
(``ray`` is not installed; ROADMAP.md queue 1 item 5) and without the
worker-to-worker frame routing of the peer channel (its tag-addressed
``Mailbox``, ``peer.py``, is ported: the fleet router's KV-ship
channel).
Only control, pickled payloads and results ride this plane: gradients
ride ``torch.distributed`` (NCCL on the card, gloo on the CPU)."""

from ray_lightning_tpu_torch.cluster.backend import (ActorHandle,
                                                     ClusterBackend, Future,
                                                     get_backend)
from ray_lightning_tpu_torch.cluster.executor import RLTExecutor
from ray_lightning_tpu_torch.cluster.local import (LocalBackend,
                                                   RemoteActorError)

__all__ = ["ActorHandle", "ClusterBackend", "Future", "LocalBackend",
           "RLTExecutor", "RemoteActorError", "get_backend"]
