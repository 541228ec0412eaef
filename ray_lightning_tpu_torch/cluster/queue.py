"""Worker-side end of the worker-to-driver queue.

Counterpart of ``WorkerQueueProxy`` in ``ray_lightning_tpu/cluster/
queue.py`` (the reference's ``ray.util.queue.Queue``, drained by
``util.process_results``).  The queue rides the actor's socket as
unsolicited frames; the worker-side object is a picklable proxy with
``put``.
"""

from __future__ import annotations

from typing import Any


class WorkerQueueProxy:
    """Picklable worker-side queue handle: inside an actor subprocess,
    ``put`` sends through the worker's driver connection."""

    def put(self, item: Any) -> None:
        from ray_lightning_tpu_torch.cluster import worker_state
        worker_state.queue_send(item)


__all__ = ["WorkerQueueProxy"]
