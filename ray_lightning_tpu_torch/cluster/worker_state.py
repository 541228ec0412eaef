"""Per-worker-process connection state.

Counterpart of ``ray_lightning_tpu/cluster/worker_state.py`` without the
elastic escrow and the peer channel.  It lives apart from ``worker_main``
because that module runs as ``__main__`` under ``python -m``: a global
there would be invisible to code importing it by name (two module
objects).  Everything that needs the driver connection goes through
here.
"""

from __future__ import annotations

from typing import Optional

from ray_lightning_tpu_torch.cluster.protocol import Connection

_conn: Optional[Connection] = None


def set_conn(conn: Optional[Connection]) -> None:
    global _conn
    _conn = conn


def queue_send(item) -> None:
    """Push an item onto the driver-side queue from inside an actor."""
    if _conn is None:
        raise RuntimeError("queue_send outside of a worker process")
    _conn.send({"type": "queue", "item": item})


__all__ = ["queue_send", "set_conn"]
