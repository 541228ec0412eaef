"""Per-worker-process connection state: the driver connection, the
worker-to-worker peer channel and the elastic plane's recovery escrow.

Counterpart of ``ray_lightning_tpu/cluster/worker_state.py`` without the
Ray transport (the Ray backend is not ported, ROADMAP.md queue 1 item
5).  It lives apart from ``worker_main`` because that module runs as
``__main__`` under ``python -m``: a global there would be invisible to
code importing it by name (two module objects).  Everything that needs
the driver connection goes through here.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from ray_lightning_tpu_torch.cluster.peer import Mailbox
from ray_lightning_tpu_torch.cluster.protocol import Connection

_log = logging.getLogger(__name__)

_conn: Optional[Connection] = None
_peer_mailbox = Mailbox()

_escrow_lock = threading.Lock()
_escrow: Optional[dict] = None
_peer_drop = 0


def set_conn(conn: Optional[Connection]) -> None:
    global _conn
    _conn = conn


def queue_send(item) -> None:
    """Push an item onto the driver-side queue from inside an actor."""
    if _conn is None:
        raise RuntimeError("queue_send outside of a worker process")
    _conn.send({"type": "queue", "item": item})


# -- worker-to-worker peer channel ---------------------------------------------


def peer_mailbox() -> Mailbox:
    """This worker process's peer-payload mailbox, fed by worker_main's
    frame reader (the backend's ``peer`` frames) through
    :func:`peer_push`."""
    return _peer_mailbox


def peer_push(item: dict) -> None:
    """Deposit an inbound peer payload ``{"tag": ..., "wire": ...}``.
    An armed ``peerdrop`` fault (elastic/faults.py) swallows the frame
    here, on the receiving side: the lossy-fabric chaos case."""
    global _peer_drop
    with _escrow_lock:
        dropped = _peer_drop > 0
        if dropped:
            _peer_drop -= 1
        remaining = _peer_drop
    if dropped:
        _log.warning("peerdrop fault: dropping inbound peer frame %r (%d "
                     "more to drop)", item.get("tag"), remaining)
        return
    _peer_mailbox.put(tuple(item["tag"]), item["wire"])


def arm_peer_drop(count: int) -> None:
    """Arm the ``peerdrop`` chaos fault: swallow the next ``count``
    inbound peer frames on this process."""
    global _peer_drop
    with _escrow_lock:
        _peer_drop += max(0, int(count))


def peer_drop_pending() -> int:
    with _escrow_lock:
        return _peer_drop


def peer_send(dst_actor_name: str, item: dict) -> None:
    """Send a peer payload to another worker by actor name: a ``peer``
    frame on the driver socket, which the driver routes to the
    destination's connection (``LocalBackend.peer_route``)."""
    if _conn is None:
        raise RuntimeError("peer_send outside of a worker process")
    _conn.send({"type": "peer", "dst": dst_actor_name, "item": item})


# -- recovery escrow (elastic/redundancy.py) -----------------------------------


def escrow_set(item: Optional[dict]) -> None:
    """Deposit this process's latest recovery escrow (the elastic parity
    tick).  One cell, latest wins: recovery only wants the most recent
    completed tick."""
    global _escrow
    with _escrow_lock:
        _escrow = item


def escrow_export() -> Optional[dict]:
    """The latest escrow, served to the driver's harvest from the frame
    reader thread (worker_main): it never touches the main thread,
    which may be wedged in a collective whose peer died."""
    with _escrow_lock:
        return _escrow


def escrow_clear() -> None:
    escrow_set(None)


def reset_for_tests() -> None:
    """Clear the process-global chaos and escrow state between in-process
    tests: the armed drops, the escrow and the mailbox's payloads."""
    global _peer_drop, _peer_mailbox
    with _escrow_lock:
        _peer_drop = 0
        _peer_mailbox = Mailbox()
    escrow_clear()


__all__ = ["arm_peer_drop", "escrow_clear", "escrow_export", "escrow_set",
           "peer_drop_pending", "peer_mailbox", "peer_push", "peer_send",
           "queue_send", "reset_for_tests", "set_conn"]
