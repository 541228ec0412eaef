"""Per-worker session (the reference's ``ray_lightning/session.py``).

Counterpart of ``ray_lightning_tpu/session.py``: holds the worker's rank
and queue proxy, so a callback deep in the training loop can relay a
side effect to the driver without handles threaded through every layer.
The same strict contract: one ``init_session`` per process, and access
outside a launched worker raises.  An item sent with :func:`put_queue`
is pickled with stdlib ``pickle``: a callable travels by import path, so
it must be a module-level function (or a ``functools.partial`` of one)
that the driver can import; the driver calls it.
"""

from __future__ import annotations

from typing import Any, Optional


class RLTSession:
    def __init__(self, rank: int, queue: Optional[Any]):
        self._rank = rank
        self._queue = queue

    def get_actor_rank(self) -> int:
        return self._rank

    def put_queue(self, item: Any) -> None:
        if self._queue is None:
            raise ValueError(
                "RLTSession has no queue: this run was not launched with "
                "a driver-side queue.")
        self._queue.put((self._rank, item))


_session: Optional[RLTSession] = None


def init_session(rank: int, queue: Optional[Any]) -> None:
    global _session
    if _session is not None:
        raise ValueError(
            "A ray_lightning_tpu_torch session is already initialized in "
            "this process; init_session may be called only once.")
    _session = RLTSession(rank, queue)


def get_session() -> RLTSession:
    if _session is None:
        raise ValueError(
            "No ray_lightning_tpu_torch session in this process; was this "
            "called outside a launched worker?")
    return _session


def reset_session() -> None:
    global _session
    _session = None


def get_actor_rank() -> int:
    return get_session().get_actor_rank()


def put_queue(item: Any) -> None:
    """Enqueue an item (usually a module-level callable, or a
    ``functools.partial`` of one) for the driver, which calls it."""
    get_session().put_queue(item)


__all__ = ["RLTSession", "get_actor_rank", "get_session", "init_session",
           "put_queue", "reset_session"]
