"""Tag-addressed peer mailbox (a port of
``ray_lightning_tpu/cluster/peer.py``).

:class:`Mailbox` is a thread-safe, tag-addressed blocking store:
out-of-order delivery is harmless by construction (a receive blocks on
ITS tag), and a receive that outlives its timeout raises
:class:`PeerTimeout` naming the waiter and the missing payload instead
of hanging.  The fleet router uses one as its KV-ship channel
(serve/fleet/router.py: the router is both ends' driver, so a put can
be chaos-dropped and a take retries under the same policy as a
worker-to-worker receive).  The worker-to-worker frame routing of the
cluster backend, which the pipeline and the elastic plane use, is not
ported yet (ROADMAP.md queue 1 items 10 and 11).

**Retry/backoff** (``RLT_PEER_RETRIES`` / ``RLT_PEER_BACKOFF_S``): by
default a receive makes ONE attempt of ``timeout`` seconds.  With
``RLT_PEER_RETRIES=N`` it waits up to N more times with exponential
backoff between attempts (a ``peer_retry`` span each, a no-op while the
telemetry plane is off); the final :class:`PeerTimeout` names the
attempt count.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any

from ray_lightning_tpu_torch.telemetry import span


class PeerTimeout(RuntimeError):
    """A receiver waited longer than the dead-peer bound for a payload."""


ENV_PEER_RETRIES = "RLT_PEER_RETRIES"
ENV_PEER_BACKOFF_S = "RLT_PEER_BACKOFF_S"


def _retry_policy() -> tuple:
    """(extra_attempts, base_backoff_s) from the env; (0, 0.05) — a
    single attempt — unless raised."""
    try:
        retries = int(os.environ.get(ENV_PEER_RETRIES, "0") or 0)
    except ValueError:
        retries = 0
    try:
        backoff = float(os.environ.get(ENV_PEER_BACKOFF_S, "0.05") or 0.05)
    except ValueError:
        backoff = 0.05
    return max(0, retries), max(0.0, backoff)


class Mailbox:
    """Thread-safe tag-addressed blocking store."""

    def __init__(self):
        self._items: dict = {}
        self._cond = threading.Condition()

    def put(self, tag: tuple, payload: Any) -> None:
        with self._cond:
            self._items[tag] = payload
            self._cond.notify_all()

    def _take_one(self, tag: tuple, timeout: float):
        """One bounded wait; returns (found, payload)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while tag not in self._items:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False, None
                self._cond.wait(remaining)
            return True, self._items.pop(tag)

    def take(self, tag: tuple, timeout: float, *, who: str = "worker",
             src: str = "peer") -> Any:
        retries, backoff = _retry_policy()
        for attempt in range(retries + 1):
            found, payload = self._take_one(tag, timeout)
            if found:
                return payload
            if attempt >= retries:
                break
            delay = backoff * (2 ** attempt)
            with span("peer_retry", tag=repr(tag), attempt=attempt + 1,
                      of=retries, backoff_s=delay):
                time.sleep(delay)
        raise PeerTimeout(
            f"{who} timed out after {retries + 1} attempt(s) of "
            f"{timeout:.1f}s waiting for peer payload {tag!r} from "
            f"{src} — peer dead or schedules desynchronized")

    def __len__(self):
        with self._cond:
            return len(self._items)


__all__ = ["ENV_PEER_BACKOFF_S", "ENV_PEER_RETRIES", "Mailbox",
           "PeerTimeout"]
