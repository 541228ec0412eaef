"""Cluster backend abstraction: actor lifecycle, object transport and the
worker-to-driver queue behind one small interface.

Counterpart of ``ray_lightning_tpu/cluster/backend.py``.  The port has
one implementation, :class:`~ray_lightning_tpu_torch.cluster.local.
LocalBackend` (subprocess actors on this node); the Ray backend is not
ported (ROADMAP.md queue 1 item 5), so :func:`get_backend` returns the
local one.  Only control, pickled payloads and results ride this plane:
gradients ride ``torch.distributed``.  Worker-to-worker payloads (the
elastic parity tick's, elastic/redundancy.py) ride it as ``peer``
frames, which the driver routes (:meth:`ClusterBackend.peer_route`).
"""

from __future__ import annotations

import atexit
import threading
from typing import Any, Optional


class Future:
    """Resolvable handle for an in-flight actor call (``ObjectRef``
    analog); ``actor_id`` names the actor it waits on."""

    def __init__(self, actor_id: str):
        self.actor_id = actor_id
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def set_result(self, value: Any) -> None:
        self._value = value
        self._event.set()

    def set_error(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the call is done or ``timeout`` seconds pass;
        whether it is done."""
        return self._event.wait(timeout)

    def error(self) -> Optional[BaseException]:
        """The call's error once it is done (``None``: none yet)."""
        return self._error

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("actor call timed out")
        if self._error is not None:
            raise self._error
        return self._value


class ActorHandle:
    """Handle to a remote actor; ``call`` is asynchronous and returns a
    :class:`Future`."""

    actor_id: str

    def call(self, method: str, *args, **kwargs) -> Future:
        raise NotImplementedError

    def kill(self) -> None:
        raise NotImplementedError

    def log_tail(self, max_bytes: int = 4096) -> str:
        """The tail of the worker's captured output ("" when the backend
        captures none)."""
        return ""

    def process_alive(self) -> Optional[bool]:
        """Strict process-level liveness for the elastic driver's death
        classifier (elastic/driver.py): True or False only when the
        backend can tell precisely, and a busy actor reads True (a
        False turns a failure into a restartable death); None when it
        cannot tell."""
        return None

    def harvest_escrow(self, timeout: float = 15.0) -> Optional[dict]:
        """Best-effort fetch of the worker's recovery escrow
        (cluster/worker_state.py, deposited by the elastic parity tick)
        without the main thread's call queue: at harvest time a
        survivor is usually wedged in a collective whose peer died.
        None when the backend cannot harvest, the worker never
        escrowed, or the fetch times out (the elastic driver then falls
        back to snapshot replay)."""
        del timeout
        return None


class ClusterBackend:
    """Actor lifecycle + object transport + worker-to-driver queue."""

    def create_actor(self, actor_cls: type, *args,
                     env: Optional["dict[str, str]"] = None,
                     resources: Optional["dict[str, float]"] = None,
                     name: Optional[str] = None, **kwargs) -> ActorHandle:
        raise NotImplementedError

    def put(self, obj: Any) -> Any:
        """Store an object once for a fan-out to actors (``ray.put``
        analog)."""
        raise NotImplementedError

    def free(self, ref: Any) -> None:
        """Release a stored object when the fan-out is done."""

    def peer_route(self, dst_actor_id: str, item) -> bool:
        """The driver's hop of the worker-to-worker peer channel: deliver
        ``item`` to ``dst_actor_id``'s process.  False when the
        destination is unknown (the receiver's timeout names the
        failure)."""
        del dst_actor_id, item
        return False

    def queue_get_nowait(self, actors: set):
        """Pop the oldest worker-to-driver queue item sent by one of
        ``actors``, or None (concurrent runs in one driver, such as Tune
        trials on threads, each drain only their own workers' items)."""
        raise NotImplementedError

    def shutdown(self) -> None:
        raise NotImplementedError


_backend_lock = threading.Lock()
_backend: Optional[ClusterBackend] = None


def get_backend() -> ClusterBackend:
    """The process-wide backend, made at first use: the built-in
    :class:`LocalBackend`, shut down when the process exits."""
    global _backend
    with _backend_lock:
        if _backend is None:
            from ray_lightning_tpu_torch.cluster.local import LocalBackend
            _backend = LocalBackend()
            atexit.register(_backend.shutdown)
        return _backend


__all__ = ["ActorHandle", "ClusterBackend", "Future", "get_backend"]
