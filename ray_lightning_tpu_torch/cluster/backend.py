"""Cluster backend abstraction: actor lifecycle, object transport and the
worker-to-driver queue behind one small interface.

Counterpart of ``ray_lightning_tpu/cluster/backend.py``.  The port has
one implementation, :class:`~ray_lightning_tpu_torch.cluster.local.
LocalBackend` (subprocess actors on this node); the Ray backend is not
ported (ROADMAP.md queue 1 item 5), so :func:`get_backend` returns the
local one.  Only control, pickled payloads and results ride this plane:
gradients ride ``torch.distributed``.
"""

from __future__ import annotations

import atexit
import threading
from typing import Any, Optional


class Future:
    """Resolvable handle for an in-flight actor call (``ObjectRef``
    analog)."""

    def __init__(self):
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

    def queue_get_nowait(self):
        """Pop one worker-to-driver queue item, or None."""
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
