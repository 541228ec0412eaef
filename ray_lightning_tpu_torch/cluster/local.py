"""Built-in subprocess actor backend.

Counterpart of ``ray_lightning_tpu/cluster/local.py``: each actor is a
subprocess (``python -m ray_lightning_tpu_torch.cluster.worker_main``)
connected to the driver over a unix socket; RPC is length-prefixed
stdlib ``pickle`` (cluster/protocol.py) and the worker-to-driver queue
rides the same connection as unsolicited frames.  This supplies, in the
repository, the roles the reference takes from Ray's core: actor RPC,
object transport, the queue.

A worker starts in the driver's working directory with the driver's
``sys.path`` as its ``PYTHONPATH``: stdlib pickle sends classes and
functions by import path, so the worker must import every module the
driver's payload names (a test module included).

Large payloads (the pickled trainer and module) go through a
shared-memory object store: :meth:`LocalBackend.put` writes the pickled
object once to a 0600 file under ``/dev/shm`` and returns a
:class:`LocalObjectRef`; a ref among a call's arguments is resolved in
the worker by mapping the file read-only, so N workers share the
driver's pages instead of receiving N socket copies.
"""

from __future__ import annotations

import mmap
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import uuid
from typing import Any, Optional

from ray_lightning_tpu_torch.cluster.backend import (ActorHandle,
                                                     ClusterBackend, Future)
from ray_lightning_tpu_torch.cluster.protocol import Connection


class RemoteActorError(RuntimeError):
    """An exception raised inside an actor, or its death, carried back
    with the remote traceback and the tail of the worker's log (what
    ``ray.get`` raising does for the reference)."""


class LocalObjectRef:
    """Reference to an object-store file: carries the path, so any
    process on the node resolves it without a round trip to the
    driver."""

    __slots__ = ("object_id", "path")

    def __init__(self, object_id: str, path: str):
        self.object_id = object_id
        self.path = path

    def load(self) -> Any:
        with open(self.path, "rb") as f:
            with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
                return pickle.loads(m)


def resolve_refs(args: tuple, kwargs: Optional[dict] = None):
    """Object refs at the top level of a call's arguments, loaded (Ray
    dereferences top-level ``ObjectRef``\\ s the same way)."""
    out_args = tuple(a.load() if isinstance(a, LocalObjectRef) else a
                     for a in args)
    out_kwargs = {k: (v.load() if isinstance(v, LocalObjectRef) else v)
                  for k, v in (kwargs or {}).items()}
    return out_args, out_kwargs


class LocalActorHandle(ActorHandle):
    """One subprocess actor: its connection, pending calls and log."""

    def __init__(self, backend: "LocalBackend", actor_id: str,
                 log_path: str):
        self.actor_id = actor_id
        self._backend = backend
        #: set by ``create_actor`` after the spawn (the handle registers
        #: first, so a hello that races ahead of the spawn finds it)
        self._proc: Optional[subprocess.Popen] = None
        self.log_path = log_path
        self._conn: Optional[Connection] = None
        self._conn_ready = threading.Event()
        self._pending: "dict[str, Future]" = {}
        self._lock = threading.Lock()
        self._dead = False
        self._death_error: Optional[BaseException] = None

    def _error(self, text: str) -> RemoteActorError:
        tail = self.log_tail()
        if tail:
            text += (f"\n--- worker log tail ({self.actor_id}, "
                     f"{self.log_path}) ---\n{tail}")
        return RemoteActorError(text)

    # -- wiring (called by the backend's handshake) ----------------------

    def _attach(self, conn: Connection) -> None:
        self._conn = conn
        self._conn_ready.set()
        threading.Thread(target=self._reader, daemon=True,
                         name=f"rlt-reader-{self.actor_id}").start()

    def _reader(self) -> None:
        try:
            while True:
                msg = self._conn.recv()
                kind = msg.get("type")
                if kind == "queue":
                    self._backend._queue_push(self.actor_id, msg["item"])
                elif kind == "result":
                    with self._lock:
                        fut = self._pending.pop(msg["call_id"], None)
                    if msg["ok"]:
                        if fut is not None:
                            fut.set_result(msg["value"])
                    elif fut is not None:
                        fut.set_error(self._error(msg["error"]))
                    else:
                        # the constructor's failure: no call awaits it
                        self._fail_pending(self._error(msg["error"]))
        except (ConnectionError, OSError, EOFError):
            rc = self._proc.poll() if self._proc is not None else None
            self._fail_pending(self._error(
                f"actor {self.actor_id} died (connection lost); "
                f"returncode={rc}"))
        except Exception as e:      # noqa: BLE001 - the reader's boundary
            # a frame the driver cannot unpickle (e.g. a class it cannot
            # import): the waiting calls fail instead of hanging
            self._fail_pending(self._error(
                f"actor {self.actor_id}: a frame could not be read on the "
                f"driver ({type(e).__name__}: {e})"))

    def _fail_pending(self, err: BaseException) -> None:
        self._dead = True
        if self._death_error is None:
            self._death_error = err          # keep the root cause
        with self._lock:
            pending, self._pending = self._pending, {}
        for fut in pending.values():
            fut.set_error(self._death_error)

    # -- API ---------------------------------------------------------------

    def call(self, method: str, *args, **kwargs) -> Future:
        fut = Future(self.actor_id)
        if self._dead:
            fut.set_error(self._death_error or RemoteActorError(
                f"actor {self.actor_id} is dead"))
            return fut
        if not self._conn_ready.wait(timeout=120):
            rc = self._proc.poll() if self._proc is not None else None
            fut.set_error(self._error(
                f"actor {self.actor_id} never connected; "
                f"{'process alive' if rc is None else f'returncode={rc}'}"))
            return fut
        call_id = uuid.uuid4().hex
        with self._lock:
            self._pending[call_id] = fut
        try:
            self._conn.send({"type": "call", "call_id": call_id,
                             "method": method, "args": args,
                             "kwargs": kwargs})
        except (ConnectionError, OSError) as e:
            self._fail_pending(self._error(str(e)))
        return fut

    def log_tail(self, max_bytes: int = 4096) -> str:
        try:
            with open(self.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - max_bytes))
                return f.read().decode(errors="replace").strip()
        except OSError:
            return ""

    def kill(self) -> None:
        """Stop the actor: a shutdown frame, then SIGTERM, then SIGKILL
        after 5 s; the process is reaped and its undrained queue items
        dropped."""
        self._dead = True
        self._backend._actors.pop(self.actor_id, None)
        if self._conn is not None:
            try:
                self._conn.send({"type": "shutdown"})
            except (ConnectionError, OSError):
                pass
        if self._proc is not None:
            try:
                self._proc.terminate()
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
        if self._conn is not None:
            self._conn.close()
        self._backend._queue_discard(self.actor_id)


class LocalBackend(ClusterBackend):
    """Subprocess actors on this node, a unix-socket listener for their
    connections, and the ``/dev/shm`` object store."""

    def __init__(self):
        self._dir = tempfile.mkdtemp(prefix="rlt_cluster_")
        self._sock_path = os.path.join(self._dir, "driver.sock")
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self._sock_path)
        self._listener.listen(64)
        self._actors: "dict[str, LocalActorHandle]" = {}
        self._objects: "dict[str, str]" = {}   # object_id -> file path
        #: (sending actor, item), oldest first
        self._queue: "list[tuple[str, Any]]" = []
        self._queue_lock = threading.Lock()
        self._closed = False
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="rlt-accept").start()

    # -- accept / queue ------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            # the hello is read off this thread with a deadline: a peer
            # that dies between connect and hello must not block the
            # other workers' attach
            threading.Thread(target=self._handshake, args=(sock,),
                             daemon=True, name="rlt-handshake").start()

    def _handshake(self, sock: socket.socket) -> None:
        sock.settimeout(60)
        conn = Connection(sock)
        try:
            hello = conn.recv()
        except (ConnectionError, OSError, EOFError):
            sock.close()
            return
        sock.settimeout(None)
        handle = self._actors.get(hello.get("actor_id"))
        if handle is None:
            print(f"[rlt-backend] dropping hello from unknown actor "
                  f"{hello.get('actor_id')!r}", file=sys.stderr, flush=True)
            sock.close()
            return
        handle._attach(conn)

    def _queue_push(self, actor_id: str, item: Any) -> None:
        with self._queue_lock:
            self._queue.append((actor_id, item))

    def _queue_discard(self, actor_id: str) -> None:
        with self._queue_lock:
            self._queue = [e for e in self._queue if e[0] != actor_id]

    def queue_get_nowait(self, actors: set):
        with self._queue_lock:
            for i, (actor_id, item) in enumerate(self._queue):
                if actor_id in actors:
                    del self._queue[i]
                    return item
            return None

    # -- actors ----------------------------------------------------------------

    def create_actor(self, actor_cls: type, *args,
                     env: Optional["dict[str, str]"] = None,
                     resources: Optional["dict[str, float]"] = None,
                     name: Optional[str] = None, **kwargs
                     ) -> LocalActorHandle:
        """Spawn a worker running ``actor_cls(*args, **kwargs)`` with the
        driver's environment updated by ``env``.  ``resources`` is
        bookkeeping for a scheduler this backend does not have."""
        del resources
        actor_id = name or f"actor-{uuid.uuid4().hex[:8]}"
        spec_path = os.path.join(self._dir, f"{actor_id}.spec")
        with open(spec_path, "wb") as f:
            pickle.dump((actor_cls, args, kwargs), f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        path = [p or os.getcwd() for p in sys.path]
        child_env = {**os.environ, **(env or {}),
                     "PYTHONPATH": os.pathsep.join(path),
                     "RLT_DRIVER_SOCKET": self._sock_path,
                     "RLT_ACTOR_ID": actor_id,
                     "RLT_ACTOR_SPEC": spec_path}
        log_path = os.path.join(self._dir, f"{actor_id}.log")
        handle = LocalActorHandle(self, actor_id, log_path)
        self._actors[actor_id] = handle
        with open(log_path, "ab") as log_file:
            try:
                handle._proc = subprocess.Popen(
                    [sys.executable, "-m",
                     "ray_lightning_tpu_torch.cluster.worker_main"],
                    env=child_env, cwd=os.getcwd(), stdout=log_file,
                    stderr=subprocess.STDOUT)
            except BaseException:
                self._actors.pop(actor_id, None)
                raise
        return handle

    # -- shared-memory object store -----------------------------------------

    @staticmethod
    def _shm_dir() -> str:
        d = "/dev/shm"
        return d if os.path.isdir(d) and os.access(d, os.W_OK) \
            else tempfile.gettempdir()

    def put(self, obj: Any) -> LocalObjectRef:
        oid = uuid.uuid4().hex
        path = os.path.join(self._shm_dir(), f"rlt-obj-{oid}")
        blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        tmp = f"{path}.{os.getpid()}.tmp"
        # 0600: /dev/shm is world-listable, and the payload is the
        # pickled trainer and module
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)     # workers see it only when complete
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._objects[oid] = path
        return LocalObjectRef(oid, path)

    def free(self, ref: LocalObjectRef) -> None:
        path = self._objects.pop(ref.object_id, None)
        if path:
            try:
                os.unlink(path)
            except OSError:
                pass

    def shutdown(self) -> None:
        """Kill every actor, delete the stored objects, close the
        listener and remove the backend's directory."""
        self._closed = True
        for handle in list(self._actors.values()):
            handle.kill()
        self._actors.clear()
        for path in self._objects.values():
            try:
                os.unlink(path)
            except OSError:
                pass
        self._objects.clear()
        self._listener.close()
        shutil.rmtree(self._dir, ignore_errors=True)


__all__ = ["LocalActorHandle", "LocalBackend", "LocalObjectRef",
           "RemoteActorError", "resolve_refs"]
