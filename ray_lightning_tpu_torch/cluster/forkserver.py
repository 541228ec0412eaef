"""Fork server of the built-in actor backend (cluster/local.py).

An actor started as a fresh interpreter imports torch, and its first
training step imports what torch loads lazily at the first call of a
custom op under autograd (``torch._dynamo``, ``torch.distributed.fsdp``,
sympy): some 850 modules.  Where the interpreter cannot cache bytecode
each process compiles them again, and an actor then spends seconds
before its first step (PERF.md, "Where the time goes").  The fork server
pays that once: it imports :data:`PRELOAD`, then forks every actor from
that state.  A forked actor sets its own environment, working directory,
``sys.path``, standard streams and log before it runs
``worker_main.main``, so it starts as a spawned one would, minus the
imports.

The server imports torch but never this package (its modules load in
each actor, with that actor's environment) and never initialises CUDA:
a CUDA context does not survive a fork, so each actor makes its own.
This file runs as the server through ``runpy.run_path`` (not ``-m``,
which would import the package first), so it imports only the standard
library at its top.  The server reaps its children and reports each
exit code; the driver holds a :class:`ForkedProcess` (the ``Popen``
subset the backend uses) for each actor.

When the server cannot start or fork, each actor is spawned as a fresh
``python -m ray_lightning_tpu_torch.cluster.worker_main`` instead.
"""

from __future__ import annotations

import os
import pickle
import select
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import uuid
from typing import Any, Optional

#: what the server imports before it forks: torch and the modules a
#: first custom-op call under autograd imports lazily
PRELOAD = ("numpy", "torch", "torch.distributed", "torch._dynamo",
           "torch._higher_order_ops", "torch.distributed.fsdp")
#: how long the driver waits for the server's imports, then for a fork
READY_TIMEOUT_S = 300.0
SPAWN_TIMEOUT_S = 60.0
#: how often the server reaps exited children
REAP_S = 0.02

_LEN = struct.Struct(">Q")


def _send(sock: socket.socket, msg: Any) -> None:
    payload = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def _recv(sock: socket.socket) -> Any:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return pickle.loads(_recv_exact(sock, n))


# -- the driver's side --------------------------------------------------------

class ForkServer:
    """The driver's handle on one server process: ``spawn`` forks an
    actor and returns its :class:`ForkedProcess`, or None when the
    server is not usable (the caller then spawns a fresh interpreter)."""

    def __init__(self, log_path: str):
        ours, theirs = socket.socketpair()
        # the server finds this package's file as the driver does
        env = {**os.environ,
               "PYTHONPATH": os.pathsep.join(p or os.getcwd()
                                             for p in sys.path)}
        boot = ("import runpy, sys; "
                "runpy.run_path(sys.argv[1], run_name='__rlt_forkserver__')")
        with open(log_path, "ab") as log:
            self._proc = subprocess.Popen(
                [sys.executable, "-c", boot, os.path.abspath(__file__),
                 str(theirs.fileno())],
                pass_fds=(theirs.fileno(),), env=env, cwd=os.getcwd(),
                stdin=subprocess.DEVNULL, stdout=log,
                stderr=subprocess.STDOUT)
        theirs.close()
        self._sock = ours
        self._wlock = threading.Lock()
        self._cond = threading.Condition()
        self._ready = False
        self._usable = False
        #: the server's import seconds, once it is ready
        self.preload_s: Optional[float] = None
        self._closed = False
        self._spawned: "dict[str, int]" = {}
        self._exits: "dict[int, int]" = {}
        threading.Thread(target=self._reader, daemon=True,
                         name="rlt-forkserver").start()

    def _reader(self) -> None:
        try:
            while True:
                msg = _recv(self._sock)
                with self._cond:
                    kind = msg["type"]
                    if kind == "ready":
                        self._ready, self._usable = True, msg["ok"]
                        self.preload_s = msg["preload_s"]
                    elif kind == "spawned":
                        self._spawned[msg["id"]] = msg["pid"]
                    elif kind == "exit":
                        self._exits[msg["pid"]] = msg["code"]
                    self._cond.notify_all()
        except (ConnectionError, OSError, EOFError):
            with self._cond:
                self._ready, self._usable, self._closed = True, False, True
                self._cond.notify_all()

    def spawn(self, env: "dict[str, str]", cwd: str,
              log_path: str) -> "Optional[ForkedProcess]":
        with self._cond:
            if not self._cond.wait_for(lambda: self._ready,
                                       READY_TIMEOUT_S) or not self._usable:
                self._usable = False
                return None
        req = uuid.uuid4().hex
        try:
            with self._wlock:
                _send(self._sock, {"type": "spawn", "id": req, "env": env,
                                   "cwd": cwd, "log_path": log_path})
        except OSError:
            return None
        with self._cond:
            if not self._cond.wait_for(
                    lambda: req in self._spawned or self._closed,
                    SPAWN_TIMEOUT_S) or req not in self._spawned:
                return None
            return ForkedProcess(self, self._spawned.pop(req))

    def _exit_code(self, pid: int) -> "Optional[int]":
        """The reported exit code, else None while the child lives.  With
        the server gone its children are no longer reported: a child is
        then over once it is gone or a zombie."""
        with self._cond:
            if pid in self._exits:
                return self._exits[pid]
            if not self._closed:
                return None
        try:
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            state = "X"
        if state in ("Z", "X"):
            with self._cond:
                self._exits.setdefault(pid, -signal.SIGKILL)
                return self._exits[pid]
        return None

    def close(self, timeout: float = 5.0) -> None:
        """End the server (it exits when its socket closes)."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        try:
            self._proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()


class ForkedProcess:
    """An actor forked by the server: the ``subprocess.Popen`` methods
    the backend calls, its exit code as the server reports it."""

    def __init__(self, server: ForkServer, pid: int):
        self._server = server
        self.pid = pid
        self.returncode: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self.returncode is None:
            self.returncode = self._server._exit_code(self.pid)
        return self.returncode

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(f"pid {self.pid}", timeout)
            time.sleep(REAP_S)
        return self.returncode

    def send_signal(self, sig: int) -> None:
        if self.poll() is None:
            try:
                os.kill(self.pid, sig)
            except ProcessLookupError:
                pass

    def terminate(self) -> None:
        self.send_signal(signal.SIGTERM)

    def kill(self) -> None:
        self.send_signal(signal.SIGKILL)


# -- the server ---------------------------------------------------------------

def _child(sock: socket.socket, req: dict) -> None:
    """In a forked child: become the actor ``req`` asks for, run it,
    exit with its code (never returns)."""
    code = 1
    try:
        sock.close()
        null = os.open(os.devnull, os.O_RDONLY)
        os.dup2(null, 0)
        os.close(null)
        log = os.open(req["log_path"],
                      os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        os.dup2(log, 1)
        os.dup2(log, 2)
        os.close(log)
        os.chdir(req["cwd"])
        os.environ.clear()
        os.environ.update(req["env"])
        # sys.path as ``python -m`` would build it from this environment
        head = [req["cwd"]] + [p for p in req["env"].get(
            "PYTHONPATH", "").split(os.pathsep) if p]
        sys.path[:] = list(dict.fromkeys(head + sys.path[1:]))
        import importlib
        importlib.invalidate_caches()
        sys.argv = [sys.argv[0]]
        # a fresh interpreter seeds numpy's global generator from the OS
        if "numpy" in sys.modules:
            sys.modules["numpy"].random.seed()
        from ray_lightning_tpu_torch.cluster import worker_main
        code = worker_main.main()
        import atexit
        atexit._run_exitfuncs()
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else int(e.code is not None)
    except BaseException:               # noqa: BLE001 - the child's boundary
        import traceback
        traceback.print_exc()
    finally:
        try:
            sys.stdout.flush()
            sys.stderr.flush()
        finally:
            os._exit(code if isinstance(code, int) else 1)


def _reap(sock: socket.socket) -> None:
    while True:
        try:
            pid, status = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return
        _send(sock, {"type": "exit", "pid": pid,
                     "code": os.waitstatus_to_exitcode(status)})


def serve(fd: int) -> int:
    """The server's loop on socket ``fd``: imports, then one fork for
    each ``spawn`` request, until the driver closes the socket."""
    sock = socket.socket(fileno=fd)
    import importlib
    t0 = time.monotonic()
    for name in PRELOAD:
        try:
            importlib.import_module(name)
        except Exception as e:          # noqa: BLE001 - what is missing loads in the actor
            print(f"[rlt-forkserver] preload {name}: {e!r}", flush=True)
    torch = sys.modules.get("torch")
    ok = torch is None or not torch.cuda.is_initialized()
    _send(sock, {"type": "ready", "ok": ok, "pid": os.getpid(),
                 "preload_s": time.monotonic() - t0})
    if not ok:
        return 1
    while True:
        try:
            _reap(sock)
            readable, _, _ = select.select([sock], [], [], REAP_S)
            if not readable:
                continue
            req = _recv(sock)
        except (ConnectionError, OSError, EOFError):
            return 0
        if req.get("type") != "spawn":
            continue
        sys.stdout.flush()
        sys.stderr.flush()
        pid = os.fork()
        if pid == 0:
            _child(sock, req)
        try:
            _send(sock, {"type": "spawned", "id": req["id"], "pid": pid})
        except OSError:
            return 0


if __name__ == "__rlt_forkserver__":
    sys.exit(serve(int(sys.argv[2])))

__all__ = ["ForkServer", "ForkedProcess", "PRELOAD", "serve"]
