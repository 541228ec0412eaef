"""Wire protocol of the built-in actor backend.

Counterpart of ``ray_lightning_tpu/cluster/protocol.py``: length-prefixed
frames over a unix-domain socket, the transport under the actors' RPC and
the worker-to-driver queue.  Frames are stdlib ``pickle`` (the JAX package
uses cloudpickle, which the port does not depend on), so a callable
in a frame travels by import path: payload callables are module-level
functions the worker can import.  Messages are dicts with a ``type``:

  driver -> worker: {type: call, call_id, method, args, kwargs}
                    {type: shutdown}
  worker -> driver: {type: hello, actor_id}
                    {type: result, call_id, ok, value | error}
                    {type: queue, item}       (unsolicited, session relay)

Both ends are this program's own processes, so unpickling a frame runs
only what this program or its workers wrote.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
from typing import Any

_LEN = struct.Struct(">Q")
MAX_FRAME = 1 << 36  # 64 GiB guard


class Connection:
    """Thread-safe framed connection over a stream socket."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._wlock = threading.Lock()
        self._rlock = threading.Lock()

    def send(self, msg: Any) -> None:
        payload = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        with self._wlock:
            self._sock.sendall(_LEN.pack(len(payload)))
            self._sock.sendall(payload)

    def _recv_exact(self, n: int) -> bytearray:
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            k = self._sock.recv_into(view[got:], min(n - got, 1 << 22))
            if not k:
                raise ConnectionError("peer closed")
            got += k
        return buf

    def recv(self) -> Any:
        with self._rlock:
            (length,) = _LEN.unpack(self._recv_exact(_LEN.size))
            if length > MAX_FRAME:
                raise ValueError(f"frame too large: {length}")
            payload = self._recv_exact(length)
        return pickle.loads(payload)

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


def find_free_port(host: str = "127.0.0.1") -> int:
    """Bind port 0 on ``host`` and report what the OS picked (the
    rendezvous port of ``torch.distributed``'s TCP store)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return s.getsockname()[1]


def node_ip() -> str:
    """The address other actors reach this node at.  The built-in
    backend's actors are subprocesses of one node, so that is the
    loopback address.  The JAX package asks the routing table for an
    outward address, which the Ray backend (not ported) would need."""
    return "127.0.0.1"


__all__ = ["Connection", "MAX_FRAME", "find_free_port", "node_ip"]
