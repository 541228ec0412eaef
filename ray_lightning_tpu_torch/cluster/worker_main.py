"""Entry point of a built-in-backend actor subprocess:

    python -m ray_lightning_tpu_torch.cluster.worker_main

Counterpart of ``ray_lightning_tpu/cluster/worker_main.py`` without the
heartbeats (the telemetry plane is not ported, ROADMAP.md queue 1 item
13).  Connects back to the driver's unix socket (its path in
``RLT_DRIVER_SOCKET``), builds the actor from its pickled spec
(``RLT_ACTOR_SPEC``), then serves calls one after another on the main
thread.  Unsolicited ``queue`` frames may leave mid-call through
``worker_state.queue_send``: the transport under ``session.put_queue``.
A call that raises is answered with its traceback, which also goes to
the worker's captured log, so the driver's error carries both.

Inbound frames are read by a thread of their own, started here in the
actor process (a forked actor starts it after the fork,
cluster/forkserver.py): ``call`` and ``shutdown`` frames queue for the
main thread, while ``peer`` frames (the worker-to-worker channel the
elastic parity tick rides) go straight into this process's peer
mailbox, so a payload arrives while the main thread runs the call that
waits for it.  ``escrow`` frames (the elastic driver's harvest) are
answered on the reader thread itself: at harvest time the main thread
is often wedged in a collective whose peer died.
"""

from __future__ import annotations

import os
import pickle
import queue
import socket
import sys
import threading
import time
import traceback

from ray_lightning_tpu_torch.cluster import worker_state
from ray_lightning_tpu_torch.cluster.local import resolve_refs
from ray_lightning_tpu_torch.cluster.protocol import Connection


def _trace(msg: str) -> None:
    """A milestone line in the worker's captured log (read back in the
    driver's errors)."""
    print(f"[worker {os.getpid()} {time.strftime('%H:%M:%S')}] {msg}",
          flush=True)


def _failure() -> str:
    tb = traceback.format_exc()
    print(tb, file=sys.stderr, flush=True)
    return tb


def main() -> int:
    actor_id = os.environ["RLT_ACTOR_ID"]
    _trace(f"start {actor_id}")
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(os.environ["RLT_DRIVER_SOCKET"])
    conn = Connection(sock)
    worker_state.set_conn(conn)
    conn.send({"type": "hello", "actor_id": actor_id})

    try:
        with open(os.environ["RLT_ACTOR_SPEC"], "rb") as f:
            actor_cls, args, kwargs = pickle.load(f)
        actor = actor_cls(*args, **kwargs)
    except BaseException:
        conn.send({"type": "result", "call_id": "__construct__",
                   "ok": False, "error": _failure()})
        return 1
    _trace("actor constructed; serving")

    inbox: "queue.Queue" = queue.Queue()

    def reader() -> None:
        while True:
            try:
                msg = conn.recv()
            except (ConnectionError, OSError, EOFError) as e:
                _trace(f"connection closed ({type(e).__name__}: {e}); "
                       f"exiting")
                inbox.put(None)
                return
            kind = msg.get("type")
            if kind == "peer":
                worker_state.peer_push(msg["item"])
            elif kind == "escrow":
                try:
                    conn.send({"type": "result", "call_id": msg["call_id"],
                               "ok": True,
                               "value": worker_state.escrow_export()})
                except (ConnectionError, OSError):
                    pass
            else:
                inbox.put(msg)

    threading.Thread(target=reader, daemon=True,
                     name="rlt-worker-reader").start()

    while True:
        msg = inbox.get()
        if msg is None:
            return 0
        kind = msg.get("type")
        if kind == "shutdown":
            return 0
        if kind != "call":
            continue
        call_id = msg["call_id"]
        try:
            # object refs in the arguments resolve here, from the shared
            # store: the payload's bytes never ride the socket
            args, kwargs = resolve_refs(msg.get("args", ()),
                                        msg.get("kwargs", {}))
            value = getattr(actor, msg["method"])(*args, **kwargs)
            # inside the try: a value that does not pickle is answered
            # as the call's failure
            conn.send({"type": "result", "call_id": call_id, "ok": True,
                       "value": value})
        except BaseException:
            conn.send({"type": "result", "call_id": call_id, "ok": False,
                       "error": _failure()})


if __name__ == "__main__":
    sys.exit(main())
