"""PyTorch/CUDA port, the cluster backend's worker-to-worker peer channel
and recovery escrow (cluster/worker_main.py's frame reader,
``LocalBackend.peer_route``, ``LocalActorHandle.harvest_escrow`` and
``process_alive``), over real subprocess actors on the CPU: the two
backend tests of tests/test_cluster_peer.py and the strict liveness
probe the elastic driver classifies deaths with.

- a peer payload reaches an actor while its main thread is blocked in
  the call that waits for it; one sent before the receive is buffered;
  one for an unknown actor is dropped by the driver and the receiver's
  timeout names the waiter;
- the escrow is harvested while the actor's main thread is wedged; an
  actor that never escrowed answers None;
- ``process_alive``: a busy actor reads True, an actor that exited
  reads False at once (the fork server reports its children's exits a
  moment later);
- the frames (cluster/protocol.py): numpy arrays and
  ``pickle.PickleBuffer`` objects leave the pickle as out-of-band buffers
  and come back equal, beside small values.

JAX-free: the actors import this module by path.
"""

import os
import pickle
import socket
import threading
import time

import numpy as np
import pytest

from ray_lightning_tpu_torch.cluster import protocol
from ray_lightning_tpu_torch.cluster.local import LocalBackend

TIMEOUT_S = 60


class _PeerActor:
    """A peer-channel participant: blocks inside a call waiting for a
    payload, or sends one to a named peer."""

    def ping(self):
        return "pong"

    def deposit_escrow(self, item):
        from ray_lightning_tpu_torch.cluster import worker_state
        worker_state.escrow_set(item)
        return True

    def block_forever(self):
        while True:
            time.sleep(3600)

    def exit_now(self, code):
        os._exit(code)

    def wait_for(self, tag, timeout):
        from ray_lightning_tpu_torch.cluster import worker_state
        return worker_state.peer_mailbox().take(tuple(tag), timeout,
                                                who="receiver actor")

    def send_to(self, dst_name, tag, payload):
        from ray_lightning_tpu_torch.cluster import worker_state
        worker_state.peer_send(dst_name, {"tag": tuple(tag),
                                          "wire": payload})
        return True


@pytest.fixture
def backend():
    b = LocalBackend()
    try:
        yield b
    finally:
        b.shutdown()


def test_local_backend_routes_peer_frames_mid_call(backend):
    """B's payload reaches A's mailbox while A is blocked in
    ``wait_for``: the driver's routing and the worker's frame reader
    together.  A payload sent before anyone waits is buffered."""
    a = backend.create_actor(_PeerActor, name="peer-a")
    b = backend.create_actor(_PeerActor, name="peer-b")
    assert a.call("ping").result(timeout=TIMEOUT_S) == "pong"
    assert b.call("ping").result(timeout=TIMEOUT_S) == "pong"

    fut = a.call("wait_for", ("fwd", 0, 0, 0), 30.0)
    assert b.call("send_to", "peer-a", ("fwd", 0, 0, 0),
                  {"h": [1, 2, 3]}).result(timeout=TIMEOUT_S)
    assert fut.result(timeout=TIMEOUT_S) == {"h": [1, 2, 3]}

    assert a.call("send_to", "peer-b", ("bwd", 1, 3, 0),
                  "grad").result(timeout=TIMEOUT_S)
    assert b.call("wait_for", ("bwd", 1, 3, 0),
                  30.0).result(timeout=TIMEOUT_S) == "grad"

    # an unknown destination: dropped on the driver, and the receiver
    # times out naming itself instead of hanging
    assert a.call("send_to", "peer-nobody", ("fwd", 9, 9, 9),
                  "lost").result(timeout=TIMEOUT_S)
    with pytest.raises(Exception, match="receiver actor"):
        a.call("wait_for", ("never", 0, 0, 0), 0.2).result(
            timeout=TIMEOUT_S)


def test_escrow_harvest_bypasses_a_wedged_main_thread(backend):
    """The driver fetches a worker's recovery escrow while its main
    thread is stuck: the frame reader answers ``escrow`` frames."""
    a = backend.create_actor(_PeerActor, name="escrow-a")
    assert a.call("ping").result(timeout=TIMEOUT_S) == "pong"
    assert a.harvest_escrow(timeout=20) is None     # nothing yet
    assert a.call("deposit_escrow",
                  {"step": 7, "rank": 0}).result(timeout=TIMEOUT_S)
    a.call("block_forever")
    assert a.harvest_escrow(timeout=20) == {"step": 7, "rank": 0}


def test_process_alive_reads_busy_as_alive_and_exit_as_dead(backend):
    """The strict probe: True for a busy actor, False for one whose
    process exited, without waiting for its reaper."""
    busy = backend.create_actor(_PeerActor, name="alive-busy")
    gone = backend.create_actor(_PeerActor, name="alive-gone")
    assert busy.call("ping").result(timeout=TIMEOUT_S) == "pong"
    assert gone.call("ping").result(timeout=TIMEOUT_S) == "pong"
    busy.call("block_forever")
    fut = gone.call("exit_now", 43)
    with pytest.raises(Exception, match="died"):
        fut.result(timeout=TIMEOUT_S)
    assert gone.process_alive() is False
    assert busy.process_alive() is True
    assert busy.harvest_escrow(timeout=20) is None
    assert gone.harvest_escrow(timeout=1) is None


FRAMES = {
    "small": ({"type": "call", "args": (1, b"tiny", [2.5])}, 0),
    "array": ({"blob": np.arange(1 << 16, dtype=np.uint8), "d": "x"}, 1),
    "buffers": ({"a": pickle.PickleBuffer(b"abc" * 1000),
                 "b": [np.ones((3, 4), np.float32), 3]}, 2),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frames_carry_large_payloads_out_of_band(name):
    msg, n_out = FRAMES[name]
    bufs: list = []
    pickle.dumps(msg, protocol=5, buffer_callback=bufs.append)
    assert len(bufs) == n_out
    a, b = socket.socketpair()
    ca, cb = protocol.Connection(a), protocol.Connection(b)
    got: list = []
    reader = threading.Thread(target=lambda: got.append(cb.recv()))
    reader.start()
    ca.send(msg)
    reader.join(30)
    ca.close()
    cb.close()
    out = got[0]
    if name == "array":
        assert np.array_equal(out["blob"], msg["blob"]) and out["d"] == "x"
    elif name == "buffers":
        assert bytes(out["a"]) == b"abc" * 1000
        assert np.array_equal(out["b"][0], msg["b"][0]) and out["b"][1] == 3
    else:
        assert out == msg
