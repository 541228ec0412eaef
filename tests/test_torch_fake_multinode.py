"""PyTorch/CUDA port, a fake multi-node topology on one machine: actors
of the built-in backend claim distinct node addresses through
``RLT_NODE_IP_OVERRIDE``, and the real RPC path feeds ``RayPlugin``'s
rank assignment (tests/test_fake_multinode.py's first test; the
reference's fake-IP rank tests, test_ddp.py:78-112).  The plugin's
environment fan-out then reaches each worker, whose device follows its
local rank (``RayPlugin._worker_device``, run in the worker with CUDA
faked, since this machine has no card).

Workers unpickle this module's functions by import path, so it imports
no JAX.
"""

import os

import pytest
import torch

from ray_lightning_tpu_torch import RayPlugin
from ray_lightning_tpu_torch.cluster import LocalBackend, RLTExecutor
from ray_lightning_tpu_torch.util import process_results

#: every call's bound
TIMEOUT_S = 60


def worker_device(plugin: RayPlugin, num_gpus: int) -> "tuple[str, list]":
    """In a worker: ``plugin._worker_device`` for the ``LOCAL_RANK`` the
    driver set, with CUDA faked to show ``num_gpus`` cards; the device and
    the cards it made current."""
    current = []
    torch.cuda.is_available = lambda: True
    torch.cuda.device_count = lambda: num_gpus
    torch.cuda.set_device = current.append
    device = plugin._worker_device(int(os.environ["LOCAL_RANK"]))
    return str(device), [str(d) for d in current]


@pytest.fixture
def fake_nodes():
    """4 actors: ranks 0 and 2 on node "1", ranks 1 and 3 on node "2"."""
    backend = LocalBackend()
    actors = []
    try:
        actors = [backend.create_actor(
            RLTExecutor, env={"RLT_NODE_IP_OVERRIDE": "1" if i % 2 == 0
                              else "2", "CUDA_VISIBLE_DEVICES": ""},
            name=f"fake-node-{i}") for i in range(4)]
        yield backend, actors
    finally:
        for a in actors:
            a.kill()
        backend.shutdown()


def test_fake_two_node_topology_assigns_ranks_and_devices(fake_nodes):
    backend, actors = fake_nodes
    info = process_results([a.call("get_node_and_device_info")
                            for a in actors], backend, TIMEOUT_S)
    assert [d["ip"] for d in info] == ["1", "2", "1", "2"]
    assert len({d["pid"] for d in info}) == 4

    ranks = RayPlugin._assign_local_ranks(info)
    assert ranks == {0: (0, 0), 2: (0, 1), 1: (1, 0), 3: (1, 1)}
    # the rendezvous address the plugin takes is worker 0's: faked too
    assert actors[0].call("get_node_ip").result(timeout=TIMEOUT_S) == "1"

    # the plugin's fan-out of node and local ranks, read in the workers
    process_results([a.call("set_env_vars", {
        "NODE_RANK": str(ranks[i][0]), "LOCAL_RANK": str(ranks[i][1])})
        for i, a in enumerate(actors)], backend, TIMEOUT_S)
    plugin = RayPlugin(num_workers=4, use_gpu=True)
    seen = process_results([a.call("execute", worker_device, plugin, 2)
                            for a in actors], backend, TIMEOUT_S)
    assert seen == [("cuda:0", ["cuda:0"]), ("cuda:0", ["cuda:0"]),
                    ("cuda:1", ["cuda:1"]), ("cuda:1", ["cuda:1"])]

    # a worker whose local rank has no card of its own fails, naming both
    with pytest.raises(Exception, match="local rank 1 but this worker "
                                        "sees 1 GPUs"):
        process_results([actors[2].call("execute", worker_device, plugin,
                                        1)], backend, TIMEOUT_S)


def test_node_with_fewer_cards_than_workers_is_refused():
    """``_check_gpu_fit`` over the fake topology's ranks: node "1" sees
    one card for its two GPU workers (NCCL takes a card a rank)."""
    info = [{"ip": "1", "num_gpus": 1}, {"ip": "2", "num_gpus": 2},
            {"ip": "1", "num_gpus": 1}, {"ip": "2", "num_gpus": 2}]
    ranks = RayPlugin._assign_local_ranks(info)
    with pytest.raises(ValueError, match="node 1 hosts 2 GPU workers but "
                                         "sees 1 GPUs"):
        RayPlugin._check_gpu_fit(info, ranks)
    info[0]["num_gpus"] = info[2]["num_gpus"] = 2
    RayPlugin._check_gpu_fit(info, ranks)


def test_node_ip_is_loopback_without_the_override(monkeypatch):
    from ray_lightning_tpu_torch.cluster.protocol import node_ip
    monkeypatch.delenv("RLT_NODE_IP_OVERRIDE", raising=False)
    assert node_ip() == "127.0.0.1"
    monkeypatch.setenv("RLT_NODE_IP_OVERRIDE", "10.0.0.7")
    assert node_ip() == "10.0.0.7"
