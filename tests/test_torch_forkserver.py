"""PyTorch/CUDA port, the actor backend's fork server
(``ray_lightning_tpu_torch/cluster/forkserver.py``) on the CPU.

- a forked actor runs with the environment, working directory and
  ``sys.path`` the driver gave it (a module on a path the driver added
  after the server started imports), is the server's child, and finds
  the server's imports loaded: torch's lazily imported modules, and no
  ``jax``, ``flax``, ``optax`` or ``ray_lightning_tpu``;
- each forked actor draws its own numpy seed, as a fresh interpreter
  does;
- ``kill`` reaps a forked actor (its pid is gone: no zombie is left),
  and an actor that exits on its own reports its exit code;
- a server that cannot fork (or start) leaves the actor to a fresh
  interpreter, the driver's own child, without the server's imports;
- ``start_stats`` counts the actors forked and spawned;
- ``shutdown`` ends the server.
"""

import importlib
import os
import sys

import numpy as np
import pytest

from ray_lightning_tpu_torch.cluster import forkserver
from ray_lightning_tpu_torch.cluster.executor import RLTExecutor
from ray_lightning_tpu_torch.cluster.local import (LocalBackend,
                                                   RemoteActorError)

TIMEOUT_S = 120
BANNED = ("jax", "flax", "optax", "ray_lightning_tpu")


def _facts(module: str) -> dict:
    """Runs in the actor."""
    return {"env": os.environ.get("RLT_FS_PROBE"), "cwd": os.getcwd(),
            "value": importlib.import_module(module).VALUE,
            "pid": os.getpid(), "ppid": os.getppid(),
            "dynamo": "torch._dynamo" in sys.modules,
            "banned": sorted({m.split(".")[0] for m in sys.modules}
                             & set(BANNED)),
            "draw": int(np.random.randint(2 ** 62))}


def _call(actor, *args):
    return actor.call("execute", *args).result(TIMEOUT_S)


@pytest.fixture(scope="module")
def backend():
    b = LocalBackend()
    yield b
    b.shutdown()


@pytest.fixture
def probe_module(tmp_path, monkeypatch):
    """A module the driver can import only from a path it adds now, and
    a working directory of the test's own."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "rlt_fs_probe_mod.py").write_text("VALUE = 7\n")
    monkeypatch.syspath_prepend(str(src))
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    return str(work)


def test_forked_actor_takes_its_env_cwd_and_path(backend, probe_module):
    actor = backend.create_actor(RLTExecutor, env={"RLT_FS_PROBE": "x"},
                                 name="fs-facts")
    try:
        got = _call(actor, _facts, "rlt_fs_probe_mod")
    finally:
        actor.kill()
    assert (got["env"], got["cwd"], got["value"]) == ("x", probe_module, 7)
    assert got["ppid"] == backend._forkserver._proc.pid != os.getpid()
    assert got["dynamo"] and got["banned"] == []
    stats = backend.start_stats()
    assert stats["forked"] >= 1 and stats["spawned"] == 0
    assert stats["preload_s"] > 0


def test_forked_actors_draw_their_own_numpy_seed(backend, probe_module):
    actors = [backend.create_actor(RLTExecutor, name=f"fs-seed-{i}")
              for i in range(2)]
    try:
        draws = [_call(a, _facts, "rlt_fs_probe_mod")["draw"]
                 for a in actors]
    finally:
        for a in actors:
            a.kill()
    assert draws[0] != draws[1]


def test_kill_reaps_the_forked_actor(backend, probe_module):
    actor = backend.create_actor(RLTExecutor, name="fs-kill")
    pid = _call(actor, _facts, "rlt_fs_probe_mod")["pid"]
    assert isinstance(actor._proc, forkserver.ForkedProcess)
    actor.kill()
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)
    assert actor._proc.returncode is not None


def test_exit_code_of_an_actor_that_exits(backend):
    actor = backend.create_actor(RLTExecutor, name="fs-exit")
    try:
        with pytest.raises(RemoteActorError, match="died"):
            _call(actor, os._exit, 3)
        assert actor._proc.wait(timeout=TIMEOUT_S) == 3
    finally:
        actor.kill()


@pytest.mark.parametrize("how", ["no_fork", "no_start"])
def test_spawns_a_fresh_interpreter_without_the_server(how, probe_module,
                                                       monkeypatch):
    if how == "no_fork":
        monkeypatch.setattr(forkserver.ForkServer, "spawn",
                            lambda self, *a, **k: None)
    else:
        # a server that dies at start reports itself unusable
        monkeypatch.setattr(forkserver, "__file__", "/nonexistent/fs.py")
    b = LocalBackend()
    try:
        actor = b.create_actor(RLTExecutor, env={"RLT_FS_PROBE": "y"},
                               name=f"fs-{how}")
        try:
            got = _call(actor, _facts, "rlt_fs_probe_mod")
        finally:
            actor.kill()
        assert not isinstance(actor._proc, forkserver.ForkedProcess)
        assert b.start_stats()["forked"] == 0
        assert b.start_stats()["spawned"] == 1
    finally:
        b.shutdown()
    assert (got["env"], got["cwd"], got["value"]) == ("y", probe_module, 7)
    assert got["ppid"] == os.getpid() and not got["dynamo"]


def test_shutdown_ends_the_server():
    b = LocalBackend()
    actor = b.create_actor(RLTExecutor, name="fs-shutdown")
    assert _call(actor, os.getpid) == actor._proc.pid
    server = b._forkserver._proc
    b.shutdown()
    assert server.poll() is not None
    assert actor._proc.poll() is not None
