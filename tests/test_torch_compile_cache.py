"""PyTorch/CUDA port, the compile plane (compile/): what a compile
cache holds on CUDA (the nvcc-built kernel libraries of ``csrc/*.cu``,
keyed by their sources), its config and env forms held against the JAX
package's, shipping, the precompiler, and the cache shared across
processes and Tune trials.

The CPU tests have no nvcc, so the keyed-library path is driven with
the host's C compiler through the same code (``ops/_kernels.py``
``Kernel(compiler=, flags=, csrc=)``): a cold process counts a miss (a
compiler run), a warm one a hit and no miss.  The card's run of the
same path over the four kernel sources is ``tests/test_torch_cuda.py``
and ``chip_smoke.py``'s planner phase.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from ray_lightning_tpu_torch import Trainer, tune
from ray_lightning_tpu_torch.compile import aot, shipping
from ray_lightning_tpu_torch.compile import cache as cc
from ray_lightning_tpu_torch.models.boring import BoringModel
from ray_lightning_tpu_torch.ops import _kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CC = shutil.which("cc") or shutil.which("gcc") or shutil.which("g++")
needs_cc = pytest.mark.skipif(CC is None, reason="no host C compiler")


@pytest.fixture(autouse=True)
def _isolate_cache_state():
    cc.reset_stats()
    counted = set(_kernels._COUNTED)
    yield
    cc.deactivate()
    _kernels._COUNTED.clear()
    _kernels._COUNTED.update(counted)


def _clear_env(monkeypatch):
    for k in cc.ENV_KNOBS + (cc.ENV_NAMESPACE,):
        monkeypatch.delenv(k, raising=False)


# -- config / env resolution, against the JAX package ----------------------

def test_config_default_disabled(monkeypatch):
    _clear_env(monkeypatch)
    assert not cc.CompileCacheConfig.resolve(None).enabled


def test_config_env_enable_forms(monkeypatch, tmp_path):
    _clear_env(monkeypatch)
    monkeypatch.setenv(cc.ENV_ENABLE, "1")
    cfg = cc.CompileCacheConfig.resolve(None)
    assert cfg.enabled and cfg.root == cc.DEFAULT_ROOT
    monkeypatch.setenv(cc.ENV_ENABLE, str(tmp_path / "root"))
    cfg = cc.CompileCacheConfig.resolve(None)
    assert cfg.enabled and cfg.root == str(tmp_path / "root")
    monkeypatch.setenv(cc.ENV_ENABLE, "0")
    monkeypatch.setenv(cc.ENV_DIR, str(tmp_path))
    assert not cc.CompileCacheConfig.resolve(None).enabled


def test_config_forms_match_jax(monkeypatch, tmp_path):
    """Every argument and env form resolves to the JAX config's
    ``enabled`` and ``dir`` (the roots differ only in their default: the
    port's holds kernel libraries, not XLA executables), and a worker's
    env carries the same two knobs."""
    from ray_lightning_tpu.compile import cache as jcc
    _clear_env(monkeypatch)
    for form in (None, False, True, str(tmp_path), {"dir": str(tmp_path)}):
        mine, theirs = (cc.CompileCacheConfig.resolve(form),
                        jcc.CompileCacheConfig.resolve(form))
        assert (mine.enabled, mine.dir) == (theirs.enabled, theirs.dir)
    monkeypatch.setenv(cc.ENV_DIR, str(tmp_path))
    cfg = cc.CompileCacheConfig.resolve(None)
    assert (cfg.enabled, cfg.root) == (True, str(tmp_path))
    theirs = jcc.CompileCacheConfig.resolve(None).worker_env()
    assert cfg.worker_env() == {k: theirs[k] for k in cc.ENV_KNOBS}
    with pytest.raises(TypeError):
        cc.CompileCacheConfig.resolve(3.14)


def test_worker_env_round_trip(monkeypatch, tmp_path):
    _clear_env(monkeypatch)
    cfg = cc.CompileCacheConfig(enabled=True, dir=str(tmp_path))
    for k, v in cfg.worker_env().items():
        monkeypatch.setenv(k, v)
    assert cc.CompileCacheConfig.resolve(None) == cfg
    assert cc.CompileCacheConfig(enabled=False).worker_env() == {}


def test_namespace_dir_components(tmp_path):
    """``<root>/torch<ver>-cuda<ver>-<device name>-sm<cc>-d<devices>-
    p<procs>``: without a card, the CPU's; path-safe."""
    ns = cc.namespace_dir(str(tmp_path))
    base = os.path.basename(ns)
    assert os.path.dirname(ns) == str(tmp_path)
    assert base.startswith(f"torch{torch.__version__}")
    assert f"-cuda{torch.version.cuda or 'none'}-" in base
    assert base.endswith("-cpu-sm0-d1-p1")
    assert "/" not in base and " " not in base


def test_workers_take_their_drivers_namespace(monkeypatch, tmp_path):
    """A driver that activated the cache ships its namespace in the
    worker env; a worker (whatever its world) resolves the same dir."""
    _clear_env(monkeypatch)
    cfg = cc.CompileCacheConfig(enabled=True, dir=str(tmp_path))
    assert cc.ENV_NAMESPACE not in cfg.worker_env()
    ns = cc.activate(cfg)
    env = cfg.worker_env()
    assert env[cc.ENV_NAMESPACE] == os.path.basename(ns)
    cc.deactivate()
    monkeypatch.setenv(cc.ENV_NAMESPACE, "torchX-cudaY-card-sm90-d1-p1")
    assert cc.namespace_dir(str(tmp_path)) == str(
        tmp_path / "torchX-cudaY-card-sm90-d1-p1")


def test_activate_points_the_kernel_libraries_at_the_namespace(tmp_path):
    ns = cc.activate(cc.CompileCacheConfig(enabled=True, dir=str(tmp_path)))
    assert cc.active_dir() == ns and os.path.isdir(ns)
    assert str(_kernels.library_dir()) == ns
    for k in _kernels.REGISTRY.values():
        assert str(k.library_path().parent) == ns
    assert cc.status_word() == "miss"
    cc.deactivate()
    assert _kernels.library_dir() == _kernels.BUILD_DIR
    assert cc.status_word() == "off"
    assert cc.activate(cc.CompileCacheConfig()) is None


# -- shipping ----------------------------------------------------------------

def test_pack_unpack_round_trip(tmp_path):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a").write_bytes(b"alpha")
    (src / "sub" / "b").write_bytes(b"beta" * 100)
    blob = shipping.pack_cache_dir(str(src))
    dst = tmp_path / "dst"
    assert shipping.unpack_cache_dir(blob, str(dst)) == 2
    assert (dst / "a").read_bytes() == b"alpha"
    assert (dst / "sub" / "b").read_bytes() == b"beta" * 100
    (dst / "a").write_bytes(b"newer")
    assert shipping.unpack_cache_dir(blob, str(dst)) == 0
    assert (dst / "a").read_bytes() == b"newer"


def test_pack_empty_and_missing(tmp_path):
    assert shipping.pack_cache_dir(str(tmp_path / "nope")) is None
    (tmp_path / "empty").mkdir()
    assert shipping.pack_cache_dir(str(tmp_path / "empty")) is None


def test_pack_cap_keeps_newest(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "old").write_bytes(b"x" * 600)
    os.utime(src / "old", (1, 1))
    (src / "new").write_bytes(b"y" * 600)
    blob = shipping.pack_cache_dir(str(src), max_bytes=1000)
    shipping.unpack_cache_dir(blob, str(tmp_path / "dst"))
    assert (tmp_path / "dst" / "new").exists()
    assert not (tmp_path / "dst" / "old").exists()


# -- the precompiler -----------------------------------------------------------

def test_precompiler_runs_builds_in_order():
    pre = aot.AotPrecompiler(enabled=True)
    done = []
    pre.submit("a", lambda: done.append("a"))
    pre.submit("b", lambda: done.append("b"))
    results = pre.barrier(timeout=30)
    assert done == ["a", "b"] and pre.succeeded("a") and pre.succeeded("b")
    assert set(results) == {"a", "b"}


def test_precompiler_failure_is_soft():
    pre = aot.AotPrecompiler(enabled=True)

    def boom():
        raise RuntimeError("nvcc not found")
    pre.submit("bad", boom)
    results = pre.barrier(timeout=30)
    assert isinstance(results["bad"], RuntimeError)
    assert not pre.succeeded("bad")


def test_precompiler_disabled_is_a_no_op(monkeypatch, tmp_path):
    ran = []
    assert not aot.AotPrecompiler.resolve().enabled     # no active cache
    cc.activate(cc.CompileCacheConfig(enabled=True, dir=str(tmp_path)))
    assert aot.AotPrecompiler.resolve().enabled
    monkeypatch.setenv(aot.ENV_AOT, "0")
    pre = aot.AotPrecompiler.resolve()
    assert not pre.enabled
    pre.submit("x", lambda: ran.append(1))
    assert pre.barrier() == {} and ran == []


def test_abstract_helpers():
    import numpy as np
    batch = (np.zeros((4, 8), np.float32), torch.zeros(4, dtype=torch.int64))
    ab = aot.global_batch_abstract(batch, 2)
    assert [tuple(t.shape) for t in ab] == [(8, 8), (8,)]
    assert ab[0].device.type == "meta" and ab[1].dtype == torch.int64
    st = aot.stack_abstract(ab, 3)
    assert [tuple(t.shape) for t in st] == [(3, 8, 8), (3, 8)]


def test_fit_records_first_step_and_engages_the_precompiler(tmp_path):
    t = Trainer(max_steps=2, enable_checkpointing=False, logger=False,
                num_sanity_val_steps=0, limit_val_batches=0, device="cpu",
                default_root_dir=str(tmp_path),
                compile_cache=str(tmp_path / "cc"))
    t.fit(BoringModel(batch_size=16, dataset_length=64))
    assert t.time_to_first_step is not None and t.time_to_first_step > 0
    assert t._precompiler is not None and t._precompiler.enabled
    assert cc.active_dir().startswith(str(tmp_path / "cc"))
    plain = Trainer(max_steps=2, enable_checkpointing=False, logger=False,
                    num_sanity_val_steps=0, limit_val_batches=0,
                    device="cpu", default_root_dir=str(tmp_path))
    cc.deactivate()
    plain.fit(BoringModel(batch_size=16, dataset_length=64))
    assert not plain._precompiler.enabled


def test_metrics_publish_the_counters():
    class Gauge:
        def __init__(self):
            self.value = None

        def set(self, v):
            self.value = v

    class Registry:
        def __init__(self):
            self.gauges = {}

        def gauge(self, name):
            return self.gauges.setdefault(name, Gauge())

    cc.note_library(hit=False, seconds=2.5)
    cc.note_library(hit=True)
    cc.note_capture(0.5)
    reg = Registry()
    cc.publish_metrics(reg)
    assert {k: g.value for k, g in reg.gauges.items()} == {
        "rlt_compile_cache_hits_total": 1,
        "rlt_compile_cache_misses_total": 1,
        "rlt_compile_seconds_total": 3.0}
    s = cc.stats()
    assert (s.captures, s.hits, s.misses) == (1, 1, 1)


def test_compile_selfcheck_runs():
    from ray_lightning_tpu_torch.compile import selfcheck
    assert selfcheck.run_selfcheck() == []


# -- the keyed libraries across processes and trials ------------------------

_CHILD = textwrap.dedent('''
    import json, sys
    from ray_lightning_tpu_torch.compile import cache
    from ray_lightning_tpu_torch.ops import _kernels
    root, src, compiler = sys.argv[1:4]
    cache.activate(cache.CompileCacheConfig(enabled=True, dir=root))
    k = _kernels.Kernel("one", "one.c", "rlt_one", "", compiler=compiler,
                        flags=("-shared", "-fPIC", "-O1"), csrc=src,
                        register=False)
    assert k.function()() == 7
    print(json.dumps(cache.stats().to_dict()))
''')


def _child(tmp_path, root, src) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", _CHILD, str(root),
                          str(src), CC], capture_output=True, text=True,
                         cwd=str(tmp_path), env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@needs_cc
def test_cold_then_warm_across_processes(tmp_path):
    """One root, two processes: the first builds the keyed library (one
    miss, compile seconds), the second finds it by its key (one hit, no
    miss, no compile seconds); a changed source is a new key (a miss)."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "one.c").write_text("int rlt_one(void) { return 7; }\n")
    root = tmp_path / "cache"
    cold = _child(tmp_path, root, src)
    assert (cold["misses"], cold["hits"]) == (1, 0)
    assert cold["build_seconds"] > 0
    warm = _child(tmp_path, root, src)
    assert (warm["misses"], warm["hits"]) == (0, 1)
    assert warm["build_seconds"] == 0
    (src / "one.c").write_text("int rlt_one(void) { return 7; } /* v2 */\n")
    assert _child(tmp_path, root, src)["misses"] == 1
    libs = [f for _, _, fs in os.walk(root) for f in fs]
    assert len(libs) == 2 and all(f.startswith("libone-") for f in libs)


def _keyed_trainable(config, checkpoint_dir=None):
    """A trial: a Trainer made inside it takes the experiment's cache
    (no argument), then one keyed library is needed from it."""
    trainer = Trainer(max_steps=1, enable_checkpointing=False,
                      logger=False, num_sanity_val_steps=0,
                      limit_val_batches=0, device="cpu",
                      default_root_dir=tune.get_trial_dir())
    trainer.fit(BoringModel(batch_size=16, dataset_length=64))
    before = cc.stats()
    _kernels._COUNTED.clear()
    k = _kernels.Kernel("one", "one.c", "rlt_one", "", compiler=CC,
                        flags=("-shared", "-fPIC", "-O1"),
                        csrc=config["src"], register=False)
    k.function()
    after = cc.stats()
    tune.report(loss=0.0, root=trainer.compile_cache.root,
                hit=after.hits - before.hits,
                miss=after.misses - before.misses)


@needs_cc
def test_tune_trials_share_one_cache(tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "one.c").write_text("int rlt_one(void) { return 7; }\n")
    analysis = tune.run(_keyed_trainable, config={"src": str(src)},
                        num_samples=2, metric="loss", mode="min",
                        local_dir=str(tmp_path), name="cc_exp")
    results = [t.last_result for t in analysis.trials]
    root = os.path.join(str(tmp_path), "cc_exp", "compile_cache")
    assert all(r["root"] == root for r in results)
    assert sorted((r["miss"], r["hit"]) for r in results) == [(0, 1),
                                                              (1, 0)]
    assert os.path.isdir(root)


def test_tune_cache_optout(tmp_path, monkeypatch):
    monkeypatch.setenv("RLT_COMPILE_CACHE", "0")

    def trainable(config, checkpoint_dir=None):
        trainer = Trainer(max_steps=1, enable_checkpointing=False,
                          logger=False, num_sanity_val_steps=0,
                          limit_val_batches=0, device="cpu",
                          default_root_dir=tune.get_trial_dir())
        trainer.fit(BoringModel(batch_size=16, dataset_length=64))
        tune.report(loss=0.0, on=trainer.compile_cache.enabled)

    analysis = tune.run(trainable, config={}, num_samples=1, metric="loss",
                        mode="min", local_dir=str(tmp_path), name="cc_off")
    assert analysis.trials[0].last_result["on"] is False
    assert not os.path.isdir(os.path.join(str(tmp_path), "cc_off",
                                          "compile_cache"))
