"""PyTorch/CUDA port, the elastic plane's units (ray_lightning_tpu_torch/
elastic/): the 21 tests of tests/test_elastic.py that need no telemetry
aggregator, and direct comparisons with the JAX package.

Counterparts: config resolution (env, forms), fault specs (parsing,
lists, the new kinds, the slow fault's stall, peerdrop swallowing
inbound frames), snapshots (cadence, backpressure skips, failures
absorbed then raised), the inert default, the loader rescale, the
failure classifier, a missing snapshot directory, a reshard onto
another model raising naming the leaf, the XOR parity at every
position, the partition packer, the redundancy manager's tick and the
driver's reconstruction over a loopback channel, a tick skipped on a
silent peer, the declared parity bytes and the residual re-bucket.
``test_worker_alive_gauges_and_restarts_counter`` and
``test_worker_alive_falls_back_to_heartbeat_age`` wait for the
telemetry plane (ROADMAP.md queue 1 item 13).

Against JAX: ``ElasticConfig.resolve`` (dicts, bools, the environment)
and ``parse_fault(s)`` (their errors included) give equal fields;
``xor_blocks``, ``recover_block`` and ``ParityGroup.holder_of`` are
byte-equal on numpy-seeded blobs at every position for k in {1, 2};
``_rebucket`` keeps the injected error sum and equals JAX's.  Also the
parity route's restore in one process, bit for bit with bf16 moments,
the selfcheck, and a grep that no module of the port or
``chip_smoke.py`` imports ``jax`` or the JAX package.
"""

import dataclasses
import os
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch import BoringModel, DataLoader, Trainer
from ray_lightning_tpu_torch.cluster.peer import Mailbox
from ray_lightning_tpu_torch.elastic import ElasticConfig
from ray_lightning_tpu_torch.elastic import redundancy as red
from ray_lightning_tpu_torch.elastic.driver import (_restartable,
                                                    latest_snapshot_step)
from ray_lightning_tpu_torch.elastic.faults import (FaultSpec, parse_fault,
                                                    parse_faults)
from ray_lightning_tpu_torch.models.boring import RandomDataset
from ray_lightning_tpu_torch.ops.optim import AdamW
from ray_lightning_tpu_torch.telemetry.aggregator import \
    WorkerHeartbeatTimeout
from ray_lightning_tpu_torch.utils.checkpoint import ShardedCheckpointer

ROOT = Path(__file__).resolve().parent.parent


def _local(tmp_path, max_steps, elastic=None, module=None, **kw):
    trainer = Trainer(max_epochs=10, max_steps=max_steps,
                      enable_checkpointing=False, num_sanity_val_steps=0,
                      limit_val_batches=0, seed=0, log_every_n_steps=1,
                      logger=False, default_root_dir=str(tmp_path),
                      device="cpu", elastic=elastic, **kw)
    trainer.fit(module or BoringModel())
    return trainer


# -- config ------------------------------------------------------------------------

def test_elastic_config_resolve_env(monkeypatch):
    monkeypatch.setenv("RLT_ELASTIC", "1")
    monkeypatch.setenv("RLT_ELASTIC_EVERY", "25")
    monkeypatch.setenv("RLT_ELASTIC_DIR", "/tmp/snaps")
    monkeypatch.setenv("RLT_ELASTIC_MAX_RESTARTS", "5")
    monkeypatch.setenv("RLT_ELASTIC_MIN_WORKERS", "2")
    monkeypatch.setenv("RLT_ELASTIC_KEEP", "7")
    monkeypatch.setenv("RLT_ELASTIC_PRESERVE_BATCH", "0")
    monkeypatch.setenv("RLT_ELASTIC_REDUNDANCY", "2")
    monkeypatch.setenv("RLT_ELASTIC_REDUNDANCY_EVERY", "4")
    monkeypatch.setenv("RLT_ELASTIC_SNAPSHOT_FAILURES", "9")
    cfg = ElasticConfig.resolve(None)
    assert cfg == ElasticConfig(
        enabled=True, snapshot_every_n_steps=25, snapshot_dir="/tmp/snaps",
        max_restarts=5, min_workers=2, preserve_global_batch=False,
        max_to_keep=7, redundancy=2, redundancy_every_n_steps=4,
        max_snapshot_failures=9)
    for k in list(os.environ):
        if k.startswith("RLT_ELASTIC"):
            monkeypatch.delenv(k)
    for k, v in cfg.worker_env().items():
        monkeypatch.setenv(k, v)
    assert ElasticConfig.resolve(None) == cfg


def test_elastic_config_forms():
    assert not ElasticConfig.resolve(None).enabled
    assert ElasticConfig.resolve(True).enabled
    cfg = ElasticConfig.resolve({"snapshot_every_n_steps": 4})
    assert cfg.enabled and cfg.snapshot_every_n_steps == 4
    with pytest.raises(ValueError):
        ElasticConfig(enabled=True, min_workers=0)
    with pytest.raises(TypeError):
        ElasticConfig.resolve(3.14)
    assert ElasticConfig().resolve_dir("/data/x") == "/data/x/elastic"


CONFIG_CASES = {
    "none": (None, {}),
    "true": (True, {}),
    "false": (False, {}),
    "dict": ({"snapshot_every_n_steps": 4, "redundancy": 1,
              "max_to_keep": None}, {}),
    "dict-off": ({"enabled": False, "min_workers": 3}, {}),
    "env": (None, {"RLT_ELASTIC": "true", "RLT_ELASTIC_EVERY": "3",
                   "RLT_ELASTIC_KEEP": "4", "RLT_ELASTIC_REDUNDANCY": "1",
                   "RLT_ELASTIC_PRESERVE_BATCH": "False",
                   "RLT_ELASTIC_DIR": "memory://snaps"}),
    "env-blank": (None, {"RLT_ELASTIC": "1", "RLT_ELASTIC_EVERY": "",
                         "RLT_ELASTIC_MAX_RESTARTS": ""}),
}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_elastic_config_equals_jax(case, monkeypatch):
    """``resolve`` and ``worker_env`` give equal fields in both
    packages."""
    from ray_lightning_tpu.elastic.config import ElasticConfig as JaxCfg

    value, env = CONFIG_CASES[case]
    for k in list(os.environ):
        if k.startswith("RLT_ELASTIC"):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = ElasticConfig.resolve(value)
    want = JaxCfg.resolve(value)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.worker_env() == want.worker_env()
    assert got.resolve_dir("/r") == want.resolve_dir("/r")


# -- fault specs -------------------------------------------------------------------

def test_fault_spec_parsing():
    s = parse_fault("kill:rank=1,step=5")
    assert s == FaultSpec("kill", 1, 5)
    assert s.should_fire(1, 5) and s.should_fire(1, 9)
    assert not s.should_fire(0, 5) and not s.should_fire(1, 4)
    assert parse_fault("slow:rank=0,step=2,seconds=0.25").seconds == 0.25
    assert parse_fault("kill:rank=2,step=3,code=9").exit_code == 9
    assert parse_fault(s.describe()) == s
    for bad in ("", "kill", "boom:rank=1,step=2", "kill:step=2",
                "kill:rank=1,step=0", "kill:rank=1,step=2,what=3"):
        with pytest.raises(ValueError):
            parse_fault(bad)


FAULTS = ("kill:rank=1,step=5", "kill:rank=2,step=3,code=9",
          "wedge:rank=0,step=2", "slow:rank=0,step=2,seconds=0.25",
          "slow:rank=1,step=3,seconds=0.5,count=4",
          "snapkill:rank=1,step=4,code=7", "peerdrop:rank=0,step=3,count=5",
          "kill:rank=0,step=5,restart=0",
          "kill:rank=1,step=5 ; kill:rank=2,step=9",
          "", "kill", "boom:rank=1,step=2", "kill:step=2",
          "kill:rank=1,step=0", "kill:rank=1,step=2,what=3",
          "kill:rank=-1,step=2", "peerdrop:rank=0,step=1,count=0",
          "kill:rank=1,step=5;boom:rank=2,step=1", " ; ",
          "kill:rank=1;step=2", "slow:rank=0,step=1,seconds=0")


@pytest.mark.parametrize("raw", FAULTS)
def test_faults_parse_equal_to_jax(raw):
    """``parse_faults`` (and ``parse_fault`` of a single clause) gives
    equal fields, ``describe`` strings and ``should_fire`` answers in
    both packages, or the same error."""
    from ray_lightning_tpu.elastic import faults as jf

    def outcome(mod):
        try:
            specs = mod.parse_faults(raw)
        except ValueError as e:
            return ("error", str(e))
        return [(dataclasses.asdict(s), s.describe(),
                 [s.should_fire(r, st, rs) for r in range(3)
                  for st in range(1, 12) for rs in range(2)])
                for s in specs]

    from ray_lightning_tpu_torch.elastic import faults as tf
    assert outcome(tf) == outcome(jf)
    if ";" not in raw:
        def single(mod):
            try:
                return dataclasses.asdict(mod.parse_fault(raw))
            except ValueError as e:
                return ("error", str(e))
        assert single(tf) == single(jf)


def test_slow_fault_injects_stall(tmp_path, monkeypatch):
    """The slow-rank fault measurably stalls the run without changing its
    result."""
    t0 = time.monotonic()
    monkeypatch.setenv("RLT_FAULT", "slow:rank=0,step=2,seconds=0.2")
    trainer = _local(tmp_path, 3)
    assert trainer.global_step == 3
    assert time.monotonic() - t0 >= 0.4     # steps 2 and 3 each stalled


def test_fault_list_and_new_kinds():
    specs = parse_faults("kill:rank=1,step=5 ; kill:rank=2,step=9")
    assert [(s.rank, s.step) for s in specs] == [(1, 5), (2, 9)]
    snap = parse_fault("snapkill:rank=1,step=4,code=7")
    assert snap.kind == "snapkill" and snap.exit_code == 7
    assert parse_fault(snap.describe()) == snap
    drop = parse_fault("peerdrop:rank=0,step=3,count=5")
    assert drop.count == 5
    assert parse_fault(drop.describe()) == drop
    with pytest.raises(ValueError, match="boom:rank=2,step=1"):
        parse_faults("kill:rank=1,step=5;boom:rank=2,step=1")
    with pytest.raises(ValueError, match="names no fault"):
        parse_faults(" ; ")
    with pytest.raises(ValueError):
        parse_fault("peerdrop:rank=0,step=1,count=0")


def test_peerdrop_swallows_inbound_frames():
    from ray_lightning_tpu_torch.cluster import worker_state

    worker_state.reset_for_tests()
    try:
        worker_state.arm_peer_drop(2)
        box = worker_state.peer_mailbox()
        for i in range(3):
            worker_state.peer_push({"tag": ("t", i), "wire": i})
        assert worker_state.peer_drop_pending() == 0
        assert box.take(("t", 2), 0.2) == 2
        with pytest.raises(Exception):
            box.take(("t", 0), 0.05)
    finally:
        worker_state.reset_for_tests()


# -- snapshots ---------------------------------------------------------------------

def test_snapshot_cadence_and_stats(tmp_path):
    snap = str(tmp_path / "elastic")
    trainer = _local(tmp_path, 6, {"snapshot_every_n_steps": 2,
                                   "snapshot_dir": snap})
    stats = trainer.elastic_stats()
    assert stats["snapshots"] + stats["skipped"] == 3    # steps 2, 4, 6
    assert stats["snapshots"] >= 1
    assert len(stats["save_seconds_each"]) == stats["snapshots"]
    trainer.wait_for_checkpoints()
    ck = ShardedCheckpointer(snap)
    steps = ck.all_steps()
    ck.close()
    assert steps and all(s in (2, 4, 6) for s in steps)
    assert latest_snapshot_step(snap) == steps[-1]


def test_snapshot_backpressure_skips_never_queues(tmp_path, monkeypatch):
    """While a save still writes, a one-process cadence hit is skipped,
    not queued."""
    monkeypatch.setattr(ShardedCheckpointer, "saving_in_progress",
                        lambda self: True)
    trainer = _local(tmp_path, 4, {"snapshot_every_n_steps": 1,
                                   "snapshot_dir": str(tmp_path / "el")})
    stats = trainer.elastic_stats()
    assert stats["snapshots"] == 0
    assert stats["skipped"] == 4
    assert stats["stall_seconds"] == 0.0


def test_elastic_off_keeps_trainer_inert(tmp_path):
    trainer = _local(tmp_path, 2)
    assert trainer._snapshotter is None
    assert trainer.elastic_stats() is None
    assert not (tmp_path / "elastic").exists()


def test_snapshot_failure_is_absorbed_and_counted(tmp_path, monkeypatch):
    """A flaky save does not kill training: caught, counted, retried at
    the next cadence hit; a success resets the count in a row."""
    calls = {"n": 0}
    real = Trainer.save_sharded_checkpoint

    def flaky(self, directory, step=None, max_to_keep=None):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise OSError("disk full (injected)")
        return real(self, directory, step=step, max_to_keep=max_to_keep)

    monkeypatch.setattr(Trainer, "save_sharded_checkpoint", flaky)
    trainer = _local(tmp_path, 4, {"snapshot_every_n_steps": 1,
                                   "snapshot_dir": str(tmp_path / "el"),
                                   "max_snapshot_failures": 3})
    assert trainer.global_step == 4
    stats = trainer.elastic_stats()
    assert stats["failed"] == 2
    assert stats["snapshots"] >= 1
    assert stats["snapshots"] + stats["skipped"] == 2


def test_snapshot_consecutive_failures_eventually_raise(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(
        Trainer, "save_sharded_checkpoint",
        lambda self, directory, step=None, max_to_keep=None:
        (_ for _ in ()).throw(OSError("target gone (injected)")))
    trainer = Trainer(
        max_epochs=10, max_steps=8, enable_checkpointing=False,
        num_sanity_val_steps=0, limit_val_batches=0, seed=0,
        log_every_n_steps=1, logger=False, default_root_dir=str(tmp_path),
        device="cpu", elastic={"snapshot_every_n_steps": 1,
                               "snapshot_dir": str(tmp_path / "el"),
                               "max_snapshot_failures": 2})
    with pytest.raises(OSError, match="target gone"):
        trainer.fit(BoringModel())
    assert trainer.elastic_stats()["failed"] == 2


# -- shrink plumbing ---------------------------------------------------------------

def test_elastic_rescale_preserves_global_batch(tmp_path):
    trainer = Trainer(max_epochs=1, enable_checkpointing=False, seed=0,
                      logger=False, default_root_dir=str(tmp_path),
                      device="cpu", elastic={"snapshot_every_n_steps": 0})
    trainer._elastic_state = {"initial_workers": 4}
    trainer._world = {"world_size": 2, "global_rank": 0, "local_rank": 0,
                      "node_rank": 0}
    loader = DataLoader(RandomDataset(32, 64), batch_size=3)
    out = trainer._elastic_rescale_loader(loader, "train")
    assert out.batch_size == 6          # 4 workers x 3 == 2 workers x 6
    assert out.dataset is loader.dataset
    assert loader.batch_size == 3
    trainer._world["world_size"] = 5    # 12 does not divide: kept
    assert trainer._elastic_rescale_loader(loader, "train").batch_size == 3
    trainer._world["world_size"] = 4    # no shrink: the loader itself
    assert trainer._elastic_rescale_loader(loader, "train") is loader


def test_failure_classifier():
    assert _restartable(RuntimeError("anything"), dead_ranks=[1])
    assert _restartable(WorkerHeartbeatTimeout("rank 1 silent"), [])
    assert _restartable(RuntimeError(
        "actor rlt-worker-1 died (connection lost)"), [])
    # the plugin's timeout past a wedged rank (no heartbeat watchdog yet)
    assert _restartable(TimeoutError(
        "workers [1] of 2 still running after 30 s"), [])
    assert not _restartable(RuntimeError("ValueError in training_step"),
                            [])


def test_latest_snapshot_step_missing_dir(tmp_path):
    assert latest_snapshot_step(str(tmp_path / "nope")) is None


# -- reshard -------------------------------------------------------------------------

class WiderBoring(BoringModel):
    def configure_model(self, device=None):
        from ray_lightning_tpu_torch.models.boring import DenseStack
        return DenseStack((32, 5), device)      # 2 -> 5 output features


def test_reshard_rejects_incompatible_shapes(tmp_path):
    """Another model's snapshot raises naming the leaf, before a read."""
    t1 = _local(tmp_path, 1)
    ck = str(tmp_path / "ck")
    t1.save_sharded_checkpoint(ck)
    t1.wait_for_checkpoints()
    with pytest.raises(ValueError, match="params/Dense_0.weight"):
        _local(tmp_path / "b", 1, module=WiderBoring(),
               resume_from_checkpoint=ck)


def test_rebucket_preserves_injected_error_sum():
    from ray_lightning_tpu_torch.elastic.reshard import _rebucket

    old = {"w": torch.arange(24, dtype=torch.float32).reshape(4, 6)}
    for m in (1, 2, 8):
        new = _rebucket(old, m)["w"]
        assert new.shape == (m, 6)
        torch.testing.assert_close(new.sum(0) / m, old["w"].sum(0) / 4,
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("m", [1, 2, 3, 8])
def test_rebucket_equals_jax(m):
    """The residual re-bucket equals JAX's on seeded rows, and both keep
    the injected error sum."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ray_lightning_tpu.elastic.reshard import _rebucket as jax_rebucket
    from ray_lightning_tpu_torch.elastic.reshard import _rebucket

    rng = np.random.default_rng(m)
    old = {"w": rng.standard_normal((4, 3, 5)).astype(np.float32),
           "b": rng.standard_normal((4, 7)).astype(np.float32)}
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    rep = {k: NamedSharding(mesh, P()) for k in old}
    want = {k: np.asarray(v) for k, v in jax_rebucket(old, m, rep).items()}
    got = _rebucket({k: torch.from_numpy(v) for k, v in old.items()}, m)
    for k in old:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
        np.testing.assert_allclose(got[k].numpy().sum(0) / m,
                                   old[k].sum(0) / 4, rtol=1e-5, atol=1e-6)


def test_saved_residual_world_reads_the_metadata():
    from ray_lightning_tpu_torch.elastic.reshard import saved_residual_world
    md = {"params/w": ((3,), torch.float32),
          "opt_state/residual/w": ((4, 3), torch.float32)}
    assert saved_residual_world(md) == 4
    assert saved_residual_world({"params/w": ((3,), torch.float32)}) is None
    assert saved_residual_world(None) is None


# -- parity ----------------------------------------------------------------------------

def test_parity_xor_roundtrip_every_position():
    rng = np.random.default_rng(3)
    for world, k in ((2, 1), (3, 1), (4, 2)):
        blobs = [rng.bytes(50 + 11 * r) for r in range(world)]
        for dead in range(world):
            holder = red.ParityGroup.holder_of(dead, world, k)
            g = red.ParityGroup(holder, world, k)
            assert dead in g.covers
            parity = red.xor_blocks([blobs[m] for m in g.covers])
            others = [blobs[m] for m in g.covers if m != dead]
            assert red.recover_block(parity, others,
                                     len(blobs[dead])) == blobs[dead]


@pytest.mark.parametrize("world,k", [(2, 1), (3, 1), (3, 2), (4, 1),
                                     (4, 2), (5, 2)])
def test_parity_codec_equals_jax(world, k):
    """``xor_blocks``, ``recover_block``, ``ParityGroup`` and its
    ``holder_of`` byte-equal with JAX's at every dead position, blobs of
    unequal lengths."""
    from ray_lightning_tpu.elastic import redundancy as jr

    rng = np.random.default_rng(100 * world + k)
    blobs = [rng.integers(0, 256, 40 + 17 * r, dtype=np.uint8).tobytes()
             for r in range(world)]
    assert red.xor_blocks(blobs) == jr.xor_blocks(blobs)
    assert red.xor_blocks([]) == jr.xor_blocks([])
    for r in range(world):
        g, jg = red.ParityGroup(r, world, k), jr.ParityGroup(r, world, k)
        assert (g.covers, g.holders, g.k) == (jg.covers, jg.holders, jg.k)
    for dead in range(world):
        holder = red.ParityGroup.holder_of(dead, world, k)
        assert holder == jr.ParityGroup.holder_of(dead, world, k)
        members = red.ParityGroup(holder, world, k).covers
        parity = red.xor_blocks([blobs[m] for m in members])
        others = [blobs[m] for m in members if m != dead]
        got = red.recover_block(parity, others, len(blobs[dead]))
        assert got == jr.recover_block(parity, others, len(blobs[dead]))
        assert got == blobs[dead]


def _leaf(value, path, shape=None, index=None):
    return red.Leaf(value, tuple(path.split("/")),
                    tuple(value.shape) if shape is None else shape, index)


def test_pack_partition_splits_unique_and_replicated():
    """Rank-unique leaves (a ZeRO-1 shard) go to the unique blob with
    their global index, the rest to the replicated blob, and both
    assemble back bit for bit (a bf16 leaf as its bits)."""
    full = torch.arange(8, dtype=torch.float32)
    moment = torch.randn(4, generator=torch.Generator().manual_seed(0)
                         ).to(torch.bfloat16)
    leaves = {
        "opt/zero1/shard": _leaf(full[:4], "opt/zero1/shard", (8,),
                                 ((0, 4),)),
        "mu/zero1/shard": _leaf(moment, "mu/zero1/shard", (8,), ((0, 4),)),
        "params/w": _leaf(torch.ones(3), "params/w"),
        "count": red.Leaf(5, ("count",), (), None),
    }
    uu = red.unpack_partition(red.pack_partition(leaves, unique=True))
    rr = red.unpack_partition(red.pack_partition(leaves, unique=False))
    assert set(uu) == {"opt/zero1/shard", "mu/zero1/shard"}
    assert set(rr) == {"params/w", "count"}
    other = red.unpack_partition(red.pack_partition(
        {"opt/zero1/shard": _leaf(full[4:], "opt/zero1/shard", (8,),
                                  ((4, 8),))}, unique=True))
    entry = dict(uu["opt/zero1/shard"])
    entry["pieces"] = entry["pieces"] + other["opt/zero1/shard"]["pieces"]
    assert torch.equal(red.leaf_value(entry), full)
    assert torch.equal(red.leaf_value(rr["params/w"]), torch.ones(3))
    assert red.leaf_value(rr["count"]) == 5
    half = red.leaf_value(dict(uu["mu/zero1/shard"],
                               pieces=uu["mu/zero1/shard"]["pieces"]
                               + [(((4, 8),), np.zeros(4, np.int16))]))
    assert half.dtype == torch.bfloat16
    assert torch.equal(half[:4].view(torch.int16), moment.view(torch.int16))
    with pytest.raises(ValueError, match="cover"):
        red.assemble_leaf(uu["opt/zero1/shard"])     # half the pieces


class _FakeTrainer:
    def __init__(self, step):
        self.global_step = step
        self.current_epoch = 0
        self.callbacks = []
        self.lightning_module = None


def _fake_manager(rank, world, blobs, reps, boxes, escrows, every=1):
    import pickle
    cfg = ElasticConfig(enabled=True, redundancy=1,
                        redundancy_every_n_steps=every)
    mgr = red.RedundancyManager(
        _FakeTrainer(step=2), cfg, rank, world,
        red.LoopbackParityTransport(boxes, rank),
        store=lambda e, _r=rank: escrows.__setitem__(_r, e))
    mgr._pack = lambda unique, _r=rank: pickle.dumps(
        blobs[_r] if unique else reps[_r])
    return mgr


def _piece(key, shape, idx, arr):
    return {key: {"path": tuple(key.split("/")), "shape": shape,
                  "dtype": "float32", "kind": "tensor",
                  "pieces": [(idx, arr)]}}


def test_redundancy_manager_tick_and_driver_reconstruction():
    """Two simulated ranks tick over a loopback channel; with either one
    dead, the driver rebuilds its partition bit for bit, checks its
    digest and assembles a full package."""
    full = np.arange(8, dtype=np.float32).reshape(4, 2)
    blobs = {0: _piece("opt", (4, 2), ((0, 2), (0, 2)), full[:2]),
             1: _piece("opt", (4, 2), ((2, 4), (0, 2)), full[2:])}
    reps = {r: _piece("params", (3,), ((0, 3),), np.ones(3, np.float32))
            for r in range(2)}
    boxes = {0: Mailbox(), 1: Mailbox()}
    escrows: dict = {}
    mgrs = [_fake_manager(r, 2, blobs, reps, boxes, escrows)
            for r in range(2)]
    threads = [threading.Thread(target=m.maybe_tick) for m in mgrs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert set(escrows) == {0, 1}
    assert all(e["step"] == 2 for e in escrows.values())
    assert all(m.stats["parity_ticks"] == 1 for m in mgrs)
    assert all(m.stats["parity_bytes"] > 0 for m in mgrs)
    assert all(len(m.stats["parity_tick_seconds"]) == 1 for m in mgrs)

    for dead in (0, 1):
        surviving = {r: e for r, e in escrows.items() if r != dead}
        pkg, why = red.build_recovery(surviving, dead, world=2, k=1)
        assert pkg is not None, why
        assert pkg["step"] == 2 and pkg["dead_rank"] == dead
        assert pkg["dead_digest"] == escrows[dead]["unique_digest"]
        np.testing.assert_array_equal(
            red.assemble_leaf(pkg["leaves"]["opt"]), full)
        np.testing.assert_array_equal(
            red.assemble_leaf(pkg["leaves"]["params"]),
            np.ones(3, np.float32))

    pkg, why = red.build_recovery({}, 1, world=2, k=1)
    assert pkg is None and "no escrow" in why
    stale = {0: dict(escrows[0], step=1)}
    pkg, why = red.build_recovery(stale, 1, world=2, k=1)
    assert pkg is not None      # one survivor: one common step trivially
    corrupt = {0: dict(escrows[0], parity=bytes(len(escrows[0]["parity"])))}
    pkg, why = red.build_recovery(corrupt, 1, world=2, k=1)
    assert pkg is None and "hashes to" in why


def test_redundancy_tick_times_out_without_peer_and_skips():
    """A tick whose peer never sends costs a skipped tick (the previous
    escrow kept), not a wedge or a crash."""
    boxes = {0: Mailbox(), 1: Mailbox()}
    escrows: dict = {}
    full = np.zeros((2, 2), np.float32)
    blobs = {0: _piece("opt", (2, 2), ((0, 2), (0, 2)), full)}
    mgr = _fake_manager(0, 2, blobs, {0: {}}, boxes, escrows)
    mgr.transport.timeout_s = 0.1
    assert mgr.maybe_tick() is False
    assert mgr.stats["parity_skipped"] == 1
    assert 0 not in escrows


def test_declared_parity_bytes_counts_only_sharded_leaves():
    leaves = {"m": _leaf(torch.zeros(4, 2), "m", (8, 2), ((0, 4), (0, 2))),
              "c": red.Leaf(3, ("c",), (), None),
              "p": _leaf(torch.zeros(8, 2), "p")}
    # (8, 2) fp32 global, a (4, 2) shard of 32 bytes; k=1 every=1 -> 32
    assert red.declared_parity_bytes(leaves, 1, 1) == 32
    assert red.declared_parity_bytes(leaves, 2, 4) == 16


class BF16Boring(BoringModel):
    """Adam with bf16 first moments: the escrow must carry their bits."""

    def configure_optimizers(self):
        return AdamW(0.05, weight_decay=0.0, b2=0.999,
                     mu_dtype=torch.bfloat16)


def test_parity_package_restores_bit_for_bit(tmp_path):
    """The parity route's restore in one process: a trained ZeRO-1
    state's blob, packed and unpacked as the driver does, restores into
    a fresh trainer of another seed bit for bit (params, bf16 moments,
    the second moments, the count, step and seed)."""
    from ray_lightning_tpu_torch.elastic.redundancy import (
        pack_partition, partition_leaves, unpack_partition)

    t1 = _local(tmp_path / "a", 3, strategy="zero1", module=BF16Boring())
    leaves = partition_leaves(t1)
    assert leaves["opt_state/mu/zero1/shard"].value.dtype \
        == torch.bfloat16
    blob = pack_partition(leaves, unique=False)
    assert pack_partition(leaves, unique=True) == pack_partition(
        {}, unique=True)             # one rank: nothing rank-unique
    pkg = {"step": 3, "epoch": 0,
           "leaves": {k: {**e, "pieces": list(e["pieces"])}
                      for k, e in unpack_partition(blob).items()},
           "meta": {"epoch": 0, "global_step": 3, "callbacks": {}}}
    t2 = Trainer(max_epochs=10, max_steps=3, enable_checkpointing=False,
                 num_sanity_val_steps=0, limit_val_batches=0, seed=1,
                 logger=False, default_root_dir=str(tmp_path / "b"),
                 device="cpu", strategy="zero1")
    t2._elastic_recovery = pkg
    m2 = BF16Boring()
    t2.fit(m2)                       # max_steps reached: restore only
    assert t2.global_step == 3 and t2._elastic_recovery is None
    want = partition_leaves(t1)
    got = partition_leaves(t2)
    assert set(got) == set(want)
    for k in want:
        a, b = want[k].value, got[k].value
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), k
        else:
            assert a == b, k


# -- the selfcheck and the import boundary ---------------------------------------

def test_elastic_selfcheck_runs(capsys):
    from ray_lightning_tpu_torch.elastic.selfcheck import _main
    assert _main([]) == 0
    assert "bit-exact" in capsys.readouterr().out


def test_port_and_smoke_import_no_jax():
    """No module of the port, and not ``chip_smoke.py``, imports ``jax``
    or anything of the JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|"
                     r"ray_lightning_tpu)(\.|\s|$)", re.M)
    files = sorted((ROOT / "ray_lightning_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = [str(p.relative_to(ROOT)) for p in files
           if pat.search(p.read_text())]
    assert not bad, bad
