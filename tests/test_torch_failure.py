"""PyTorch/CUDA port, the elastic plane end to end: what
tests/test_failure.py:139-350 specifies, over two CPU workers
(``RayPlugin(platform="cpu")``) that lose rank 1 to an injected kill
(``RLT_FAULT=kill:rank=1,step=5``) and finish on one.

- shrink to continue: the fit does not raise, ends at ``max_steps`` on
  one worker, resumed from an even snapshot step; its params equal a
  clean one-worker resume from that snapshot at the doubled batch;
- zero-replay parity recovery (ZeRO-1, Adam moments): resumes at step 5,
  which no snapshot holds, with no snapshot restore, the rebuilt shard
  hashing to the digest the dead rank sent; params within 2e-2 of a
  clean run that mirrors it (two workers to step 5, then one at batch
  4), which is the JAX chaos tests' bar;
- redundancy off: the same fault replays from step 2 or 4 with exactly
  one restore, and matches its own clean mirror;
- peerdrop: rank 0 swallows one inbound peer frame, its parity tick
  times out and is skipped, no restart, later ticks complete.

The flight-dump assertions of the JAX tests wait for the telemetry
plane (ROADMAP.md queue 1 item 13).  These are the behaviours the JAX
package's own runs cannot show today (ROADMAP.md R2).  The workers
import this module by path: no JAX here.
"""

import os

import torch

from ray_lightning_tpu_torch import BoringModel, RayPlugin, Trainer
from ray_lightning_tpu_torch.ops.optim import AdamW

KILL = "kill:rank=1,step=5"
BAR = 2e-2


class AdamBoring(BoringModel):
    """``BoringModel`` with Adam moments (``optax.adam(0.05)``), so the
    ZeRO-1 shard a dead rank takes with it is not trivial."""

    def configure_optimizers(self):
        return AdamW(0.05, weight_decay=0.0, b2=0.999)


def _trainer(root, *, workers=2, fault=None, elastic=None, max_steps=8,
             resume=None, strategy="zero1", env=None):
    worker_env = dict(env or {})
    if fault:
        worker_env["RLT_FAULT"] = fault
    return Trainer(
        max_epochs=20, max_steps=max_steps, limit_val_batches=0,
        num_sanity_val_steps=0, enable_checkpointing=False, seed=0,
        log_every_n_steps=1, logger=False, default_root_dir=str(root),
        plugins=[RayPlugin(num_workers=workers, platform="cpu",
                           strategy=strategy, worker_env=worker_env,
                           timeout_s=240)],
        elastic=elastic, resume_from_checkpoint=resume)


def _params(module) -> dict:
    return {k: v.clone() for k, v in module._trained_state.items()}


def _close(got: dict, want: dict, tol: float) -> None:
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=tol, atol=tol)


def _clean_reference(tmp_path, stop_step: int, max_steps: int = 8) -> dict:
    """The params of a fault-free run mirroring a recovery resumed at
    ``stop_step``: two workers to ``stop_step`` (a snapshot every step),
    then one worker at the doubled batch to ``max_steps``."""
    snap = str(tmp_path / f"ref_snap_{stop_step}")
    _trainer(tmp_path / "ref1", max_steps=stop_step,
             elastic={"snapshot_every_n_steps": 1, "snapshot_dir": snap,
                      "max_restarts": 0}).fit(
        AdamBoring(dataset_length=64, batch_size=2))
    m2 = AdamBoring(dataset_length=64, batch_size=4)
    t2 = _trainer(tmp_path / "ref2", workers=1, max_steps=max_steps,
                  resume=os.path.join(snap, str(stop_step)))
    t2.fit(m2)
    assert t2.global_step == max_steps
    return _params(m2)


def test_elastic_shrink_to_continue_matches_clean_resume(tmp_path):
    """Two workers, snapshots every 2 steps, rank 1 killed at step 5: the
    fit shrinks to one worker without raising and completes; its params
    equal a clean one-worker resume from the same snapshot with the
    doubled batch (the same global batches)."""
    snap = str(tmp_path / "elastic")
    module = BoringModel(dataset_length=64, batch_size=2)
    # every snapshot kept: the resumed fleet's own saves would evict the
    # one the clean run resumes from
    trainer = _trainer(tmp_path, fault=KILL, strategy="ddp",
                       elastic={"snapshot_every_n_steps": 2,
                                "snapshot_dir": snap, "max_restarts": 2,
                                "max_to_keep": None})
    trainer.fit(module)

    assert trainer.global_step == 8
    rep = trainer._elastic_report
    assert rep["restarts"] == 1 and rep["recovery"] == "replay"
    assert rep["workers"] == 1 and rep["initial_workers"] == 2
    step = rep["resumed_step"]
    assert step is not None and step < 8 and step % 2 == 0
    assert rep["snapshots"] + rep["skipped"] >= 1
    assert rep["recovery_seconds"] > 0

    module2 = BoringModel(dataset_length=64, batch_size=4)
    clean = _trainer(tmp_path / "clean", workers=1, strategy="ddp",
                     resume=os.path.join(snap, str(step)))
    clean.fit(module2)
    assert clean.global_step == 8
    _close(_params(module), _params(module2), 1e-5)
    assert sum(float(v.abs().sum()) for v in _params(module).values()) > 0


def test_zero_replay_parity_recovery(tmp_path):
    """ZeRO-1 with parity on loses rank 1 at step 5.  Snapshots exist at
    steps 2 and 4 only, yet the run resumes at step 5 from the
    survivor's escrow and the parity block, reads no snapshot, and ends
    within 2e-2 of the clean mirror."""
    snap = str(tmp_path / "elastic")
    module = AdamBoring(dataset_length=64, batch_size=2)
    trainer = _trainer(tmp_path, fault=KILL,
                       elastic={"snapshot_every_n_steps": 2,
                                "snapshot_dir": snap, "max_restarts": 2,
                                "redundancy": 1})
    trainer.fit(module)

    assert trainer.global_step == 8
    rep = trainer._elastic_report
    assert rep["recovery"] == "parity"
    assert rep["restarts"] == 1
    assert rep["workers"] == 1 and rep["initial_workers"] == 2
    assert rep["resumed_step"] == 5          # a replay lands on an even step
    assert rep.get("snapshot_restores", 0) == 0
    assert rep["recovery_seconds"] > 0
    assert rep["dead_digest"] == rep["escrowed_digest"]
    assert rep["failed_fleet_parity_ticks"] == 5
    _close(_params(module), _clean_reference(tmp_path, stop_step=5), BAR)


def test_same_fixture_with_redundancy_off_replays(tmp_path):
    """The same fault with parity off routes to snapshot replay from the
    last committed snapshot (step 4's async write may not have committed
    before the kill: then step 2), exactly one restore."""
    snap = str(tmp_path / "elastic")
    module = AdamBoring(dataset_length=64, batch_size=2)
    trainer = _trainer(tmp_path, fault=KILL,
                       elastic={"snapshot_every_n_steps": 2,
                                "snapshot_dir": snap, "max_restarts": 2})
    trainer.fit(module)

    assert trainer.global_step == 8
    rep = trainer._elastic_report
    assert rep["recovery"] == "replay"
    assert rep["resumed_step"] in (2, 4)
    assert rep.get("snapshot_restores", 0) == 1
    _close(_params(module),
           _clean_reference(tmp_path, stop_step=rep["resumed_step"]), BAR)


def test_peerdrop_skips_parity_tick_without_failing(tmp_path):
    """Rank 0 swallows the next inbound peer frame after step 2: its
    step-3 exchange times out and is skipped (the previous escrow
    kept), the fleet never wedges, nothing restarts, later ticks go
    on."""
    trainer = _trainer(
        tmp_path, fault="peerdrop:rank=0,step=2,count=1",
        env={"RLT_ELASTIC_PARITY_TIMEOUT_S": "2"},
        elastic={"snapshot_every_n_steps": 4,
                 "snapshot_dir": str(tmp_path / "elastic"),
                 "max_restarts": 2, "redundancy": 1})
    trainer.fit(AdamBoring(dataset_length=64, batch_size=2))
    assert trainer.global_step == 8
    rep = trainer._elastic_report
    assert rep["restarts"] == 0
    assert rep.get("parity_skipped", 0) >= 1
    assert rep.get("parity_ticks", 0) >= 5
