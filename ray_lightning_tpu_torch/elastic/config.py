"""Elastic-plane configuration.

Counterpart of ``ray_lightning_tpu/elastic/config.py``, kept as the
port's own copy (the port imports nothing of the JAX package).
``ElasticConfig`` turns on the fault-tolerance subsystem (elastic/):
async snapshots off the critical path, reshardable restore of those
snapshots onto another world size, parity redundancy of the ZeRO-1
optimizer state, and the shrink-to-continue driver that answers a dead
rank by rebuilding the fleet with the survivors instead of failing the
run.

Construction (first match wins, as ``CommPolicy.resolve``):

- ``Trainer(elastic=ElasticConfig(...))``: full control;
- ``Trainer(elastic=True)``: the defaults (snapshots still need
  ``snapshot_every_n_steps`` or ``RLT_ELASTIC_EVERY``);
- ``Trainer(elastic={...})``: keyword arguments, enabled unless the
  dict says otherwise;
- ``RLT_ELASTIC=1`` (with ``RLT_ELASTIC_EVERY``, ``RLT_ELASTIC_DIR``,
  ``RLT_ELASTIC_MAX_RESTARTS``, ``RLT_ELASTIC_MIN_WORKERS``,
  ``RLT_ELASTIC_KEEP``, ``RLT_ELASTIC_PRESERVE_BATCH``,
  ``RLT_ELASTIC_REDUNDANCY``, ``RLT_ELASTIC_REDUNDANCY_EVERY``,
  ``RLT_ELASTIC_SNAPSHOT_FAILURES``): the environment, read when the
  Trainer's argument is ``None``.

The resolved config is a frozen dataclass that rides the pickled
trainer to the workers; the knobs also go to them through
:meth:`ElasticConfig.worker_env` (plugins/ray_ddp.py), as ``RLT_COMM*``
do, so a worker that reads ``RLT_ELASTIC*`` agrees with the driver.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional


def _env_flag(name: str, default: bool) -> bool:
    raw = os.environ.get(name, "").strip()
    if raw in ("0", "false", "False"):
        return False
    if raw in ("1", "true", "True"):
        return True
    return default


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """How the run survives worker loss.

    enabled: master switch — snapshotting, fault injection plumbing and
        the shrink-to-continue driver all key off it.
    snapshot_every_n_steps: async sharded-snapshot cadence (0 = no
        periodic snapshots; the shrink driver then falls back to the
        original ``resume_from_checkpoint`` or a from-scratch restart).
    snapshot_dir: where snapshots land; ``None`` =
        ``<default_root_dir>/elastic``.  Must be visible to every worker
        process (a shared file system or an fsspec URL: every rank
        writes its own blocks of a save, utils/checkpoint.py).
    max_restarts: how many shrink-and-continue attempts before the
        original failure propagates.
    min_workers: never shrink the fleet below this.
    preserve_global_batch: rescale each surviving worker's loader batch
        by ``initial_workers / current_workers`` so the global batch
        (and therefore the optimization trajectory) is preserved across
        a shrink, as the sharded restore redistributes the state
        (core/trainer.py ``_restore_sharded``).
    max_to_keep: snapshot retention (``ShardedCheckpointer``'s
        ``max_to_keep``).
    redundancy: parity-redundant optimizer state (elastic/redundancy.py):
        each rank XORs the ZeRO-1 optimizer-state partitions of this
        many neighbor ranks into a parity block, enabling zero-replay
        reconstruct-and-continue on a single-rank loss.  0 (default)
        disables parity; snapshot replay is then the only recovery.
    redundancy_every_n_steps: parity refresh cadence piggybacked on the
        step — recovery resumes from the last completed tick, so 1
        (default) makes single-loss recovery exact at the current step
        while larger values amortize the ``k x shard_bytes`` wire cost.
    max_snapshot_failures: how many CONSECUTIVE async-snapshot save
        failures to absorb (counted, retried next cadence tick) before
        raising: a flaky snapshot target must not kill training, a
        permanently broken one must not fail silently.
    """

    enabled: bool = False
    snapshot_every_n_steps: int = 0
    snapshot_dir: Optional[str] = None
    max_restarts: int = 2
    min_workers: int = 1
    preserve_global_batch: bool = True
    max_to_keep: Optional[int] = 2
    redundancy: int = 0
    redundancy_every_n_steps: int = 1
    max_snapshot_failures: int = 3

    def __post_init__(self):
        if self.snapshot_every_n_steps < 0:
            raise ValueError("elastic snapshot_every_n_steps must be >= 0")
        if self.max_restarts < 0:
            raise ValueError("elastic max_restarts must be >= 0")
        if self.min_workers < 1:
            raise ValueError("elastic min_workers must be >= 1")
        if self.max_to_keep is not None and self.max_to_keep < 1:
            raise ValueError("elastic max_to_keep must be >= 1 or None")
        if self.redundancy < 0:
            raise ValueError("elastic redundancy must be >= 0")
        if self.redundancy_every_n_steps < 1:
            raise ValueError(
                "elastic redundancy_every_n_steps must be >= 1")
        if self.max_snapshot_failures < 1:
            raise ValueError("elastic max_snapshot_failures must be >= 1")

    # -- construction ----------------------------------------------------

    @classmethod
    def resolve(cls, value: Any) -> "ElasticConfig":
        if isinstance(value, cls):
            return value
        if isinstance(value, bool):
            return cls(enabled=value)
        if isinstance(value, dict):
            cfg = dict(value)
            cfg.setdefault("enabled", True)
            return cls(**cfg)
        if value is not None:
            raise TypeError(f"bad elastic config: {value!r}")
        keep_raw = os.environ.get("RLT_ELASTIC_KEEP", "").strip()
        return cls(
            enabled=_env_flag("RLT_ELASTIC", False),
            snapshot_every_n_steps=int(
                os.environ.get("RLT_ELASTIC_EVERY", "0") or 0),
            snapshot_dir=os.environ.get("RLT_ELASTIC_DIR") or None,
            max_restarts=int(
                os.environ.get("RLT_ELASTIC_MAX_RESTARTS", "2") or 2),
            min_workers=int(
                os.environ.get("RLT_ELASTIC_MIN_WORKERS", "1") or 1),
            preserve_global_batch=_env_flag(
                "RLT_ELASTIC_PRESERVE_BATCH", True),
            max_to_keep=int(keep_raw) if keep_raw else 2,
            redundancy=int(
                os.environ.get("RLT_ELASTIC_REDUNDANCY", "0") or 0),
            redundancy_every_n_steps=int(
                os.environ.get("RLT_ELASTIC_REDUNDANCY_EVERY", "1") or 1),
            max_snapshot_failures=int(
                os.environ.get("RLT_ELASTIC_SNAPSHOT_FAILURES", "3") or 3),
        )

    # -- env round-trip --------------------------------------------------

    def worker_env(self) -> dict:
        """The environment that reproduces this config through
        :meth:`resolve` in a worker process (the pickled trainer carries
        the config; the environment keeps a nested fit there
        consistent)."""
        if not self.enabled:
            return {}
        env = {
            "RLT_ELASTIC": "1",
            "RLT_ELASTIC_EVERY": str(self.snapshot_every_n_steps),
            "RLT_ELASTIC_MAX_RESTARTS": str(self.max_restarts),
            "RLT_ELASTIC_MIN_WORKERS": str(self.min_workers),
            "RLT_ELASTIC_PRESERVE_BATCH":
                "1" if self.preserve_global_batch else "0",
            "RLT_ELASTIC_REDUNDANCY": str(self.redundancy),
            "RLT_ELASTIC_REDUNDANCY_EVERY":
                str(self.redundancy_every_n_steps),
            "RLT_ELASTIC_SNAPSHOT_FAILURES":
                str(self.max_snapshot_failures),
        }
        if self.snapshot_dir:
            env["RLT_ELASTIC_DIR"] = self.snapshot_dir
        if self.max_to_keep is not None:
            env["RLT_ELASTIC_KEEP"] = str(self.max_to_keep)
        return env

    # -- paths -----------------------------------------------------------

    def resolve_dir(self, default_root_dir: str) -> str:
        if self.snapshot_dir:
            return self.snapshot_dir
        return os.path.join(default_root_dir, "elastic")
