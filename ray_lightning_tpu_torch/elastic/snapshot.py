"""Async snapshots off the critical path.

Counterpart of ``ray_lightning_tpu/elastic/snapshot.py`` on the port's
``ShardedCheckpointer(async_save=True)`` (utils/checkpoint.py) in place
of orbax.  The trainer calls :meth:`Snapshotter.maybe_snapshot` after
every optimizer step (``Trainer._engine_one`` / ``_engine_chunk``); on
the configured cadence it runs ``Trainer.save_sharded_checkpoint``,
whose blocking part is the copy to host memory: the write runs on the
checkpointer's thread behind the next steps, under ``<step>.partial``,
renamed to ``<step>`` only when every rank's files are down.

Backpressure is bounded by construction, at most one save in flight,
never a queue:

- a one-process run skips a cadence hit while the previous save is
  still writing (``stats["skipped"]``);
- a multi-process run must take the same save-or-skip decision on every
  rank (a save is collective: a rank that skips while another saves
  deadlocks the fleet), and whether the previous save still writes is a
  local, timing-dependent question.  So it waits for the previous save
  instead, still at most one in flight, and the wait is measured
  (``stats["stall_seconds"]``).

Failure hardening: a save that raises is caught, counted
(``stats["failed"]``) and retried at the next cadence hit; only
``ElasticConfig.max_snapshot_failures`` failures in a row raise (a
flaky target costs durability headroom, not the run; a broken one must
not fail silently).  The ``snapkill`` chaos fault (elastic/faults.py)
fires here, after the save is dispatched and before it commits.

``stats`` holds ``snapshots``, ``skipped``, ``failed``,
``save_seconds`` (the blocking host seconds of the saves),
``stall_seconds`` and ``save_seconds_each`` (one a save); the metrics
plane's counters (``rlt_snapshot_*``) are no-ops while it is not ported
(telemetry/metrics.py).
"""

from __future__ import annotations

import logging
import time

from ray_lightning_tpu_torch.parallel import strategy as _parallel
from ray_lightning_tpu_torch.telemetry import metrics as _metrics

_log = logging.getLogger(__name__)


class Snapshotter:
    """Cadence-driven async sharded snapshots for one fit stage."""

    def __init__(self, trainer, cfg):
        self.trainer = trainer
        self.cfg = cfg
        self.directory = cfg.resolve_dir(trainer.default_root_dir)
        self.stats = {
            "snapshots": 0,
            "skipped": 0,
            "failed": 0,
            "save_seconds": 0.0,
            "stall_seconds": 0.0,
            "save_seconds_each": [],
        }
        self._consecutive_failures = 0
        self._multiprocess = _parallel.world_size() > 1

    def _count(self, name: str, value: float = 1.0) -> None:
        reg = _metrics.get_registry()
        if reg is not None:
            reg.counter(name).inc(value)

    def maybe_snapshot(self) -> bool:
        """One cadence check; True when a snapshot was taken.  Collective
        in a multi-process run (every rank decides from ``global_step``
        alone)."""
        t = self.trainer
        n = self.cfg.snapshot_every_n_steps
        if n <= 0 or t.global_step <= 0 or t.global_step % n:
            return False
        ckpt = t._sharded_checkpointer(self.directory,
                                       max_to_keep=self.cfg.max_to_keep)
        if ckpt.saving_in_progress():
            if not self._multiprocess:
                self.stats["skipped"] += 1
                self._count("rlt_snapshot_skipped_total")
                _log.debug("elastic snapshot at step %d skipped: the "
                           "previous save still writes", t.global_step)
                return False
            t0 = time.monotonic()
            ckpt.wait()
            stall = time.monotonic() - t0
            self.stats["stall_seconds"] += stall
            self._count("rlt_snapshot_stall_seconds_total", stall)
            _log.info("elastic snapshot at step %d stalled %.3f s behind "
                      "the previous save", t.global_step, stall)
        t0 = time.monotonic()
        try:
            t.save_sharded_checkpoint(self.directory,
                                      max_to_keep=self.cfg.max_to_keep)
        except Exception:   # noqa: BLE001 - counted and retried
            self._consecutive_failures += 1
            self.stats["failed"] += 1
            self._count("rlt_snapshot_failed_total")
            limit = self.cfg.max_snapshot_failures
            if self._consecutive_failures >= limit:
                _log.error(
                    "elastic snapshot at step %d failed %d times in a row "
                    "(limit %d); raising: the snapshot target is broken, "
                    "not flaky", t.global_step, self._consecutive_failures,
                    limit)
                raise
            _log.warning(
                "elastic snapshot at step %d failed (%d in a row, limit "
                "%d); training goes on and the next cadence hit retries",
                t.global_step, self._consecutive_failures, limit,
                exc_info=True)
            return False
        dt = time.monotonic() - t0
        self._consecutive_failures = 0
        self.stats["snapshots"] += 1
        self.stats["save_seconds"] += dt
        self.stats["save_seconds_each"].append(dt)
        self._count("rlt_snapshot_total")
        self._count("rlt_snapshot_seconds_total", dt)
        # chaos hook: an armed snapkill fires here, while the async
        # write is in flight, so the step never commits
        from ray_lightning_tpu_torch.elastic.faults import (
            _elastic_restarts, maybe_snapkill)
        maybe_snapkill(t.global_rank, t.global_step, _elastic_restarts(t))
        return True


__all__ = ["Snapshotter"]
