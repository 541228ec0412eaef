"""Two-tier recovery: the driver's answer to a lost worker.

Counterpart of ``ray_lightning_tpu/elastic/driver.py``.  When a fit
attempt fails because a rank died (its process gone, its connection
lost, or, until the heartbeat watchdog is ported (ROADMAP.md queue 1
item 13), the plugin's ``timeout_s`` past a wedged rank), and not
because of a deterministic user exception, which still propagates, the
driver routes between two tiers:

**Tier 1, reconstruct and continue (zero replay).**  With parity on
(``ElasticConfig(redundancy=k)``) and exactly one dead rank, the
survivors' escrows, harvested by the plugin from each worker's frame
reader before teardown, hold what the dead rank took with it: its
ZeRO-1 optimizer shard is its holder's parity block XOR the other
covered members' blobs (elastic/redundancy.py ``build_recovery``), the
fleet shrinks to N-1, and the next attempt restores the assembled state
in memory at the escrowed step; the snapshot directory is not read.

**Tier 2, snapshot replay.**  A multi-rank loss, parity off, or any gap
in the escrows falls back to the latest committed elastic snapshot (a
save the dead fleet never finished, the ``snapkill`` case, is not
listed), restored onto the new world (core/trainer.py
``_restore_sharded``); with no snapshot, the original ``ckpt_path`` or
a restart from scratch.

Either way the attempt runs again with a fresh fleet: new actors, a new
process group on the new world size over a fresh ``MASTER_PORT``, each
worker's batch rescaled so the global batch stays
(``Trainer._elastic_rescale_loader``), training on to ``max_steps``.
The route lands in ``trainer._elastic_report["recovery"]``
(``parity``, ``replay`` or ``scratch``) beside the restart history and
the seconds it took.  The flight dumps and the ``rlt_recovery_*``
series of the JAX driver wait for the telemetry plane (item 13):
:func:`_dump_flights` is a no-op here, as it is in JAX with no
aggregator.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

from ray_lightning_tpu_torch.telemetry.aggregator import WorkerHeartbeatTimeout

_log = logging.getLogger(__name__)

#: substrings of a failure message that mean "the process is gone" even
#: when the liveness probe could not say so, and the plugin's timeout
#: past a wedged rank (``util.process_results``), the stand-in for the
#: heartbeat watchdog until the telemetry plane is ported
_DEATH_MARKERS = ("connection lost", "died", "never connected",
                  "heartbeat", "still running after")


def _restartable(err: BaseException, dead_ranks: list) -> bool:
    """A failure the elastic driver may absorb: a dead process, a lost
    connection, or a heartbeat hard-timeout.  Deterministic user
    exceptions re-raise — shrinking would just re-run the bug."""
    if dead_ranks:
        return True
    if isinstance(err, WorkerHeartbeatTimeout):
        return True
    msg = str(err).lower()
    return any(m in msg for m in _DEATH_MARKERS)


def _dump_flights(plugin, err: BaseException, dead_ranks: list,
                  recovery: Optional[str] = None) -> None:
    """The black-box dumps at death classification: a no-op while the
    telemetry plane (its aggregator and flight recorder) is not ported,
    as the JAX driver's is without an aggregator."""
    del plugin, err, dead_ranks, recovery


def latest_snapshot_step(directory: str) -> Optional[int]:
    """Latest COMMITTED snapshot step under ``directory`` (None when
    the directory is empty or absent)."""
    from ray_lightning_tpu_torch.utils.checkpoint import ShardedCheckpointer
    if not ShardedCheckpointer.is_sharded_checkpoint(directory):
        return None
    ckpt = ShardedCheckpointer(directory)
    try:
        return ckpt.latest_step()
    finally:
        ckpt.close()


def _route_recovery(plugin, trainer, cfg, dead: list,
                    snap_dir: str, orig_ckpt: Optional[str]) -> dict:
    """Choose the recovery tier for one classified failure.

    Returns ``{"mode", "package", "resume", "step", "why"}`` — mode is
    ``parity`` (in-memory package attached), ``replay`` (a snapshot or
    the original ckpt_path to restore), or ``scratch``.
    """
    from ray_lightning_tpu_torch.elastic import redundancy

    if cfg.redundancy > 0 and len(dead) == 1:
        escrows = dict(getattr(plugin, "_last_escrows", None) or {})
        package, why = redundancy.build_recovery(
            escrows, dead[0], plugin.num_workers, cfg.redundancy)
        if package is not None:
            return {"mode": "parity", "package": package, "resume": None,
                    "step": package["step"], "why": None}
        _log.warning("elastic: parity recovery unavailable (%s); "
                     "falling back to snapshot replay", why)
    elif cfg.redundancy > 0:
        _log.warning("elastic: parity covers single-rank loss only "
                     "(dead ranks %s); falling back to snapshot replay",
                     dead or "unknown")
    step = latest_snapshot_step(snap_dir)
    if step is not None:
        return {"mode": "replay", "package": None,
                "resume": os.path.join(snap_dir, str(step)),
                "step": step, "why": None}
    if orig_ckpt:
        return {"mode": "replay", "package": None, "resume": orig_ckpt,
                "step": None, "why": None}
    return {"mode": "scratch", "package": None, "resume": None,
            "step": None, "why": None}


def run_elastic_fit(plugin, trainer, module, datamodule,
                    ckpt_path: Optional[str]):
    """Drive ``plugin._run_attempt`` with two-tier recovery retries.

    Returns the successful attempt's result; sets
    ``trainer._elastic_report``: the restart history, the route taken,
    the resumed step, the seconds to recover, and the workers' elastic
    stats (rank 0's ``Trainer.elastic_stats``; the failed fleet's parity
    counters under ``failed_fleet_*``).
    """
    cfg = trainer.elastic
    snap_dir = cfg.resolve_dir(trainer.default_root_dir)
    initial = plugin.num_workers
    orig_ckpt = ckpt_path
    trainer._elastic_recovery = None   # never inherit a stale package
    restarts = 0
    decision_s = None
    report = {"initial_workers": initial, "workers": initial,
              "restarts": 0, "resumed_step": None}
    while True:
        # rides the pickled trainer to the workers: the loader rescale
        # and the worker-side stats both read it
        trainer._elastic_state = dict(report)
        try:
            result = plugin._run_attempt(trainer, module, datamodule,
                                         "fit", ckpt_path)
        except BaseException as err:   # noqa: BLE001 - classified below
            failed_wall = time.time()
            dead = list(getattr(plugin, "_last_dead_ranks", ()) or ())
            if not _restartable(err, dead):
                _dump_flights(plugin, err, dead)
                raise
            restarts += 1
            shrink = max(1, len(dead))
            if dead and len(dead) >= plugin.num_workers:
                # full-fleet loss: a rank's death can take its peers
                # down with it (a collective that raises on a lost
                # peer).  Count one preemption and go on (the restart
                # budget bounds repeats); parity cannot help (no
                # survivor escrowed), so the route falls to replay.
                _log.warning(
                    "elastic: full-fleet loss (%d/%d ranks dead); "
                    "counting one preemption and shrinking by 1",
                    len(dead), plugin.num_workers)
                shrink = 1
            new_workers = plugin.num_workers - shrink
            if restarts > cfg.max_restarts:
                _dump_flights(plugin, err, dead)
                _log.error(
                    "elastic: restart budget exhausted (%d); raising",
                    cfg.max_restarts)
                raise
            if new_workers < cfg.min_workers:
                _dump_flights(plugin, err, dead)
                _log.error(
                    "elastic: shrinking %d -> %d would go below "
                    "min_workers=%d; raising", plugin.num_workers,
                    new_workers, cfg.min_workers)
                raise
            t0 = time.monotonic()
            route = _route_recovery(plugin, trainer, cfg, dead,
                                    snap_dir, orig_ckpt)
            decision_s = time.monotonic() - t0
            _dump_flights(plugin, err, dead, recovery=route["mode"])
            trainer._elastic_recovery = route["package"]
            # replayed steps: the resume point's distance behind the
            # last step the dead fleet escrowed (parity resumes there)
            escrowed = [e.get("step") for e in (getattr(
                plugin, "_last_escrows", None) or {}).values()]
            crash_step = max(escrowed) if escrowed else None
            plugin._last_escrows = None     # the package holds what counts
            replayed = None
            if crash_step is not None:
                replayed = max(0, int(crash_step)
                               - int(route["step"] or 0))
            resume = route["resume"]
            if route["mode"] == "scratch":
                _log.warning(
                    "elastic: no durable snapshot under %s and no "
                    "parity escrow; restarting from scratch (step 0)",
                    snap_dir)
            _log.warning(
                "elastic: worker failure (%s: %s); dead ranks %s — "
                "shrinking %d -> %d workers (restart %d/%d), recovery "
                "via %s from step %s",
                type(err).__name__, str(err).splitlines()[0][:200],
                dead or "unknown", plugin.num_workers, new_workers,
                restarts, cfg.max_restarts, route["mode"],
                route["step"] if route["step"] is not None else "0")
            plugin.num_workers = new_workers
            ckpt_path = resume
            report = {"initial_workers": initial,
                      "workers": new_workers, "restarts": restarts,
                      "resumed_step": route["step"],
                      "resumed_from": resume,
                      "recovery": route["mode"],
                      "recovery_decision_seconds": decision_s,
                      "probe_and_harvest_seconds": getattr(
                          plugin, "_last_harvest_s", None),
                      "replayed_steps": replayed}
            if route["package"] is not None:
                # the dead fleet's parity counters rode the escrow (its
                # workers returned no result package)
                pkg = route["package"]
                report.update({f"failed_fleet_{k}": v for k, v in
                               pkg.get("escrow_stats", {}).items()})
                report["reconstruct_seconds"] = pkg.get(
                    "reconstruct_seconds")
                # the leaves pieced together from several ranks (the
                # rank-unique ones, the dead rank's among them)
                report["rebuilt_leaves"] = {
                    k: e["dtype"] for k, e in pkg["leaves"].items()
                    if len(e["pieces"]) > 1}
                report["dead_digest"] = pkg.get("dead_digest")
                report["escrowed_digest"] = pkg.get("escrowed_digest")
            continue
        # the recovery package is one-shot: a completed attempt consumed
        # it (or never needed it) — a later fit must not resurrect it
        trainer._elastic_recovery = None
        report.update(getattr(trainer, "_elastic_worker_stats", None)
                      or {})
        if restarts:
            # time to recover: from the driver catching the failed
            # attempt to the resumed attempt's first step (harvest,
            # teardown, the route, the new fleet's start, its restore)
            first = getattr(trainer, "first_step_wall", None)
            if first is not None:
                report["recovery_seconds"] = first - failed_wall
        trainer._elastic_report = report
        if restarts:
            _log.info("elastic: fit completed after %d restart(s) on "
                      "%d/%d workers (recovery=%s, resumed step %s)",
                      restarts, report["workers"], initial,
                      report.get("recovery"),
                      report.get("resumed_step"))
        return result
