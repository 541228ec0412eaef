"""The trial runner: ``tune.run`` in this process, no Ray needed.

Counterpart of ``ray_lightning_tpu/tune/runner.py`` without the
telemetry hooks (``Trial.metrics_url``, ``Trial.telemetry_dir``: ROADMAP.md
queue 1 item 13).  Every trial of an experiment shares one compile cache
under ``<exp_dir>/compile_cache`` (``RLT_COMPILE_CACHE=0`` opts out):
trial 0 builds the kernel libraries and every later trial, and every
retry, reads them; ``Trial.plan_report`` holds the plan a
``strategy="auto"`` trial trained under.  The reference's shape (SURVEY.md §3.3):
``tune.run(train_fn, config, num_samples, scheduler,
resources_per_trial)`` runs ``train_fn(config)`` per trial; it builds a
``Trainer`` (in process, or with a ``RayPlugin`` whose actors train) and
reports metrics and checkpoints through the session.  ``run`` returns an
``ExperimentAnalysis`` with ``best_config``, ``best_checkpoint`` and
each trial's ``last_result``.

Trials run on threads (``max_concurrent_trials`` at once).  A trial's
compute runs in this process on its leased card, or in actor
subprocesses, so the threads only coordinate.  The scheduler's STOP and
EXPLOIT decisions are exceptions raised inside ``report``: under a
``RayPlugin`` that is the driver's drain of the worker queue
(util.process_results), so they leave ``Trainer.fit`` unwrapped after
the plugin has killed its actors.
"""

from __future__ import annotations

import inspect
import logging
import os
import threading
import time
import traceback
from typing import Any, Callable, Optional

import torch

from ray_lightning_tpu_torch.tune.schedulers import (EXPLOIT, STOP,
                                                     FIFOScheduler,
                                                     PopulationBasedTraining,
                                                     TrialScheduler)
from ray_lightning_tpu_torch.tune.search import generate_variants
from ray_lightning_tpu_torch.tune.session import TrialSession, set_session

_log = logging.getLogger(__name__)


class _StopTrial(Exception):
    pass


class _ExploitTrial(Exception):
    def __init__(self, config: dict, checkpoint: str):
        super().__init__(checkpoint)
        self.config = config
        self.checkpoint = checkpoint


class Trial:
    def __init__(self, trial_id: str, config: dict, logdir: str):
        self.trial_id = trial_id
        self.config = config
        self.logdir = logdir
        self.status = "PENDING"
        self.last_result: dict = {}
        self.history: "list[dict]" = []
        self.latest_checkpoint: Optional[str] = None
        self.error: Optional[str] = None
        #: the cards an in-process trial leased (``"cuda:0"``, ...), set
        #: when its fit takes the lease (tune/session.py)
        self.leased_devices: "list[str]" = []
        #: the planner's report dict of a ``strategy="auto"`` fit in this
        #: trial (tune/session.py ``note_plan_report``)
        self.plan_report: Optional[dict] = None

    def __repr__(self):
        return f"Trial({self.trial_id}, {self.status})"


class ExperimentAnalysis:
    def __init__(self, trials: "list[Trial]", metric: Optional[str],
                 mode: str):
        self.trials = trials
        self.default_metric = metric
        self.default_mode = mode

    # -- the ray.tune.ExperimentAnalysis accessors -----------------------

    @property
    def results(self) -> "dict[str, dict]":
        return {t.trial_id: t.last_result for t in self.trials}

    def get_best_trial(self, metric: Optional[str] = None,
                       mode: Optional[str] = None) -> Optional[Trial]:
        metric = metric or self.default_metric
        mode = mode or self.default_mode
        sign = -1.0 if mode == "min" else 1.0
        best, best_v = None, None
        for t in self.trials:
            if t.status == "ERROR" or metric not in t.last_result:
                continue
            v = sign * float(t.last_result[metric])
            if best_v is None or v > best_v:
                best, best_v = t, v
        return best

    @property
    def best_trial(self) -> Optional[Trial]:
        return self.get_best_trial()

    @property
    def best_config(self) -> Optional[dict]:
        t = self.best_trial
        return t.config if t else None

    @property
    def best_checkpoint(self) -> Optional[str]:
        t = self.best_trial
        return t.latest_checkpoint if t else None

    @property
    def best_result(self) -> Optional[dict]:
        t = self.best_trial
        return t.last_result if t else None


def _accepts_checkpoint_dir(fn: Callable) -> bool:
    try:
        return "checkpoint_dir" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def _trial_device_demand(resources_per_trial: Any) -> Optional[int]:
    """The cards one trial wants: ``"GPU"`` summed over the bundles of
    ``get_tune_resources(...)`` (a ``TrialResources``), or a plain
    ``{"GPU": n}``.  ``None``: no GPU demand declared."""
    if resources_per_trial is None:
        return None
    bundles = getattr(resources_per_trial, "bundles", None)
    if bundles is not None:
        demand = sum(int(b.get("GPU", 0)) for b in bundles)
    elif isinstance(resources_per_trial, dict):
        demand = int(resources_per_trial.get("GPU", 0))
    else:
        return None
    return demand or None


def _visible_devices() -> "list[torch.device]":
    """The cards this process sees: ``cuda:0 ... cuda:{count - 1}``."""
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class _DeviceLeaser:
    """Partitions the visible cards into disjoint chunks, one a trial.

    The reference gets trial isolation from Ray's placement groups
    (``tune.py:50-56``); the runner gives in-process trials the same: a
    trial leases its chunk when its fit first asks for a device and
    holds it to the trial's end (PBT restarts included); a trial wanting
    more cards than are free waits, so trials that each want every card
    run one after another.  The cards are counted at the first lease,
    on a trial's thread.  Trials whose fits run in actor workers never
    lease: their cards are the workers' business, and the tune driver
    stays off CUDA.
    """

    def __init__(self, per_trial: int):
        self._per_trial = per_trial
        self._chunks: Optional[list] = None
        self._cond = threading.Condition()

    def _ensure_chunks(self) -> None:
        if self._chunks is not None:
            return
        devices = _visible_devices()
        if self._per_trial > len(devices):
            raise ValueError(
                f"resources_per_trial wants {self._per_trial} GPUs but "
                f"only {len(devices)} are visible to this process; an "
                f"in-process trial does not train on the CPU")
        stranded = len(devices) % self._per_trial
        if stranded:
            _log.warning(
                "resources_per_trial=%d does not divide the %d visible "
                "GPUs: %d GPU(s) (%s) will sit idle under the trial lease "
                "partition.", self._per_trial, len(devices), stranded,
                ", ".join(str(d) for d in devices[-stranded:]))
        self._chunks = [
            devices[i:i + self._per_trial]
            for i in range(0, len(devices) - self._per_trial + 1,
                           self._per_trial)]

    def acquire(self) -> list:
        with self._cond:
            self._ensure_chunks()
            while not self._chunks:
                self._cond.wait()
            return self._chunks.pop()

    def release(self, chunk: list) -> None:
        with self._cond:
            self._chunks.append(chunk)
            self._cond.notify()


def run(
    trainable: Callable,
    config: Optional[dict] = None,
    *,
    num_samples: int = 1,
    scheduler: Optional[TrialScheduler] = None,
    metric: Optional[str] = None,
    mode: Optional[str] = None,
    stop: Optional[dict] = None,
    resources_per_trial: Any = None,
    local_dir: Optional[str] = None,
    name: Optional[str] = None,
    max_concurrent_trials: Optional[int] = None,
    max_failures: int = 0,
    fail_fast: bool = False,
    raise_on_failed_trial: bool = True,
    seed: int = 0,
    verbose: int = 1,
) -> ExperimentAnalysis:
    """Run ``num_samples`` trials of ``trainable`` over ``config``.

    ``trainable(config)``, or ``trainable(config, checkpoint_dir=None)``
    to restart from a checkpoint: a PBT exploit's donor, or the trial's
    latest checkpoint when it is retried.  Trials and their logs live
    under ``<local_dir>/<name>/trial_NNNNN`` (``local_dir`` defaults to
    ``<cwd>/rlt_tune``); pass ``default_root_dir=tune.get_trial_dir()``
    to a trial's ``Trainer`` so trials never share a ``metrics.csv``.

    ``stop``: ``{"training_iteration": n}`` ends a trial at its n-th
    report (the count runs on across PBT restarts and retries); another
    key ends it when the reported value reaches the bound.  A report
    that meets ``stop`` ends the trial whatever the scheduler decides
    (``ray.tune``'s order; the JAX runner lets a PBT exploit go first).
    ``max_failures`` retries a crashed trial up to that many times
    (``ray.tune``'s; the reference's recovery is "Tune trial retries and
    checkpoints", SURVEY.md §5); ``SystemExit`` and
    ``KeyboardInterrupt`` are not retried.  ``fail_fast`` stops the sweep
    at the first failed trial; a failed trial raises at the end unless
    ``raise_on_failed_trial=False``.  ``max_concurrent_trials`` defaults
    to 1, or to every trial under PBT (its population must coexist).

    Cards: when ``resources_per_trial`` declares GPUs
    (``get_tune_resources(..., use_gpu=True)`` or ``{"GPU": n}``), the
    visible cards are split into disjoint leases of n; a trial whose
    ``Trainer`` runs in process and was given no device takes a lease
    when its fit starts and trains on its first card.  At most
    ``device_count // n`` such trials then run at once, and a trial
    asking for more cards than are visible (none, on a machine without
    CUDA) fails with that error instead of training on the CPU.  Trials
    under a ``RayPlugin`` never lease.
    """
    scheduler = scheduler or FIFOScheduler(metric or "loss", mode or "min")
    # metric and mode default to the scheduler's, so the analysis ranks
    # in the direction the sweep was scheduled
    if metric is None:
        metric = scheduler.metric
    if mode is None:
        mode = scheduler.mode
    local_dir = local_dir or os.path.join(os.getcwd(), "rlt_tune")
    exp_dir = os.path.join(local_dir, name or f"exp_{int(time.time())}")
    os.makedirs(exp_dir, exist_ok=True)
    # one kernel cache for the experiment (module docstring); an
    # explicit RLT_COMPILE_CACHE_DIR outranks it at resolution
    compile_cache_dir = (
        None if os.environ.get("RLT_COMPILE_CACHE", "").strip() == "0"
        else os.path.join(exp_dir, "compile_cache"))

    variants = generate_variants(dict(config or {}), num_samples, seed)
    trials = []
    for i, cfg in enumerate(variants):
        tid = f"trial_{i:05d}"
        logdir = os.path.join(exp_dir, tid)
        os.makedirs(logdir, exist_ok=True)
        trials.append(Trial(tid, cfg, logdir))

    stop = dict(stop or {})
    takes_ckpt = _accepts_checkpoint_dir(trainable)
    errors: "list[BaseException]" = []
    errors_lock = threading.Lock()
    abort = threading.Event()      # fail_fast: the first error stops all

    if max_concurrent_trials is None:
        max_concurrent_trials = (
            len(trials) if isinstance(scheduler, PopulationBasedTraining)
            else 1)
    demand = _trial_device_demand(resources_per_trial)
    leaser = _DeviceLeaser(demand) if demand is not None else None
    sem = threading.Semaphore(max(1, max_concurrent_trials))

    def stop_reached(metrics: dict) -> bool:
        it = int(metrics.get("training_iteration", 0))
        stop_it = stop.get("training_iteration")
        if stop_it and it >= stop_it:
            return True
        return any(key in metrics and key != "training_iteration"
                   and float(metrics[key]) >= float(bound)
                   for key, bound in stop.items())

    def on_report(trial: Trial, metrics: dict) -> None:
        trial.last_result = dict(metrics)
        trial.history.append(dict(metrics))
        if abort.is_set():
            raise _StopTrial()
        decision = scheduler.on_result(trial, metrics)
        # ``stop`` comes before the scheduler's decision, as in
        # ray.tune: an exploit first would restart a trial that stays at
        # the bottom (its donors done) for ever
        if stop_reached(metrics) or decision.action == STOP:
            raise _StopTrial()
        if decision.action == EXPLOIT:
            trial.config = dict(decision.config)
            raise _ExploitTrial(decision.config, decision.checkpoint)

    def run_trial(trial: Trial) -> None:
        with sem:
            if abort.is_set():
                return     # fail_fast tripped: the trial stays PENDING
            trial.status = "RUNNING"
            session = TrialSession(trial, on_report, device_leaser=leaser,
                                   compile_cache_dir=compile_cache_dir)
            set_session(session)
            restore_from: Optional[str] = None
            failures = 0
            try:
                while True:
                    try:
                        if takes_ckpt:
                            trainable(dict(trial.config),
                                      checkpoint_dir=restore_from)
                        else:
                            trainable(dict(trial.config))
                        trial.status = "TERMINATED"
                        return
                    except _StopTrial:
                        trial.status = "TERMINATED"
                        return
                    except _ExploitTrial as e:
                        if not takes_ckpt:
                            _log.warning(
                                "PBT exploit requested but %s has no "
                                "checkpoint_dir parameter; continuing "
                                "without restore.", trainable)
                        restore_from = e.checkpoint
                        # a retry after the exploit resumes the donor's
                        # weights, not this trial's older checkpoint
                        trial.latest_checkpoint = e.checkpoint
                        _log.info("%s exploiting: restart from %s",
                                  trial.trial_id, e.checkpoint)
                        continue
                    except Exception:
                        # a retry (Exception only: SystemExit and
                        # KeyboardInterrupt are deliberate exits), from
                        # the latest checkpoint when the trainable takes
                        # one
                        failures += 1
                        if failures > max_failures or abort.is_set():
                            raise
                        restore_from = (trial.latest_checkpoint
                                        if takes_ckpt else None)
                        _log.warning(
                            "%s failed (attempt %d/%d); retrying%s:\n%s",
                            trial.trial_id, failures, max_failures + 1,
                            f" from {restore_from}" if restore_from
                            else "", traceback.format_exc())
                        continue
            except BaseException as e:          # noqa: BLE001
                trial.status = "ERROR"
                trial.error = traceback.format_exc()
                with errors_lock:
                    errors.append(e)
                if fail_fast:
                    abort.set()
                if verbose:
                    _log.error("%s failed:\n%s", trial.trial_id, trial.error)
            finally:
                scheduler.on_trial_complete(trial)
                set_session(None)
                session.release_devices()

    threads = [threading.Thread(target=run_trial, args=(t,), daemon=True,
                                name=f"rlt-{t.trial_id}")
               for t in trials]
    for th in threads:
        th.start()
    for th in threads:
        th.join()

    if errors and (fail_fast or raise_on_failed_trial):
        # as ray.tune: a failed trial raises by default, so a partial
        # sweep is never read as a complete one
        failed = [t.trial_id for t in trials if t.status == "ERROR"]
        raise RuntimeError(
            f"{len(failed)} trial(s) failed: {failed}. First error "
            f"below; pass raise_on_failed_trial=False to get a partial "
            f"ExperimentAnalysis instead.") from errors[0]
    return ExperimentAnalysis(trials, metric, mode)


__all__ = ["ExperimentAnalysis", "Trial", "run"]
