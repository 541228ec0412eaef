"""Per-trial session: the thread-local context that makes ``report``
and ``checkpoint_dir`` work inside a running trial.

Counterpart of ``ray_lightning_tpu/tune/session.py``, with the
compile-cache and planner hooks (``compile_cache_dir``,
``get_compile_cache_dir``, ``note_plan_report``).  As in the reference, ``tune.report`` and
``tune.checkpoint_dir`` work only where the trial runs
(``ray_lightning/tune.py:130-134, 161-178``): the runner runs each trial
on its own thread, and the distributed plugins relay a worker's calls
to that thread through the worker-to-driver queue.  Outside the
runner's trials they deliver into a live Ray Tune session
(tune/ray_bridge.py) when there is one.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
from typing import Optional

_local = threading.local()


class TrialSession:
    """The live context of one running trial.

    ``devices`` is the trial's lease of cards (tune/runner.py
    ``_DeviceLeaser``), taken the first time an in-process fit asks for
    its device.  Trials that train in actor workers never take one, so
    the tune driver stays off CUDA for them.  ``None``: no lease (yet).
    """

    def __init__(self, trial, on_report, device_leaser=None,
                 compile_cache_dir=None):
        self.trial = trial
        #: the experiment's shared compile-cache root (tune/runner.py),
        #: which ``CompileCacheConfig.resolve`` takes inside the trial
        self.compile_cache_dir = compile_cache_dir
        self._on_report = on_report
        self._step = 0
        self._leaser = device_leaser
        self.devices = None

    def acquire_devices(self):
        if self._leaser is not None and self.devices is None:
            self.devices = self._leaser.acquire()
            # which cards ran this trial, for ExperimentAnalysis (what
            # the reference reads off its placement groups)
            self.trial.leased_devices = [str(d) for d in self.devices]
        return self.devices

    def release_devices(self) -> None:
        if self._leaser is not None and self.devices is not None:
            self._leaser.release(self.devices)
            self.devices = None

    def report(self, **metrics) -> None:
        self._step += 1
        metrics = dict(metrics)
        metrics.setdefault("training_iteration", self._step)
        self._on_report(self.trial, metrics)

    @contextlib.contextmanager
    def checkpoint_dir(self, step: int):
        """This trial's checkpoint directory for ``step``
        (``tune.checkpoint_dir``, which the reference writes into,
        ``tune.py:161-167``); it becomes the trial's latest checkpoint
        when the block ends."""
        path = os.path.join(self.trial.logdir, f"checkpoint_{step:06d}")
        os.makedirs(path, exist_ok=True)
        yield path
        self.trial.latest_checkpoint = path


def _get() -> Optional[TrialSession]:
    return getattr(_local, "session", None)


def set_session(session: Optional[TrialSession]) -> None:
    _local.session = session


def in_session() -> bool:
    return _get() is not None


def report(_metrics: Optional[dict] = None, **metrics) -> None:
    """Report metrics for the current trial (``tune.report``): to the
    built-in runner's session when one is live on this thread, else to a
    live Ray Tune / Train session (tune/ray_bridge.py), else raise."""
    merged = dict(_metrics or {})
    merged.update(metrics)
    s = _get()
    if s is not None:
        s.report(**merged)
        return
    from ray_lightning_tpu_torch.tune import ray_bridge
    if ray_bridge.report(merged):
        return
    raise RuntimeError(
        "tune.report() called outside a tune trial; run this function "
        "through ray_lightning_tpu_torch.tune.run() or a Ray Tune trial.")


def deliver_checkpoint(blob: bytes, step: int, filename: str) -> None:
    """Write checkpoint bytes where the live trial keeps checkpoints:
    the built-in runner's trial directory (atomically: a temporary file
    that replaces ``filename``, so a trial exploiting this checkpoint
    never reads half of it), classic Ray Tune's ``checkpoint_dir``, or
    staged for the next report under the modern Ray Train API
    (``tune.py:161-167``)."""
    s = _get()
    if s is not None:
        with s.checkpoint_dir(step) as d:
            fd, tmp = tempfile.mkstemp(dir=d)
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(blob)
                os.replace(tmp, os.path.join(d, filename))
            except BaseException:
                os.unlink(tmp)
                raise
        return
    from ray_lightning_tpu_torch.tune import ray_bridge
    if ray_bridge.stage_checkpoint(blob, step, filename):
        return
    raise RuntimeError(
        "Tune checkpoint relay outside a tune trial; run through "
        "ray_lightning_tpu_torch.tune.run() or a Ray Tune trial.")


@contextlib.contextmanager
def checkpoint_dir(step: int):
    s = _get()
    if s is None:
        from ray_lightning_tpu_torch.tune import ray_bridge
        if ray_bridge.in_session():
            with ray_bridge.checkpoint_dir(step) as path:
                yield path
            return
        raise RuntimeError("tune.checkpoint_dir() outside a tune trial.")
    with s.checkpoint_dir(step) as path:
        yield path


def lease_declared() -> bool:
    """True inside a built-in trial whose ``resources_per_trial`` asks
    for GPUs: an in-process fit there takes its card from the lease."""
    s = _get()
    return s is not None and s._leaser is not None


def get_trial_devices():
    """The cards leased to the current trial (``torch.device``\\ s), or
    ``None`` (no trial, or no GPU demand declared).  ``LocalPlugin``
    calls it when its ``Trainer`` was given no device; the lease is
    taken at the first call, which may wait until a lease frees."""
    s = _get()
    return s.acquire_devices() if s is not None else None


def get_trial_id() -> str:
    s = _get()
    return s.trial.trial_id if s else "default"


def note_plan_report(report: dict) -> None:
    """Record the planner's report dict on the live trial (no-op outside
    a trial); plan/planner.py calls it after every plan, a reused one
    too."""
    s = _get()
    if s is not None:
        s.trial.plan_report = report


def get_compile_cache_dir() -> Optional[str]:
    """The experiment's shared compile-cache root, or None outside a
    trial (or with sharing turned off)."""
    s = _get()
    return getattr(s, "compile_cache_dir", None) if s is not None else None


def get_trial_dir() -> Optional[str]:
    s = _get()
    return s.trial.logdir if s else None


def get_trial():
    """The live ``Trial``, or ``None`` outside a built-in trial."""
    s = _get()
    return s.trial if s else None


__all__ = ["TrialSession", "checkpoint_dir", "deliver_checkpoint",
           "get_trial", "get_trial_devices", "get_trial_dir",
           "get_trial_id", "in_session", "lease_declared", "report",
           "set_session"]
