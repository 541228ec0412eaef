"""Bridge to a live Ray Tune / Train trial session.

Counterpart of ``ray_lightning_tpu/tune/ray_bridge.py``.  The built-in
runner (tune/runner.py) keeps its own thread-local session; the
reference's own recipe is ``ray.tune.run(train_fn,
resources_per_trial=get_tune_resources(...))`` with Ray Tune
(reference ``README.md:140-183``), where ``tune.report`` and
``tune.checkpoint_dir`` resolve against Ray's session in the trial's
process (``tune.py:130-134, 161-178``).  This module finds that session
and routes the relay payloads into it, so ``TuneReportCallback`` works
under either runner.

Three Ray API generations, probed in this order:

- **classic function trainables** (the one the reference binds):
  ``ray.tune.report(**metrics)`` and ``with ray.tune.checkpoint_dir(step)``,
  found through ``tune.is_session_enabled``;
- **the public context API** (where ``is_session_enabled`` is gone):
  ``ray.tune.get_context()`` with a live trial id, reporting through
  ``ray.tune.report(metrics_dict, checkpoint=...)``; probed before the
  private path below, so a release that drops its internals still works;
- **the Train API through its private session** (last):
  ``ray.train._internal.session.get_session`` and
  ``ray.train.report(metrics, checkpoint=Checkpoint.from_directory(d))``.

Under both later generations a checkpoint can only ride a report, so a
checkpoint payload is staged and attached to the next report (the
callbacks relay the checkpoint first, then the report, for this
pairing: ``tune.py:234-236``).

Everything is probed lazily and defensively: Ray absent, Ray present
without a live session, and each generation behave sensibly.  The
built-in runner's session always wins: tune/session.py asks it first.
"""

from __future__ import annotations

import contextlib
import logging
import os
import shutil
import tempfile
import threading

_log = logging.getLogger(__name__)

# modern-API checkpoint staged for the next report, per trial thread
_local = threading.local()


# -- session detection ------------------------------------------------------

def _classic_session_live() -> bool:
    """True when ray.tune's classic function-trainable session exists."""
    try:
        from ray import tune
    except Exception:
        return False
    for probe in ("is_session_enabled",):
        fn = getattr(tune, probe, None)
        if fn is not None:
            try:
                return bool(fn())
            except Exception:
                return False
    # older layout: ray.tune.session.get_session()
    try:
        from ray.tune.session import get_session
        return get_session() is not None
    except Exception:
        return False


def _tune_context():
    """Live public-API tune context (``ray.tune.get_context()``), or None.

    Recent Ray hands back a context object even outside a trial, so a
    context only counts as live when it can produce a trial id.
    """
    try:
        from ray import tune
    except Exception:
        return None
    get_ctx = getattr(tune, "get_context", None)
    if get_ctx is None:
        return None
    try:
        ctx = get_ctx()
        if ctx is None or not ctx.get_trial_id():
            return None
        return ctx
    except Exception:
        return None


def _train_session():
    """The modern Train-API session object via the PRIVATE module path.
    Kept as the last probe: releases that drop the internals are served
    by :func:`_tune_context` above."""
    try:
        from ray.train._internal.session import get_session
        return get_session()
    except Exception:
        return None


def in_session() -> bool:
    """True when a real Ray Tune/Train session is live in this process."""
    return (_classic_session_live() or _tune_context() is not None
            or _train_session() is not None)


# -- report -----------------------------------------------------------------

def report(metrics: dict) -> bool:
    """Deliver ``metrics`` to the live real-Ray session.

    Returns False when no real session exists (caller falls through to
    its own error/warning path).  A staged modern-API checkpoint is
    attached and consumed.
    """
    if _classic_session_live():
        from ray import tune
        tune.report(**metrics)
        return True
    if _tune_context() is not None:
        from ray import tune
        if _report_accepts_checkpoint(tune.report):
            return _report_with_staged(
                lambda m, c: tune.report(m, checkpoint=c)
                if c is not None else tune.report(m), metrics)
        # MID-generation Ray: tune.get_context exists but tune.report
        # still has the classic kwargs-only signature — calling it with
        # a positional dict would TypeError.  Prefer the train session
        # (falls through to the branch below, which can attach staged
        # checkpoints); with no train session, deliver a staged
        # checkpoint via the classic dir if it survives, then the
        # metrics classic-style.
        if _train_session() is None:
            _deliver_staged_classic(tune)
            tune.report(**metrics)
            return True
    if _train_session() is not None:
        from ray import train
        return _report_with_staged(lambda m, c: train.report(m, checkpoint=c)
                                   if c is not None else train.report(m),
                                   metrics)
    return False


def _deliver_staged_classic(tune) -> None:
    """Mid-generation last resort for a staged checkpoint: the report
    about to go out is kwargs-only and cannot attach it.  If this Ray
    still ships the classic ``tune.checkpoint_dir``, write the staged
    files there (the reference's own move, tune.py:161-167); otherwise
    warn LOUDLY and drop — silently losing a trial's checkpoints is the
    one unacceptable outcome."""
    staged = getattr(_local, "pending_checkpoint", None)
    if staged is None:
        return
    _local.pending_checkpoint = None
    step = getattr(_local, "pending_step", 0)
    try:
        ckpt_dir = getattr(tune, "checkpoint_dir", None)
        if ckpt_dir is not None:
            with ckpt_dir(step=step) as d:
                for name in os.listdir(staged):
                    shutil.copy2(os.path.join(staged, name),
                                 os.path.join(d, name))
            return
        _log.warning(
            "Staged Tune checkpoint dropped: this Ray generation's "
            "tune.report cannot attach checkpoints and tune.checkpoint_dir "
            "is gone; install a Ray with the modern report signature to "
            "record checkpoints from this callback.")
    finally:
        shutil.rmtree(staged, ignore_errors=True)


def _report_accepts_checkpoint(report_fn) -> bool:
    """True when ``report_fn`` takes a ``checkpoint`` kwarg (the modern
    positional-dict signature).  Mid-generation Ray ships
    ``tune.get_context`` while ``tune.report`` keeps the classic
    kwargs-only signature; probing the signature (instead of catching a
    TypeError mid-call) keeps staged checkpoints from being consumed by
    a call that was never going to deliver them."""
    import inspect
    try:
        params = inspect.signature(report_fn).parameters
    except (TypeError, ValueError):
        return True   # uninspectable builtins: assume modern
    return "checkpoint" in params


def _report_with_staged(report_fn, metrics: dict) -> bool:
    """Shared non-classic delivery: attach and consume any staged
    checkpoint (it can only ride a report in these generations)."""
    staged = getattr(_local, "pending_checkpoint", None)
    _local.pending_checkpoint = None
    if staged is not None:
        checkpoint = _as_train_checkpoint(staged)
        try:
            report_fn(dict(metrics), checkpoint)
        finally:
            shutil.rmtree(staged, ignore_errors=True)
    else:
        report_fn(dict(metrics), None)
    return True


def _as_train_checkpoint(directory: str):
    # same class either way in real Ray; probe the tune alias first so a
    # release that reorganizes ray.train keeps working
    try:
        from ray.tune import Checkpoint
    except Exception:
        from ray.train import Checkpoint
    return Checkpoint.from_directory(directory)


# -- checkpoint -------------------------------------------------------------

def stage_checkpoint(blob: bytes, step: int, filename: str) -> bool:
    """Hand checkpoint bytes to the live real-Ray session.

    Classic API: written straight into ``tune.checkpoint_dir(step)``
    (the reference's exact move, tune.py:161-167).  Modern API: written
    to a temp dir and staged; the next :func:`report` attaches it.
    Returns False when no real session exists.
    """
    if _classic_session_live():
        from ray import tune
        with tune.checkpoint_dir(step=step) as d:
            with open(os.path.join(d, filename), "wb") as f:
                f.write(blob)
        return True
    if _tune_context() is not None or _train_session() is not None:
        prev = getattr(_local, "pending_checkpoint", None)
        if prev is not None:
            # a checkpoint was staged but never reported (standalone
            # checkpoint cadence): the newer one supersedes it.
            _log.warning(
                "Staged Tune checkpoint was replaced before any report "
                "attached it; pair _TuneCheckpointCallback with a report "
                "(TuneReportCheckpointCallback) under the modern Ray "
                "Train API.")
            shutil.rmtree(prev, ignore_errors=True)
        d = tempfile.mkdtemp(prefix=f"rlt_tune_ckpt_{step}_")
        with open(os.path.join(d, filename), "wb") as f:
            f.write(blob)
        _local.pending_checkpoint = d
        _local.pending_step = step   # classic-dir fallback needs it
        return True
    return False


@contextlib.contextmanager
def checkpoint_dir(step: int):
    """Classic-API passthrough used when callers want a directory.  The
    modern Train API has no standalone checkpoint directory — use
    :func:`stage_checkpoint` + :func:`report` there."""
    if not _classic_session_live():
        raise RuntimeError(
            "checkpoint_dir() requires the classic Ray Tune session; "
            "under the modern Ray Train API checkpoints must be "
            "attached to a report.")
    from ray import tune
    with tune.checkpoint_dir(step=step) as d:
        yield d


__all__ = ["checkpoint_dir", "in_session", "report", "stage_checkpoint"]
