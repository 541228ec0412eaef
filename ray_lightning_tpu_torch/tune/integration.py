"""Trainer and Tune: trial resources and the report / checkpoint relay.

Counterpart of ``ray_lightning_tpu/tune/integration.py`` (the reference's
``ray_lightning/tune.py`` in full):

- ``get_tune_resources`` (``tune.py:32-56``): one trial's resource
  bundles, a head bundle for the trial driver and one a worker, in GPUs
  as the reference and ``RayPlugin`` count them;
- ``TuneReportCallback`` (``tune.py:59-134``): at the chosen trainer
  event, global zero takes ``trainer.callback_metrics`` (outside the
  sanity check) and relays ``report(**metrics)`` to the trial driver:
  through the worker-to-driver queue when the fit runs in actors, by a
  direct call when it runs in process;
- ``TuneReportCheckpointCallback`` (``tune.py:180-236``): the whole
  checkpoint as bytes first, then the report; the trial driver writes
  the bytes into ``tune.checkpoint_dir(step)`` (``tune.py:161-178``).

"Relay the side effect, not the call": ``report`` works only where the
trial session lives, so a worker sends a zero-argument callable that the
driver's ``util.process_results`` calls (SURVEY.md §3.3).  The payload
classes are module-level: the queue pickles them by import path.
"""

from __future__ import annotations

import logging
import warnings
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

from ray_lightning_tpu_torch.core.callbacks import Callback
from ray_lightning_tpu_torch.session import get_session
from ray_lightning_tpu_torch.tune import session as tune_session
from ray_lightning_tpu_torch.utils.imports import RAY_AVAILABLE

_log = logging.getLogger(__name__)


@dataclass
class TrialResources:
    """One trial's resource bundles (``PlacementGroupFactory``'s):
    ``bundles[0]`` is the trial driver's head (1 CPU, ``tune.py:50-53``),
    the rest one a worker.  ``as_placement_group_factory()`` makes the
    Ray object when Ray is installed."""

    bundles: list = field(default_factory=list)
    strategy: str = "PACK"

    @property
    def head_cpus(self) -> float:
        return self.bundles[0].get("CPU", 0) if self.bundles else 0

    def as_placement_group_factory(self):
        if not RAY_AVAILABLE:
            raise ImportError("Ray is not installed.")
        from ray.tune import PlacementGroupFactory
        return PlacementGroupFactory(self.bundles, strategy=self.strategy)


def get_tune_resources(
    num_workers: int = 1,
    num_cpus_per_worker: int = 1,
    use_gpu: bool = False,
    gpus_per_worker: int = 1,
    resources_per_worker: Optional[dict] = None,
    cpus_per_worker: Optional[int] = None,
) -> TrialResources:
    """Resources for one trial of ``num_workers`` workers: a worker
    bundle is ``{"CPU": n, "GPU": g}`` (``"GPU"`` only with
    ``use_gpu``).  ``resources_per_worker`` overrides the convenience
    arguments as ``RayPlugin``'s does: its ``"CPU"`` sets the CPUs, its
    ``"GPU"`` sets ``use_gpu`` (``> 0``) and the GPUs a worker asks
    for, other keys are kept.  ``cpus_per_worker`` is the reference's
    deprecated spelling of ``num_cpus_per_worker`` (``tune.py:42-48``).
    """
    if cpus_per_worker is not None:
        warnings.warn(
            "cpus_per_worker is deprecated; use num_cpus_per_worker",
            DeprecationWarning, stacklevel=2)
        num_cpus_per_worker = cpus_per_worker
    resources = dict(resources_per_worker or {})
    num_cpus_per_worker = resources.pop("CPU", num_cpus_per_worker)
    if "GPU" in resources:
        gpus = resources.pop("GPU")
        use_gpu = gpus > 0
        gpus_per_worker = gpus or gpus_per_worker
    worker = {"CPU": num_cpus_per_worker, **resources}
    if use_gpu:
        worker["GPU"] = gpus_per_worker
    head = {"CPU": 1}
    return TrialResources(bundles=[head] + [dict(worker)] * num_workers,
                          strategy="PACK")


_EVENTS = ("validation_end", "train_epoch_end", "train_end", "batch_end")


class _TuneCallbackBase(Callback):
    """Event dispatch (the reference's ``TuneCallback(on=...)``)."""

    def __init__(self, on: Union[str, Sequence[str]] = "validation_end"):
        if isinstance(on, str):
            on = [on]
        bad = [e for e in on if e not in _EVENTS]
        if bad:
            raise ValueError(f"Unknown events {bad}; options: {_EVENTS}")
        self._on = set(on)

    def _handle(self, trainer, module) -> None:
        raise NotImplementedError

    def _fire(self, event, trainer, module):
        if event in self._on and not trainer.sanity_checking \
                and trainer.is_global_zero:
            self._handle(trainer, module)

    def on_validation_end(self, trainer, module):
        self._fire("validation_end", trainer, module)

    def on_train_epoch_end(self, trainer, module):
        self._fire("train_epoch_end", trainer, module)

    def on_train_end(self, trainer, module):
        self._fire("train_end", trainer, module)

    needs_batch = False   # _fire never receives the batch

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx):
        self._fire("batch_end", trainer, module)

    @staticmethod
    def _relay(payload) -> None:
        """Run ``payload`` where the trial session lives: send it to the
        driver from an actor worker, else call it here (against the
        built-in runner's session or a live Ray Tune one)."""
        try:
            get_session().put_queue(payload)
            return
        except ValueError:
            pass
        from ray_lightning_tpu_torch.tune import ray_bridge
        if tune_session.in_session() or ray_bridge.in_session():
            payload()
        else:
            _log.warning(
                "Tune callback fired outside a tune trial and outside a "
                "worker queue; dropping report.")


class TuneReportCallback(_TuneCallbackBase):
    """Report trainer metrics to Tune (``tune.py:59-134``).

    ``metrics``: ``None`` (every metric), a name or a list of names, or a
    dict from the reported name to the trainer metric's name.
    """

    def __init__(self, metrics: Union[None, str, list, dict] = None,
                 on: Union[str, Sequence[str]] = "validation_end"):
        super().__init__(on)
        if isinstance(metrics, str):
            metrics = [metrics]
        self._metrics = metrics

    def _get_report_dict(self, trainer) -> Optional[dict]:
        cbm = {k: float(v) for k, v in trainer.callback_metrics.items()}
        if not self._metrics:
            report = dict(cbm)
        elif isinstance(self._metrics, dict):
            report = {out: cbm[src] for out, src in self._metrics.items()
                      if src in cbm}
        else:
            report = {k: cbm[k] for k in self._metrics if k in cbm}
        if not report:
            _log.warning(
                "Metrics %s not found in trainer.callback_metrics %s; "
                "skipping report.", self._metrics, sorted(cbm))
            return None
        return report

    def _handle(self, trainer, module) -> None:
        report = self._get_report_dict(trainer)
        if report is not None:
            self._relay(_ReportPayload(report))


class _ReportPayload:
    """Zero-argument callable run on the trial driver: the session is
    looked up when it is called there (the built-in runner's or a live
    Ray Tune one)."""

    def __init__(self, metrics: dict):
        self.metrics = metrics

    def __call__(self):
        tune_session.report(**self.metrics)


class _CheckpointPayload:
    """Checkpoint bytes, written into the trial's checkpoint store on
    the trial driver (``tune.py:161-167``: the worker's bytes, the
    driver's write): a directory of the built-in runner or classic Ray
    Tune, or staged for the next report under the Ray Train API."""

    def __init__(self, blob: bytes, step: int, filename: str):
        self.blob = blob
        self.step = step
        self.filename = filename

    def __call__(self):
        tune_session.deliver_checkpoint(self.blob, self.step, self.filename)


class _TuneCheckpointCallback(_TuneCallbackBase):
    """Send the trainer's whole checkpoint to the trial driver
    (``tune.py:136-178``)."""

    def __init__(self, filename: str = "checkpoint",
                 on: Union[str, Sequence[str]] = "validation_end"):
        super().__init__(on)
        self._filename = filename

    def _fire(self, event, trainer, module):
        # building the checkpoint is collective (ZeRO-1 gathers its
        # shards on every rank); only the relay is global zero's
        if event in self._on and not trainer.sanity_checking:
            ckpt = trainer.dump_checkpoint()
            if trainer.is_global_zero:
                blob = trainer.serialize_checkpoint(ckpt)
                self._relay(_CheckpointPayload(
                    blob, trainer.global_step, self._filename))

    def _handle(self, trainer, module) -> None:   # _fire does the work
        pass


class TuneReportCheckpointCallback(_TuneCallbackBase):
    """The checkpoint, then the report, so Tune ties the checkpoint to
    the reported iteration (``tune.py:180-236``, order at :234-236)."""

    def __init__(self, metrics: Union[None, str, list, dict] = None,
                 filename: str = "checkpoint",
                 on: Union[str, Sequence[str]] = "validation_end"):
        super().__init__(on)
        self._checkpoint = _TuneCheckpointCallback(filename, on)
        self._report = TuneReportCallback(metrics, on)

    def _fire(self, event, trainer, module):
        self._checkpoint._fire(event, trainer, module)
        self._report._fire(event, trainer, module)

    def _handle(self, trainer, module) -> None:
        pass


__all__ = ["TrialResources", "TuneReportCallback",
           "TuneReportCheckpointCallback", "get_tune_resources"]
