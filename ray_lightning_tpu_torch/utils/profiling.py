"""Observability callbacks: throughput measurement and profiler traces.

Counterpart of ``ray_lightning_tpu/utils/profiling.py``.  The
reference's only perf-measurement code is the sharded example's
``CUDACallback`` (epoch wall time and ``torch.cuda.max_memory_allocated``,
examples/ray_ddp_sharded_example.py:16-45); here:

- :func:`peak_device_memory_bytes`: the card's peak allocated bytes;
- :class:`ThroughputMonitor`: steps/s, samples/s (tokens/s for token
  batches), epoch wall time and peak device memory, logged into
  ``trainer.callback_metrics`` under the JAX package's names, so rank
  0's numbers ride the distributed result relay (the JAX monitor also
  emits each as a telemetry counter; the port's metrics plane is not
  ported, so it does not);
- :class:`TorchProfilerCallback` (in place of ``JaxProfilerCallback``):
  a ``torch.profiler`` trace over a window of training steps, written as
  a Chrome trace.

Both are host-side hooks.  The monitor syncs the device once a window,
not once a step, so it measures the device's work without serialising
the launches of every step.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import torch

from ray_lightning_tpu_torch.core.callbacks import Callback

_log = logging.getLogger(__name__)


def _cuda(device) -> Optional[torch.device]:
    """``device`` as a CUDA device, or ``None`` for any other."""
    if device is None:
        return None
    device = torch.device(device)
    return device if device.type == "cuda" else None


def peak_device_memory_bytes(device=None) -> Optional[int]:
    """``torch.cuda.max_memory_allocated`` of ``device`` (default: the
    current card, once this process has initialised CUDA); ``None`` off
    CUDA.  It never initialises CUDA itself, so a driver that stays off
    the card stays off it."""
    if device is None:
        if not torch.cuda.is_initialized():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = _cuda(device)
    if device is None:
        return None
    return int(torch.cuda.max_memory_allocated(device))


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


class ThroughputMonitor(Callback):
    """Log ``steps_per_sec``, ``samples_per_sec`` (and
    ``tokens_per_sec`` for [B, T] integer batches), ``epoch_time_s`` and
    ``peak_memory_mb`` (module docstring).

    ``window`` is how many steps go between device syncs: the monitor
    syncs once a window and averages over it."""

    def __init__(self, window: int = 50, log_tokens: bool = True):
        self.window = max(1, int(window))
        self.log_tokens = log_tokens
        self._t0: Optional[float] = None
        self._epoch_t0: Optional[float] = None
        self._units = 0
        self._samples = 0
        self._steps = 0           # optimizer steps in the current window
        self._prev_step = 0       # last observed trainer.global_step

    @staticmethod
    def _sync(trainer) -> None:
        """Wait for the window's device work."""
        device = _cuda(trainer.device)
        if device is not None:
            torch.cuda.synchronize(device)

    def _reset_window(self, trainer) -> None:
        self._t0 = None
        self._units = 0
        self._samples = 0
        self._steps = 0
        self._prev_step = trainer.global_step

    def _log_peak(self, trainer) -> None:
        device = _cuda(trainer.device)
        peak = device is not None and peak_device_memory_bytes(device)
        if peak:
            trainer.log_metric("peak_memory_mb", peak / 1e6)

    def on_train_epoch_start(self, trainer, module):
        self._epoch_t0 = time.monotonic()
        self._prev_step = trainer.global_step

    def on_validation_start(self, trainer, module):
        # a mid-epoch validation is work outside training: drop the window
        self._reset_window(trainer)

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx):
        delta = max(1, trainer.global_step - self._prev_step)
        self._prev_step = trainer.global_step
        self._steps += delta
        leaves = [x for x in _leaves(batch) if x.dim() >= 1]
        if leaves:
            lead = leaves[0]
            self._samples += int(lead.shape[0]) * delta
            # tokens/s only for [B, T] integer batches (token ids)
            is_tokens = (self.log_tokens and lead.dim() == 2
                         and not lead.is_floating_point())
            self._units += int(lead.shape[0]) * delta * (
                int(lead.shape[1]) if is_tokens else 1)
        if self._steps < self.window:
            return
        self._sync(trainer)
        now = time.monotonic()
        if self._t0 is not None:
            dt = now - self._t0
            trainer.log_metric("steps_per_sec", self._steps / dt)
            trainer.log_metric("samples_per_sec", self._samples / dt)
            if self.log_tokens and self._units != self._samples:
                trainer.log_metric("tokens_per_sec", self._units / dt)
            self._log_peak(trainer)
        self._t0 = now
        self._units = 0
        self._samples = 0
        self._steps = 0

    def on_train_epoch_end(self, trainer, module):
        if self._epoch_t0 is not None:
            self._sync(trainer)
            trainer.log_metric("epoch_time_s",
                               time.monotonic() - self._epoch_t0)
        self._log_peak(trainer)
        self._reset_window(trainer)


class TorchProfilerCallback(Callback):
    """A ``torch.profiler`` trace of training steps ``[start_step,
    start_step + num_steps)``: CPU activity, and CUDA kernels when the
    trainer runs on a card; written as a Chrome trace
    (``trace_rank{rank}_step{start}.json``) under ``log_dir`` (default
    ``<default_root_dir>/profile``).  :attr:`profile` keeps the finished
    profiler (``key_averages()``, ``events()``) on the process that ran
    the steps.  A profiler that fails to start or stop logs a warning
    and training goes on."""

    needs_batch = False   # windows on global_step; never reads the batch

    def __init__(self, start_step: int = 5, num_steps: int = 5,
                 log_dir: Optional[str] = None):
        self.start_step = int(start_step)
        self.num_steps = max(1, int(num_steps))
        self.log_dir = log_dir
        self.profile: Optional[torch.profiler.profile] = None
        self.trace_path: Optional[str] = None
        self._prof: Optional[torch.profiler.profile] = None
        self._started_at = 0
        self._done = False

    def _dir(self, trainer) -> str:
        return self.log_dir or os.path.join(trainer.default_root_dir,
                                            "profile")

    def on_train_batch_start(self, trainer, module, batch, batch_idx):
        # >= so a resumed run already past start_step still takes its
        # window (global_step restores from the checkpoint)
        if self._prof is not None or self._done \
                or trainer.global_step < self.start_step:
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if _cuda(trainer.device) is not None:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(trainer.device)
        try:
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
        except RuntimeError as e:       # profiling must never kill training
            _log.warning("torch.profiler failed to start: %s", e)
            self._done = True
            return
        self._prof = prof
        self._started_at = trainer.global_step

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx):
        if self._prof is not None and trainer.global_step >= \
                self._started_at + self.num_steps:
            self._stop(trainer)

    def on_train_end(self, trainer, module):
        if self._prof is not None:
            self._stop(trainer)

    def _stop(self, trainer) -> None:
        prof, self._prof = self._prof, None
        self._done = True
        if _cuda(trainer.device) is not None:
            torch.cuda.synchronize(trainer.device)
        try:
            prof.__exit__(None, None, None)
            path = self._dir(trainer)
            os.makedirs(path, exist_ok=True)
            self.trace_path = os.path.join(
                path, f"trace_rank{trainer.global_rank}_step"
                      f"{self._started_at}.json")
            prof.export_chrome_trace(self.trace_path)
        except (RuntimeError, OSError) as e:
            _log.warning("torch.profiler failed to stop: %s", e)
            return
        self.profile = prof


__all__ = ["ThroughputMonitor", "TorchProfilerCallback",
           "peak_device_memory_bytes"]
