"""Callbacks: the base class, ``ModelCheckpoint`` and ``EarlyStopping``.

Counterpart of ``ray_lightning_tpu/core/callbacks.py`` (``Callback``,
``_Monitor``, ``ModelCheckpoint``, ``EarlyStopping``): the same hooks,
called by the port's ``Trainer`` at the same points, the same file names
(``epoch={epoch}-step={step}.ckpt`` under
``<default_root_dir>/checkpoints``), top-k eviction, ``save_last``,
``every_n_epochs`` and ``state_dict`` entries.  A ``ModelCheckpoint``
saves at the end of each validation outside the sanity check, or at the
end of a train epoch that ran no validation.  Every rank runs the
callbacks and saves (a collective; ``Trainer.save_checkpoint`` writes
on global zero alone), and only global zero deletes an evicted file.
``ShardedCheckpoint`` (orbax) is not ported.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class Callback:
    """Base callback; hooks mirror the PL names."""

    def setup(self, trainer, module, stage: str) -> None: ...
    def teardown(self, trainer, module, stage: str) -> None: ...
    def on_fit_start(self, trainer, module) -> None: ...
    def on_fit_end(self, trainer, module) -> None: ...
    def on_sanity_check_start(self, trainer, module) -> None: ...
    def on_sanity_check_end(self, trainer, module) -> None: ...
    def on_train_start(self, trainer, module) -> None: ...
    def on_train_end(self, trainer, module) -> None: ...
    def on_train_epoch_start(self, trainer, module) -> None: ...
    def on_train_epoch_end(self, trainer, module) -> None: ...
    def on_train_batch_start(self, trainer, module, batch,
                             batch_idx) -> None: ...
    def on_train_batch_end(self, trainer, module, outputs, batch,
                           batch_idx) -> None: ...
    def on_validation_start(self, trainer, module) -> None: ...
    def on_validation_end(self, trainer, module) -> None: ...
    def on_validation_epoch_start(self, trainer, module) -> None: ...
    def on_validation_epoch_end(self, trainer, module) -> None: ...
    def on_validation_batch_end(self, trainer, module, outputs, batch,
                                batch_idx) -> None: ...
    def on_test_start(self, trainer, module) -> None: ...
    def on_test_end(self, trainer, module) -> None: ...
    def on_test_epoch_end(self, trainer, module) -> None: ...
    def on_predict_start(self, trainer, module) -> None: ...
    def on_predict_end(self, trainer, module) -> None: ...
    def on_exception(self, trainer, module, err: BaseException) -> None: ...
    def on_save_checkpoint(self, trainer, module,
                           checkpoint: dict) -> None: ...
    def on_load_checkpoint(self, trainer, module,
                           checkpoint: dict) -> None: ...

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None: ...


_MODE_OPS = {"min": (np.less, np.inf), "max": (np.greater, -np.inf)}


class _Monitor:
    """The monitored metric of a checkpoint or early-stop callback."""

    def __init__(self, monitor: Optional[str], mode: str,
                 min_delta: float = 0.0):
        if mode not in _MODE_OPS:
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.monitor = monitor
        self.mode = mode
        self.min_delta = abs(min_delta)
        self.op, self.worst = _MODE_OPS[mode]
        self.best = self.worst

    def current(self, trainer) -> Optional[float]:
        if self.monitor is None:
            return None
        val = trainer.callback_metrics.get(self.monitor)
        return None if val is None else float(val)

    def improved(self, value: float) -> bool:
        delta = -self.min_delta if self.mode == "min" else self.min_delta
        return (bool(self.op(value, self.best + delta))
                or self.best == self.worst)


class ModelCheckpoint(Callback):
    """Save checkpoints and track the best one (``best_model_path``,
    ``best_model_score``).  Without ``monitor`` every save becomes the
    best and none is evicted; with one, the ``save_top_k`` best scores
    are kept (``-1``: all), a new file that would not be among them is
    not written, and an evicted one is deleted."""

    def __init__(
        self,
        dirpath: Optional[str] = None,
        filename: str = "epoch={epoch}-step={step}",
        monitor: Optional[str] = None,
        mode: str = "min",
        save_top_k: int = 1,
        save_last: bool = False,
        every_n_epochs: int = 1,
    ):
        self.dirpath = dirpath
        self.filename = filename
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.save_last = save_last
        self.every_n_epochs = max(1, every_n_epochs)
        self.best_model_path: str = ""
        self.best_model_score: Optional[float] = None
        self.last_model_path: str = ""
        #: (score, path) of the kept files, best first
        self._saved: "list[tuple[float, str]]" = []
        self._mon = _Monitor(monitor, mode)

    def setup(self, trainer, module, stage: str) -> None:
        if self.dirpath is None:
            self.dirpath = os.path.join(trainer.default_root_dir,
                                        "checkpoints")

    def _format_name(self, trainer) -> str:
        name = self.filename.format(
            epoch=trainer.current_epoch, step=trainer.global_step,
            **{k: v for k, v in trainer.callback_metrics.items()
               if isinstance(v, (int, float))})
        return name + ".ckpt"

    def on_validation_end(self, trainer, module) -> None:
        if not trainer.sanity_checking:
            self._maybe_save(trainer)

    def on_train_epoch_end(self, trainer, module) -> None:
        # only here when this epoch runs no validation
        if trainer.num_val_batches == 0:
            self._maybe_save(trainer)

    def _maybe_save(self, trainer) -> None:
        if self.save_top_k == 0:
            return
        if (trainer.current_epoch + 1) % self.every_n_epochs != 0:
            return
        path = os.path.join(self.dirpath, self._format_name(trainer))
        if self.monitor is None:
            trainer.save_checkpoint(path)
            self.best_model_path = path
        else:
            score = self._mon.current(trainer)
            if score is None:
                return
            self._saved.append((score, path))
            self._saved.sort(key=lambda t: t[0], reverse=self.mode == "max")
            if self.save_top_k > 0 and len(self._saved) > self.save_top_k:
                _, evict = self._saved.pop()
                if evict == path:
                    self._record_last(trainer)
                    return                  # not in the top k: not written
                if trainer.is_global_zero and os.path.exists(evict):
                    os.remove(evict)
            trainer.save_checkpoint(path)
            self.best_model_score, self.best_model_path = self._saved[0]
        self._record_last(trainer)

    def _record_last(self, trainer) -> None:
        if self.save_last:
            self.last_model_path = os.path.join(self.dirpath, "last.ckpt")
            trainer.save_checkpoint(self.last_model_path)

    def state_dict(self) -> dict:
        return {"best_model_path": self.best_model_path,
                "best_model_score": self.best_model_score,
                "saved": list(self._saved)}

    def load_state_dict(self, state: dict) -> None:
        self.best_model_path = state.get("best_model_path", "")
        self.best_model_score = state.get("best_model_score")
        self._saved = [tuple(t) for t in state.get("saved", [])]


class EarlyStopping(Callback):
    """Stop training when a monitored metric stops improving by more than
    ``min_delta`` for ``patience`` checks in a row: checked at the end
    of each validation (outside the sanity check), or at the end of each
    train epoch with ``check_on_train_epoch_end`` or when the fit runs
    no validation."""

    def __init__(
        self,
        monitor: str = "val_loss",
        min_delta: float = 0.0,
        patience: int = 3,
        mode: str = "min",
        check_on_train_epoch_end: bool = False,
    ):
        self.monitor = monitor
        self.patience = patience
        self.wait_count = 0
        self.stopped_epoch = 0
        self.check_on_train_epoch_end = check_on_train_epoch_end
        self._mon = _Monitor(monitor, mode, min_delta)

    def _run_check(self, trainer) -> None:
        value = self._mon.current(trainer)
        if value is None:
            return
        if self._mon.improved(value):
            self._mon.best = value
            self.wait_count = 0
        else:
            self.wait_count += 1
            if self.wait_count >= self.patience:
                self.stopped_epoch = trainer.current_epoch
                trainer.should_stop = True

    def on_validation_end(self, trainer, module) -> None:
        if not trainer.sanity_checking \
                and not self.check_on_train_epoch_end:
            self._run_check(trainer)

    def on_train_epoch_end(self, trainer, module) -> None:
        if self.check_on_train_epoch_end or trainer.num_val_batches == 0:
            self._run_check(trainer)

    def state_dict(self) -> dict:
        return {"best": self._mon.best,
                "wait_count": self.wait_count,
                "stopped_epoch": self.stopped_epoch}

    def load_state_dict(self, state: dict) -> None:
        self._mon.best = state.get("best", self._mon.worst)
        self.wait_count = state.get("wait_count", 0)
        self.stopped_epoch = state.get("stopped_epoch", 0)


__all__ = ["Callback", "EarlyStopping", "ModelCheckpoint"]
