"""``Trainer``: fit / validate / test of a ``LightningModule`` on one
device.

Counterpart of the single-device surface of ``ray_lightning_tpu/core/
trainer.py`` (``Trainer.__init__``, ``fit``, ``validate``, ``test``,
``_fit_loop``, ``_train_epoch``, ``_eval_loop``): the same loop order,
hooks, stop conditions and metric semantics, run eagerly by PyTorch on
``device`` (the card unless the caller passes ``device="cpu"``).

Honoured: ``max_epochs``, ``max_steps``, ``callbacks``,
``limit_{train,val,test}_batches``, ``num_sanity_val_steps``,
``check_val_every_n_epoch``, ``log_every_n_steps``,
``accumulate_grad_batches``, ``seed``.  ``callback_metrics`` holds, per
name, the mean over the epoch of the train steps' values (published
mid-epoch every ``log_every_n_steps`` steps) and the batch-size-weighted
mean of the last validation; ``global_step`` counts optimizer steps and
``current_epoch`` the epochs run.  Every other argument of the JAX
``Trainer`` raises ``NotImplementedError`` when given a value other than
its default, and ``enable_checkpointing=True`` (its default: it adds a
``ModelCheckpoint``) raises until checkpointing is ported: pass
``enable_checkpointing=False``.  The JAX package's logger, progress bar
and distributed sampler have nothing to do on one device and no files
are written.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch._device import resolve_device
from ray_lightning_tpu_torch.core.callbacks import Callback
from ray_lightning_tpu_torch.core.data import to_device
from ray_lightning_tpu_torch.core.state import TrainState
from ray_lightning_tpu_torch.core.steps import (build_eval_step,
                                                build_init_fn,
                                                build_train_step)
from ray_lightning_tpu_torch.utils.seed import (SEED_ENV_VAR, reset_seed,
                                                seed_everything)

#: arguments of the JAX ``Trainer`` that are not ported: name -> default
_NOT_PORTED = {
    "plugins": None, "strategy": None, "default_root_dir": None,
    "val_check_interval": None, "limit_predict_batches": None,
    "steps_per_execution": 1, "cache_train_dataset": False,
    "gradient_clip_val": None, "precision": "32",
    "resume_from_checkpoint": None, "telemetry": None,
    "compile_cache": None, "comm_policy": None, "elastic": None,
    "plan": None,
}

#: the JAX ``Trainer``'s precision spellings: every one of the first
#: set runs fp32 (``"64"`` too: it enables no float64), the second set
#: means bf16 inputs, which the port does not take yet
_FP32_PRECISIONS = ("32", "32-true", "64")
_BF16_PRECISIONS = ("bf16", "bf16-mixed", "bf16-true",
                    "16", "16-mixed", "16-true")


class Trainer:
    """Drives fit / validate / test for a LightningModule on one
    device (module docstring)."""

    def __init__(
        self,
        max_epochs: Optional[int] = None,
        max_steps: int = -1,
        callbacks: Optional["list[Callback]"] = None,
        plugins: Optional[list] = None,
        strategy: Any = None,
        default_root_dir: Optional[str] = None,
        enable_checkpointing: bool = True,
        limit_train_batches: Optional[int] = None,
        limit_val_batches: Optional[int] = None,
        limit_test_batches: Optional[int] = None,
        limit_predict_batches: Optional[int] = None,
        check_val_every_n_epoch: int = 1,
        val_check_interval: Optional[int] = None,
        log_every_n_steps: int = 50,
        num_sanity_val_steps: int = 2,
        accumulate_grad_batches: int = 1,
        steps_per_execution: int = 1,
        cache_train_dataset: bool = False,
        gradient_clip_val: Optional[float] = None,
        precision: str = "32",
        seed: Optional[int] = None,
        resume_from_checkpoint: Optional[str] = None,
        use_distributed_sampler: bool = True,
        enable_progress_bar: bool = False,
        logger: Any = True,
        telemetry: Any = None,
        compile_cache: Any = None,
        comm_policy: Any = None,
        elastic: Any = None,
        plan: Any = None,
        device: "str | torch.device | None" = None,
    ):
        precision = str(precision)
        if precision not in _BF16_PRECISIONS + _FP32_PRECISIONS:
            raise ValueError(
                f"Unknown precision {precision!r}; use one of "
                f"{_BF16_PRECISIONS + _FP32_PRECISIONS}")
        if precision in _FP32_PRECISIONS:
            precision = "32"
        given = dict(plugins=plugins or None, strategy=strategy,
                     default_root_dir=default_root_dir,
                     val_check_interval=val_check_interval,
                     limit_predict_batches=limit_predict_batches,
                     steps_per_execution=int(steps_per_execution),
                     cache_train_dataset=bool(cache_train_dataset),
                     gradient_clip_val=gradient_clip_val or None,
                     precision=precision,
                     resume_from_checkpoint=resume_from_checkpoint,
                     telemetry=telemetry, compile_cache=compile_cache,
                     comm_policy=comm_policy, elastic=elastic, plan=plan)
        for name, default in _NOT_PORTED.items():
            if given[name] != default:
                raise NotImplementedError(
                    f"Trainer({name}={given[name]!r}) is not ported yet "
                    f"(ROADMAP.md queue 1: the rest of core/trainer.py); "
                    f"the port's Trainer runs one device, eagerly")
        if enable_checkpointing:
            raise NotImplementedError(
                "checkpointing (ModelCheckpoint) is not ported yet "
                "(ROADMAP.md queue 1); pass enable_checkpointing=False")
        if max_epochs is None and (max_steps is None or max_steps < 0):
            max_epochs = 1000
        self.max_epochs = max_epochs
        self.max_steps = max_steps if max_steps is not None else -1
        self.callbacks: "list[Callback]" = list(callbacks or [])
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.limit_test_batches = limit_test_batches
        self.check_val_every_n_epoch = max(1, check_val_every_n_epoch)
        self.log_every_n_steps = max(1, log_every_n_steps)
        self.num_sanity_val_steps = num_sanity_val_steps
        self.accumulate_grad_batches = max(1, accumulate_grad_batches)
        self.seed = seed
        self.device = resolve_device(device)

        self.lightning_module = None
        self.current_epoch = 0
        self.global_step = 0
        self.should_stop = False
        self.sanity_checking = False
        self.num_val_batches = 0
        self.callback_metrics: "dict[str, float]" = {}
        self.logged_metrics: "dict[str, float]" = {}
        self.state: Optional[TrainState] = None
        self._train_step = None
        self._eval_steps: dict = {}
        self._epoch_metric_acc: "dict[str, list]" = {}

    # -- public API -------------------------------------------------------

    def fit(self, module, datamodule=None, ckpt_path: Optional[str] = None):
        return self._run_stage(module, datamodule, "fit", ckpt_path)

    def validate(self, module, datamodule=None,
                 ckpt_path: Optional[str] = None):
        return self._run_stage(module, datamodule, "validate", ckpt_path)

    def test(self, module, datamodule=None, ckpt_path: Optional[str] = None):
        return self._run_stage(module, datamodule, "test", ckpt_path)

    def predict(self, module, datamodule=None,
                ckpt_path: Optional[str] = None):
        raise NotImplementedError(
            "Trainer.predict is not ported yet (ROADMAP.md queue 1)")

    # -- stage execution ----------------------------------------------------

    def _run_stage(self, module, datamodule, stage: str, ckpt_path):
        if datamodule is not None or ckpt_path:
            raise NotImplementedError(
                "datamodules and checkpoint restore are not ported yet "
                "(ROADMAP.md queue 1)")
        self.lightning_module = module
        module.trainer = self
        if self.seed is not None:
            seed_everything(self.seed)
        else:
            reset_seed()
        seed = (int(os.environ.get(SEED_ENV_VAR, "0")) if self.seed is None
                else self.seed)

        module.prepare_data()
        module.setup(stage)
        module.setup_model(self.device)
        loaders = self._build_loaders(module, stage)
        key = {"fit": "train", "validate": "val", "test": "test"}[stage]
        if loaders.get(key) is None:
            raise ValueError(f"No dataloader available for stage {stage!r}")

        tx = module.configure_optimizers()
        if isinstance(tx, dict):
            tx = tx["optimizer"]
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state = build_init_fn(module, tx)(generator)
        trained = getattr(module, "_trained_state", None)
        if trained is not None:
            # reuse the weights of a previous fit with this module, as the
            # JAX trainer restores ``module._trained_variables``
            module.model.load_state_dict(trained)
        self._train_step = build_train_step(module, tx,
                                            self.accumulate_grad_batches)
        self._eval_steps = {s: build_eval_step(module, s)
                            for s in ("validate", "test")}

        for cb in self.callbacks:
            cb.setup(self, module, stage)
        try:
            if stage == "fit":
                return self._fit_loop(module, loaders)
            limit = (self.limit_val_batches if stage == "validate"
                     else self.limit_test_batches)
            return [self._eval_loop(module, stage, loaders[key], limit)]
        except BaseException as e:
            for cb in self.callbacks:
                cb.on_exception(self, module, e)
            raise
        finally:
            for cb in self.callbacks:
                cb.teardown(self, module, stage)

    def _build_loaders(self, module, stage: str) -> dict:
        if stage == "fit":
            return {"train": module.train_dataloader(),
                    "val": module.val_dataloader()}
        if stage == "validate":
            return {"val": module.val_dataloader()}
        return {"test": module.test_dataloader()}

    # -- fit loop -------------------------------------------------------------

    def _max_steps_reached(self) -> bool:
        return self.max_steps is not None and self.max_steps >= 0 \
            and self.global_step >= self.max_steps

    def _fit_loop(self, module, loaders):
        train_loader, val_loader = loaders["train"], loaders.get("val")
        self.num_val_batches = self._loader_len(val_loader,
                                                self.limit_val_batches)
        for cb in self.callbacks:
            cb.on_fit_start(self, module)
        module.on_fit_start()
        if val_loader is not None and self.num_sanity_val_steps > 0 \
                and self.num_val_batches > 0:
            self._sanity_check(module, val_loader)
        for cb in self.callbacks:
            cb.on_train_start(self, module)
        module.on_train_start()

        epoch = start_epoch = self.current_epoch
        ran_epoch = False
        try:
            for epoch in range(start_epoch, self.max_epochs or 10**9):
                if self.should_stop or self._max_steps_reached():
                    break
                ran_epoch = True
                self.current_epoch = epoch
                if hasattr(train_loader, "set_epoch"):
                    train_loader.set_epoch(epoch)
                self._epoch_metric_acc = {}
                for cb in self.callbacks:
                    cb.on_train_epoch_start(self, module)
                module.on_train_epoch_start()

                self._train_epoch(module, train_loader)

                self._flush_epoch_metrics()
                module.on_train_epoch_end()
                for cb in self.callbacks:
                    cb.on_train_epoch_end(self, module)
                if val_loader is not None and self.num_val_batches > 0 \
                        and (epoch + 1) % self.check_val_every_n_epoch == 0:
                    self._eval_loop(module, "validate", val_loader,
                                    self.limit_val_batches)
                if self.should_stop or self._max_steps_reached():
                    break
        finally:
            if ran_epoch:
                self.current_epoch = (
                    min(epoch + 1, self.max_epochs or epoch + 1)
                    if not self.should_stop else epoch)
            module.on_train_end()
            for cb in self.callbacks:
                cb.on_train_end(self, module)
            module.on_fit_end()
            for cb in self.callbacks:
                cb.on_fit_end(self, module)
        self._flush_epoch_metrics()
        module._trained_state = {k: v.detach().clone() for k, v in
                                 module.model.state_dict().items()}
        return {"callback_metrics": dict(self.callback_metrics)}

    def _train_epoch(self, module, train_loader) -> None:
        """One pass over the loader: ``limit_train_batches`` counts loader
        positions; stops at ``max_steps`` or ``should_stop``."""
        for batch_idx, batch in enumerate(train_loader):
            if self.should_stop or self._max_steps_reached():
                break
            if self.limit_train_batches is not None \
                    and batch_idx >= self.limit_train_batches:
                break
            batch = to_device(batch, self.device)
            for cb in self.callbacks:
                cb.on_train_batch_start(self, module, batch, batch_idx)
            self.state, metrics = self._train_step(self.state, batch)
            self.global_step += 1
            for k, v in metrics.items():
                self._epoch_metric_acc.setdefault(k, []).append(v)
            if self.global_step % self.log_every_n_steps == 0:
                for k, v in metrics.items():
                    self.callback_metrics[k] = self.logged_metrics[k] = \
                        float(v)
            for cb in self.callbacks:
                cb.on_train_batch_end(self, module, metrics, batch,
                                      batch_idx)

    def _flush_epoch_metrics(self) -> None:
        """Per name: the epoch's mean into ``callback_metrics``, its last
        value into ``logged_metrics``."""
        for k, vals in self._epoch_metric_acc.items():
            arr = torch.stack([v.float() for v in vals]).double().cpu()
            self.callback_metrics[k] = float(arr.mean())
            self.logged_metrics[k] = float(arr[-1])
        self._epoch_metric_acc = {}

    def log_metric(self, name: str, value) -> None:
        """Record a host-side scalar into ``callback_metrics``."""
        self.callback_metrics[name] = float(np.asarray(
            value.detach().cpu() if isinstance(value, torch.Tensor)
            else value))

    # -- evaluation -------------------------------------------------------------

    def _loader_len(self, loader, limit) -> int:
        if loader is None or limit == 0:
            return 0
        try:
            n = len(loader)
        except TypeError:
            n = 10**9
        return min(n, limit) if limit is not None else n

    def _sanity_check(self, module, val_loader) -> None:
        self.sanity_checking = True
        for cb in self.callbacks:
            cb.on_sanity_check_start(self, module)
        self._eval_loop(module, "validate", val_loader,
                        self.num_sanity_val_steps)
        for cb in self.callbacks:
            cb.on_sanity_check_end(self, module)
        self.sanity_checking = False

    def _eval_loop(self, module, stage: str, loader, limit) -> dict:
        step = self._eval_steps[stage]
        if stage == "validate":
            for cb in self.callbacks:
                cb.on_validation_start(self, module)
            for cb in self.callbacks:
                cb.on_validation_epoch_start(self, module)
            module.on_validation_epoch_start()
        else:
            for cb in self.callbacks:
                cb.on_test_start(self, module)

        acc = []
        for batch_idx, batch in enumerate(loader):
            if limit is not None and batch_idx >= limit:
                break
            batch = to_device(batch, self.device)
            logged = step(self.state, batch)
            leaves = batch if isinstance(batch, (tuple, list)) else [batch]
            bsz = leaves[0].shape[0] if leaves[0].dim() > 0 else 1
            acc.append((logged, bsz))
            if stage == "validate":
                for cb in self.callbacks:
                    cb.on_validation_batch_end(self, module, logged, batch,
                                               batch_idx)

        means: "dict[str, float]" = {}
        if acc:
            total = sum(b for _, b in acc)
            for k in acc[0][0]:
                vals = torch.stack([d[k].float() for d, _ in acc]).double()
                weights = torch.tensor([b for _, b in acc],
                                       dtype=torch.float64)
                means[k] = float((vals.cpu() * weights).sum()
                                 / max(total, 1))
        if not self.sanity_checking:
            self.callback_metrics.update(means)
            self.logged_metrics.update(means)

        if stage == "validate":
            module.on_validation_epoch_end()
            for cb in self.callbacks:
                cb.on_validation_epoch_end(self, module)
            for cb in self.callbacks:
                cb.on_validation_end(self, module)
        else:
            for cb in self.callbacks:
                cb.on_test_epoch_end(self, module)
            for cb in self.callbacks:
                cb.on_test_end(self, module)
        return means


__all__ = ["Trainer"]
