"""``Trainer``: fit / validate / test / predict of a ``LightningModule``
on one device, with checkpointing, resume and a metrics log.

Counterpart of the single-device surface of ``ray_lightning_tpu/core/
trainer.py`` (``Trainer.__init__``, ``fit``, ``validate``, ``test``,
``predict``, ``_fit_loop``, ``_train_epoch``, ``_maybe_interval_val``,
``_eval_loop``, ``_predict_loop``, ``dump_checkpoint``,
``save_checkpoint``, ``load_checkpoint_dict``, ``_restore_checkpoint``):
the same loop order, hooks, stop conditions, metric semantics and
checkpoint keys, run eagerly by PyTorch on ``device`` (the card unless
the caller passes ``device="cpu"``).

Honoured: ``max_epochs``, ``max_steps``, ``callbacks``,
``default_root_dir`` (default ``<cwd>/rlt_logs``),
``enable_checkpointing`` (adds a ``ModelCheckpoint``),
``limit_{train,val,test,predict}_batches``, ``num_sanity_val_steps``,
``check_val_every_n_epoch``, ``val_check_interval`` (a validation when
``global_step`` is a multiple of it, inside the epoch),
``log_every_n_steps``, ``accumulate_grad_batches``,
``gradient_clip_val`` (``clip_by_global_norm`` chained ahead of the
module's optimizer), ``precision`` (the bf16 spellings cast a batch's
floating leaves to bf16; the model's dtypes do not change), ``seed``,
``resume_from_checkpoint`` / ``ckpt_path`` and ``logger`` (``True``: a
``CSVLogger`` writing ``<default_root_dir>/logs/metrics.csv``).
``callback_metrics`` holds, per name, the mean over the epoch of the
train steps' values (published mid-epoch every ``log_every_n_steps``
steps) and the batch-size-weighted mean of the last validation;
``global_step`` counts optimizer steps and ``current_epoch`` the epochs
run.  ``plugins``, ``strategy``, ``steps_per_execution``,
``cache_train_dataset`` and the telemetry, compile-cache, comm, elastic
and planner planes raise ``NotImplementedError`` when given a value
other than their default.

A checkpoint is one file, ``torch.save`` of plain containers
(utils/states.py), with the JAX checkpoint's top-level keys: ``epoch``,
``global_step``, ``state`` (``step``, ``params``, ``model_state``, the
optimizer's ``state_dict``, and ``rng``: the seed the steps draw from),
``hparams``, ``callbacks``, ``world_size``, ``strategy``.  Resuming
restores all of it, the tensors on the trainer's device in their saved
dtypes, so a resumed fit continues as the uninterrupted one does, bit
for bit.  As in the JAX package, ``epoch`` is the epoch the resumed fit
starts at: a ``ModelCheckpoint`` file saved during epoch e runs epoch e
again, a ``save_checkpoint`` after a fit starts the next one.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch._device import resolve_device
from ray_lightning_tpu_torch.core.callbacks import Callback, ModelCheckpoint
from ray_lightning_tpu_torch.core.data import to_device
from ray_lightning_tpu_torch.core.state import TrainState
from ray_lightning_tpu_torch.core.steps import (build_eval_step,
                                                build_init_fn,
                                                build_predict_step,
                                                build_train_step)
from ray_lightning_tpu_torch.ops.optim import chain, clip_by_global_norm
from ray_lightning_tpu_torch.utils.logger import resolve_logger
from ray_lightning_tpu_torch.utils.seed import (SEED_ENV_VAR, reset_seed,
                                                seed_everything)
from ray_lightning_tpu_torch.utils.states import (load_state_stream,
                                                  to_state_stream)

#: arguments of the JAX ``Trainer`` that are not ported: name -> default
_NOT_PORTED = {
    "plugins": None, "strategy": None, "steps_per_execution": 1,
    "cache_train_dataset": False, "telemetry": None,
    "compile_cache": None, "comm_policy": None, "elastic": None,
    "plan": None,
}

#: the JAX ``Trainer``'s precision spellings: every one of the first
#: set runs fp32 (``"64"`` too: it enables no float64), the second set
#: casts a batch's floating leaves to bf16
_FP32_PRECISIONS = ("32", "32-true", "64")
_BF16_PRECISIONS = ("bf16", "bf16-mixed", "bf16-true",
                    "16", "16-mixed", "16-true")

_LOADER_OF_STAGE = {"fit": "train", "validate": "val", "test": "test",
                    "predict": "predict"}


class Trainer:
    """Drives fit / validate / test / predict for a LightningModule on
    one device (module docstring)."""

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
        self.precision = str(precision)
        if self.precision not in _BF16_PRECISIONS + _FP32_PRECISIONS:
            raise ValueError(
                f"Unknown precision {precision!r}; use one of "
                f"{_BF16_PRECISIONS + _FP32_PRECISIONS}")
        given = dict(plugins=plugins or None, strategy=strategy,
                     steps_per_execution=int(steps_per_execution),
                     cache_train_dataset=bool(cache_train_dataset),
                     telemetry=telemetry, compile_cache=compile_cache,
                     comm_policy=comm_policy, elastic=elastic, plan=plan)
        for name, default in _NOT_PORTED.items():
            if given[name] != default:
                raise NotImplementedError(
                    f"Trainer({name}={given[name]!r}) is not ported yet "
                    f"(ROADMAP.md queue 1); the port's Trainer runs one "
                    f"device, eagerly")
        if max_epochs is None and (max_steps is None or max_steps < 0):
            max_epochs = 1000
        self.max_epochs = max_epochs
        self.max_steps = max_steps if max_steps is not None else -1
        self.callbacks: "list[Callback]" = list(callbacks or [])
        self.default_root_dir = default_root_dir or os.path.join(
            os.getcwd(), "rlt_logs")
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.limit_test_batches = limit_test_batches
        self.limit_predict_batches = limit_predict_batches
        self.check_val_every_n_epoch = max(1, check_val_every_n_epoch)
        self.val_check_interval = val_check_interval
        self.log_every_n_steps = max(1, log_every_n_steps)
        self.num_sanity_val_steps = num_sanity_val_steps
        self.accumulate_grad_batches = max(1, accumulate_grad_batches)
        self.gradient_clip_val = gradient_clip_val
        self.seed = seed
        self.resume_from_checkpoint = resume_from_checkpoint
        self.logger = resolve_logger(logger, self.default_root_dir)
        self.device = resolve_device(device)
        #: the dtype a batch's floating leaves are cast to (``None``:
        #: as the loader gives them)
        self.batch_float_dtype = (torch.bfloat16
                                  if self.precision in _BF16_PRECISIONS
                                  else None)
        if enable_checkpointing and not any(
                isinstance(c, ModelCheckpoint) for c in self.callbacks):
            self.callbacks.append(ModelCheckpoint())

        self.lightning_module = None
        self.datamodule = None
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
        self._predict_step = None
        self._epoch_metric_acc: "dict[str, list]" = {}

    # -- public API -------------------------------------------------------

    def fit(self, module, datamodule=None, ckpt_path: Optional[str] = None):
        ckpt_path = ckpt_path or self.resume_from_checkpoint
        return self._run_stage(module, datamodule, "fit", ckpt_path)

    def validate(self, module, datamodule=None,
                 ckpt_path: Optional[str] = None):
        return self._run_stage(module, datamodule, "validate", ckpt_path)

    def test(self, module, datamodule=None, ckpt_path: Optional[str] = None):
        return self._run_stage(module, datamodule, "test", ckpt_path)

    def predict(self, module, datamodule=None,
                ckpt_path: Optional[str] = None):
        """The predict loader's batches through ``module.predict_step``:
        a list of its outputs, one a batch, as CPU tensors."""
        return self._run_stage(module, datamodule, "predict", ckpt_path)

    @property
    def checkpoint_callback(self) -> Optional[ModelCheckpoint]:
        return next((c for c in self.callbacks
                     if isinstance(c, ModelCheckpoint)), None)

    # -- stage execution ----------------------------------------------------

    def _run_stage(self, module, datamodule, stage: str, ckpt_path):
        self.lightning_module = module
        module.trainer = self
        self.datamodule = datamodule
        if datamodule is not None:
            datamodule.trainer = self
        if self.seed is not None:
            seed_everything(self.seed)
        else:
            reset_seed()
        seed = (int(os.environ.get(SEED_ENV_VAR, "0")) if self.seed is None
                else self.seed)

        if datamodule is not None:
            datamodule._call_prepare_data()
            datamodule._call_setup(stage)
        module.prepare_data()
        module.setup(stage)
        module.setup_model(self.device)
        loaders = self._build_loaders(stage)
        if loaders[_LOADER_OF_STAGE[stage]] is None:
            raise ValueError(f"No dataloader available for stage {stage!r}")

        tx = module.configure_optimizers()
        if isinstance(tx, dict):
            tx = tx["optimizer"]
        if self.gradient_clip_val:
            tx = chain(clip_by_global_norm(self.gradient_clip_val), tx)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state = build_init_fn(module, tx)(generator)
        trained = getattr(module, "_trained_state", None)
        if ckpt_path:
            self._restore_checkpoint(ckpt_path, module)
        elif trained is not None:
            # reuse the weights of a previous fit with this module, as the
            # JAX trainer restores ``module._trained_variables``; a
            # checkpoint takes precedence over them
            module.model.load_state_dict(trained)
        self._train_step = build_train_step(module, tx,
                                            self.accumulate_grad_batches)
        self._eval_steps = {s: build_eval_step(module, s)
                            for s in ("validate", "test")}
        self._predict_step = build_predict_step(module)

        for cb in self.callbacks:
            cb.setup(self, module, stage)
        try:
            if stage == "fit":
                return self._fit_loop(module, loaders)
            if stage == "predict":
                return self._predict_loop(module, loaders["predict"])
            limit = (self.limit_val_batches if stage == "validate"
                     else self.limit_test_batches)
            return [self._eval_loop(module, stage,
                                    loaders[_LOADER_OF_STAGE[stage]], limit)]
        except BaseException as e:
            for cb in self.callbacks:
                cb.on_exception(self, module, e)
            raise
        finally:
            for cb in self.callbacks:
                cb.teardown(self, module, stage)

    def _get_loader(self, name: str):
        """The datamodule's loader, else the module's."""
        src = None
        if self.datamodule is not None:
            src = getattr(self.datamodule, f"{name}_dataloader")()
        if src is None:
            src = getattr(self.lightning_module, f"{name}_dataloader")()
        return src

    def _build_loaders(self, stage: str) -> dict:
        if stage == "fit":
            return {"train": self._get_loader("train"),
                    "val": self._get_loader("val")}
        name = _LOADER_OF_STAGE[stage]
        return {name: self._get_loader(name)}

    def _to_device(self, batch):
        return to_device(batch, self.device, self.batch_float_dtype)

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
                    break       # e.g. resumed from a checkpoint at max_steps
                ran_epoch = True
                self.current_epoch = epoch
                if hasattr(train_loader, "set_epoch"):
                    train_loader.set_epoch(epoch)
                self._epoch_metric_acc = {}
                for cb in self.callbacks:
                    cb.on_train_epoch_start(self, module)
                module.on_train_epoch_start()

                self._train_epoch(module, train_loader, val_loader)

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
            # zero epochs run (resumed at max_steps): the restored epoch
            # must not drift up with each save and resume
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

    def _train_epoch(self, module, train_loader, val_loader) -> None:
        """One pass over the loader: ``limit_train_batches`` counts loader
        positions; stops at ``max_steps`` or ``should_stop``; validates
        after each step that lands on ``val_check_interval``."""
        for batch_idx, batch in enumerate(train_loader):
            if self.should_stop or self._max_steps_reached():
                break
            if self.limit_train_batches is not None \
                    and batch_idx >= self.limit_train_batches:
                break
            batch = self._to_device(batch)
            for cb in self.callbacks:
                cb.on_train_batch_start(self, module, batch, batch_idx)
            self.state, metrics = self._train_step(self.state, batch)
            self.global_step += 1
            for k, v in metrics.items():
                self._epoch_metric_acc.setdefault(k, []).append(v)
            if self.global_step % self.log_every_n_steps == 0:
                self._publish_metrics(metrics)
            for cb in self.callbacks:
                cb.on_train_batch_end(self, module, metrics, batch,
                                      batch_idx)
            self._maybe_interval_val(module, val_loader)

    def _maybe_interval_val(self, module, val_loader) -> None:
        if self.val_check_interval \
                and self.global_step % self.val_check_interval == 0 \
                and val_loader is not None and self.num_val_batches > 0:
            self._eval_loop(module, "validate", val_loader,
                            self.limit_val_batches)

    def _publish_metrics(self, metrics: dict) -> None:
        for k, v in metrics.items():
            self.callback_metrics[k] = self.logged_metrics[k] = float(v)
        if self.logger is not None and metrics:
            self.logger.log_metrics(
                {k: self.logged_metrics[k] for k in metrics},
                self.global_step)

    def _flush_epoch_metrics(self) -> None:
        """Per name: the epoch's mean into ``callback_metrics``, its last
        value into ``logged_metrics``; the means to the logger as
        ``<name>_epoch``."""
        flushed = {}
        for k, vals in self._epoch_metric_acc.items():
            arr = torch.stack([v.float() for v in vals]).double().cpu()
            self.callback_metrics[k] = flushed[k] = float(arr.mean())
            self.logged_metrics[k] = float(arr[-1])
        self._epoch_metric_acc = {}
        if self.logger is not None and flushed:
            self.logger.log_metrics(
                {f"{k}_epoch": v for k, v in flushed.items()},
                self.global_step)

    def log_metric(self, name: str, value) -> None:
        """Record a host-side scalar into ``callback_metrics``."""
        self.callback_metrics[name] = float(np.asarray(
            value.detach().cpu() if isinstance(value, torch.Tensor)
            else value))

    # -- evaluation and prediction -------------------------------------------

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
            batch = self._to_device(batch)
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
            if self.logger is not None and means:
                self.logger.log_metrics(means, self.global_step)

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

    def _predict_loop(self, module, loader) -> list:
        for cb in self.callbacks:
            cb.on_predict_start(self, module)
        outputs = []
        for batch_idx, batch in enumerate(loader):
            if self.limit_predict_batches is not None \
                    and batch_idx >= self.limit_predict_batches:
                break
            out = self._predict_step(self.state, self._to_device(batch))
            outputs.append(_to_cpu(out))
        for cb in self.callbacks:
            cb.on_predict_end(self, module)
        return outputs

    # -- checkpointing -------------------------------------------------------

    def dump_checkpoint(self) -> dict:
        """The checkpoint dict (module docstring): plain containers whose
        tensors are the live state's, detached."""
        module = self.lightning_module
        model = module.model
        ckpt = {
            "epoch": int(self.current_epoch),
            "global_step": int(self.global_step),
            "state": {
                "step": int(self.state.step),
                "params": {k: p.detach() for k, p in
                           model.named_parameters()},
                "model_state": {k: b.detach() for k, b in
                                model.named_buffers()},
                "opt_state": self.state.opt_state.state_dict(),
                "rng": int(self.state.generator.initial_seed()),
            },
            "hparams": _sanitize(dict(module.hparams)),
            "callbacks": {type(cb).__name__: _sanitize(cb.state_dict())
                          for cb in self.callbacks},
            "world_size": 1,
            "strategy": "none",
        }
        module.on_save_checkpoint(ckpt)
        for cb in self.callbacks:
            cb.on_save_checkpoint(self, module, ckpt)
        return ckpt

    def save_checkpoint(self, filepath: str) -> None:
        """Write :meth:`dump_checkpoint` to ``filepath`` atomically: into
        a temporary file in the same directory that then replaces it.
        Local paths only."""
        _local(filepath)
        payload = to_state_stream(self.dump_checkpoint())
        dirname = os.path.dirname(filepath)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=dirname or ".")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
            os.replace(tmp, filepath)
        except BaseException:
            os.unlink(tmp)
            raise

    @staticmethod
    def load_checkpoint_dict(filepath: str,
                             map_location: "str | torch.device | None" = None
                             ) -> dict:
        """A checkpoint file's dict, its tensors on ``map_location`` (as
        saved when ``None``)."""
        _local(filepath)
        with open(filepath, "rb") as f:
            return load_state_stream(f.read(), map_location)

    def _restore_checkpoint(self, filepath: str, module) -> None:
        """The state, counters and callback states of a checkpoint, its
        tensors on this trainer's device in their saved dtypes; then the
        module's and the callbacks' ``on_load_checkpoint``."""
        ckpt = self.load_checkpoint_dict(filepath, self.device)
        st = ckpt["state"]
        model = module.model
        saved = {**st["params"], **st.get("model_state", {})}
        live = model.state_dict()
        wrong = [k for k, v in saved.items()
                 if k in live and v.dtype != live[k].dtype]
        if wrong:
            raise ValueError(
                f"checkpoint {filepath}: {wrong[:4]} saved as "
                f"{saved[wrong[0]].dtype}, the model holds "
                f"{live[wrong[0]].dtype}; restore would cast them")
        model.load_state_dict(saved)
        self.state.opt_state.load_state_dict(st["opt_state"])
        self.state.step = int(st["step"])
        self.state.generator = torch.Generator(
            device=self.device).manual_seed(int(st["rng"]))
        self.current_epoch = int(ckpt.get("epoch", 0))
        self.global_step = int(ckpt.get("global_step", 0))
        cb_states = ckpt.get("callbacks", {})
        for cb in self.callbacks:
            cb_state = cb_states.get(type(cb).__name__)
            if cb_state:
                cb.load_state_dict(cb_state)
        module.on_load_checkpoint(ckpt)
        for cb in self.callbacks:
            cb.on_load_checkpoint(self, module, ckpt)


def _local(filepath: str) -> None:
    if "://" in filepath:
        raise NotImplementedError(
            f"{filepath!r}: the port reads and writes local checkpoint "
            f"paths only (the JAX package's fsspec remote paths are not "
            f"ported)")


def _to_cpu(out):
    """A predict step's output with every tensor on the host."""
    if isinstance(out, torch.Tensor):
        return out.cpu()
    if isinstance(out, (tuple, list)):
        return type(out)(_to_cpu(x) for x in out)
    if isinstance(out, dict):
        return {k: _to_cpu(v) for k, v in out.items()}
    return out


def _sanitize(obj):
    """A nested structure as the plain containers a checkpoint holds:
    tuples as lists, numpy scalars as Python numbers, anything else
    unknown as its ``repr`` (the JAX ``_sanitize``)."""
    if isinstance(obj, dict):
        return {str(k): _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, (str, int, float, bool, type(None), torch.Tensor)):
        return obj
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    return repr(obj)


__all__ = ["Trainer"]
