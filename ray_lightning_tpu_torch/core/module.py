"""``LightningModule`` and the ``StepContext`` its steps receive.

Counterpart of ``ray_lightning_tpu/core/module.py``.  The JAX steps are
pure functions traced under jit, so their context carries the params and
collects logged metrics functionally.  A torch module carries its own
parameters and runs eagerly, so here the context only names the model to
call, says whether the step trains, and collects ``ctx.log`` values (as
detached fp32 tensors, left on the device until the trainer reads them).
"""

from __future__ import annotations

import copy
import inspect
from typing import Any, Mapping, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.ops.random import Key, key_words


class StepContext:
    """What a ``training_step`` / ``validation_step`` receives:
    ``ctx.model`` (the module's ``torch.nn.Module``), ``ctx.training``,
    ``ctx.make_key()`` / ``ctx.make_rng()`` and ``ctx.log`` /
    ``ctx.log_dict`` / ``ctx.logged``.

    ``rng`` is the step's entropy, a tuple of non-negative ints (the
    train step passes the ``Trainer`` seed, the global step and the
    microbatch index; ``None``: the step draws nothing, as the JAX eval
    step has no key).  ``key`` is the step's key words on the device
    (ops/random.py: int64 [2]), given where the host cannot make them: a
    graphed chunk feeds each step's through a static input; ``None``:
    :meth:`make_key` makes them from ``rng`` on first use."""

    __slots__ = ("module", "training", "_logged", "_rng", "_rng_calls",
                 "_device", "_key")

    def __init__(self, module: "LightningModule", training: bool,
                 rng: "tuple[int, ...] | None" = None,
                 device: "torch.device | str | None" = None,
                 key: "torch.Tensor | None" = None):
        self.module = module
        self.training = training
        self._logged: "dict[str, torch.Tensor]" = {}
        self._rng = rng
        self._rng_calls = 0
        self._device = device
        self._key = key

    @property
    def model(self) -> Optional[torch.nn.Module]:
        return self.module.model

    def _capturing(self) -> bool:
        return (self._device is not None
                and torch.device(self._device).type == "cuda"
                and torch.cuda.is_current_stream_capturing())

    def make_key(self) -> Key:
        """A fresh keyed draw (ops/random.py ``Key``: ``key.uniform(shape)``,
        ``key.fold_in(...)``) from the step's key and this call's index
        within the step: the counterpart of the JAX ``make_rng``, which
        splits the step's key.  Graph-safe: its draws read the key words
        from device memory, so a graphed chunk draws each step's own
        numbers, and a remat recompute the same ones.  The numbers differ
        from ``jax.random``'s; tests that compare the two packages hand
        both the same draws."""
        if self._key is None:
            if self._rng is None:
                raise RuntimeError(
                    "No PRNG key available in this step context.")
            if self._capturing():
                raise RuntimeError(
                    "make_key inside a CUDA graph capture needs the step's "
                    "key from the chunk's static input (core/steps.py "
                    "ChunkRunner passes it)")
            self._key = torch.from_numpy(key_words(*self._rng)).to(
                self._device or "cpu")
        key = Key(self._key, (self._rng_calls,))
        self._rng_calls += 1
        return key

    def make_rng(self) -> torch.Generator:
        """A fresh ``torch.Generator`` on the step's device, seeded from
        the step's entropy and this call's index within the step.  It
        never touches the global RNG state.  Eager steps only: a CUDA
        graph would replay one seed, so inside a graphed chunk this
        raises; draw through :meth:`make_key` there."""
        if self._rng is None:
            raise RuntimeError("No PRNG key available in this step context.")
        if self._capturing():
            raise NotImplementedError(
                "make_rng inside a graphed chunk (steps_per_execution > 1 "
                "on the card): a torch.Generator's seed would be frozen in "
                "the graph; draw through ctx.make_key() (ops/random.py "
                "Key.uniform), which reads each step's key on the device")
        words = (*self._rng, self._rng_calls)
        self._rng_calls += 1
        seed = int(np.random.SeedSequence(words).generate_state(
            1, np.uint64)[0])
        return torch.Generator(device=self._device or "cpu").manual_seed(seed)

    def dropout_seed(self, rate: float) -> "Key | None":
        """The key of one forward's dropout masks (ops/attention.py
        ``dropout``): ``None``, no dropout, outside training or at rate
        0 (flax's ``deterministic``), else a :meth:`make_key` key."""
        if not self.training or rate <= 0:
            return None
        return self.make_key()

    def log(self, name: str, value, **_ignored) -> None:
        if isinstance(value, torch.Tensor):
            value = value.detach().float()
        else:
            value = torch.tensor(float(value))
        self._logged[name] = value

    def log_dict(self, metrics: Mapping[str, Any], **_ignored) -> None:
        for k, v in metrics.items():
            self.log(k, v)

    @property
    def logged(self) -> "dict[str, torch.Tensor]":
        return dict(self._logged)


class _HParams(dict):
    """Attribute-accessible hyperparameter dict (PL ``hparams`` analog)."""

    def __getattr__(self, item):
        try:
            return self[item]
        except KeyError as e:
            raise AttributeError(item) from e

    def __setattr__(self, key, value):
        self[key] = value


class LightningModule:
    """Base class for user models (``pl.LightningModule`` analog).

    Subclasses implement ``configure_model(device) -> torch.nn.Module``,
    ``configure_optimizers()`` (ops/optim.py), ``training_step(ctx,
    batch) -> loss`` and optionally ``validation_step`` / ``test_step``
    / ``predict_step``, the dataloader hooks and the checkpoint hooks.
    For serving they may override ``configure_decode_model(device)``.
    Unlike flax modules, a ``torch.nn.Module`` carries its own
    parameters, so the hooks take the device to make them on (``None``:
    the card) and ``init_params`` initializes the model in place from an
    explicit ``torch.Generator`` and returns its ``state_dict``.
    """

    #: residency dtype for float params (``None`` = leave as
    #: initialized, fp32); with an ``ops.optim.fp32_master`` optimizer
    param_dtype: Optional[torch.dtype] = None

    def __init__(self):
        self.trainer = None
        self.model: Optional[torch.nn.Module] = None
        self._hparams = _HParams()

    # -- hyperparameters ---------------------------------------------------

    def save_hyperparameters(self, *args, **kwargs) -> None:
        """Record the calling constructor's arguments into ``self.hparams``
        (the named ones, or all of them when none is named)."""
        local_vars = inspect.currentframe().f_back.f_locals
        if args or kwargs:
            for a in args:
                if isinstance(a, dict):
                    self._hparams.update(a)
                elif isinstance(a, str) and a in local_vars:
                    self._hparams[a] = local_vars[a]
            self._hparams.update(kwargs)
            return
        for name in inspect.signature(type(self).__init__).parameters:
            if name not in ("self", "args", "kwargs") and name in local_vars:
                self._hparams[name] = copy.deepcopy(local_vars[name])

    @property
    def hparams(self) -> _HParams:
        return self._hparams

    # -- model / optimizer configuration -----------------------------------

    def configure_model(self, device=None) -> Optional[torch.nn.Module]:
        """Return the model (``None`` for raw-param workflows)."""
        return None

    def configure_optimizers(self):
        raise NotImplementedError

    def configure_decode_model(self,
                               device=None) -> Optional[torch.nn.Module]:
        """Serve-plane hook: a module for the KV-cache generation path
        with this module's parameter names.  Its
        ``hidden_with_kv(tokens)`` returns the pre-head representation
        and every layer's ``(k, v)`` (the prefill), ``decode(tokens,
        positions, k_caches, v_caches)`` one step over the slot cache
        (see models/gpt.py).
        Default: the training model."""
        return self.configure_model(device)

    def configure_draft(self, layers: "int | None" = None, device=None
                        ) -> Optional[torch.nn.Module]:
        """Speculative-decode hook (serve/engine.py): a smaller sibling of
        the decode model — fewer layers, the same tokenizer and
        parameter names — whose parameters are a subset of the decode
        model's by name, so the engine shares the target's tensors with
        it.  It needs the decode model's ``hidden_with_kv`` and
        ``decode`` surface.  ``layers`` overrides the draft depth
        (``RLT_SPEC_DRAFT_LAYERS`` through ``SpecConfig``).  Default:
        ``None`` — no draft, and the engine refuses ``spec=`` rather than
        serve without speculation (models/gpt.py has the layer-cut
        reference)."""
        return None

    def setup_model(self, device=None) -> None:
        """Materialize ``self.model`` on ``device`` (idempotent)."""
        if self.model is None:
            self.model = self.configure_model(device)

    def init_params(self, generator: torch.Generator) -> dict:
        """Initialize ``self.model`` in place from ``generator`` (its
        ``init_weights``; the generator lives on the model's device) and
        return its ``state_dict``.  The override point for loading given
        weights instead (the parity tests load converted JAX inits)."""
        self.setup_model(generator.device)
        if self.model is None:
            raise NotImplementedError(
                "Provide configure_model() or override init_params().")
        self.model.init_weights(generator)
        return self.model.state_dict()

    # -- steps --------------------------------------------------------------

    def training_step(self, ctx: StepContext, batch) -> torch.Tensor:
        raise NotImplementedError

    def validation_step(self, ctx: StepContext, batch):
        return None

    def test_step(self, ctx: StepContext, batch):
        return self.validation_step(ctx, batch)

    def predict_step(self, ctx: StepContext, batch):
        """The model's output on the batch's inputs (its first entry for
        an (inputs, target) tuple)."""
        if self.model is None:
            raise NotImplementedError
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        return ctx.model(x)

    # -- data ---------------------------------------------------------------

    def prepare_data(self) -> None:
        """Download / materialize data once (host-side hook)."""

    def setup(self, stage: str) -> None:
        """Setup before dataloaders are requested."""

    def train_dataloader(self):
        return None

    def val_dataloader(self):
        return None

    def test_dataloader(self):
        return None

    def predict_dataloader(self):
        return None

    # -- host-side hooks ------------------------------------------------------

    def on_fit_start(self) -> None: ...
    def on_fit_end(self) -> None: ...
    def on_train_start(self) -> None: ...
    def on_train_end(self) -> None: ...
    def on_train_epoch_start(self) -> None: ...
    def on_train_epoch_end(self) -> None: ...
    def on_validation_epoch_start(self) -> None: ...
    def on_validation_epoch_end(self) -> None: ...
    def on_save_checkpoint(self, checkpoint: dict) -> None: ...

    def on_load_checkpoint(self, checkpoint: dict) -> None:
        """``checkpoint`` is the dict of ``Trainer.dump_checkpoint``
        (epoch, global_step, state, hparams, callbacks, world_size,
        strategy), after the trainer restored it."""

    # -- trainer-delegated conveniences ---------------------------------------

    @property
    def current_epoch(self) -> int:
        return self.trainer.current_epoch if self.trainer is not None else 0

    @property
    def global_step(self) -> int:
        return self.trainer.global_step if self.trainer is not None else 0

    def log(self, name: str, value, **kwargs) -> None:
        """Host-side logging from hooks (steps use ``ctx.log``)."""
        if self.trainer is not None:
            self.trainer.log_metric(name, value)


__all__ = ["LightningModule", "StepContext"]
