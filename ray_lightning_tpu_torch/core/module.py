"""``LightningModule`` base: the serve hooks of the JAX package's
``core/module.py`` (configure_model / configure_decode_model /
setup_model / init_params).  The training hooks are a later slice."""

from __future__ import annotations

from typing import Optional

import torch


class LightningModule:
    """Base class for user models (``pl.LightningModule`` analog).

    Subclasses implement ``configure_model(device) -> torch.nn.Module``
    and, for serving, may override ``configure_decode_model(device)``.
    Unlike flax modules, a ``torch.nn.Module`` carries its own
    parameters, so the hooks take the device to make them on (``None``:
    the card) and ``init_params`` initializes the model in place from an
    explicit ``torch.Generator`` and returns its ``state_dict``.
    """

    #: residency dtype for float params (``None`` = leave as
    #: initialized, fp32)
    param_dtype: Optional[torch.dtype] = None

    def __init__(self):
        self.model: Optional[torch.nn.Module] = None

    def configure_model(self, device=None) -> Optional[torch.nn.Module]:
        """Return the model (``None`` for raw-param workflows)."""
        return None

    def configure_decode_model(self,
                               device=None) -> Optional[torch.nn.Module]:
        """Serve-plane hook: a module for the KV-cache generation path
        with this module's parameter names.  Its ``hidden(tokens)``
        returns the pre-head representation and every layer's ``(k,
        v)`` (the prefill), ``decode(tokens, positions, k_caches,
        v_caches)`` one step over the slot cache (see models/gpt.py).
        Default: the training model."""
        return self.configure_model(device)

    def setup_model(self, device=None) -> None:
        """Materialize ``self.model`` on ``device`` (idempotent)."""
        if self.model is None:
            self.model = self.configure_model(device)

    def init_params(self, generator: torch.Generator) -> dict:
        """Initialize ``self.model`` in place from ``generator`` (its
        ``init_weights``; the generator lives on the model's device) and
        return its ``state_dict``."""
        self.setup_model(generator.device)
        if self.model is None:
            raise NotImplementedError(
                "Provide configure_model() or override init_params().")
        self.model.init_weights(generator)
        return self.model.state_dict()


__all__ = ["LightningModule"]
