"""AdamW with a linear warmup, and the fp32 master for low-precision
resident params.

Counterpart of the JAX package's optimizer: ``optax.adamw(
linear_schedule(0, lr, warmup), b1=0.9, b2=0.95, weight_decay,
mu_dtype=bf16)`` (models/gpt.py ``configure_optimizers``) wrapped in
``ops/optim.py`` ``fp32_master``.  ``torch.optim.AdamW`` cannot hold a
bf16 first moment beside an fp32 second moment and applies the decay
before the moments, so the port carries its own, as functions over
lists of tensors (``torch._foreach_*``), in optax's op order:

1. ``scale_by_adam``: ``mu = (1 - b1) g + b1 mu`` (``b1 mu`` in mu's
   dtype, as JAX rounds the weak scalar and the product to it), ``nu =
   (1 - b2) g^2 + b2 nu``; ``count += 1``; ``mu_hat = mu / (1 - b1^count)``
   from the fp32 ``mu`` before its cast back to ``mu_dtype``, ``nu_hat``
   alike; ``u = mu_hat / (sqrt(nu_hat) + eps)``;
2. ``add_decayed_weights``: ``u += weight_decay * p`` on every parameter;
3. ``scale_by_learning_rate``: ``u *= -lr(count before the increment)``,
   so step 0 has lr 0 and moves nothing but the moments;
4. ``p += u``.

With the fp32 master (:class:`fp32_master`) ``p`` is the master, which
sits in the optimizer state, and after each step the resident params
are set to ``master.to(their dtype)``: the end state of the JAX delta
trick (``optim.py:25-33``) without the trick.  Updates run in place
under ``torch.no_grad()``; parameters and state are keyed by parameter
name (``model.named_parameters()``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int):
    """``optax.linear_schedule``: ``count -> lr`` as an fp32 number; a
    non-positive ``transition_steps`` gives the constant
    ``init_value``."""
    if transition_steps <= 0:
        return lambda count: np.float32(init_value)

    def schedule(count: int) -> np.float32:
        c = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1) - c / np.float32(transition_steps)
        return (np.float32(init_value - end_value) * frac
                + np.float32(end_value))

    return schedule


@dataclasses.dataclass
class AdamWState:
    """``ScaleByAdamState`` + the schedule's count (the two advance
    together): moments keyed by parameter name."""

    count: int
    mu: "dict[str, torch.Tensor]"
    nu: "dict[str, torch.Tensor]"


@dataclasses.dataclass
class FP32MasterState:
    """State of :class:`fp32_master`: the inner optimizer's state and the
    fp32 master copy of the params, keyed by parameter name."""

    inner: AdamWState
    master: "dict[str, torch.Tensor]"


def _rounded(value: float, dtype: torch.dtype) -> float:
    return torch.tensor(value, dtype=dtype).item()


class AdamW:
    """``optax.adamw`` over a linear warmup schedule (module docstring).
    ``mu_dtype=None`` keeps the first moment in fp32."""

    def __init__(self, lr: float, *, warmup_steps: int,
                 weight_decay: float, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8,
                 mu_dtype: Optional[torch.dtype] = None):
        self.schedule = linear_schedule(0.0, lr, warmup_steps)
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu_dtype = mu_dtype

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        mu_dtype = self.mu_dtype
        return AdamWState(
            count=0,
            mu={k: torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamWState,
               params: Mapping[str, torch.Tensor]) -> None:
        """One step in place on ``params`` (fp32) and ``state`` from fp32
        ``grads``."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        lr = self.schedule(state.count)
        count = state.count + 1
        b1, b2 = self.b1, self.b2

        new_mu = torch._foreach_mul(g, 1 - b1)
        torch._foreach_add_(new_mu, [
            m * _rounded(b1, m.dtype) for m in mu])      # in mu's dtype
        new_nu = torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2)
        torch._foreach_add_(new_nu, torch._foreach_mul(nu, b2))
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        denom = torch._foreach_sqrt(torch._foreach_div(new_nu, bc2))
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(torch._foreach_div(new_mu, bc1), denom)
        torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(u, float(-lr))
        torch._foreach_add_(p, u)

        for k, m, n in zip(names, new_mu, new_nu):
            state.mu[k] = m.to(state.mu[k].dtype)
            state.nu[k] = n
        state.count = count


class fp32_master:  # noqa: N801 - named as the JAX package's transform
    """Wrap ``inner`` to run against an fp32 master copy of the params
    (for bf16-resident params, ``LightningModule.param_dtype``), held in
    the state; the resident params are set to the master cast to their
    dtype."""

    def __init__(self, inner: AdamW):
        self.inner = inner

    def init(self, params: Mapping[str, torch.Tensor]) -> FP32MasterState:
        master = {k: p.detach().float().clone() for k, p in params.items()}
        return FP32MasterState(inner=self.inner.init(master), master=master)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor],
               state: FP32MasterState,
               params: Mapping[str, torch.Tensor]) -> None:
        g32 = {k: g.float() for k, g in grads.items()}
        self.inner.update(g32, state.inner, state.master)
        for k, p in params.items():
            p.copy_(state.master[k])                 # master.to(p.dtype)


__all__ = ["AdamW", "AdamWState", "FP32MasterState", "fp32_master",
           "linear_schedule"]
