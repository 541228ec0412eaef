"""AdamW with a linear warmup or a constant rate, the fp32 master for
low-precision resident params, SGD with optional (Nesterov) momentum,
weight decay as a gradient map, and clipping by the global norm.

Counterpart of the JAX package's optimizers: ``optax.adamw(
linear_schedule(0, lr, warmup), b1=0.9, b2=0.95, weight_decay,
mu_dtype=bf16)`` (models/gpt.py ``configure_optimizers``) wrapped in
``ops/optim.py`` ``fp32_master``, and ``optax.adamw(lr,
weight_decay=0.01)`` (models/bert.py ``BertMLMModule``: a constant rate,
b2 = 0.999, an fp32 first moment).  ``torch.optim.AdamW`` cannot hold a
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
   so under the warmup step 0 has lr 0 and moves nothing but the
   moments; without one, ``u *= -lr``;
4. ``p += u``.

With the fp32 master (:class:`fp32_master`) ``p`` is the master, which
sits in the optimizer state, and after each step the resident params
are set to ``master.to(their dtype)``: the end state of the JAX delta
trick (``optim.py:25-33``) without the trick.  Updates run in place
under ``torch.no_grad()``, on the params and on the state's own
tensors (a state never rebinds a tensor), so a CUDA graph that captured
a step (core/steps.py) updates the live state when it replays;
parameters and state are keyed by parameter name
(``model.named_parameters()``).

The count-dependent scalars (``-lr`` and the bias corrections) are
computed on the host in float32 from the host ``count``
(:meth:`AdamW.host_scalars`) and read by the update from a small device
tensor (``scalars``): the eager step builds it, a graphed chunk writes
the k steps' rows into its static copy before each replay, so both run
the same kernels on the same values.  ``update`` advances the host
count by one; :meth:`AdamW.advance` moves it by n (a replay runs n
steps without Python).

``clip_by_global_norm`` and :class:`chain` are ``optax.clip_by_global_
norm`` chained ahead of the optimizer, as ``Trainer(gradient_clip_val=
...)`` wraps it; ``SGD`` is ``optax.sgd(lr, momentum, nesterov)`` and
``add_decayed_weights`` optax's gradient map of that name (the ResNet
optimizer, models/resnet.py, is ``chain(add_decayed_weights(1e-4),
SGD(lr, momentum=0.9, nesterov=True))``).  Every state has a
``state_dict()`` of plain containers (ints and dicts of tensors, keyed
as the optax state's fields) and a ``load_state_dict`` that takes the
loaded tensors as they are, in their saved dtypes: the checkpoint
(core/trainer.py) holds no pickled class.
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

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(self.mu),
                "nu": dict(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.mu = _same_keys(self.mu, state["mu"], "mu")
        self.nu = _same_keys(self.nu, state["nu"], "nu")


@dataclasses.dataclass
class FP32MasterState:
    """State of :class:`fp32_master`: the inner optimizer's state and the
    fp32 master copy of the params, keyed by parameter name."""

    inner: AdamWState
    master: "dict[str, torch.Tensor]"

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "master": dict(self.master)}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.master = _same_keys(self.master, state["master"], "master")


@dataclasses.dataclass
class EmptyState:
    """``optax.EmptyState``: the state of a stateless transform."""

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        if state:
            raise ValueError(f"EmptyState takes no entries: {sorted(state)}")


@dataclasses.dataclass
class ChainState:
    """The state of :class:`chain`: one per transform, keyed ``"0"``,
    ``"1"``, ... as flax keys optax's tuple."""

    states: tuple

    def state_dict(self) -> dict:
        return {str(i): s.state_dict() for i, s in enumerate(self.states)}

    def load_state_dict(self, state: dict) -> None:
        if sorted(state) != [str(i) for i in range(len(self.states))]:
            raise ValueError(f"chain of {len(self.states)} transforms; "
                             f"the state has {sorted(state)}")
        for i, s in enumerate(self.states):
            s.load_state_dict(state[str(i)])


def _same_keys(live: Mapping, saved: Mapping, what: str) -> dict:
    """``saved`` as a dict, after checking it names the live tensors."""
    if set(live) != set(saved):
        raise ValueError(
            f"{what}: the saved state names other parameters (missing "
            f"{sorted(set(live) - set(saved))[:4]}, unexpected "
            f"{sorted(set(saved) - set(live))[:4]})")
    return dict(saved)


def _rounded(value: float, dtype: torch.dtype) -> float:
    return torch.tensor(value, dtype=dtype).item()


def device_scalars(values: np.ndarray, device: torch.device
                   ) -> torch.Tensor:
    """``values`` (float32, from the host) as a tensor on ``device``: on
    the card sent from pinned memory without a wait (the pinned block is
    not reused until the copy ends); under a fake-tensor mode (the
    planner's verify step) a plain copy, as nothing is pinned there."""
    t = torch.from_numpy(np.ascontiguousarray(values, np.float32))
    if device.type != "cuda":
        return t
    if torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is not None:
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


_NO_SCALARS = np.zeros(0, np.float32)


class AdamW:
    """``optax.adamw`` (module docstring).  With ``warmup_steps`` the rate
    is ``linear_schedule(0, lr, warmup_steps)``, as optax takes a
    schedule: ``warmup_steps=0`` is then the constant 0.0, which trains
    nothing, as in optax.  Without it the rate is the constant ``lr``, as
    optax takes a float.  ``mu_dtype=None`` keeps the first moment in
    fp32."""

    def __init__(self, lr: float, *, warmup_steps: Optional[int] = None,
                 weight_decay: float, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8,
                 mu_dtype: Optional[torch.dtype] = None):
        self.schedule = (linear_schedule(0.0, lr, warmup_steps)
                         if warmup_steps is not None
                         else lambda count: lr)
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

    def host_scalars(self, state: AdamWState, ahead: int = 0
                     ) -> np.ndarray:
        """``[-lr, 1 - b1^t, 1 - b2^t]`` in float32 for the step ``ahead``
        steps past ``state.count`` (``lr`` at that count, ``t`` one past
        it), in optax's float32 arithmetic."""
        count = state.count + ahead
        t = np.float32(count + 1)
        return np.array(
            [float(-self.schedule(count)),
             np.float32(1) - np.float32(self.b1) ** t,
             np.float32(1) - np.float32(self.b2) ** t], np.float32)

    def advance(self, state: AdamWState, n: int) -> None:
        state.count += n

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamWState,
               params: Mapping[str, torch.Tensor],
               scalars: "torch.Tensor | None" = None) -> None:
        """One step in place on ``params`` (fp32) and ``state`` from fp32
        ``grads``; ``scalars`` is :meth:`host_scalars` on the params'
        device (``None``: made here from the host count)."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        if scalars is None:
            scalars = device_scalars(self.host_scalars(state), p[0].device)
        neg_lr, bc1, bc2 = scalars.unbind()
        b1, b2 = self.b1, self.b2

        new_mu = torch._foreach_mul(g, 1 - b1)
        torch._foreach_add_(new_mu, [
            m * _rounded(b1, m.dtype) for m in mu])      # in mu's dtype
        # nu in place: b2 nu + (1 - b2) g^2, the same sum as optax's
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(g, g), 1 - b2))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(torch._foreach_div(new_mu, bc1), denom)
        torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(u, neg_lr)
        torch._foreach_add_(p, u)
        torch._foreach_copy_(mu, new_mu)        # cast to mu's dtype
        self.advance(state, 1)


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

    def host_scalars(self, state: FP32MasterState, ahead: int = 0
                     ) -> np.ndarray:
        return self.inner.host_scalars(state.inner, ahead)

    def advance(self, state: FP32MasterState, n: int) -> None:
        self.inner.advance(state.inner, n)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor],
               state: FP32MasterState,
               params: Mapping[str, torch.Tensor],
               scalars: "torch.Tensor | None" = None) -> None:
        g32 = {k: g.float() for k, g in grads.items()}
        self.inner.update(g32, state.inner, state.master, scalars)
        for k, p in params.items():
            p.copy_(state.master[k])                 # master.to(p.dtype)


@dataclasses.dataclass
class TraceState:
    """``optax.TraceState``: :class:`SGD`'s momentum buffer, keyed by
    parameter name."""

    trace: "dict[str, torch.Tensor]"

    def state_dict(self) -> dict:
        return {"trace": dict(self.trace)}

    def load_state_dict(self, state: dict) -> None:
        self.trace = _same_keys(self.trace, state["trace"], "trace")


class SGD:
    """``optax.sgd(lr, momentum, nesterov)``: ``optax.trace(momentum,
    nesterov)`` then the scale by ``-lr``.  With a momentum ``m`` and the
    old trace ``t``, the new trace is ``g + m t`` and the update ``u`` is
    that trace, or ``g + m (g + m t)`` with ``nesterov``; without one
    ``u = g`` and the state is empty.  Then ``p += u * -lr`` (the update
    rounded before the add, as ``apply_updates`` adds it).  The trace
    keeps the params' dtype."""

    def __init__(self, lr: float, momentum: Optional[float] = None,
                 nesterov: bool = False):
        self.lr = lr
        self.momentum = momentum
        self.nesterov = nesterov

    def init(self, params: Mapping[str, torch.Tensor]
             ) -> "EmptyState | TraceState":
        if self.momentum is None:
            return EmptyState()
        return TraceState({k: torch.zeros_like(p)
                           for k, p in params.items()})

    def host_scalars(self, state, ahead: int = 0) -> np.ndarray:
        """None: the rate is constant."""
        return _NO_SCALARS

    def advance(self, state, n: int) -> None:
        pass

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor],
               state: "EmptyState | TraceState",
               params: Mapping[str, torch.Tensor],
               scalars: "torch.Tensor | None" = None) -> None:
        names = list(params)
        u = [grads[k] for k in names]
        if self.momentum is not None:
            m = self.momentum
            # the trace in place: m t + g, the same sum as g + m t
            trace = [state.trace[k] for k in names]
            torch._foreach_mul_(trace, m)
            torch._foreach_add_(trace, u)
            if self.nesterov:
                u = torch._foreach_add(u, torch._foreach_mul(trace, m))
            else:
                u = trace
        torch._foreach_add_([params[k] for k in names],
                            torch._foreach_mul(u, -self.lr))


class add_decayed_weights:  # noqa: N801 - named as the optax transform
    """``optax.add_decayed_weights(weight_decay)``: each gradient becomes
    ``g + weight_decay * p``.  Stateless; its :meth:`update` returns the
    new gradients, so it sits ahead of the optimizer in a
    :class:`chain`."""

    def __init__(self, weight_decay: float):
        self.weight_decay = weight_decay

    def init(self, params: Mapping[str, torch.Tensor]) -> EmptyState:
        return EmptyState()

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: EmptyState,
               params: Mapping[str, torch.Tensor]
               ) -> "dict[str, torch.Tensor]":
        names = list(grads)
        return dict(zip(names, torch._foreach_add(
            [grads[k] for k in names],
            torch._foreach_mul([params[k] for k in names],
                               self.weight_decay))))


class clip_by_global_norm:  # noqa: N801 - named as the optax transform
    """``optax.clip_by_global_norm(max_norm)``: with ``norm`` the square
    root of the sum over tensors of ``sum(g * g)``, computed in the
    gradients' dtype, each gradient becomes ``g`` where ``norm <
    max_norm``, else ``(g / norm) * max_norm``.  Stateless; its
    :meth:`update` returns the clipped gradients."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def init(self, params: Mapping[str, torch.Tensor]) -> EmptyState:
        return EmptyState()

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: EmptyState,
               params=None) -> "dict[str, torch.Tensor]":
        # python's sum from 0, as optax's: the first tensor's square sum
        # in its dtype, then each next one added in the promoted dtype
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        trigger = norm < self.max_norm
        return {k: torch.where(trigger, g,
                               (g / norm.to(g.dtype)) * self.max_norm)
                for k, g in grads.items()}


class chain:  # noqa: N801 - named as optax.chain
    """``optax.chain(*transforms)`` for the shape the ``Trainer`` builds:
    every transform but the last maps the gradients (its ``update``
    returns new ones, as :class:`clip_by_global_norm`'s and
    :class:`add_decayed_weights`' do), the last applies them to the
    params in place (a nested chain as its last transform included).  So the clip sees the gradients
    in their own dtype, before ``fp32_master`` upcasts them, as in the
    JAX package."""

    def __init__(self, *transforms):
        if not transforms:
            raise ValueError("chain needs at least one transform")
        self.transforms = transforms

    def init(self, params: Mapping[str, torch.Tensor]) -> ChainState:
        return ChainState(tuple(t.init(params) for t in self.transforms))

    def host_scalars(self, state: ChainState, ahead: int = 0
                     ) -> np.ndarray:
        """The last transform's (the maps have none)."""
        return self.transforms[-1].host_scalars(state.states[-1], ahead)

    def advance(self, state: ChainState, n: int) -> None:
        self.transforms[-1].advance(state.states[-1], n)

    def update(self, grads: Mapping[str, torch.Tensor], state: ChainState,
               params: Mapping[str, torch.Tensor],
               scalars: "torch.Tensor | None" = None) -> None:
        *maps, last = self.transforms
        for t, s in zip(maps, state.states):
            grads = t.update(grads, s, params)
        last.update(grads, state.states[-1], params, scalars)


__all__ = ["AdamW", "AdamWState", "ChainState", "EmptyState",
           "FP32MasterState", "SGD", "TraceState", "add_decayed_weights",
           "chain", "clip_by_global_norm", "device_scalars", "fp32_master",
           "linear_schedule"]
