"""Step builders: init, train and eval steps; the serve prefill and
decode programs.

Counterpart of ``ray_lightning_tpu/core/steps.py`` ``build_init_fn`` /
``build_train_step`` (the ``grad_sync=None`` path) / ``build_eval_step``
/ ``build_prefill_step`` / ``build_decode_step``.  A torch module holds
its own parameters, so the builders close over the model (the JAX
builders take the params as an argument of the jitted program) and the
train step updates them IN PLACE where the JAX program returns new ones;
PyTorch runs eagerly, so there is nothing to trace or compile.  The
serve caches are updated in place too, where the JAX programs return new
caches from donated buffers.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ray_lightning_tpu_torch.core.module import StepContext
from ray_lightning_tpu_torch.core.state import TrainState


def build_init_fn(module, tx) -> Callable:
    """``generator -> TrainState``: initialize the module's model in
    place (``module.init_params``, on the generator's device), let the
    optimizer snapshot its state (an ``fp32_master`` its fp32 master)
    from the full-precision init, and only then cast the float params to
    ``module.param_dtype``, as the JAX init does."""

    def init_fn(generator: torch.Generator) -> TrainState:
        module.init_params(generator)
        opt_state = tx.init(dict(module.model.named_parameters()))
        pd = getattr(module, "param_dtype", None)
        if pd is not None:
            module.model.to(dtype=pd)      # casts the floating params only
        return TrainState(step=0, opt_state=opt_state, generator=generator)

    return init_fn


def _split_loss(out) -> "tuple[torch.Tensor, dict]":
    if isinstance(out, dict):
        if "loss" not in out:
            raise ValueError("training_step dict output must contain 'loss'")
        extra = {k: v.detach().float() for k, v in out.items()
                 if k != "loss"}
        return out["loss"], extra
    return out, {}


def build_train_step(module, tx, accumulate_grad_batches: int = 1
                     ) -> Callable:
    """``(state, batch) -> (state, metrics)``: one optimizer step.

    With ``accumulate_grad_batches=k`` the batch's leading dim splits
    into k microbatches whose gradients are summed in fp32 (whatever the
    params' dtype: k bf16 additions would lose the low bits the
    optimizer needs) and averaged; the loss and logged metrics are the
    microbatch means.  With k=1 the gradients keep the params' dtype
    (bf16 for bf16-resident params) and the optimizer upcasts them.
    ``metrics`` holds detached fp32 tensors on the device.
    """
    k = max(1, int(accumulate_grad_batches))

    def grads_of(params, batch):
        ctx = StepContext(module, training=True)
        loss, extra = _split_loss(module.training_step(ctx, batch))
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach().float(), {**ctx.logged, **extra}, grads

    def micro(x, i):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        if x.shape[0] % k:
            raise ValueError(f"Batch size {x.shape[0]} must be divisible "
                             f"by accumulate_grad_batches={k}")
        n = x.shape[0] // k
        return x[i * n:(i + 1) * n]

    def step_fn(state: TrainState, batch: Any):
        params = dict(module.model.named_parameters())
        if k == 1:
            loss, logged, grads = grads_of(params, batch)
        else:
            acc = [torch.zeros_like(p, dtype=torch.float32)
                   for p in params.values()]
            losses, logs = [], []
            for i in range(k):
                mb = (type(batch)(micro(x, i) for x in batch)
                      if isinstance(batch, (tuple, list))
                      else micro(batch, i))
                loss_i, logged_i, grads_i = grads_of(params, mb)
                torch._foreach_add_(acc, [g.float() for g in grads_i])
                losses.append(loss_i)
                logs.append(logged_i)
            grads = torch._foreach_div(acc, k)
            loss = torch.stack(losses).mean()
            logged = {n: torch.stack([d[n] for d in logs]).mean()
                      for n in logs[0]}
        tx.update(dict(zip(params, grads)), state.opt_state, params)
        state.step += 1
        return state, {"loss": loss, **logged}

    return step_fn


def build_eval_step(module, stage: str) -> Callable:
    """``(state, batch) -> logged metrics`` for ``validate`` / ``test``,
    under ``torch.no_grad()``.  A bare returned scalar with nothing
    logged surfaces as ``val_loss`` / ``test_loss``."""
    step = {"validate": module.validation_step,
            "test": module.test_step}[stage]

    @torch.no_grad()
    def step_fn(state: TrainState, batch: Any):
        ctx = StepContext(module, training=False)
        out = step(ctx, batch)
        logged = ctx.logged
        if out is not None and not isinstance(out, dict) and not logged:
            logged = {"val_loss" if stage == "validate" else "test_loss":
                      torch.as_tensor(out).float()}
        elif isinstance(out, dict):
            logged = {**logged, **{n: torch.as_tensor(v).float()
                                   for n, v in out.items()}}
        return logged

    return step_fn


def build_prefill_step(model: torch.nn.Module,
                       bucket_len: int) -> Callable:
    """Prefill for ONE sequence-length bucket.

    ``(k_caches, v_caches, tokens, slot, length) -> first_token``:
    ``tokens`` [1, bucket_len] (right-padded) long on the model's
    device; ``slot``/``length`` python ints.  Runs the whole-sequence
    forward, takes the greedy token at ``length - 1`` and writes every
    layer's K/V block into rows ``[0, bucket_len)`` of ``slot``.  Rows
    ``>= length`` hold pad garbage that the causal mask keeps out of the
    first token and ``cached_attention``'s position bound out of every
    later one.  Returns a 0-d long tensor (not yet synced).
    """
    def step_fn(k_caches, v_caches, tokens, slot: int, length: int):
        if tokens.shape != (1, bucket_len):
            raise ValueError(f"prefill_{bucket_len} takes tokens "
                             f"[1, {bucket_len}], got {tuple(tokens.shape)}")
        x, kvs = model.hidden(tokens)
        # only row length-1 feeds the first token: no [T, V] logits
        logits = model.head(x[0, length - 1])
        for i, (k, v) in enumerate(kvs):
            k_caches[i, slot, :bucket_len] = k[0]
            v_caches[i, slot, :bucket_len] = v[0]
        return torch.argmax(logits, dim=-1)

    return step_fn


def build_decode_step(model: torch.nn.Module,
                      impl: "str | None" = None) -> Callable:
    """Continuous-batching decode: THE serving hot path.

    ``(k_caches, v_caches, tokens, positions) -> next_tokens``: advances
    every slot one token; ``tokens``/``positions`` [S] int32 on the
    model's device, caches [n_layer, S, L, H, D] written in place.
    ``impl`` is the decode attention (``dense`` | ``flash_decode``,
    ops/flash_decode.py ``resolve_decode_impl``).  Returns [S] long
    (not yet synced).
    """
    def step_fn(k_caches, v_caches, tokens, positions):
        logits = model.decode(tokens, positions, k_caches, v_caches,
                              impl=impl)
        return torch.argmax(logits, dim=-1)

    return step_fn


__all__ = ["build_decode_step", "build_eval_step", "build_init_fn",
           "build_prefill_step", "build_train_step"]
