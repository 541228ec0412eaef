"""Step builders: init, train, eval and predict steps; the serve programs
(prefill, decode, the paged KV copy and suffix step, the speculative
draft and verify).

Counterpart of ``ray_lightning_tpu/core/steps.py`` ``build_init_fn`` /
``build_train_step`` (the ``grad_sync=None`` path) / ``build_eval_step``
/ ``build_predict_step`` / ``build_prefill_step`` / ``build_decode_step``
/ ``build_kv_copy`` / ``build_suffix_step`` / ``build_draft_step`` /
``build_verify_step``.  A torch module holds its own parameters, so the
builders close over the model (the JAX builders take the params as an
argument of the jitted program) and the train step updates them IN
PLACE where the JAX program returns new ones;
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

    def grads_of(params, batch, rng, device):
        ctx = StepContext(module, training=True, rng=rng, device=device)
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
        # the step's entropy: the seed, the step, the microbatch (the JAX
        # step folds the step and the microbatch index into its key)
        seed, dev = state.generator.initial_seed(), state.generator.device
        if k == 1:
            loss, logged, grads = grads_of(params, batch,
                                           (seed, state.step, 0), dev)
        else:
            acc = [torch.zeros_like(p, dtype=torch.float32)
                   for p in params.values()]
            losses, logs = [], []
            for i in range(k):
                mb = (type(batch)(micro(x, i) for x in batch)
                      if isinstance(batch, (tuple, list))
                      else micro(batch, i))
                loss_i, logged_i, grads_i = grads_of(
                    params, mb, (seed, state.step, i), dev)
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


def build_predict_step(module) -> Callable:
    """``(state, batch) -> module.predict_step(ctx, batch)`` under
    ``torch.no_grad()``, with no entropy (as the JAX predict step has no
    key): a forward only."""

    @torch.no_grad()
    def step_fn(state: TrainState, batch: Any):
        return module.predict_step(StepContext(module, training=False),
                                   batch)

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
        x, kvs = model.hidden_with_kv(tokens)
        # only row length-1 feeds the first token: no [T, V] logits
        logits = model.head(x[0, length - 1])
        for i, (k, v) in enumerate(kvs):
            k_caches[i, slot, :bucket_len] = k[0]
            v_caches[i, slot, :bucket_len] = v[0]
        return torch.argmax(logits, dim=-1)

    return step_fn


def build_decode_step(model: torch.nn.Module,
                      impl: "str | None" = None,
                      page_table: "torch.Tensor | None" = None) -> Callable:
    """Continuous-batching decode: THE serving hot path.

    ``(k_caches, v_caches, tokens, positions) -> next_tokens``: advances
    every slot one token; ``tokens``/``positions`` [S] int32 on the
    model's device, caches [n_layer, S, L, H, D] written in place.
    ``impl`` is the decode attention (``dense`` | ``flash_decode`` |
    ``paged``, ops/flash_decode.py ``resolve_decode_impl``);
    ``page_table`` ([S, L / page_size] int32 on the device,
    serve/fleet/pages.py ``identity_page_table``) is what the paged
    kernel walks.  Returns [S] long (not yet synced).
    """
    def step_fn(k_caches, v_caches, tokens, positions):
        logits = model.decode(tokens, positions, k_caches, v_caches,
                              impl=impl, page_table=page_table)
        return torch.argmax(logits, dim=-1)

    return step_fn


def build_draft_step(model: torch.nn.Module, k: int,
                     impl: "str | None" = None,
                     page_table: "torch.Tensor | None" = None) -> Callable:
    """Speculative-decode draft: ``k`` greedy decode steps of the DRAFT
    model over its own KV cache.

    ``(dk_caches, dv_caches, tokens, positions) -> drafts``:
    ``tokens``/``positions`` [S] are each slot's last emitted token at
    its position (the plain decode inputs); ``drafts`` [S, k] long (not
    yet synced).  Each step writes its row of the draft cache and feeds
    its argmax forward; a row past the cache end is dropped (an idle
    slot's dummy row at ``L - 1`` plus the step).  Rows drafted past the
    accepted prefix are masked and overwritten by the next round, which
    restarts at the corrected position.

    One forward more than the JAX program: the k-th draft's own row
    (position ``pos + k``) is written too, its logits unused.  When a
    round accepts all k drafts the next one starts at ``pos + k + 1``,
    and the JAX draft cache holds a stale row at ``pos + k`` there, so
    even a draft identical to the target can disagree; here the draft
    cache always holds the accepted stream.  The drafts themselves are
    the JAX program's, and the emitted tokens are the target's either
    way.
    """
    def step_fn(dk_caches, dv_caches, tokens, positions):
        toks, pos, drafts = tokens, positions, []
        for i in range(k + 1):
            logits = model.decode(toks, pos, dk_caches, dv_caches,
                                  impl=impl, page_table=page_table,
                                  drop_past_end=True)
            if i == k:
                break
            toks = torch.argmax(logits, dim=-1).to(tokens.dtype)
            pos = pos + 1
            drafts.append(toks)
        return torch.stack(drafts, dim=1)

    return step_fn


def build_verify_step(model: torch.nn.Module, impl: "str | None" = None,
                      page_table: "torch.Tensor | None" = None
                      ) -> Callable:
    """Speculative-decode verify: ONE batched target forward over the k
    drafted positions per slot.

    ``(k_caches, v_caches, tokens, positions) -> argmaxes`` with
    ``tokens``/``positions`` [S, k+1] — per slot the last emitted token
    and its k drafts at consecutive positions; ``argmaxes`` [S, k+1]
    long: column j is the token the target emits after the prefix
    extended by drafts ``1..j``.  The scheduler accepts the longest
    agreeing prefix plus one corrected token (serve/scheduler.py), so
    the output equals target-only greedy decode.  Rides
    ``GPT.verify``'s multi-query cached attention: the decode kernels
    and per-query masks of the plain path, k+1 launches a layer.
    """
    def step_fn(k_caches, v_caches, tokens, positions):
        logits = model.verify(tokens, positions, k_caches, v_caches,
                              impl=impl, page_table=page_table)
        return torch.argmax(logits, dim=-1)

    return step_fn


def build_kv_copy() -> Callable:
    """Paged-KV copy (serve/fleet/pages.py prefix reuse).

    ``(k_caches, v_caches, src, dst, length)`` copies cache rows
    ``[0, length)`` of slot ``src`` into slot ``dst`` in every layer, in
    place: the device half of a prefix-cache hit, the matched pages
    moved instead of recomputed.  Sound because a cache row is a pure
    per-(token, position) value: identical prefixes have identical rows
    wherever they were computed.
    """
    def copy_fn(k_caches, v_caches, src: int, dst: int, length: int):
        for c in (k_caches, v_caches):
            c[:, dst, :length].copy_(c[:, src, :length])

    return copy_fn


def build_suffix_step(model: torch.nn.Module, impl: "str | None" = None,
                      page_table: "torch.Tensor | None" = None
                      ) -> Callable:
    """Single-slot suffix step (the compute leg of prefix reuse).

    ``(k_caches, v_caches, token, pos, slot) -> next_token``: advances
    ONE slot one token through the decode forward on the one-slot slice
    of the cache (a view, written in place).  After a prefix-cache hit
    copies the matched pages (:func:`build_kv_copy`), the unmatched
    suffix is teacher-forced through this step one token at a time.  It
    writes nothing outside ``slot``, so it needs no dispatch-order
    contract.  ``page_table`` is the ONE-slot table
    (``identity_page_table(1, L, page_size)``): the slice's pages are
    slice-relative, the same for every slot.  Returns a 0-d long tensor
    (not yet synced).
    """
    def step_fn(k_caches, v_caches, token, pos, slot: int):
        logits = model.decode(token.reshape(1), pos.reshape(1),
                              k_caches[:, slot:slot + 1],
                              v_caches[:, slot:slot + 1], impl=impl,
                              page_table=page_table)
        return torch.argmax(logits[0], dim=-1)

    return step_fn


__all__ = ["build_decode_step", "build_draft_step", "build_eval_step",
           "build_init_fn", "build_kv_copy", "build_predict_step",
           "build_prefill_step", "build_suffix_step", "build_train_step",
           "build_verify_step"]
