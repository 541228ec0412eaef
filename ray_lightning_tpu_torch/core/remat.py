"""Remat (activation recomputation) policies for the port's models.

Counterpart of ``ray_lightning_tpu/core/remat.py`` ``policy_object`` and
of ``models/gpt.py`` ``_remat_policy`` (the ``RLT_REMAT_POLICY``
override).  There a policy is a ``jax.checkpoint`` policy handed to
``nn.remat`` around each block; here it is a wrapper that runs one block
under ``torch.utils.checkpoint`` (or ``None``: no wrap), every policy
but "full" and "off" a selective checkpoint
(``create_selective_checkpoint_contexts``) whose policy function sees
each dispatcher op the block runs:

- ``"off"``: no wrap (``everything_saveable``);
- ``"dots"``: save the output of every matrix product (``mm``,
  ``addmm``, ``bmm``, ``baddbmm`` and the einsums and linears that lower
  to them), recompute the rest (``dots_saveable``);
- ``"dots_no_batch"``: save only the products without batch dims
  (``mm``, ``addmm``: a linear over ``[B, T, C]`` folds to one), so the
  plain attention's and the MoE layer's batched products are recomputed
  (``dots_with_no_batch_dims_saveable``);
- ``"dots_moe_act"`` / ``"dots_moe"``: ``"dots"`` plus the named MoE
  intermediates ``moe_hact`` / ``moe_hact``, ``moe_dispatch``,
  ``moe_combine`` (``save_from_both_policies`` with
  ``save_only_these_names``).  A name reaches the policy through
  :func:`checkpoint_name`, the custom op ``rlt::checkpoint_name``;
- ``"full"``: save nothing inside the block (jax's default policy,
  ``None``): ``checkpoint(block, x, use_reentrant=False)``.

The attention kernels are custom ops (``rlt::flash_fwd``,
ops/flash_attention.py), not products: every policy but "off" recomputes
them in the backward pass, as ``jax.checkpoint``'s dots policies
recompute a ``pallas_call``.  Neither policy stashes the RNG state: a
block's draws are keyed (ops/random.py), so the recompute draws them
again bit for bit.

The planner's side (``LightningModule.configure_remat()``, plan/): a
:class:`RematSpec` names a module's ladder, its default, an ``apply``
that reconfigures it in place and a ``probe`` that prices one policy
(:class:`RematProbe`) from the example batch's shapes alone.  The probe
primitives trace one block over fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``: no storage, no
launch; every custom op has its ``register_fake``):

- :func:`saved_activation_bytes`: the bytes a policy keeps alive from
  the forward to the backward that the block *computes*: the tensors
  autograd saves (``torch.autograd.graph.saved_tensors_hooks``) plus,
  under a selective checkpoint, the op outputs its policy function
  marks ``MUST_SAVE`` (the checkpoint caches them outside autograd's
  saved tensors), each storage once; tensors sharing a storage with an
  argument (a parameter, a transposed weight, the block input) are left
  out, as the JAX probe leaves out ``"argument"`` residuals;
- :func:`grad_dot_flops` / :func:`step_dot_flops`: matrix-product
  flops only (``mm``, ``addmm``, ``bmm``, ``baddbmm``: the einsums and
  linears lower to them) over forward plus backward, counted by
  ``torch.utils.flop_counter.FlopCounterMode``.  As the JAX count walks
  ``dot_general`` and never a ``pallas_call``, no flop formula is
  registered for ``rlt::flash_fwd`` / ``rlt::flash_bwd``: on the card
  the probe traces the flash route and its attention counts zero, on
  the CPU the plain attention's batched products count.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

#: the JAX package's policy ladder (no recompute -> max recompute) and
#: its MoE save lists: every name a config may carry
POLICY_LADDER = ("off", "dots", "dots_no_batch", "full")
MOE_POLICIES = ("dots_moe_act", "dots_moe")

_aten = torch.ops.aten
#: matrix products without batch dims, and those with
_NO_BATCH_DOTS = frozenset({_aten.mm.default, _aten.addmm.default,
                            _aten.mv.default, _aten.addmv.default,
                            _aten.dot.default})
_BATCH_DOTS = frozenset({_aten.bmm.default, _aten.baddbmm.default})
#: the named intermediates each MoE save list adds to "dots"
MOE_NAMES = {"dots_moe_act": ("moe_hact",),
             "dots_moe": ("moe_hact", "moe_dispatch", "moe_combine")}


@torch.library.custom_op("rlt::checkpoint_name", mutates_args=())
def CHECKPOINT_NAME_OP(x: torch.Tensor, name: str) -> torch.Tensor:
    """``rlt::checkpoint_name``: a copy of ``x`` that carries ``name`` to
    a selective-checkpoint policy (a custom op may not return its
    input)."""
    return x.clone()


@CHECKPOINT_NAME_OP.register_fake
def _(x, name):
    return x.new_empty(x.shape)


def _name_setup(ctx, inputs, output):
    pass


CHECKPOINT_NAME_OP.register_autograd(lambda ctx, grad: (grad, None),
                                     setup_context=_name_setup)


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``jax.ad_checkpoint.checkpoint_name``: ``x``, tagged for the MoE
    save lists (callers tag only under those policies: the tag is a
    copy)."""
    return CHECKPOINT_NAME_OP(x, name)


def save_policy(name: str) -> Optional[Callable]:
    """The selective-checkpoint policy function of a policy name
    (``(ctx, op, *args, **kwargs) -> CheckpointPolicy``): ``MUST_SAVE``
    for the products and tags the policy keeps, ``PREFER_RECOMPUTE`` for
    every other op; ``None`` for "off" and "full", which need none.
    Raises ``ValueError`` for an unknown name."""
    if name in ("off", "full"):
        return None
    if name == "dots_no_batch":
        dots, names = _NO_BATCH_DOTS, ()
    elif name == "dots" or name in MOE_NAMES:
        dots, names = _NO_BATCH_DOTS | _BATCH_DOTS, MOE_NAMES.get(name, ())
    else:
        raise ValueError(f"remat_policy {name!r}; options: "
                         f"{sorted(POLICY_LADDER + MOE_POLICIES)}")

    def policy(ctx, op, *args, **kwargs):
        if op in dots or (op is torch.ops.rlt.checkpoint_name.default
                          and args[1] in names):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def policy_object(name: str) -> Optional[Callable]:
    """The block wrapper for a policy name: ``None`` for ``"off"``, else
    a ``(fn, *args) -> out`` running ``fn`` under a non-reentrant
    checkpoint ("full") or a selective one with :func:`save_policy`'s
    function (the rest; module docstring).  The RNG state is not stashed
    for the recompute: a block's draws are keyed (ops/random.py
    ``Key``), so the recompute draws them again bit for bit.  Raises
    ``ValueError`` for an unknown name."""
    if name == "off":
        return None
    policy = save_policy(name)
    context = {} if policy is None else {
        "context_fn": functools.partial(
            create_selective_checkpoint_contexts, policy)}
    return functools.partial(checkpoint, use_reentrant=False,
                             preserve_rng_state=False, **context)


def model_policy(remat: bool, remat_policy: str) -> str:
    """The policy a model build uses: ``"off"`` without remat, else
    ``RLT_REMAT_POLICY`` when set, else the config's ``remat_policy``
    (``_remat_policy`` of the JAX GPT)."""
    if not remat:
        return "off"
    return os.environ.get("RLT_REMAT_POLICY") or remat_policy


@dataclasses.dataclass(frozen=True)
class RematProbe:
    """One policy's modeled cost ingredients at the probe batch size
    (plan/cost.py rescales linearly to the candidate's per-device
    batch)."""

    saved_bytes: int        #: computed bytes kept across ALL blocks
    recompute_flops: int    #: extra backward product flops vs no remat
    n_blocks: int           #: remat region count (per-region overhead)
    batch: int              #: probe leading batch dim (rescale anchor)


@dataclasses.dataclass(frozen=True)
class RematSpec:
    """What ``configure_remat()`` returns: the module's remat surface.

    ``apply(policy)`` reconfigures the module the spec was made from in
    place (drops its materialized model); ``probe(policy, batch)``
    prices a policy from the example batch's shapes alone."""

    policies: tuple           #: supported policy names, ladder-ordered
    default: str              #: the module's current effective policy
    apply: Callable           #: (policy: str) -> None, in place
    probe: Callable           #: (policy: str, batch) -> RematProbe


# -- probe primitives ------------------------------------------------------

#: the matrix products the flop probes count (the einsums and linears
#: lower to these)
DOT_OPS = ("mm", "addmm", "bmm", "baddbmm")


def probe_device() -> torch.device:
    """The device the probes' fake tensors claim: the card when there is
    one (the flash route, as the step runs there), else the CPU (the
    plain attention)."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def fake_mode():
    """A fresh ``FakeTensorMode`` for one probe (shapes and dtypes only;
    tensors made inside have no storage)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def _mode_of(args) -> "contextlib.AbstractContextManager":
    from torch._guards import detect_fake_mode
    mode = detect_fake_mode(tuple(a for a in args
                                  if isinstance(a, torch.Tensor)))
    return mode if mode is not None else contextlib.nullcontext()


def _wrapped(fn: Callable, policy: str) -> Callable:
    wrap = policy_object(policy)
    return fn if wrap is None else functools.partial(wrap, fn)


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Kept:
    """Records, over one forward, every computed storage kept for the
    backward: autograd's saved tensors and the selective checkpoint's
    cached outputs (module docstring)."""

    def __init__(self, args, policy: str):
        self.skip = {_storage_key(a) for a in args
                     if isinstance(a, torch.Tensor)}
        self.kept: "dict[int, int]" = {}
        self.select = save_policy(policy)

    def note(self, t) -> None:
        if isinstance(t, torch.Tensor):
            key = _storage_key(t)
            if key not in self.skip:
                self.kept[key] = t.untyped_storage().nbytes()

    def pack(self, t):
        self.note(t)
        return t

    def mode(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        kept = self

        class _Record(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if kept.select is not None and kept.select(
                        None, func, *args, **(kwargs or {})) \
                        is CheckpointPolicy.MUST_SAVE:
                    for t in (out if isinstance(out, (tuple, list))
                              else (out,)):
                        kept.note(t)
                return out

        return _Record()


def saved_activation_bytes(fn: Callable, *args, policy: str = "off") -> int:
    """Bytes ``fn(*args)`` keeps for its backward under ``policy`` that
    it computes (module docstring).  ``args`` are fake tensors (the
    block's parameters and its input); this only traces."""
    kept = _Kept(args, policy)
    with _mode_of(args), torch.enable_grad(), kept.mode(), \
            torch.autograd.graph.saved_tensors_hooks(kept.pack,
                                                     lambda t: t):
        _wrapped(fn, policy)(*args)
    return int(sum(kept.kept.values()))


def _dot_flops(counter) -> int:
    counts = counter.get_flop_counts().get("Global", {})
    return int(sum(n for op, n in counts.items()
                   if getattr(op, "_opname", str(op)).split(".")[-1]
                   in DOT_OPS))


def _float_leaves(out) -> list:
    from ray_lightning_tpu_torch.core.steps import tree_leaves
    return [t for t in tree_leaves(out)
            if t is not None and t.is_floating_point()]


def grad_dot_flops(fn: Callable, *args, policy: str = "off") -> int:
    """Product flops of ``fn``'s forward and its full backward (grads
    of the summed float outputs wrt every float argument) under
    ``policy``; the policy-minus-"off" difference is the product work
    the policy recomputes.  Pure tracing over fake ``args``."""
    from torch.utils.flop_counter import FlopCounterMode
    with _mode_of(args), torch.enable_grad(), \
            FlopCounterMode(display=False) as counter:
        leaves = _float_leaves(_wrapped(fn, policy)(*args))
        total = functools.reduce(torch.add, [t.float().sum()
                                             for t in leaves])
        # backward(), not autograd.grad: the counter's module tracker
        # hooks the graph's leaves, which autograd.grad refuses
        total.backward()
    for a in args:
        if isinstance(a, torch.Tensor):
            a.grad = None
    return _dot_flops(counter)


def step_dot_flops(fn: Callable, *args) -> int:
    """Product flops of ``fn``'s own run, for programs that contain
    their backward already (a built train step)."""
    from torch.utils.flop_counter import FlopCounterMode
    with _mode_of(args), FlopCounterMode(display=False) as counter:
        fn(*args)
    return _dot_flops(counter)


def block_cost(fn: Callable, *args, policy: str,
               base_flops: "int | None" = None) -> "tuple[int, int]":
    """(kept computed bytes of ``fn`` under ``policy``, extra backward
    product flops vs "off").  Pass ``base_flops`` (one
    :func:`grad_dot_flops` under "off") when pricing several policies
    of the same block."""
    if base_flops is None:
        base_flops = grad_dot_flops(fn, *args)
    saved = saved_activation_bytes(fn, *args, policy=policy)
    extra = 0 if policy == "off" else max(
        0, grad_dot_flops(fn, *args, policy=policy) - base_flops)
    return saved, extra


def batch_dims(batch) -> "tuple[int, int]":
    """(B, T) of an LM example batch (its first leaf)."""
    x = batch[0] if isinstance(batch, (tuple, list)) else batch
    return int(x.shape[0]), int(x.shape[1])


def ladder_spec(module, policies: tuple, block_probe: Callable
                ) -> RematSpec:
    """The :class:`RematSpec` of a module whose config carries ``remat``
    and ``remat_policy`` (GPT, BERT, ``PipelinedGPT``): ``apply`` folds
    a policy into ``module.config`` ("off" turns the wrap off) and drops
    the materialized model, which the next ``setup_model`` makes with
    the policy; ``probe`` runs ``block_probe(policy, B, T) -> (saved,
    flops, n_blocks)``."""

    def apply(policy: str) -> None:
        if policy not in policies:
            raise ValueError(f"remat policy {policy!r}; this config's "
                             f"ladder: {list(policies)}")
        cfg = module.config
        module.config = dataclasses.replace(
            cfg, remat=(policy != "off"),
            remat_policy=(policy if policy != "off" else cfg.remat_policy))
        module.model = None

    def probe(policy: str, batch) -> RematProbe:
        B, T = batch_dims(batch)
        saved, flops, n = block_probe(policy, B, T)
        return RematProbe(saved_bytes=int(saved), recompute_flops=int(flops),
                          n_blocks=int(n), batch=B)

    cfg = module.config
    return RematSpec(policies=tuple(policies),
                     default=(cfg.remat_policy if cfg.remat else "off"),
                     apply=apply, probe=probe)


def probe_blocks(make_block: Callable, kinds, policy: str, B: int, T: int,
                 width: int, dtype: torch.dtype,
                 param_dtype: "torch.dtype | None",
                 base_cache: "dict | None" = None) -> "tuple[int, int]":
    """Sum of :func:`block_cost` over block kinds: ``kinds`` is a list of
    ``(count, kind)``; ``make_block(kind, policy)`` builds one block
    (under the fake mode, on :func:`probe_device`) and returns it with
    the function of ``h`` that runs it.  ``base_cache`` keeps each
    kind's "off" flops across policies."""
    saved = flops = 0
    dev = probe_device()
    for count, kind in kinds:
        if count == 0:
            continue
        with fake_mode():
            with torch.device(dev):
                blk, run = make_block(kind, policy)
                if param_dtype is not None:
                    # as the step's params are resident (a fake tensor
                    # takes no in-place swap, so each is replaced)
                    for mod in blk.modules():
                        for name, p in list(mod._parameters.items()):
                            if p is not None and p.is_floating_point():
                                mod._parameters[name] = torch.nn.Parameter(
                                    p.detach().to(param_dtype))
                h = torch.empty(B, T, width, dtype=dtype,
                                requires_grad=True)
            args = [*blk.parameters(), h]

            def fn(*a, _run=run):
                return _run(a[-1])

            key = (kind, B, T, str(dev))
            base = None if base_cache is None else base_cache.get(key)
            if base is None:
                base = grad_dot_flops(fn, *args)
                if base_cache is not None:
                    base_cache[key] = base
            s, f = block_cost(fn, *args, policy=policy, base_flops=base)
        saved += count * s
        flops += count * f
    return saved, flops


__all__ = ["CHECKPOINT_NAME_OP", "DOT_OPS", "MOE_NAMES", "MOE_POLICIES",
           "POLICY_LADDER", "RematProbe", "RematSpec", "batch_dims",
           "block_cost", "checkpoint_name", "fake_mode", "grad_dot_flops",
           "ladder_spec", "model_policy", "policy_object", "probe_blocks",
           "probe_device", "saved_activation_bytes", "save_policy",
           "step_dot_flops"]
