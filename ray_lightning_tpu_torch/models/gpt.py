"""GPT-style decoder LM in PyTorch: the serve and training paths' model.

Counterpart of ``ray_lightning_tpu/models/gpt.py`` (``GPTConfig``,
``CONFIGS``, ``MLP``, ``Block``, ``GPT.hidden`` / ``__call__`` /
``decode`` / ``verify``, ``synthetic_lm_dataset``,
``GPTLightningModule``'s serve, speculative-draft and training hooks).  Parameter names map
one to one onto the flax tree (``convert.flax_to_torch``): ``wte``,
``wpe``, ``h.{i}.ln1|attn.qkv|attn.proj|ln2|mlp.fc|mlp.out``, ``ln_f``.

Numerics follow the flax modules the JAX package uses, so both packages
agree on the same weights:

- ``LayerNorm``: eps 1e-6, statistics in fp32 (E[x^2] - E[x]^2), the
  normalized value cast to the compute dtype;
- ``gelu``: the tanh approximation (flax ``nn.gelu`` default), computed
  as ``jax.nn.gelu`` does: constants rounded to the compute dtype and
  every operation rounded to it (:func:`gelu_tanh`);
- linear layers cast weight and input to the compute dtype;
- logits are the compute-dtype product with the tied embedding, then
  fp32; ``wpe`` rows are cast to the compute dtype before the add;
- dropout (``config.dropout``, training only) after each block's
  attention output projection and after its MLP, as flax's
  ``nn.Dropout`` (ops/attention.py ``dropout``), its keyed masks
  (ops/random.py) folded per layer and site from the forward's
  ``dropout_seed``;
- with ``n_experts > 0`` every ``moe_every``-th block's MLP is a routed
  ``MoEMLP`` (ops/moe.py, parameters ``h.{i}.moe.router|w1|w2``), whose
  load-balance losses the forward sums into ``GPT.moe_aux``.

Under a sharded strategy (parallel/layout.py) every use site takes its
parameter through ``gathered`` (the pieces on batch axes all-gathered),
and under :func:`gpt_partition_rules` on a ``tensor`` axis over 1 the
training forward is Megatron's (parallel/tensor.py): the vocab-parallel
``wte`` lookup and tied loss, column-parallel ``qkv`` / ``fc`` (and the
routed ``w1``), row-parallel ``proj`` / ``out`` (and ``w2``).  The serve
paths (the prefill ``hidden_with_kv``, ``decode``, ``verify`` and the
draft's decode) are the same on this rank's ``n_head / tp`` heads: the
vocab-parallel lookup, the attention on its heads of the KV cache, and
the tied head's vocab-split logits gathered along the vocab in rank
order into the whole fp32 ``[S, V]`` before any argmax, so a tie goes
to the lowest id as on one rank.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_lightning_tpu_torch._device import resolve_device
from ray_lightning_tpu_torch.core.data import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.core.module import LightningModule
from ray_lightning_tpu_torch.core.remat import (MOE_POLICIES, model_policy,
                                                policy_object)
from ray_lightning_tpu_torch.ops.attention import (CacheWrite,
                                                   MultiHeadAttention,
                                                   column_linear, dropout,
                                                   fold_in, row_linear)
from ray_lightning_tpu_torch.ops.losses import (
    chunked_softmax_cross_entropy, fused_lm_cross_entropy)
from ray_lightning_tpu_torch.ops.moe import (MoEMLP, moe_partition_rules,
                                             total_aux_loss)
from ray_lightning_tpu_torch.ops.optim import AdamW, fp32_master
from ray_lightning_tpu_torch.parallel.layout import gathered
from ray_lightning_tpu_torch.parallel.mesh import all_gather_along
from ray_lightning_tpu_torch.parallel.strategy import P
from ray_lightning_tpu_torch.parallel.tensor import (copy_to, gather_from,
                                                     mean_from, vocab_embed)


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """The JAX package's config, same fields and defaults.  The serve
    path rejects MoE."""

    vocab_size: int = 50304
    block_size: int = 256
    n_layer: int = 4
    n_head: int = 4
    n_embd: int = 256
    dropout: float = 0.0
    remat: bool = True
    remat_policy: str = "full"
    dtype: torch.dtype = torch.bfloat16   # compute dtype
    # "auto" | "dot" | "flash" (ops/attention.py resolve_attention)
    attention_impl: str = "auto"
    chunked_ce: int = 0
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_every: int = 2
    moe_aux_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


CONFIGS = {
    "tiny": GPTConfig(vocab_size=512, block_size=64, n_layer=2, n_head=2,
                      n_embd=64, remat=False),
    "gpt2-small": GPTConfig(block_size=1024, n_layer=12, n_head=12,
                            n_embd=768, remat=False),
    "gpt2-medium": GPTConfig(block_size=1024, n_layer=24, n_head=16,
                             n_embd=1024, remat_policy="dots"),
    "gpt2-1p3b": GPTConfig(block_size=2048, n_layer=24, n_head=32,
                           n_embd=2048, chunked_ce=16),
    "moe-tiny": GPTConfig(vocab_size=512, block_size=64, n_layer=2,
                          n_head=2, n_embd=64, remat=False, n_experts=4),
    "gpt2-moe-8e": GPTConfig(block_size=1024, n_layer=12, n_head=12,
                             n_embd=768, n_experts=8,
                             remat_policy="dots"),
}


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)``: eps 1e-6, fp32 statistics and
    affine, output in the compute dtype."""

    def __init__(self, n: int, dtype: torch.dtype, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x):
        # one fused kernel in fp32: the statistics agree with flax's to
        # fp32 rounding (it computes E[x^2] - E[x]^2, torch Welford)
        w, b = gathered(self.weight), gathered(self.bias)
        return F.layer_norm(x.float(), w.shape, w.float(), b.float(),
                            self.eps).to(self.dtype)


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float (exact)."""
    return torch.tensor(value, dtype=dtype).item()


def gelu_tanh(x):
    """``jax.nn.gelu(x, approximate=True)`` op for op: the constants
    sqrt(2/pi) and 0.044715 rounded to ``x``'s dtype, each product and
    sum rounded to it.  In bf16 this matches the JAX package bit for bit
    where ``F.gelu(approximate="tanh")``, which rounds once, differs by
    an ulp on ~40% of the elements."""
    c0 = _rounded(0.044715, x.dtype)
    c1 = _rounded(math.sqrt(2.0 / math.pi), x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c1 * (x + c0 * (x * x * x)))))


@torch.no_grad()
def init_weights(model: nn.Module, embeddings, generator: torch.Generator
                 ) -> None:
    """Seeded init of ``model`` in place, drawn from ``generator`` (which
    must live on the parameters' device): ``embeddings`` N(0, 0.02),
    linear kernels flax's lecun_normal (truncated normal, variance
    1/fan_in), biases 0, LayerNorm scale 1, routed MLPs their own
    (``MoEMLP.init_weights``).  The numbers differ from ``jax.random``'s;
    tests that compare the two packages convert the JAX weights
    instead."""
    for p in embeddings:
        p.copy_(torch.randn(p.shape, generator=generator,
                            device=p.device) * 0.02)
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            fan_in = mod.weight.shape[1]
            # variance_scaling(1, fan_in, truncated_normal): the stddev
            # of a unit normal truncated to [-2, 2]
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            w = torch.empty(mod.weight.shape, device=mod.weight.device)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
            mod.weight.copy_(w * std)
            mod.bias.zero_()
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, MoEMLP):
            mod.init_weights(generator)


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.dropout = cfg.dropout
        self.fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd)
        self.out = nn.Linear(4 * cfg.n_embd, cfg.n_embd)
        #: the tensor-parallel group (``fc`` column-, ``out`` row-parallel)
        self.tp = None
        #: the sequence group (the dropout masks' slice)
        self.sp = None

    def forward(self, x, dropout_seed: "int | None" = None):
        h = gelu_tanh(column_linear(self.fc, x, self.dtype, self.tp))
        return dropout(row_linear(self.out, h, self.dtype, self.tp),
                       self.dropout, dropout_seed, self.sp)


class Block(nn.Module):
    """A pre-LN block: attention, then the MLP, or with ``use_moe`` the
    routed ``moe`` (ops/moe.py; no dropout inside, as in the JAX
    package).  ``tag_names``: the MoE layer tags its intermediates for a
    MoE remat save list."""

    def __init__(self, cfg: GPTConfig, use_moe: bool = False,
                 tag_names: bool = False):
        super().__init__()
        self.ln1 = LayerNorm(cfg.n_embd, cfg.dtype)
        self.attn = MultiHeadAttention(cfg.n_embd, cfg.n_head, causal=True,
                                       dtype=cfg.dtype,
                                       attention_impl=cfg.attention_impl,
                                       dropout=cfg.dropout)
        self.ln2 = LayerNorm(cfg.n_embd, cfg.dtype)
        if use_moe:
            self.moe = MoEMLP(cfg.n_embd, cfg.n_experts, 4 * cfg.n_embd,
                              cfg.moe_top_k, cfg.moe_capacity_factor,
                              cfg.dtype, tag_names)
        else:
            self.mlp = MLP(cfg)

    def forward(self, x, dropout_seed=None):
        return self.forward_with_kv(x, dropout_seed)[0]

    def train_forward(self, x, dropout_seed=None):
        """``(x', aux)``: the block's output and its routed layer's
        load-balance loss (``None`` for a dense block)."""
        return self._forward(x, dropout_seed)[::2]

    def forward_with_kv(self, x, dropout_seed=None):
        """Returns ``(x', (k, v))``: the layer's K/V for the prefill."""
        return self._forward(x, dropout_seed)[:2]

    def _forward(self, x, dropout_seed):
        """``(x', (k, v), aux)``.  ``dropout_seed`` (training: an
        ops/random.py ``Key``, or an int) seeds the attention's and the
        MLP's dropout masks, sites 0 and 1."""
        a, kv = self.attn(self.ln1(x), fold_in(dropout_seed, 0))
        x = x + a
        if hasattr(self, "moe"):
            h, aux = self.moe(self.ln2(x))
            return x + h, kv, aux
        return x + self.mlp(self.ln2(x), fold_in(dropout_seed, 1)), kv, None

    def decode(self, x, k_cache, v_cache, positions, impl=None,
               page_table=None, write=None):
        x = x + self.attn.decode(self.ln1(x), k_cache, v_cache, positions,
                                 impl, page_table, write)
        return x + self.mlp(self.ln2(x))


class GPT(nn.Module):
    """Decoder-only transformer.  ``hidden`` -> pre-head representation,
    ``hidden_with_kv`` -> that and every layer's K/V (the prefill),
    ``forward`` -> fp32 logits, ``decode`` -> one continuous-batching
    step over the slot cache, ``verify`` -> the speculative verify's
    multi-token step.  Dropout runs in :meth:`hidden` when it is given a
    seed (training); the serve paths run without it, and the decode
    model is made with it off (``configure_decode_model``).

    With ``config.remat`` each block of ``hidden`` runs under the remat
    policy (core/remat.py: ``RLT_REMAT_POLICY``, else
    ``config.remat_policy``) whenever autograd records, as ``nn.remat``
    wraps each block in the JAX package.  The checkpointed function
    returns the block's output and its load-balance loss alone: its K/V
    are views of the fused qkv projection, and returning them would keep
    every layer's qkv alive through the backward pass.  With
    ``config.n_experts > 0`` block i is routed when ``i % moe_every ==
    moe_every - 1``; ``moe_aux`` holds the last forward's summed
    load-balance loss (ops/moe.py ``total_aux_loss``).

    The parameters are made on ``device``: the card unless the caller
    asks for the CPU (``device="cpu"``); without CUDA the default
    raises.  ``tp`` is the tensor-parallel group a sharded layout sets
    (module docstring); ``tensor_parallel_dims`` names what it splits."""

    #: its use sites gather sharded parameters (parallel/layout.py)
    shardable = True

    def __init__(self, config: GPTConfig,
                 device: "str | torch.device | None" = None):
        super().__init__()
        self.config = config
        self.remat_policy = model_policy(config.remat, config.remat_policy)
        self._remat = policy_object(self.remat_policy)
        self.moe_aux: "torch.Tensor | None" = None
        self.tp = None
        #: the sequence group (positions, the loss's mean, predict)
        self.sp = None
        tag = self.remat_policy in MOE_POLICIES
        with torch.device(resolve_device(device)):
            self.wte = nn.Embedding(config.vocab_size, config.n_embd)
            self.wpe = nn.Parameter(torch.zeros(config.block_size,
                                                config.n_embd))
            self.h = nn.ModuleList(
                Block(config, config.n_experts > 0
                      and i % config.moe_every == config.moe_every - 1, tag)
                for i in range(config.n_layer))
            self.ln_f = LayerNorm(config.n_embd, config.dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init in place (:func:`init_weights`): ``wte`` and
        ``wpe`` N(0, 0.02)."""
        init_weights(self, (self.wte.weight, self.wpe), generator)

    def tensor_parallel_dims(self) -> "dict[str, int]":
        """The parameters the tensor-parallel forward computes on in
        pieces, each with its split dim in the flax layout (the dims
        :func:`gpt_partition_rules` names)."""
        out = {"wte.weight": 0}
        for i, blk in enumerate(self.h):
            out.update({f"h.{i}.attn.qkv.weight": 1,
                        f"h.{i}.attn.proj.weight": 0})
            if hasattr(blk, "moe"):
                out.update({f"h.{i}.moe.w1": 2, f"h.{i}.moe.w2": 1})
            else:
                out.update({f"h.{i}.mlp.fc.weight": 1,
                            f"h.{i}.mlp.out.weight": 0})
        return out

    def table(self) -> torch.Tensor:
        """The tied embedding as its use sites take it (gathered when
        sharded on a batch axis; this rank's vocab rows under tensor
        parallelism)."""
        return gathered(self.wte.weight)

    def head(self, x, table: "torch.Tensor | None" = None):
        """fp32 logits from the tied embedding (compute-dtype product),
        over the whole vocab (gathered over the tensor group)."""
        dt = self.config.dtype
        table = self.table() if table is None else table
        x = copy_to(x, self.tp)
        return gather_from((x.to(dt) @ table.to(dt).t()).float(), self.tp)

    def _embed(self, idx, table: "torch.Tensor | None" = None):
        """The token and position embeddings; on a ``sequence`` axis over
        1 ``idx`` is this rank's slice of the sequence, so its positions
        start at ``rank * T_local``."""
        dt = self.config.dtype
        T = idx.shape[1]
        start = 0 if self.sp is None else self.sp.rank * T
        table = self.table() if table is None else table
        return vocab_embed(table, idx, dt, self.tp) \
            + gathered(self.wpe)[start:start + T].to(dt)

    def hidden(self, idx, dropout_seed: "int | None" = None):
        """Pre-head representation ``[B, T, C]`` in the compute dtype;
        each block under the remat policy while autograd records.
        ``dropout_seed`` (``StepContext.dropout_seed``; ``None``: no
        dropout) seeds layer i's masks with ``fold_in(seed, i)``, a
        keyed draw's site, so a recomputed block draws them again.  Sets
        ``moe_aux``."""
        return self.hidden_and_table(idx, dropout_seed)[0]

    def hidden_and_table(self, idx, dropout_seed: "int | None" = None):
        """``(hidden, table)``: :meth:`hidden` and the tied table it
        embedded with, for the loss to reuse (one gather a step: the
        embedding's and the head's gradients meet before its
        reduce-scatter, as they meet before DDP's all-reduce)."""
        table = self.table()
        x = self._embed(idx, table)
        remat = self._remat if torch.is_grad_enabled() else None
        aux = []
        for i, blk in enumerate(self.h):
            seed = fold_in(dropout_seed, i)
            x, a = (remat(blk.train_forward, x, seed) if remat is not None
                    else blk.train_forward(x, seed))
            if a is not None:
                aux.append(a)
        # summed left to right, as the JAX total_aux_loss adds its leaves
        self.moe_aux = functools.reduce(torch.add, aux) if aux else None
        return self.ln_f(x), table

    def hidden_with_kv(self, idx, table: "torch.Tensor | None" = None):
        """The prefill's forward: :meth:`hidden` without remat, and every
        layer's ``(k, v)`` [B, T, H, D] (under ``tp`` this rank's
        ``H / tp`` heads); ``table`` is :meth:`table`'s, when the caller
        keeps it for the head (one gather a step under FSDP)."""
        x = self._embed(idx, table)
        kvs = []
        for blk in self.h:
            x, kv = blk.forward_with_kv(x)
            kvs.append(kv)
        return self.ln_f(x), kvs

    def forward(self, idx, dropout_seed: "int | None" = None):
        """Whole-sequence forward: fp32 logits ``[B, T, V]``."""
        return self.head(*self.hidden_and_table(idx, dropout_seed))

    def _pos_embed(self, positions):
        """``wpe`` rows at ``positions`` in the compute dtype.  A draft or
        verify position past the table reads its last row: the JAX
        gather fills NaN there; either way the output it feeds is cut by
        the scheduler's ``max_new`` cap before anything is emitted, and
        its K/V row is past the cache and dropped."""
        idx = positions.long().clamp_max(self.config.block_size - 1)
        return gathered(self.wpe)[idx].to(self.config.dtype)

    def decode(self, tokens, positions, k_caches, v_caches,
               impl: "str | None" = None, page_table=None,
               drop_past_end: bool = False):
        """One decode step over ``S`` slots.

        ``tokens``/``positions`` [S] int32 — each slot's current token
        and its absolute position; ``k_caches``/``v_caches``
        [n_layer, S, L, H, D]; ``impl`` picks the decode attention and
        ``page_table`` ([S, L / page_size] int32 on the device,
        serve/fleet/pages.py) the paged kernel's table
        (ops/attention.py ``cached_attention``).  Writes every slot's K/V
        row in place and returns fp32 logits ``[S, V]``.  With
        ``drop_past_end`` a position past the cache writes nothing, as
        the JAX scatter drops it (the draft step's positions run past
        the end); otherwise positions must lie in the cache.  Shapes do
        not depend on which slots are live: insertion and eviction are
        slot-index changes in the host-side scheduler."""
        dt = self.config.dtype
        table = self.table()        # one gather a step under FSDP
        x = vocab_embed(table, tokens, dt, self.tp)[:, None, :]
        x = x + self._pos_embed(positions)[:, None, :]
        write = CacheWrite(positions, k_caches.shape[2], drop_past_end)
        for i, blk in enumerate(self.h):
            x = blk.decode(x, k_caches[i], v_caches[i], positions, impl,
                           page_table, write)
        return self.head(self.ln_f(x), table)[:, 0]

    def verify(self, tokens, positions, k_caches, v_caches,
               impl: "str | None" = None, page_table=None):
        """Multi-token decode over ``S`` slots: the speculative verify
        forward (core/steps.py ``build_verify_step``).

        ``tokens``/``positions`` [S, T] int32 — per slot the last
        emitted token followed by the k drafted tokens at consecutive
        positions (T = k + 1); caches as in :meth:`decode`.  One batched
        forward writes every query's K/V row (a row past the cache end
        is dropped, as the JAX scatter drops it) and scores each query
        under its own position bound, so the argmax of query j is the
        token plain decode would emit after accepting drafts 1..j.
        Returns fp32 logits ``[S, T, V]``."""
        dt = self.config.dtype
        table = self.table()
        x = vocab_embed(table, tokens, dt, self.tp)
        x = x + self._pos_embed(positions)
        write = CacheWrite(positions, k_caches.shape[2], drop_past_end=True)
        for i, blk in enumerate(self.h):
            x = blk.decode(x, k_caches[i], v_caches[i], positions, impl,
                           page_table, write)
        return self.head(self.ln_f(x), table)


def gpt_partition_rules(tensor_axis: str = "tensor") -> list:
    """``SpmdStrategy`` rules for a (data, [fsdp,] tensor) mesh, the JAX
    function's: Megatron-style ``qkv`` / ``fc`` column-split, ``proj`` /
    ``out`` row-split, the embeddings vocab-split, the routed layers'
    (ops/moe.py ``moe_partition_rules``) first.  The port's forward
    issues the matching collectives itself (module docstring)."""
    return moe_partition_rules(tensor_axis=tensor_axis) + [
        (r"wte/embedding", P(tensor_axis, None)),
        (r"attn/qkv/kernel", P(None, tensor_axis)),
        (r"attn/proj/kernel", P(tensor_axis, None)),
        (r"mlp/fc/kernel", P(None, tensor_axis)),
        (r"mlp/out/kernel", P(tensor_axis, None)),
        # no wpe rule: position embeddings fall through to the fsdp
        # fallback, as in the JAX package
    ]


def synthetic_lm_dataset(n: int, block_size: int, vocab_size: int,
                         seed: int = 0) -> ArrayDataset:
    """Deterministic token sequences with learnable structure (each token
    depends on the previous one), so loss decreases measurably fast: the
    JAX package's generator, draw for draw."""
    rng = np.random.default_rng(seed)
    perm = np.random.default_rng(7).permutation(vocab_size)
    first = rng.integers(0, vocab_size, size=(n, 1))
    seqs = [first]
    for _ in range(block_size):
        # next token = perm[prev] with 10% noise
        nxt = perm[seqs[-1]]
        noise = rng.integers(0, vocab_size, size=(n, 1))
        mask = rng.random((n, 1)) < 0.1
        seqs.append(np.where(mask, noise, nxt))
    toks = np.concatenate(seqs, axis=1).astype(np.int32)
    return ArrayDataset(toks[:, :-1], toks[:, 1:])


class GPTLightningModule(LightningModule):
    """LM module over :class:`GPT`: next-token cross-entropy training and
    the serve hooks."""

    def __init__(self, config: "GPTConfig | str" = "tiny",
                 lr: float = 3e-4, weight_decay: float = 0.01,
                 warmup_steps: int = 10, dataset_size: int = 256,
                 batch_size: int = 8):
        super().__init__()
        if isinstance(config, str):
            config = CONFIGS[config]
        self.config = config
        self.save_hyperparameters("lr", "weight_decay", "batch_size")
        self.lr = lr
        self.weight_decay = weight_decay
        self.warmup_steps = warmup_steps
        self.dataset_size = dataset_size
        self.batch_size = batch_size

    def configure_model(self, device=None):
        """The training model, with its remat policy (core/remat.py) and
        ``config.dropout``."""
        return GPT(self.config, device=device)

    def configure_decode_model(self, device=None):
        """Serve-plane model: the training model's parameter tree with
        dropout and remat off.  MoE configs are rejected: expert routing
        is batch-shaped and has no single-token cache path."""
        if self.config.n_experts > 0:
            raise ValueError(
                "serve decode does not support MoE configs: expert "
                "routing is batch-shaped and has no single-token cache "
                "path yet (models/gpt.py GPT.decode)")
        return GPT(dataclasses.replace(self.config, remat=False,
                                       dropout=0.0), device=device)

    def configure_draft(self, layers: "int | None" = None, device=None):
        """Speculative-decode draft (serve/engine.py): the same
        architecture cut to its first ``layers`` blocks (default
        ``n_layer // 2``).  Its parameter names — ``wte``, ``wpe``,
        ``h.0..h.{layers-1}``, ``ln_f`` — are a subset of the target's,
        so the engine points them at the target's own tensors by path
        and the draft adds no weight memory.  ``device="meta"`` makes it
        without storage for that.  ``layers == n_layer`` is the
        full-clone draft (acceptance 1.0 up to near-ties)."""
        if self.config.n_experts > 0:
            raise ValueError(
                "speculative decode does not support MoE configs: the "
                "draft/verify path rides GPT.decode/verify, which "
                "reject expert routing (configure_decode_model)")
        cfg = self.config
        n = int(layers) if layers else max(1, cfg.n_layer // 2)
        if not 1 <= n <= cfg.n_layer:
            raise ValueError(
                f"draft layers {n} must be in [1, {cfg.n_layer}]")
        return GPT(dataclasses.replace(cfg, n_layer=n, remat=False,
                                       dropout=0.0), device=device)

    def configure_remat(self):
        """The planner's remat surface (core/remat.py, JAX
        ``models/gpt.py:373``): the ladder, plus the MoE save lists when
        the config routes experts; ``apply`` folds a policy into the
        config ("off" drops the wrap) and drops the model; the probe
        prices a policy one block kind at a time (dense and routed),
        over fake tensors at the example batch's shape."""
        from ray_lightning_tpu_torch.core import remat as _rm

        policies = list(_rm.POLICY_LADDER)
        if self.config.n_experts > 0:
            policies += list(_rm.MOE_POLICIES)
        base: dict = {}

        def block_probe(policy: str, B: int, T: int):
            cfg = self.config
            n_moe = sum(1 for i in range(cfg.n_layer)
                        if cfg.n_experts > 0
                        and i % cfg.moe_every == cfg.moe_every - 1)

            def make(use_moe: bool, pol: str):
                blk = Block(cfg, use_moe, pol in _rm.MOE_POLICIES)
                return blk, lambda h: blk.train_forward(h)
            saved, flops = _rm.probe_blocks(
                make, [(cfg.n_layer - n_moe, False), (n_moe, True)],
                policy, B, T, cfg.n_embd, cfg.dtype, self.param_dtype,
                base)
            return saved, flops, cfg.n_layer

        return _rm.ladder_spec(self, tuple(policies), block_probe)

    @property
    def param_dtype(self) -> Optional[torch.dtype]:
        """bf16-resident params unless ``RLT_BF16_PARAMS=0``, as in the
        JAX package."""
        return (torch.bfloat16
                if os.environ.get("RLT_BF16_PARAMS", "1") != "0" else None)

    def configure_optimizers(self):
        """``adamw(linear_schedule(0, lr, warmup_steps), b1=0.9, b2=0.95,
        weight_decay, mu_dtype=bf16)`` (``RLT_BF16_MOMENTS=0`` keeps mu in
        fp32), wrapped in ``fp32_master`` when the params are
        bf16-resident (ops/optim.py)."""
        mu_dtype = (torch.bfloat16
                    if os.environ.get("RLT_BF16_MOMENTS", "1") != "0"
                    else None)
        tx = AdamW(self.lr, warmup_steps=self.warmup_steps,
                   weight_decay=self.weight_decay, b1=0.9, b2=0.95,
                   mu_dtype=mu_dtype)
        if self.param_dtype is not None:
            tx = fp32_master(tx)
        return tx

    def _loss(self, ctx, batch):
        """Fused full-vocab CE by default; the chunked CE when
        ``chunked_ce > 0``; the fp32-logits CE under ``RLT_FUSED_CE=0``
        (ops/losses.py).  On a ``sequence`` axis over 1 each rank's mean
        over its slice is averaged over the sequence ranks
        (parallel/tensor.py ``mean_from``)."""
        x, y = batch
        model = ctx.model
        seed = ctx.dropout_seed(self.config.dropout)
        sp = model.sp
        if sp is not None and self.config.n_experts > 0:
            raise NotImplementedError(
                "a routed (MoE) GPT on a sequence axis: its capacity slots "
                "and load-balance loss count over the whole sequence, "
                "which no rank holds")
        if self.config.chunked_ce > 0:
            h, table = model.hidden_and_table(x, seed)
            return mean_from(chunked_softmax_cross_entropy(
                h, table, y, self.config.chunked_ce, tp=model.tp), sp)
        if os.environ.get("RLT_FUSED_CE", "1") != "0":
            h, table = model.hidden_and_table(x, seed)
            return mean_from(fused_lm_cross_entropy(h, table, y,
                                                    tp=model.tp), sp)
        logits = model(x, seed)
        return mean_from((torch.logsumexp(logits, dim=-1) - logits.gather(
            -1, y.long()[..., None])[..., 0]).mean(), sp)

    def training_step(self, ctx, batch):
        """The LM loss; with routed layers plus ``moe_aux_weight`` times
        their summed load-balance loss, logged as ``moe_aux``."""
        loss = self._loss(ctx, batch)
        if self.config.n_experts > 0:
            aux = total_aux_loss(ctx.model)
            if aux is not None:
                ctx.log("moe_aux", aux)
                loss = loss + self.config.moe_aux_weight * aux
        ctx.log("loss", loss)
        return loss

    def validation_step(self, ctx, batch):
        ctx.log("val_loss", self._loss(ctx, batch))

    def test_step(self, ctx, batch):
        ctx.log("test_loss", self._loss(ctx, batch))

    def predict_step(self, ctx, batch):
        """The argmax token at every position of the full forward (on a
        ``sequence`` axis over 1, the ranks' slices joined)."""
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        out = torch.argmax(ctx.model(x), dim=-1)
        sp = ctx.model.sp
        return out if sp is None else all_gather_along(out, 1, sp.group)

    def _loader(self, seed):
        ds = synthetic_lm_dataset(self.dataset_size, self.config.block_size,
                                  self.config.vocab_size, seed)
        return DataLoader(ds, batch_size=self.batch_size, drop_last=True)

    def train_dataloader(self):
        return self._loader(0)

    def val_dataloader(self):
        return self._loader(1)

    def test_dataloader(self):
        return self._loader(2)

    def predict_dataloader(self):
        return self._loader(3)


__all__ = ["CONFIGS", "GPT", "GPTConfig", "GPTLightningModule", "Block",
           "LayerNorm", "MLP", "gelu_tanh", "gpt_partition_rules",
           "init_weights", "synthetic_lm_dataset"]
