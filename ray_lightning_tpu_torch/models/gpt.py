"""GPT-style decoder LM in PyTorch: the serve and training paths' model.

Counterpart of ``ray_lightning_tpu/models/gpt.py`` (``GPTConfig``,
``CONFIGS``, ``MLP``, ``Block``, ``GPT.hidden`` / ``__call__`` /
``decode``, ``synthetic_lm_dataset``, ``GPTLightningModule``'s serve and
training hooks).  Parameter names map
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
  fp32; ``wpe`` rows are cast to the compute dtype before the add.
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
from ray_lightning_tpu_torch.core.remat import model_policy, policy_object
from ray_lightning_tpu_torch.ops.attention import MultiHeadAttention, linear
from ray_lightning_tpu_torch.ops.losses import (
    chunked_softmax_cross_entropy, fused_lm_cross_entropy)
from ray_lightning_tpu_torch.ops.optim import AdamW, fp32_master


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """The JAX package's config, same fields and defaults.  The
    training-only fields (remat, chunked CE, MoE) are kept so configs
    compare one to one; the serve path rejects MoE."""

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
        return F.layer_norm(x.float(), self.weight.shape,
                            self.weight.float(), self.bias.float(),
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


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd)
        self.out = nn.Linear(4 * cfg.n_embd, cfg.n_embd)

    def forward(self, x):
        h = gelu_tanh(linear(self.fc, x, self.dtype))
        return linear(self.out, h, self.dtype)


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln1 = LayerNorm(cfg.n_embd, cfg.dtype)
        self.attn = MultiHeadAttention(cfg.n_embd, cfg.n_head, causal=True,
                                       dtype=cfg.dtype,
                                       attention_impl=cfg.attention_impl)
        self.ln2 = LayerNorm(cfg.n_embd, cfg.dtype)
        self.mlp = MLP(cfg)

    def forward(self, x):
        return self.forward_with_kv(x)[0]

    def forward_with_kv(self, x):
        """Returns ``(x', (k, v))``: the layer's K/V for the prefill."""
        a, kv = self.attn(self.ln1(x))
        x = x + a
        return x + self.mlp(self.ln2(x)), kv

    def decode(self, x, k_cache, v_cache, positions, impl=None):
        x = x + self.attn.decode(self.ln1(x), k_cache, v_cache, positions,
                                 impl)
        return x + self.mlp(self.ln2(x))


class GPT(nn.Module):
    """Decoder-only transformer.  ``hidden`` -> pre-head representation,
    ``hidden_with_kv`` -> that and every layer's K/V (the prefill),
    ``forward`` -> fp32 logits, ``decode`` -> one continuous-batching
    step over the slot cache.  Dropout is not ported (the serve path
    runs with it off, as ``configure_decode_model`` sets it).

    With ``config.remat`` each block of ``hidden`` runs under the remat
    policy (core/remat.py: ``RLT_REMAT_POLICY``, else
    ``config.remat_policy``) whenever autograd records, as ``nn.remat``
    wraps each block in the JAX package; an unported policy raises
    here.  The checkpointed function returns the block's output alone:
    its K/V are views of the fused qkv projection, and returning them
    would keep every layer's qkv alive through the backward pass.

    The parameters are made on ``device``: the card unless the caller
    asks for the CPU (``device="cpu"``); without CUDA the default
    raises."""

    def __init__(self, config: GPTConfig,
                 device: "str | torch.device | None" = None):
        super().__init__()
        if config.n_experts > 0:
            raise NotImplementedError(
                "MoE blocks (ops/moe.py) are not ported yet")
        self.config = config
        self.remat_policy = model_policy(config.remat, config.remat_policy)
        self._remat = policy_object(self.remat_policy)
        with torch.device(resolve_device(device)):
            self.wte = nn.Embedding(config.vocab_size, config.n_embd)
            self.wpe = nn.Parameter(torch.zeros(config.block_size,
                                                config.n_embd))
            self.h = nn.ModuleList(Block(config)
                                   for _ in range(config.n_layer))
            self.ln_f = LayerNorm(config.n_embd, config.dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init in place, drawn from ``generator`` (which must
        live on the parameters' device): embeddings N(0, 0.02), linear
        kernels flax's lecun_normal (truncated normal, variance 1/fan_in),
        biases 0, LayerNorm scale 1.  The numbers differ from
        ``jax.random``'s; tests that compare the two packages convert the
        JAX weights instead."""
        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device) * std)

        normal(self.wte.weight, 0.02)
        normal(self.wpe, 0.02)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                fan_in = mod.weight.shape[1]
                # variance_scaling(1, fan_in, truncated_normal): the
                # stddev of a unit normal truncated to [-2, 2]
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                w = torch.empty(mod.weight.shape, device=mod.weight.device)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                mod.weight.copy_(w * std)
                mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def head(self, x):
        """fp32 logits from the tied embedding (compute-dtype product)."""
        dt = self.config.dtype
        return (x.to(dt) @ self.wte.weight.to(dt).t()).float()

    def _embed(self, idx):
        dt = self.config.dtype
        T = idx.shape[1]
        return self.wte.weight[idx].to(dt) + self.wpe[:T].to(dt)

    def hidden(self, idx):
        """Pre-head representation ``[B, T, C]`` in the compute dtype;
        each block under the remat policy while autograd records."""
        x = self._embed(idx)
        remat = self._remat if torch.is_grad_enabled() else None
        for blk in self.h:
            x = remat(blk, x) if remat is not None else blk(x)
        return self.ln_f(x)

    def hidden_with_kv(self, idx):
        """The prefill's forward: :meth:`hidden` without remat, and every
        layer's ``(k, v)`` [B, T, H, D]."""
        x = self._embed(idx)
        kvs = []
        for blk in self.h:
            x, kv = blk.forward_with_kv(x)
            kvs.append(kv)
        return self.ln_f(x), kvs

    def forward(self, idx):
        """Whole-sequence forward: fp32 logits ``[B, T, V]``."""
        return self.head(self.hidden(idx))

    def decode(self, tokens, positions, k_caches, v_caches,
               impl: "str | None" = None):
        """One decode step over ``S`` slots.

        ``tokens``/``positions`` [S] int32 — each slot's current token
        and its absolute position; ``k_caches``/``v_caches``
        [n_layer, S, L, H, D]; ``impl`` picks the decode attention
        (ops/attention.py ``cached_attention``).  Writes every slot's K/V
        row in place and returns fp32 logits ``[S, V]``.  Shapes do not depend on which
        slots are live: insertion and eviction are slot-index changes in
        the host-side scheduler."""
        dt = self.config.dtype
        x = self.wte.weight[tokens.long()].to(dt)[:, None, :]
        x = x + self.wpe[positions.long()].to(dt)[:, None, :]
        for i, blk in enumerate(self.h):
            x = blk.decode(x, k_caches[i], v_caches[i], positions, impl)
        return self.head(self.ln_f(x))[:, 0]


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
        """The training model, with its remat policy (core/remat.py:
        "full" and "off" are ported).  Dropout is not ported (ROADMAP.md
        queue 1, with the rest of the trainer); no shipped config uses
        it."""
        cfg = self.config
        if cfg.dropout > 0:
            raise NotImplementedError(
                f"dropout={cfg.dropout} is not ported yet (ROADMAP.md "
                f"queue 1, with the rest of the trainer)")
        return GPT(cfg, device=device)

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
        (ops/losses.py)."""
        x, y = batch
        model = ctx.model
        if self.config.chunked_ce > 0:
            return chunked_softmax_cross_entropy(model.hidden(x),
                                                 model.wte.weight, y,
                                                 self.config.chunked_ce)
        if os.environ.get("RLT_FUSED_CE", "1") != "0":
            return fused_lm_cross_entropy(model.hidden(x), model.wte.weight,
                                          y)
        logits = model(x)
        return (torch.logsumexp(logits, dim=-1)
                - logits.gather(-1, y.long()[..., None])[..., 0]).mean()

    def training_step(self, ctx, batch):
        loss = self._loss(ctx, batch)
        ctx.log("loss", loss)
        return loss

    def validation_step(self, ctx, batch):
        ctx.log("val_loss", self._loss(ctx, batch))

    def test_step(self, ctx, batch):
        ctx.log("test_loss", self._loss(ctx, batch))

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
           "LayerNorm", "MLP", "synthetic_lm_dataset"]
