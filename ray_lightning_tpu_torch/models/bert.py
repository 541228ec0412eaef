"""BERT-style bidirectional encoder: masked-LM pretraining and sequence
classification.

Counterpart of ``ray_lightning_tpu/models/bert.py`` (``BertConfig``,
``CONFIGS``, ``EncoderLayer``, ``BertEncoder``, ``BertForMaskedLM``,
``BertClassifier``, ``BertMLMModule``, ``BertLightningModule``,
``synthetic_classification``).  Parameter names map one to one onto the
flax tree (``convert.flax_to_torch``): ``encoder.wte``, ``encoder.wpe``,
``encoder.h.{i}.ln1|attn.qkv|attn.proj|ln2|fc|out``, ``encoder.ln_f``,
then ``mlm_head`` or ``pooler`` and ``classifier``.

Op for op as the flax modules, so both packages agree on the same
weights: the token table cast to the compute dtype and gathered
(``nn.Embed(dtype=...)``); ``wpe`` an fp32 parameter whose first T rows
are cast and added in the compute dtype; pre-LN layers (``ln1``,
bidirectional attention, residual, ``ln2``, ``fc`` -> tanh GELU ->
``out``, dropout in training, residual) with models/gpt.py's
``LayerNorm`` and :func:`gelu_tanh`; ``ln_f``.  Dropout
(``config.dropout``) follows the attention's output projection and the
layer's ``out``, as flax's ``nn.Dropout`` (ops/attention.py
``dropout``), seeded per layer and site from the forward's
``dropout_seed``.  The MLM head is a compute-dtype ``Dense``
cast to fp32; the classifier mean-pools in fp32, then ``pooler`` (fp32)
with tanh, then ``classifier`` (fp32).  Params stay fp32-resident (BERT
has no ``param_dtype``, so no fp32 master).

Attention is non-causal through :class:`MultiHeadAttention`: the flash
kernels with ``causal=0`` on the card (TPU kernel rows 1 and 6 at
bert-base, rows 5 and 10 at ``tiny``, whose heads do not pack, and rows
5, 15 and 16 under ``RLT_FLASH_BLOCK_Q/K`` below T: ops/flash_attention.py
``tpu_rows``), the plain attention on the CPU.  Remat takes every
policy of core/remat.py's ladder; ``bert_partition_rules`` (SPMD) is not
ported and raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_lightning_tpu_torch._device import resolve_device
from ray_lightning_tpu_torch.core.data import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.core.module import LightningModule
from ray_lightning_tpu_torch.core.remat import model_policy, policy_object
from ray_lightning_tpu_torch.models.common import ClassificationModule
from ray_lightning_tpu_torch.models.gpt import (LayerNorm, gelu_tanh,
                                                init_weights,
                                                synthetic_lm_dataset)
from ray_lightning_tpu_torch.ops.attention import (MultiHeadAttention,
                                                   dropout, fold_in, linear)
from ray_lightning_tpu_torch.ops.optim import AdamW
from ray_lightning_tpu_torch.ops.random import Key, as_key


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """The JAX package's config, same fields and defaults."""

    vocab_size: int = 30592          # 30522 padded to a multiple of 128
    max_len: int = 512
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    intermediate: int = 3072
    num_classes: int = 2
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16   # compute dtype
    # "auto" | "dot" | "flash" (ops/attention.py resolve_attention)
    attention_impl: str = "auto"
    remat: bool = False
    remat_policy: str = "full"

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


CONFIGS = {
    "tiny": BertConfig(vocab_size=512, max_len=64, n_layer=2, n_head=2,
                       n_embd=64, intermediate=128),
    "bert-base": BertConfig(),
    "bert-large": BertConfig(n_layer=24, n_head=16, n_embd=1024,
                             intermediate=4096),
}


class EncoderLayer(nn.Module):
    """Pre-LN encoder layer: ``x + attn(ln1(x))``, then ``x + out(gelu(
    fc(ln2(x))))``; with ``dropout_seed`` (training) the attention's and
    the ``out`` projection's dropout, sites 0 and 1."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.dropout = cfg.dropout
        self.ln1 = LayerNorm(cfg.n_embd, cfg.dtype)
        self.attn = MultiHeadAttention(cfg.n_embd, cfg.n_head, causal=False,
                                       dtype=cfg.dtype,
                                       attention_impl=cfg.attention_impl,
                                       dropout=cfg.dropout)
        self.ln2 = LayerNorm(cfg.n_embd, cfg.dtype)
        self.fc = nn.Linear(cfg.n_embd, cfg.intermediate)
        self.out = nn.Linear(cfg.intermediate, cfg.n_embd)

    def forward(self, x, dropout_seed: "int | None" = None):
        x = x + self.attn(self.ln1(x), fold_in(dropout_seed, 0))[0]
        h = gelu_tanh(linear(self.fc, self.ln2(x), self.dtype))
        h = linear(self.out, h, self.dtype)
        return x + dropout(h, self.dropout, fold_in(dropout_seed, 1))


class BertEncoder(nn.Module):
    """``forward(tokens [B, T]) -> hidden [B, T, C]`` in the compute
    dtype; each layer under the remat policy while autograd records, as
    ``nn.remat`` wraps each layer in the JAX package."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.remat_policy = model_policy(cfg.remat, cfg.remat_policy)
        self._remat = policy_object(self.remat_policy)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd)
        self.wpe = nn.Parameter(torch.zeros(cfg.max_len, cfg.n_embd))
        self.h = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.n_layer))
        self.ln_f = LayerNorm(cfg.n_embd, cfg.dtype)

    def forward(self, idx, dropout_seed: "int | None" = None):
        dt = self.config.dtype
        T = idx.shape[1]
        x = self.wte.weight[idx.long()].to(dt) + self.wpe[:T].to(dt)
        remat = self._remat if torch.is_grad_enabled() else None
        for i, layer in enumerate(self.h):
            seed = fold_in(dropout_seed, i)
            x = (remat(layer, x, seed) if remat is not None
                 else layer(x, seed))
        return self.ln_f(x)


class _BertModel(nn.Module):
    """An encoder and a head, made on ``device`` (the card unless the
    caller asks for the CPU)."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.config = cfg
        with torch.device(resolve_device(device)):
            self.encoder = BertEncoder(cfg)
            self._make_head(cfg)

    def _make_head(self, cfg: BertConfig) -> None:
        raise NotImplementedError

    @property
    def remat_policy(self) -> str:
        return self.encoder.remat_policy

    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init in place (models/gpt.py ``init_weights``): ``wte``
        and ``wpe`` N(0, 0.02), every ``Linear`` lecun_normal."""
        init_weights(self, (self.encoder.wte.weight, self.encoder.wpe),
                     generator)


class BertForMaskedLM(_BertModel):
    """Masked-LM head over the encoder: ``[B, T] -> [B, T, V]`` fp32
    logits (the product in the compute dtype)."""

    def _make_head(self, cfg):
        self.mlm_head = nn.Linear(cfg.n_embd, cfg.vocab_size)

    def forward(self, idx, dropout_seed: "int | None" = None):
        h = self.encoder(idx, dropout_seed)
        return linear(self.mlm_head, h, self.config.dtype).float()


class BertClassifier(_BertModel):
    """Sequence classification: the mean-pooled encoder output (fp32)
    -> ``pooler`` + tanh -> ``classifier``, all fp32."""

    def _make_head(self, cfg):
        self.pooler = nn.Linear(cfg.n_embd, cfg.n_embd)
        self.classifier = nn.Linear(cfg.n_embd, cfg.num_classes)

    def forward(self, idx, dropout_seed: "int | None" = None):
        pooled = self.encoder(idx, dropout_seed).float().mean(dim=1)
        pooled = torch.tanh(linear(self.pooler, pooled, torch.float32))
        return linear(self.classifier, pooled, torch.float32)


def softmax_cross_entropy(logits, labels):
    """Per-position fp32 cross-entropy of ``logits`` [..., V] against int
    ``labels`` [...] (optax's ``softmax_cross_entropy_with_integer_
    labels``: a max-shifted log-softmax)."""
    shape = labels.shape
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           labels.long().reshape(-1),
                           reduction="none").reshape(shape)


class BertMLMModule(LightningModule):
    """Masked-LM pretraining.  A Bernoulli(``mask_prob``) mask drawn from
    the step's key (``ctx.make_key()``, a keyed draw that a graphed chunk
    replays with each step's own key; the JAX step draws it from its
    PRNG stream) selects positions, their inputs become the reserved
    last vocab id, and the loss is the mean fp32 cross-entropy over the
    masked positions only."""

    def __init__(self, config: "BertConfig | str" = "tiny",
                 lr: float = 1e-4, weight_decay: float = 0.01,
                 mask_prob: float = 0.15, batch_size: int = 8,
                 train_size: int = 256, val_size: int = 64):
        super().__init__()
        if isinstance(config, str):
            config = CONFIGS[config]
        self.config = config
        self.save_hyperparameters("lr", "mask_prob", "batch_size")
        self.lr = lr
        self.weight_decay = weight_decay
        self.mask_prob = mask_prob
        self.batch_size = batch_size
        self.train_size = train_size
        self.val_size = val_size

    def configure_model(self, device=None):
        return BertForMaskedLM(self.config, device=device)

    def configure_optimizers(self):
        """``optax.adamw(lr, weight_decay)``: a constant rate, b2 = 0.999,
        an fp32 first moment."""
        return AdamW(self.lr, weight_decay=self.weight_decay, b1=0.9,
                     b2=0.999)

    def _mlm_loss(self, ctx, tokens, key: "Key | int | None" = None,
                  mask: "torch.Tensor | None" = None):
        """The masked-LM loss of ``tokens`` [B, T]: ``mask`` (bool [B, T])
        when given, else Bernoulli(``mask_prob``) drawn from ``key`` (an
        ops/random.py ``Key``, or an int seed)."""
        if mask is None:
            mask = as_key(key, tokens.device).uniform(
                tokens.shape) < self.mask_prob
        inputs = torch.where(mask, self.config.vocab_size - 1, tokens.long())
        logits = ctx.model(inputs, ctx.dropout_seed(self.config.dropout))
        ce = softmax_cross_entropy(logits, tokens)
        weights = mask.float()
        return (ce * weights).sum() / weights.sum().clamp_min(1.0)

    def training_step(self, ctx, batch):
        tokens = batch[0] if isinstance(batch, (tuple, list)) else batch
        loss = self._mlm_loss(ctx, tokens, ctx.make_key())
        ctx.log("loss", loss)
        return loss

    def validation_step(self, ctx, batch):
        tokens = batch[0] if isinstance(batch, (tuple, list)) else batch
        # a fixed eval mask (the JAX package's PRNGKey(0)): a metric that
        # is the same across runs
        ctx.log("val_loss", self._mlm_loss(ctx, tokens, 0))

    def _loader(self, n, seed, shuffle=False):
        # the last vocab id is the mask token: the data never holds it
        ds = synthetic_lm_dataset(n, self.config.max_len,
                                  self.config.vocab_size - 1, seed)
        return DataLoader(ds, batch_size=self.batch_size, shuffle=shuffle,
                          drop_last=True)

    def train_dataloader(self):
        return self._loader(self.train_size, 0, shuffle=True)

    def val_dataloader(self):
        return self._loader(self.val_size, 1)


def bert_partition_rules(tensor_axis: str = "tensor") -> list:
    """SpmdStrategy's tensor-parallel rules: not ported (no SPMD yet)."""
    raise NotImplementedError(
        "bert_partition_rules needs SpmdStrategy, which is not ported yet "
        "(ROADMAP.md queue 1, parallelism beyond DP)")


def synthetic_classification(n: int, cfg: BertConfig,
                             seed: int = 0) -> ArrayDataset:
    """Class-dependent token distributions: each class draws tokens from
    its own vocab band, so a short fine-tune must become separable (the
    JAX package's generator, draw for draw)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.num_classes, size=n)
    band = cfg.vocab_size // max(2, cfg.num_classes)
    tokens = (rng.integers(0, band, size=(n, cfg.max_len))
              + labels[:, None] * band)
    return ArrayDataset(tokens.astype(np.int32), labels.astype(np.int32))


class BertLightningModule(ClassificationModule):
    """Sequence-classification fine-tune (BASELINE config #4's
    workload)."""

    def __init__(self, config: "BertConfig | str" = "tiny",
                 lr: float = 5e-5, weight_decay: float = 0.01,
                 warmup_steps: int = 10, batch_size: int = 8,
                 train_size: int = 256, val_size: int = 64):
        super().__init__()
        if isinstance(config, str):
            config = CONFIGS[config]
        self.config = config
        self.save_hyperparameters("lr", "batch_size")
        self.lr = lr
        self.weight_decay = weight_decay
        self.warmup_steps = warmup_steps
        self.batch_size = batch_size
        self.train_size = train_size
        self.val_size = val_size

    def configure_model(self, device=None):
        return BertClassifier(self.config, device=device)

    def configure_optimizers(self):
        """``optax.adamw(linear_schedule(0, lr, warmup_steps),
        weight_decay)``: b2 = 0.999, an fp32 first moment."""
        return AdamW(self.lr, warmup_steps=self.warmup_steps,
                     weight_decay=self.weight_decay, b1=0.9, b2=0.999)

    def compute_logits(self, ctx, tokens):
        return ctx.model(tokens, ctx.dropout_seed(self.config.dropout))

    def make_dataset(self, n, seed):
        return synthetic_classification(n, self.config, seed)


__all__ = ["BertClassifier", "BertConfig", "BertEncoder", "BertForMaskedLM",
           "BertLightningModule", "BertMLMModule", "CONFIGS", "EncoderLayer",
           "bert_partition_rules", "softmax_cross_entropy",
           "synthetic_classification"]
