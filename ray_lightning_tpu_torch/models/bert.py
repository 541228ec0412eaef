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
policy of core/remat.py's ladder.  Under :func:`bert_partition_rules`
on a ``tensor`` axis over 1 the forward is models/gpt.py's Megatron
layout (``wte`` vocab-split, ``qkv`` / ``fc`` column-, ``proj`` /
``out`` row-parallel) plus ``mlm_head`` column-split over the vocab,
whose loss takes its max, sum and target over the group; sharded
parameters are gathered at their use sites (parallel/layout.py).
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
                                                   column_linear, dropout,
                                                   fold_in, linear,
                                                   row_linear)
from ray_lightning_tpu_torch.ops.optim import AdamW
from ray_lightning_tpu_torch.ops.random import Key, as_key
from ray_lightning_tpu_torch.parallel.layout import gathered
from ray_lightning_tpu_torch.parallel.strategy import P
from ray_lightning_tpu_torch.parallel.tensor import (reduce_from,
                                                     target_logit,
                                                     vocab_embed, vocab_max)


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
        #: the tensor-parallel group (``fc`` column-, ``out`` row-parallel)
        self.tp = None

    def forward(self, x, dropout_seed: "int | None" = None):
        x = x + self.attn(self.ln1(x), fold_in(dropout_seed, 0))[0]
        h = gelu_tanh(column_linear(self.fc, self.ln2(x), self.dtype,
                                    self.tp))
        h = row_linear(self.out, h, self.dtype, self.tp)
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
        #: the tensor-parallel group (``wte`` vocab-split)
        self.tp = None

    def forward(self, idx, dropout_seed: "int | None" = None):
        dt = self.config.dtype
        T = idx.shape[1]
        x = vocab_embed(gathered(self.wte.weight), idx, dt, self.tp) \
            + gathered(self.wpe)[:T].to(dt)
        remat = self._remat if torch.is_grad_enabled() else None
        for i, layer in enumerate(self.h):
            seed = fold_in(dropout_seed, i)
            x = (remat(layer, x, seed) if remat is not None
                 else layer(x, seed))
        return self.ln_f(x)


class _BertModel(nn.Module):
    """An encoder and a head, made on ``device`` (the card unless the
    caller asks for the CPU)."""

    #: its use sites gather sharded parameters (parallel/layout.py)
    shardable = True

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.config = cfg
        #: the tensor-parallel group (the MLM head column-split)
        self.tp = None
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

    def tensor_parallel_dims(self) -> "dict[str, int]":
        """The parameters the tensor-parallel forward computes on in
        pieces, with their split dims in the flax layout (the dims
        :func:`bert_partition_rules` names)."""
        out = {"encoder.wte.weight": 0}
        for i in range(self.config.n_layer):
            out.update({f"encoder.h.{i}.attn.qkv.weight": 1,
                        f"encoder.h.{i}.attn.proj.weight": 0,
                        f"encoder.h.{i}.fc.weight": 1,
                        f"encoder.h.{i}.out.weight": 0})
        return out


class BertForMaskedLM(_BertModel):
    """Masked-LM head over the encoder: ``[B, T] -> [B, T, V]`` fp32
    logits (the product in the compute dtype); under tensor parallelism
    :meth:`local_logits` are this rank's vocab slice, which the loss
    takes as they are (:func:`softmax_cross_entropy`)."""

    def _make_head(self, cfg):
        self.mlm_head = nn.Linear(cfg.n_embd, cfg.vocab_size)

    def tensor_parallel_dims(self) -> "dict[str, int]":
        return {**super().tensor_parallel_dims(), "mlm_head.weight": 1}

    def local_logits(self, idx, dropout_seed: "int | None" = None):
        h = self.encoder(idx, dropout_seed)
        return column_linear(self.mlm_head, h, self.config.dtype,
                             self.tp).float()

    def forward(self, idx, dropout_seed: "int | None" = None):
        from ray_lightning_tpu_torch.parallel.tensor import gather_from
        return gather_from(self.local_logits(idx, dropout_seed), self.tp)


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


def softmax_cross_entropy(logits, labels, tp=None):
    """Per-position fp32 cross-entropy of ``logits`` [..., V] against int
    ``labels`` [...] (optax's ``softmax_cross_entropy_with_integer_
    labels``: a max-shifted log-softmax).  Under ``tp`` the logits are
    this rank's vocab slice: the max, the sum of exponentials and the
    label's logit are taken over the group."""
    if tp is None:
        shape = labels.shape
        return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                               labels.long().reshape(-1),
                               reduction="none").reshape(shape)
    logits = logits.float()
    m = vocab_max(logits, tp)
    lse = torch.log(reduce_from(torch.exp(logits - m[..., None]).sum(-1),
                                tp)) + m
    return lse - target_logit(logits, labels, tp)


def _bert_remat_spec(module):
    """``configure_remat()`` of both BERT modules (JAX
    ``models/bert.py:145``): the generic ladder, probed on the encoder
    layers both share."""
    from ray_lightning_tpu_torch.core import remat as _rm
    base: dict = {}

    def block_probe(policy: str, B: int, T: int):
        cfg = module.config

        def make(_kind, _pol):
            lyr = EncoderLayer(cfg)
            return lyr, lyr
        saved, flops = _rm.probe_blocks(
            make, [(cfg.n_layer, "layer")], policy, B, T, cfg.n_embd,
            cfg.dtype, getattr(module, "param_dtype", None), base)
        return saved, flops, cfg.n_layer

    return _rm.ladder_spec(module, _rm.POLICY_LADDER, block_probe)


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

    def configure_remat(self):
        return _bert_remat_spec(self)

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
        model = ctx.model
        logits = model.local_logits(inputs,
                                    ctx.dropout_seed(self.config.dropout))
        ce = softmax_cross_entropy(logits, tokens, model.tp)
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
    """``SpmdStrategy`` rules, the JAX function's: Megatron column / row
    splits (models/gpt.py's pattern) and the vocab-split MLM projection;
    no catch-all, so the rest falls to the replicate-or-fsdp fallback."""
    t = tensor_axis
    return [
        ("wte/embedding", P(t, None)),
        ("qkv/kernel", P(None, t)),
        ("proj/kernel", P(t, None)),
        ("fc/kernel", P(None, t)),
        ("out/kernel", P(t, None)),
        ("mlm_head/kernel", P(None, t)),
    ]


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

    def configure_remat(self):
        return _bert_remat_spec(self)

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
