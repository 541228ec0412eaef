"""GPT with pipeline-parallel blocks (parallel/pipeline.py).

Counterpart of ``ray_lightning_tpu/models/pipeline_gpt.py``
(``PipelinedGPT``): the same transformer math as models/gpt.py, whose
``Block`` it runs, with the blocks' parameters *stacked*, a leading
``n_layer`` dim on each (``blocks.attn.qkv.weight`` [L, 3C, C], the JAX
tree's ``blocks/attn/qkv/kernel`` [L, C, 3C] transposed layer by layer:
convert.py), so ``PipelineStrategy`` splits them on the ``stage`` axis
as it splits every parameter (parallel/layout.py): each rank keeps its
stage's ``L / S`` layers of each, cut from the full-size init, so the
weights equal the one-process model's.  A layer runs as the ``Block``
module with one slice of each stacked tensor in place of its parameters
(``torch.func.functional_call``), as the JAX model applies its flax
``Block`` to one slice of the stacked tree.

As in the JAX model: ``wte`` [V, C] (tied: the embedding and the head),
``wpe``, ``ln_f`` (eps 1e-6); the embedding's sum is cast to the compute
dtype, ``ln_f`` and the head run on every stage, replicated, on the
pipeline's broadcast outputs; MoE and dropout configs are rejected; the
``"auto"`` and ``"ring"`` attentions become ``"local"`` (the flash
kernels on the card, never the mesh); fp32 params and a constant-rate
AdamW (b1 0.9, b2 0.95).  With ``remat`` each layer runs under the
config's remat policy (core/remat.py).  The loss is the fused
full-vocab CE (ops/losses.py); the JAX model's is the fp32-logits CE of
the same products.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch import nn
from torch.func import functional_call

from ray_lightning_tpu_torch._device import resolve_device
from ray_lightning_tpu_torch.core.data import DataLoader
from ray_lightning_tpu_torch.core.module import LightningModule
from ray_lightning_tpu_torch.core.remat import model_policy, policy_object
from ray_lightning_tpu_torch.models.gpt import (CONFIGS, Block, GPTConfig,
                                               LayerNorm,
                                               synthetic_lm_dataset)
from ray_lightning_tpu_torch.ops.losses import fused_lm_cross_entropy
from ray_lightning_tpu_torch.ops.optim import AdamW
from ray_lightning_tpu_torch.parallel.pipeline import pipeline_forward


class PipelinedGPTModel(nn.Module):
    """``wte``, ``wpe``, the stacked ``blocks`` (a ``Block`` whose every
    parameter has a leading layer dim) and ``ln_f``; ``forward`` -> fp32
    logits, ``hidden`` -> the pre-head representation.  The parameters
    are made on ``device`` (the card unless the caller asks for the
    CPU)."""

    #: its use sites take the stage's layers as they are (parallel/layout.py)
    shardable = True
    #: the ``blocks.`` tensors' dim 0 is the layers: a ``stage`` split
    stacked_blocks = True

    def __init__(self, config: GPTConfig, n_microbatches: int,
                 device: "str | torch.device | None" = None):
        super().__init__()
        self.config = config
        self.n_microbatches = n_microbatches
        self._remat = policy_object(model_policy(config.remat,
                                                 config.remat_policy))
        L, C = config.n_layer, config.n_embd
        with torch.device(resolve_device(device)):
            self.wte = nn.Parameter(torch.zeros(config.vocab_size, C))
            self.wpe = nn.Parameter(torch.zeros(config.block_size, C))
            self.blocks = Block(config)
            for mod in self.blocks.modules():
                for name, p in list(mod.named_parameters(recurse=False)):
                    setattr(mod, name, nn.Parameter(
                        p.new_zeros((L,) + tuple(p.shape))))
            self.ln_f = LayerNorm(C, config.dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init in place: ``wte`` and ``wpe`` N(0, 0.02), each
        layer's linear kernels flax's lecun_normal (fan_in the kernel's
        input width), biases 0, LayerNorm scales 1."""
        for p in (self.wte, self.wpe):
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device) * 0.02)
        for mod in self.blocks.modules():
            if isinstance(mod, nn.Linear):
                std = math.sqrt(1.0 / mod.weight.shape[-1]) \
                    / .87962566103423978
                w = torch.empty(mod.weight.shape, device=mod.weight.device)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                mod.weight.copy_(w * std)
                mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        self.ln_f.weight.fill_(1.0)
        self.ln_f.bias.zero_()

    def _layer(self, layer_params: dict, h: torch.Tensor) -> torch.Tensor:
        """One layer: the ``Block`` with one slice of each stacked
        tensor."""
        return functional_call(self.blocks, layer_params, (h,))

    def hidden(self, idx: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        T = idx.shape[1]
        h = (self.wte[idx.long()] + self.wpe[:T]).to(cfg.dtype)
        stage_fn = self._layer
        if self._remat is not None and torch.is_grad_enabled():
            remat = self._remat

            def stage_fn(p, x):
                return remat(functools.partial(self._layer, p), x)
        h = pipeline_forward(stage_fn, dict(self.blocks.named_parameters()),
                             h, n_microbatches=self.n_microbatches)
        return self.ln_f(h)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        dt = self.config.dtype
        return (self.hidden(idx) @ self.wte.to(dt).t()).float()


class PipelinedGPT(LightningModule):
    """Decoder LM whose blocks run under the GPipe schedule (the JAX
    module's arguments and defaults).  ``n_microbatches`` divides the
    per-data-shard batch; on a mesh without a ``stage`` axis the same
    model is a plain loop over its layers."""

    def __init__(self, config: "GPTConfig | str" = "tiny",
                 n_microbatches: int = 2, lr: float = 3e-4,
                 weight_decay: float = 0.01, dataset_size: int = 256,
                 batch_size: int = 8):
        super().__init__()
        if isinstance(config, str):
            config = CONFIGS[config]
        if config.n_experts > 0:
            raise ValueError(
                "PipelinedGPT does not support MoE configs yet; set "
                "GPTConfig(n_experts=0)")
        if config.dropout > 0:
            raise ValueError(
                "PipelinedGPT does not support dropout yet; set "
                "GPTConfig(dropout=0.0)")
        if config.attention_impl in ("auto", "ring"):
            config = dataclasses.replace(config, attention_impl="local")
        self.config = config
        self.n_microbatches = n_microbatches
        self.save_hyperparameters("lr", "weight_decay", "batch_size")
        self.lr = lr
        self.weight_decay = weight_decay
        self.dataset_size = dataset_size
        self.batch_size = batch_size

    def configure_model(self, device=None):
        return PipelinedGPTModel(self.config, self.n_microbatches,
                                 device=device)

    def configure_optimizers(self):
        return AdamW(self.lr, weight_decay=self.weight_decay, b1=0.9,
                     b2=0.95)

    def configure_remat(self):
        """The GPT ladder without the MoE save lists (this model rejects
        MoE configs), probed on the one block kind every stage runs (JAX
        ``models/pipeline_gpt.py:114``)."""
        from ray_lightning_tpu_torch.core import remat as _rm
        base: dict = {}

        def block_probe(policy: str, B: int, T: int):
            cfg = self.config

            def make(_kind, _pol):
                blk = Block(cfg)
                return blk, blk
            saved, flops = _rm.probe_blocks(
                make, [(cfg.n_layer, "block")], policy, B, T, cfg.n_embd,
                cfg.dtype, self.param_dtype, base)
            return saved, flops, cfg.n_layer

        return _rm.ladder_spec(self, _rm.POLICY_LADDER, block_probe)

    def configure_mpmd(self):
        raise NotImplementedError(
            "MPMD stage partitioning is not ported yet (ROADMAP.md queue "
            "1 item 11)")

    def _loss(self, ctx, batch):
        x, y = batch
        model = ctx.model
        return fused_lm_cross_entropy(model.hidden(x), model.wte, y)

    def training_step(self, ctx, batch):
        loss = self._loss(ctx, batch)
        ctx.log("loss", loss)
        return loss

    def validation_step(self, ctx, batch):
        ctx.log("val_loss", self._loss(ctx, batch))

    def test_step(self, ctx, batch):
        ctx.log("test_loss", self._loss(ctx, batch))

    def predict_step(self, ctx, batch):
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        return torch.argmax(ctx.model(x), dim=-1)

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


__all__ = ["PipelinedGPT", "PipelinedGPTModel"]
