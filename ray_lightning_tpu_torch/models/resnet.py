"""ResNet family (v1.5 bottleneck) for image classification.

Counterpart of ``ray_lightning_tpu/models/resnet.py`` (BASELINE.md
config #2: "ResNet-50 / CIFAR-10 LightningModule via RayXlaPlugin
DDP"), with the same names and flax's numerics:

- images come in NHWC, as in the JAX package; ``ResNet.forward`` views
  them as NCHW without a copy, which is the ``channels_last`` layout, so
  cuDNN runs every conv on the card channels-last (the conv weights are
  cast to it at use);
- parameters are fp32 and compute runs in the config's dtype (bf16):
  each conv casts its input and kernel to it, as flax's ``Conv(dtype=)``
  promotes them;
- convs pad as flax's ``"SAME"`` does: ``ceil(n / s)`` outputs, the odd
  pad row and column on the high side (a 3x3 stride-2 conv on 32x32 pads
  (0, 1), the ImageNet stem's 7x7 stride 2 at 224 (2, 3), the 3x3
  stride-2 max pool with -inf);
- :class:`BatchNorm` is flax's ``nn.BatchNorm(momentum=0.9,
  epsilon=1e-5)``: batch moments in fp32 (``max(0, E[x^2] - E[x]^2)``,
  over the global batch under DDP or ZeRO-1: parallel/strategy.py
  ``batch_moments``), the running variance the *biased* batch variance,
  ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in fp32 cast to the
  compute dtype, no ``num_batches_tracked``; train or eval is the
  ``train`` argument (the steps pass ``ctx.training``), never a module
  flag;
- the global pool is a mean over H and W accumulated in fp32 and
  rounded to the compute dtype; the head runs in fp32;
- ``init_weights`` follows flax's distributions: conv and dense kernels
  lecun_normal, biases 0, BatchNorm scales 1 except the last of each
  block, which starts at 0 (residual branches start as the identity).

Convs, pooling and the head are library calls (cuDNN, cuBLAS): the JAX
package computes them outside any Pallas kernel, so no TPU kernel lies
on this path.  ``synthetic_cifar10`` draws the JAX package's dataset
element for element.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_lightning_tpu_torch._device import resolve_device
from ray_lightning_tpu_torch.core.data import ArrayDataset
from ray_lightning_tpu_torch.models.common import ClassificationModule
from ray_lightning_tpu_torch.ops.optim import SGD, add_decayed_weights, chain
from ray_lightning_tpu_torch.parallel.strategy import batch_moments

#: flax ``nn.BatchNorm``'s momentum (as the JAX ResNet sets it) and epsilon
BN_MOMENTUM = 0.9
BN_EPS = 1e-5
#: image channels (RGB): flax infers the stem's input width from the
#: batch, a torch conv takes it when it is built
IN_CHANNELS = 3


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (3, 4, 6, 3)   # resnet-50
    bottleneck: bool = True
    num_classes: int = 10
    width: int = 64
    # cifar stem: 3x3/s1 conv, no max-pool (32x32 inputs); imagenet stem:
    # 7x7/s2 + 3x3 max-pool
    cifar_stem: bool = True
    dtype: torch.dtype = torch.bfloat16


CONFIGS = {
    "resnet18": ResNetConfig(stage_sizes=(2, 2, 2, 2), bottleneck=False),
    "resnet34": ResNetConfig(stage_sizes=(3, 4, 6, 3), bottleneck=False),
    "resnet50": ResNetConfig(stage_sizes=(3, 4, 6, 3), bottleneck=True),
    "resnet101": ResNetConfig(stage_sizes=(3, 4, 23, 3), bottleneck=True),
}


def same_pads(size: int, kernel: int, stride: int) -> "tuple[int, int]":
    """flax's ``"SAME"`` padding of one spatial dim: ``ceil(size /
    stride)`` outputs, the pad split with the odd one on the high
    side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int,
              value: float = 0.0) -> "tuple[torch.Tensor, tuple]":
    """``x`` [N, C, H, W] with its asymmetric SAME pad applied (kept
    channels-last), and the symmetric pad left for the op itself."""
    (hl, hh), (wl, wh) = (same_pads(x.shape[2], kernel, stride),
                          same_pads(x.shape[3], kernel, stride))
    if (hl, wl) == (hh, wh):
        return x, (hl, wl)
    x = F.pad(x, (wl, wh, hl, hh), value=value)
    return x.contiguous(memory_format=torch.channels_last), (0, 0)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), (s, s), use_bias=False,
    dtype=dtype)`` with ``"SAME"`` padding, over [N, C, H, W]."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kernel, kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, pad = _pad_same(x.to(self.dtype), self.kernel, self.stride)
        w = self.weight.to(dtype=self.dtype,
                           memory_format=torch.channels_last)
        return F.conv2d(x, w, stride=self.stride, padding=pad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel dim of [N, C, H, W]
    (module docstring); ``weight`` is flax's ``scale``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16,
                 zero_scale: bool = False):
        super().__init__()
        self.dtype, self.zero_scale = dtype, zero_scale
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = x.float()
        if train:
            mean, mean_sq = batch_moments(x, (0, 2, 3))
            var = torch.clamp_min(mean_sq - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.copy_(
                    BN_MOMENTUM * self.running_mean
                    + (1 - BN_MOMENTUM) * mean.detach())
                self.running_var.copy_(
                    BN_MOMENTUM * self.running_var
                    + (1 - BN_MOMENTUM) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype)


class ResNetBlock(nn.Module):
    """Two 3x3 convs; a 1x1 projection of the residual when the channels
    or the stride change (the JAX block's ``residual.shape !=
    y.shape``)."""

    def __init__(self, in_features: int, filters: int, strides: int,
                 dtype: torch.dtype):
        super().__init__()
        self.Conv_0 = Conv(in_features, filters, 3, strides, dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype)
        self.Conv_1 = Conv(filters, filters, 3, 1, dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype, zero_scale=True)
        self.out_features = filters
        if in_features != filters or strides != 1:
            self.proj = Conv(in_features, filters, 1, strides, dtype)
            self.proj_bn = BatchNorm(filters, dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        if hasattr(self, "proj"):
            x = self.proj_bn(self.proj(x), train)
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    """1x1, 3x3 (strided), 1x1 to ``4 * filters``; a 1x1 projection of
    the residual when the channels or the stride change."""

    def __init__(self, in_features: int, filters: int, strides: int,
                 dtype: torch.dtype):
        super().__init__()
        self.Conv_0 = Conv(in_features, filters, 1, 1, dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype)
        self.Conv_1 = Conv(filters, filters, 3, strides, dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype)
        self.Conv_2 = Conv(filters, filters * 4, 1, 1, dtype)
        self.BatchNorm_2 = BatchNorm(filters * 4, dtype, zero_scale=True)
        self.out_features = filters * 4
        if in_features != filters * 4 or strides != 1:
            self.proj = Conv(in_features, filters * 4, 1, strides, dtype)
            self.proj_bn = BatchNorm(filters * 4, dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        if hasattr(self, "proj"):
            x = self.proj_bn(self.proj(x), train)
        return F.relu(x + y)


class ResNet(nn.Module):
    """``forward(images[N, H, W, C], train) -> logits [N, classes]``
    (fp32); the children carry flax's names (``stem``, ``stem_bn``,
    ``s{stage}b{block}``, ``head``), so ``convert.flax_to_torch`` maps
    the JAX variables one to one."""

    def __init__(self, config: ResNetConfig, device=None):
        super().__init__()
        self.config = cfg = config
        block = BottleneckBlock if cfg.bottleneck else ResNetBlock
        with torch.device(resolve_device(device)):
            self.stem = (Conv(IN_CHANNELS, cfg.width, 3, 1, cfg.dtype)
                         if cfg.cifar_stem else
                         Conv(IN_CHANNELS, cfg.width, 7, 2, cfg.dtype))
            self.stem_bn = BatchNorm(cfg.width, cfg.dtype)
            self.blocks: "list[str]" = []
            features = cfg.width
            for stage, n_blocks in enumerate(cfg.stage_sizes):
                for b in range(n_blocks):
                    strides = 2 if stage > 0 and b == 0 else 1
                    name = f"s{stage}b{b}"
                    blk = block(features, cfg.width * 2 ** stage, strides,
                                cfg.dtype)
                    self.add_module(name, blk)
                    self.blocks.append(name)
                    features = blk.out_features
            self.head = nn.Linear(features, cfg.num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's init in place from ``generator`` (on the parameters'
        device): kernels lecun_normal (a unit normal truncated to [-2, 2]
        scaled to variance 1/fan_in), biases 0, BatchNorm scales 1 (0
        for each block's last) and running statistics 0 and 1.  The
        numbers differ from ``jax.random``'s; tests that compare the two
        packages convert the JAX weights instead."""
        for mod in self.modules():
            if isinstance(mod, (Conv, nn.Linear)):
                w = mod.weight
                fan_in = math.prod(w.shape[1:])
                t = torch.empty(w.shape, device=w.device)
                nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                w.copy_(t * (math.sqrt(1.0 / fan_in) / .87962566103423978))
                if isinstance(mod, nn.Linear):
                    mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.weight.fill_(0.0 if mod.zero_scale else 1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)

    def forward(self, images: torch.Tensor, train: bool = False
                ) -> torch.Tensor:
        cfg = self.config
        # NHWC memory viewed as [N, C, H, W]: the channels-last layout
        x = images.to(cfg.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.stem_bn(self.stem(x), train))
        if not cfg.cifar_stem:
            x, pad = _pad_same(x, 3, 2, value=-math.inf)
            x = F.max_pool2d(x, 3, 2, padding=pad)
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        x = x.float().mean((2, 3)).to(cfg.dtype)        # global avg pool
        # head in fp32: tiny matmul, and logits feed the loss softmax
        return F.linear(x.float(), self.head.weight, self.head.bias)


def synthetic_cifar10(n: int, seed: int = 0) -> ArrayDataset:
    """Separable CIFAR-10-shaped data: class-dependent mean images plus
    noise, NHWC fp32 (the JAX package's generator, draw for draw)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    base = np.random.default_rng(1234).standard_normal(
        (10, 32, 32, 3)).astype(np.float32)
    x = base[labels] + 0.4 * rng.standard_normal(
        (n, 32, 32, 3)).astype(np.float32)
    return ArrayDataset(x.astype(np.float32), labels.astype(np.int32))


class ResNetLightningModule(ClassificationModule):
    """Image classification (BASELINE config #2 workload): SGD with
    Nesterov momentum after a weight decay (``optax.chain(
    add_decayed_weights(wd), sgd(lr, momentum, nesterov=True))``)."""

    def __init__(self, config: "ResNetConfig | str" = "resnet50",
                 lr: float = 0.1, momentum: float = 0.9,
                 weight_decay: float = 1e-4, batch_size: int = 32,
                 train_size: int = 512, val_size: int = 128):
        super().__init__()
        if isinstance(config, str):
            config = CONFIGS[config]
        self.config = config
        self.save_hyperparameters("lr", "momentum", "batch_size")
        self.lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.batch_size = batch_size
        self.train_size = train_size
        self.val_size = val_size

    def configure_model(self, device=None):
        return ResNet(self.config, device=device)

    def configure_optimizers(self):
        return chain(add_decayed_weights(self.weight_decay),
                     SGD(self.lr, momentum=self.momentum, nesterov=True))

    def compute_logits(self, ctx, images):
        return ctx.model(images, ctx.training)

    def make_dataset(self, n, seed):
        return synthetic_cifar10(n, seed)


__all__ = ["BatchNorm", "BottleneckBlock", "CONFIGS", "Conv", "ResNet",
           "ResNetBlock", "ResNetConfig", "ResNetLightningModule",
           "same_pads", "synthetic_cifar10"]
