"""Test-fixture models: ``BoringModel`` and ``LightningMNISTClassifier``.

Counterpart of ``ray_lightning_tpu/models/boring.py`` (the reference's
``tests/utils.py:16-148``).  ``BoringModel`` is a linear 32 -> 2
regression against zeros, the smallest module that drives the whole
train / validate / test / predict surface; ``LightningMNISTClassifier``
a 3-layer MLP over a synthetic MNIST-shaped dataset, whose accuracy
shows a learning signal.  The datasets are the JAX package's, draw for
draw.  The layers are named ``Dense_0``, ``Dense_1``, ... as flax names
them, so ``convert.flax_to_torch`` maps the JAX params one to one; each
computes in the promoted dtype of its input and weight, as flax's
``Dense`` does (a bf16 batch against fp32 weights runs in fp32).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_lightning_tpu_torch._device import resolve_device
from ray_lightning_tpu_torch.core.data import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.core.module import LightningModule
from ray_lightning_tpu_torch.models.gpt import init_weights
from ray_lightning_tpu_torch.ops.attention import linear
from ray_lightning_tpu_torch.ops.optim import SGD, AdamW


class RandomDataset(ArrayDataset):
    """``(length, size)`` standard normal fp32 rows."""

    def __init__(self, size: int, length: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        super().__init__(rng.standard_normal((length, size),
                                             dtype=np.float32))


class DenseStack(nn.Module):
    """flax ``Dense`` layers ``Dense_0 .. Dense_{n-1}`` over the
    flattened input, ReLU between them."""

    #: its layers gather sharded weights at use (ops/attention.py
    #: ``linear``; parallel/layout.py)
    shardable = True

    def __init__(self, sizes: "tuple[int, ...]", device=None):
        super().__init__()
        self.n = len(sizes) - 1
        with torch.device(resolve_device(device)):
            for i, (a, b) in enumerate(zip(sizes, sizes[1:])):
                self.add_module(f"Dense_{i}", nn.Linear(a, b))

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's init: kernels lecun_normal, biases 0."""
        init_weights(self, (), generator)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n):
            layer = getattr(self, f"Dense_{i}")
            x = linear(layer, x, torch.promote_types(x.dtype,
                                                     layer.weight.dtype))
            if i < self.n - 1:
                x = F.relu(x)
        return x


class BoringModel(LightningModule):
    """Minimal end-to-end module: SGD drives a linear map's outputs on
    gaussian inputs towards zero."""

    def __init__(self, lr: float = 0.1, dataset_length: int = 64,
                 batch_size: int = 2):
        super().__init__()
        self.save_hyperparameters()
        self.lr = lr
        self.dataset_length = dataset_length
        self.batch_size = batch_size

    def configure_model(self, device=None):
        return DenseStack((32, 2), device)

    def configure_optimizers(self):
        return SGD(self.lr)

    def _loss(self, ctx, batch):
        return torch.mean(ctx.model(batch) ** 2)

    def training_step(self, ctx, batch):
        loss = self._loss(ctx, batch)
        ctx.log("loss", loss)
        return loss

    def validation_step(self, ctx, batch):
        ctx.log("val_loss", self._loss(ctx, batch))

    def test_step(self, ctx, batch):
        ctx.log("test_loss", self._loss(ctx, batch))

    def predict_step(self, ctx, batch):
        return ctx.model(batch)

    def _loader(self, seed=0):
        return DataLoader(RandomDataset(32, self.dataset_length, seed),
                          batch_size=self.batch_size)

    def train_dataloader(self):
        return self._loader(0)

    def val_dataloader(self):
        return self._loader(1)

    def test_dataloader(self):
        return self._loader(2)

    def predict_dataloader(self):
        return self._loader(3)


def synthetic_mnist(n: int, seed: int = 0) -> ArrayDataset:
    """Separable MNIST-shaped data: each class a fixed 28 x 28 prototype
    plus noise (the JAX package's generator, draw for draw)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    base = np.random.default_rng(42).standard_normal(
        (10, 28 * 28)).astype(np.float32)
    x = base[labels] + 0.3 * rng.standard_normal(
        (n, 28 * 28)).astype(np.float32)
    return ArrayDataset(x.reshape(n, 28, 28).astype(np.float32),
                        labels.astype(np.int32))


class LightningMNISTClassifier(LightningModule):
    """3-layer MLP classifier with Adam (``optax.adam``: AdamW without
    decay, b2 0.999)."""

    def __init__(self, config: Optional[dict] = None, data_dir: str = "",
                 train_size: int = 512, val_size: int = 128):
        super().__init__()
        config = config or {}
        self.save_hyperparameters()
        self.lr = config.get("lr", 1e-2)
        self.batch_size = int(config.get("batch_size", 32))
        self.hidden1 = int(config.get("layer_1", 128))
        self.hidden2 = int(config.get("layer_2", 256))
        self.data_dir = data_dir
        self.train_size = train_size
        self.val_size = val_size

    def configure_model(self, device=None):
        return DenseStack((28 * 28, self.hidden1, self.hidden2, 10), device)

    def configure_optimizers(self):
        return AdamW(self.lr, weight_decay=0.0, b1=0.9, b2=0.999)

    def _logits_loss_acc(self, ctx, batch):
        x, y = batch
        logits = ctx.model(x)
        y = y.long()
        loss = F.cross_entropy(logits.float(), y)
        acc = (logits.argmax(-1) == y).float().mean()
        return logits, loss, acc

    def training_step(self, ctx, batch):
        _, loss, acc = self._logits_loss_acc(ctx, batch)
        ctx.log("ptl/train_loss", loss)
        ctx.log("ptl/train_accuracy", acc)
        return loss

    def validation_step(self, ctx, batch):
        _, loss, acc = self._logits_loss_acc(ctx, batch)
        ctx.log("ptl/val_loss", loss)
        ctx.log("ptl/val_accuracy", acc)
        ctx.log("val_loss", loss)
        ctx.log("val_accuracy", acc)

    def test_step(self, ctx, batch):
        _, loss, acc = self._logits_loss_acc(ctx, batch)
        ctx.log("test_loss", loss)
        ctx.log("test_accuracy", acc)

    def predict_step(self, ctx, batch):
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        return torch.argmax(ctx.model(x), dim=-1)

    def train_dataloader(self):
        return DataLoader(synthetic_mnist(self.train_size, seed=0),
                          batch_size=self.batch_size, shuffle=True)

    def val_dataloader(self):
        return DataLoader(synthetic_mnist(self.val_size, seed=1),
                          batch_size=self.batch_size)

    def test_dataloader(self):
        return DataLoader(synthetic_mnist(self.val_size, seed=2),
                          batch_size=self.batch_size)

    def predict_dataloader(self):
        return self.test_dataloader()


__all__ = ["BoringModel", "DenseStack", "LightningMNISTClassifier",
           "RandomDataset", "synthetic_mnist"]
