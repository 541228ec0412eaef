"""Shared scaffolding for classification-style LightningModules.

Counterpart of ``ray_lightning_tpu/models/common.py``: cross-entropy and
accuracy over ``(inputs, int_labels)`` batches, the logged metrics and
the loaders, and ``predict_step``: the argmax class over the test
loader's inputs.  Subclasses implement :meth:`compute_logits` and
:meth:`make_dataset`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ray_lightning_tpu_torch.core.data import DataLoader
from ray_lightning_tpu_torch.core.module import LightningModule


class ClassificationModule(LightningModule):
    """Cross-entropy classification over ``(inputs, int_labels)`` batches.

    Subclass contract:
      - ``compute_logits(ctx, inputs) -> [B, num_classes]``
      - ``make_dataset(n, seed) -> ArrayDataset`` of (inputs, labels)
      - attributes ``batch_size``, ``train_size``, ``val_size``
    """

    def compute_logits(self, ctx, inputs):
        raise NotImplementedError

    def make_dataset(self, n: int, seed: int):
        raise NotImplementedError

    # -- steps ------------------------------------------------------------

    def _logits_loss_acc(self, ctx, batch):
        """fp32 mean cross-entropy (optax's
        ``softmax_cross_entropy_with_integer_labels``, max-shifted) and
        the share of argmax hits."""
        inputs, labels = batch
        logits = self.compute_logits(ctx, inputs)
        labels = labels.long()
        loss = F.cross_entropy(logits.float(), labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        return logits, loss, acc

    def training_step(self, ctx, batch):
        _, loss, acc = self._logits_loss_acc(ctx, batch)
        ctx.log("loss", loss)
        ctx.log("train_accuracy", acc)
        return loss

    def validation_step(self, ctx, batch):
        _, loss, acc = self._logits_loss_acc(ctx, batch)
        ctx.log("val_loss", loss)
        ctx.log("val_accuracy", acc)

    def test_step(self, ctx, batch):
        _, loss, acc = self._logits_loss_acc(ctx, batch)
        ctx.log("test_loss", loss)
        ctx.log("test_accuracy", acc)

    def predict_step(self, ctx, batch):
        inputs = batch[0] if isinstance(batch, (tuple, list)) else batch
        return torch.argmax(self.compute_logits(ctx, inputs), dim=-1)

    # -- loaders ----------------------------------------------------------

    def _loader(self, n, seed, shuffle=False):
        return DataLoader(self.make_dataset(n, seed),
                          batch_size=self.batch_size, shuffle=shuffle,
                          drop_last=True)

    def train_dataloader(self):
        return self._loader(self.train_size, 0, shuffle=True)

    def val_dataloader(self):
        return self._loader(self.val_size, 1)

    def test_dataloader(self):
        return self._loader(self.val_size, 2)

    def predict_dataloader(self):
        return self.test_dataloader()


__all__ = ["ClassificationModule"]
