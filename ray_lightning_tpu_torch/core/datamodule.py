"""``LightningDataModule``: dataloaders and the data lifecycle hooks,
apart from the model.

Counterpart of ``ray_lightning_tpu/core/datamodule.py``.  The
``Trainer`` calls ``prepare_data`` once and ``setup(stage)`` once per
stage, and takes a datamodule's loader ahead of the module's.
"""

from __future__ import annotations


class LightningDataModule:
    """Groups dataloaders and data lifecycle hooks, separable from the
    model."""

    def __init__(self):
        self.trainer = None
        self._prepared = False
        self._setup_stages: "set[str]" = set()

    def prepare_data(self) -> None:
        """One-time data materialization (download etc.)."""

    def setup(self, stage: str) -> None:
        """Per-stage setup (splits, transforms)."""

    def train_dataloader(self):
        return None

    def val_dataloader(self):
        return None

    def test_dataloader(self):
        return None

    def predict_dataloader(self):
        return None

    # -- lifecycle bookkeeping (idempotent, like PL) ------------------------

    def _call_prepare_data(self) -> None:
        if not self._prepared:
            self.prepare_data()
            self._prepared = True

    def _call_setup(self, stage: str) -> None:
        if stage not in self._setup_stages:
            self.setup(stage)
            self._setup_stages.add(stage)


__all__ = ["LightningDataModule"]
