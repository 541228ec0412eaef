"""Core: the ``LightningModule`` serve hooks and the serve step
builders."""
