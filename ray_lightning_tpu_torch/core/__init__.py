"""Core: ``LightningModule`` and ``StepContext``, the step builders
(init, train, eval, serve prefill and decode), the single-device
``Trainer`` with checkpointing, data loading, datamodules, callbacks
(``ModelCheckpoint``, ``EarlyStopping``) and the train state."""
