"""Core: ``LightningModule`` and ``StepContext``, the step builders
(init, train, eval, serve prefill and decode), the single-device
``Trainer``, data loading, callbacks and the train state."""
