"""PyTorch/CUDA port, the observability callbacks of ``ray_lightning_tpu_
torch.utils.profiling`` on the CPU (tests/test_profiling.py's
behaviours): ``ThroughputMonitor`` logs the JAX package's names into
``callback_metrics`` (and carries no device memory off CUDA); tokens/s
only for token batches; ``TorchProfilerCallback`` writes a Chrome trace
of its window and keeps the profile; both ride a ``RayPlugin`` fit."""

import json
import os

import pytest
import torch

from ray_lightning_tpu_torch import (BoringModel, GPTLightningModule,
                                     RayPlugin, Trainer)
from ray_lightning_tpu_torch.utils.profiling import (ThroughputMonitor,
                                                     TorchProfilerCallback,
                                                     peak_device_memory_bytes)


def _trainer(tmp_path, callbacks, **kw):
    kw.setdefault("device", "cpu")
    return Trainer(max_epochs=1, limit_train_batches=8, limit_val_batches=0,
                   num_sanity_val_steps=0, enable_checkpointing=False,
                   logger=False, seed=0, default_root_dir=str(tmp_path),
                   callbacks=callbacks, **kw)


def test_throughput_monitor_logs_its_names(tmp_path):
    trainer = _trainer(tmp_path, [ThroughputMonitor(window=4)])
    trainer.fit(BoringModel(dataset_length=64, batch_size=4))
    cbm = trainer.callback_metrics
    assert cbm["steps_per_sec"] > 0
    assert cbm["samples_per_sec"] == pytest.approx(4 * cbm["steps_per_sec"])
    assert cbm["epoch_time_s"] > 0
    assert "tokens_per_sec" not in cbm      # float rows, not tokens
    assert "peak_memory_mb" not in cbm      # no card
    assert peak_device_memory_bytes() is None
    assert peak_device_memory_bytes("cpu") is None


def test_throughput_monitor_tokens_for_sequences(tmp_path):
    trainer = _trainer(tmp_path, [ThroughputMonitor(window=4)])
    trainer.fit(GPTLightningModule("tiny", dataset_size=64, batch_size=4))
    cbm = trainer.callback_metrics
    # token batches are [B, T]: tokens/s = samples/s x T
    assert cbm["tokens_per_sec"] == pytest.approx(64 * cbm["samples_per_sec"])


def test_profiler_callback_writes_a_trace(tmp_path):
    prof = TorchProfilerCallback(start_step=2, num_steps=3,
                                 log_dir=str(tmp_path / "prof"))
    _trainer(tmp_path, [prof]).fit(BoringModel(dataset_length=64,
                                               batch_size=4))
    assert prof.trace_path == str(tmp_path / "prof" /
                                  "trace_rank0_step2.json")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    ops = {e.key for e in prof.profile.key_averages()}
    assert any(k.startswith("aten::") for k in ops)


def test_profiler_window_past_the_fit_closes_at_train_end(tmp_path):
    """A window longer than the fit closes at ``on_train_end``; one that
    starts after the last step writes nothing."""
    long = TorchProfilerCallback(start_step=6, num_steps=10,
                                 log_dir=str(tmp_path / "long"))
    late = TorchProfilerCallback(start_step=50, log_dir=str(tmp_path /
                                                             "late"))
    _trainer(tmp_path, [long, late]).fit(BoringModel(dataset_length=64,
                                                     batch_size=4))
    assert os.path.exists(long.trace_path)
    assert late.trace_path is None and not os.path.exists(tmp_path / "late")


def test_callbacks_ride_a_plugin_fit(tmp_path):
    """Under ``RayPlugin`` the monitor's metrics come back with rank 0's
    and each worker writes its own trace under ``default_root_dir``."""
    trainer = _trainer(tmp_path, [ThroughputMonitor(window=2),
                                  TorchProfilerCallback(start_step=1,
                                                        num_steps=2)],
                       device=None, plugins=[RayPlugin(
                           num_workers=2, platform="cpu", timeout_s=90)])
    trainer.fit(BoringModel(dataset_length=32, batch_size=2))
    assert trainer.callback_metrics["steps_per_sec"] > 0
    traces = sorted(os.listdir(tmp_path / "profile"))
    assert traces == ["trace_rank0_step1.json", "trace_rank1_step1.json"]
    assert torch.cuda.is_initialized() is False
