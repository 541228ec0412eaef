"""PyTorch/CUDA port, the example scripts run as a user runs them: each
in a subprocess, with ``--platform cpu --smoke-test`` (CPU workers on
gloo, one epoch of a few batches), from a scratch working directory so
their logs and trials stay out of the repository (tests/test_examples.py
runs the JAX package's the same way)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = [
    "ray_lightning_tpu_torch.examples.ray_ddp_example",
    "ray_lightning_tpu_torch.examples.ray_ddp_tune",
    "ray_lightning_tpu_torch.examples.ray_ddp_sharded_example",
    "ray_lightning_tpu_torch.examples.ray_spmd_example",
    "ray_lightning_tpu_torch.examples.ray_longcontext_example",
    "ray_lightning_tpu_torch.examples.ray_pipeline_example",
    "ray_lightning_tpu_torch.examples.ray_moe_example",
]


def run_example(module: str, cwd, *extra: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return subprocess.run(
        [sys.executable, "-m", module, "--platform", "cpu", "--smoke-test",
         *extra], capture_output=True, text=True, timeout=300, env=env,
        cwd=str(cwd))


@pytest.mark.parametrize("module", EXAMPLES)
def test_example_smoke(module, tmp_path):
    proc = run_example(module, tmp_path)
    assert proc.returncode == 0, (
        f"{module} failed\nstdout:\n{proc.stdout}\nstderr:\n{proc.stderr}")
    if module.endswith("ray_ddp_tune"):
        assert "Best hyperparameters found were" in proc.stdout
    else:
        assert "Final metrics:" in proc.stdout
    if module.endswith("ray_ddp_sharded_example"):
        # the perf callback's epoch line, from the worker (CPU: no
        # device memory to report) and its metrics on the driver
        assert "Epoch 0: " in proc.stdout
        assert "'epoch_time_s'" in proc.stdout


def test_ddp_example_tune_smoke(tmp_path):
    proc = run_example(EXAMPLES[0], tmp_path, "--tune", "--local-dir",
                       str(tmp_path / "sweep"))
    assert proc.returncode == 0, (
        f"tune sweep failed\nstdout:\n{proc.stdout}\nstderr:\n{proc.stderr}")
    assert "Best hyperparameters found were" in proc.stdout
    # the experiment's shared kernel cache lives beside its trials
    # (tune/runner.py <exp_dir>/compile_cache)
    entries = sorted(os.listdir(tmp_path / "sweep" / "tune_mnist"))
    trials = [e for e in entries if e != "compile_cache"]
    assert trials == ["trial_00000", "trial_00001"]
    assert entries == ["compile_cache", *trials]
    for t in trials:
        assert os.path.isfile(tmp_path / "sweep" / "tune_mnist" / t /
                              "logs" / "metrics.csv")


@pytest.mark.parametrize("workers", ["0", "2"])
def test_perf_tuning_example_smoke(workers, tmp_path):
    """The tuning walk in process and over two gloo workers: a line per
    configuration, each fit the same 4 steps (one epoch of 4 batches)."""
    proc = run_example(
        "ray_lightning_tpu_torch.examples.ray_perf_tuning_example",
        tmp_path, "--num-workers", workers)
    assert proc.returncode == 0, (
        f"failed\nstdout:\n{proc.stdout}\nstderr:\n{proc.stderr}")
    lines = [ln for ln in proc.stdout.splitlines() if "steps/s" in ln]
    assert [ln.split("  ")[0] for ln in lines] == [
        "streamed (baseline)", "steps_per_execution=8",
        "+ cache_train_dataset", "+ precision=bf16"]
    steps = {4 if workers == "0" else 2}
    assert all(f"({s} steps in" in ln for ln in lines for s in steps)
