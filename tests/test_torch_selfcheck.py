"""PyTorch/CUDA port, ``ray_lightning_tpu_torch.ops.selfcheck``: the
decode path's invariants on the CPU (the counterpart of the JAX
package's ``ops/selfcheck.py``), in process and as the module's command
line, and the JAX package's decode dispatch order on the same inputs."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from ray_lightning_tpu.ops.flash_decode import (
    resolve_decode_impl as jax_resolve_decode_impl)
from ray_lightning_tpu_torch.ops import selfcheck
from ray_lightning_tpu_torch.ops.flash_decode import resolve_decode_impl

ROOT = Path(__file__).resolve().parents[1]


def test_selfcheck_finds_no_problem():
    assert selfcheck.run() == []


def test_selfcheck_command_line():
    out = subprocess.run(
        [sys.executable, "-m", "ray_lightning_tpu_torch.ops.selfcheck"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OK" in out.stdout


@pytest.mark.parametrize("value,env", [("dense", "flash_decode"),
                                       (None, "paged"), ("paged", None),
                                       ("flash_decode", "dense")])
def test_decode_impl_order_matches_jax(value, env, monkeypatch):
    """An explicit value beats ``RLT_DECODE_IMPL``, as in the JAX
    package (auto differs on purpose: the card takes the kernel where
    the JAX package keeps the dense path off the TPU)."""
    if env:
        monkeypatch.setenv("RLT_DECODE_IMPL", env)
    else:
        monkeypatch.delenv("RLT_DECODE_IMPL", raising=False)
    assert resolve_decode_impl(value, "cpu") == jax_resolve_decode_impl(
        value)
