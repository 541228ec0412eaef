"""Bucketed sequence lengths: the static-shape contract of the serve
plane (a copy of ``ray_lightning_tpu/serve/buckets.py``).

Prompts are padded up to one of a small set of length buckets, so the
prefill runs at a handful of fixed shapes (the JAX package compiles one
program per bucket; the port will capture one CUDA graph per bucket).
Decode is bucket-free: one token per step against the slot-indexed KV
cache.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

#: default bucket ladder (powers of two): doubles cap the padding waste
#: at <2x tokens while keeping the compiled-program count logarithmic
DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)


def resolve_buckets(buckets: "Sequence[int] | None",
                    max_seq_len: int) -> tuple[int, ...]:
    """Validated ascending bucket ladder clipped to ``max_seq_len``.

    ``None`` takes :data:`DEFAULT_BUCKETS` up to the model context (a
    terminal ``max_seq_len`` bucket is always present so every
    admissible prompt has a home).
    """
    if max_seq_len < 1:
        raise ValueError(f"max_seq_len must be >= 1, got {max_seq_len}")
    if buckets is None:
        out = [b for b in DEFAULT_BUCKETS if b < max_seq_len]
        out.append(max_seq_len)
        return tuple(out)
    out = sorted({int(b) for b in buckets})
    if not out:
        raise ValueError("buckets must be non-empty")
    if out[0] < 1:
        raise ValueError(f"buckets must be positive, got {out[0]}")
    if out[-1] > max_seq_len:
        raise ValueError(
            f"bucket {out[-1]} exceeds the model context {max_seq_len}")
    return tuple(out)


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= ``length`` (raises when the prompt exceeds the
    terminal bucket — the admission-time length check)."""
    if length < 1:
        raise ValueError(f"prompt length must be >= 1, got {length}")
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(
        f"prompt length {length} exceeds the largest bucket {buckets[-1]}")


def pad_to_bucket(tokens: np.ndarray, bucket: int,
                  pad_id: int = 0) -> np.ndarray:
    """Right-pad a 1-D token array to ``[1, bucket]`` int32 (the prefill
    program's input shape).  Pad content is irrelevant by construction:
    the causal mask plus the decode position bound keep padded positions
    out of every attended window (core/steps.py build_prefill_step)."""
    tokens = np.asarray(tokens, dtype=np.int32).reshape(-1)
    if len(tokens) > bucket:
        raise ValueError(
            f"prompt length {len(tokens)} exceeds bucket {bucket}")
    out = np.full((1, bucket), pad_id, dtype=np.int32)
    out[0, :len(tokens)] = tokens
    return out


__all__ = ["DEFAULT_BUCKETS", "resolve_buckets", "bucket_for",
           "pad_to_bucket"]
