"""Host-side spans, off: the disabled ``span`` of
``ray_lightning_tpu/telemetry/spans.py`` (a no-op context manager;
the recorder is not ported yet)."""

from __future__ import annotations

import contextlib
from typing import Any

_NOOP = contextlib.nullcontext()


def span(name: str, **attrs: Any):
    """Time a host-side phase: a no-op while no recorder is ported."""
    return _NOOP


__all__ = ["span"]
