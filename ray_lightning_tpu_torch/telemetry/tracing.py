"""Request tracing, off: ``mint_trace_id`` and the plane-off
``record_request_span`` of ``ray_lightning_tpu/telemetry/tracing.py``.

Trace ids are minted as in the JAX package so plans carry them; with no
aggregator ported, recording a driver-side request span does nothing.
"""

from __future__ import annotations

import uuid
from typing import Any, Optional


def mint_trace_id() -> str:
    """One request's trace id: 16 hex chars."""
    return uuid.uuid4().hex[:16]


def record_request_span(name: str, t0: float, t1: Optional[float] = None,
                        **attrs: Any) -> None:
    """Feed one driver-side request span to the active aggregator: a
    no-op, since none is ported yet."""
    return None


__all__ = ["mint_trace_id", "record_request_span"]
