"""Metrics plane, off: the plane-off behaviour of
``ray_lightning_tpu/telemetry/metrics.py`` ``get_registry``.

The registry, its pump and exporters are not ported yet, so the
registry is always ``None`` and every caller's ``if reg is not None``
guard makes its instrument a no-op.
"""

from __future__ import annotations


def get_registry() -> None:
    """The active metrics registry: none while the plane is not ported."""
    return None


__all__ = ["get_registry"]
