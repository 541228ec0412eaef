"""Telemetry: the plane-off surface the serve path calls (no-op spans,
no metrics registry).  The telemetry plane itself is not ported yet."""

from ray_lightning_tpu_torch.telemetry.spans import span  # noqa: F401

__all__ = ["span"]
