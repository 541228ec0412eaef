"""Metrics plane, off: the plane-off behaviour of
``ray_lightning_tpu/telemetry/metrics.py`` ``get_registry``, and its
name lint.

The registry, its pump and exporters are not ported yet (ROADMAP.md
queue 1 item 13), so the registry is always ``None`` and every caller's
``if reg is not None`` guard makes its instrument a no-op.  The name
rule is ported so the planes that publish (compile/cache.py
``publish_metrics``, the planner) lint their names today:
:data:`CORE_METRICS` lists the names of the ported planes.
"""

from __future__ import annotations

import re

#: Prometheus-clean instrument name: rlt_ prefix, lowercase, and a unit
#: suffix (the JAX rule)
NAME_RE = re.compile(r"^rlt_[a-z0-9_]+$")
UNIT_SUFFIXES = ("_bytes", "_seconds", "_total")

#: the instruments the ported planes publish (item 13 adds the rest)
CORE_METRICS = (
    "rlt_compile_seconds_total",
    "rlt_compile_cache_hits_total",
    "rlt_compile_cache_misses_total",
    "rlt_time_to_first_step_seconds",
    "rlt_plan_candidates_total",
    "rlt_plan_pruned_total",
    "rlt_plan_rejected_total",
    "rlt_plan_compiled_total",
    "rlt_plan_seconds",
)


def validate_metric_name(name: str) -> str:
    """Raise ``ValueError`` unless ``name`` is Prometheus-clean and
    carries a unit suffix; returns the name."""
    if not NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} must match {NAME_RE.pattern}")
    if not name.endswith(UNIT_SUFFIXES):
        raise ValueError(
            f"metric name {name!r} must end with a unit suffix "
            f"{UNIT_SUFFIXES}")
    return name


def get_registry() -> None:
    """The active metrics registry: none while the plane is not ported."""
    return None


__all__ = ["CORE_METRICS", "NAME_RE", "UNIT_SUFFIXES", "get_registry",
           "validate_metric_name"]
