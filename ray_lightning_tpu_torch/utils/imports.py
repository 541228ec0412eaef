"""Optional-dependency guards.

Counterpart of ``ray_lightning_tpu/utils/imports.py`` (the reference's
``Unavailable`` sentinel and ``TUNE_INSTALLED`` flag pattern,
``ray_lightning/util.py:40-44``, ``ray_lightning/tune.py:13-27``): a
missing optional dependency is replaced by a class that raises a clear
error on use, never on import.  The JAX package's ``TORCH_AVAILABLE``
has no meaning here: the port is built on torch.
"""

from __future__ import annotations

import importlib.util


class Unavailable:
    """Placeholder for a class from a dependency that is not installed:
    raises on instantiation and on subclassing, not on import."""

    _reason = "This class requires a dependency that is not installed."

    def __init__(self, *args, **kwargs):
        raise ImportError(self._reason)

    def __init_subclass__(cls, **kwargs):
        raise ImportError(cls._reason)


def _has(mod: str) -> bool:
    try:
        return importlib.util.find_spec(mod) is not None
    except (ImportError, ModuleNotFoundError, ValueError):
        return False


#: True when a real Ray runtime is importable.  The port's plugins use
#: the built-in subprocess actor backend (cluster/local.py) either way;
#: Tune's callbacks also deliver into a live Ray Tune session
#: (tune/ray_bridge.py) when one exists.
RAY_AVAILABLE: bool = _has("ray")


__all__ = ["RAY_AVAILABLE", "Unavailable"]
