"""Compile-cache management: the kernel libraries, keyed and shared.

Counterpart of ``ray_lightning_tpu/compile/cache.py``.  There the cache
holds XLA executables keyed by the program's HLO; a port step has no
program to compile, and what a process pays before its first launch is
the ``nvcc`` build of each kernel library (ops/_kernels.py: one shared
library a ``csrc/*.cu``, keyed by a hash of its sources and flags) plus
the capture of its CUDA graphs.  So on CUDA the cache holds the kernel
libraries:

- :class:`CompileCacheConfig`: picklable settings carried on the
  Trainer, resolved from the ``compile_cache=`` argument, the
  ``RLT_COMPILE_CACHE*`` env knobs, or the live Tune trial (tune.run
  points every trial of an experiment at ``<exp_dir>/compile_cache``);
- :func:`activate`: the libraries then live under :func:`namespace_dir`
  of the root, ``<root>/torch<ver>-cuda<ver>-<device name>-sm<cc>-
  d<devices>-p<procs>`` (the JAX ``jax<ver>-<platform>-<kind>-d<devices>
  -p<procs>``), so a library of another torch, toolkit, card or world
  never meets this run's.  A run's processes share one namespace: a
  worker takes its driver's (``worker_env`` carries it,
  ``RLT_COMPILE_CACHE_NS``), since a kernel library depends on none of
  the world's sizes, so the forked actors, the Tune trials and a
  restarted worker find what the first process built;
- accounting: a *hit* is a library found by its key, a *miss* an nvcc
  run; ``compile seconds`` are the nvcc seconds plus the CUDA-graph
  capture seconds (:func:`note_capture`: a capture is per process, so
  it counts as seconds and never as a hit).  :func:`publish_metrics`
  mirrors them as ``rlt_compile_cache_hits_total`` /
  ``rlt_compile_cache_misses_total`` / ``rlt_compile_seconds_total``,
  :func:`note_first_step` sets ``rlt_time_to_first_step_seconds``;
  a worker's counters come back to its driver (:func:`note_remote`,
  :func:`drain_remote`).

The JAX config's ``min_entry_bytes`` / ``min_compile_secs`` (and their
``RLT_COMPILE_CACHE_MIN_*`` knobs) choose which XLA executables are
worth persisting; the port persists every library (one file of a few
MB, seconds of nvcc each), so it has neither.
"""

from __future__ import annotations

import logging
import os
import re
import threading
from dataclasses import dataclass, field
from typing import Any, Optional

_log = logging.getLogger(__name__)

#: default cache root when enabled without a directory
DEFAULT_ROOT = os.path.join(os.path.expanduser("~"), ".cache",
                            "ray_lightning_tpu_torch", "kernels")

ENV_ENABLE = "RLT_COMPILE_CACHE"            # 0 | 1 | /path/to/root
ENV_DIR = "RLT_COMPILE_CACHE_DIR"           # explicit root directory
ENV_KNOBS = (ENV_ENABLE, ENV_DIR)
#: the namespace a driver activated, which its workers take (worker_env)
ENV_NAMESPACE = "RLT_COMPILE_CACHE_NS"


@dataclass
class CompileCacheConfig:
    """Picklable compile-cache settings carried on the Trainer."""

    enabled: bool = False
    #: cache root; the namespace is appended at activation (None:
    #: :data:`DEFAULT_ROOT`)
    dir: Optional[str] = None

    @classmethod
    def resolve(cls, value: Any) -> "CompileCacheConfig":
        """``compile_cache=`` -> a config (the JAX rules): ``None``
        defers to the env and the live Tune trial (``RLT_COMPILE_CACHE=0``
        turns everything off; an env dir wins over the trial's; bare
        ``RLT_COMPILE_CACHE=1`` the default root); ``True`` / ``False``
        force; a string is a root; a dict overrides fields."""
        if isinstance(value, cls):
            return value
        if isinstance(value, bool):
            return cls(enabled=value)
        if isinstance(value, str):
            return cls(enabled=True, dir=value)
        if isinstance(value, dict):
            cfg = dict(value)
            cfg.setdefault("enabled", True)
            return cls(**cfg)
        if value is not None:
            raise TypeError(
                f"compile_cache must be None/bool/str/dict/"
                f"CompileCacheConfig; got {type(value).__name__}")
        enable = os.environ.get(ENV_ENABLE, "").strip()
        if enable == "0":
            return cls()
        env_dir = os.environ.get(ENV_DIR, "").strip() or None
        if enable not in ("", "0", "1") and env_dir is None:
            env_dir = enable
        if env_dir is None:
            env_dir = _session_cache_dir()
        if env_dir is None and enable != "1":
            return cls()
        return cls(enabled=True, dir=env_dir)

    @property
    def root(self) -> str:
        return self.dir or DEFAULT_ROOT

    def worker_env(self) -> "dict[str, str]":
        """Env replicating this config in a worker process, with the
        namespace this process activated under the same root (module
        docstring: the run's processes share one directory)."""
        if not self.enabled:
            return {}
        env = {ENV_ENABLE: "1", ENV_DIR: self.root}
        if _active_dir is not None \
                and os.path.dirname(_active_dir) == os.path.abspath(
                    self.root):
            env[ENV_NAMESPACE] = os.path.basename(_active_dir)
        return env


def _session_cache_dir() -> Optional[str]:
    """The live Tune trial's shared cache dir, or None."""
    try:
        from ray_lightning_tpu_torch.tune.session import \
            get_compile_cache_dir
        return get_compile_cache_dir()
    except Exception:   # noqa: BLE001 - outside a trial
        return None


def _clean(text: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.+-]+", "-", str(text))


def namespace_dir(root: str) -> str:
    """The namespaced subdirectory of ``root`` (module docstring): torch
    and CUDA versions, the card's name and compute capability, the
    visible cards and the processes of the world; in a worker whose
    driver activated the cache, the driver's (``RLT_COMPILE_CACHE_NS``,
    set by ``worker_env``)."""
    inherited = os.environ.get(ENV_NAMESPACE, "").strip()
    if inherited:
        return os.path.join(os.path.abspath(root), _clean(inherited))
    import torch

    from ray_lightning_tpu_torch.parallel.strategy import world_size
    if torch.cuda.is_available():
        name = torch.cuda.get_device_name(0)
        cc = "".join(str(v) for v in torch.cuda.get_device_capability(0))
        devices = torch.cuda.device_count()
    else:
        name, cc, devices = "cpu", "0", 1
    ns = (f"torch{torch.__version__}-cuda{torch.version.cuda or 'none'}"
          f"-{name}-sm{cc}-d{devices}-p{world_size()}")
    return os.path.join(os.path.abspath(root), _clean(ns))


# -- activation -----------------------------------------------------------

_active_dir: Optional[str] = None
_activate_lock = threading.Lock()


def activate(config: Optional[CompileCacheConfig]) -> Optional[str]:
    """Point the kernel libraries at the config's namespaced dir
    (idempotent; another root re-targets).  Returns the active dir, or
    None when disabled."""
    global _active_dir
    if config is None or not config.enabled:
        return None
    from ray_lightning_tpu_torch.ops import _kernels
    with _activate_lock:
        ns = namespace_dir(config.root)
        os.makedirs(ns, exist_ok=True)
        if _active_dir != ns:
            _kernels.set_library_dir(ns)
            _active_dir = ns
            _log.info("kernel compile cache at %s", ns)
        return ns


def deactivate() -> None:
    """Back to the build directory (tests use this so one cache dir
    never leaks into the next)."""
    global _active_dir
    from ray_lightning_tpu_torch.ops import _kernels
    with _activate_lock:
        _kernels.set_library_dir(None)
        _active_dir = None


def active_dir() -> Optional[str]:
    return _active_dir


# -- accounting -----------------------------------------------------------

@dataclass
class CacheStats:
    """Cumulative compile / cache accounting for this process."""

    hits: int = 0
    misses: int = 0
    #: nvcc seconds
    build_secs: float = 0.0
    #: CUDA-graph capture seconds (per process: never a hit)
    capture_secs: float = 0.0
    captures: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    @property
    def backend_compile_secs(self) -> float:
        """The JAX name: every second spent compiling (nvcc + capture)."""
        return self.build_secs + self.capture_secs

    def snapshot(self) -> "CacheStats":
        with self._lock:
            return CacheStats(hits=self.hits, misses=self.misses,
                              build_secs=self.build_secs,
                              capture_secs=self.capture_secs,
                              captures=self.captures)

    def to_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "build_seconds": round(self.build_secs, 6),
                "capture_seconds": round(self.capture_secs, 6),
                "captures": self.captures,
                "compile_seconds": round(self.backend_compile_secs, 6)}


_stats = CacheStats()


def note_library(hit: bool, seconds: float = 0.0) -> None:
    """One kernel library needed by this process: found by its key
    (``hit``) or built by nvcc in ``seconds`` (ops/_kernels.py)."""
    with _stats._lock:
        if hit:
            _stats.hits += 1
        else:
            _stats.misses += 1
            _stats.build_secs += float(seconds)


def note_capture(seconds: float) -> None:
    """One CUDA-graph capture of ``seconds`` (core/steps.py)."""
    with _stats._lock:
        _stats.captures += 1
        _stats.capture_secs += float(seconds)


def stats() -> CacheStats:
    """A consistent snapshot of this process's counters."""
    return _stats.snapshot()


def reset_stats() -> None:
    with _stats._lock:
        _stats.hits = _stats.misses = _stats.captures = 0
        _stats.build_secs = _stats.capture_secs = 0.0


def status_word() -> str:
    """``hit`` (a library came from the cache in this process), ``miss``
    (active, everything built fresh) or ``off`` (no cache active)."""
    if _active_dir is None:
        return "off"
    return "hit" if stats().hits > 0 else "miss"


def engine_stats() -> dict:
    """The ``compile_cache`` entry of an engine's stats: active, the
    dir, the status word and this process's counters (JAX
    ``serve/engine.py:649-669``)."""
    d = {"active": _active_dir is not None, "dir": _active_dir,
         "status": status_word()}
    d.update(stats().to_dict())
    return d


#: counters other processes reported back to this one (a plugin's
#: ranks at the end of their stage), with where they came from
_REMOTE: "list[dict]" = []
_REMOTE_LOCK = threading.Lock()


def note_remote(counters: Optional[dict], where: str) -> None:
    """Record a worker process's :meth:`CacheStats.to_dict` (the plugins
    call it for each rank's, so a driver can tell how warm its workers
    started)."""
    if counters is not None:
        with _REMOTE_LOCK:
            _REMOTE.append({"where": where, **counters})


def drain_remote() -> "list[dict]":
    """The workers' counters noted since the last drain."""
    with _REMOTE_LOCK:
        out = list(_REMOTE)
        _REMOTE.clear()
    return out


def publish_metrics(registry) -> None:
    """Mirror the counters into a metrics registry (anything with
    ``gauge(name).set(value)``)."""
    s = stats()
    registry.gauge("rlt_compile_cache_hits_total").set(s.hits)
    registry.gauge("rlt_compile_cache_misses_total").set(s.misses)
    registry.gauge("rlt_compile_seconds_total").set(
        round(s.backend_compile_secs, 6))


def note_first_step(seconds: float) -> None:
    """Record time-to-first-step into the metrics plane (a no-op while
    its registry is not ported, telemetry/metrics.py)."""
    from ray_lightning_tpu_torch.telemetry import metrics as _metrics
    reg = _metrics.get_registry()
    if reg is not None:
        reg.gauge("rlt_time_to_first_step_seconds").set(round(seconds, 6))


__all__ = ["CacheStats", "CompileCacheConfig", "DEFAULT_ROOT", "ENV_KNOBS",
           "ENV_NAMESPACE",
           "activate", "active_dir", "deactivate", "drain_remote",
           "engine_stats", "namespace_dir", "note_capture",
           "note_first_step", "note_library", "note_remote",
           "publish_metrics", "reset_stats", "stats", "status_word"]
