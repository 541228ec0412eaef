"""Native (C++) input-pipeline runtime, bound through ctypes.

Counterpart of ``ray_lightning_tpu/native/__init__.py``, with its own
copy of the source (``src/prefetch.cpp``): a dependency-free C++ core
that assembles batches with a multithreaded row-gather and prefetches
them on a background thread, so host batch assembly overlaps the card's
compute instead of serializing with it.  Host code, not a kernel.

Build model: compiled at first use with the system ``g++`` into
``build/ray_lightning_tpu_torch/`` at the repository root (beside the
kernels, ops/_kernels.py), keyed by a hash of the source and flags, via
a per-pid temporary file and an atomic rename, so concurrent worker
processes race safely.  Without a toolchain the library is ``None`` and
the loader falls back to the Python path, as the JAX package does; a
failed build logs a warning and is counted (``stats["build_failures"]``),
so a caller that needs the native path can tell.  ``RLT_NATIVE=0``
turns it off, ``RLT_NATIVE_THREADS`` sets the gather's threads.
``stats["epochs"]`` and ``stats["batches"]`` count what it served.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_log = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "src" / "prefetch.cpp"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "ray_lightning_tpu_torch")
#: the JAX build's flags less ``-march=native``: a library left in the
#: build directory must load on another machine's CPU (its row gather is
#: memcpy, which needs no host-specific instructions)
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False
#: builds that failed, epochs and batches the prefetcher served
stats = {"build_failures": 0, "epochs": 0, "batches": 0}


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"librlt_native-{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        stats["build_failures"] += 1
        _log.warning("native build failed (%s); using the Python path", e)
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p = ctypes.c_void_p
    i64 = ctypes.c_int64
    lib.rlt_prefetcher_create.restype = p
    lib.rlt_prefetcher_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int]
    lib.rlt_prefetcher_set_array.argtypes = [p, ctypes.c_int, p, i64]
    lib.rlt_prefetcher_set_slot.argtypes = [p, ctypes.c_int, ctypes.c_int, p]
    lib.rlt_prefetcher_start.argtypes = [p, ctypes.POINTER(i64), i64, i64,
                                         ctypes.c_int]
    lib.rlt_prefetcher_next.restype = i64
    lib.rlt_prefetcher_next.argtypes = [p, ctypes.POINTER(i64)]
    lib.rlt_prefetcher_release.argtypes = [p, i64]
    lib.rlt_prefetcher_stop.argtypes = [p]
    lib.rlt_prefetcher_destroy.argtypes = [p]
    lib.rlt_gather.argtypes = [p, i64, ctypes.POINTER(i64), i64, p,
                               ctypes.c_int]
    return lib


def load_library() -> Optional[ctypes.CDLL]:
    """The native library, building it if missing; ``None`` when it
    cannot be built (no toolchain) or ``RLT_NATIVE=0``."""
    global _lib, _lib_failed
    if os.environ.get("RLT_NATIVE", "1") == "0":
        return None
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            out = library_path()
            if not out.is_file() and not _compile(out):
                _lib_failed = True
                return None
            _lib = _bind(ctypes.CDLL(str(out)))
        except OSError as e:
            stats["build_failures"] += 1
            _log.warning("native library unusable (%s)", e)
            _lib_failed = True
            _lib = None
        return _lib


def native_available() -> bool:
    return load_library() is not None


def default_threads() -> int:
    env = os.environ.get("RLT_NATIVE_THREADS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            _log.warning("ignoring malformed RLT_NATIVE_THREADS=%r", env)
    return min(4, os.cpu_count() or 1)


def _as_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class NativePrefetcher:
    """Batch prefetcher over a fixed set of source arrays.

    Per epoch, Python hands it the index order and iterates.  Each batch
    is yielded with OWNERSHIP: the consumer keeps the arrays for good
    (the Python path's fresh ``take()`` copies); the wrapper installs a
    freshly allocated buffer into the vacated ring slot before releasing
    it to the producer, so no yielded batch is ever overwritten, even
    while a copy to the card still reads it.
    """

    def __init__(self, arrays: "list[np.ndarray]", batch_size: int,
                 queue_depth: int = 3, n_threads: Optional[int] = None):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        # sources must stay alive and contiguous for the prefetcher's life
        self._sources = [np.ascontiguousarray(a) for a in arrays]
        self.batch_size = int(batch_size)
        # depth < 2 would let a stale ready flag satisfy the next wait
        self.queue_depth = max(2, int(queue_depth))
        self._handle = lib.rlt_prefetcher_create(
            len(self._sources), self.queue_depth,
            n_threads or default_threads())
        self._slots: "list[list[np.ndarray]]" = []
        for a_i, a in enumerate(self._sources):
            row_bytes = a.dtype.itemsize * int(np.prod(a.shape[1:],
                                                       dtype=np.int64))
            lib.rlt_prefetcher_set_array(self._handle, a_i, _as_ptr(a),
                                         row_bytes)
        for s in range(self.queue_depth):
            slot_bufs = []
            for a_i, a in enumerate(self._sources):
                buf = np.empty((self.batch_size,) + a.shape[1:],
                               dtype=a.dtype)
                lib.rlt_prefetcher_set_slot(self._handle, s, a_i,
                                            _as_ptr(buf))
                slot_bufs.append(buf)
            self._slots.append(slot_bufs)

    def iter_epoch(self, indices: np.ndarray):
        """Yield one list of per-array batches (caller-owned) per batch,
        in ``indices`` order (a partial last batch included, as the
        Python path yields it)."""
        lib, h = self._lib, self._handle
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        lib.rlt_prefetcher_start(
            h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
            self.batch_size, 0)
        stats["epochs"] += 1
        nrows = ctypes.c_int64()
        try:
            while True:
                slot = lib.rlt_prefetcher_next(h, ctypes.byref(nrows))
                if slot < 0:
                    break
                rows = int(nrows.value)
                bufs = self._slots[slot]
                # hand these buffers to the consumer and give the slot
                # fresh ones (np.empty is lazy: the pages fault in the
                # producer thread); set_slot before release: the producer
                # reads slot pointers only after seeing the slot free
                # under the same mutex
                fresh = [np.empty_like(b) for b in bufs]
                for a_i, nb in enumerate(fresh):
                    lib.rlt_prefetcher_set_slot(h, int(slot), a_i,
                                                _as_ptr(nb))
                self._slots[slot] = fresh
                lib.rlt_prefetcher_release(h, slot)
                stats["batches"] += 1
                yield [b[:rows] for b in bufs]
        finally:
            lib.rlt_prefetcher_stop(h)  # abort on an early exit

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.rlt_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def gather(src: np.ndarray, indices: np.ndarray,
           out: Optional[np.ndarray] = None,
           n_threads: Optional[int] = None) -> np.ndarray:
    """Threaded ``src[indices]`` for 1+-D contiguous arrays; numpy's
    fancy indexing when the native library is unavailable."""
    lib = load_library()
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    if lib is None:
        result = src[idx]
        if out is not None:
            out[:len(idx)] = result
            return out[:len(idx)]
        return result
    if out is None:
        out = np.empty((len(idx),) + src.shape[1:], dtype=src.dtype)
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:],
                                                 dtype=np.int64))
    lib.rlt_gather(_as_ptr(src), row_bytes,
                   idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                   len(idx), _as_ptr(out), n_threads or default_threads())
    return out[:len(idx)]


__all__ = ["NativePrefetcher", "default_threads", "gather",
           "load_library", "native_available", "stats"]
