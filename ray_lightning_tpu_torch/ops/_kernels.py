"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled
at first use with ``nvcc`` into its own shared library under
``build/ray_lightning_tpu_torch/`` at the repository root, keyed by a
hash of the sources, then loaded with ``ctypes``; kernels whose entry
points live in one source share its library.  No PyTorch headers
are involved, so a build takes seconds, not minutes.  :func:`build`
starts one ``nvcc`` per source at once (the smoke script's set-up).

A :class:`Kernel` also carries its launch counter: the wrapper bumps
``launches`` where it launches the kernel and nowhere else, so a run can
show that the main path went through it.

With the compile cache active (compile/cache.py) the libraries live in
its namespaced directory instead (:func:`set_library_dir`), so every
process pointed at one cache root finds the libraries the first one
built: each library a process needs counts once, a hit when its key is
found, a miss when nvcc runs (``compile.cache.stats``).  The same
keyed-artifact path builds any C source with another compiler
(``Kernel(compiler=, flags=, csrc=)``), which is how the CPU tests run
it without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "ray_lightning_tpu_torch")
#: where the CUDA toolkit puts nvcc when neither CUDA_HOME nor PATH says
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: every kernel the package defines, by name (filled by ``Kernel``)
REGISTRY: "dict[str, Kernel]" = {}
#: where libraries go: the compile cache's namespace while it is active
#: (compile/cache.py ``activate``), else :data:`BUILD_DIR`
_LIBRARY_DIR: "Path | None" = None
#: the libraries this process has counted for the cache's stats
_COUNTED: "set[Path]" = set()


def set_library_dir(path: "str | Path | None") -> None:
    """Build and load libraries under ``path`` (``None``: back to
    :data:`BUILD_DIR`).  Kernels already bound keep their library."""
    global _LIBRARY_DIR
    _LIBRARY_DIR = Path(path) if path is not None else None


def library_dir() -> Path:
    return _LIBRARY_DIR if _LIBRARY_DIR is not None else BUILD_DIR


def _count(path: Path, hit: bool, seconds: float = 0.0) -> None:
    """One library this process needs, counted once (module
    docstring)."""
    if path in _COUNTED:
        return
    _COUNTED.add(path)
    from ray_lightning_tpu_torch.compile import cache
    cache.note_library(hit, seconds)
#: one build at a time in this process: kernels that share a source
#: share its library and its temporary output, and threads (Tune trials)
#: may first use two of them at once
_BUILD_LOCK = threading.Lock()


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``.  Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


class Kernel:
    """One ``csrc/<source>`` library: build, load, bind, count.

    ``signature`` lists the C entry point's argument kinds, ``"p"`` for a
    pointer or the stream (``c_void_p``), ``"i"`` for an int
    (``c_int``), ``"u"`` for an unsigned 32-bit word (``c_uint``) and
    ``"f"`` for a float (``c_float``); the entry point returns
    ``cudaGetLastError()`` as an int.
    """

    def __init__(self, name: str, source: str, entry: str,
                 signature: str, compiler: str = "nvcc",
                 flags: "Sequence[str]" = NVCC_FLAGS,
                 csrc: "Path | None" = None, register: bool = True):
        self.name = name
        self.source = source
        self.entry = entry
        self.signature = signature
        self.compiler = compiler
        self.flags = tuple(flags)
        self._csrc = Path(csrc) if csrc is not None else None
        self.launches = 0
        self._count_lock = threading.Lock()
        #: nvcc's output of the last build (``-Xptxas=-v``: registers,
        #: shared memory and spills of each instantiation)
        self.build_log = ""
        self._fn = None
        self._lock = threading.Lock()
        if register:
            REGISTRY[name] = self

    @property
    def csrc(self) -> Path:
        return self._csrc if self._csrc is not None else CSRC

    @property
    def path(self) -> Path:
        return self.csrc / self.source

    def library_path(self) -> Path:
        """Build output, keyed by the sources and flags it depends on."""
        h = hashlib.sha256()
        for src in sorted(self.csrc.glob("*.c*")):
            if src.suffix in (".cuh", ".h") or src == self.path:
                h.update(src.name.encode())
                h.update(src.read_bytes())
        h.update(" ".join((self.compiler,) + self.flags).encode())
        stem = Path(self.source).stem
        return library_dir() / f"lib{stem}-{h.hexdigest()[:16]}.so"

    def find_compiler(self) -> str:
        if self.compiler == "nvcc":
            return find_nvcc()
        found = shutil.which(self.compiler)
        if found is None:
            raise RuntimeError(f"{self.compiler} not found on PATH")
        return found

    def build_command(self, compiler: str) -> "tuple[list[str], Path, Path]":
        out = self.library_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        return ([compiler, *self.flags, "-o", str(tmp), str(self.path)],
                tmp, out)

    def _bind(self):
        lib = ctypes.CDLL(str(self.library_path()))
        fn = getattr(lib, self.entry)
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int,
                 "u": ctypes.c_uint, "f": ctypes.c_float}
        fn.argtypes = [kinds[c] for c in self.signature]
        fn.restype = ctypes.c_int
        self._lib = lib     # keep the library alive with the binding
        return fn

    def function(self):
        """The bound C entry point, building the library on first use."""
        if self._fn is None:
            with self._lock:
                if self._fn is None:
                    if self.library_path().is_file():
                        _count(self.library_path(), hit=True)
                    else:
                        build([self])
                    self._fn = self._bind()
        return self._fn

    def launch(self, *args) -> None:
        """Call the entry point, count the launch, raise on a CUDA error
        (a refused launch never runs and no later sync reports it)."""
        err = self.function()(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.name} launch failed with cudaError_t {err} "
                f"(cuda_runtime_api.h names the codes)")
        with self._count_lock:      # threads may launch at once
            self.launches += 1


def build(kernels: "Optional[Sequence[Kernel]]" = None) -> float:
    """Compile every given kernel (default: all registered ones) whose
    library is missing, one ``nvcc`` each, all started together.
    Returns the wall seconds spent; raises with the compiler's output on
    a failed build."""
    with _BUILD_LOCK:
        return _build(kernels)


def _build(kernels: "Optional[Sequence[Kernel]]") -> float:
    t0 = time.monotonic()
    # kernels whose entry points share a source share its library: one
    # nvcc each library
    todo: "dict[Path, list[Kernel]]" = {}
    for k in (kernels if kernels is not None else REGISTRY.values()):
        path = k.library_path()
        if not path.is_file():
            todo.setdefault(path, []).append(k)
        else:
            _count(path, hit=True)
    if not todo:
        return 0.0
    library_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    failures = []
    try:
        for group in todo.values():
            k = group[0]
            cmd, tmp, out = k.build_command(k.find_compiler())
            procs.append((group, tmp, out, time.monotonic(),
                          subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
        for group, tmp, out, started, p in procs:
            k = group[0]
            log, _ = p.communicate()
            for g in group:
                g.build_log = log
            if p.returncode != 0:
                failures.append(f"{k.source}:\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)   # atomic: readers never see half
                _count(out, hit=False, seconds=time.monotonic() - started)
    finally:
        for *_, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return time.monotonic() - t0


def add_launches(counts: "dict[str, int]") -> None:
    """Add ``counts`` (kernel name -> launches) to the kernels' counters:
    a CUDA graph's replay runs the launches its capture recorded, and no
    wrapper's Python runs then (core/steps.py ``ChunkRunner``).  A
    negative count takes back launches a capture recorded but did not
    run."""
    for name, n in counts.items():
        k = REGISTRY[name]
        with k._count_lock:
            k.launches += n


def reset_launches() -> None:
    for k in REGISTRY.values():
        k.launches = 0


def launch_counts() -> "dict[str, int]":
    return {name: k.launches for name, k in REGISTRY.items()}


__all__ = ["Kernel", "REGISTRY", "add_launches", "build", "find_nvcc",
           "launch_counts", "library_dir", "reset_launches",
           "set_library_dir"]
