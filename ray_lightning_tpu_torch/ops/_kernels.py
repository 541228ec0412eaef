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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
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
    (``c_int``) and ``"f"`` for a float (``c_float``); the entry point
    returns ``cudaGetLastError()`` as an int.
    """

    def __init__(self, name: str, source: str, entry: str,
                 signature: str):
        self.name = name
        self.source = source
        self.entry = entry
        self.signature = signature
        self.launches = 0
        self._count_lock = threading.Lock()
        #: nvcc's output of the last build (``-Xptxas=-v``: registers,
        #: shared memory and spills of each instantiation)
        self.build_log = ""
        self._fn = None
        self._lock = threading.Lock()
        REGISTRY[name] = self

    @property
    def path(self) -> Path:
        return CSRC / self.source

    def library_path(self) -> Path:
        """Build output, keyed by the sources and flags it depends on."""
        h = hashlib.sha256()
        for src in sorted(CSRC.glob("*.cu*")):
            if src.suffix == ".cuh" or src == self.path:
                h.update(src.name.encode())
                h.update(src.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        stem = Path(self.source).stem
        return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"

    def build_command(self, nvcc: str) -> "tuple[list[str], Path, Path]":
        out = self.library_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        return ([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(self.path)],
                tmp, out)

    def _bind(self):
        lib = ctypes.CDLL(str(self.library_path()))
        fn = getattr(lib, self.entry)
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int,
                 "f": ctypes.c_float}
        fn.argtypes = [kinds[c] for c in self.signature]
        fn.restype = ctypes.c_int
        self._lib = lib     # keep the library alive with the binding
        return fn

    def function(self):
        """The bound C entry point, building the library on first use."""
        if self._fn is None:
            with self._lock:
                if self._fn is None:
                    if not self.library_path().is_file():
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
    import time
    t0 = time.monotonic()
    # kernels whose entry points share a source share its library: one
    # nvcc each library
    todo: "dict[Path, list[Kernel]]" = {}
    for k in (kernels if kernels is not None else REGISTRY.values()):
        if not k.library_path().is_file():
            todo.setdefault(k.library_path(), []).append(k)
    if not todo:
        return 0.0
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    failures = []
    try:
        for group in todo.values():
            k = group[0]
            cmd, tmp, out = k.build_command(nvcc)
            procs.append((group, tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for group, tmp, out, p in procs:
            k = group[0]
            log, _ = p.communicate()
            for g in group:
                g.build_log = log
            if p.returncode != 0:
                failures.append(f"{k.source}:\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)   # atomic: readers never see half
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
           "launch_counts", "reset_launches"]
