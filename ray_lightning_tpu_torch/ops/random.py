"""Keyed random draws: the same bits in an eager step, in a CUDA graph's
replay and in a remat recompute.

The JAX package's steps take their key as an argument of the jitted
program and split it (``ray_lightning_tpu/core/module.py`` ``make_rng``),
so a compiled step draws fresh numbers every call.  A ``torch.Generator``
cannot read its seed from device memory: a CUDA graph captured over a
``torch.rand`` replays one seed.  Here a draw is a pure function of a
**key** (two uint32 words in an int64 [2] tensor, on the draw's device)
and a **stream id** (a host int naming the draw site), so:

- the trainer computes each step's key words on the host
  (:func:`key_words` of the step's entropy); an eager step copies them
  to the device, a graphed chunk feeds the k steps' words through a
  static input (core/steps.py ``ChunkRunner``), and both run the same
  kernel on the same words;
- a site's stream id comes from its fold-in path on the host
  (:meth:`Key.fold_in`), the same in every step, so a graph freezes
  nothing that changes;
- a recompute (remat) draws the same bits again: nothing is stateful.

:func:`philox_uniform` is the draw: Philox4x32-10 keyed by the words,
its counter the element group and the stream id, each uint32 output
word ``w`` becoming ``(w >> 8) * 2**-24`` in float32 (exact).  A CUDA
key launches ``csrc/philox.cu``; a CPU key takes
:func:`philox_uniform_plain`, the same function in int64 torch
arithmetic, so the CPU gives the card's bits.  It is the torch custom
op ``rlt::philox_uniform`` (:data:`PHILOX_OP`), which remat policies
see.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch

from ray_lightning_tpu_torch.ops._kernels import Kernel

KERNEL = Kernel("philox_uniform", "philox.cu", "rlt_philox_uniform",
                "ppi" + "uu" + "i" + "p")

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
#: stream ids are 62-bit (a custom op's int argument is a signed int64)
_STREAM_BITS = 62


def _mix64(z: np.ndarray) -> np.ndarray:
    """SplitMix64's finaliser over uint64 (wrapping): a bijection that
    spreads every input bit over the output."""
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def key_words(*entropy) -> np.ndarray:
    """Two uint32 key words of ``entropy`` (non-negative ints, or int
    arrays that broadcast: the seed, the step, the microbatch, the
    rank), as int64 ``[..., 2]``: each entry folded into a SplitMix64
    chain that starts from the tuple's length.  Vectorised, so a graphed
    chunk makes its k steps' words at once."""
    h = np.uint64(len(entropy))
    with np.errstate(over="ignore"):
        for x in entropy:
            h = _mix64(h + np.uint64(0x9E3779B97F4A7C15)
                       + np.asarray(x, dtype=np.uint64))
    h = np.asarray(h, dtype=np.uint64)
    return np.stack([h & np.uint64(_MASK), h >> np.uint64(32)],
                    -1).astype(np.int64)


@functools.lru_cache(maxsize=4096)
def stream_id(path: "tuple[int, ...]") -> int:
    """The stream id of a draw site's fold-in path (cached: a step's
    sites repeat every step).  The path's length leads the entropy:
    ``SeedSequence`` pads its entropy with zeros, so ``(1,)`` and ``(1,
    0)`` would otherwise name one stream."""
    if not path:
        return 0
    w = np.random.SeedSequence((len(path), *path)).generate_state(
        2, np.uint32)
    return ((int(w[1]) << 32) | int(w[0])) & ((1 << _STREAM_BITS) - 1)


def _mulhilo(a: torch.Tensor, m: int) -> "tuple[torch.Tensor, torch.Tensor]":
    """``(hi, lo)`` words of ``a * m`` for uint32 values ``a`` held in
    int64 and a uint32 constant ``m``, without overflowing int64: ``m``
    is split into 16-bit halves, each partial product under 2**48."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _MASK


def philox4x32(c: "list[torch.Tensor]", k0, k1) -> "list[torch.Tensor]":
    """Ten Philox4x32 rounds over the counter words ``c`` (int64 tensors
    of uint32 values) under the key words ``k0``, ``k1``."""
    c0, c1, c2, c3 = c
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK
        k1 = (k1 + _W1) & _MASK
    return [c0, c1, c2, c3]


def philox_uniform_plain(key: torch.Tensor, stream: int,
                         shape: Sequence[int]) -> torch.Tensor:
    """The kernel's function in plain PyTorch on ``key``'s device:
    float32 ``shape`` of ``(w >> 8) * 2**-24`` for element ``i``'s word
    ``i % 4`` of Philox4x32-10 over counter ``(g, g >> 32, stream,
    stream >> 32)``, ``g = i // 4``, under the key ``key``."""
    n = math.prod(shape)
    groups = -(-n // 4)
    g = torch.arange(groups, dtype=torch.int64, device=key.device)
    c = [g & _MASK, g >> 32,
         torch.full_like(g, stream & _MASK), torch.full_like(g, stream >> 32)]
    k = key.to(torch.int64) & _MASK
    words = torch.stack(philox4x32(c, k[0], k[1]), dim=1).reshape(-1)[:n]
    return ((words >> 8).to(torch.float32)
            * (1.0 / 16777216.0)).reshape(tuple(shape))


def _check_key(key: torch.Tensor) -> None:
    if key.shape != (2,) or key.dtype != torch.int64:
        raise TypeError(f"a key is int64 [2], got {key.dtype} "
                        f"{tuple(key.shape)}")


def philox_uniform_cuda(key: torch.Tensor, stream: int,
                        shape: Sequence[int]) -> torch.Tensor:
    """``csrc/philox.cu`` on ``key``'s card: the kernel reads the key
    words from device memory (a graph's static input replays fresh
    ones), writes float32 ``shape``."""
    n = math.prod(shape)
    if n >= 2 ** 31:
        raise ValueError(f"philox_uniform takes fewer than 2**31 elements, "
                         f"got {n}")
    out = torch.empty(tuple(shape), dtype=torch.float32, device=key.device)
    if n == 0:
        return out
    KERNEL.launch(key.contiguous().data_ptr(), out.data_ptr(), n,
                  stream & _MASK, stream >> 32, key.device.index or 0,
                  torch.cuda.current_stream(key.device).cuda_stream)
    return out


def philox_uniform(key: torch.Tensor, stream: int,
                   shape: Sequence[int]) -> torch.Tensor:
    """Uniform [0, 1) float32 of ``shape`` on ``key``'s device, a pure
    function of the key words and ``stream`` (see the module): a CUDA
    key launches the kernel, a CPU key takes
    :func:`philox_uniform_plain`."""
    _check_key(key)
    if not 0 <= stream < 2 ** _STREAM_BITS:
        raise ValueError(f"stream id {stream} out of [0, 2**62)")
    return PHILOX_OP(key, stream, [int(s) for s in shape])


@torch.library.custom_op("rlt::philox_uniform", mutates_args=(),
                         device_types="cuda")
def PHILOX_OP(key: torch.Tensor, stream: int,
              shape: list[int]) -> torch.Tensor:
    """``rlt::philox_uniform``: the kernel on a CUDA key."""
    return philox_uniform_cuda(key, stream, shape)


PHILOX_OP.register_kernel("cpu")(philox_uniform_plain)


@PHILOX_OP.register_fake
def _(key, stream, shape):
    return key.new_empty(tuple(shape), dtype=torch.float32)


class Key:
    """One draw site's key: the step's key words (``words``, an int64 [2]
    tensor on the device the draws land on) and the site's fold-in path
    (host ints).  ``fold_in`` extends the path (the counterpart of
    ``jax.random.fold_in``), ``uniform`` draws.  Picklable and
    comparable, so a test can carry one across processes."""

    __slots__ = ("words", "path")

    def __init__(self, words: torch.Tensor, path: "tuple[int, ...]" = ()):
        _check_key(words)
        self.words = words
        self.path = tuple(int(p) for p in path)

    def fold_in(self, *path: int) -> "Key":
        return Key(self.words, self.path + tuple(path))

    def to(self, device) -> "Key":
        return Key(self.words.to(device), self.path)

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        return philox_uniform(self.words, stream_id(self.path), shape)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Key) and self.path == other.path
                and torch.equal(self.words.cpu(), other.words.cpu()))

    def __reduce__(self):
        return Key, (self.words.cpu(), self.path)

    def __repr__(self) -> str:
        return f"Key({self.words.tolist()}, path={self.path})"


def as_key(seed: "int | Key", device) -> Key:
    """``seed`` as a :class:`Key` whose words live on ``device``: an int
    seeds :func:`key_words`; a key moves there (a copy only when it
    lives elsewhere)."""
    if isinstance(seed, Key):
        device = torch.device(device)
        if seed.words.device == device or (
                device.type == "cuda" and device.index is None
                and seed.words.device.type == "cuda"):
            return seed
        return seed.to(device)
    return Key(torch.from_numpy(key_words(int(seed))).to(device))


__all__ = ["KERNEL", "Key", "PHILOX_OP", "as_key", "key_words", "philox4x32",
           "philox_uniform", "philox_uniform_cuda", "philox_uniform_plain",
           "stream_id"]
