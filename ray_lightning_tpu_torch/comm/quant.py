"""Blockwise quantize/dequantize codecs (a port of the codec half of
``ray_lightning_tpu/comm/quant.py``).

Plain torch ops on any device, so one codec serves both of its users:
the fleet router's KV-page ship, which encodes and decodes CPU tensors
in the driver (serve/fleet/router.py), and the int8-resident draft,
whose dequantize runs inside the draft programs on the card
(serve/engine.py).  Every step follows the JAX codec's order and
precision, so the bytes on the wire are the JAX package's bytes.

int8 scheme: symmetric per-block scaling.  A flat payload is viewed as
``[..., n_blocks, block_size]``; each block carries one fp32 scale
``max|x| / 127`` and stores ``round(x * (1 / scale))`` in int8 (round
half to even).  Zero blocks quantize to zeros with a zero scale, so the
decode's multiply restores exact zeros.

fp8 scheme (e4m3): per-block scaling to the e4m3fn range (max 448),
then a round-to-nearest-even cast to ``float8_e4m3fn``; the payload is
its bit pattern as ``uint8``, one byte per element.

int4 scheme: per-block scales ``max|x| / 7``, values in [-7, 7] stored
offset-encoded (q + 8) two to a byte, the low nibble first: the
payload's last dim is half the element count.

bf16 scheme: a plain cast (no scales).

fp32 subnormals flush to zero at the codec's inputs, scales and
decoded outputs, as XLA flushes them on the CPU and the TPU: a
subnormal block encodes as a zero block, so the bytes stay the JAX
package's.

Stochastic rounding (``stochastic=True``, the compressed collectives'
unbiased quantizer): one uniform draw an element, ``floor(x / scale +
u)`` for the integer codecs and, for fp8, the lower or upper e4m3 grid
neighbour with probability proportional to the distance, as the JAX
codec draws them.  The draws come from ``key`` (ops/random.py ``Key``,
the keyed Philox), never a ``torch.Generator``, so they replay inside a
CUDA graph; their bits differ from ``jax.random``'s, and the two
packages agree in distribution only.  bf16 is a plain cast in either
mode, as in the JAX codec.
"""

from __future__ import annotations

from typing import Optional

import torch

INT8_LEVELS = 127.0
INT4_LEVELS = 7.0
FP8_MAX = 448.0          # float8_e4m3fn max finite value

#: every mode ``compress_cast`` accepts
CODEC_MODES = ("int8", "bf16", "fp8", "int4")


FP8_MANT_BITS = 3
FP8_MIN_EXP = -6         # smallest normal exponent of e4m3


def _uniform(key, shape) -> torch.Tensor:
    """The quantizer's draws: uniform [0, 1) of ``shape`` from ``key``."""
    if key is None:
        raise ValueError("stochastic rounding needs a key "
                         "(ops/random.py Key)")
    return key.uniform(tuple(shape))


_TINY = torch.finfo(torch.float32).tiny


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """fp32 subnormals to zero of their sign (module docstring)."""
    return torch.where(x.abs() < _TINY, x * 0, x)


def _block_view(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """[..., n] -> [..., n // bs, bs]; n must already divide."""
    if x.shape[-1] % block_size:
        raise ValueError(
            f"last dim {x.shape[-1]} not a multiple of block {block_size}")
    return x.reshape(tuple(x.shape[:-1])
                     + (x.shape[-1] // block_size, block_size))


def _block_scale(blocks: torch.Tensor, levels: float) -> torch.Tensor:
    """The per-block fp32 scale ``max|x| / levels`` (zero for a zero
    block)."""
    return _ftz(blocks.abs().amax(dim=-1) / levels)


def _inverse(scale: torch.Tensor) -> torch.Tensor:
    """``1 / scale`` per block, zero where the scale is zero."""
    pos = scale > 0
    return torch.where(pos, 1.0 / torch.where(pos, scale,
                                              torch.ones_like(scale)),
                       torch.zeros_like(scale))


def _int_round(val: torch.Tensor, levels: float, stochastic: bool = False,
               key=None) -> torch.Tensor:
    if stochastic:
        val = torch.floor(val + _uniform(key, val.shape))
    else:
        val = torch.round(val)
    return torch.clamp(val, -levels, levels)


#: the levels each scaled codec divides a block's ``max|x|`` by
LEVELS = {"int8": INT8_LEVELS, "fp8": FP8_MAX, "int4": INT4_LEVELS}


def _encode(blocks: torch.Tensor, scale: torch.Tensor, mode: str,
            shape, stochastic: bool = False, key=None) -> torch.Tensor:
    """The payload of ``blocks`` ``[..., n_blocks, block_size]`` (fp32,
    subnormals flushed) at the per-block ``scale``, for the flat
    ``shape``: int8 levels, the e4m3 bit pattern as uint8, or int4
    nibble pairs (``[..., n // 2]``)."""
    val = blocks * _inverse(scale)[..., None]
    if mode == "int8":
        return _int_round(val, INT8_LEVELS, stochastic,
                          key).to(torch.int8).reshape(shape)
    if mode == "fp8":
        if stochastic:
            val = _fp8_stochastic_round(val, key)
        # round to nearest even; |val| <= 448, so it never overflows
        return val.to(torch.float8_e4m3fn).view(torch.uint8).reshape(shape)
    q = (_int_round(val, INT4_LEVELS, stochastic, key) + 8.0).to(
        torch.uint8).reshape(shape)
    pairs = q.reshape(tuple(shape[:-1]) + (shape[-1] // 2, 2))
    return pairs[..., 0] | (pairs[..., 1] << 4)


def _quantize(x: torch.Tensor, mode: str, block_size: int,
              stochastic: bool, key):
    blocks = _block_view(_ftz(x.to(torch.float32)), block_size)
    scale = _block_scale(blocks, LEVELS[mode])
    return _encode(blocks, scale, mode, x.shape, stochastic, key), scale


def blockwise_quantize(x: torch.Tensor, block_size: int = 64, *,
                       stochastic: bool = False, key=None):
    """Quantize ``x`` (last dim a multiple of ``block_size``) to int8:
    ``(q, scale)``, ``q`` int8 shaped like ``x``, ``scale`` fp32 shaped
    ``[..., n_blocks]``."""
    return _quantize(x, "int8", block_size, stochastic, key)


def blockwise_dequantize(q: torch.Tensor, scale: torch.Tensor,
                         block_size: int = 64) -> torch.Tensor:
    """Inverse of :func:`blockwise_quantize` (fp32 out)."""
    blocks = _block_view(q.to(torch.float32), block_size)
    return _ftz(blocks * scale[..., None]).reshape(q.shape)


def _fp8_stochastic_round(v: torch.Tensor, key) -> torch.Tensor:
    """Stochastic rounding onto the e4m3 grid: the lower or upper
    neighbouring representable value with probability proportional to
    the fractional distance (``E[result] == v``).  ``v`` is already
    scaled into [-FP8_MAX, FP8_MAX]; the result is representable, so the
    round-to-nearest cast after it is exact."""
    a = v.abs()
    e = torch.floor(torch.log2(torch.where(a > 0, a, torch.ones_like(a))))
    e = torch.clamp(e, FP8_MIN_EXP, 8)        # subnormals share 2^-6's ulp
    ulp = torch.exp2(e - FP8_MANT_BITS)
    lower = torch.floor(a / ulp) * ulp
    frac = (a - lower) / ulp
    u = _uniform(key, v.shape)
    a_sr = torch.clamp(lower + torch.where(u < frac, ulp,
                                           torch.zeros_like(ulp)),
                       max=FP8_MAX)
    return torch.sign(v) * a_sr


def fp8_blockwise_quantize(x: torch.Tensor, block_size: int = 64, *,
                           stochastic: bool = False, key=None):
    """Quantize to e4m3 with per-block range scaling: ``(payload,
    scale)``, ``payload`` the f8 bit pattern as uint8 shaped like
    ``x``."""
    return _quantize(x, "fp8", block_size, stochastic, key)


def fp8_blockwise_dequantize(payload: torch.Tensor, scale: torch.Tensor,
                             block_size: int = 64) -> torch.Tensor:
    q8 = payload.contiguous().view(torch.float8_e4m3fn)
    blocks = _block_view(q8.to(torch.float32), block_size)
    return _ftz(blocks * scale[..., None]).reshape(payload.shape)


def int4_blockwise_quantize(x: torch.Tensor, block_size: int = 64, *,
                            stochastic: bool = False, key=None):
    """Quantize to 4-bit levels [-7, 7] with per-block scales, two
    values a byte (low nibble first, offset q + 8): ``(payload,
    scale)``, ``payload`` uint8 shaped ``[..., n // 2]``.
    ``block_size`` must be even."""
    if block_size % 2:
        raise ValueError(f"int4 needs an even block size, got {block_size}")
    return _quantize(x, "int4", block_size, stochastic, key)


def int4_blockwise_dequantize(payload: torch.Tensor, scale: torch.Tensor,
                              block_size: int = 64) -> torch.Tensor:
    lo = (payload & 0xF).to(torch.float32) - 8.0
    hi = (payload >> 4).to(torch.float32) - 8.0
    full = torch.stack([lo, hi], dim=-1).reshape(
        tuple(payload.shape[:-1]) + (payload.shape[-1] * 2,))
    blocks = _block_view(full, block_size)
    return _ftz(blocks * scale[..., None]).reshape(full.shape)


def compress_cast(x: torch.Tensor, mode: str, block_size: int = 64, *,
                  stochastic: bool = False, key=None):
    """Uniform ``(payload, scale)`` encode for every codec: int8/fp8
    return a 1-byte payload shaped like ``x`` plus per-block scales,
    int4 a half-length packed payload, bf16 the cast with
    ``scale=None``.  ``stochastic`` draws from ``key`` (module
    docstring)."""
    if mode == "bf16":
        return x.to(torch.bfloat16), None
    kw = dict(stochastic=stochastic, key=key)
    if mode == "int8":
        return blockwise_quantize(x, block_size, **kw)
    if mode == "fp8":
        return fp8_blockwise_quantize(x, block_size, **kw)
    if mode == "int4":
        return int4_blockwise_quantize(x, block_size, **kw)
    raise ValueError(f"unknown compression mode {mode!r}; "
                     f"options: {CODEC_MODES}")


def decompress_cast(q: torch.Tensor, scale: Optional[torch.Tensor],
                    mode: str, block_size: int = 64) -> torch.Tensor:
    """fp32 decode matching :func:`compress_cast`."""
    if mode == "bf16":
        return q.to(torch.float32)
    if mode == "int8":
        return blockwise_dequantize(q, scale, block_size)
    if mode == "fp8":
        return fp8_blockwise_dequantize(q, scale, block_size)
    if mode == "int4":
        return int4_blockwise_dequantize(q, scale, block_size)
    raise ValueError(f"unknown compression mode {mode!r}; "
                     f"options: {CODEC_MODES}")


def decode_levels(q: torch.Tensor, mode: str) -> torch.Tensor:
    """The codec's unscaled fp32 values of ``q`` (int8 / fp8 / int4;
    int4 unpacked to the full length): :func:`decompress_cast` before
    the per-block scale multiplies in."""
    if mode == "int8":
        return q.to(torch.float32)
    if mode == "fp8":
        return q.contiguous().view(torch.float8_e4m3fn).to(torch.float32)
    if mode == "int4":
        lo = (q & 0xF).to(torch.float32) - 8.0
        hi = (q >> 4).to(torch.float32) - 8.0
        return torch.stack([lo, hi], dim=-1).reshape(
            tuple(q.shape[:-1]) + (q.shape[-1] * 2,))
    raise ValueError(f"no scaled levels for mode {mode!r}")


def payload_bytes(n_elements: int, mode: str, block_size: int = 64) -> int:
    """Wire bytes of ``n_elements`` compressed: 1-byte data + fp32
    per-block scales for int8/fp8, two elements a byte for int4, no
    scales for bf16; ``raw`` (and any other uncompressed mode) charges
    fp32.  The fleet's KV-ship accounting measures codec savings in
    these units against the raw leg."""
    if mode == "bf16":
        return 2 * n_elements
    n_blocks = -(-n_elements // block_size)
    if mode == "int8" or mode == "fp8":
        return n_elements + 4 * n_blocks
    if mode == "int4":
        return -(-n_elements // 2) + 4 * n_blocks
    return 4 * n_elements


def quantize_blob(x, mode: str, block_size: int = 64):
    """Shape-agnostic ``(payload, scale)`` encode for whole tensors:
    flattened to 1-D and zero-padded up to a block multiple (except for
    bf16) before encoding; :func:`dequantize_blob` strips the pad.
    ``mode="raw"`` is fp32 on the wire, the uncompressed control leg of
    KV shipping that the codec ratios are measured against."""
    x = torch.as_tensor(x)
    if mode == "raw":
        return x.to(torch.float32), None
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.shape[0]) % block_size
    if pad and mode != "bf16":
        flat = torch.nn.functional.pad(flat, (0, pad))
    return compress_cast(flat, mode, block_size)


def dequantize_blob(payload, scale, mode: str, shape,
                    block_size: int = 64,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Decode matching :func:`quantize_blob`: unpad, reshape to
    ``shape``, cast to ``dtype``."""
    if mode == "raw":
        return torch.as_tensor(payload).reshape(tuple(shape)).to(dtype)
    flat = decompress_cast(payload, scale, mode, block_size)
    n = 1
    for d in shape:
        n *= int(d)
    return flat[:n].reshape(tuple(shape)).to(dtype)


__all__ = ["CODEC_MODES", "FP8_MANT_BITS", "FP8_MAX", "FP8_MIN_EXP",
           "INT4_LEVELS", "INT8_LEVELS", "LEVELS", "blockwise_dequantize",
           "blockwise_quantize", "compress_cast", "decode_levels",
           "decompress_cast", "dequantize_blob", "fp8_blockwise_dequantize",
           "fp8_blockwise_quantize", "int4_blockwise_dequantize",
           "int4_blockwise_quantize", "payload_bytes", "quantize_blob"]
