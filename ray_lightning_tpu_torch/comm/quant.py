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

Stochastic rounding, which belongs with the compressed collectives and
their error-feedback residual, is not ported: asking for it raises,
naming its ROADMAP.md item.
"""

from __future__ import annotations

from typing import Optional

import torch

INT8_LEVELS = 127.0
INT4_LEVELS = 7.0
FP8_MAX = 448.0          # float8_e4m3fn max finite value

#: every mode ``compress_cast`` accepts
CODEC_MODES = ("int8", "bf16", "fp8", "int4")


def _deterministic(stochastic: bool) -> None:
    if stochastic:
        raise NotImplementedError(
            "stochastic rounding belongs with the compressed collectives "
            "and is not ported yet (ROADMAP.md queue 1 item 7)")


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


def _block_scale(blocks: torch.Tensor, levels: float):
    """(scale, inv_scale) per block in fp32; zero blocks get zero for
    both."""
    scale = _ftz(blocks.abs().amax(dim=-1) / levels)
    pos = scale > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, scale,
                                             torch.ones_like(scale)),
                      torch.zeros_like(scale))
    return scale, inv


def _int_round(val: torch.Tensor, levels: float) -> torch.Tensor:
    return torch.clamp(torch.round(val), -levels, levels)


def blockwise_quantize(x: torch.Tensor, block_size: int = 64, *,
                       stochastic: bool = False):
    """Quantize ``x`` (last dim a multiple of ``block_size``) to int8:
    ``(q, scale)``, ``q`` int8 shaped like ``x``, ``scale`` fp32 shaped
    ``[..., n_blocks]``."""
    _deterministic(stochastic)
    blocks = _block_view(_ftz(x.to(torch.float32)), block_size)
    scale, inv = _block_scale(blocks, INT8_LEVELS)
    q = _int_round(blocks * inv[..., None], INT8_LEVELS).to(torch.int8)
    return q.reshape(x.shape), scale


def blockwise_dequantize(q: torch.Tensor, scale: torch.Tensor,
                         block_size: int = 64) -> torch.Tensor:
    """Inverse of :func:`blockwise_quantize` (fp32 out)."""
    blocks = _block_view(q.to(torch.float32), block_size)
    return _ftz(blocks * scale[..., None]).reshape(q.shape)


def fp8_blockwise_quantize(x: torch.Tensor, block_size: int = 64, *,
                           stochastic: bool = False):
    """Quantize to e4m3 with per-block range scaling: ``(payload,
    scale)``, ``payload`` the f8 bit pattern as uint8 shaped like
    ``x``."""
    _deterministic(stochastic)
    blocks = _block_view(_ftz(x.to(torch.float32)), block_size)
    scale, inv = _block_scale(blocks, FP8_MAX)
    # round to nearest even; |val| <= 448, so it never overflows
    q8 = (blocks * inv[..., None]).to(torch.float8_e4m3fn)
    return q8.view(torch.uint8).reshape(x.shape), scale


def fp8_blockwise_dequantize(payload: torch.Tensor, scale: torch.Tensor,
                             block_size: int = 64) -> torch.Tensor:
    q8 = payload.contiguous().view(torch.float8_e4m3fn)
    blocks = _block_view(q8.to(torch.float32), block_size)
    return _ftz(blocks * scale[..., None]).reshape(payload.shape)


def int4_blockwise_quantize(x: torch.Tensor, block_size: int = 64, *,
                            stochastic: bool = False):
    """Quantize to 4-bit levels [-7, 7] with per-block scales, two
    values a byte (low nibble first, offset q + 8): ``(payload,
    scale)``, ``payload`` uint8 shaped ``[..., n // 2]``.
    ``block_size`` must be even."""
    if block_size % 2:
        raise ValueError(f"int4 needs an even block size, got {block_size}")
    _deterministic(stochastic)
    blocks = _block_view(_ftz(x.to(torch.float32)), block_size)
    scale, inv = _block_scale(blocks, INT4_LEVELS)
    q = _int_round(blocks * inv[..., None], INT4_LEVELS)
    q = (q + 8.0).to(torch.uint8).reshape(x.shape)
    pairs = q.reshape(tuple(x.shape[:-1]) + (x.shape[-1] // 2, 2))
    return pairs[..., 0] | (pairs[..., 1] << 4), scale


def int4_blockwise_dequantize(payload: torch.Tensor, scale: torch.Tensor,
                              block_size: int = 64) -> torch.Tensor:
    lo = (payload & 0xF).to(torch.float32) - 8.0
    hi = (payload >> 4).to(torch.float32) - 8.0
    full = torch.stack([lo, hi], dim=-1).reshape(
        tuple(payload.shape[:-1]) + (payload.shape[-1] * 2,))
    blocks = _block_view(full, block_size)
    return _ftz(blocks * scale[..., None]).reshape(full.shape)


def compress_cast(x: torch.Tensor, mode: str, block_size: int = 64, *,
                  stochastic: bool = False):
    """Uniform ``(payload, scale)`` encode for every codec: int8/fp8
    return a 1-byte payload shaped like ``x`` plus per-block scales,
    int4 a half-length packed payload, bf16 the cast with
    ``scale=None``."""
    if mode == "bf16":
        _deterministic(stochastic)
        return x.to(torch.bfloat16), None
    if mode == "int8":
        return blockwise_quantize(x, block_size, stochastic=stochastic)
    if mode == "fp8":
        return fp8_blockwise_quantize(x, block_size, stochastic=stochastic)
    if mode == "int4":
        return int4_blockwise_quantize(x, block_size, stochastic=stochastic)
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


__all__ = ["CODEC_MODES", "FP8_MAX", "INT4_LEVELS", "INT8_LEVELS",
           "blockwise_dequantize", "blockwise_quantize", "compress_cast",
           "decompress_cast", "dequantize_blob", "fp8_blockwise_dequantize",
           "fp8_blockwise_quantize", "int4_blockwise_dequantize",
           "int4_blockwise_quantize", "payload_bytes", "quantize_blob"]
