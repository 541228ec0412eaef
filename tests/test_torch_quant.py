"""PyTorch/CUDA port, the comm plane's codecs: ``ray_lightning_tpu_torch/
comm/quant.py`` against the JAX package's ``comm/quant.py`` on the same
numpy-seeded inputs.

Every payload and every scale must be byte-equal to JAX's (int8, fp8
e4m3 as uint8 bits, int4 nibble-packed, bf16, raw fp32), as must the
decoded values and ``payload_bytes``: the same bytes travel whichever
package encodes them.  The inputs cover zero blocks, fp32 subnormals
(flushed to zero, as XLA flushes them), the e4m3 range's edges at
+-448, exact rounding ties and lengths that need a pad.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_lightning_tpu.comm import quant as jq
from ray_lightning_tpu_torch.comm import quant as tq

MODES = ("int8", "fp8", "int4", "bf16", "raw")


def _inputs(case: str) -> np.ndarray:
    rng = np.random.default_rng(abs(hash(case)) % 2 ** 32)
    if case == "normal":
        return (rng.standard_normal(4096) * 3).astype(np.float32)
    if case == "pad":                  # 1000 and 37: not block multiples
        return rng.standard_normal(1000).astype(np.float32)
    if case == "short":
        return rng.standard_normal(37).astype(np.float32)
    x = rng.standard_normal(64 * 8).astype(np.float32)
    if case == "zero_blocks":
        x[:64] = 0.0
        x[128:192] = -0.0
    elif case == "subnormal":
        x[:64] = np.float32(1e-42) * rng.integers(1, 9, 64)
        x[64:128] *= np.float32(1e-39)      # a normal max, subnormal rest
        x[200] = np.float32(-1e-41)
    elif case == "fp8_edges":
        # blocks whose max is exactly 448 (scale 1): values on, between
        # and at the e4m3 grid's ties, its subnormals, and +-448
        blk = np.linspace(-448, 448, 64).astype(np.float32)
        blk[0], blk[1], blk[2] = 448.0, -448.0, 2.0 ** -9
        blk[3], blk[4], blk[5] = 1.5 * 2.0 ** -9, 2.0 ** -10, 1.0625
        blk[6], blk[7], blk[8] = 1.1875, 240.0, 232.0
        x[:64] = blk
        x[64:128] = blk[::-1]
    elif case == "ties":
        # blocks with max 127 (int8 scale 1) and 7 (int4 scale 1) whose
        # values sit on .5: round half to even
        x[:64] = np.arange(64, dtype=np.float32) - 31.5
        x[0] = 127.0
        x[64:128] = (np.arange(64, dtype=np.float32) % 15 - 7) + 0.5
        x[64] = 7.0
        x[128:192] = np.float32(0.5) * np.arange(64, dtype=np.float32)
        x[128] = 127.0
    return x


def _bytes(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().view(np.uint8)
    a = np.asarray(t)
    return a.view(np.uint8)


CASES = ("normal", "pad", "short", "zero_blocks", "subnormal", "fp8_edges",
         "ties")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", MODES)
def test_quantize_blob_bytes_equal_jax(mode, case):
    """``quantize_blob``'s payload and scale, byte for byte, and
    ``dequantize_blob``'s values (fp32 and bf16 out) against JAX's."""
    x = _inputs(case)
    shape = (x.size,) if case == "short" else (8, x.size // 8)
    x = x.reshape(shape)
    jp, js = jq.quantize_blob(jnp.asarray(x), mode)
    tp, ts = tq.quantize_blob(torch.from_numpy(x), mode)
    assert np.array_equal(_bytes(tp), _bytes(jp)), mode
    assert tuple(tp.shape) == tuple(np.asarray(jp).shape)
    assert (ts is None) == (js is None)
    if ts is not None:
        assert ts.dtype == torch.float32
        assert np.array_equal(_bytes(ts), _bytes(js))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jd = jq.dequantize_blob(jp, js, mode, shape, dtype=jdt)
        td = tq.dequantize_blob(tp, ts, mode, shape, dtype=tdt)
        assert tuple(td.shape) == shape and td.dtype == tdt
        assert np.array_equal(_bytes(td), _bytes(jd)), (mode, tdt)


@pytest.mark.parametrize("mode", ("int8", "fp8", "int4", "bf16"))
def test_compress_cast_blockwise_equals_jax(mode):
    """The blockwise codecs on a [rows, n] payload (no pad), and their
    fp32 decode."""
    x = _inputs("normal").reshape(16, 256)
    jp, js = jq.compress_cast(jnp.asarray(x), mode, 32)
    tp, ts = tq.compress_cast(torch.from_numpy(x), mode, 32)
    assert np.array_equal(_bytes(tp), _bytes(jp))
    if ts is not None:
        assert tuple(ts.shape) == (16, 8)
        assert np.array_equal(_bytes(ts), _bytes(js))
    got = tq.decompress_cast(tp, ts, mode, 32)
    assert np.array_equal(got.numpy(),
                          np.asarray(jq.decompress_cast(jp, js, mode, 32)))


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000, 4096])
@pytest.mark.parametrize("mode", MODES)
def test_payload_bytes_equal_jax(mode, n):
    assert tq.payload_bytes(n, mode) == jq.payload_bytes(n, mode)
    if mode != "raw":
        p, s = tq.quantize_blob(torch.ones(n), mode)
        wire = p.nbytes + (0 if s is None else s.nbytes)
        assert wire == tq.payload_bytes(-(-n // 64) * 64 if mode != "bf16"
                                        else n, mode)


def test_codec_refusals():
    """Stochastic rounding is not ported (it names its ROADMAP item); an
    unknown mode and an odd int4 block raise as in JAX."""
    x = torch.ones(64)
    for mode in ("int8", "fp8", "int4", "bf16"):
        with pytest.raises(NotImplementedError, match="item 7"):
            tq.compress_cast(x, mode, stochastic=True)
    with pytest.raises(ValueError, match="unknown compression mode"):
        tq.compress_cast(x, "zstd")
    with pytest.raises(ValueError, match="even block"):
        tq.int4_blockwise_quantize(x, 63)
    with pytest.raises(ValueError, match="multiple of block"):
        tq.blockwise_quantize(torch.ones(65))
    assert tq.CODEC_MODES == jq.CODEC_MODES
