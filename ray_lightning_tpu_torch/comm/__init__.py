"""Comm plane (port of ``ray_lightning_tpu/comm/``).

Ported so far: ``quant.py``'s codecs (blockwise int8, fp8 e4m3, int4,
bf16, and the shape-agnostic blob encode the fleet's KV ship and the
int8-resident draft use).  The compressed collectives, their policy,
audit and calibration are not ported yet (ROADMAP.md queue 1 item 7).
"""

from ray_lightning_tpu_torch.comm.quant import (  # noqa: F401
    CODEC_MODES,
    compress_cast,
    decompress_cast,
    dequantize_blob,
    payload_bytes,
    quantize_blob,
)

__all__ = ["CODEC_MODES", "compress_cast", "decompress_cast",
           "dequantize_blob", "payload_bytes", "quantize_blob"]
