"""Comm plane (port of ``ray_lightning_tpu/comm/``): blockwise-quantized
cross-replica gradient collectives.

- :mod:`quant`: blockwise int8 / bf16 / fp8-e4m3 / packed-int4 codecs in
  plain torch ops, with stochastic rounding from the keyed Philox; also
  the blob encode the fleet's KV ship and the int8-resident draft use.
- :mod:`collectives`: ``compressed_reduce_scatter`` /
  ``compressed_all_gather`` / ``compressed_psum`` over
  ``torch.distributed`` groups (sums always in fp32), the two-level
  ``hierarchical_psum``, and :class:`GradSync`, what a strategy's
  ``grad_transform(mesh, policy)`` hands the step (one collective a
  gradient or a bucket, the error-feedback residual in the optimizer
  state, ZeRO-1's updated-param gather at ``param_gather`` dtype).
- :mod:`policy`: :class:`CommPolicy` (``Trainer(comm_policy=...)`` /
  ``RLT_COMM*`` knobs).
- :mod:`audit`: the per-rank record of the collectives issued and the
  wire-byte accounting over it (by op, dtype and link).
- :mod:`calibrate`: measured link bandwidths, cached per topology.
- :mod:`selfcheck`: ``python -m ray_lightning_tpu_torch.comm.selfcheck``.

Off by default: with the policy off (or no compressible axis) every
strategy's ``grad_transform`` returns ``None`` and the step issues the
collectives it issues without a policy.
"""

from ray_lightning_tpu_torch.comm.collectives import (  # noqa: F401
    CommState,
    GradSync,
    build_grad_sync,
    compressed_all_gather,
    compressed_psum,
    compressed_reduce_scatter,
    hierarchical_psum,
    hierarchy_groups,
    partition_buckets,
)
from ray_lightning_tpu_torch.comm.policy import CommPolicy  # noqa: F401
from ray_lightning_tpu_torch.comm.quant import (  # noqa: F401
    CODEC_MODES,
    blockwise_dequantize,
    blockwise_quantize,
    compress_cast,
    decompress_cast,
    dequantize_blob,
    payload_bytes,
    quantize_blob,
)

__all__ = ["CODEC_MODES", "CommPolicy", "CommState", "GradSync",
           "blockwise_dequantize", "blockwise_quantize", "build_grad_sync",
           "compress_cast", "compressed_all_gather", "compressed_psum",
           "compressed_reduce_scatter", "decompress_cast", "dequantize_blob",
           "hierarchical_psum", "hierarchy_groups", "partition_buckets",
           "payload_bytes", "quantize_blob"]
