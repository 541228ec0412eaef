"""ray_lightning_tpu_torch — the PyTorch/CUDA port of ray_lightning_tpu.

A second package beside the JAX one, which stays as the reference.  Two
paths are ported.  Serving: ``GPTLightningModule`` -> ``ServeEngine``
(per-bucket prefill + one decode step over a slot KV cache) driven by
the continuous-batching ``Scheduler`` through ``ServeWorker.serve_step``.
Training: ``Trainer(...).fit(GPTLightningModule(...))`` on one device
(fused CE, AdamW with an fp32 master, accumulation).  Their attention
kernels are hand-written CUDA C++ for Hopper (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``, ``csrc/flash_decode.cu``), built with nvcc at
first use.  Entry points run on the card unless the caller passes
``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.

This package imports ``torch`` and never ``jax`` or the JAX package.
"""

from ray_lightning_tpu_torch._device import resolve_device
from ray_lightning_tpu_torch.convert import (flax_opt_state_to_torch,
                                             flax_to_torch)
from ray_lightning_tpu_torch.core.callbacks import Callback
from ray_lightning_tpu_torch.core.data import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.core.module import LightningModule
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.gpt import (CONFIGS, GPT, GPTConfig,
                                                GPTLightningModule)
from ray_lightning_tpu_torch.serve import (Scheduler, ServeEngine,
                                           ServeRequest, ServeWorker)

__version__ = "0.1.0"

__all__ = [
    "ArrayDataset",
    "CONFIGS",
    "Callback",
    "DataLoader",
    "GPT",
    "GPTConfig",
    "GPTLightningModule",
    "LightningModule",
    "Scheduler",
    "ServeEngine",
    "ServeRequest",
    "ServeWorker",
    "Trainer",
    "flax_opt_state_to_torch",
    "flax_to_torch",
    "resolve_device",
    "__version__",
]
