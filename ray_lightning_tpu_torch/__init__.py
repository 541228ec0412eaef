"""ray_lightning_tpu_torch — the PyTorch/CUDA port of ray_lightning_tpu.

A second package beside the JAX one, which stays as the reference.  Two
paths are ported.  Serving: ``GPTLightningModule`` -> ``ServeEngine``
(per-bucket prefill + one decode step over a slot KV cache; with
``paged=`` prefix reuse over the page-table decode kernel, with
``spec=`` speculative decoding) driven by the continuous-batching
``Scheduler`` through ``ServeWorker.serve_step``.
Training: ``Trainer(...).fit(GPTLightningModule(...))`` on one device
(fused CE, AdamW with an fp32 master, accumulation, clipping, dropout;
checkpoints with ``ModelCheckpoint`` and resume with ``ckpt_path=``,
``EarlyStopping``, ``val_check_interval``, ``predict``, datamodules, a
``CSVLogger``), data-parallel over subprocess actors with
``Trainer(plugins=[RayPlugin(num_workers=N)])`` (DDP) or
``RayShardedPlugin`` (ZeRO-1), NCCL on the card and gloo on the CPU, and
the BERT
family: ``Trainer(...).fit(BertMLMModule("bert-base", batch_size=32))``
(masked-LM pretraining) and ``BertLightningModule`` (sequence
classification), whose attention is bidirectional.  Their attention
kernels are hand-written CUDA C++ for Hopper (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``, ``csrc/flash_decode.cu``), built with nvcc at
first use.  Entry points run on the card unless the caller passes
``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.

This package imports ``torch`` and never ``jax`` or the JAX package.
"""

from ray_lightning_tpu_torch._device import resolve_device
from ray_lightning_tpu_torch.convert import (flax_opt_state_to_torch,
                                             flax_to_torch,
                                             jax_checkpoint_to_torch)
from ray_lightning_tpu_torch.core.callbacks import (Callback, EarlyStopping,
                                                    ModelCheckpoint)
from ray_lightning_tpu_torch.core.data import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.core.datamodule import LightningDataModule
from ray_lightning_tpu_torch.core.module import LightningModule
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.bert import (BertConfig,
                                                 BertLightningModule,
                                                 BertMLMModule)
from ray_lightning_tpu_torch.models.boring import (BoringModel,
                                                   LightningMNISTClassifier)
from ray_lightning_tpu_torch.models.gpt import (CONFIGS, GPT, GPTConfig,
                                                GPTLightningModule)
from ray_lightning_tpu_torch.plugins import (LocalPlugin, RayPlugin,
                                            RayShardedPlugin)
from ray_lightning_tpu_torch.serve import (Scheduler, ServeEngine,
                                           ServeRequest, ServeWorker)
from ray_lightning_tpu_torch.utils.logger import CSVLogger

__version__ = "0.1.0"

__all__ = [
    "ArrayDataset",
    "BertConfig",
    "BertLightningModule",
    "BertMLMModule",
    "BoringModel",
    "CONFIGS",
    "CSVLogger",
    "Callback",
    "DataLoader",
    "EarlyStopping",
    "GPT",
    "GPTConfig",
    "GPTLightningModule",
    "LightningDataModule",
    "LightningMNISTClassifier",
    "LightningModule",
    "LocalPlugin",
    "ModelCheckpoint",
    "RayPlugin",
    "RayShardedPlugin",
    "Scheduler",
    "ServeEngine",
    "ServeRequest",
    "ServeWorker",
    "Trainer",
    "flax_opt_state_to_torch",
    "flax_to_torch",
    "jax_checkpoint_to_torch",
    "resolve_device",
    "__version__",
]
