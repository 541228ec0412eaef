"""ray_lightning_tpu_torch — the PyTorch/CUDA port of ray_lightning_tpu.

A second package beside the JAX one, which stays as the reference.  Two
paths are ported.  Serving: ``Server(GPTLightningModule(...)).start()``
then ``submit`` / ``generate`` / ``drain`` / ``shutdown``: the
continuous-batching ``Scheduler`` on the driver, persistent
``ServeWorker`` actors, one a card, each holding a ``ServeEngine``
(per-bucket prefill + one decode step over a slot KV cache, each
program one CUDA graph on the card; with ``paged=`` prefix reuse over
the page-table decode kernel, with ``spec=`` speculative decoding);
``ServeWorker(engine).serve_step`` drives an engine in process;
``FleetServer(module, replicas=N)`` puts N ``Server`` replicas behind
one front door (routing, fleet-wide quotas, failover, autoscaling,
disaggregated prefill/decode pools with codec-compressed KV shipping,
prefix federation).
Training: ``Trainer(...).fit(GPTLightningModule(...))`` on one device
(fused CE, AdamW with an fp32 master, accumulation, clipping, dropout;
checkpoints with ``ModelCheckpoint`` and resume with ``ckpt_path=``,
``EarlyStopping``, ``val_check_interval``, ``predict``, datamodules, a
``CSVLogger``), data-parallel over subprocess actors with
``Trainer(plugins=[RayPlugin(num_workers=N)])`` (DDP) or
``RayShardedPlugin`` (ZeRO-1), NCCL on the card and gloo on the CPU,
their gradient sync compressed with ``Trainer(comm_policy=CommPolicy(
...))`` (int8 / fp8 / int4 / bf16 collectives with error feedback,
hierarchical and bucketed), surviving a dead worker with
``Trainer(elastic=...)`` (async snapshots, parity of the ZeRO-1
optimizer shards, a shrunk fleet resumed in memory or from a snapshot),
sharded training (``Trainer(strategy="fsdp")``, ``SpmdStrategy`` with
``gpt_partition_rules`` / ``bert_partition_rules`` for tensor
parallelism, ``RaySpmdPlugin``) with sharded checkpoints
(``save_sharded_checkpoint``, ``ShardedCheckpoint``), hyperparameter
sweeps with ``tune.run`` (grid and random search, ASHA,
PBT) whose trials train in process on a leased card or in those
workers, the BERT
family: ``Trainer(...).fit(BertMLMModule("bert-base", batch_size=32))``
(masked-LM pretraining) and ``BertLightningModule`` (sequence
classification), whose attention is bidirectional, and the ResNet
family: ``ResNetLightningModule("resnet50", batch_size=128)`` on
synthetic CIFAR-10, whose BatchNorm takes its moments over the global
batch under ``RayPlugin`` / ``RayShardedPlugin``.  Their attention
kernels are hand-written CUDA C++ for Hopper (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``, ``csrc/flash_decode.cu``), built with nvcc at
first use.  Entry points run on the card unless the caller passes
``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.

This package imports ``torch`` and never ``jax`` or the JAX package.
"""

from ray_lightning_tpu_torch._device import resolve_device
from ray_lightning_tpu_torch.comm import CommPolicy
from ray_lightning_tpu_torch.convert import (flax_opt_state_to_torch,
                                             flax_to_torch,
                                             jax_checkpoint_to_torch)
from ray_lightning_tpu_torch.core.callbacks import (Callback, EarlyStopping,
                                                    ModelCheckpoint,
                                                    ShardedCheckpoint)
from ray_lightning_tpu_torch.core.data import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.core.datamodule import LightningDataModule
from ray_lightning_tpu_torch.core.module import LightningModule
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.elastic import ElasticConfig
from ray_lightning_tpu_torch.models.bert import (BertConfig,
                                                 BertLightningModule,
                                                 BertMLMModule)
from ray_lightning_tpu_torch.models.boring import (BoringModel,
                                                   LightningMNISTClassifier)
from ray_lightning_tpu_torch.models.gpt import (CONFIGS, GPT, GPTConfig,
                                                GPTLightningModule)
from ray_lightning_tpu_torch.models.pipeline_gpt import PipelinedGPT
from ray_lightning_tpu_torch.models.resnet import (ResNet, ResNetConfig,
                                                   ResNetLightningModule)
from ray_lightning_tpu_torch.plugins import (LocalPlugin, RayPlugin,
                                            RayShardedPlugin, RaySpmdPlugin)
from ray_lightning_tpu_torch.serve import (Scheduler, ServeEngine,
                                           ServeRequest, ServeWorker, Server)
from ray_lightning_tpu_torch.serve.fleet import FleetServer
from ray_lightning_tpu_torch.utils.logger import CSVLogger
from ray_lightning_tpu_torch import tune

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
    "CommPolicy",
    "DataLoader",
    "EarlyStopping",
    "ElasticConfig",
    "FleetServer",
    "GPT",
    "GPTConfig",
    "GPTLightningModule",
    "LightningDataModule",
    "LightningMNISTClassifier",
    "LightningModule",
    "LocalPlugin",
    "ModelCheckpoint",
    "PipelinedGPT",
    "RayPlugin",
    "RayShardedPlugin",
    "RaySpmdPlugin",
    "ResNet",
    "ResNetConfig",
    "ResNetLightningModule",
    "Scheduler",
    "ServeEngine",
    "ServeRequest",
    "ServeWorker",
    "Server",
    "ShardedCheckpoint",
    "Trainer",
    "flax_opt_state_to_torch",
    "flax_to_torch",
    "jax_checkpoint_to_torch",
    "resolve_device",
    "tune",
    "__version__",
]
