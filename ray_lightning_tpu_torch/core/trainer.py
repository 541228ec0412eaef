"""``Trainer``: fit / validate / test / predict of a ``LightningModule``,
in this process or over actor workers, with checkpointing, resume and a
metrics log.

Counterpart of ``ray_lightning_tpu/core/trainer.py`` (``Trainer.__init__``,
``fit``, ``validate``, ``test``, ``predict``, the world info,
``_fit_loop``, the epoch engine (``_allowed_chunk``,
``_publish_if_crossed``, ``_train_source``, ``_train_epoch``,
``_batch_hook_plan``, ``_engine_one``, ``_engine_chunk``),
``_maybe_interval_val``, ``_eval_loop``, ``_predict_loop``,
``dump_checkpoint``, ``save_checkpoint``, ``load_checkpoint_dict``,
``_restore_checkpoint``): the same loop order, hooks, stop conditions,
metric semantics and checkpoint keys, run eagerly by PyTorch, except
that on the card a full chunk of ``steps_per_execution`` steps is one
CUDA graph replay (core/steps.py ``ChunkRunner``).  A stage runs
through the execution plugin (plugins/): ``LocalPlugin`` (the default) runs it here on ``device``
(the card unless the caller passes ``device="cpu"``) at world size 1;
``RayPlugin`` / ``RayShardedPlugin`` run it in actor workers, each on
its own device, joined by ``torch.distributed``, and the driver resolves
no device.  ``strategy=`` (``"ddp"``, ``"zero1"``, ``"fsdp"``, ``"spmd"``,
their aliases or a ``SpmdStrategy``, parallel/strategy.py) overrides the
plugin's.  Each stage lays the ranks out on the strategy's mesh
(parallel/mesh.py); under FSDP and SPMD the model is cut to each rank's
blocks right after its init (parallel/layout.py), the loaders are split
over the mesh's batch axes (``data``, ``fsdp``: the ranks of one tensor
group read the same batches), ``_trained_state`` and the checkpoints
hold whole tensors (gathered), and ``save_sharded_checkpoint`` /
``ShardedCheckpoint`` write each rank's blocks with no gather
(utils/checkpoint.py), which ``ckpt_path=`` restores into any mesh.

Across ranks, as in the JAX package, whose step computes on the global
batch: each loader is sharded by rank (``DataLoader.shard``, when
``use_distributed_sampler`` and the world size is over 1); the train
metrics are the mean over the ranks and the validation metrics the
batch-size-weighted mean over every rank's batches, so callbacks decide
the same on every rank; ``predict`` returns every rank's rows in
dataset order, each sample once (the loader's wrap-around padding
dropped); a step's dropout masks differ across batch shards (the shard
joins the step's entropy) and agree within a tensor group.
Checkpoints are collective: every rank builds the dict (ZeRO-1 and the
sharded layouts gather their shards into the single-device layout) and
global zero alone writes it, the ``metrics.csv`` rows and the
evictions.

Honoured: ``max_epochs``, ``max_steps``, ``callbacks``,
``default_root_dir`` (default ``<cwd>/rlt_logs``),
``enable_checkpointing`` (adds a ``ModelCheckpoint``),
``limit_{train,val,test,predict}_batches``, ``num_sanity_val_steps``,
``check_val_every_n_epoch``, ``val_check_interval`` (a validation when
``global_step`` is a multiple of it, inside the epoch),
``log_every_n_steps``, ``accumulate_grad_batches``,
``steps_per_execution`` (k steps a dispatch: the engine below),
``cache_train_dataset`` (the train set resident on the device,
repacked each epoch in the loader's order: core/loop_engine.py
``CachedSource``), ``plugins``,
``strategy``, ``use_distributed_sampler``,
``gradient_clip_val`` (``clip_by_global_norm`` chained ahead of the
module's optimizer), ``precision`` (the bf16 spellings cast a batch's
floating leaves to bf16; the model's dtypes do not change), ``seed``,
``resume_from_checkpoint`` / ``ckpt_path``, ``logger`` (``True``: a
``CSVLogger`` writing ``<default_root_dir>/logs/metrics.csv``) and
``device``.  Inside a Tune trial whose ``resources_per_trial`` asks for
GPUs, a ``Trainer`` given no device takes its card from the trial's
lease when the fit starts (tune/runner.py ``_DeviceLeaser``): it is
single-device, so a lease of n > 1 cards trains on its first card.
``callback_metrics`` holds, per name, the mean over the epoch of the
train steps' values (published mid-epoch every ``log_every_n_steps``
steps) and the batch-size-weighted mean of the last validation;
``global_step`` counts optimizer steps and ``current_epoch`` the epochs
run.  ``comm_policy`` (a ``CommPolicy``, a codec name or a dict; the
``RLT_COMM*`` knobs when ``None``) routes DDP's and ZeRO-1's gradient
sync through the comm plane's compressed collectives
(comm/collectives.py ``GradSync``, wrapped outermost around the
optimizer: its state carries each rank's error-feedback residual,
checkpointed gathered to ``[W, ...]``); off, the step issues exactly
the collectives it issues without a policy.  ``elastic`` (an
``ElasticConfig``, ``True`` or a dict; the ``RLT_ELASTIC*`` knobs when
``None``, elastic/config.py) turns on the elastic plane: async sharded
snapshots on a step cadence (elastic/snapshot.py), parity of the ZeRO-1
optimizer shards over the workers' peer channel (elastic/redundancy.py),
and, under ``RayPlugin``, the shrink-to-continue driver that answers a
dead rank with a smaller fleet resumed from the parity escrows or the
latest snapshot (elastic/driver.py; the report in ``_elastic_report``,
the worker's numbers in ``elastic_stats()``); ``RLT_FAULT`` in a
worker's environment arms the deterministic faults of
elastic/faults.py.  The telemetry, compile-cache and planner planes
raise ``NotImplementedError`` when given a value other than their
default.

The epoch engine (one loop over a batch source, core/loop_engine.py):
a chunk never crosses ``max_steps`` or a ``val_check_interval``
boundary (``_allowed_chunk``); a full chunk of k same-shape batches is
one dispatch, anything shorter runs step by step; ``limit_train_batches``
counts loader positions.  Batch-granular callbacks coarsen to once per
chunk: ``on_train_batch_start`` for every batch before it, one
``on_train_batch_end`` with the chunk's metrics stacked to ``[k]`` and
its last batch; a callback gets the host batch (``Callback.needs_batch``
says whether it is collated at all).  The epoch's metrics flatten the
chunks into one per-step series.

A checkpoint is one file (a local path or an fsspec URL; fsspec is
imported for URLs only), ``torch.save`` of plain containers
(utils/states.py), with the JAX checkpoint's top-level keys: ``epoch``,
``global_step``, ``state`` (``step``, ``params``, ``model_state``, the
optimizer's ``state_dict``, and ``rng``: the seed the steps draw from),
``hparams``, ``callbacks``, ``world_size``, ``strategy`` (the strategy's
name: ``"ddp"`` for a plain fit).  Resuming
restores all of it, the tensors on the trainer's device in their saved
dtypes, so a resumed fit continues as the uninterrupted one does, bit
for bit.  As in the JAX package, ``epoch`` is the epoch the resumed fit
starts at: a ``ModelCheckpoint`` file saved during epoch e runs epoch e
again, a ``save_checkpoint`` after a fit starts the next one.
"""

from __future__ import annotations

import logging
import os
import tempfile
import time
from typing import Any, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.comm.collectives import (CommState, CommTx,
                                                      inner_state_dict)
from ray_lightning_tpu_torch.comm.policy import CommPolicy
from ray_lightning_tpu_torch.elastic.config import ElasticConfig
from ray_lightning_tpu_torch.parallel import strategy as _parallel
from ray_lightning_tpu_torch.parallel.gather import fetch_tree
from ray_lightning_tpu_torch.parallel.layout import (ShardLayout,
                                                     ShardedOptState,
                                                     map_param_dicts)
from ray_lightning_tpu_torch.parallel.mesh import set_current_mesh
from ray_lightning_tpu_torch.parallel.strategy import resolve_strategy
from ray_lightning_tpu_torch.plugins.base import LocalPlugin
from ray_lightning_tpu_torch.core.callbacks import Callback, ModelCheckpoint
from ray_lightning_tpu_torch.core.data import to_device
from ray_lightning_tpu_torch.core.loop_engine import (CachedSource,
                                                      StreamSource)
from ray_lightning_tpu_torch.core.state import TrainState
from ray_lightning_tpu_torch.core.steps import (ChunkRunner,
                                                build_eval_step,
                                                build_init_fn,
                                                build_predict_step,
                                                build_train_step,
                                                tree_leaves, tree_map)
from ray_lightning_tpu_torch.ops.optim import chain, clip_by_global_norm
from ray_lightning_tpu_torch.utils.logger import resolve_logger
from ray_lightning_tpu_torch.utils.seed import (SEED_ENV_VAR, reset_seed,
                                                seed_everything)
from ray_lightning_tpu_torch.utils.states import (load_state_stream,
                                                  to_state_stream)

_log = logging.getLogger(__name__)

#: arguments of the JAX ``Trainer`` that are not ported: name -> default
_NOT_PORTED = {
    "telemetry": None,
    "compile_cache": None,
    "plan": None,
}

#: the JAX ``Trainer``'s precision spellings: every one of the first
#: set runs fp32 (``"64"`` too: it enables no float64), the second set
#: casts a batch's floating leaves to bf16
_FP32_PRECISIONS = ("32", "32-true", "64")
_BF16_PRECISIONS = ("bf16", "bf16-mixed", "bf16-true",
                    "16", "16-mixed", "16-true")

_LOADER_OF_STAGE = {"fit": "train", "validate": "val", "test": "test",
                    "predict": "predict"}


class Trainer:
    """Drives fit / validate / test / predict for a LightningModule
    through its execution plugin (module docstring)."""

    def __init__(
        self,
        max_epochs: Optional[int] = None,
        max_steps: int = -1,
        callbacks: Optional["list[Callback]"] = None,
        plugins: Optional[list] = None,
        strategy: Any = None,
        default_root_dir: Optional[str] = None,
        enable_checkpointing: bool = True,
        limit_train_batches: Optional[int] = None,
        limit_val_batches: Optional[int] = None,
        limit_test_batches: Optional[int] = None,
        limit_predict_batches: Optional[int] = None,
        check_val_every_n_epoch: int = 1,
        val_check_interval: Optional[int] = None,
        log_every_n_steps: int = 50,
        num_sanity_val_steps: int = 2,
        accumulate_grad_batches: int = 1,
        steps_per_execution: int = 1,
        cache_train_dataset: bool = False,
        gradient_clip_val: Optional[float] = None,
        precision: str = "32",
        seed: Optional[int] = None,
        resume_from_checkpoint: Optional[str] = None,
        use_distributed_sampler: bool = True,
        enable_progress_bar: bool = False,
        logger: Any = True,
        telemetry: Any = None,
        compile_cache: Any = None,
        comm_policy: Any = None,
        elastic: Any = None,
        plan: Any = None,
        device: "str | torch.device | None" = None,
    ):
        self.precision = str(precision)
        if self.precision not in _BF16_PRECISIONS + _FP32_PRECISIONS:
            raise ValueError(
                f"Unknown precision {precision!r}; use one of "
                f"{_BF16_PRECISIONS + _FP32_PRECISIONS}")
        given = dict(telemetry=telemetry, compile_cache=compile_cache,
                     plan=plan)
        for name, default in _NOT_PORTED.items():
            if given[name] != default:
                raise NotImplementedError(
                    f"Trainer({name}={given[name]!r}) is not ported yet "
                    f"(ROADMAP.md queue 1)")
        #: the resolved comm policy (comm/policy.py) and, while a stage
        #: runs with it active, its ``GradSync``
        self.comm_policy = CommPolicy.resolve(comm_policy)
        self._grad_sync = None
        #: the resolved elastic config (elastic/config.py)
        self.elastic = ElasticConfig.resolve(elastic)
        #: a stage's snapshotter and parity manager (elastic/), the
        #: driver's restart bookkeeping that rides the pickled trainer to
        #: the workers (the loader rescale reads it), its report, rank
        #: 0's elastic numbers, and the one-shot in-memory recovery
        #: package of a parity route
        self._snapshotter = None
        self._redundancy = None
        self._elastic_state: Optional[dict] = None
        self._elastic_report: Optional[dict] = None
        self._elastic_worker_stats: Optional[dict] = None
        self._elastic_recovery: Optional[dict] = None
        self._snapshot_restores = 0
        self._warned_rescale = False
        #: the wall time (``time.time()``) of this stage's first step,
        #: from rank 0 under a remote plugin
        self.first_step_wall: Optional[float] = None
        runners = [p for p in (plugins or []) if hasattr(p, "run")]
        if len(runners) > 1:
            raise ValueError("At most one execution plugin is supported.")
        self.plugin = runners[0] if runners else LocalPlugin()
        if strategy is not None:
            self.plugin.strategy = resolve_strategy(strategy)
        if self.plugin.remote and device is not None:
            raise ValueError(
                f"Trainer(device={device!r}) with {type(self.plugin).__name__}"
                f": its workers take their own devices (platform='cpu' for "
                f"CPU workers)")
        if max_epochs is None and (max_steps is None or max_steps < 0):
            max_epochs = 1000
        self.max_epochs = max_epochs
        self.max_steps = max_steps if max_steps is not None else -1
        self.callbacks: "list[Callback]" = list(callbacks or [])
        self.default_root_dir = default_root_dir or os.path.join(
            os.getcwd(), "rlt_logs")
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.limit_test_batches = limit_test_batches
        self.limit_predict_batches = limit_predict_batches
        self.check_val_every_n_epoch = max(1, check_val_every_n_epoch)
        self.val_check_interval = val_check_interval
        self.log_every_n_steps = max(1, log_every_n_steps)
        self.num_sanity_val_steps = num_sanity_val_steps
        self.accumulate_grad_batches = max(1, accumulate_grad_batches)
        self.steps_per_execution = max(1, int(steps_per_execution))
        self.cache_train_dataset = bool(cache_train_dataset)
        self.gradient_clip_val = gradient_clip_val
        self.seed = seed
        self.resume_from_checkpoint = resume_from_checkpoint
        self.use_distributed_sampler = use_distributed_sampler
        self.logger = resolve_logger(logger, self.default_root_dir)
        #: ``None`` for a remote plugin (each worker sets its own) and
        #: until the stage starts where the plugin says so (a Tune
        #: trial's lease); else the resolved device
        self.device = None if self.plugin.remote \
            else self.plugin.initial_device(device)
        self._world = {"world_size": 1, "global_rank": 0, "local_rank": 0,
                       "node_rank": 0}
        #: the dtype a batch's floating leaves are cast to (``None``:
        #: as the loader gives them)
        self.batch_float_dtype = (torch.bfloat16
                                  if self.precision in _BF16_PRECISIONS
                                  else None)
        if enable_checkpointing and not any(
                isinstance(c, ModelCheckpoint) for c in self.callbacks):
            self.callbacks.append(ModelCheckpoint())

        self.lightning_module = None
        self.datamodule = None
        self.current_epoch = 0
        self.global_step = 0
        self.should_stop = False
        self.sanity_checking = False
        self.num_val_batches = 0
        self.callback_metrics: "dict[str, float]" = {}
        self.logged_metrics: "dict[str, float]" = {}
        self.state: Optional[TrainState] = None
        #: the stage's mesh (parallel/mesh.py) and, under FSDP / SPMD, the
        #: model's sharded layout (parallel/layout.py)
        self._mesh = None
        self._layout: "ShardLayout | None" = None
        #: live sharded checkpointers by directory (utils/checkpoint.py)
        self._sharded_checkpointers: dict = {}
        #: the last sharded save's blocking seconds (``save_stage_s``: the
        #: host copy; the write runs behind) and restore's (``restore_s``)
        self.checkpoint_stats: dict = {}
        self._train_step = None
        self._tx = None
        #: k steps a dispatch (``steps_per_execution`` > 1 or the cache)
        self._multi_train_step = None
        self._cache_source = None
        self._cache_disabled = False
        #: the last fit's chunk graphs: ``ChunkRunner.stats``
        self.graph_stats: dict = {}
        self._eval_steps: dict = {}
        self._predict_step = None
        self._epoch_metric_acc: "dict[str, list]" = {}

    # -- public API -------------------------------------------------------

    def fit(self, module, datamodule=None, ckpt_path: Optional[str] = None):
        ckpt_path = ckpt_path or self.resume_from_checkpoint
        return self.plugin.run(self, module, datamodule, "fit", ckpt_path)

    def validate(self, module, datamodule=None,
                 ckpt_path: Optional[str] = None):
        return self.plugin.run(self, module, datamodule, "validate",
                               ckpt_path)

    def test(self, module, datamodule=None, ckpt_path: Optional[str] = None):
        return self.plugin.run(self, module, datamodule, "test", ckpt_path)

    def predict(self, module, datamodule=None,
                ckpt_path: Optional[str] = None):
        """The predict loader's batches through ``module.predict_step``:
        a list of its outputs, one a batch (every rank's rows, in dataset
        order, without the padding of the last one), as CPU tensors."""
        return self.plugin.run(self, module, datamodule, "predict",
                               ckpt_path)

    # -- world info (set by ``_run_stage`` from the process group) ----------

    @property
    def world_size(self) -> int:
        return self._world["world_size"]

    @property
    def global_rank(self) -> int:
        return self._world["global_rank"]

    @property
    def local_rank(self) -> int:
        return self._world["local_rank"]

    @property
    def node_rank(self) -> int:
        return self._world["node_rank"]

    @property
    def is_global_zero(self) -> bool:
        return self.global_rank == 0

    @property
    def strategy(self):
        return self.plugin.strategy

    @property
    def checkpoint_callback(self) -> Optional[ModelCheckpoint]:
        return next((c for c in self.callbacks
                     if isinstance(c, ModelCheckpoint)), None)

    # -- stage execution ----------------------------------------------------

    def _run_stage(self, module, datamodule, stage: str, ckpt_path):
        self.lightning_module = module
        module.trainer = self
        self.datamodule = datamodule
        if datamodule is not None:
            datamodule.trainer = self
        if self.seed is not None:
            seed_everything(self.seed)
        else:
            reset_seed()
        seed = (int(os.environ.get(SEED_ENV_VAR, "0")) if self.seed is None
                else self.seed)
        # node and local ranks as the plugin assigned them to the worker
        env = os.environ if _parallel.group_active() else {}
        self._world = {"world_size": _parallel.world_size(),
                       "global_rank": _parallel.global_rank(),
                       "local_rank": int(env.get("LOCAL_RANK", 0)),
                       "node_rank": int(env.get("NODE_RANK", 0))}
        strategy = self.plugin.strategy
        self._mesh = strategy.build_mesh()
        set_current_mesh(self._mesh)
        self.first_step_wall = None
        # deterministic fault injection (elastic/faults.py): RLT_FAULT in
        # this process's environment arms its faults
        from ray_lightning_tpu_torch.elastic.faults import (
            FaultInjector, maybe_injector_from_env)
        if not any(isinstance(c, FaultInjector) for c in self.callbacks):
            injector = maybe_injector_from_env()
            if injector is not None:
                self.callbacks.append(injector)
        self._snapshotter = self._redundancy = None
        self._snapshot_restores = 0
        if module.model is not None and any(
                getattr(getattr(p, "_rlt_shard", None), "sharded", False)
                for p in module.model.parameters()):
            # cut to an earlier stage's layout: made again, whole, and
            # given its trained weights below
            module.model = None

        if datamodule is not None:
            datamodule._call_prepare_data()
            datamodule._call_setup(stage)
        module.prepare_data()
        module.setup(stage)
        module.setup_model(self.device)
        loaders = self._build_loaders(stage)
        if loaders[_LOADER_OF_STAGE[stage]] is None:
            raise ValueError(f"No dataloader available for stage {stage!r}")

        tx = module.configure_optimizers()
        if isinstance(tx, dict):
            tx = tx["optimizer"]
        if self.gradient_clip_val:
            tx = chain(clip_by_global_norm(self.gradient_clip_val), tx)
        # the comm plane: None (off, or inert on this strategy and mesh)
        # keeps the step's collectives as they are without a policy
        sync = self._grad_sync = strategy.grad_transform(
            self._mesh, self.comm_policy)
        if sync is None:
            tx = strategy.wrap_optimizer(tx)
        else:
            sync.setup(self.device)
            # outermost: the optimizer state becomes a CommState
            tx = CommTx(strategy.wrap_optimizer(tx, comm=sync), sync)
        #: the optimizer the step runs (its wraps included)
        self._tx = tx
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self._layout = None

        def shard(model):
            self._layout = strategy.layout(model, self._mesh)
            if self._layout is not None:
                self._layout.apply(model)
                tx.bind(self._layout)

        self.state = build_init_fn(module, tx, shard)(generator)
        trained = getattr(module, "_trained_state", None)
        recovery = self._elastic_recovery if stage == "fit" else None
        if recovery:
            # the parity route (elastic/redundancy.py): the driver rebuilt
            # the dead rank's shard; restore the package at its escrowed
            # step, reading no snapshot and no ``ckpt_path``
            from ray_lightning_tpu_torch.elastic.redundancy import \
                apply_recovery
            apply_recovery(self, recovery, module)
            self._elastic_recovery = None       # one-shot
        elif ckpt_path:
            self._restore_checkpoint(ckpt_path, module)
        elif trained is not None:
            # reuse the weights of a previous fit with this module, as the
            # JAX trainer restores ``module._trained_variables``; a
            # checkpoint takes precedence over them
            self._load_full_state(module.model, trained)
        mesh = self._mesh
        self._train_step = build_train_step(
            module, tx, self.accumulate_grad_batches,
            grad_sync=strategy.grad_sync(self._layout),
            rank=mesh.batch_index if mesh.batch_size > 1 else None,
            metric_sync=_parallel.mean_over_ranks, comm=sync)
        if stage == "fit" and (self.steps_per_execution > 1
                               or self.cache_train_dataset):
            # gloo's collectives cannot be captured in a CUDA graph
            # (NCCL's are): such a chunk runs as k eager steps on the
            # card, and graph_stats says so
            ungraphed = ("gloo's collectives cannot be captured in a "
                         "CUDA graph: k eager steps a chunk"
                         if self.device.type == "cuda"
                         and mesh.backend == "gloo" else None)
            self._multi_train_step = ChunkRunner(
                self._train_step, tx, self.steps_per_execution,
                module.model, self.device, ungraphed=ungraphed)
            self.graph_stats = self._multi_train_step.stats
        self._cache_disabled = False
        self._eval_steps = {s: build_eval_step(module, s)
                            for s in ("validate", "test")}
        self._predict_step = build_predict_step(module)

        if stage == "fit" and self.elastic.enabled:
            if self.elastic.snapshot_every_n_steps > 0:
                from ray_lightning_tpu_torch.elastic.snapshot import \
                    Snapshotter
                self._snapshotter = Snapshotter(self, self.elastic)
            if self.elastic.redundancy > 0:
                self._redundancy = self._build_redundancy()

        for cb in self.callbacks:
            cb.setup(self, module, stage)
        try:
            if stage == "fit":
                return self._fit_loop(module, loaders)
            if stage == "predict":
                return self._predict_loop(module, loaders["predict"])
            limit = (self.limit_val_batches if stage == "validate"
                     else self.limit_test_batches)
            return [self._eval_loop(module, stage,
                                    loaders[_LOADER_OF_STAGE[stage]], limit)]
        except BaseException as e:
            for cb in self.callbacks:
                cb.on_exception(self, module, e)
            raise
        finally:
            # the chunk graphs' memory pools and the cached train set
            # live for one stage; an in-flight sharded save becomes
            # durable even while an exception unwinds
            self._multi_train_step = self._cache_source = None
            self._close_sharded_checkpointers()
            for cb in self.callbacks:
                cb.teardown(self, module, stage)
            set_current_mesh(None)

    def _get_loader(self, name: str):
        """The datamodule's loader, else the module's; this rank's shard
        of it when the world has more than one rank."""
        src = None
        if self.datamodule is not None:
            src = getattr(self.datamodule, f"{name}_dataloader")()
        if src is None:
            src = getattr(self.lightning_module, f"{name}_dataloader")()
        if src is not None:
            src = self._elastic_rescale_loader(src, name)
        mesh = self._mesh
        if src is not None and self.use_distributed_sampler \
                and mesh.batch_size > 1 and hasattr(src, "shard"):
            # the batch shards: a tensor group's ranks read the same
            src = src.shard(mesh.batch_size, mesh.batch_index)
        seq = mesh.shape.get("sequence", 1)
        if src is not None and seq > 1:
            # the batch spec P(data, "sequence"): each rank its slice of
            # the inputs' and the targets' dim 1
            if not getattr(self.plugin.strategy, "shard_sequence_dim",
                           False):
                raise ValueError(
                    "a sequence axis over 1 needs shard_sequence_dim=True: "
                    "ring attention takes each rank's slice of the "
                    "sequence")
            if not hasattr(src, "slice_sequence"):
                raise TypeError(
                    f"a sequence axis over 1 slices the batches' dim 1 in "
                    f"the loader; {type(src).__name__} has no "
                    f"slice_sequence (use core.data.DataLoader)")
            src = src.slice_sequence(seq, mesh.coords["sequence"])
        return src

    def _build_redundancy(self):
        """This stage's parity manager (elastic/redundancy.py), or None
        where parity cannot run: one process, no rank-to-actor map (an
        in-process fit has no peer channel), or a model cut by a sharded
        layout (parity covers DDP and ZeRO-1)."""
        from ray_lightning_tpu_torch.elastic import redundancy as _red
        world = self.world_size
        if world < 2:
            _log.debug("elastic redundancy: one process, parity off "
                      "(snapshot replay only)")
            return None
        names = [n for n in os.environ.get("RLT_PEER_NAMES", "").split(",")
                 if n]
        if len(names) != world:
            _log.warning("elastic redundancy: no rank-to-actor map for %d "
                        "ranks (RLT_PEER_NAMES); parity off, snapshot "
                        "replay only", world)
            return None
        if self._layout is not None:
            _log.warning("elastic redundancy: parity covers DDP and ZeRO-1, "
                        "not %s's cut model; snapshot replay only",
                        self.strategy.name)
            return None
        transport = _red.PeerParityTransport(names, self.global_rank,
                                             _red.parity_timeout_s())
        return _red.RedundancyManager(self, self.elastic, self.global_rank,
                                      world, transport)

    def _elastic_rescale_loader(self, src, name: str):
        """After a shrink the fleet has fewer workers than the run started
        with: keep the global batch (the world times a worker's batch,
        what the trajectory depends on) by scaling each survivor's
        loader batch by ``initial_workers / current_workers``, the batch
        half of what the sharded restore does for the state.  A no-op
        outside an elastic restart, or where the global batch does not
        divide (a warning)."""
        es = self._elastic_state
        if not es or not self.elastic.enabled \
                or not self.elastic.preserve_global_batch:
            return src
        initial = es.get("initial_workers") or 0
        current = self.world_size
        if initial <= 0 or initial == current:
            return src
        bs = getattr(src, "batch_size", None)
        total = int(bs) * initial if bs is not None else None
        if bs is None or not hasattr(src, "shard") or total % current:
            if not self._warned_rescale:
                self._warned_rescale = True
                _log.warning(
                    "elastic: cannot rescale the %s loader %r to keep the "
                    "global batch across %d -> %d workers (no batch_size, "
                    "or it does not divide); keeping its batch", name,
                    type(src).__name__, initial, current)
            return src
        import copy
        clone = copy.copy(src)
        clone.batch_size = total // current
        return clone

    def _build_loaders(self, stage: str) -> dict:
        if stage == "fit":
            return {"train": self._get_loader("train"),
                    "val": self._get_loader("val")}
        name = _LOADER_OF_STAGE[stage]
        return {name: self._get_loader(name)}

    def _to_device(self, batch):
        return to_device(batch, self.device, self.batch_float_dtype)

    def _host_cast(self, batch):
        """A host batch as CPU tensors, the floating leaves cast as
        :meth:`_to_device` casts them (the JAX ``_host_cast``)."""
        return to_device(batch, None, self.batch_float_dtype)

    # -- fit loop -------------------------------------------------------------

    def _max_steps_reached(self) -> bool:
        return self.max_steps is not None and self.max_steps >= 0 \
            and self.global_step >= self.max_steps

    def _fit_loop(self, module, loaders):
        train_loader, val_loader = loaders["train"], loaders.get("val")
        self.num_val_batches = self._loader_len(val_loader,
                                                self.limit_val_batches)
        for cb in self.callbacks:
            cb.on_fit_start(self, module)
        module.on_fit_start()
        if val_loader is not None and self.num_sanity_val_steps > 0 \
                and self.num_val_batches > 0:
            self._sanity_check(module, val_loader)
        for cb in self.callbacks:
            cb.on_train_start(self, module)
        module.on_train_start()

        epoch = start_epoch = self.current_epoch
        ran_epoch = False
        try:
            for epoch in range(start_epoch, self.max_epochs or 10**9):
                if self.should_stop or self._max_steps_reached():
                    break       # e.g. resumed from a checkpoint at max_steps
                ran_epoch = True
                self.current_epoch = epoch
                if hasattr(train_loader, "set_epoch"):
                    train_loader.set_epoch(epoch)
                self._epoch_metric_acc = {}
                for cb in self.callbacks:
                    cb.on_train_epoch_start(self, module)
                module.on_train_epoch_start()

                self._train_epoch(module, train_loader, val_loader)

                self._flush_epoch_metrics()
                module.on_train_epoch_end()
                for cb in self.callbacks:
                    cb.on_train_epoch_end(self, module)
                if val_loader is not None and self.num_val_batches > 0 \
                        and (epoch + 1) % self.check_val_every_n_epoch == 0:
                    self._eval_loop(module, "validate", val_loader,
                                    self.limit_val_batches)
                if self.should_stop or self._max_steps_reached():
                    break
        finally:
            # zero epochs run (resumed at max_steps): the restored epoch
            # must not drift up with each save and resume
            if ran_epoch:
                self.current_epoch = (
                    min(epoch + 1, self.max_epochs or epoch + 1)
                    if not self.should_stop else epoch)
            module.on_train_end()
            for cb in self.callbacks:
                cb.on_train_end(self, module)
            module.on_fit_end()
            for cb in self.callbacks:
                cb.on_fit_end(self, module)
        self._flush_epoch_metrics()
        module._trained_state = {k: v.clone() for k, v in
                                 self._full_state(module.model).items()}
        return {"callback_metrics": dict(self.callback_metrics)}

    def _allowed_chunk(self) -> int:
        """How many steps the next chunk may run without crossing a host
        decision: ``max_steps`` or a ``val_check_interval`` boundary."""
        allowed = self.steps_per_execution
        if self.max_steps is not None and self.max_steps >= 0:
            allowed = min(allowed, self.max_steps - self.global_step)
        if self.val_check_interval:
            allowed = min(allowed, self.val_check_interval
                          - self.global_step % self.val_check_interval)
        return allowed

    def _publish_if_crossed(self, before: int, last_metrics: dict) -> None:
        """Publish when a chunk crossed a ``log_every_n_steps`` boundary
        (``last_metrics``: its last step's values)."""
        if before // self.log_every_n_steps \
                != self.global_step // self.log_every_n_steps:
            self._publish_metrics(last_metrics)

    def _train_source(self, train_loader):
        """This epoch's batch source (core/loop_engine.py): the device-
        resident set when enabled and buildable (built once a fit,
        repacked each epoch in the loader's order), else the loader."""
        if self.cache_train_dataset and not self._cache_disabled:
            if self._cache_source is None \
                    and CachedSource.usable(train_loader):
                src = CachedSource(self, train_loader)
                if src.build():
                    self._cache_source = src
            if self._cache_source is None:
                # unusable with this loader: do not try again each epoch
                self._cache_disabled = True
            else:
                return self._cache_source.new_epoch()
        return StreamSource(self, train_loader)

    def _train_epoch(self, module, train_loader, val_loader) -> None:
        """THE training loop, one for every dispatch shape: the source
        decides how batches reach the device; this loop owns the stop
        conditions, the chunk boundaries, the callback cadence (per batch
        singly, per chunk when k steps ride one dispatch) and the
        validation check after every dispatch (module docstring)."""
        source = self._train_source(train_loader)
        k = self.steps_per_execution
        while not (self.should_stop or self._max_steps_reached()):
            allowed = self._allowed_chunk()
            if allowed <= 0:
                break
            pending = source.take(allowed)
            if not pending:
                if source.exhausted:
                    break
                continue
            if len(pending) == k and k > 1 and source.chunkable(pending):
                self._engine_chunk(module, source, pending)
                self._maybe_interval_val(module, val_loader)
            else:
                for item in pending:
                    self._engine_one(module, source, item)
                    self._maybe_interval_val(module, val_loader)
                    if self.should_stop or self._max_steps_reached():
                        break

    def _batch_hook_plan(self) -> "tuple[bool, bool]":
        """``(invoke, materialize)``: does any callback override a batch
        hook, and does any of those read its batch (``needs_batch``,
        counted only where declared at or below the class that defines
        the overriding hook; an instance-assigned hook counts as an
        override that reads)?  Recomputed per dispatch, so callbacks
        added mid-epoch count."""
        def overrides(cb, name):
            fn = getattr(cb, name, None)
            return getattr(fn, "__func__", fn) is not getattr(Callback, name)

        def hook_needs_batch(cb, name):
            inst = getattr(cb, "__dict__", {})
            if "needs_batch" in inst:
                return inst["needs_batch"]
            if name in inst:
                return True
            mro = type(cb).__mro__
            hook_at = next((i for i, c in enumerate(mro)
                            if name in vars(c)), len(mro))
            for c in mro[:hook_at + 1]:
                if "needs_batch" in vars(c):
                    return vars(c)["needs_batch"]
            return True

        invoke = materialize = False
        for cb in self.callbacks:
            for name in ("on_train_batch_start", "on_train_batch_end"):
                if overrides(cb, name):
                    invoke = True
                    materialize = materialize or hook_needs_batch(cb, name)
        return invoke, materialize

    def _engine_one(self, module, source, item) -> None:
        invoke, want_batch = self._batch_hook_plan()
        batch = item.batch() if invoke and want_batch else None
        if invoke:
            for cb in self.callbacks:
                cb.on_train_batch_start(self, module, batch, item.batch_idx)
        metrics = source.run_one(self, item)
        self.global_step += 1
        self._after_step()
        self._accumulate_metrics(metrics)
        if self.global_step % self.log_every_n_steps == 0:
            self._publish_metrics(metrics)
        if invoke:
            for cb in self.callbacks:
                cb.on_train_batch_end(self, module, metrics, batch,
                                      item.batch_idx)

    def _engine_chunk(self, module, source, items) -> None:
        """k steps in ONE dispatch; the batch hooks fire once per chunk
        (module docstring)."""
        invoke, want_batch = self._batch_hook_plan()
        if invoke:
            for it in items:
                for cb in self.callbacks:
                    cb.on_train_batch_start(
                        self, module, it.batch() if want_batch else None,
                        it.batch_idx)
        before = self.global_step
        metrics = source.run_chunk(self, items)
        self.global_step += len(items)
        self._after_step()
        self._accumulate_metrics(metrics)
        self._publish_if_crossed(before, {k: v[-1]
                                          for k, v in metrics.items()})
        if invoke:
            for cb in self.callbacks:
                cb.on_train_batch_end(
                    self, module, metrics,
                    items[-1].batch() if want_batch else None,
                    items[-1].batch_idx)

    def _after_step(self) -> None:
        """The elastic plane after a dispatch: the parity tick, then the
        snapshot (a rank that dies inside its save has escrowed the step
        already); a chunk coarsens both cadences to its end, as it does
        the batch hooks."""
        if self.first_step_wall is None:
            self.first_step_wall = time.time()
        if self._redundancy is not None:
            self._redundancy.maybe_tick()
        if self._snapshotter is not None:
            self._snapshotter.maybe_snapshot()

    def _accumulate_metrics(self, metrics: dict) -> None:
        for k, v in metrics.items():
            self._epoch_metric_acc.setdefault(k, []).append(v)

    def _maybe_interval_val(self, module, val_loader) -> None:
        if self.val_check_interval \
                and self.global_step % self.val_check_interval == 0 \
                and val_loader is not None and self.num_val_batches > 0:
            self._eval_loop(module, "validate", val_loader,
                            self.limit_val_batches)

    def _publish_metrics(self, metrics: dict) -> None:
        for k, v in metrics.items():
            self.callback_metrics[k] = self.logged_metrics[k] = float(v)
        if self.logger is not None and self.is_global_zero and metrics:
            self.logger.log_metrics(
                {k: self.logged_metrics[k] for k in metrics},
                self.global_step)

    def _flush_epoch_metrics(self) -> None:
        """Per name: the epoch's mean into ``callback_metrics``, its last
        value into ``logged_metrics``; the means to the logger as
        ``<name>_epoch``.  A chunk's ``[k]`` values count as k steps."""
        flushed = {}
        for k, vals in self._epoch_metric_acc.items():
            arr = torch.cat([v.float().reshape(-1)
                             for v in vals]).double().cpu()
            self.callback_metrics[k] = flushed[k] = float(arr.mean())
            self.logged_metrics[k] = float(arr[-1])
        self._epoch_metric_acc = {}
        if self.logger is not None and self.is_global_zero and flushed:
            self.logger.log_metrics(
                {f"{k}_epoch": v for k, v in flushed.items()},
                self.global_step)

    def log_metric(self, name: str, value) -> None:
        """Record a host-side scalar into ``callback_metrics``."""
        self.callback_metrics[name] = float(np.asarray(
            value.detach().cpu() if isinstance(value, torch.Tensor)
            else value))

    # -- evaluation and prediction -------------------------------------------

    def _loader_len(self, loader, limit) -> int:
        if loader is None or limit == 0:
            return 0
        try:
            n = len(loader)
        except TypeError:
            n = 10**9
        return min(n, limit) if limit is not None else n

    def _sanity_check(self, module, val_loader) -> None:
        self.sanity_checking = True
        for cb in self.callbacks:
            cb.on_sanity_check_start(self, module)
        self._eval_loop(module, "validate", val_loader,
                        self.num_sanity_val_steps)
        for cb in self.callbacks:
            cb.on_sanity_check_end(self, module)
        self.sanity_checking = False

    def _eval_loop(self, module, stage: str, loader, limit) -> dict:
        step = self._eval_steps[stage]
        if stage == "validate":
            for cb in self.callbacks:
                cb.on_validation_start(self, module)
            for cb in self.callbacks:
                cb.on_validation_epoch_start(self, module)
            module.on_validation_epoch_start()
        else:
            for cb in self.callbacks:
                cb.on_test_start(self, module)

        acc = []
        for batch_idx, batch in enumerate(loader):
            if limit is not None and batch_idx >= limit:
                break
            batch = self._to_device(batch)
            logged = step(self.state, batch)
            leaves = batch if isinstance(batch, (tuple, list)) else [batch]
            bsz = leaves[0].shape[0] if leaves[0].dim() > 0 else 1
            acc.append((logged, bsz))
            if stage == "validate":
                for cb in self.callbacks:
                    cb.on_validation_batch_end(self, module, logged, batch,
                                               batch_idx)

        means: "dict[str, float]" = {}
        if acc:
            # per name the batch-size-weighted sum, then the batch count,
            # summed over the ranks (every rank runs as many batches)
            weights = torch.tensor([b for _, b in acc], dtype=torch.float64)
            sums = [(torch.stack([d[k].float() for d, _ in acc]).double()
                     .cpu() * weights).sum() for k in acc[0][0]]
            sums = _parallel.sum_over_ranks(
                torch.stack([*sums, weights.sum()]).to(self.device)).cpu()
            total = max(float(sums[-1]), 1.0)
            means = {k: float(v / total) for k, v in zip(acc[0][0], sums)}
        if not self.sanity_checking:
            self.callback_metrics.update(means)
            self.logged_metrics.update(means)
            if self.logger is not None and self.is_global_zero and means:
                self.logger.log_metrics(means, self.global_step)

        if stage == "validate":
            module.on_validation_epoch_end()
            for cb in self.callbacks:
                cb.on_validation_epoch_end(self, module)
            for cb in self.callbacks:
                cb.on_validation_end(self, module)
        else:
            for cb in self.callbacks:
                cb.on_test_epoch_end(self, module)
            for cb in self.callbacks:
                cb.on_test_end(self, module)
        return means

    def _predict_loop(self, module, loader) -> list:
        for cb in self.callbacks:
            cb.on_predict_start(self, module)
        outputs = []
        for batch_idx, batch in enumerate(loader):
            if self.limit_predict_batches is not None \
                    and batch_idx >= self.limit_predict_batches:
                break
            out = _to_cpu(self._predict_step(self.state,
                                             self._to_device(batch)))
            if self.world_size > 1:
                parts = _parallel.gather_objects(out)
                # one rank a batch shard: a tensor group's hold the same
                parts = [parts[r] for r in self._mesh.batch_leaders()]
                out = _deinterleave(_cat_ranks(parts),
                                    self._mesh.batch_size)
            outputs.append(out)
        outputs = _trim_predict_padding(outputs, loader)
        for cb in self.callbacks:
            cb.on_predict_end(self, module)
        return outputs

    # -- checkpointing -------------------------------------------------------

    def _full_state(self, model) -> "dict[str, torch.Tensor]":
        """``model.state_dict()`` with every tensor whole (gathered from
        the ranks' blocks under a sharded layout: collective)."""
        return fetch_tree(model.state_dict(), self._layout, host=False)

    def _load_full_state(self, model, state) -> None:
        """``model.load_state_dict`` of whole tensors (each rank takes its
        blocks under a sharded layout)."""
        if self._layout is None:
            model.load_state_dict(state)
        else:
            self._layout.load_full_state_dict(model, state)

    def dump_checkpoint(self) -> dict:
        """The checkpoint dict (module docstring): plain containers whose
        tensors are the live state's, detached (whole: gathered under a
        sharded layout, a collective)."""
        module = self.lightning_module
        model = module.model
        full = self._full_state(model)
        params = dict(model.named_parameters())
        ckpt = {
            "epoch": int(self.current_epoch),
            "global_step": int(self.global_step),
            "state": {
                "step": int(self.state.step),
                "params": {k: full[k] for k in params},
                "model_state": {k: b.detach() for k, b in
                                model.named_buffers()},
                "opt_state": self.state.opt_state.state_dict(),
                "rng": int(self.state.generator.initial_seed()),
            },
            "hparams": _sanitize(dict(module.hparams)),
            "callbacks": {type(cb).__name__: _sanitize(cb.state_dict())
                          for cb in self.callbacks},
            "world_size": int(self.world_size),
            "strategy": self.strategy.name,
        }
        module.on_save_checkpoint(ckpt)
        for cb in self.callbacks:
            cb.on_save_checkpoint(self, module, ckpt)
        return ckpt

    @staticmethod
    def serialize_checkpoint(ckpt: dict) -> bytes:
        """The bytes :meth:`save_checkpoint` writes for ``ckpt``
        (``torch.save`` of its plain containers), as the Tune checkpoint
        relay sends them to the trial driver."""
        return to_state_stream(ckpt)

    def save_checkpoint(self, filepath: str) -> None:
        """Write :meth:`dump_checkpoint` to ``filepath`` atomically: into
        a temporary file in the same directory that then replaces it.
        Collective: every rank builds the dict, global zero alone
        writes.  An fsspec URL (``"memory://..."``, ``"s3://..."``) is
        written through fsspec, in one piece."""
        ckpt = self.dump_checkpoint()
        if not self.is_global_zero:
            return
        payload = self.serialize_checkpoint(ckpt)
        if _remote(filepath):
            with _fsspec().open(filepath, "wb") as f:
                f.write(payload)
            return
        dirname = os.path.dirname(filepath)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=dirname or ".")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
            os.replace(tmp, filepath)
        except BaseException:
            os.unlink(tmp)
            raise

    @staticmethod
    def load_checkpoint_dict(filepath: str,
                             map_location: "str | torch.device | None" = None
                             ) -> dict:
        """A checkpoint file's dict, its tensors on ``map_location`` (as
        saved when ``None``); a local path or an fsspec URL."""
        opener = _fsspec().open if _remote(filepath) else open
        with opener(filepath, "rb") as f:
            return load_state_stream(f.read(), map_location)

    def _restore_checkpoint(self, filepath: str, module) -> None:
        """The state, counters and callback states of a checkpoint, its
        tensors on this trainer's device in their saved dtypes; then the
        module's and the callbacks' ``on_load_checkpoint``.  A sharded
        checkpoint directory (utils/checkpoint.py) restores through
        :meth:`_restore_sharded`."""
        from ray_lightning_tpu_torch.utils.checkpoint import \
            ShardedCheckpointer
        if ShardedCheckpointer.is_sharded_checkpoint(filepath):
            self._restore_sharded(filepath, module)
            return
        ckpt = self.load_checkpoint_dict(filepath, self.device)
        st = ckpt["state"]
        model = module.model
        saved = {**st["params"], **st.get("model_state", {})}
        live = model.state_dict()
        wrong = [k for k, v in saved.items()
                 if k in live and v.dtype != live[k].dtype]
        if wrong:
            raise ValueError(
                f"checkpoint {filepath}: {wrong[:4]} saved as "
                f"{saved[wrong[0]].dtype}, the model holds "
                f"{live[wrong[0]].dtype}; restore would cast them")
        self._load_full_state(model, saved)
        opt = self.state.opt_state
        # a CommState takes a save with or without a residual; a state
        # without the plane drops a saved residual
        opt.load_state_dict(st["opt_state"] if isinstance(opt, CommState)
                            else inner_state_dict(st["opt_state"]))
        self._restore_counters(int(st["step"]), int(st["rng"]), ckpt,
                               module)

    def _restore_counters(self, step: int, rng: int, ckpt: dict,
                          module) -> None:
        """The step count, seed, epoch, global step and callback states
        of a restored checkpoint (``ckpt``: its dict, or a sharded one's
        meta), then the ``on_load_checkpoint`` hooks."""
        self.state.step = step
        self.state.generator = torch.Generator(
            device=self.device).manual_seed(rng)
        self.current_epoch = int(ckpt.get("epoch", 0))
        self.global_step = int(ckpt.get("global_step", 0))
        cb_states = ckpt.get("callbacks", {})
        for cb in self.callbacks:
            cb_state = cb_states.get(type(cb).__name__)
            if cb_state:
                cb.load_state_dict(cb_state)
        module.on_load_checkpoint(ckpt)
        for cb in self.callbacks:
            cb.on_load_checkpoint(self, module, ckpt)

    # -- sharded checkpoints (utils/checkpoint.py) ---------------------------

    def _checkpoint_layout(self) -> ShardLayout:
        """The layout a sharded checkpoint is written in: the strategy's,
        or every parameter whole on every rank (DDP, ZeRO-1)."""
        if self._layout is not None:
            return self._layout
        return ShardLayout.of_model(self.lightning_module.model,
                                    self.plugin.strategy, self._mesh)

    def sharded_state_dict(self, stage=None) -> dict:
        """The state as a sharded checkpoint holds it: ``params``,
        ``model_state`` and ``opt_state``, each per-parameter tensor this
        rank's block ``stage``d (default: a host copy) as a DTensor of
        its storage shape (parallel/layout.py ``ShardLayout.dtensor``).
        Collective under ZeRO-1, whose flat shards leave as the
        single-device layout."""
        stage = stage or (lambda t: t.detach().to("cpu", copy=True))
        layout = self._checkpoint_layout()
        model = self.lightning_module.model
        opt = self.state.opt_state
        inner = opt.inner if isinstance(opt, CommState) else opt
        if isinstance(inner, ShardedOptState):
            opt_sd = inner.sharded_state_dict(stage)
        else:
            opt_sd = map_param_dicts(inner.state_dict(), layout.names,
                                     lambda k, v: layout.dtensor(k, stage(v)))
        if isinstance(opt, CommState):
            # each rank's residual is row ``index`` of a [W, ...] tensor
            sync = self._grad_sync
            opt_sd = {"residual": {
                k: _row_dtensor(stage(r)[None], sync.index, sync.world,
                                self._mesh)
                for k, r in opt.residual.items()}, "inner": opt_sd}
        return {"params": {k: layout.dtensor(k, stage(p))
                           for k, p in model.named_parameters()},
                "model_state": {k: stage(b)
                                for k, b in model.named_buffers()},
                "opt_state": opt_sd}

    def _sharded_checkpointer(self, directory: str,
                              max_to_keep: Optional[int] = None):
        """The live checkpointer of ``directory`` (made on first use and
        kept for the stage; made again when ``max_to_keep`` changes)."""
        from ray_lightning_tpu_torch.utils.checkpoint import \
            ShardedCheckpointer
        ckpt = self._sharded_checkpointers.get(directory)
        if ckpt is not None and ckpt.max_to_keep != max_to_keep:
            ckpt.close()
            ckpt = None
        if ckpt is None:
            ckpt = ShardedCheckpointer(directory, max_to_keep=max_to_keep,
                                       mesh=self._mesh)
            self._sharded_checkpointers[directory] = ckpt
        return ckpt

    def save_sharded_checkpoint(self, directory: str,
                                step: Optional[int] = None,
                                max_to_keep: Optional[int] = None) -> None:
        """Every rank writes its own blocks of the state under
        ``directory/<step>`` (default: the global step), asynchronously,
        with no gather, unlike :meth:`save_checkpoint`
        (utils/checkpoint.py).  Collective: every rank calls it."""
        ckpt = self._sharded_checkpointer(directory, max_to_keep)
        step = int(self.global_step if step is None else step)
        if ckpt.has(step):
            return                  # two cadences on one step: no copy
        module = self.lightning_module
        meta = {
            "epoch": int(self.current_epoch),
            "global_step": int(self.global_step),
            "world_size": int(self.world_size),
            "strategy": self.strategy.name,
            "hparams": _sanitize(dict(module.hparams)) if module else {},
            "callbacks": {type(cb).__name__: _sanitize(cb.state_dict())
                          for cb in self.callbacks},
            "step": int(self.state.step),
            "rng": int(self.state.generator.initial_seed()),
        }
        opt = self.state.opt_state
        if isinstance(opt, CommState) and opt.residual:
            # the residual's stacked world: a restore into another world
            # re-buckets it (``_restore_sharded``)
            meta["comm_world"] = int(opt.world)
        t0 = time.perf_counter()
        ckpt.save(step, self.sharded_state_dict(), meta)
        self.checkpoint_stats["save_stage_s"] = time.perf_counter() - t0

    def wait_for_checkpoints(self) -> None:
        """Block until the in-flight sharded saves are durable."""
        for ckpt in self._sharded_checkpointers.values():
            ckpt.wait()

    def _close_sharded_checkpointers(self) -> None:
        """Wait for and release every sharded checkpointer of the stage
        (their writer threads outlive it otherwise); a later save opens
        one again."""
        try:
            for ckpt in self._sharded_checkpointers.values():
                ckpt.close()
        finally:
            self._sharded_checkpointers = {}

    def _restore_sharded(self, directory: str, module) -> None:
        """Restore a sharded checkpoint (its root: the latest step; or
        one step's directory) into this stage's layout, which may be
        another mesh's or strategy's than the one that saved: each rank
        reads the chunks that overlap its blocks.  The hooks receive the
        checkpoint's meta (``dump_checkpoint``'s keys without
        ``state``)."""
        from ray_lightning_tpu_torch.elastic.reshard import _verify_shapes
        from ray_lightning_tpu_torch.utils.checkpoint import (
            ShardedCheckpointer, flatten)
        t0 = time.perf_counter()
        root, step = ShardedCheckpointer.split_step_dir(directory)
        ckpt = ShardedCheckpointer(root, mesh=self._mesh)
        opt = self.state.opt_state
        try:
            saved = ckpt.saved_state_metadata(step) or {}
            template = self.sharded_state_dict(
                stage=lambda t: torch.empty(t.shape, dtype=t.dtype))
            res_keys = {k[len("opt_state/residual/"):]: v for k, v in
                        saved.items() if k.startswith("opt_state/residual/")}
            if isinstance(opt, CommState):
                # the saved [N, ...] rows whole on every rank (re-bucketed
                # below); a save without the plane restores the inner
                # state alone and error feedback starts from zero
                if res_keys:
                    template["opt_state"]["residual"] = {
                        k: torch.empty(shape, dtype=dt)
                        for k, (shape, dt) in res_keys.items()}
                else:
                    template["opt_state"] = template["opt_state"]["inner"]
            elif res_keys:
                # saved with the plane, restored where it is inert: the
                # residual is dropped
                template["opt_state"] = {"inner": template["opt_state"]}
            # another model's save raises naming the leaf, before a read
            _verify_shapes(saved, flatten(template))
            state, meta = ckpt.restore(template, step)
        finally:
            ckpt.close()
        layout = self._checkpoint_layout()
        model = module.model
        live = dict(model.named_parameters())
        wrong = [k for k, p in live.items() if f"params/{k}" in saved
                 and saved[f"params/{k}"][1] != p.dtype]
        if wrong:
            raise ValueError(
                f"checkpoint {directory}: {wrong[:4]} saved as "
                f"{saved['params/' + wrong[0]][1]}, the model holds "
                f"{live[wrong[0]].dtype}; restore would cast them")
        with torch.no_grad():
            for k, p in live.items():
                p.copy_(layout.from_storage(k, state["params"][k]))
            for k, b in model.named_buffers():
                b.copy_(state["model_state"][k])
        opt_sd = state["opt_state"]
        if isinstance(opt, CommState):
            if res_keys:
                opt.load_residual(opt_sd["residual"])
                opt_sd = opt_sd["inner"]
            else:
                opt.zero_residual()
            inner = opt.inner
        else:
            inner = opt
            if res_keys:
                opt_sd = opt_sd["inner"]
        if isinstance(inner, ShardedOptState):
            inner.load_sharded_state_dict(opt_sd, self.device)
        else:
            inner.load_state_dict(map_param_dicts(
                opt_sd, layout.names,
                lambda k, v: layout.from_storage(k, v).to(self.device)))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.checkpoint_stats["restore_s"] = time.perf_counter() - t0
        # the replay counter a parity recovery must leave at 0
        self._snapshot_restores += 1
        self._restore_counters(int(meta["step"]), int(meta["rng"]), meta,
                               module)

    def elastic_stats(self) -> Optional[dict]:
        """This process's elastic numbers: the snapshotter's and the
        parity manager's counters, the sharded restores of the stage
        (``snapshot_restores``) and the driver's restart bookkeeping.
        Rank 0's copy rides its result to the driver, which folds it into
        ``_elastic_report``; None with nothing to say."""
        out: dict = {}
        if self._snapshotter is not None:
            out.update(self._snapshotter.stats)
        if self._redundancy is not None:
            out.update(self._redundancy.stats)
        if self._snapshot_restores:
            out["snapshot_restores"] = self._snapshot_restores
        if self._elastic_state:
            out.update(self._elastic_state)
        return out or None


def _row_dtensor(row: torch.Tensor, index: int, world: int, mesh):
    """``row`` ([1, ...], this rank's) as row ``index`` of a ``[world,
    ...]`` DTensor sharded on dim 0 along the mesh's ``data`` axis (the
    comm plane's residual in a sharded checkpoint)."""
    if world == 1 or mesh.world == 1:
        return row
    from torch.distributed.tensor import DTensor, Replicate, Shard
    ckpt_mesh, _ = mesh.checkpoint_mesh()
    placements = [Shard(0) if a == "data" else Replicate()
                  for a in mesh.axis_names]
    shape = (world,) + tuple(row.shape[1:])
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(row.contiguous(), ckpt_mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def _remote(filepath: str) -> bool:
    return "://" in filepath


def _fsspec():
    import fsspec
    return fsspec


def _cat_ranks(parts: list):
    """One predict batch's outputs of every rank, joined along the batch
    dim in rank order (tensors inside tuples, lists and dicts too)."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts)
    if isinstance(first, (tuple, list)):
        return type(first)(_cat_ranks(list(p)) for p in zip(*parts))
    if isinstance(first, dict):
        return {k: _cat_ranks([p[k] for p in parts]) for k in first}
    return parts


def _deinterleave(out, w: int):
    """A gathered predict batch (rank 0's rows, then rank 1's, ...) back
    in dataset order: the loader's stride gives rank r the dataset
    indices r, r + W, ..., so dataset order is the (position, rank)
    transpose (the JAX ``_deinterleave_global_batch``)."""
    def fix(t):
        if t.dim() == 0 or t.shape[0] % w:
            return t
        lb = t.shape[0] // w
        return t.reshape(w, lb, *t.shape[1:]).transpose(0, 1).reshape(
            w * lb, *t.shape[1:])
    return tree_map(fix, out)


def _trim_predict_padding(outputs: list, loader) -> list:
    """``outputs`` without the trailing rows of the loader's wrap-around
    padding (``DataLoader._indices`` pads so every shard is as long),
    so every sample comes back once (the JAX ``_trim_predict_padding``).
    Outputs without a batch dim are left as they are."""
    if not outputs or getattr(loader, "num_shards", 1) <= 1:
        return outputs
    ds = getattr(loader, "dataset", None)
    if ds is None or not hasattr(ds, "__len__"):
        return outputs
    counts = [next((t.shape[0] for t in tree_leaves(o) if t.dim() > 0), None)
              for o in outputs]
    if any(c is None for c in counts):
        return outputs
    excess = sum(counts) - len(ds)
    if excess <= 0:
        return outputs
    keep = counts[-1] - excess
    if keep <= 0:
        return outputs[:-1]
    outputs[-1] = tree_map(
        lambda t: t[:keep] if t.dim() > 0 else t, outputs[-1])
    return outputs


def _to_cpu(out):
    """A predict step's output with every tensor on the host."""
    return tree_map(lambda t: t.cpu(), out)


def _sanitize(obj):
    """A nested structure as the plain containers a checkpoint holds:
    tuples as lists, numpy scalars as Python numbers, anything else
    unknown as its ``repr`` (the JAX ``_sanitize``)."""
    if isinstance(obj, dict):
        return {str(k): _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, (str, int, float, bool, type(None), torch.Tensor)):
        return obj
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    return repr(obj)


__all__ = ["Trainer"]
