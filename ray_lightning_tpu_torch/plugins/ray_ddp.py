"""Distributed execution plugins: DDP, ZeRO-1, FSDP and SPMD training
over subprocess actors, one rank a worker.

``RayPlugin`` and ``RayShardedPlugin`` take the original reference's
names (``ray_lightning/ray_ddp.py``, ``ray_ddp_sharded.py``); their JAX
counterparts are ``RayXlaPlugin`` and ``RayXlaShardedPlugin``
(``ray_lightning_tpu/plugins/xla.py``), without its telemetry and
MPMD branches.  The workers get the compile cache's and the planner's
env (``CompileCacheConfig.worker_env``, ``PlanConfig.worker_env``) and
``RLT_REMAT_POLICY``; under ``strategy="auto"`` every rank plans alike
and rank 0's report returns to ``trainer._plan_report``.
``RaySpmdPlugin``
(JAX ``RayXlaSpmdPlugin``, ``plugins/xla.py:696-703``) defaults to
``strategy="spmd"``; one rank is one card, so the JAX
``devices_per_worker=2`` is twice the workers here.  Driver side, a
run:

  1. creates ``num_workers`` executor actors (cluster/local.py) and runs
     ``init_hook`` on each;
  2. takes worker 0's address and a free port there as ``MASTER_ADDR``
     and ``MASTER_PORT``, assigns each worker its node and local rank
     from the node addresses (:meth:`RayPlugin._assign_local_ranks`),
     and, for GPU workers, checks that no node hosts more of them than
     it has GPUs (NCCL refuses two ranks on one device);
  3. ships one pickled payload (trainer, module, datamodule) through
     the object store;
  4. waits for the results while relaying queue items
     (``util.process_results``; with ``RLT_DATA_CHECK=1`` the workers'
     batch fingerprints go to the run's validator, which raises on a
     divergent loader), and rehydrates the module from rank 0's state
     stream, with the metrics, counters and best checkpoint;
  5. kills every actor, whatever happened.

An elastic fit (``Trainer(elastic=...)`` with ``max_restarts > 0``)
goes through ``run_elastic_fit`` (elastic/driver.py), which calls
:meth:`RayPlugin._run_attempt`, one fleet's lifecycle, until a fleet
finishes: when an attempt fails, the plugin first probes which ranks'
processes died (``process_alive``, never a busy survivor) and harvests
the survivors' parity escrows from their frame readers, then tears the
fleet down; the driver shrinks it and starts the next attempt, with a
fresh ``MASTER_PORT``.  A survivor blocked in a collective whose peer
died (NCCL) is never waited for past ``util.FAILURE_GRACE_S``: the dead
actor's failed call decides the attempt.  Each worker gets the
rank-ordered actor names (``RLT_PEER_NAMES``), so rank r reaches rank s
over the peer channel.

Worker side (:func:`_worker_run`), each actor takes its device (its
local GPU, ``cuda:<local rank>``, or the CPU), joins the default process
group (NCCL on the card, gloo on the CPU) and re-enters
``trainer._run_stage``: the strategy (parallel/strategy.py) then syncs
the gradients and shards the optimizer state.  The driver never touches
CUDA for a plugin run.

``RLT_ONE_CARD_GLOO=1`` (tests and the smoke only, read on the driver
and passed to the workers) puts every GPU worker on card 0 over gloo:
two ranks of one communicator cannot share a card under NCCL, so a
one-card machine runs a multi-rank fit time-sliced this way, its
collectives through host memory.  Nothing else changes backend.

Payload callables (``init_hook``, ``session.put_queue`` items,
callbacks) are pickled with stdlib ``pickle``, by import path: they are
module-level functions or classes the workers can import.
"""

from __future__ import annotations

import datetime
import os
import time
import uuid
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from ray_lightning_tpu_torch._device import worker_device
from ray_lightning_tpu_torch.cluster.backend import get_backend
from ray_lightning_tpu_torch.cluster.executor import RLTExecutor
from ray_lightning_tpu_torch.cluster.queue import WorkerQueueProxy
from ray_lightning_tpu_torch.compile import cache as compile_cache
from ray_lightning_tpu_torch.parallel.strategy import resolve_strategy
from ray_lightning_tpu_torch.plugins.base import (ExecutionPlugin,
                                                   data_check_validator)
from ray_lightning_tpu_torch.session import init_session, reset_session
from ray_lightning_tpu_torch.util import process_results
from ray_lightning_tpu_torch.utils.seed import SEED_ENV_VAR
from ray_lightning_tpu_torch.utils.states import (load_state_stream,
                                                  to_state_stream)

#: the bound of each set-up call to the workers (they import torch and
#: the package first)
SETUP_TIMEOUT_S = 120.0
#: the default bound of ``init_hook`` and of a stage's run on the driver
#: (``RayPlugin(timeout_s=...)`` sets another for longer fits)
RUN_TIMEOUT_S = 3600.0
#: the most a collective waits (less when the run's bound is shorter)
COLLECTIVE_TIMEOUT_S = 600.0
#: every GPU worker on card 0 over gloo (module docstring)
ONE_CARD_ENV = "RLT_ONE_CARD_GLOO"
#: the bound of one survivor's escrow harvest (a blob of its optimizer
#: shard, the params and a parity block through the driver's socket)
ESCROW_TIMEOUT_S = 60.0


def one_card(env=None) -> bool:
    """Whether ``RLT_ONE_CARD_GLOO`` asks for every GPU rank on card 0."""
    return (os.environ if env is None else env).get(ONE_CARD_ENV) == "1"


def _worker_run(payload: tuple, rank: int, queue) -> Optional[dict]:
    """Runs inside each actor: take the device, join the process group,
    re-enter the trainer's loop, and on rank 0 pack the results."""
    trainer, module, datamodule, stage, ckpt_path = payload
    plugin = trainer.plugin
    plugin._is_remote = True
    shared = one_card()
    device = plugin._worker_device(
        0 if shared else int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(
        "nccl" if device.type == "cuda" and not shared else "gloo",
        rank=rank,
        world_size=plugin.num_workers,
        timeout=datetime.timedelta(
            seconds=min(plugin.timeout_s, COLLECTIVE_TIMEOUT_S)))
    reset_session()
    init_session(rank, queue)
    trainer.device = device
    try:
        result = trainer._run_stage(module, datamodule, stage, ckpt_path)
    finally:
        dist.destroy_process_group()
    # every rank's kernel-cache counters: how warm this process started
    counters = compile_cache.stats().to_dict()
    if rank != 0:
        return {"compile_cache": counters}
    package: "dict[str, Any]" = {
        "compile_cache": counters,
        "result": result,
        "callback_metrics": dict(trainer.callback_metrics),
        "epoch": int(trainer.current_epoch),
        "global_step": int(trainer.global_step),
    }
    package["first_step_wall"] = trainer.first_step_wall
    # the planner's report (strategy="auto": every rank planned alike)
    # and the first step's clock (compile plane)
    package["plan_report"] = trainer._plan_report
    package["time_to_first_step"] = trainer.time_to_first_step
    if stage == "fit":
        # the elastic plane's numbers, for the driver's report
        package["elastic"] = trainer.elastic_stats()
        # the weights return in-band as a state stream: a temp-file
        # handoff breaks across nodes (the reference's ray_ddp.py)
        package["stream_t0"] = time.time()
        package["state_stream"] = to_state_stream(module._trained_state)
        ckpt_cb = trainer.checkpoint_callback
        if ckpt_cb is not None:
            package["best_model_path"] = ckpt_cb.best_model_path
            package["best_model_score"] = ckpt_cb.best_model_score
    return package


class RayPlugin(ExecutionPlugin):
    """Data-parallel training over subprocess actors, one rank each
    (module docstring).

    Workers run on the card unless the caller asks for the CPU:
    ``platform="cpu"`` or ``use_gpu=False`` gives CPU workers on gloo,
    each with ``num_cpus_per_worker`` intra-op threads.
    ``resources_per_worker`` overrides the convenience arguments: its
    ``"CPU"`` sets ``num_cpus_per_worker``, its ``"GPU"`` sets
    ``use_gpu`` (``> 0``) and the GPUs a worker asks for, and other keys
    are kept as custom resources.  ``worker_env`` is added to each
    worker's environment.  ``timeout_s`` bounds ``init_hook`` and a
    stage's run on the driver (past it the fit raises ``TimeoutError``
    and the actors are killed), and each collective up to
    ``COLLECTIVE_TIMEOUT_S``."""

    remote = True

    def __init__(self, num_workers: int = 1, num_cpus_per_worker: float = 1,
                 use_gpu: bool = True, platform: Optional[str] = None,
                 strategy: Any = "ddp", init_hook: Optional[Callable] = None,
                 resources_per_worker: Optional[dict] = None,
                 worker_env: Optional[dict] = None,
                 timeout_s: float = RUN_TIMEOUT_S):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if timeout_s is None or not timeout_s > 0:
            raise ValueError(f"timeout_s must be a positive number of "
                             f"seconds, got {timeout_s!r}")
        if platform not in (None, "cpu", "cuda"):
            raise ValueError(f"platform must be 'cpu' or 'cuda', got "
                             f"{platform!r}")
        self.num_workers = int(num_workers)
        self.strategy = resolve_strategy(strategy)
        self.init_hook = init_hook
        self.worker_env = dict(worker_env or {})
        self.timeout_s = float(timeout_s)
        resources = dict(resources_per_worker or {})
        self.num_cpus_per_worker = resources.pop("CPU", num_cpus_per_worker)
        self.gpus_per_worker = 1
        if "GPU" in resources:
            self.gpus_per_worker = resources.pop("GPU")
            use_gpu = self.gpus_per_worker > 0
        self.additional_resources = resources
        self.use_gpu = bool(use_gpu) and platform != "cpu"
        self.platform = "cuda" if self.use_gpu else "cpu"
        self._workers: list = []
        self._backend = None
        self._is_remote = False
        #: the last fit's result round trip on the driver: the state
        #: stream's bytes and its seconds from rank 0's pack to the
        #: driver's unpack
        self.last_result: dict = {}

    # -- pickling: the payload carries the plugin without live handles ----

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_workers"] = []
        state["_backend"] = None
        state["init_hook"] = None       # already run before shipping
        state["_last_escrows"] = {}     # the driver's, never shipped
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)

    # -- resources and environment -----------------------------------------

    def _worker_resources(self) -> dict:
        res = {"CPU": self.num_cpus_per_worker, **self.additional_resources}
        if self.use_gpu:
            res["GPU"] = self.gpus_per_worker
        return res

    def _worker_env_base(self) -> dict:
        env = {}
        if SEED_ENV_VAR in os.environ:
            env[SEED_ENV_VAR] = os.environ[SEED_ENV_VAR]
        if not self.use_gpu:
            env["CUDA_VISIBLE_DEVICES"] = ""     # CPU workers stay off it
        if one_card():
            env[ONE_CARD_ENV] = "1"
        if os.environ.get("RLT_REMAT_POLICY", "").strip():
            # the model build's remat override (core/remat.py
            # model_policy), which pins the planner's remat axis: the
            # workers build the driver's program
            env["RLT_REMAT_POLICY"] = os.environ["RLT_REMAT_POLICY"]
        env.update(self.worker_env)
        return env

    def _worker_device(self, local_rank: int) -> torch.device:
        """In a worker: its local GPU, made current, or the CPU.  A GPU
        worker without CUDA raises: it never trains on the CPU."""
        return worker_device(
            self.use_gpu, local_rank, self.num_cpus_per_worker,
            "RayPlugin(use_gpu=True)", "platform='cpu' (or use_gpu=False)")

    # -- driver-side run ------------------------------------------------------

    def run(self, trainer, module, datamodule, stage: str,
            ckpt_path: Optional[str]):
        if self._is_remote:
            raise RuntimeError("plugin.run called inside a worker")
        elastic = trainer.elastic
        if stage == "fit" and elastic.enabled and elastic.max_restarts > 0:
            # shrink-to-continue (elastic/driver.py)
            from ray_lightning_tpu_torch.elastic.driver import \
                run_elastic_fit
            return run_elastic_fit(self, trainer, module, datamodule,
                                   ckpt_path)
        return self._run_attempt(trainer, module, datamodule, stage,
                                 ckpt_path)

    def _run_attempt(self, trainer, module, datamodule, stage: str,
                     ckpt_path: Optional[str]):
        """One fleet's lifecycle: create the actors, rendezvous, run the
        stage, tear down.  On a failure, before teardown: the ranks
        whose processes died (``_last_dead_ranks``) and, for an elastic
        fit with parity, the survivors' escrows (``_last_escrows``)."""
        backend = get_backend()
        self._backend = backend
        env = self._worker_env_base()
        # the comm and elastic planes' knobs, so a nested fit in a worker
        # resolves the same config (the trainer carries the resolved one)
        env.update(trainer.comm_policy.worker_env())
        env.update(trainer.elastic.worker_env())
        env.update(trainer.compile_cache.worker_env())
        env.update(trainer.plan.worker_env())
        tag = uuid.uuid4().hex[:8]
        names = [f"rlt-worker-{os.getpid()}-{tag}-{i}"
                 for i in range(self.num_workers)]
        # rank-ordered actor names: rank r sends to rank s by name over
        # the peer channel (elastic/redundancy.py)
        env["RLT_PEER_NAMES"] = ",".join(names)
        self._last_dead_ranks, self._last_escrows = [], {}
        self._last_harvest_s = None
        try:
            self._workers = [
                backend.create_actor(
                    RLTExecutor, env=env,
                    resources=self._worker_resources(), name=name)
                for name in names]
            return self._execution_loop(trainer, module, datamodule, stage,
                                        ckpt_path, backend)
        except BaseException:
            # the strict probe: a busy survivor reads alive
            self._last_dead_ranks = [
                i for i, w in enumerate(self._workers)
                if w.process_alive() is False]
            t0 = time.monotonic()
            if stage == "fit" and trainer.elastic.enabled \
                    and trainer.elastic.redundancy > 0:
                for i, w in enumerate(self._workers):
                    if i not in self._last_dead_ranks:
                        esc = w.harvest_escrow(timeout=ESCROW_TIMEOUT_S)
                        if esc is not None:
                            self._last_escrows[i] = esc
            self._last_harvest_s = time.monotonic() - t0
            raise
        finally:
            for w in self._workers:
                w.kill()
            self._workers = []

    def _execution_loop(self, trainer, module, datamodule, stage, ckpt_path,
                        backend):
        workers = self._workers

        def on_all(method, *args, timeout=SETUP_TIMEOUT_S):
            return process_results([w.call(method, *args) for w in workers],
                                   backend, timeout)

        if self.init_hook is not None:
            on_all("execute", self.init_hook, timeout=self.timeout_s)
        addr, port = process_results(
            [workers[0].call("get_node_ip"),
             workers[0].call("get_free_port")], backend, SETUP_TIMEOUT_S)
        node_info = on_all("get_node_and_device_info")
        ranks = self._assign_local_ranks(node_info)
        if self.use_gpu and not one_card(self._worker_env_base()):
            self._check_gpu_fit(node_info, ranks)
        process_results([w.call("set_env_vars", {
            "MASTER_ADDR": addr, "MASTER_PORT": str(port),
            "NODE_RANK": str(ranks[i][0]), "LOCAL_RANK": str(ranks[i][1])})
            for i, w in enumerate(workers)], backend, SETUP_TIMEOUT_S)

        ref = backend.put((trainer, module, datamodule, stage, ckpt_path))
        try:
            results = process_results(
                [w.call("execute", _worker_run, ref, i, WorkerQueueProxy())
                 for i, w in enumerate(workers)], backend, self.timeout_s,
                validator=data_check_validator(self.worker_env))
        finally:
            backend.free(ref)
        return self._post_dispatch(trainer, module, stage, results)

    @staticmethod
    def _assign_local_ranks(node_info: "list[dict]"
                            ) -> "dict[int, tuple[int, int]]":
        """Global rank -> (node rank, local rank) from the node addresses
        (the reference's ``get_local_ranks``): nodes numbered in address
        order, ranks on a node in global order."""
        by_ip: "dict[str, list[int]]" = {}
        for i, info in enumerate(node_info):
            by_ip.setdefault(info.get("ip", "?"), []).append(i)
        out: "dict[int, tuple[int, int]]" = {}
        for node_rank, (_ip, members) in enumerate(sorted(by_ip.items())):
            for local_rank, grank in enumerate(members):
                out[grank] = (node_rank, local_rank)
        return out

    @staticmethod
    def _check_gpu_fit(node_info: "list[dict]",
                       ranks: "dict[int, tuple[int, int]]") -> None:
        """Raise ``ValueError`` when a node hosts more GPU workers than it
        has GPUs: NCCL refuses two ranks on one device, and would hang
        the rendezvous.  A node that sees no GPU is left to its workers,
        which raise CUDA's absence themselves."""
        workers: "dict[int, list[int]]" = {}
        for i, (node, _local) in ranks.items():
            workers.setdefault(node, []).append(i)
        for node, members in sorted(workers.items()):
            gpus = node_info[members[0]].get("num_gpus", 0)
            if 0 < gpus < len(members):
                raise ValueError(
                    f"node {node_info[members[0]].get('ip')} hosts "
                    f"{len(members)} GPU workers but sees {gpus} GPUs: "
                    f"NCCL takes one GPU a rank; use at most {gpus} "
                    f"workers there")

    def _post_dispatch(self, trainer, module, stage, results):
        rank0 = results[0]
        for rank, r in enumerate(results):
            compile_cache.note_remote((r or {}).get("compile_cache"),
                                      f"{type(self).__name__} rank {rank}")
        trainer.first_step_wall = rank0.get("first_step_wall")
        trainer._plan_report = rank0.get("plan_report")
        trainer.time_to_first_step = rank0.get("time_to_first_step")
        trainer._elastic_worker_stats = rank0.get("elastic")
        trainer.callback_metrics.update(rank0["callback_metrics"])
        trainer.current_epoch = rank0["epoch"]
        trainer.global_step = rank0["global_step"]
        if stage == "fit":
            stream = rank0["state_stream"]
            # on the host: the driver stays off CUDA
            module._trained_state = load_state_stream(stream, "cpu")
            self.last_result = {
                "state_stream_bytes": len(stream),
                "round_trip_s": time.time() - rank0["stream_t0"]}
            ckpt_cb = trainer.checkpoint_callback
            if ckpt_cb is not None and rank0.get("best_model_path"):
                # a path on rank 0's node: valid on a shared filesystem
                ckpt_cb.best_model_path = rank0["best_model_path"]
                ckpt_cb.best_model_score = rank0["best_model_score"]
        return rank0["result"]


class RayShardedPlugin(RayPlugin):
    """ZeRO-1 (the reference's ``RayShardedPlugin``; JAX
    ``RayXlaShardedPlugin``): the same orchestration with
    ``strategy="zero1"``: the fp32 master and the optimizer's moments
    sharded across the ranks, gradients reduce-scattered, params
    all-gathered (parallel/strategy.py)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("strategy", "zero1")
        super().__init__(*args, **kwargs)


class RaySpmdPlugin(RayPlugin):
    """SPMD over actors (JAX ``RayXlaSpmdPlugin``): the same
    orchestration with ``strategy="spmd"`` by default; pass a
    ``SpmdStrategy(rules=gpt_partition_rules(), axis_sizes=...)``, or
    ``"fsdp"``.  The mesh spans every worker's rank (parallel/mesh.py),
    so a ``tensor`` axis crosses process boundaries: NCCL on the card's
    NVLink, gloo on the CPU (or on one card, ``RLT_ONE_CARD_GLOO=1``).
    The driver gets the trained weights whole (gathered in the
    workers)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("strategy", "spmd")
        super().__init__(*args, **kwargs)


__all__ = ["ONE_CARD_ENV", "RayPlugin", "RaySpmdPlugin", "RayShardedPlugin",
           "one_card"]
