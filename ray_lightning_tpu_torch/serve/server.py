"""The public serving endpoint: ``Server`` — trained weights in,
multi-tenant generation out.

Counterpart of ``ray_lightning_tpu/serve/server.py``: a driver-side
:class:`~ray_lightning_tpu_torch.serve.scheduler.Scheduler` forms
continuous batches over bucketed sequence lengths, and a fleet of
persistent :class:`~ray_lightning_tpu_torch.serve.worker.ServeWorker`
actors (subprocesses of the cluster backend, ``cluster/``) executes
them, each on its own card (``platform="cpu"``: on the CPU), against
its engine's CUDA graphs::

    server = Server(GPTLightningModule("gpt2-small"), num_workers=1,
                    buckets=(128, 256, 512, 1024),
                    max_batch_slots=16).start()
    req = server.submit(prompt_tokens, tenant="alice")
    tokens = req.result(timeout=60)          # np.int32 generated ids
    tokens = server.generate(prompt_tokens)  # submit + wait
    server.shutdown()                        # graceful drain first

Weights come from ``checkpoint=`` (a port ``Trainer`` checkpoint), the
module's ``_trained_state`` from a previous ``fit``, or the seeded init
(built whole on each rank, then cut to its pieces).  ``strategy=`` is
any strategy the training side takes (``"ddp"``, the default,
``"zero1"``, ``"fsdp"``, ``SpmdStrategy`` on ``data`` / ``fsdp`` /
``tensor`` axes with ``gpt_partition_rules()``, parallel/strategy.py),
served as the JAX engine serves it (serve/engine.py): the serving
layout is the training layout, over ``num_workers x
devices_per_worker`` ranks, one card each (``devices_per_worker=2`` is
twice the workers, as for ``RayPlugin``; on the CPU one process a
rank), joined into one process group at ``start``.  The S slots split
over the data shards in contiguous blocks (serve/worker.py); under
``paged=`` a prefix reuse takes its donor from the admitting block
(serve/scheduler.py ``ranks``, the data shards).  A model the JAX
engine cannot serve is refused here before any actor starts, with the
JAX engine's error class: a routed (MoE) GPT, ``ValueError``; a module
with no decode model (``PipelinedGPT``), ``AttributeError``.  A pump
thread plans, broadcasts each plan to every worker, merges the block
leaders' results and applies them; a step that raises, or a worker that
dies, fails every live and queued request, records ``failure_report``
(the cause; ``flight_paths`` stays empty until the flight recorder is
ported) and stops the pump.  With ``kvship=True`` (and ``paged=``) the
server is one end of the fleet's KV-ship plane (serve/fleet/router.py):
``export_kv`` hands out a donor's rows (every head: a tensor group
gathers them), ``import_kv`` adopts shipped ones (each rank its heads),
so servers of different layouts ship to each other.
``compile_cache=`` (compile/cache.py) rides to every serve actor as its
env, and each engine reports the cache in its stats.  The telemetry,
goodput, profile and flight planes are not ported yet: asking for them
raises, naming the ROADMAP.md item.  Prompts and
completions are token-id arrays: tokenization lives with the caller.
"""

from __future__ import annotations

import copy
import logging
import math
import os
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np

from ray_lightning_tpu_torch.cluster.backend import get_backend
from ray_lightning_tpu_torch.cluster.queue import WorkerQueueProxy
from ray_lightning_tpu_torch.compile.cache import CompileCacheConfig
from ray_lightning_tpu_torch.parallel.strategy import resolve_strategy
from ray_lightning_tpu_torch.plugins.ray_ddp import (ONE_CARD_ENV, RayPlugin,
                                                     one_card)
from ray_lightning_tpu_torch.serve.buckets import (bucket_for,
                                                  resolve_buckets)
from ray_lightning_tpu_torch.serve.engine import decode_model_of
from ray_lightning_tpu_torch.serve.fleet.pages import PageConfig
from ray_lightning_tpu_torch.serve.scheduler import Scheduler, ServeRequest
from ray_lightning_tpu_torch.serve.spec import SpecConfig
from ray_lightning_tpu_torch.serve.worker import ServeWorker
from ray_lightning_tpu_torch.util import _drain, process_results

_log = logging.getLogger(__name__)

#: the most ``start()`` waits for the fleet's set-up (spawn, CUDA
#: initialisation, engine build and captures), as the JAX server
START_TIMEOUT_S = 600.0
#: the most one serve step, or a rendezvous or stats call, may take
STEP_TIMEOUT_S = 300.0
CALL_TIMEOUT_S = 120.0


@dataclass
class ServeSpec:
    """Picklable engine configuration shipped to every serve worker;
    ``slots`` is the fleet's, which the ranks split over the strategy's
    data shards."""

    module: Any
    buckets: tuple
    slots: int
    max_seq_len: int
    seed: int
    strategy: Any = None
    paged: Any = None
    spec: Any = None
    #: the KV import programs (``None``: the ``RLT_SERVE_KVSHIP``
    #: worker env decides)
    kvship: Any = None


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"Server({what}) is not ported yet (ROADMAP.md queue 1 item "
        f"{item})")


class Server:
    """Multi-tenant generation endpoint over a trained module."""

    def __init__(
        self,
        module,
        checkpoint: Optional[str] = None,
        *,
        strategy: Any = None,
        buckets: Optional[Sequence[int]] = None,
        max_batch_slots: int = 8,
        num_workers: int = 1,
        platform: Optional[str] = None,
        use_tpu: bool = False,
        devices_per_worker: Optional[int] = None,
        max_seq_len: Optional[int] = None,
        max_new_tokens: int = 32,
        eos_token: Optional[int] = None,
        tenant_quotas: "dict[str, int] | int | None" = None,
        max_prefills_per_step: int = 1,
        seed: int = 0,
        default_root_dir: Optional[str] = None,
        telemetry: Any = None,
        compile_cache: Any = None,
        paged: Any = None,
        spec: Any = None,
        kvship: bool = False,
        worker_env: Optional[dict] = None,
    ):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if use_tpu:
            raise ValueError("use_tpu: the port serves on CUDA cards "
                             "(platform='cuda', the default) or the CPU")
        if platform not in (None, "cuda", "gpu", "cpu"):
            raise ValueError(f"platform must be 'cuda' or 'cpu', got "
                             f"{platform!r}")
        #: "cuda": one card a rank; "cpu": CPU ranks (one torch thread
        #: each)
        self.platform = "cpu" if platform == "cpu" else "cuda"
        if telemetry not in (None, False):
            raise _not_ported("telemetry=...", 13)
        #: the workers' kernel cache (compile/cache.py): its env rides
        #: to every serve actor, whose engine activates it
        self.compile_cache = CompileCacheConfig.resolve(compile_cache)
        if (devices_per_worker or 1) < 1:
            raise ValueError("devices_per_worker must be >= 1")
        self.strategy = resolve_strategy(strategy)
        # a module the JAX engine cannot serve raises its error class
        # here, before any actor starts: the decode model made without
        # storage (a routed GPT: ValueError; none: AttributeError)
        decode_model_of(module, "meta")
        self.module = module
        if max_seq_len is None:
            max_seq_len = getattr(getattr(module, "config", None),
                                  "block_size", None)
            if max_seq_len is None:
                raise ValueError(
                    "pass max_seq_len= (module.config has no block_size)")
        self.max_seq_len = int(max_seq_len)
        self.buckets = resolve_buckets(buckets, self.max_seq_len)
        self.max_batch_slots = int(max_batch_slots)
        self.num_workers = int(num_workers)
        self.devices_per_worker = devices_per_worker
        #: the ranks: one actor (and one card) each
        self.num_ranks = self.num_workers * int(devices_per_worker or 1)
        #: the strategy's mesh over the ranks (the slots must divide by
        #: its data shards: each block serves S / data of them)
        self.mesh_shape = self.strategy.mesh_shape(self.num_ranks,
                                                   self.max_batch_slots)
        self.data_shards = math.prod(self.mesh_shape.get(a, 1) for a in
                                     self.strategy.data_axis_names)
        self.paged = PageConfig.resolve(paged)
        self.spec = SpecConfig.resolve(spec)
        #: the per-bucket KV import programs (fleet KV shipping)
        self.kvship = bool(kvship)
        self.seed = int(seed)
        # default_root_dir holds the telemetry plane's files, not ported
        del default_root_dir
        self.worker_env = dict(worker_env or {})
        self.scheduler = Scheduler(
            self.buckets, self.max_batch_slots, self.max_seq_len,
            quotas=tenant_quotas,
            max_prefills_per_step=max_prefills_per_step,
            default_max_new_tokens=max_new_tokens, eos_token=eos_token,
            paged=self.paged, spec=self.spec, ranks=self.data_shards)
        self._weights = self._resolve_weights(module, checkpoint)
        self._backend = None
        self._workers: list = []
        self._pump: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._work = threading.Event()
        #: held from a plan to its broadcast, and from a KV adoption's
        #: slot choice to its import's broadcast: a worker runs its calls
        #: in arrival order, so an adoption that evicts a donor can never
        #: overwrite it ahead of a planned step that copies from it
        self._dispatch = threading.Lock()
        self._draining = False
        self._started = False
        self._error: Optional[BaseException] = None
        #: postmortem of a mid-serve failure, set by the pump: the cause
        #: and the flight-recorder dumps (``{}`` until the flight
        #: recorder is ported, ROADMAP.md item 13); the fleet router's
        #: failover report links it
        self.failure_report: Optional[dict] = None
        self._setup_info: list = []
        #: ``start()``'s wall seconds by part: spawn (actors up and
        #: rendezvoused), setup (every worker's engine built, captures
        #: included), capture (the slowest worker's captures), total
        self.start_timing: dict = {}
        #: the pump's dispatches and their wall seconds (the broadcast,
        #: the workers' steps and the merge)
        self.pump_stats = {"steps": 0, "step_s": 0.0}

    @staticmethod
    def _resolve_weights(module, checkpoint: Optional[str]):
        """Weights for the fleet, on the host: a port ``Trainer``
        checkpoint's params, a module's ``_trained_state`` from a
        previous ``fit``, or ``None`` (the seeded init)."""
        if checkpoint is not None:
            from ray_lightning_tpu_torch.core.trainer import Trainer
            state = Trainer.load_checkpoint_dict(checkpoint, "cpu")["state"]
            return {**state["params"], **state.get("model_state", {})}
        trained = getattr(module, "_trained_state", None)
        if trained is not None:
            return {k: v.detach().cpu() for k, v in trained.items()}
        return None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Server":
        """Spawn the fleet, rendezvous, build every engine (captured on
        the card), start the pump.  Blocking; returns self."""
        if self._started:
            return self
        if self._stop.is_set():
            raise RuntimeError("this Server was shut down; make a new one")
        t0 = time.monotonic()
        backend = self._backend = get_backend()
        env = self._worker_env_base()
        tag = uuid.uuid4().hex[:8]
        self._workers = [
            backend.create_actor(
                ServeWorker, env=env, resources=self._worker_resources(),
                name=f"rlt-serve-{os.getpid()}-{tag}-{i}")
            for i in range(self.num_ranks)]
        try:
            self._rendezvous()
            t1 = time.monotonic()
            # the module travels without its live model, trainer or
            # trained state: the weights ride beside it, on the host
            shipped = copy.copy(self.module)
            shipped.model = shipped.trainer = None
            shipped._trained_state = None
            spec = ServeSpec(
                module=shipped, buckets=self.buckets,
                slots=self.max_batch_slots, max_seq_len=self.max_seq_len,
                seed=self.seed, strategy=self.strategy, paged=self.paged,
                spec=self.spec, kvship=self.kvship)
            ref = backend.put((spec, self._weights))
            try:
                self._setup_info = process_results(
                    [w.call("setup_serve", ref, i, WorkerQueueProxy())
                     for i, w in enumerate(self._workers)], backend,
                    START_TIMEOUT_S)
            finally:
                backend.free(ref)
        except BaseException:
            self._kill_workers()
            raise
        t2 = time.monotonic()
        self.start_timing = {
            "spawn_s": t1 - t0, "setup_s": t2 - t1,
            "capture_s": max(i["stats"]["capture_ms"]
                             for i in self._setup_info) / 1e3,
            "total_s": t2 - t0}
        info = self._setup_info[0]
        _log.info("serve fleet ready in %.2f s (spawn %.2f, setup %.2f, "
                  "captures %.2f): %d rank(s) on %s, mesh=%s, buckets=%s, "
                  "slots=%d a rank", t2 - t0, t1 - t0, t2 - t1,
                  self.start_timing["capture_s"], self.num_ranks,
                  [i["device"] for i in self._setup_info], info["mesh"],
                  info["buckets"], info["slots"])
        self._started = True
        self._pump = threading.Thread(target=self._pump_loop, daemon=True,
                                      name="rlt-serve-pump")
        self._pump.start()
        return self

    def _worker_env_base(self) -> dict:
        """The workers' environment (plugins/ray_ddp.py's plumbing):
        the ranks' count and platform; CPU workers see no card; under
        ``RLT_ONE_CARD_GLOO=1`` every card rank takes card 0 over
        gloo."""
        env = {"RLT_NUM_PROCESSES": str(self.num_ranks),
               "RLT_PLATFORM": self.platform}
        if self.platform == "cpu":
            env["CUDA_VISIBLE_DEVICES"] = ""
            env["RLT_CPU_THREADS"] = "1"
        if one_card():
            env[ONE_CARD_ENV] = "1"
        if self.kvship:
            env["RLT_SERVE_KVSHIP"] = "1"
        env.update(self.compile_cache.worker_env())
        env.update(self.worker_env)
        return env

    def _worker_resources(self) -> dict:
        res: dict = {"CPU": 1.0}
        if self.platform == "cuda":
            res["GPU"] = 1.0
        return res

    def _rendezvous(self) -> None:
        """Each worker's node and local rank from the node addresses, as
        a fit assigns them (``RayPlugin._assign_local_ranks``), and the
        process group's address (worker 0's, a free port there); a node
        hosting more card workers than cards raises (but on one card
        under ``RLT_ONE_CARD_GLOO=1``)."""
        w0 = self._workers[0]
        addr, port = process_results(
            [w0.call("get_node_ip"), w0.call("get_free_port")],
            self._backend, CALL_TIMEOUT_S)
        info = process_results([w.call("get_node_and_device_info")
                                for w in self._workers], self._backend,
                               CALL_TIMEOUT_S)
        ranks = RayPlugin._assign_local_ranks(info)
        if self.platform == "cuda" and not one_card(
                self._worker_env_base()):
            RayPlugin._check_gpu_fit(info, ranks)
        process_results([w.call("set_env_vars", {
            "MASTER_ADDR": addr, "MASTER_PORT": str(port),
            "LOCAL_RANK": str(ranks[i][1])})
            for i, w in enumerate(self._workers)],
            self._backend, CALL_TIMEOUT_S)

    # -- request surface ---------------------------------------------------

    def submit(self, prompt, tenant: str = "default",
               max_new_tokens: Optional[int] = None,
               ship_kv: bool = False) -> ServeRequest:
        """Enqueue a prompt (token ids); returns a handle whose
        ``result()`` blocks for the generated tokens."""
        if not self._started:
            raise RuntimeError("Server.start() first")
        if self._draining:
            raise RuntimeError("server is draining; no new requests")
        if self._error is not None:
            raise RuntimeError("serve fleet failed") from self._error
        req = self.scheduler.submit(prompt, tenant=tenant,
                                    max_new_tokens=max_new_tokens,
                                    ship_kv=ship_kv)
        self._work.set()
        return req

    def generate(self, prompt, tenant: str = "default",
                 max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = 300.0) -> np.ndarray:
        """Blocking submit-and-wait."""
        return self.submit(prompt, tenant=tenant,
                           max_new_tokens=max_new_tokens).result(timeout)

    # -- KV-page shipping (fleet disaggregation) ---------------------------

    def can_ship_kv(self) -> bool:
        """Both ends of the KV-ship channel need paging (the prefix
        index addresses donor pages) and the kv_import programs."""
        return self._started and self.kvship and self.paged.enabled

    def export_kv(self, prompt_tokens, req_id: "int | None" = None):
        """Donor rows for the fleet's KV-ship leg, both the push path
        (disaggregation ships a just-prefilled request's pages to its
        decode replica) and the pull path (prefix federation fetches a
        retained donor another replica advertised): the longest
        registered prefix of ``prompt_tokens`` on this replica as
        ``(k_rows, v_rows, matched_tokens)`` (CPU tensors in the cache
        dtype, engine ``export_kv``), or ``None`` (no donor: the
        federation caller treats that as a stale directory entry).
        Rows go at bucket granularity (the import programs are one a
        bucket) and the importer registers only the matched whole
        pages, so the bucket's tail never decodes.

        ``req_id`` (a ``submit(ship_kv=True)`` request) claims the rows
        its prefill step piggybacked into the kv outbox, with no worker
        round trip; the donor match below is the fallback."""
        sched = self.scheduler
        if sched.pages is None or not self._started:
            return None
        if req_id is not None:
            boxed = sched.pop_kv_export(int(req_id))
            if boxed is not None:
                return boxed
        prompt_tokens = np.asarray(prompt_tokens,
                                   dtype=np.int32).reshape(-1)
        # match and pin under ONE lock hold: an admission evicting (and
        # re-admitting) the donor between the match and the worker row
        # fetch would ship a DIFFERENT prompt's rows under this
        # prompt's registration
        with sched._lock:
            hit = sched.pages.match(prompt_tokens)
            if hit is None:
                return None
            src, matched = hit
            sched.pages.pin(src)
        try:
            bucket = bucket_for(matched, self.buckets)
            with self._dispatch:
                # in the plans' order on every worker: a tensor group's
                # export is a collective
                futures = [w.call("serve_export_kv", int(src), int(bucket))
                           for w in self._workers]
            results = process_results(futures, self._backend,
                                      CALL_TIMEOUT_S)
            rows = next(r for r in results if r is not None)
            return rows[0], rows[1], int(matched)
        finally:
            with sched._lock:
                sched.pages.unpin(src)

    def can_adopt_kv(self) -> bool:
        """Cheap capacity probe for the router's ship policy: is there a
        slot this replica could host shipped rows in right now (free, or
        reclaimable from an LRU donor)?  Racy by design: a ship admitted
        on a stale yes still fails safe in ``import_kv``."""
        sched = self.scheduler
        if sched.pages is None or not self._started:
            return False
        with sched._lock:
            return (sched.allocator.free_count > 0
                    or sched.pages.donor_count > 0)

    def import_kv(self, prompt_tokens, k_rows, v_rows) -> bool:
        """Adopt shipped donor rows: acquire a donor slot, install the
        rows on the worker that owns it, then register the prefix (the
        order is the soundness story: scheduler ``adopt_commit``).
        False: no adoptable slot (the router falls back to a pooled
        prefill)."""
        prompt_tokens = np.asarray(prompt_tokens,
                                   dtype=np.int32).reshape(-1)
        with self._dispatch:
            slot = self.scheduler.adopt_imported(prompt_tokens)
            if slot is None:
                return False
            futures = [w.call("serve_import_kv", int(slot), k_rows, v_rows)
                       for w in self._workers]
        try:
            process_results(futures, self._backend, CALL_TIMEOUT_S)
        except BaseException:
            self.scheduler.adopt_abort(slot)
            raise
        self.scheduler.adopt_commit(slot, prompt_tokens)
        return True

    def call_ranks(self, fn, *args, timeout: float = STEP_TIMEOUT_S
                   ) -> list:
        """``fn(engine, *args)`` on every rank's engine (serve/worker.py
        ``serve_call``), in the plans' order on each; the results in
        rank order."""
        if not self._started:
            raise RuntimeError("Server.start() first")
        with self._dispatch:
            futures = [w.call("serve_call", fn, *args)
                       for w in self._workers]
        return process_results(futures, self._backend, timeout)

    # -- the pump ----------------------------------------------------------

    def _pump_loop(self) -> None:
        sched = self.scheduler
        while not self._stop.is_set():
            _drain(self._backend, {w.actor_id for w in self._workers})
            with self._dispatch:
                plan = sched.plan()
                if plan is not None:
                    t0 = time.monotonic()
                    futures = [w.call("serve_step", plan)
                               for w in self._workers]
            if plan is None:
                if self._draining and sched.idle():
                    return
                self._work.wait(0.02)
                self._work.clear()
                continue
            try:
                results = process_results(futures, self._backend,
                                          STEP_TIMEOUT_S)
                blocks = [r for r in results if r is not None]
                if len(blocks) != self.data_shards:
                    raise RuntimeError(
                        f"{len(blocks)} serve ranks returned a step "
                        f"result; the mesh has {self.data_shards} blocks")
                merged: dict = {"prefill": {}, "decode": {},
                                "kv_export": {}}
                for r in blocks:       # each block's leader
                    for key in merged:
                        merged[key].update(r.get(key, {}))
                sched.apply(plan, merged)
            except BaseException as e:   # noqa: BLE001 - fleet failure
                _log.error("serve step failed; failing %d live request(s)",
                           sched.active_count + sched.queued_count,
                           exc_info=True)
                self.failure_report = {"cause": repr(e), "flight_paths": {}}
                self._error = e
                sched.fail_all(e)
                return
            self.pump_stats["steps"] += 1
            self.pump_stats["step_s"] += time.monotonic() - t0

    # -- drain / shutdown --------------------------------------------------

    def drain(self, timeout: Optional[float] = 300.0) -> None:
        """Graceful drain: stop admitting, finish every in-flight and
        queued request, stop the pump.  Idempotent."""
        self._draining = True
        self._work.set()
        if self._pump is not None and self._pump.is_alive():
            self._pump.join(timeout)
            if self._pump.is_alive():
                raise TimeoutError(f"drain incomplete after {timeout}s")

    def stats(self) -> dict:
        """The scheduler's stats, each worker's setup facts, ``start()``'s
        seconds by part, the pump's steps and seconds, the failure that
        stopped the pump (if one did) and, while the fleet is up, each
        worker's ``serve_stats`` (the engine's stats: launches, captures
        and recaptures, capture ms, pool bytes)."""
        out = {"scheduler": self.scheduler.stats(),
               "setup": self._setup_info, "start": dict(self.start_timing),
               "pump": dict(self.pump_stats)}
        if self.failure_report is not None:
            out["failure"] = dict(self.failure_report)
        if self._started and self._workers and self._error is None:
            out["workers"] = process_results(
                [w.call("serve_stats") for w in self._workers],
                self._backend, CALL_TIMEOUT_S)
        return out

    def shutdown(self, graceful: bool = True) -> None:
        """Drain (when ``graceful``), stop the pump and the fleet.  The
        process-wide cluster backend stays up (a trainer may share
        it)."""
        if graceful and self._started and self._error is None:
            try:
                self.drain()
            except TimeoutError:
                _log.warning("graceful drain timed out; killing the fleet")
        self._stop.set()
        self._work.set()
        if self._pump is not None and self._pump.is_alive():
            self._pump.join(10)
        if self._started and self._error is None:
            try:
                process_results([w.call("teardown_serve")
                                 for w in self._workers], self._backend, 30)
            except Exception:   # noqa: BLE001 - the actors die next
                _log.warning("serve teardown failed", exc_info=True)
        self._kill_workers()
        self._started = False

    def _kill_workers(self) -> None:
        for w in self._workers:
            w.kill()
        self._workers = []

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown(graceful=exc[0] is None)


__all__ = ["Server", "ServeSpec"]
