"""The fleet front door: :class:`FleetServer` — N serve replicas behind
one ``submit/generate/drain/shutdown`` surface (a port of
``ray_lightning_tpu/serve/fleet/router.py``).

One :class:`~ray_lightning_tpu_torch.serve.server.Server` is exactly one SPMD
fleet; heavy traffic needs many.  ``FleetServer(module, replicas=N)``
holds N independent replicas (each an unmodified ``Server`` placed
through the existing cluster backends) and adds the three fleet
behaviors on the driver:

- **Routing** — least-loaded by (active slots, queue depth), with
  tenant stickiness as the tiebreak inside ``sticky_slack``: a tenant's
  requests keep landing on the replica that already holds its prefix
  pages (serve/fleet/pages.py KV affinity), but never at the price of
  real load imbalance.  With ``fleet={"prefix_fed": True}`` the
  router-resident prefix directory (serve/fleet/federation.py) goes
  first: the replica MEASURED to hold the longest matching prefix wins
  inside the same slack, and a prefix held only on another replica is
  pulled over the KV-ship plane before admission — shared prompts
  prefill once per fleet, not once per replica.  Per-tenant quotas are
  enforced FLEET-WIDE on
  dispatched in-flight requests (the per-replica schedulers run
  unquoted); a tenant at quota parks in the fleet queue without
  head-of-line-blocking other tenants.  With ``fleet={"roles":
  ("prefill", "decode")}`` admissions prefill on the prefill pool and
  their KV pages ship, codec-compressed, to a decode replica
  (disaggregated serving); a ship that fails falls back, per request,
  to a local prefill on the decode replica.

- **Failover** — a replica whose serve pump dies has already failed its
  admitted requests (the cause in ``Server.failure_report``); the
  router re-dispatches every queued-but-unprefilled request to
  survivors (safe: nothing was computed, generation is deterministic)
  and fails only the truly lost in-flight ones with a
  :class:`FleetReplicaLost` whose cause names the death.  The fleet
  then grows a replacement back toward ``min_replicas``.

- **Autoscaling** — the pump feeds queue-depth / TTFT-p99 signals to
  the :class:`~ray_lightning_tpu_torch.serve.fleet.autoscale.Autoscaler`;
  grow spawns a replica in the background, shrink drains one
  gracefully — withdrawn queued requests complete elsewhere, in-flight
  ones finish locally, then the replica shuts down.  Decisions,
  cooldowns and per-event actuation seconds land in ``status()``.

::

    fleet = FleetServer(module, replicas=2, num_workers=1,
                        fleet={"max_replicas": 4}).start()
    req = fleet.submit(prompt_tokens, tenant="alice")
    tokens = req.result(timeout=60)
    fleet.shutdown()

Replicas take ``Server``'s keyword arguments: on the card by default,
``platform="cpu"`` for CPU workers.  The router, the codecs and the
KV-ship mailbox run in the driver on CPU tensors, so a fleet never
initialises CUDA in the driver.  The telemetry plane (``telemetry=``,
``/metrics``, the aggregator's events), goodput and flight dumps are
not ported yet (ROADMAP.md queue 1 item 13): ``telemetry=`` raises and
``goodput_stats()`` is ``None``.  Chaos: ``arm_kvship_drop(n)``, or an
``RLT_FAULT`` ``peerdrop`` spec (elastic/faults.py), drops the next n
KV ships.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.cluster.peer import (Mailbox, PeerTimeout,
                                                  _retry_policy)
from ray_lightning_tpu_torch.comm.quant import (dequantize_blob,
                                                quantize_blob)
from ray_lightning_tpu_torch.serve.fleet.autoscale import Autoscaler
from ray_lightning_tpu_torch.serve.fleet.config import FleetConfig
from ray_lightning_tpu_torch.serve.fleet.pages import PageConfig, _prefix_hash
from ray_lightning_tpu_torch.serve.fleet.replica import FleetReplica
from ray_lightning_tpu_torch.telemetry import metrics as _metrics

_log = logging.getLogger(__name__)


def pick_replica(rows: "list[dict]", sticky_rid: Optional[int] = None,
                 sticky_slack: int = 1,
                 pool: Optional[str] = None,
                 spill: bool = False,
                 affinity: "Optional[dict]" = None) -> Optional[int]:
    """Routing policy (pure: the tests drive it directly).

    ``rows``: one ``{"rid", "active", "queued", "slots"[, "role"]}``
    per routable replica.  Least-loaded wins: fewest active slots, then
    shortest queue, then lowest id (deterministic).  The tenant's
    sticky replica overrides the winner only while its load is within
    ``sticky_slack`` of the winner on BOTH axes — KV affinity must
    never hide a hot replica.

    ``affinity`` (prefix federation): ``{rid: matched_prefix_tokens}``
    from the fleet directory — the replica already holding the LONGEST
    matching prefix beats least-loaded (and beats stickiness: measured
    pages outrank a routing habit), under the SAME slack discipline:
    a prefix hit never justifies routing onto a hot replica, because
    past the slack the pages can be fetched instead (the federation's
    whole point).

    ``pool`` restricts routing to one disaggregation role ("prefill" /
    "decode"); when NO row carries that role the filter falls back to
    every row — a role pool that emptied (shrink, failover) degrades
    to pooled routing instead of stranding requests.

    ``spill`` (pooled decode-pool traffic only): when the pool's best
    replica is saturated (every slot live AND a queue behind it), a
    fully-idle replica OUTSIDE the pool joins the candidates — after a
    prefill burst drains, the dedicated prefill replica absorbs pooled
    work instead of idling while the decode pool grinds its backlog.
    """
    if not rows:
        return None
    if pool is not None:
        pooled = [r for r in rows if r.get("role", "pooled") == pool]
        if pooled:
            if spill:
                best = min(pooled, key=lambda r: (
                    r["active"], r["queued"], r["rid"]))
                if best["active"] >= best["slots"] and best["queued"]:
                    pooled = pooled + [
                        r for r in rows if r not in pooled
                        and r["active"] == 0 and r["queued"] == 0]
            rows = pooled
    best = min(rows, key=lambda r: (r["active"], r["queued"], r["rid"]))
    if affinity:
        near = [r for r in rows
                if affinity.get(r["rid"], 0) > 0
                and r["active"] <= best["active"] + sticky_slack
                and r["queued"] <= best["queued"] + sticky_slack]
        if near:
            return max(near, key=lambda r: (affinity[r["rid"]],
                                            -r["rid"]))["rid"]
    if sticky_rid is not None and sticky_rid != best["rid"]:
        for r in rows:
            if r["rid"] == sticky_rid \
                    and r["active"] <= best["active"] + sticky_slack \
                    and r["queued"] <= best["queued"] + sticky_slack:
                return r["rid"]
    return best["rid"]


class FleetReplicaLost(RuntimeError):
    """An in-flight request died with its replica; its ``__cause__`` is
    the replica's failure, and ``flight_paths`` the per-rank
    flight-recorder dumps (empty until the flight recorder is
    ported)."""

    def __init__(self, message: str, flight_paths: Optional[dict] = None):
        super().__init__(message)
        self.flight_paths = dict(flight_paths or {})


class FleetRequest:
    """Driver-side handle on one fleet request.  Mirrors
    :class:`~ray_lightning_tpu_torch.serve.scheduler.ServeRequest`'s surface
    (``done()`` / ``result(timeout)``) but survives replica failover:
    the inner per-replica request may be replaced any number of times
    before the fleet-level outcome settles."""

    def __init__(self, fid: int, prompt: np.ndarray, tenant: str,
                 max_new_tokens: Optional[int]):
        self.id = fid
        self.prompt = prompt
        self.tenant = tenant
        self.max_new_tokens = max_new_tokens
        #: current per-replica request (None while parked in the fleet
        #: queue) and the replica it was dispatched to
        self.inner = None
        self.replica: Optional[int] = None
        self.requeues = 0
        self.t_submit = time.monotonic()
        self.t_done: Optional[float] = None
        #: fleet-level TTFT: submit-at-the-front-door to first token,
        #: fleet queueing included (the autoscaler's grow signal)
        self.ttft_s: Optional[float] = None
        self.tpot_s: Optional[float] = None
        self.error: Optional[BaseException] = None
        self._tokens: Optional[np.ndarray] = None
        #: disaggregation state (router-owned): ``{"stage": "prefill"}``
        #: while the prefill leg runs, then ``{"stage": "decode",
        #: "head": [t1], "shipped": bool}`` on the decode leg; the head
        #: tokens prepend to the decode leg's stream at completion
        self._disagg: Optional[dict] = None
        self._event = threading.Event()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"fleet request {self.id} not complete after {timeout}s")
        if self.error is not None:
            raise self.error
        return self._tokens


class FleetServer:
    """Front-door router over N serve replicas with signal-driven
    autoscaling (module docstring)."""

    def __init__(
        self,
        module,
        *,
        replicas: Optional[int] = None,
        fleet: Any = None,
        autoscale: bool = True,
        tenant_quotas: "dict[str, int] | int | None" = None,
        paged: Any = True,
        telemetry: Any = None,
        default_root_dir: Optional[str] = None,
        replica_factory: Optional[Callable[[int], Any]] = None,
        **server_kwargs,
    ):
        if telemetry not in (None, False):
            raise NotImplementedError(
                "FleetServer(telemetry=...) is not ported yet (ROADMAP.md "
                "queue 1 item 13)")
        cfg = FleetConfig.resolve(fleet)
        initial = int(replicas) if replicas is not None \
            else cfg.min_replicas
        if initial < 1:
            raise ValueError("replicas must be >= 1")
        if not autoscale:
            cfg = dataclasses.replace(cfg, min_replicas=initial,
                                      max_replicas=initial)
        else:
            if initial > cfg.max_replicas:
                cfg = dataclasses.replace(cfg, max_replicas=initial)
            if initial < cfg.min_replicas:
                cfg = dataclasses.replace(cfg, min_replicas=initial)
        self.cfg = cfg
        self.initial_replicas = initial
        self.module = module
        self.paged = PageConfig.resolve(paged)
        self._default_quota: Optional[int] = (
            int(tenant_quotas) if isinstance(tenant_quotas, int) else None)
        self._quotas: dict[str, int] = (
            dict(tenant_quotas) if isinstance(tenant_quotas, dict) else {})
        self.default_root_dir = default_root_dir or os.path.join(
            os.getcwd(), "rlt_fleet")
        server_kwargs.pop("tenant_quotas", None)   # fleet-enforced
        self._server_kwargs = server_kwargs
        self._factory = replica_factory or self._default_factory
        self.autoscaler = Autoscaler(cfg)
        self._replicas: dict[int, FleetReplica] = {}
        self._rid = 0
        self._pending: deque[FleetRequest] = deque()
        self._inflight: dict[int, FleetRequest] = {}
        self._tenant_inflight: dict[str, int] = {}
        self._sticky: dict[str, int] = {}
        self._fid = 0
        self._lock = threading.RLock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._pump: Optional[threading.Thread] = None
        self._scale_threads: list[threading.Thread] = []
        self._last_tick = 0.0
        self._ttfts: deque[float] = deque(maxlen=128)
        self._draining = False
        self._started = False
        #: failover log: replica, cause, flight paths, requeued/failed
        self.failovers: list[dict] = []
        #: prefix-reuse counters folded in from removed replicas, so a
        #: shrink doesn't erase the fleet's reuse evidence
        self._retired_pages = {"prefill_tokens_requested": 0,
                               "prefill_tokens_computed": 0,
                               "prefix_hits": 0, "reused_prefills": 0,
                               "remote_imports": 0,
                               "federated_tokens_reused": 0}
        self.completed = 0
        self.failed = 0
        self.requeued = 0
        #: KV-ship channel (disaggregated decode): the router is both
        #: ends' driver, so one Mailbox IS the peer channel — puts can
        #: be chaos-dropped (arm_kvship_drop) and takes retry/backoff
        #: per RLT_PEER_RETRIES
        self._kvship_mailbox = Mailbox()
        self._kvship_drop = 0
        self._kvship_seconds = 0.0
        #: ships run OFF the router pump (a ship is two worker RPCs
        #: plus the codec; inline it would stall every other request's
        #: dispatch — the exact TTFT the disaggregation exists to win)
        self._kvship_pool = None
        self.kvship = {"codec": cfg.kvship_codec, "ships": 0,
                       "bytes_wire": 0, "bytes_raw": 0, "retries": 0,
                       "failovers": 0, "skipped": 0}
        #: one record a ship attempt: reason, fleet request, bucket (the
        #: rows' length), status, wall ms, wire and raw bytes
        self.ship_log: list[dict] = []
        #: prefix federation (serve/fleet/federation.py): the router-
        #: resident directory every replica's PagedKV advertises donor
        #: retentions to; a directory hit for a prefix the admitting
        #: replica lacks pulls the pages over the SAME kvship plane
        #: (shared counters, reason="federation" on the metrics)
        self.directory = None
        if cfg.prefix_fed and self.paged.enabled:
            from ray_lightning_tpu_torch.serve.fleet.federation import \
                PrefixDirectory
            self.directory = PrefixDirectory(
                self.paged.page_size, ttl_s=cfg.prefix_fed_ttl_s)
        self._kvfed_seconds = 0.0
        #: in-flight federated fetches, keyed (target rid, prefix hash)
        #: — the capacity gate AND the dedupe (N queued requests with
        #: one shared prefix must not fetch it N times)
        self._fed_inflight: set = set()
        self.federation = {"codec": cfg.kvship_codec, "hits": 0,
                           "fetches": 0, "ships": 0, "bytes_wire": 0,
                           "bytes_raw": 0, "retries": 0, "failovers": 0,
                           "skipped": 0}
        # chaos: an RLT_FAULT peerdrop spec arms the router's KV-ship
        # mailbox as it arms the worker-to-worker peer channel
        # (elastic/faults.py); serve workers install no training fault
        # injector, so the spec is unambiguous here
        raw_fault = os.environ.get("RLT_FAULT", "").strip()
        if raw_fault and "peerdrop" in raw_fault \
                and (cfg.roles or self.directory is not None):
            from ray_lightning_tpu_torch.elastic.faults import parse_faults
            for spec in parse_faults(raw_fault):
                if spec.kind == "peerdrop":
                    self._kvship_drop += spec.count

    # -- construction ------------------------------------------------------

    def _default_factory(self, rid: int):
        """An unmodified :class:`Server` per replica: same module, same
        config, its own worker actors via the cluster backends.  The
        fleet's env knobs (RLT_FLEET*, RLT_SERVE_PAGED*) round-trip
        into every replica's worker actors."""
        from ray_lightning_tpu_torch.serve.server import Server
        kw = dict(self._server_kwargs)
        worker_env = {**self.cfg.worker_env(),
                      **kw.pop("worker_env", {})}
        if self.cfg.role_for(rid) == "prefill" \
                and "max_prefills_per_step" not in kw:
            # a dedicated prefill replica never interleaves decode
            # tails, so it batches admissions to its slot count — the
            # admission-throughput half of the disaggregation win (a
            # pooled replica admitting this greedily would stall its
            # live decodes' TPOT every step)
            kw["max_prefills_per_step"] = kw.get("max_batch_slots", 8)
        return Server(
            self.module,
            tenant_quotas=None,
            paged=self.paged,
            # roles or federation configured → every replica can
            # ship/receive KV pages (the per-bucket import programs
            # are cheap and a failback-to-pooled replica may still
            # receive a ship or a federated fetch)
            kvship=(bool(self.cfg.roles) or self.directory is not None)
            and self.paged.enabled,
            default_root_dir=os.path.join(self.default_root_dir,
                                          f"replica_{rid}"),
            worker_env=worker_env,
            **kw)

    def _new_replica(self) -> FleetReplica:
        with self._lock:
            rid = self._rid
            self._rid += 1
            rep = FleetReplica(rid, self._factory(rid),
                               role=self.cfg.role_for(rid))
            self._replicas[rid] = rep
        if self.directory is not None:
            pages = getattr(rep.server.scheduler, "pages", None)
            if pages is not None:
                pages.bind_federation(rid, self.directory)
        return rep

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FleetServer":
        """Spawn the initial replicas (concurrently — each is its own
        actor fleet), start the router pump.  Blocking; returns self."""
        if self._started:
            return self
        reps = [self._new_replica() for _ in range(self.initial_replicas)]
        errors: list[BaseException] = []

        def boot(rep):
            try:
                rep.start()
            except BaseException as e:   # noqa: BLE001 - surfaced below
                errors.append(e)

        threads = [threading.Thread(target=boot, args=(rep,),
                                    name=f"rlt-fleet-boot-{rep.id}",
                                    daemon=True) for rep in reps]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            for rep in reps:
                try:
                    rep.shutdown(graceful=False)
                except Exception:
                    pass
            raise errors[0]
        self._started = True
        self._pump = threading.Thread(target=self._pump_loop, daemon=True,
                                      name="rlt-fleet-router")
        self._pump.start()
        _log.info("fleet ready: %d replica(s), autoscale [%d, %d]",
                  len(reps), self.cfg.min_replicas, self.cfg.max_replicas)
        return self

    # -- request surface ---------------------------------------------------

    def submit(self, prompt, tenant: str = "default",
               max_new_tokens: Optional[int] = None) -> FleetRequest:
        """Enqueue a prompt at the front door; the router dispatches it
        to the best replica (possibly after a failover or a grow)."""
        if not self._started:
            raise RuntimeError("FleetServer.start() first")
        if self._draining:
            raise RuntimeError("fleet is draining; no new requests")
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        with self._lock:
            fr = FleetRequest(self._fid, prompt, tenant, max_new_tokens)
            self._fid += 1
            self._pending.append(fr)
        self._wake.set()
        return fr

    def generate(self, prompt, tenant: str = "default",
                 max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = 300.0) -> np.ndarray:
        """Blocking submit-and-wait."""
        return self.submit(prompt, tenant=tenant,
                           max_new_tokens=max_new_tokens).result(timeout)

    # -- the router pump ---------------------------------------------------

    def _pump_loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(0.01)
            self._wake.clear()
            try:
                self._poll_completions()
                self._scan_failures()
                self._dispatch_pending()
                self._tick_autoscaler()
            except Exception:
                _log.error("fleet router pump error", exc_info=True)
                time.sleep(0.05)

    def _routable(self) -> "list[FleetReplica]":
        return [r for r in self._replicas.values() if r.routable]

    def _quota_of(self, tenant: str) -> Optional[int]:
        return self._quotas.get(tenant, self._default_quota)

    def _poll_completions(self) -> None:
        with self._lock:
            inflight = list(self._inflight.values())
        for fr in inflight:
            inner = fr.inner
            if inner is None or not inner.done():
                continue
            if inner.error is None:
                stage = (fr._disagg.get("stage")
                         if fr._disagg is not None else None)
                if stage == "prefill":
                    # hand the ship to the kvship pool; the pump keeps
                    # dispatching while the pages travel
                    fr._disagg["stage"] = "shipping"
                    self._kvship_executor().submit(
                        self._advance_disagg_task, fr)
                elif stage == "shipping":
                    continue     # leg 1 done, ship in flight
                else:
                    self._finish_ok(fr)
            else:
                rep = self._replicas.get(fr.replica)
                if rep is not None and rep.failed:
                    continue   # the failover scan routes this one
                self._finish_failed(fr, inner.error)

    def _finish_ok(self, fr: FleetRequest) -> None:
        inner = fr.inner
        toks = list(inner.generated)
        if fr._disagg is not None:
            # the prefill leg's token(s) lead the decode leg's stream
            toks = list(fr._disagg.get("head", ())) + toks
        fr._tokens = np.asarray(toks, dtype=np.int32)
        fr.t_done = time.monotonic()
        if fr.ttft_s is None and inner.t_first is not None:
            # disaggregated requests stamped TTFT at the prefill leg
            fr.ttft_s = inner.t_first - fr.t_submit
            self._ttfts.append(fr.ttft_s)
        fr.tpot_s = inner.tpot_s
        with self._lock:
            self._inflight.pop(fr.id, None)
            self._tenant_inflight[fr.tenant] = max(
                0, self._tenant_inflight.get(fr.tenant, 1) - 1)
            self.completed += 1
        fr._event.set()
        self._count("rlt_fleet_requests_total", 1, status="ok",
                    tenant=fr.tenant)

    def _finish_failed(self, fr: FleetRequest,
                       error: BaseException) -> None:
        fr.error = error
        fr.t_done = time.monotonic()
        with self._lock:
            self._inflight.pop(fr.id, None)
            self._tenant_inflight[fr.tenant] = max(
                0, self._tenant_inflight.get(fr.tenant, 1) - 1)
            self.failed += 1
        fr._event.set()
        self._count("rlt_fleet_requests_total", 1, status="failed",
                    tenant=fr.tenant)

    def _requeue(self, fr: FleetRequest) -> None:
        with self._lock:
            self._inflight.pop(fr.id, None)
            self._tenant_inflight[fr.tenant] = max(
                0, self._tenant_inflight.get(fr.tenant, 1) - 1)
            fr.inner = None
            fr.replica = None
            fr._disagg = None    # a redispatch restarts from scratch
            fr.requeues += 1
            self._pending.appendleft(fr)
            self.requeued += 1
        self._count("rlt_fleet_requests_total", 1, status="requeued",
                    tenant=fr.tenant)

    def _scan_failures(self) -> None:
        for rep in list(self._replicas.values()):
            if rep.failed and rep.state != "dead":
                self._handle_failover(rep)

    def _handle_failover(self, rep: FleetReplica) -> None:
        """A replica's serve pump died mid-serve.  Its scheduler has
        already failed every admitted request (its cause in
        ``failure_report``);
        queued-but-unprefilled ones are re-dispatched to survivors —
        nothing was computed for them, and greedy generation is
        deterministic, so a replay is the same answer."""
        rep.mark_dead()
        error = rep.server._error
        report = getattr(rep.server, "failure_report", None) or {}
        flight_paths = report.get("flight_paths", {})
        requeued = failed = 0
        with self._lock:
            mine = [fr for fr in self._inflight.values()
                    if fr.replica == rep.id]
        for fr in mine:
            inner = fr.inner
            if inner is not None and inner.t_admit is None:
                self._requeue(fr)
                requeued += 1
            else:
                lost = FleetReplicaLost(
                    f"replica {rep.id} lost request in flight: "
                    f"{error!r} (flight dumps: "
                    f"{sorted(flight_paths.values())})",
                    flight_paths=flight_paths)
                lost.__cause__ = error
                self._finish_failed(fr, lost)
                failed += 1
        event = {"replica": rep.id, "cause": repr(error),
                 "flight_paths": dict(flight_paths),
                 "requeued": requeued, "failed": failed,
                 "at": time.time()}
        self.failovers.append(event)
        self._count("rlt_fleet_failover_total", 1)
        _log.error("fleet failover: replica %d dead (%r); %d requeued, "
                   "%d lost; flight dumps: %s", rep.id, error, requeued,
                   failed, sorted(flight_paths.values()))
        self._reap_async(rep)
        with self._lock:
            capacity = sum(1 for r in self._replicas.values()
                           if r.state in ("starting", "serving"))
        if capacity < self.cfg.min_replicas:
            self._spawn_async("failover replacement", autoscaled=False)
        self._wake.set()

    def _fold_pages(self, rep: FleetReplica) -> None:
        """Preserve a departing replica's prefix-reuse counters (and
        drop its directory advertisements — a dead donor must stop
        attracting fetches)."""
        if self.directory is not None:
            self.directory.invalidate_replica(rep.id)
        pages = getattr(rep.server.scheduler, "pages", None)
        if pages is None:
            return
        st = pages.stats()
        with self._lock:
            for key in self._retired_pages:
                self._retired_pages[key] += st.get(key, 0)

    def _reap_async(self, rep: FleetReplica) -> None:
        def reap():
            try:
                rep.shutdown(graceful=False)
            except Exception:
                pass
            self._fold_pages(rep)
            with self._lock:
                self._replicas.pop(rep.id, None)
        t = threading.Thread(target=reap, daemon=True,
                             name=f"rlt-fleet-reap-{rep.id}")
        t.start()
        self._scale_threads.append(t)

    def _dispatch_pending(self) -> None:
        with self._lock:
            if not self._pending:
                return
            routable = self._routable()
            if not routable:
                return
            rows = {rep.id: rep.load_row() for rep in routable}
            reps = {rep.id: rep for rep in routable}
            for fr in list(self._pending):
                quota = self._quota_of(fr.tenant)
                if quota is not None and \
                        self._tenant_inflight.get(fr.tenant, 0) >= quota:
                    continue   # tenant at fleet-wide quota; others pass
                disagg = self._disagg_eligible(fr, reps)
                # prefix-affinity routing: the directory knows which
                # replica already holds the longest matching prefix —
                # land there when its load allows, fetch otherwise
                aff = None
                if self.directory is not None \
                        and len(fr.prompt) >= self.paged.page_size:
                    aff = self.directory.affinity(fr.prompt)
                if disagg:
                    # disaggregated: the prefill pool computes the
                    # prompt (ONE token), its KV pages ship, a decode
                    # replica finishes the request (_advance_disagg)
                    rid = pick_replica(list(rows.values()),
                                       None, 0, pool="prefill",
                                       affinity=aff)
                else:
                    # with roles configured, pooled traffic routes to
                    # the DECODE pool: a full request parked on a
                    # prefill replica would hold one of its slots for
                    # a whole decode tail, stalling every disagg
                    # admission behind it (pick_replica fails back to
                    # all rows when the pool empties)
                    rid = pick_replica(list(rows.values()),
                                       self._sticky.get(fr.tenant),
                                       self.cfg.sticky_slack,
                                       pool="decode" if self.cfg.roles
                                       else None,
                                       spill=bool(self.cfg.roles),
                                       affinity=aff)
                if rid is None:
                    break
                rep = reps[rid]
                fetch = self._plan_fed_fetch(fr, rid, aff)
                if fetch is not None:
                    # a replica OTHER than the routed one holds a
                    # longer prefix: pull the pages first (off-pump,
                    # capacity-gated), then submit — the admission
                    # lands on freshly-installed donor rows and
                    # prefills only the suffix
                    self._pending.remove(fr)
                    self._inflight[fr.id] = fr
                    self._tenant_inflight[fr.tenant] = \
                        self._tenant_inflight.get(fr.tenant, 0) + 1
                    if not disagg:
                        self._sticky[fr.tenant] = rid
                    self._fed_inflight.add(fetch[3])
                    self._kvship_executor().submit(
                        self._fed_fetch_task, fr, fetch, rid, disagg)
                    rows[rid]["queued"] += 1
                    continue
                try:
                    if disagg:
                        # piggyback the KV export only when the decode
                        # pool could actually adopt it right now — a
                        # doomed export still costs the prefill lane a
                        # device fetch per admission (ship_kv=False
                        # legs fall back to the donor-match export,
                        # opportunistically)
                        ship = any(
                            r.role == "decode"
                            and hasattr(r.server, "can_adopt_kv")
                            and r.server.can_adopt_kv()
                            for r in reps.values())
                        inner = rep.server.submit(
                            fr.prompt, tenant=fr.tenant,
                            max_new_tokens=1, ship_kv=ship)
                    else:
                        inner = rep.server.submit(
                            fr.prompt, tenant=fr.tenant,
                            max_new_tokens=fr.max_new_tokens)
                except Exception:
                    # replica refused (failed/draining between probe
                    # and submit); the failure scan sorts it out
                    rows.pop(rid, None)
                    reps.pop(rid, None)
                    if not rows:
                        break
                    continue
                self._pending.remove(fr)
                fr.inner = inner
                fr.replica = rid
                fr._disagg = {"stage": "prefill"} if disagg else None
                self._inflight[fr.id] = fr
                self._tenant_inflight[fr.tenant] = \
                    self._tenant_inflight.get(fr.tenant, 0) + 1
                if not disagg:
                    self._sticky[fr.tenant] = rid
                rows[rid]["queued"] += 1   # count our own dispatches

    # -- disaggregated decode (prefill pool → KV ship → decode pool) -------

    def _disagg_eligible(self, fr: FleetRequest,
                         reps: "dict[int, FleetReplica]") -> bool:
        """Disaggregate this request?  Needs BOTH dedicated pools
        routable (a pool that emptied fails back to pooled routing),
        shippable replicas (paging + kv_import programs on both ends),
        a prompt long enough to own at least one whole page, room in
        the buckets for the decode leg's prompt+first-token resubmit,
        and more than one token wanted (a 1-token request IS its
        prefill leg)."""
        prefills = [r for r in reps.values() if r.role == "prefill"]
        decodes = [r for r in reps.values() if r.role == "decode"]
        if not prefills or not decodes:
            return False
        if not all(r.server.can_ship_kv() for r in prefills + decodes):
            return False
        if fr.max_new_tokens is not None and fr.max_new_tokens <= 1:
            return False
        buckets = prefills[0].server.buckets
        if len(fr.prompt) + 1 > max(buckets):
            return False
        return len(fr.prompt) >= self.paged.page_size

    def _kvship_executor(self):
        with self._lock:
            if self._kvship_pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._kvship_pool = ThreadPoolExecutor(
                    max_workers=2, thread_name_prefix="rlt-kvship")
            return self._kvship_pool

    def _advance_disagg_task(self, fr: FleetRequest) -> None:
        """Pool-thread wrapper: a ship/advance that dies for any reason
        requeues the request (a redispatch restarts it from scratch,
        pooled if the pools vanished meanwhile)."""
        try:
            self._advance_disagg(fr)
        except Exception:
            _log.error("disagg advance failed; requeueing fleet "
                       "request %d", fr.id, exc_info=True)
            self._requeue(fr)
        finally:
            self._wake.set()

    def _advance_disagg(self, fr: FleetRequest) -> None:
        """The prefill leg finished (one token): ship its KV pages to
        a decode replica and submit the decode leg there.  A ship that
        times out (chaos drop, dead peer) fails over PER-REQUEST: the
        decode replica simply prefills the prompt itself (pooled mode)
        — deterministic greedy makes the answer identical, only the
        prefill compute is paid twice."""
        leg1 = fr.inner
        t1 = int(leg1.generated[-1])
        if fr.ttft_s is None and leg1.t_first is not None:
            # fleet TTFT = the PREFILL leg's first token — the number
            # the disaggregated fleet's TTFT against pooled serving
            fr.ttft_s = leg1.t_first - fr.t_submit
            self._ttfts.append(fr.ttft_s)
        want = fr.max_new_tokens
        if want is None:
            # pin the effective budget so leg-2 doesn't re-apply the
            # full per-replica default on top of the prefill token
            src0 = self._replicas.get(fr.replica)
            want = src0.server.scheduler.default_max_new_tokens \
                if src0 is not None else 32
        hit_eos = (leg1.eos_token is not None
                   and t1 == leg1.eos_token)
        if hit_eos or (want is not None and want <= 1):
            fr._disagg = {"stage": "done", "head": []}
            self._finish_ok(fr)
            return
        with self._lock:
            routable = {rep.id: rep for rep in self._routable()}
        rows = [rep.load_row() for rep in routable.values()]
        rid = pick_replica(rows, None, 0, pool="decode")
        rep = routable.get(rid) if rid is not None else None
        if rep is None:
            self._requeue(fr)       # decode pool AND failback empty
            return
        src = self._replicas.get(fr.replica)
        shipped = False
        if src is not None:
            shipped = self._ship_kv(
                src, rep, fr.prompt, fr.id,
                req_id=getattr(fr.inner, "id", None)) == "ok"
        prompt2 = np.concatenate(
            [fr.prompt, np.asarray([t1], dtype=np.int32)])
        remaining = None if want is None else want - 1
        try:
            inner2 = rep.server.submit(prompt2, tenant=fr.tenant,
                                       max_new_tokens=remaining)
        except Exception:
            self._requeue(fr)
            return
        with self._lock:
            fr.inner = inner2
            fr.replica = rep.id
            fr._disagg = {"stage": "decode", "head": [t1],
                          "shipped": shipped}

    def _ship_kv(self, src: FleetReplica, dst: FleetReplica,
                 prompt: np.ndarray, fid: int,
                 req_id: Optional[int] = None,
                 reason: str = "disagg") -> str:
        """One KV-page ship over the peer channel: export the donor
        rows from ``src``, codec-compress them onto the mailbox, take
        with retry/backoff (RLT_PEER_RETRIES), decode and install on
        ``dst``.  Returns a status string — ``"ok"`` (installed),
        ``"stale"`` (the donor vanished between lookup and export:
        federation invalidates the directory entry), ``"busy"`` (no
        adoptable slot on ``dst``), ``"timeout"`` (wire chaos / dead
        peer), ``"error"``.  Anything but ``"ok"`` means the consumer
        prefills for itself (per-request local failover); bookkeeping
        lands in ``self.kvship`` for the disagg push path or
        ``self.federation`` for the pull path, its wall seconds in the
        matching total, and every attempt in ``ship_log``."""
        t0 = time.monotonic()
        codec = self.cfg.kvship_codec
        stats = self.kvship if reason == "disagg" else self.federation
        bucket = status = None
        wire_b = raw_b = 0
        try:
            # a disagg leg-1 prefill piggybacked its rows into the
            # prefill replica's kv outbox (claimed by req_id) — no
            # worker round-trip; federation pulls fall through to the
            # pin-under-lock donor-match export
            exported = src.server.export_kv(prompt, req_id=req_id)
            if exported is not None:
                bucket = int(exported[0].shape[2])
            if exported is None:
                stats["skipped"] += 1
                status = "stale"
                return "stale"
            if hasattr(dst.server, "can_adopt_kv") \
                    and not dst.server.can_adopt_kv():
                # every destination slot is live: the install would
                # fail after paying quantize + mailbox + a worker
                # round-trip — skip up front and let the consumer
                # prefill for itself (same fallback, none of the cost)
                stats["skipped"] += 1
                status = "busy"
                return "busy"
            k_rows, v_rows, matched = exported
            # CPU tensors in the cache dtype (numpy has no bfloat16)
            k_rows, v_rows = torch.as_tensor(k_rows), torch.as_tensor(v_rows)
            kp, ks = quantize_blob(k_rows, codec)
            vp, vs = quantize_blob(v_rows, codec)
            payload = {
                "k": (kp, ks), "v": (vp, vs),
                "shape": tuple(k_rows.shape), "dtype": k_rows.dtype,
                "codec": codec,
                "tokens": np.asarray(prompt[:matched], dtype=np.int32),
            }
            wire = sum(a.nbytes for pair in (payload["k"], payload["v"])
                       for a in pair if a is not None)
            raw = 2 * k_rows.numel() * 4   # fp32 baseline
            tag = ("kvship", reason, int(fid))
            with self._lock:
                drop = self._kvship_drop > 0
                if drop:
                    self._kvship_drop -= 1
            if not drop:
                self._kvship_mailbox.put(tag, payload)
            else:
                _log.warning("kvship chaos: dropping ship for fleet "
                             "request %d", fid)
            try:
                got = self._kvship_mailbox.take(
                    tag, timeout=self._kvship_timeout(),
                    who=f"decode replica {dst.id}",
                    src=f"prefill replica {src.id}")
            except PeerTimeout as e:
                retries, _ = _retry_policy()
                stats["retries"] += retries
                stats["failovers"] += 1
                self._count("rlt_kvship_retries_total", max(1, retries),
                            reason=reason)
                self._count("rlt_kvship_failovers_total", 1,
                            reason=reason)
                _log.warning("kvship failover for fleet request %d: %s",
                             fid, e)
                status = "timeout"
                return "timeout"
            # decoded into the export's dtype: the worker's pickle never
            # carries fp32 rows (raw rows decode exactly)
            k2 = dequantize_blob(got["k"][0], got["k"][1],
                                 got["codec"], got["shape"],
                                 dtype=got["dtype"])
            v2 = dequantize_blob(got["v"][0], got["v"][1],
                                 got["codec"], got["shape"],
                                 dtype=got["dtype"])
            if not dst.server.import_kv(got["tokens"], k2, v2):
                stats["skipped"] += 1
                status = "busy"
                return "busy"
            stats["ships"] += 1
            stats["bytes_wire"] += wire
            stats["bytes_raw"] += raw
            self._count("rlt_kvship_ships_total", 1, codec=codec,
                        reason=reason)
            # wire vs raw as separate label series: the live fp8
            # compression ratio is wire/raw straight off /metrics
            self._count("rlt_kvship_bytes_total", wire, codec=codec,
                        reason=reason, kind="wire")
            self._count("rlt_kvship_bytes_total", raw, codec=codec,
                        reason=reason, kind="raw")
            status, wire_b, raw_b = "ok", wire, raw
            return "ok"
        except Exception:
            _log.warning("kvship failed; consumer prefills locally",
                         exc_info=True)
            stats["failovers"] += 1
            self._count("rlt_kvship_failovers_total", 1, reason=reason)
            status = "error"
            return "error"
        finally:
            dt = time.monotonic() - t0
            with self._lock:
                if reason == "disagg":
                    self._kvship_seconds += dt
                else:
                    self._kvfed_seconds += dt
                self.ship_log.append({
                    "reason": reason, "fid": int(fid), "bucket": bucket,
                    "status": status, "ms": dt * 1e3, "wire": wire_b,
                    "raw": raw_b})

    # -- prefix federation (directory hit → pull over the kvship plane) ----

    def _plan_fed_fetch(self, fr: FleetRequest, rid: int,
                        aff: "Optional[dict]"):
        """Should this admission pull its prefix from another replica
        before submitting?  Called under ``self._lock`` from the
        dispatch loop.  Returns ``(donor_rid, donor_slot, matched,
        inflight_key)`` or ``None`` (= submit normally and prefill
        locally).  A plan commits only when the donor beats what the
        routed replica already holds, both ends can ship, and the
        fetch fits the ``prefix_fed_fetches`` capacity gate — a hit
        past the gate degrades to local prefill, never queues behind
        the wire."""
        if self.directory is None or not aff:
            return None
        dst = self._replicas.get(rid)
        if dst is None or not dst.server.can_ship_kv():
            return None
        hit = self.directory.lookup(fr.prompt, exclude_rid=rid)
        if hit is None:
            return None
        drid, dslot, matched = hit
        if matched <= aff.get(rid, 0):
            return None   # the routed replica already holds as much
        # draining donors still export fine (their pages outlive the
        # withdraw); dead/folded ones already left the directory
        src = self._replicas.get(drid)
        if src is None or src.failed or not src.server.can_ship_kv():
            return None
        key = (rid, _prefix_hash(
            np.asarray(fr.prompt[:matched], dtype=np.int32)))
        if key in self._fed_inflight \
                or len(self._fed_inflight) >= self.cfg.prefix_fed_fetches:
            self.federation["skipped"] += 1
            return None
        self.federation["hits"] += 1
        return drid, dslot, matched, key

    def _fed_fetch_task(self, fr: FleetRequest, fetch, rid: int,
                        disagg: bool) -> None:
        """Pool-thread leg of a federated fetch: ship the donor pages
        onto the routed replica, then submit the request there — its
        prefill lands on the freshly-installed rows and computes only
        the suffix (the scheduler's ``prefill_reused`` path).  ANY
        ship outcome still submits: a failed pull degrades to local
        prefill on the same replica (token-exact either way, only the
        prefill compute differs), and a donor found gone heals the
        stale directory entry."""
        drid, dslot, matched, key = fetch
        try:
            self.federation["fetches"] += 1
            src = self._replicas.get(drid)
            dst = self._replicas.get(rid)
            status = "error"
            if src is not None and dst is not None:
                status = self._ship_kv(src, dst, fr.prompt, fr.id,
                                       reason="federation")
            if status in ("stale", "error") \
                    and self.directory is not None:
                # the donor vanished between lookup and export (the
                # eviction race) — heal the entry so the next lookup
                # doesn't chase it; "busy"/"timeout" keep it: the
                # donor is alive, only this fetch lost
                self.directory.invalidate(drid, dslot)
        except Exception:
            _log.warning("federated fetch failed; request %d prefills "
                         "locally", fr.id, exc_info=True)
        finally:
            with self._lock:
                self._fed_inflight.discard(key)
        rep = self._replicas.get(rid)
        if rep is None or rep.failed:
            self._requeue(fr)
            self._wake.set()
            return
        try:
            if disagg:
                ship = any(
                    r.role == "decode"
                    and hasattr(r.server, "can_adopt_kv")
                    and r.server.can_adopt_kv()
                    for r in self._replicas.values()
                    if not r.failed)
                inner = rep.server.submit(
                    fr.prompt, tenant=fr.tenant,
                    max_new_tokens=1, ship_kv=ship)
            else:
                inner = rep.server.submit(
                    fr.prompt, tenant=fr.tenant,
                    max_new_tokens=fr.max_new_tokens)
        except Exception:
            self._requeue(fr)
            self._wake.set()
            return
        with self._lock:
            fr.inner = inner
            fr.replica = rid
            fr._disagg = {"stage": "prefill"} if disagg else None
        self._wake.set()

    @staticmethod
    def _kvship_timeout() -> float:
        try:
            return float(os.environ.get("RLT_KVSHIP_TIMEOUT_S", "0.2")
                         or 0.2)
        except ValueError:
            return 0.2

    def arm_kvship_drop(self, count: int = 1) -> None:
        """Chaos hook (the serve analog of the elastic plane's
        ``peerdrop`` fault): drop the next ``count`` KV-page ships on
        the channel, forcing the retry → timeout → per-request
        pooled-failover path the chaos test pins."""
        with self._lock:
            self._kvship_drop += int(count)

    # -- autoscaling -------------------------------------------------------

    def signals(self) -> dict:
        """The autoscaler's inputs — the same queue-depth and TTFT
        numbers the trace plane exports per tenant, aggregated
        fleet-wide."""
        with self._lock:
            reps = [r for r in self._replicas.values()
                    if r.state in ("starting", "serving")]
            routable = [r for r in reps if r.routable]
            queued = len(self._pending) + sum(r.queued for r in routable)
            active = sum(r.active for r in routable)
            slots = sum(r.slots for r in routable)
            ttfts = list(self._ttfts)
        ttft_p99 = (float(np.percentile(np.asarray(ttfts), 99)) * 1e3
                    if ttfts else None)
        return {"replicas": len(reps), "queued": queued,
                "active": active, "slots_total": max(1, slots),
                "ttft_p99_ms": ttft_p99}

    def _tick_autoscaler(self) -> None:
        now = time.monotonic()
        if now - self._last_tick < self.cfg.tick_interval_s:
            return
        self._last_tick = now
        sig = self.signals()
        self._gauge("rlt_fleet_replicas_total", sig["replicas"])
        self._gauge("rlt_fleet_queue_depth_total", sig["queued"])
        self._gauge("rlt_fleet_active_slots_total", sig["active"])
        if self._draining:
            return
        decision = self.autoscaler.tick(sig)
        if decision is None:
            return
        if decision["action"] == "grow":
            self._spawn_async(decision["reason"], autoscaled=True)
        else:
            self._shrink_async(decision["reason"])

    def _spawn_async(self, reason: str, autoscaled: bool) -> None:
        def grow():
            t0 = time.monotonic()
            rep = self._new_replica()
            ok = True
            try:
                rep.start()
                _log.info("fleet grow: replica %d serving (%s)",
                          rep.id, reason)
            except Exception:
                ok = False
                _log.error("fleet grow failed", exc_info=True)
                with self._lock:
                    self._replicas.pop(rep.id, None)
            seconds = time.monotonic() - t0
            if autoscaled:
                self.autoscaler.note_actuated(seconds, ok)
            self._count("rlt_fleet_grow_total", 1,
                        outcome="ok" if ok else "error")
            self._count("rlt_fleet_scale_seconds_total", seconds,
                        action="grow")
            self._wake.set()
        t = threading.Thread(target=grow, daemon=True,
                             name="rlt-fleet-grow")
        t.start()
        self._scale_threads.append(t)

    def _shrink_async(self, reason: str) -> None:
        with self._lock:
            routable = self._routable()
            if len(routable) <= self.cfg.min_replicas:
                self.autoscaler.note_actuated(0.0, False)
                return
            # least-loaded first; ties drain the NEWEST replica — the
            # oldest holds the warmest prefix-donor population
            rep = min(routable,
                      key=lambda r: (r.active + r.queued, -r.id))
            rep.mark_draining()

        def shrink():
            t0 = time.monotonic()
            ok = True
            # withdraw the not-yet-admitted requests; they complete on
            # a surviving replica (nothing computed for them yet)
            withdrawn = rep.server.scheduler.withdraw_queued()
            withdrawn_ids = {id(r) for r in withdrawn}
            with self._lock:
                mine = [fr for fr in self._inflight.values()
                        if fr.replica == rep.id and fr.inner is not None
                        and id(fr.inner) in withdrawn_ids]
            for fr in mine:
                self._requeue(fr)
            self._wake.set()
            deadline = time.monotonic() + 300
            while not rep.idle():
                if rep.failed or time.monotonic() > deadline:
                    ok = False
                    break
                time.sleep(0.02)
            if ok:
                try:
                    rep.shutdown(graceful=True)
                except Exception:
                    ok = False
                    _log.warning("fleet shrink: replica %d shutdown "
                                 "failed", rep.id, exc_info=True)
                self._fold_pages(rep)
                with self._lock:
                    self._replicas.pop(rep.id, None)
                _log.info("fleet shrink: replica %d drained and "
                          "stopped (%s)", rep.id, reason)
            seconds = time.monotonic() - t0
            self.autoscaler.note_actuated(seconds, ok)
            self._count("rlt_fleet_shrink_total", 1,
                        outcome="ok" if ok else "error")
            self._count("rlt_fleet_scale_seconds_total", seconds,
                        action="shrink")
            self._wake.set()
        t = threading.Thread(target=shrink, daemon=True,
                             name=f"rlt-fleet-shrink-{rep.id}")
        t.start()
        self._scale_threads.append(t)

    # -- drain / shutdown --------------------------------------------------

    def drain(self, timeout: Optional[float] = 300.0) -> None:
        """Stop admitting; wait for every pending and in-flight request
        to settle (completed, failed, or failed over and completed)."""
        self._draining = True
        self._wake.set()
        deadline = time.monotonic() + (timeout or 0)
        while True:
            with self._lock:
                if not self._pending and not self._inflight:
                    return
            if timeout is not None and time.monotonic() > deadline:
                raise TimeoutError(f"fleet drain incomplete after "
                                   f"{timeout}s")
            self._wake.set()
            time.sleep(0.02)

    def shutdown(self, graceful: bool = True) -> None:
        """Drain (when graceful), stop the router, tear down every
        replica."""
        if graceful and self._started:
            try:
                self.drain()
            except TimeoutError:
                _log.warning("fleet drain timed out; shutting down "
                             "anyway")
        self._stop.set()
        self._wake.set()
        if self._pump is not None and self._pump.is_alive():
            self._pump.join(10)
        if self._kvship_pool is not None:
            self._kvship_pool.shutdown(wait=False, cancel_futures=True)
        for t in self._scale_threads:
            t.join(30)
        reps = list(self._replicas.values())

        def down(rep):
            try:
                rep.shutdown(graceful=graceful)
            except Exception:
                _log.warning("replica %d shutdown failed", rep.id,
                             exc_info=True)

        threads = [threading.Thread(target=down, args=(rep,), daemon=True)
                   for rep in reps]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        self._replicas.clear()
        self._started = False

    def __enter__(self) -> "FleetServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown(graceful=exc[0] is None)

    # -- evidence ----------------------------------------------------------

    def status(self) -> dict:
        """The fleet's evidence: replicas, counts, the autoscaler's
        events, failovers, and with roles the KV-ship counters, with
        federation the directory's."""
        with self._lock:
            replicas = {str(rid): rep.status()
                        for rid, rep in sorted(self._replicas.items())}
            pending = len(self._pending)
            inflight = len(self._inflight)
            sticky = dict(self._sticky)
        pages = self.pages_stats()
        doc = {
            "fleet": {
                "replicas": replicas,
                "pending": pending,
                "inflight": inflight,
                "completed": self.completed,
                "failed": self.failed,
                "requeued": self.requeued,
                "sticky": sticky,
                "autoscale": self.autoscaler.stats(),
                "failovers": [dict(e) for e in self.failovers],
                "bounds": {"min": self.cfg.min_replicas,
                           "max": self.cfg.max_replicas},
            }
        }
        if self.cfg.roles:
            # disaggregated-decode evidence: wire bytes by codec, the
            # compression ratio vs the fp32 baseline, and the chaos
            # counters (retries / per-request failovers)
            kv = dict(self.kvship)
            kv["roles"] = list(self.cfg.roles)
            kv["compression_ratio"] = round(
                kv["bytes_raw"] / kv["bytes_wire"], 4) \
                if kv["bytes_wire"] else None
            doc["fleet"]["kvship"] = kv
        if self.directory is not None:
            # prefix-federation evidence: directory occupancy +
            # hit/miss/invalidation counts, the pull-path wire
            # counters, and the live compression ratio
            fed = dict(self.federation)
            fed["compression_ratio"] = round(
                fed["bytes_raw"] / fed["bytes_wire"], 4) \
                if fed["bytes_wire"] else None
            fed["directory"] = self.directory.stats()
            doc["fleet"]["federation"] = fed
        if pages:
            doc["fleet"]["pages"] = pages
        return doc

    def goodput_stats(self) -> Optional[dict]:
        """Fleet goodput: the telemetry plane's wall-clock partition,
        not ported yet (ROADMAP.md queue 1 item 13), so ``None``."""
        return None

    def pages_stats(self) -> Optional[dict]:
        """Fleet-aggregated prefix-reuse numbers (sums the replicas'
        PagedKV stats; ratio recomputed over the sums)."""
        if not self.paged.enabled:
            return None
        with self._lock:
            reps = list(self._replicas.values())
            retired = dict(self._retired_pages)
        requested = retired["prefill_tokens_requested"]
        computed = retired["prefill_tokens_computed"]
        hits = retired["prefix_hits"]
        reused = retired["reused_prefills"]
        remote = retired["remote_imports"]
        fed_reused = retired["federated_tokens_reused"]
        for rep in reps:
            pages = getattr(rep.server.scheduler, "pages", None)
            if pages is None:
                continue
            st = pages.stats()
            requested += st["prefill_tokens_requested"]
            computed += st["prefill_tokens_computed"]
            hits += st["prefix_hits"]
            reused += st["reused_prefills"]
            remote += st.get("remote_imports", 0)
            fed_reused += st.get("federated_tokens_reused", 0)
        out = {
            "page_size": self.paged.page_size,
            "prefill_tokens_requested": requested,
            "prefill_tokens_computed": computed,
            "prefix_hits": hits,
            "reused_prefills": reused,
            "prefix_reuse_ratio": round(1.0 - computed / requested, 4)
            if requested else 0.0,
        }
        if self.directory is not None:
            # the federation's OWN contribution: prefill tokens the
            # fleet skipped because the pages were pulled from another
            # replica (a strict subset of the overall reuse ratio)
            out["remote_imports"] = remote
            out["federated_tokens_reused"] = fed_reused
            out["federated_reuse_ratio"] = round(
                fed_reused / requested, 4) if requested else 0.0
        return out

    def stats(self) -> dict:
        return {**self.status(),
                "signals": self.signals()}

    # -- metrics plumbing (no-ops when the metrics plane is off) -----------

    @staticmethod
    def _count(name: str, value: float, **labels: Any) -> None:
        reg = _metrics.get_registry()
        if reg is not None:
            reg.counter(name).inc(value, **labels)

    @staticmethod
    def _gauge(name: str, value: float) -> None:
        reg = _metrics.get_registry()
        if reg is not None:
            reg.gauge(name).set(value)


__all__ = ["FleetServer", "FleetRequest", "FleetReplicaLost",
           "pick_replica"]
