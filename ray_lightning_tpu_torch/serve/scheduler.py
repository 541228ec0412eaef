"""Driver-side request queue + continuous-batching scheduler (a copy of
``ray_lightning_tpu/serve/scheduler.py`` without the paged-KV,
speculative-decode and KV-shipping branches, which are not ported yet:
asking for them raises).

Admission control and batch formation for the serve plane.  The
scheduler owns every piece of host-side generation state — per-tenant
FIFOs, the slot free-list, each request's position cursor — so workers
stay stateless between steps (params + KV cache only): one plan object
broadcast to every worker fully determines the step, which is what
keeps a multi-host SPMD fleet in lockstep.

Scheduling policy:

- **Per-tenant quota**: a tenant never holds more than
  ``quota`` concurrent batch slots (unbounded by default).
- **Fair-share ordering**: when slots free up, the next admission goes
  to the queued tenant with the fewest active slots, ties broken by
  fewest total served tokens, then FIFO arrival — a deficit-style
  policy under which a chatty tenant cannot starve a quiet one.
- **Continuous batching**: ONE decode program advances every live
  slot a token, and at most ``max_prefills_per_step`` prompt prefills
  are injected per step (bounding decode-latency jitter for in-flight
  requests).  A request admitted at step k starts decoding at step
  k+1 (its first token comes out of the prefill itself) — which is why
  the worker dispatches the decode BEFORE the prefills: the decode's
  static shapes make it write a dummy position-0 K/V entry for every
  slot outside ``decode_slots``, and the admitting prefill must land
  after that write, not before (worker.py serve_step).

Invariants (pinned by tests/test_serve.py and tests/test_torch_serve.py):
slot indices are unique among live requests; per-tenant active count
never exceeds its quota; a submitted request is eventually completed
(no starvation) while the pump keeps stepping.

Trace plane (telemetry/tracing.py): every request carries a trace id
minted at submit; the plan broadcast propagates it to the workers
(prefill entries ``trace=``, decode a slot→trace map), and the
scheduler records the driver-side phases — a ``queue_wait`` span at
admission and a ``request`` summary span at completion/failure carrying
the latency attribution — so the aggregator reassembles one span tree
per request.  Failed/drained requests land in the TTFT/TPOT histograms
under ``status="failed"`` (``fail_all``), never silently unobserved.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np

from ray_lightning_tpu_torch.serve.buckets import bucket_for, pad_to_bucket
from ray_lightning_tpu_torch.serve.kvcache import SlotAllocator
from ray_lightning_tpu_torch.telemetry import metrics as _metrics
from ray_lightning_tpu_torch.telemetry import tracing as _tracing

#: histogram bounds for TTFT/TPOT (seconds): sub-ms CPU-mesh decodes up
#: to multi-second cold paths
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


class ServeRequest:
    """One in-flight generation request (driver-side handle).

    ``result(timeout)`` blocks until the request completes and returns
    the generated token ids (numpy int32).  TTFT/TPOT timestamps are
    recorded here and fed to the metrics plane by the scheduler.
    """

    def __init__(self, req_id: int, tenant: str, tokens: np.ndarray,
                 max_new_tokens: int, eos_token: Optional[int]):
        self.id = req_id
        self.tenant = tenant
        self.tokens = tokens
        self.max_new_tokens = max_new_tokens
        self.eos_token = eos_token
        self.state = "queued"
        self.slot: Optional[int] = None
        self.bucket: Optional[int] = None
        self.generated: list[int] = []
        #: absolute position of the LAST generated token (the next
        #: decode step's input position)
        self.pos: Optional[int] = None
        #: distributed trace id (telemetry/tracing.py): rides the plan
        #: broadcast to the workers, whose prefill/decode spans carry it
        #: back, so the aggregator reassembles this request's span tree
        self.trace = _tracing.mint_trace_id()
        self.t_submit = time.monotonic()
        #: wall-clock twins of the monotonic stamps — the trace plane's
        #: synthetic driver spans must share the workers' wall timeline
        self.t_submit_wall = time.time()
        self.t_admit: Optional[float] = None
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        self.error: Optional[BaseException] = None
        self._event = threading.Event()

    # -- user surface -----------------------------------------------------

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.id} not complete after {timeout}s")
        if self.error is not None:
            raise self.error
        return np.asarray(self.generated, dtype=np.int32)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first is None:
            return None
        return self.t_first - self.t_submit

    @property
    def tpot_s(self) -> Optional[float]:
        """Time-per-output-token over the decode phase (excludes the
        prefill-produced first token)."""
        if self.t_done is None or self.t_first is None \
                or len(self.generated) < 2:
            return None
        return (self.t_done - self.t_first) / (len(self.generated) - 1)

    @property
    def queue_wait_s(self) -> Optional[float]:
        """Submit→admission wait — the queue's share of TTFT (the
        per-tenant p99 the bench and /status report)."""
        if self.t_admit is None:
            return None
        return self.t_admit - self.t_submit

    @property
    def decode_s(self) -> Optional[float]:
        """First token→completion — the decode share of total latency."""
        if self.t_done is None or self.t_first is None:
            return None
        return self.t_done - self.t_first

    # -- scheduler internal ------------------------------------------------

    def _finish(self, error: Optional[BaseException] = None) -> None:
        self.error = error
        self.state = "done" if error is None else "failed"
        self.t_done = time.monotonic()
        self._event.set()


@dataclass
class _Tenant:
    name: str
    quota: Optional[int] = None          # max concurrent slots
    queue: list = field(default_factory=list)
    active: int = 0
    served_tokens: int = 0


class Scheduler:
    """Continuous-batching planner over ``slots`` KV-cache slots."""

    def __init__(self, buckets: Sequence[int], slots: int,
                 max_seq_len: int,
                 quotas: "dict[str, int] | int | None" = None,
                 max_prefills_per_step: int = 1,
                 default_max_new_tokens: int = 32,
                 eos_token: Optional[int] = None,
                 paged: Any = None,
                 spec: Any = None):
        self.buckets = tuple(buckets)
        self.max_seq_len = int(max_seq_len)
        self.allocator = SlotAllocator(slots)
        if paged is not None and getattr(paged, "enabled", False):
            raise NotImplementedError(
                "paged KV with prefix reuse is not ported yet")
        if spec is not None and getattr(spec, "enabled", False):
            raise NotImplementedError(
                "speculative decoding is not ported yet")
        self.max_prefills_per_step = max(1, int(max_prefills_per_step))
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.eos_token = eos_token
        self._default_quota: Optional[int] = (
            int(quotas) if isinstance(quotas, int) else None)
        self._quotas: dict[str, int] = (
            dict(quotas) if isinstance(quotas, dict) else {})
        self._tenants: dict[str, _Tenant] = {}
        self._by_slot: dict[int, ServeRequest] = {}
        self._ids = itertools.count()
        self._arrival = itertools.count()
        self._order: dict[int, int] = {}     # req id -> arrival seq
        self._lock = threading.Lock()
        self.completed = 0
        self.failed = 0
        self._occupancy_sum = 0.0
        self._decode_steps = 0
        # rolling latency tails (incident plane): the histograms above
        # are cumulative-forever, so a live p99 regression drowns in
        # history — these bounded deques carry only the recent window
        # the serve detectors watch
        from collections import deque
        self._recent_ttfts: "deque[float]" = deque(maxlen=128)
        self._recent_tpots: "deque[float]" = deque(maxlen=128)

    # -- admission ---------------------------------------------------------

    def _tenant(self, name: str) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            t = self._tenants[name] = _Tenant(
                name, self._quotas.get(name, self._default_quota))
        return t

    def submit(self, tokens, tenant: str = "default",
               max_new_tokens: Optional[int] = None,
               ship_kv: bool = False) -> ServeRequest:
        if ship_kv:
            raise NotImplementedError(
                "KV shipping (disaggregated serving) is not ported yet")
        tokens = np.asarray(tokens, dtype=np.int32).reshape(-1)
        if len(tokens) == 0:
            raise ValueError("empty prompt")
        bucket = bucket_for(len(tokens), self.buckets)  # raises if too long
        want = max_new_tokens if max_new_tokens is not None \
            else self.default_max_new_tokens
        # the final produced token never writes K/V, so the precise cap
        # is context - prompt_len + 1 (kvcache.py position invariant)
        cap = self.max_seq_len - len(tokens) + 1
        req = ServeRequest(next(self._ids), tenant, tokens,
                           max(1, min(int(want), cap)), self.eos_token)
        req.bucket = bucket
        with self._lock:
            self._order[req.id] = next(self._arrival)
            self._tenant(tenant).queue.append(req)
        self._gauge("rlt_serve_queue_depth_total", self.queued_count)
        return req

    # -- planning ----------------------------------------------------------

    @property
    def queued_count(self) -> int:
        with self._lock:
            return sum(len(t.queue) for t in self._tenants.values())

    @property
    def active_count(self) -> int:
        return len(self._by_slot)

    def idle(self) -> bool:
        return self.queued_count == 0 and self.active_count == 0

    def _admissible_tenants(self) -> list[_Tenant]:
        out = []
        for t in self._tenants.values():
            if not t.queue:
                continue
            if t.quota is not None and t.active >= t.quota:
                continue
            out.append(t)
        return out

    def plan(self) -> Optional[dict]:
        """One scheduler step: admissions (fair-share + quota) into free
        slots, then a decode over every already-live slot.  ``None``
        when there is nothing to do."""
        prefills = []
        with self._lock:
            budget = self.max_prefills_per_step
            while budget > 0:
                candidates = self._admissible_tenants()
                if not candidates:
                    break
                # fair share: fewest active slots, then fewest served
                # tokens, then FIFO arrival of the head request
                tenant = min(candidates, key=lambda t: (
                    t.active, t.served_tokens, self._order[t.queue[0].id]))
                req = tenant.queue[0]
                if self.allocator.free_count == 0:
                    break               # a full allocator ends admission
                tenant.queue.pop(0)
                slot = self.allocator.acquire()
                req.slot = slot
                req.state = "active"
                req.t_admit = time.monotonic()
                tenant.active += 1
                self._by_slot[slot] = req
                entry = {
                    "req": req.id, "slot": slot, "bucket": req.bucket,
                    "tokens": pad_to_bucket(req.tokens, req.bucket),
                    "length": int(len(req.tokens)),
                    # trace id: the driver→worker leg of the trace-
                    # context propagation (the worker's prefill span
                    # carries it back on the queue channel)
                    "trace": req.trace,
                }
                prefills.append(entry)
                budget -= 1
                # the queue-wait phase of this request's span tree +
                # its numeric twin (per-tenant labeled histogram)
                wait = req.queue_wait_s
                _tracing.record_request_span(
                    "queue_wait", req.t_submit_wall, time.time(),
                    trace=req.trace, tenant=req.tenant, req=req.id)
                self._observe("rlt_serve_queue_wait_seconds", wait,
                              tenant=req.tenant)
            # decode advances every slot that already HAS a first token
            # (slots prefilled this very step join the next decode)
            decode_slots = sorted(
                s for s, r in self._by_slot.items() if r.pos is not None)
        decode = None
        if decode_slots:
            S = self.allocator.slots
            tokens = np.zeros((S,), dtype=np.int32)
            # dummy decode writes for idle slots land at position 0,
            # overwritten by the slot's admitting prefill
            positions = np.zeros((S,), dtype=np.int32)
            for s in decode_slots:
                r = self._by_slot[s]
                tokens[s] = r.generated[-1]
                positions[s] = r.pos
            decode = {"tokens": tokens, "positions": positions,
                      "slots": decode_slots,
                      # slot→trace map: ONE decode program advances many
                      # requests, so its worker span fans out to every
                      # live request's tree (aggregator._span_trace_ids)
                      "traces": {s: self._by_slot[s].trace
                                 for s in decode_slots}}
        if not prefills and decode is None:
            return None
        if decode is not None:
            self._occupancy_sum += (
                len(decode_slots) + len(prefills)) / self.allocator.slots
            self._decode_steps += 1
        self._gauge("rlt_serve_queue_depth_total", self.queued_count)
        self._gauge("rlt_serve_active_slots_total",
                    len(self._by_slot))
        return {"prefills": prefills, "decode": decode}

    # -- result application ------------------------------------------------

    def apply(self, plan: dict, result: dict) -> None:
        """Fold one step's worker result (``{"prefill": {slot: token},
        "decode": {slot: token}}``) back into request state: first
        tokens (TTFT), appended tokens, completions (slot eviction)."""
        now = time.monotonic()
        for p in plan["prefills"]:
            slot = p["slot"]
            req = self._by_slot[slot]
            tok = int(result["prefill"][slot])
            req.t_first = now
            req.generated.append(tok)
            req.pos = len(req.tokens)       # the first token's position
            self._observe("rlt_serve_ttft_seconds", req.ttft_s,
                          status="ok")
            if req.ttft_s is not None:
                self._recent_ttfts.append(req.ttft_s)
            self._count("rlt_serve_tokens_total", 1, tenant=req.tenant)
            self._tenant(req.tenant).served_tokens += 1
            self._maybe_finish(req, tok)
        if plan.get("decode") is not None:
            for slot in plan["decode"]["slots"]:
                req = self._by_slot.get(slot)
                if req is None:      # finished by a racing eviction
                    continue
                tok = int(result["decode"][slot])
                req.generated.append(tok)
                req.pos += 1
                self._count("rlt_serve_tokens_total", 1,
                            tenant=req.tenant)
                self._tenant(req.tenant).served_tokens += 1
                self._maybe_finish(req, tok)

    def _maybe_finish(self, req: ServeRequest, last_token: int) -> None:
        hit_eos = (req.eos_token is not None
                   and last_token == req.eos_token)
        if len(req.generated) < req.max_new_tokens and not hit_eos:
            return
        with self._lock:
            self._by_slot.pop(req.slot, None)
            self.allocator.release(req.slot)
            self._tenant(req.tenant).active -= 1
            self.completed += 1
        req._finish()     # stamps t_done — tpot_s is defined only after
        self._observe("rlt_serve_tpot_seconds", req.tpot_s, status="ok")
        if req.tpot_s is not None:
            self._recent_tpots.append(req.tpot_s)
        self._count("rlt_serve_requests_total", 1, tenant=req.tenant,
                    status="ok")
        self._request_span(req, "ok")

    def _request_span(self, req: ServeRequest, status: str) -> None:
        """The request's driver-side summary span: whole submit→done
        life on the wall timeline, carrying the latency attribution the
        aggregator's tenant_breakdown reads (queue_s/ttft_s/tpot_s)."""
        _tracing.record_request_span(
            "request", req.t_submit_wall, time.time(),
            trace=req.trace, tenant=req.tenant, req=req.id,
            status=status, tokens=len(req.generated),
            queue_s=req.queue_wait_s, ttft_s=req.ttft_s,
            tpot_s=req.tpot_s)

    def fail_all(self, error: BaseException) -> None:
        """Propagate a fleet failure into every live/queued request so
        no caller blocks forever on ``result()``.

        Latency accounting (trace-plane satellite): failed and drained
        requests used to vanish from the TTFT/TPOT histograms entirely,
        biasing them optimistic — a fleet that fell over under load
        reported only the requests that finished before it did.  Every
        request failed here now lands in the histograms under a
        ``status="failed"`` label: time-to-failure for requests that
        never produced a token, the partial decode rate for those that
        did."""
        now = time.monotonic()
        with self._lock:
            live = list(self._by_slot.values())
            queued = [r for t in self._tenants.values() for r in t.queue]
            for t in self._tenants.values():
                t.queue.clear()
                t.active = 0
            self._by_slot.clear()
            self.allocator = SlotAllocator(self.allocator.slots)
            self.failed += len(live) + len(queued)
        for r in live + queued:
            r._finish(error)
            # TTFT for a request that never got a first token = its
            # time-to-failure; a partially-decoded one keeps its real
            # TTFT and gets a failure-truncated TPOT
            ttft = r.ttft_s if r.t_first is not None \
                else now - r.t_submit
            self._observe("rlt_serve_ttft_seconds", ttft,
                          status="failed")
            if r.t_first is not None and len(r.generated) >= 2:
                self._observe(
                    "rlt_serve_tpot_seconds",
                    (r.t_done - r.t_first) / (len(r.generated) - 1),
                    status="failed")
            self._count("rlt_serve_requests_total", 1, tenant=r.tenant,
                        status="failed")
            self._request_span(r, "failed")

    # -- stats -------------------------------------------------------------

    def stats(self) -> dict:
        return {
            "completed": self.completed,
            "failed": self.failed,
            "queued": self.queued_count,
            "active": self.active_count,
            "batch_occupancy": (
                self._occupancy_sum / self._decode_steps
                if self._decode_steps else 0.0),
            "decode_steps": self._decode_steps,
            "per_tenant": {
                name: {"active": t.active, "queued": len(t.queue),
                       "served_tokens": t.served_tokens,
                       "quota": t.quota}
                for name, t in self._tenants.items()},
        }

    @staticmethod
    def _tail_p99(tail) -> Optional[float]:
        vals = sorted(tail)
        if not vals:
            return None
        return vals[min(len(vals) - 1, int(0.99 * len(vals)))]

    def recent_ttft_p99(self) -> Optional[float]:
        """p99 of the last ≤128 first-token latencies (None = no
        completed prefills yet)."""
        return self._tail_p99(self._recent_ttfts)

    def recent_tpot_p99(self) -> Optional[float]:
        """p99 of the last ≤128 per-token decode latencies."""
        return self._tail_p99(self._recent_tpots)

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

    @staticmethod
    def _observe(name: str, value: Optional[float],
                 **labels: Any) -> None:
        reg = _metrics.get_registry()
        if reg is not None and value is not None:
            reg.histogram(name, buckets=LATENCY_BUCKETS).observe(
                value, **labels)


__all__ = ["Scheduler", "ServeRequest", "LATENCY_BUCKETS"]
