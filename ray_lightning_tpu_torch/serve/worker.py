"""The persistent serve actor, and the serve step: one scheduler plan
executed on the engine.

Counterpart of ``ray_lightning_tpu/serve/worker.py`` ``ServeWorker``.
Training actors live for ONE blocking ``execute`` call; a serve worker
stays resident: ``setup_serve`` takes the worker's device and builds
the engine once (its programs captured as CUDA graphs on the card),
then the driver (serve/server.py ``Server``) streams ``serve_step``
calls for the fleet's whole life.  It extends the generic
:class:`~ray_lightning_tpu_torch.cluster.executor.RLTExecutor`, so the
driver-side rendezvous plumbing (node address, env vars) is the one the
fit path uses.

Lockstep contract: every worker of a fleet receives the IDENTICAL plan.
With W workers the fleet's S slots split in contiguous blocks of S / W
(the JAX ``kv_cache_spec`` shards the slots over the data axes the same
way): each rank decodes, drafts and verifies its own block, runs the
prefills of its own slots, and returns its block's results, which the
driver merges.  The JAX ranks return nothing but rank 0's replicated
outputs; here no collective is needed.

``ServeWorker(engine)`` is the in-process form (the tests and the smoke
script drive the loop without actors): it owns all the engine's slots.
KV shipping (the fleet's disaggregation and prefix federation): a
ship-bound prefill's rows ride back with its step result (the plan's
``export_kv``), ``serve_export_kv`` and ``serve_import_kv`` move a
donor's rows out of and into this rank's block, the rank that owns the
slot answering.  The telemetry sinks and the profile windows are not
ported yet.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

from ray_lightning_tpu_torch._device import worker_device
from ray_lightning_tpu_torch.cluster.executor import RLTExecutor
from ray_lightning_tpu_torch.telemetry import span


class ServeWorker(RLTExecutor):
    """Holds one :class:`~ray_lightning_tpu_torch.serve.engine.
    ServeEngine` and runs plans on it: in process around a given engine,
    or as an actor that builds its own in :meth:`setup_serve`."""

    def __init__(self, engine=None, env: Optional[dict] = None):
        super().__init__(env)
        self._engine = engine
        self._rank = 0
        #: the fleet's slots ``[lo, hi)`` this worker serves (``None``:
        #: every slot of its engine, the in-process form)
        self._block: "Optional[tuple[int, int]]" = None

    # -- lifecycle ---------------------------------------------------------

    def setup_serve(self, payload: tuple, rank: int, queue=None) -> dict:
        """Take this worker's device, build and capture its engine over
        its block of slots, and return the setup facts the driver logs:
        rank, device, buckets, slots and their block, the KV shape, the
        seconds it took and the engine's stats.

        ``payload`` is ``(ServeSpec, weights)``.  The device is the
        worker's local card ``LOCAL_RANK``, made current, or the CPU
        under ``RLT_PLATFORM=cpu`` (``torch.set_num_threads`` of
        ``RLT_CPU_THREADS``); a GPU worker without CUDA raises.
        ``queue`` (the worker-to-driver proxy) feeds the telemetry
        sinks, which are not ported yet.  ``spec`` and ``kvship`` ride
        the ``ServeSpec`` when the driver set them; otherwise the
        ``RLT_SPEC_*`` / ``RLT_SERVE_KVSHIP`` worker env decides (the
        fleet's replica round trip)."""
        from ray_lightning_tpu_torch.serve.engine import ServeEngine
        from ray_lightning_tpu_torch.serve.spec import SpecConfig

        t0 = time.monotonic()
        spec, weights = payload
        self._rank = int(rank)
        n = int(os.environ.get("RLT_NUM_PROCESSES", "1"))
        per = spec.slots // n
        self._block = (self._rank * per, (self._rank + 1) * per)
        device = worker_device(
            os.environ.get("RLT_PLATFORM", "cuda") != "cpu",
            int(os.environ.get("LOCAL_RANK", "0")),
            int(os.environ.get("RLT_CPU_THREADS", "1")),
            "Server", "platform='cpu'")
        sp = spec.spec if spec.spec is not None else SpecConfig.resolve(None)
        kvship = spec.kvship
        if kvship is None:
            kvship = os.environ.get(
                "RLT_SERVE_KVSHIP", "").strip() in ("1", "true", "True")
        self._engine = ServeEngine(
            spec.module, spec.buckets, per, spec.max_seq_len,
            seed=spec.seed, weights=weights, device=device,
            paged=spec.paged, spec=sp, kvship=bool(kvship)).setup()
        eng = self._engine
        return {
            "rank": self._rank,
            "device": str(device),
            "buckets": list(eng.buckets),
            "slots": eng.slots,
            "slot_block": list(self._block),
            "kv_shape": list(eng.kv_spec.shape),
            "setup_s": time.monotonic() - t0,
            "stats": eng.stats(),
        }

    # -- the serving hot path ----------------------------------------------

    def serve_step(self, plan: dict) -> dict:
        """Execute one scheduler plan: one decode over every live slot
        (or, under speculative decoding, one draft round and one verify),
        then the admitting prefills — fresh, or a prefix-cache hit's copy
        and suffix — each followed by its draft prefill under speculative
        decoding (scheduler.py plan format).  On this worker's block of
        slots only; slot ids in the result are the fleet's.

        The order is load-bearing.  The decode step has static shapes,
        so it writes K/V for EVERY slot — slots outside ``decode_slots``
        carry ``tokens=0/positions=0`` and get a dummy write at position
        0.  Decode never reads a same-step prefill's state (a slot
        admitted at step k joins the decode at step k+1), so decode-first
        lets each admitting prefill overwrite its slot's dummy entry;
        prefill-first would let the dummy write clobber the prompt's
        position-0 K/V just after the prefill produced it, corrupting
        every subsequent token (position 0 is always inside the mask).
        Free slots that are NOT admitted this step keep the dummy entry
        harmlessly: their next prefill rewrites the whole prefix
        (kvcache.py invariant)."""
        if plan.get("profile") is not None:
            raise NotImplementedError(
                "profile windows are not ported yet")
        engine = self._engine
        if engine is None:
            raise RuntimeError("serve_step before setup_serve")
        lo, hi = self._block or (0, None)

        def mine(slot: int) -> bool:
            return lo <= slot and (hi is None or slot < hi)

        result: dict[str, Any] = {"prefill": {}, "decode": {}}
        decode = plan.get("decode")
        if decode is not None:
            tokens = decode["tokens"][lo:hi]
            positions = decode["positions"][lo:hi]
            live = [s for s in decode["slots"] if mine(s)]
        if decode is not None and decode.get("spec"):
            # speculative round: k draft steps then ONE batched target
            # verify; the SCHEDULER decides acceptance from the raw
            # outputs (scheduler._apply_spec), the worker stays stateless
            with span("draft", traces=decode.get("traces"),
                      slots=len(live)):
                drafts = engine.draft(tokens, positions)
            with span("verify", traces=decode.get("traces"),
                      slots=len(live)):
                ver = engine.verify(tokens, positions, drafts)
            for s in live:
                result["decode"][s] = {
                    "draft": [int(x) for x in drafts[s - lo]],
                    "verify": [int(x) for x in ver[s - lo]]}
        elif decode is not None:
            # ONE span for the shared decode step
            with span("decode", traces=decode.get("traces"),
                      slots=len(live)):
                toks = engine.decode(tokens, positions)
            for s in live:
                result["decode"][s] = int(toks[s - lo])
        for p in plan["prefills"]:
            if not mine(p["slot"]):
                continue
            slot = p["slot"] - lo
            reuse = p.get("reuse")
            with span("prefill", trace=p.get("trace"),
                      bucket=p["bucket"], slot=p["slot"],
                      reused=(reuse or {}).get("matched", 0)):
                if reuse is not None:
                    # prefix-cache hit (serve/fleet/pages.py): copy the
                    # matched donor pages, compute only the suffix (the
                    # scheduler keeps the donor in the admission's block)
                    result["prefill"][p["slot"]] = engine.prefill_reused(
                        slot, reuse["src"] - lo, p["tokens"],
                        p["length"], reuse["matched"])
                else:
                    result["prefill"][p["slot"]] = engine.prefill(
                        slot, p["tokens"], p["length"], p["bucket"])
            if p.get("draft"):
                # prime the draft cache for the admitted prompt (fresh
                # AND reused admissions: the draft cache has no copy
                # plane, it always recomputes the full prefix)
                engine.draft_prefill(slot, p["tokens"], p["length"],
                                     p["bucket"])
            exp = p.get("export_kv")
            if exp is not None:
                # ship-bound prefill (disaggregation leg 1): the donor
                # rows ride back WITH the step result, so the router's
                # KV ship never pays a second worker round trip nor
                # races this slot's later eviction
                with span("kv_export", slot=p["slot"],
                          bucket=exp["bucket"]):
                    rows = engine.export_kv(slot, exp["bucket"])
                result.setdefault("kv_export", {})[p["slot"]] = rows
        return result

    # -- KV-page shipping (fleet disaggregation) ---------------------------

    def _local(self, slot: int) -> "Optional[int]":
        """``slot`` (the fleet's) in this rank's block, or ``None``."""
        lo, hi = self._block or (0, self._engine.slots)
        return slot - lo if lo <= slot < hi else None

    def serve_export_kv(self, slot: int, bucket: int):
        """Device-to-host donor rows for the router's KV-ship leg from
        the rank that owns ``slot`` (``None`` from the others)."""
        local = self._local(slot)
        if local is None:
            return None
        with span("kv_export", slot=slot, bucket=bucket):
            return self._engine.export_kv(local, bucket)

    def serve_import_kv(self, slot: int, k_rows, v_rows) -> None:
        """Install shipped donor rows (engine ``kv_import_{b}``) on the
        rank that owns ``slot``."""
        local = self._local(slot)
        if local is None:
            return
        with span("kv_import", slot=slot, bucket=int(k_rows.shape[2])):
            self._engine.import_kv(local, k_rows, v_rows)

    # -- evidence / teardown -----------------------------------------------

    def serve_stats(self) -> dict:
        """The engine's stats (serve/engine.py ``stats``), this rank's
        block, its process id and, on the card, the device memory its
        process holds (``memory_allocated`` / ``memory_reserved``)."""
        if self._engine is None:
            return {}
        out = {**self._engine.stats(), "rank": self._rank,
               "slot_block": list(self._block or (0, self._engine.slots)),
               "pid": os.getpid()}
        dev = self._engine.device
        if dev.type == "cuda":
            import torch
            out["memory_allocated"] = torch.cuda.memory_allocated(dev)
            out["memory_reserved"] = torch.cuda.memory_reserved(dev)
        return out

    def teardown_serve(self) -> None:
        """Drop the engine (its caches and graphs) before the actor is
        stopped."""
        self._engine = None


__all__ = ["ServeWorker"]
