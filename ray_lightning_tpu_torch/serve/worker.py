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
The workers are the ranks of one process group (``setup_serve``: NCCL
on the cards, gloo on the CPU or on one card under
``RLT_ONE_CARD_GLOO=1``) and of the strategy's mesh over it
(serve/engine.py).  The fleet's S slots split over the data shards in
contiguous blocks, as the JAX ``kv_cache_spec`` shards them: a rank
takes the block of its coordinates on the data axes (``data``,
``fsdp``), not of its rank, and under ``tensor`` its heads of that
block's cache.  Every rank runs every program of the plan, in the
plan's order, whether or not a slot of its block is live: the decode
(or the draft and the verify), and the prefills of its block; the
ranks of a tensor group hold the same slots, so they run those
together, and their collectives match.  Under FSDP a prefill gathers
parameters over every data shard, so a rank runs the other shards'
admissions too, on a scratch slot past its block
(``ServeEngine.shadow_prefill``).
Only the rank at coordinate 0 on every axis but the data axes returns
its block's results, which the driver merges; the others of its tensor
group return nothing, as the JAX ranks but rank 0 do.

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

import datetime
import os
import time
from typing import Any, Optional

from ray_lightning_tpu_torch._device import worker_device
from ray_lightning_tpu_torch.cluster.executor import RLTExecutor
from ray_lightning_tpu_torch.telemetry import span

#: the most a serving collective waits
COLLECTIVE_TIMEOUT_S = 600.0


class ServeWorker(RLTExecutor):
    """Holds one :class:`~ray_lightning_tpu_torch.serve.engine.
    ServeEngine` and runs plans on it: in process around a given engine,
    or as an actor that builds its own in :meth:`setup_serve`."""

    def __init__(self, engine=None, env: Optional[dict] = None):
        super().__init__(env)
        self._rank = 0
        #: the fleet's slots ``[lo, hi)`` this worker serves (``None``:
        #: every slot of its engine, the in-process form)
        self._block: "Optional[tuple[int, int]]" = None
        #: whether this rank returns its block's results (module
        #: docstring)
        self._leader = True
        #: whether this actor joined a process group
        self._group = False
        self._serve(engine)

    def _serve(self, engine) -> None:
        """Serve ``engine``: set up under a strategy, its block of the
        fleet's slots, as its leader or not."""
        self._engine = engine
        if getattr(engine, "mesh", None) is not None:
            self._block, self._leader = engine.slot_block, engine.leader

    # -- lifecycle ---------------------------------------------------------

    def setup_serve(self, payload: tuple, rank: int, queue=None) -> dict:
        """Take this worker's device, join the fleet's process group,
        build and capture its engine over its block of slots under the
        spec's strategy, and return the setup facts the driver logs:
        rank, device, buckets, slots and their block, the KV shape, the
        mesh, the seconds it took and the engine's stats.

        ``payload`` is ``(ServeSpec, weights)``.  The device is the
        worker's local card ``LOCAL_RANK``, made current (card 0 under
        ``RLT_ONE_CARD_GLOO=1``), or the CPU under ``RLT_PLATFORM=cpu``
        (``torch.set_num_threads`` of ``RLT_CPU_THREADS``); a GPU worker
        without CUDA raises.  With ``RLT_NUM_PROCESSES`` over 1 the
        ranks rendezvous at ``MASTER_ADDR`` / ``MASTER_PORT``, as the
        plugins' workers do (NCCL on the cards, gloo otherwise).
        ``queue`` (the worker-to-driver proxy) feeds the telemetry
        sinks, which are not ported yet.  ``spec`` and ``kvship`` ride
        the ``ServeSpec`` when the driver set them; otherwise the
        ``RLT_SPEC_*`` / ``RLT_SERVE_KVSHIP`` worker env decides (the
        fleet's replica round trip)."""
        import torch.distributed as dist

        from ray_lightning_tpu_torch.plugins.ray_ddp import one_card
        from ray_lightning_tpu_torch.serve.engine import ServeEngine
        from ray_lightning_tpu_torch.serve.spec import SpecConfig

        t0 = time.monotonic()
        spec, weights = payload
        self._rank = int(rank)
        n = int(os.environ.get("RLT_NUM_PROCESSES", "1"))
        shared = one_card()
        device = worker_device(
            os.environ.get("RLT_PLATFORM", "cuda") != "cpu",
            0 if shared else int(os.environ.get("LOCAL_RANK", "0")),
            int(os.environ.get("RLT_CPU_THREADS", "1")),
            "Server", "platform='cpu'")
        if n > 1:
            dist.init_process_group(
                "nccl" if device.type == "cuda" and not shared else "gloo",
                rank=self._rank, world_size=n,
                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
            self._group = True
        sp = spec.spec if spec.spec is not None else SpecConfig.resolve(None)
        kvship = spec.kvship
        if kvship is None:
            kvship = os.environ.get(
                "RLT_SERVE_KVSHIP", "").strip() in ("1", "true", "True")
        eng = ServeEngine(
            spec.module, spec.buckets, spec.slots, spec.max_seq_len,
            seed=spec.seed, weights=weights, device=device,
            strategy=spec.strategy, paged=spec.paged, spec=sp,
            kvship=bool(kvship)).setup()
        self._serve(eng)
        return {
            "rank": self._rank,
            "device": str(device),
            "buckets": list(eng.buckets),
            "slots": eng.slots,
            "slot_block": list(eng.slot_block),
            "kv_shape": list(eng.kv_spec.shape),
            "mesh": eng.mesh and dict(eng.mesh.shape),
            "leader": eng.leader,
            "setup_s": time.monotonic() - t0,
            "stats": eng.stats(),
        }

    # -- the serving hot path ----------------------------------------------

    def serve_step(self, plan: dict) -> "Optional[dict]":
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
        (kvcache.py invariant).  Another block's admission runs here
        only under lockstep, on the scratch slot; a rank that is not its
        block's leader returns ``None`` (module docstring)."""
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
                if getattr(engine, "lockstep", False):
                    with span("shadow_prefill", bucket=p["bucket"],
                              slot=p["slot"]):
                        engine.shadow_prefill(p)
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
        return result if self._leader else None

    # -- KV-page shipping (fleet disaggregation) ---------------------------

    def _local(self, slot: int) -> "Optional[int]":
        """``slot`` (the fleet's) in this rank's block, or ``None``."""
        lo, hi = self._block or (0, self._engine.slots)
        return slot - lo if lo <= slot < hi else None

    def serve_export_kv(self, slot: int, bucket: int):
        """Device-to-host donor rows for the router's KV-ship leg from
        the leader of the block that owns ``slot`` (``None`` from the
        others; its tensor group gathers the heads together)."""
        local = self._local(slot)
        if local is None:
            return None
        with span("kv_export", slot=slot, bucket=bucket):
            rows = self._engine.export_kv(local, bucket)
        return rows if self._leader else None

    def serve_import_kv(self, slot: int, k_rows, v_rows) -> None:
        """Install shipped donor rows (engine ``kv_import_{b}``) on the
        ranks that own ``slot``, each its heads of them."""
        local = self._local(slot)
        if local is None:
            return
        with span("kv_import", slot=slot, bucket=int(k_rows.shape[2])):
            self._engine.import_kv(local, k_rows, v_rows)

    # -- evidence / teardown -----------------------------------------------

    def serve_call(self, fn, *args):
        """``fn(engine, *args)`` on this rank's engine: a probe for tests
        and tools (the weights' pieces, a step's logits).  ``fn`` is a
        module-level function (pickled by name); every rank of the mesh
        runs it, in its order among the plans, so collectives inside it
        match."""
        if self._engine is None:
            raise RuntimeError("serve_call before setup_serve")
        return fn(self._engine, *args)

    def serve_stats(self) -> dict:
        """The engine's stats (serve/engine.py ``stats``), this rank's
        block, its process id and, on the card, the device memory its
        process holds (``max_memory_allocated``, ``memory_allocated``,
        ``memory_reserved``)."""
        if self._engine is None:
            return {}
        out = {**self._engine.stats(), "rank": self._rank,
               "slot_block": list(self._block or (0, self._engine.slots)),
               "pid": os.getpid()}
        dev = self._engine.device
        if dev.type == "cuda":
            import torch
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                dev)
            out["memory_allocated"] = torch.cuda.memory_allocated(dev)
            out["memory_reserved"] = torch.cuda.memory_reserved(dev)
        return out

    def teardown_serve(self) -> None:
        """Drop the engine (its caches and graphs) and leave the process
        group before the actor is stopped."""
        engine, self._engine = self._engine, None
        if engine is not None:
            engine.close()
        del engine
        if self._group:
            import torch.distributed as dist
            self._group = False
            dist.destroy_process_group()


__all__ = ["ServeWorker"]
