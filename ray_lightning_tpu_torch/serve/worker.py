"""The serve step: one scheduler plan executed on the engine.

Counterpart of ``ray_lightning_tpu/serve/worker.py``
``ServeWorker.serve_step``.  The actor plumbing (``setup_serve``, the
cluster backends, telemetry sinks, profiler windows) is not ported yet:
here the worker wraps an engine in the driver's own process, the way
the JAX package's tests drive the loop.
"""

from __future__ import annotations

from typing import Any

from ray_lightning_tpu_torch.telemetry import span


class ServeWorker:
    """Holds one :class:`~ray_lightning_tpu_torch.serve.engine.
    ServeEngine` and runs plans on it."""

    def __init__(self, engine):
        self._engine = engine

    def serve_step(self, plan: dict) -> dict:
        """Execute one scheduler plan: one decode over every live slot
        (or, under speculative decoding, one draft round and one verify),
        then the admitting prefills — fresh, or a prefix-cache hit's copy
        and suffix — each followed by its draft prefill under speculative
        decoding (scheduler.py plan format).

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
        engine = self._engine
        if plan.get("profile") is not None:
            raise NotImplementedError(
                "profile windows are not ported yet")
        result: dict[str, Any] = {"prefill": {}, "decode": {}}
        decode = plan.get("decode")
        if decode is not None and decode.get("spec"):
            # speculative round: k draft steps then ONE batched target
            # verify; the SCHEDULER decides acceptance from the raw
            # outputs (scheduler._apply_spec), the worker stays stateless
            with span("draft", traces=decode.get("traces"),
                      slots=len(decode["slots"])):
                drafts = engine.draft(decode["tokens"],
                                      decode["positions"])
            with span("verify", traces=decode.get("traces"),
                      slots=len(decode["slots"])):
                ver = engine.verify(decode["tokens"],
                                    decode["positions"], drafts)
            for s in decode["slots"]:
                result["decode"][s] = {
                    "draft": [int(x) for x in drafts[s]],
                    "verify": [int(x) for x in ver[s]]}
        elif decode is not None:
            # ONE span for the shared decode step
            with span("decode", traces=decode.get("traces"),
                      slots=len(decode["slots"])):
                toks = engine.decode(decode["tokens"],
                                     decode["positions"])
            for s in decode["slots"]:
                result["decode"][s] = int(toks[s])
        for p in plan["prefills"]:
            if p.get("export_kv") is not None:
                raise NotImplementedError(
                    "KV export (disaggregated serving) is not ported yet")
            reuse = p.get("reuse")
            with span("prefill", trace=p.get("trace"),
                      bucket=p["bucket"], slot=p["slot"],
                      reused=(reuse or {}).get("matched", 0)):
                if reuse is not None:
                    # prefix-cache hit (serve/fleet/pages.py): copy the
                    # matched donor pages, compute only the suffix
                    result["prefill"][p["slot"]] = engine.prefill_reused(
                        p["slot"], reuse["src"], p["tokens"],
                        p["length"], reuse["matched"])
                else:
                    result["prefill"][p["slot"]] = engine.prefill(
                        p["slot"], p["tokens"], p["length"], p["bucket"])
            if p.get("draft"):
                # prime the draft cache for the admitted prompt (fresh
                # AND reused admissions: the draft cache has no copy
                # plane, it always recomputes the full prefix)
                engine.draft_prefill(p["slot"], p["tokens"], p["length"],
                                     p["bucket"])
        return result

__all__ = ["ServeWorker"]
