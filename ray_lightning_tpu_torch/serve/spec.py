"""Speculative-decoding knobs (the serve plane's draft→verify loop): a
copy of ``ray_lightning_tpu/serve/spec.py``.  The int8-resident draft
(``draft_quant="int8"``) needs the comm plane's codecs, which are not
ported yet: the engine refuses it.

Resolved like every other plane config (PageConfig, FleetConfig):
``Server(spec=...)`` accepts a :class:`SpecConfig`, a bool/int/dict
sugar, or ``None`` to defer to the ``RLT_SPEC_*`` env knobs — and
``worker_env()`` reproduces the config in a worker process so replica
actors inherit it under both cluster backends.

The loop itself: per decode round the DRAFT model (a smaller sibling
sharing the target's weights, ``LightningModule.configure_draft``)
greedily drafts ``k`` tokens per slot over its own KV cache
(core/steps.py ``build_draft_step``), then ONE batched target forward
scores all k+1 positions (``build_verify_step``); the scheduler accepts
the longest agreeing prefix plus one corrected token — token-level
IDENTICAL to target-only greedy decode, so speculation is purely a
latency lever.  ``min_accept`` arms the per-request fallback: a request
whose rolling acceptance collapses below the floor is marked ``spec
off`` and thereafter takes only the verify's first (= plain decode)
token; when EVERY live slot has fallen back the scheduler plans plain
decode steps again and the draft cost disappears entirely.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decode configuration.

    enabled: master switch — off keeps the serve plane byte-identical
        to the plain-decode build (no draft model, no extra programs).
    k: speculation depth — tokens drafted per round; each verify can
        emit 1..k+1 tokens.  Deeper k amortizes more target forwards
        but wastes more draft work at low acceptance.
    min_accept: per-request acceptance floor in [0, 1] — a request
        whose rolling window acceptance (accepted/drafted) drops below
        it falls back to plain decode for its remaining life.  0
        disables the fallback.
    window: spec rounds in the rolling acceptance window (per request);
        the fallback only arms once the window has ``window // 2``
        entries, so a cold start can't trip it.
    draft_layers: draft depth override for
        ``configure_draft(layers=...)``; 0 = the module's default
        (GPT: ``n_layer // 2``).
    draft_quant: ``"int8"`` holds the draft weights as a blockwise
        int8-resident copy (comm/quant.py), dequantized inline in the
        draft programs — trades exact weight sharing for ~2x smaller
        draft residency (the HBM delta is reported in
        ``server.stats()``).  Parity note: the EMITTED stream stays
        exactly greedy-parity regardless (only the target's verify
        decides tokens); quantization can only move the acceptance
        rate.
    """

    enabled: bool = False
    k: int = 4
    min_accept: float = 0.0
    window: int = 32
    draft_layers: int = 0
    draft_quant: Optional[str] = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError("spec k must be >= 1")
        if not 0.0 <= self.min_accept <= 1.0:
            raise ValueError("min_accept must be in [0, 1]")
        if self.window < 2:
            raise ValueError("window must be >= 2")
        if self.draft_layers < 0:
            raise ValueError("draft_layers must be >= 0")
        if self.draft_quant not in (None, "int8"):
            raise ValueError(
                f"draft_quant {self.draft_quant!r}; only 'int8' is "
                f"supported (comm/quant.py blockwise residency)")

    @classmethod
    def resolve(cls, value) -> "SpecConfig":
        """``Server(spec=...)`` → a config.  ``None`` defers to the
        ``RLT_SPEC_*`` env knobs (the worker_env round-trip)."""
        if isinstance(value, cls):
            return value
        if isinstance(value, bool):
            return cls(enabled=value)
        if isinstance(value, int):
            return cls(enabled=True, k=value)
        if isinstance(value, dict):
            cfg = dict(value)
            cfg.setdefault("enabled", True)
            return cls(**cfg)
        if value is not None:
            raise TypeError(f"bad spec config: {value!r}")
        env = os.environ.get
        return cls(
            enabled=env("RLT_SPEC_DECODE", "").strip()
            in ("1", "true", "True"),
            k=int(env("RLT_SPEC_K", "4") or 4),
            min_accept=float(env("RLT_SPEC_MIN_ACCEPT", "0") or 0),
            window=int(env("RLT_SPEC_WINDOW", "32") or 32),
            draft_layers=int(env("RLT_SPEC_DRAFT_LAYERS", "0") or 0),
            draft_quant=env("RLT_DRAFT_QUANT", "").strip() or None,
        )

    def worker_env(self) -> dict:
        """Env mapping reproducing this config via :meth:`resolve` in a
        worker process."""
        if not self.enabled:
            return {}
        out = {"RLT_SPEC_DECODE": "1",
               "RLT_SPEC_K": str(self.k),
               "RLT_SPEC_MIN_ACCEPT": repr(self.min_accept),
               "RLT_SPEC_WINDOW": str(self.window),
               "RLT_SPEC_DRAFT_LAYERS": str(self.draft_layers)}
        if self.draft_quant:
            out["RLT_DRAFT_QUANT"] = self.draft_quant
        return out


__all__ = ["SpecConfig"]
