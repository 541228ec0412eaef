"""Planner configuration (``Trainer(strategy="auto")`` knobs).

Counterpart of ``ray_lightning_tpu/plan/config.py``.  ``PlanConfig`` is
the frozen, picklable settings object of the planner plane (first match
wins):

- ``Trainer(plan=PlanConfig(...))`` — full control;
- ``Trainer(plan={...})`` — kwargs dict;
- ``AutoStrategy(plan=...)`` — per-strategy override;
- ``RLT_PLAN_TOPK`` / ``RLT_PLAN_ICI_GBPS`` / ``RLT_PLAN_DCN_GBPS`` /
  ``RLT_PLAN_STRATEGIES`` / ``RLT_PLAN_MICROBATCH`` / ``RLT_PLAN_REMAT``
  / ``RLT_PLAN_HBM_GBPS`` / ``RLT_PLAN_TFLOPS`` / ``RLT_PLAN_HBM_BYTES``
  / ``RLT_PLAN_HEADROOM`` — env knobs, read when the Trainer arg is
  ``None``;
- ``RLT_PLAN_CALIBRATE=1`` — measured link speeds (comm/calibrate.py,
  cached per topology fingerprint) replace the link constants;
  ``RLT_PLAN_CALIBRATE=live`` scales them by the last run's stored
  measured-over-modeled comm ratio, falling back to the measurement.
  Explicit ``RLT_PLAN_{ICI,DCN}_GBPS`` values still win.

The constants are the card's, not a TPU's.  The links are
comm/audit.py's (``INTRA_HOST_GBPS``: NVLink 4, 450 GB/s a direction;
``INTER_HOST_GBPS``: one 400 Gbit/s NIC a card), H100 SXM published
figures.  :data:`HBM_GBPS` is the H100 SXM 80GB HBM3's published 3,350
GB/s (the bound every ``PERF.md`` kernel row uses).
:data:`DEVICE_TFLOPS` is the recompute rate: the bf16 GEMM rate
``chip_smoke.py``'s planner phase measures on an H100 80GB HBM3 at a
700 W power limit, at a gpt2-medium block's MLP product ([8192, 1024] x
[1024, 4096]).  The model's two other constants are plan/cost.py's.

The resolved config pickles driver→worker on the Trainer and
round-trips through ``worker_env()``, so every rank plans from the same
inputs and the fleet agrees on one winner without a collective.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from ray_lightning_tpu_torch.comm.audit import (INTER_HOST_GBPS,
                                                INTRA_HOST_GBPS)

#: strategy names the planner may enumerate (canonical spellings only)
PLANNABLE_STRATEGIES = ("ddp", "zero1", "fsdp", "spmd")

ENV_TOPK = "RLT_PLAN_TOPK"
ENV_ICI = "RLT_PLAN_ICI_GBPS"
ENV_DCN = "RLT_PLAN_DCN_GBPS"
ENV_STRATEGIES = "RLT_PLAN_STRATEGIES"
ENV_MICROBATCH = "RLT_PLAN_MICROBATCH"
ENV_HBM = "RLT_PLAN_HBM_BYTES"
ENV_HEADROOM = "RLT_PLAN_HEADROOM"
ENV_CALIBRATE = "RLT_PLAN_CALIBRATE"
ENV_REMAT = "RLT_PLAN_REMAT"
ENV_HBM_GBPS = "RLT_PLAN_HBM_GBPS"
ENV_TFLOPS = "RLT_PLAN_TFLOPS"
ENV_KNOBS = (ENV_TOPK, ENV_ICI, ENV_DCN, ENV_STRATEGIES, ENV_MICROBATCH,
             ENV_HBM, ENV_HEADROOM, ENV_CALIBRATE, ENV_REMAT,
             ENV_HBM_GBPS, ENV_TFLOPS)

#: H100 SXM 80GB HBM3 memory rate, GB/s (module docstring)
HBM_GBPS = 3350.0
#: measured bf16 GEMM rate, TFLOP/s (module docstring): 710.6 on an H100
#: 80GB HBM3 at 700 W (717.4 on a second machine of that kind)
DEVICE_TFLOPS = 710.6


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """What the planner enumerates and how it scores (the JAX fields).

    topk: how many model-ranked survivors the verify step runs in fake
        mode (compile/aot.py ``compile_scored``; 0 skips it).
    ici_gbps / dcn_gbps: modeled link rates for bytes -> seconds.
    strategies: candidate strategy inventory.
    microbatch: candidate ``accumulate_grad_batches`` values.
    remat: candidate remat policies (``()``: the module's whole ladder).
    hbm_gbps: the rate saved activations are charged at (a store and a
        load a step).
    device_tflops: the rate recomputed products are charged at.
    hbm_budget_bytes: per-device budget override (None: ask the card;
        on the CPU memory never rejects).
    headroom: fraction of the budget modeled residents may use.
    activation_factor: activations per batch byte when the module has
        no remat ladder.
    max_candidates: cap on scored candidates (overflow is reported).
    reuse: reuse a plan for same-shaped trials inside a Tune experiment.
    """

    topk: int = 3
    ici_gbps: float = INTRA_HOST_GBPS
    dcn_gbps: float = INTER_HOST_GBPS
    strategies: tuple = PLANNABLE_STRATEGIES
    microbatch: tuple = (1,)
    remat: tuple = ()
    hbm_gbps: float = HBM_GBPS
    device_tflops: float = DEVICE_TFLOPS
    hbm_budget_bytes: Optional[int] = None
    headroom: float = 0.9
    activation_factor: float = 8.0
    max_candidates: int = 256
    reuse: bool = True

    def __post_init__(self):
        if self.topk < 0:
            raise ValueError("plan topk must be >= 0")
        if self.ici_gbps <= 0 or self.dcn_gbps <= 0:
            raise ValueError("plan bandwidths must be positive")
        if not (0.0 < self.headroom <= 1.0):
            raise ValueError("plan headroom must be in (0, 1]")
        if self.max_candidates < 1:
            raise ValueError("plan max_candidates must be >= 1")
        object.__setattr__(self, "strategies", tuple(self.strategies))
        unknown = [s for s in self.strategies
                   if s not in PLANNABLE_STRATEGIES]
        if unknown:
            raise ValueError(
                f"unplannable strategies {unknown}; "
                f"options: {PLANNABLE_STRATEGIES}")
        mb = tuple(int(m) for m in self.microbatch)
        if not mb or any(m < 1 for m in mb):
            raise ValueError("plan microbatch values must be >= 1")
        object.__setattr__(self, "microbatch", mb)
        rm = tuple(str(p) for p in self.remat)
        if any(not p for p in rm):
            raise ValueError("plan remat policy names must be non-empty")
        object.__setattr__(self, "remat", rm)
        if self.hbm_gbps <= 0 or self.device_tflops <= 0:
            raise ValueError(
                "plan hbm_gbps / device_tflops must be positive")

    # -- construction ----------------------------------------------------

    @classmethod
    def resolve(cls, value) -> "PlanConfig":
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        if value is not None:
            raise TypeError(f"bad plan config: {value!r}")
        kw: dict = {}
        env = os.environ
        raw = env.get(ENV_TOPK, "").strip()
        if raw:
            kw["topk"] = int(raw)
        raw_cal = env.get(ENV_CALIBRATE, "").strip().lower()
        if raw_cal in ("1", "true"):
            from ray_lightning_tpu_torch.comm.calibrate import \
                calibrated_gbps
            kw["ici_gbps"], kw["dcn_gbps"] = calibrated_gbps()
        elif raw_cal in ("live", "anatomy"):
            from ray_lightning_tpu_torch.comm import calibrate as _cal
            live = _cal.live_calibration()
            if live is not None:
                scale = float(live["comm_scale"])
                kw["ici_gbps"] = round(INTRA_HOST_GBPS / scale, 3)
                kw["dcn_gbps"] = round(INTER_HOST_GBPS / scale, 3)
            else:
                kw["ici_gbps"], kw["dcn_gbps"] = _cal.calibrated_gbps()
        for name, key, conv in (
                (ENV_ICI, "ici_gbps", float), (ENV_DCN, "dcn_gbps", float),
                (ENV_HBM_GBPS, "hbm_gbps", float),
                (ENV_TFLOPS, "device_tflops", float),
                (ENV_HBM, "hbm_budget_bytes", int),
                (ENV_HEADROOM, "headroom", float)):
            raw = env.get(name, "").strip()
            if raw:
                kw[key] = conv(raw)
        for name, key, conv in ((ENV_STRATEGIES, "strategies", str),
                                (ENV_MICROBATCH, "microbatch", int),
                                (ENV_REMAT, "remat", str)):
            raw = env.get(name, "").strip()
            if raw:
                kw[key] = tuple(conv(s) for s in raw.split(",") if s)
        return cls(**kw)

    # -- env round-trip --------------------------------------------------

    def worker_env(self) -> dict:
        """Env mapping reproducing this config via :meth:`resolve` in a
        worker process (only the fields off their defaults)."""
        default = PlanConfig()
        env = {}
        for name, key in ((ENV_TOPK, "topk"), (ENV_ICI, "ici_gbps"),
                          (ENV_DCN, "dcn_gbps"), (ENV_HBM_GBPS, "hbm_gbps"),
                          (ENV_TFLOPS, "device_tflops"),
                          (ENV_HEADROOM, "headroom")):
            value = getattr(self, key)
            if value != getattr(default, key):
                env[name] = repr(value)
        for name, key in ((ENV_STRATEGIES, "strategies"),
                          (ENV_MICROBATCH, "microbatch"),
                          (ENV_REMAT, "remat")):
            value = getattr(self, key)
            if value != getattr(default, key):
                env[name] = ",".join(str(v) for v in value)
        if self.hbm_budget_bytes is not None:
            env[ENV_HBM] = str(self.hbm_budget_bytes)
        return env


__all__ = ["DEVICE_TFLOPS", "ENV_KNOBS", "HBM_GBPS", "PLANNABLE_STRATEGIES",
           "PlanConfig"]
