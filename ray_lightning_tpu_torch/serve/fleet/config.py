"""Fleet-plane configuration: replica bounds + autoscaler policy (a copy
of ``ray_lightning_tpu/serve/fleet/config.py``; ``kvship_codec`` is
checked against the port's codecs, comm/quant.py).

``FleetConfig`` is the router's and autoscaler's shared knob set,
resolved like every other plane config (CommPolicy / ElasticConfig /
PageConfig): an explicit object or dict wins, ``None`` reads the
``RLT_FLEET*`` env knobs, and :meth:`worker_env` reproduces the config
via :meth:`resolve` in a worker process — so replica actors inherit the
fleet config through the cluster backend (the round trip pinned by
tests/test_fleet.py and tests/test_torch_fleet.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """How the fleet scales and routes.

    min_replicas / max_replicas: the autoscaler's bounds; the router
        also grows back toward ``min_replicas`` after a failover.
    grow_queue_depth: queued requests PER SERVING REPLICA above which
        the autoscaler votes grow.
    grow_ttft_p99_ms: recent fleet TTFT p99 above which the autoscaler
        votes grow (None = queue signal only).
    shrink_occupancy: live-slot fraction below which (with an empty
        queue) the autoscaler votes shrink.
    patience_ticks: consecutive agreeing ticks before a decision fires
        (debounce — one bursty tick must not scale the fleet).
    cooldown_s: seconds after an action completes before the next may
        fire (grow actuation takes seconds; deciding again from stale
        signals mid-actuation would oscillate).
    tick_interval_s: autoscaler evaluation cadence.
    sticky_slack: tenant stickiness tolerance — the tenant's last
        replica wins routing while its active-slot load is within this
        many slots of the least-loaded replica (KV affinity keeps
        prefix-reuse hits local without defeating load balance).
    roles: per-replica pool assignment for disaggregated serving —
        one of ``"prefill"`` / ``"decode"`` / ``"pooled"`` per replica
        index, cycled when the fleet outgrows the tuple.  Empty =
        every replica pooled (the pre-disaggregation behavior).  With
        both a prefill and a decode pool routable, an admission
        prefills on the prefill pool, its KV pages ship over the peer
        channel (``kvship_codec``), and the decode replica finishes
        the request; either pool emptying fails back to pooled
        routing.
    kvship_codec: wire codec for shipped KV pages (comm/quant.py):
        ``"fp8"`` (default), ``"int8"``, ``"int4"``, ``"bf16"``, or
        ``"raw"`` (the uncompressed fp32 A/B control leg).
    prefix_fed: fleet-level prefix-cache federation
        (serve/fleet/federation.py): replicas advertise retained
        donors to a router-resident directory, and an admission whose
        prefix lives on ANOTHER replica fetches the pages over the
        KV-ship plane instead of re-prefilling — shared prompts
        prefill once per FLEET, not once per replica.  Requires
        paging; off keeps routing and reuse per-replica.
    prefix_fed_ttl_s: directory-entry liveness window — an
        advertisement older than this is treated as dead (a wedged
        replica's donors age out instead of attracting doomed
        fetches).
    prefix_fed_fetches: max concurrent federated fetches (the
        capacity gate): a directory hit past this budget dispatches
        normally and prefills locally rather than queueing behind the
        wire.
    """

    min_replicas: int = 1
    max_replicas: int = 1
    grow_queue_depth: float = 4.0
    grow_ttft_p99_ms: Optional[float] = None
    shrink_occupancy: float = 0.25
    patience_ticks: int = 2
    cooldown_s: float = 10.0
    tick_interval_s: float = 0.5
    sticky_slack: int = 1
    roles: "tuple[str, ...]" = ()
    kvship_codec: str = "fp8"
    prefix_fed: bool = False
    prefix_fed_ttl_s: float = 30.0
    prefix_fed_fetches: int = 2

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("fleet min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("fleet max_replicas must be >= min_replicas")
        if self.grow_queue_depth <= 0:
            raise ValueError("fleet grow_queue_depth must be > 0")
        if not (0.0 <= self.shrink_occupancy <= 1.0):
            raise ValueError("fleet shrink_occupancy must be in [0, 1]")
        if self.patience_ticks < 1:
            raise ValueError("fleet patience_ticks must be >= 1")
        if self.cooldown_s < 0:
            raise ValueError("fleet cooldown_s must be >= 0")
        if self.tick_interval_s <= 0:
            raise ValueError("fleet tick_interval_s must be > 0")
        if self.sticky_slack < 0:
            raise ValueError("fleet sticky_slack must be >= 0")
        object.__setattr__(self, "roles", tuple(self.roles))
        for r in self.roles:
            if r not in ("prefill", "decode", "pooled"):
                raise ValueError(
                    f"fleet role {r!r}: must be prefill/decode/pooled")
        from ray_lightning_tpu_torch.comm.quant import CODEC_MODES
        if self.kvship_codec not in CODEC_MODES + ("raw",):
            raise ValueError(
                f"kvship_codec {self.kvship_codec!r}: must be one of "
                f"{CODEC_MODES + ('raw',)}")
        if self.prefix_fed_ttl_s <= 0:
            raise ValueError("fleet prefix_fed_ttl_s must be > 0")
        if self.prefix_fed_fetches < 1:
            raise ValueError("fleet prefix_fed_fetches must be >= 1")

    # -- construction ----------------------------------------------------

    @classmethod
    def resolve(cls, value: Any) -> "FleetConfig":
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        if value is not None:
            raise TypeError(f"bad fleet config: {value!r}")
        ttft_raw = os.environ.get("RLT_FLEET_GROW_TTFT_MS", "").strip()
        return cls(
            min_replicas=int(os.environ.get("RLT_FLEET_MIN", "1") or 1),
            max_replicas=int(os.environ.get(
                "RLT_FLEET_MAX",
                os.environ.get("RLT_FLEET_MIN", "1") or "1") or 1),
            grow_queue_depth=float(
                os.environ.get("RLT_FLEET_GROW_QUEUE", "4") or 4),
            grow_ttft_p99_ms=float(ttft_raw) if ttft_raw else None,
            shrink_occupancy=float(
                os.environ.get("RLT_FLEET_SHRINK_OCC", "0.25") or 0.25),
            patience_ticks=int(
                os.environ.get("RLT_FLEET_PATIENCE", "2") or 2),
            cooldown_s=float(
                os.environ.get("RLT_FLEET_COOLDOWN", "10") or 10),
            tick_interval_s=float(
                os.environ.get("RLT_FLEET_TICK", "0.5") or 0.5),
            sticky_slack=int(
                os.environ.get("RLT_FLEET_STICKY_SLACK", "1") or 1),
            roles=tuple(
                r.strip()
                for r in os.environ.get("RLT_FLEET_ROLES", "").split(",")
                if r.strip()),
            kvship_codec=os.environ.get(
                "RLT_KVSHIP_CODEC", "fp8").strip() or "fp8",
            prefix_fed=os.environ.get(
                "RLT_FLEET_PREFIX_FED", "").strip()
            in ("1", "true", "True"),
            prefix_fed_ttl_s=float(os.environ.get(
                "RLT_FLEET_PREFIX_FED_TTL", "30") or 30),
            prefix_fed_fetches=int(os.environ.get(
                "RLT_FLEET_PREFIX_FED_FETCHES", "2") or 2),
        )

    # -- env round-trip --------------------------------------------------

    def worker_env(self) -> dict:
        """Env mapping reproducing this config via :meth:`resolve` in a
        worker process (tests/test_torch_fleet.py pins the round trip)."""
        env = {
            "RLT_FLEET_MIN": str(self.min_replicas),
            "RLT_FLEET_MAX": str(self.max_replicas),
            "RLT_FLEET_GROW_QUEUE": repr(self.grow_queue_depth),
            "RLT_FLEET_SHRINK_OCC": repr(self.shrink_occupancy),
            "RLT_FLEET_PATIENCE": str(self.patience_ticks),
            "RLT_FLEET_COOLDOWN": repr(self.cooldown_s),
            "RLT_FLEET_TICK": repr(self.tick_interval_s),
            "RLT_FLEET_STICKY_SLACK": str(self.sticky_slack),
        }
        if self.grow_ttft_p99_ms is not None:
            env["RLT_FLEET_GROW_TTFT_MS"] = repr(self.grow_ttft_p99_ms)
        if self.roles:
            env["RLT_FLEET_ROLES"] = ",".join(self.roles)
        if self.kvship_codec != "fp8":
            env["RLT_KVSHIP_CODEC"] = self.kvship_codec
        if self.prefix_fed:
            env["RLT_FLEET_PREFIX_FED"] = "1"
        if self.prefix_fed_ttl_s != 30.0:
            env["RLT_FLEET_PREFIX_FED_TTL"] = repr(self.prefix_fed_ttl_s)
        if self.prefix_fed_fetches != 2:
            env["RLT_FLEET_PREFIX_FED_FETCHES"] = \
                str(self.prefix_fed_fetches)
        return env

    def role_for(self, index: int) -> str:
        """Pool assignment for replica ``index``: the roles tuple,
        cycled so a fleet that outgrows it keeps a deterministic
        assignment; empty tuple = everything pooled."""
        if not self.roles:
            return "pooled"
        return self.roles[index % len(self.roles)]


__all__ = ["FleetConfig"]
