"""Fleet-plane selfcheck: ``python -m
ray_lightning_tpu_torch.serve.fleet.selfcheck``.

Counterpart of ``ray_lightning_tpu/serve/fleet/selfcheck.py``: cheap,
deterministic, no pytest, on the CPU; it asserts the invariants that
would otherwise fail only deep inside a live fleet:

1. ``FleetConfig`` / ``PageConfig`` validation and the ``RLT_FLEET*`` /
   ``RLT_SERVE_PAGED*`` env round trip (replica actors inherit the
   fleet's config);
2. page free-list accounting: ``free + allocated == total`` through
   allocation, lazy growth, donor retention and eviction;
3. the prefix-hash round trip: the longest page-aligned match, exact
   token verification (a forged hash collision must NOT donate), drop;
4. the autoscaler's cooldown state machine: patience, cooldown after an
   actuation, min/max bounds;
5. the router's policy: least-loaded pick, tenant stickiness within the
   slack only, prefix affinity beating both inside the same slack, the
   fleet-wide quota under a simulated dispatch loop, and the
   disaggregation pools with their failback to pooled routing;
6. the KV-ship codecs' wire bytes and round trips;
7. the federation directory: register -> lookup -> invalidate, liveness
   expiry on an injected clock, hash and exact-token agreement, and a
   size bounded by the retained pages.

The JAX selfcheck also holds the ``rlt_fleet_*`` metric names to the
metrics lint; the port's metrics plane is a stub until ROADMAP.md
queue 1 item 13, so that check waits for it.
"""

from __future__ import annotations

import os


def _check_config_roundtrip() -> None:
    from ray_lightning_tpu_torch.serve.fleet.config import FleetConfig
    from ray_lightning_tpu_torch.serve.fleet.pages import PageConfig

    cfg = FleetConfig(min_replicas=2, max_replicas=5,
                      grow_queue_depth=3.5, grow_ttft_p99_ms=250.0,
                      shrink_occupancy=0.2, patience_ticks=3,
                      cooldown_s=7.5, tick_interval_s=0.25,
                      sticky_slack=2, roles=("prefill", "decode"),
                      kvship_codec="int8", prefix_fed=True,
                      prefix_fed_ttl_s=12.5, prefix_fed_fetches=3)
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith(("RLT_FLEET", "RLT_SERVE_PAGE",
                              "RLT_KVSHIP"))}
    try:
        os.environ.update(cfg.worker_env())
        assert FleetConfig.resolve(None) == cfg, FleetConfig.resolve(None)
        for k in cfg.worker_env():
            del os.environ[k]
        pc = PageConfig(enabled=True, page_size=32)
        os.environ.update(pc.worker_env())
        assert PageConfig.resolve(None) == pc
        for k in pc.worker_env():
            del os.environ[k]
        assert PageConfig.resolve(None) == PageConfig(enabled=False)
        assert not PageConfig(enabled=False).worker_env()
    finally:
        for k in list(os.environ):
            if k.startswith(("RLT_FLEET", "RLT_SERVE_PAGE",
                             "RLT_KVSHIP")):
                del os.environ[k]
        os.environ.update(saved)
    # role cycling: a fleet that outgrows the tuple stays deterministic
    assert [cfg.role_for(i) for i in range(4)] == \
        ["prefill", "decode", "prefill", "decode"]
    assert FleetConfig().role_for(3) == "pooled"
    for bad in (dict(min_replicas=0), dict(max_replicas=0),
                dict(patience_ticks=0), dict(tick_interval_s=0),
                dict(roles=("prefill", "verify")),
                dict(kvship_codec="zstd"),
                dict(prefix_fed_ttl_s=0.0),
                dict(prefix_fed_fetches=0)):
        try:
            FleetConfig(**bad)
        except ValueError:
            pass
        else:
            raise AssertionError(f"expected ValueError for {bad}")
    print("fleet selfcheck: FleetConfig/PageConfig env round-trip OK")


def _check_page_pool() -> None:
    from ray_lightning_tpu_torch.serve.fleet.pages import PagePool

    pool = PagePool(slots=4, max_seq_len=32, page_size=8)
    assert pool.total_pages == 16 and pool.free == 16
    pool.note_written(0, 9)          # 2 pages
    pool.note_written(0, 5)          # never shrinks below high water
    assert pool.held(0) == 2
    pool.note_written(1, 32)         # the whole slot
    pool.check()
    assert pool.free == 16 - 2 - 4
    freed = pool.shrink_to(1, 16)    # donor keeps its 2 prefix pages
    assert freed == 2 and pool.held(1) == 2
    pool.check()
    assert pool.release(1) == 2 and pool.release(1) == 0
    pool.check()
    assert pool.free == 14
    print("fleet selfcheck: page free-list accounting OK")


def _check_prefix_index() -> None:
    import numpy as np

    from ray_lightning_tpu_torch.serve.fleet.pages import (PrefixIndex,
                                                     _prefix_hash)

    idx = PrefixIndex(page_size=4)
    base = np.arange(100, 120, dtype=np.int32)
    assert idx.register(0, base, limit=19) == 16   # whole pages under 19
    hit = idx.lookup(np.concatenate([base[:8], [7, 7, 7, 7]]))
    assert hit == (0, 8), hit
    hit = idx.lookup(base)                          # longest wins
    assert hit == (0, 16), hit
    assert idx.lookup(np.arange(5, dtype=np.int32)) is None
    # forged collision: same bucket, different tokens must NOT donate
    other = base[:4].copy()
    other[0] = 999
    forged = _prefix_hash(other[:4])
    idx._by_hash.setdefault(forged, set()).add(0)
    assert idx.lookup(other) is None, "collision donated"
    del idx._by_hash[forged]
    idx.drop(0)
    assert idx.lookup(base) is None and not idx._by_hash
    print("fleet selfcheck: prefix-hash round-trip + collision "
          "verification OK")


def _check_autoscaler() -> None:
    from ray_lightning_tpu_torch.serve.fleet.autoscale import Autoscaler
    from ray_lightning_tpu_torch.serve.fleet.config import FleetConfig

    clock = [0.0]
    a = Autoscaler(FleetConfig(min_replicas=1, max_replicas=3,
                               grow_queue_depth=2, patience_ticks=2,
                               cooldown_s=5.0, shrink_occupancy=0.5),
                   clock=lambda: clock[0])
    hot = {"replicas": 1, "queued": 10, "active": 4, "slots_total": 4}
    idle = {"replicas": 2, "queued": 0, "active": 0, "slots_total": 8}
    assert a.tick(hot) is None, "patience ignored"
    d = a.tick(hot)
    assert d == {"action": "grow",
                 "reason": d["reason"]} and "queue_depth" in d["reason"]
    assert a.tick(hot) is None, "decided while actuating"
    a.note_actuated(1.5, True)
    assert a.events[-1]["seconds"] == 1.5 and a.events[-1]["ok"]
    clock[0] = 2.0
    for _ in range(4):
        assert a.tick(hot) is None, "cooldown ignored"
    clock[0] = 10.0
    assert a.tick(idle) is None
    d = a.tick(idle)
    assert d is not None and d["action"] == "shrink", d
    a.note_actuated(0.5, True)
    clock[0] = 100.0
    # bounds: no shrink below min, no grow above max
    for _ in range(5):
        assert a.tick({"replicas": 1, "queued": 0, "active": 0,
                       "slots_total": 4}) is None
        assert a.tick({"replicas": 3, "queued": 99, "active": 12,
                       "slots_total": 12}) is None
    st = a.stats()
    assert st["grows"] == 1 and st["shrinks"] == 1
    print("fleet selfcheck: autoscaler patience/cooldown/bounds OK")


def _check_router_policy() -> None:
    from ray_lightning_tpu_torch.serve.fleet.router import pick_replica

    rows = [{"rid": 0, "active": 2, "queued": 0, "slots": 4},
            {"rid": 1, "active": 0, "queued": 3, "slots": 4},
            {"rid": 2, "active": 0, "queued": 1, "slots": 4}]
    assert pick_replica(rows) == 2, "least-loaded violated"
    # sticky wins inside slack...
    assert pick_replica(rows, sticky_rid=1, sticky_slack=2) == 1
    # ...but never past it
    assert pick_replica(rows, sticky_rid=0, sticky_slack=1) == 2
    assert pick_replica([], sticky_rid=0) is None
    # prefix affinity: the replica measured to hold the prefix wins
    # inside the slack (even over stickiness)...
    assert pick_replica(rows, sticky_slack=2, affinity={1: 8}) == 1
    assert pick_replica(rows, sticky_rid=2, sticky_slack=2,
                        affinity={1: 8}) == 1
    # ...longest prefix beats a shorter one...
    assert pick_replica(rows, sticky_slack=2,
                        affinity={1: 16, 2: 8}) == 1
    # ...but never past the slack: pages can be FETCHED instead
    assert pick_replica(rows, sticky_slack=1, affinity={0: 8}) == 2

    # fleet-wide quota conservation under a simulated dispatch loop:
    # 8 requests from one quota-2 tenant over 3 replicas — dispatched
    # in-flight never exceeds the quota, every request eventually runs
    quota, inflight, done, pending = 2, [], 0, list(range(8))
    sticky = None
    while pending or inflight:
        while pending and len(inflight) < quota:
            rid = pick_replica(rows, sticky)
            inflight.append((pending.pop(0), rid))
            sticky = rid
            assert len(inflight) <= quota, "quota violated"
        done += 1
        inflight.pop(0)
    assert done == 8
    print("fleet selfcheck: router least-loaded/sticky/quota OK")


def _check_pool_routing() -> None:
    """Disaggregation pools: ``pool=`` restricts routing to one role;
    an EMPTY pool falls back to every row (a drained/failed role pool
    degrades to pooled routing instead of stranding requests)."""
    from ray_lightning_tpu_torch.serve.fleet.router import pick_replica

    rows = [{"rid": 0, "active": 3, "queued": 0, "slots": 4,
             "role": "prefill"},
            {"rid": 1, "active": 0, "queued": 0, "slots": 4,
             "role": "decode"},
            {"rid": 2, "active": 1, "queued": 0, "slots": 4,
             "role": "prefill"}]
    assert pick_replica(rows, pool="prefill") == 2   # busier 0 loses
    assert pick_replica(rows, pool="decode") == 1
    # decode pool emptied -> failback to pooled (least-loaded overall)
    no_decode = [r for r in rows if r["role"] != "decode"]
    assert pick_replica(no_decode, pool="decode") == 2
    # rows without a role key count as pooled, never as a named pool
    bare = [{"rid": 7, "active": 0, "queued": 0, "slots": 4}]
    assert pick_replica(bare + rows, pool="prefill") == 2
    assert pick_replica(bare, pool="prefill") == 7   # failback again
    print("fleet selfcheck: pool routing + empty-pool failback OK")


def _check_kvship_codecs() -> None:
    """KV wire bytes by codec: fp8 / int8 pages ride the wire at >= 3x
    under the raw (fp32) control leg, and every codec round-trips
    shape-exact (bit-exact for raw: the ship -> resume parity leg
    tests/test_torch_kvship.py holds end to end)."""
    import torch

    from ray_lightning_tpu_torch.comm.quant import (dequantize_blob,
                                                    quantize_blob)
    rows = (torch.arange(2 * 1 * 64 * 2 * 16, dtype=torch.float32)
            .reshape(2, 1, 64, 2, 16) / 777.0 - 1.1).to(torch.bfloat16)
    raw_payload, _ = quantize_blob(rows, "raw")
    raw_bytes = raw_payload.numel() * raw_payload.element_size()
    assert raw_bytes == rows.numel() * 4, "raw control leg must be fp32"
    for codec in ("fp8", "int8"):
        payload, scales = quantize_blob(rows, codec)
        wire = payload.numel() * payload.element_size() + (
            scales.numel() * scales.element_size()
            if scales is not None else 0)
        ratio = raw_bytes / wire
        assert ratio >= 3.0, (codec, ratio)
        back = dequantize_blob(payload, scales, codec, rows.shape)
        assert tuple(back.shape) == tuple(rows.shape), (codec, back.shape)
    back = dequantize_blob(raw_payload, None, "raw",
                           rows.shape).to(torch.bfloat16)
    assert torch.equal(back, rows), "raw roundtrip not bit-exact"
    print("fleet selfcheck: kvship codec wire-bytes >= 3x + "
          "roundtrip OK")


def _check_federation_directory() -> None:
    """Federation directory invariants: register → lookup →
    invalidate round-trip, liveness expiry (injected clock), forged
    hash collisions never route, size bounded by retained pages."""
    import numpy as np

    from ray_lightning_tpu_torch.serve.fleet.federation import PrefixDirectory
    from ray_lightning_tpu_torch.serve.fleet.pages import _prefix_hash

    clock = [0.0]
    d = PrefixDirectory(page_size=4, ttl_s=10.0, clock=lambda: clock[0])
    base = np.arange(200, 220, dtype=np.int32)
    assert d.register(0, 1, base[:9]) == 8      # whole pages only
    assert d.register(1, 0, base) == 20
    hit = d.lookup(base)
    assert hit == (1, 0, 20), hit               # longest wins
    hit = d.lookup(np.concatenate([base[:8], [5, 5, 5, 5]]),
                   exclude_rid=1)
    assert hit == (0, 1, 8), hit                # exclusion honored
    # hash/exact-token agreement: a forged collision must NOT route
    other = base[:4].copy()
    other[0] = 999
    forged = _prefix_hash(other[:4])
    d._by_hash.setdefault(forged, set()).add((0, 1))
    assert d.lookup(other) is None, "collision routed a fetch"
    d._by_hash.pop(forged, None)
    # affinity mirrors lookup, per replica
    aff = d.affinity(base)
    assert aff == {0: 8, 1: 20}, aff
    # size bounded: re-registration REPLACES (one entry per donor slot)
    d.register(1, 0, base[:12])
    assert d.entries() == 2 and d.pages() == 2 + 3
    # invalidation round-trip
    d.invalidate(0, 1)
    assert d.lookup(base[:8]) == (1, 0, 8)
    d.invalidate_replica(1)
    assert d.lookup(base) is None
    assert d.entries() == 0 and not d._by_hash
    # liveness: entries past ttl_s are dead AND get pruned in passing
    d.register(2, 3, base[:8])
    clock[0] = 11.0
    assert d.lookup(base) is None
    assert d.entries() == 0, "expired entry not pruned"
    st = d.stats()
    assert st["hits"] == 3 and st["invalidations"] == 2, st
    print("fleet selfcheck: federation directory register/lookup/"
          "invalidate + liveness expiry OK")


def run() -> int:
    _check_config_roundtrip()
    _check_page_pool()
    _check_prefix_index()
    _check_autoscaler()
    _check_router_policy()
    _check_pool_routing()
    _check_kvship_codecs()
    _check_federation_directory()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(run())
