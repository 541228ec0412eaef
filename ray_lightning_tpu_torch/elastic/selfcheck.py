"""Elastic-plane selfcheck (``python -m
ray_lightning_tpu_torch.elastic.selfcheck``).

Counterpart of ``ray_lightning_tpu/elastic/selfcheck.py`` without its
metric-name check, which waits for the metrics plane (ROADMAP.md queue
1 item 13), as ``comm/selfcheck.py`` does.  Cheap and deterministic,
no pytest: it holds the invariants that would otherwise fail only deep
inside a shrinking fleet:

1. ``ElasticConfig`` validation and the ``RLT_ELASTIC*`` round trip
   (``worker_env`` then ``resolve`` gives the config back);
2. fault-spec parsing (every kind round-trips, semicolon lists parse, a
   malformed spec raises naming the bad clause);
3. the residual re-bucket keeps the injected-error sum ``(1/M) * sum(new)
   = (1/N) * sum(old)``;
4. the XOR parity: encode, drop any one rank, decode, bit for bit at
   several (world, k), and every rank's blob held by exactly k holders.
"""

from __future__ import annotations


def _check_config() -> None:
    import os
    from ray_lightning_tpu_torch.elastic.config import ElasticConfig

    cfg = ElasticConfig(enabled=True, snapshot_every_n_steps=25,
                        snapshot_dir="/tmp/ck", max_restarts=3,
                        min_workers=2, preserve_global_batch=False,
                        max_to_keep=5, redundancy=2,
                        redundancy_every_n_steps=4,
                        max_snapshot_failures=7)
    saved = {k: os.environ.get(k) for k in list(os.environ)
             if k.startswith("RLT_ELASTIC")}
    try:
        for k in saved:
            os.environ.pop(k, None)
        os.environ.update(cfg.worker_env())
        assert ElasticConfig.resolve(None) == cfg, "env round-trip drifted"
    finally:
        for k in list(os.environ):
            if k.startswith("RLT_ELASTIC"):
                os.environ.pop(k, None)
        os.environ.update({k: v for k, v in saved.items() if v is not None})
    assert not ElasticConfig.resolve(None).enabled
    assert ElasticConfig.resolve({"snapshot_every_n_steps": 5}).enabled
    for bad in (dict(snapshot_every_n_steps=-1), dict(min_workers=0),
                dict(max_restarts=-1), dict(max_to_keep=0),
                dict(redundancy=-1), dict(redundancy_every_n_steps=0),
                dict(max_snapshot_failures=0)):
        try:
            ElasticConfig(enabled=True, **bad)
        except ValueError:
            pass
        else:
            raise AssertionError(f"expected ValueError for {bad}")
    print("elastic selfcheck: config validation + env round-trip OK")


def _check_faults() -> None:
    from ray_lightning_tpu_torch.elastic.faults import (FaultSpec,
                                                        parse_fault,
                                                        parse_faults)

    s = parse_fault("kill:rank=1,step=5,code=9")
    assert s == FaultSpec("kill", 1, 5, exit_code=9)
    assert s.should_fire(1, 5) and s.should_fire(1, 6)
    assert not s.should_fire(0, 5) and not s.should_fire(1, 4)
    assert parse_fault("wedge:rank=0,step=2").kind == "wedge"
    slow = parse_fault("slow:rank=2,step=3,seconds=0.5")
    assert slow.seconds == 0.5
    assert parse_fault(s.describe()) == s
    snap = parse_fault("snapkill:rank=1,step=4")
    assert snap.kind == "snapkill" and parse_fault(snap.describe()) == snap
    drop = parse_fault("peerdrop:rank=0,step=3,count=2")
    assert drop.count == 2 and parse_fault(drop.describe()) == drop
    once = parse_fault("kill:rank=0,step=5,restart=0")
    assert once.restart == 0 and parse_fault(once.describe()) == once
    assert once.should_fire(0, 5, restarts=0)
    assert not once.should_fire(0, 5, restarts=1)
    specs = parse_faults("kill:rank=1,step=5; kill:rank=2,step=5")
    assert [x.rank for x in specs] == [1, 2]
    try:
        parse_faults("kill:rank=1,step=5;boom:rank=2,step=5")
    except ValueError as e:
        assert "boom:rank=2,step=5" in str(e), e
    else:
        raise AssertionError("bad clause in a list did not raise")
    for bad in ("kill", "boom:rank=1,step=2", "kill:rank=1",
                "kill:rank=1,step=0", "kill:rank=-1,step=2",
                "kill:rank=1;step=2", "peerdrop:rank=0,step=1,count=0"):
        try:
            parse_fault(bad)
        except ValueError:
            pass
        else:
            raise AssertionError(f"expected ValueError for {bad!r}")
    print("elastic selfcheck: fault-spec parsing OK")


def _check_rebucket() -> None:
    import torch
    from ray_lightning_tpu_torch.elastic.reshard import _rebucket

    old = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)}
    for m in (1, 2, 6):
        got = _rebucket(old, m)["w"]
        assert got.shape == (m, 4)
        torch.testing.assert_close(got.sum(0) / m, old["w"].sum(0) / 3,
                                   rtol=1e-6, atol=0)
    print("elastic selfcheck: residual re-bucket preserves the "
          "injected-error sum")


def _check_parity() -> None:
    import numpy as np
    from ray_lightning_tpu_torch.elastic.redundancy import (ParityGroup,
                                                            recover_block,
                                                            xor_blocks)

    rng = np.random.default_rng(7)
    for world, k in ((2, 1), (3, 1), (3, 2), (5, 2), (4, 3)):
        blobs = [rng.bytes(64 + 13 * r) for r in range(world)]
        held_by: dict = {r: [] for r in range(world)}
        for r in range(world):
            g = ParityGroup(r, world, k)
            assert g.holders == [(r - 1 - i) % world for i in range(g.k)]
            for m in g.covers:
                held_by[m].append(r)
        kk = min(k, world - 1)
        assert all(len(v) == kk for v in held_by.values()), held_by
        for dead in range(world):
            holder = ParityGroup.holder_of(dead, world, k)
            g = ParityGroup(holder, world, k)
            assert dead in g.covers
            parity = xor_blocks([blobs[m] for m in g.covers])
            others = [blobs[m] for m in g.covers if m != dead]
            got = recover_block(parity, others, len(blobs[dead]))
            assert got == blobs[dead], (world, k, dead)
    print("elastic selfcheck: XOR parity encode -> drop one -> decode "
          "bit-exact for every rank position")


def _main(argv: list) -> int:
    del argv
    _check_config()
    _check_faults()
    _check_rebucket()
    _check_parity()
    return 0


if __name__ == "__main__":   # pragma: no cover - run as a module
    import sys
    sys.exit(_main(sys.argv[1:]))
