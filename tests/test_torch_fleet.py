"""PyTorch/CUDA port, the serving fleet: ``ray_lightning_tpu_torch/serve/
fleet/`` against the JAX package's ``serve/fleet/``.

Three tiers:

- host-side units: ``FleetConfig`` (validation, the env round trip),
  the ``Autoscaler``'s decisions on scripted signals under a fake
  clock, ``PrefixDirectory``, ``pick_replica`` and the peer
  ``Mailbox``, each driven by one script beside the JAX object;
- the router over scripted fake replicas (tests/test_fleet.py's
  harness): the REAL ``FleetServer`` of each package over its own
  ``Scheduler``, fabricated step results, the router pump, the KV-ship
  pool and the scale threads run in the test's thread, so each step is
  deterministic; for mixed load, quotas, failover, grow and shrink,
  drain, prefix affinity, federated fetches, a stale donor, peerdrop
  chaos and disaggregated roles the decision log (which replica took
  each request, what was exported, imported, requeued, failed, shipped
  or skipped, the counters) equals the JAX ``FleetServer``'s;
- real fleets of ``platform="cpu"`` serve actors: pooled, with the JAX
  engine's fp32 tokens (exact up to a 2e-5 near-tie); autoscale grow
  and shrink; failover after a killed worker.

JAX is imported inside the tests and fixtures only, so that importing
this module (as a worker does to unpickle a name of it) stays free of
JAX.
"""

import hashlib
import os
import signal
import threading
import time
import types

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch import FleetServer, GPTLightningModule, \
    flax_to_torch
from ray_lightning_tpu_torch.models.gpt import GPTConfig
from ray_lightning_tpu_torch.serve.fleet import (Autoscaler, FleetConfig,
                                                 FleetReplicaLost,
                                                 PrefixDirectory,
                                                 pick_replica)

#: the most a real fleet's request or event may take here
WAIT_S = 120


def _jax():
    import ray_lightning_tpu.cluster.peer as peer
    import ray_lightning_tpu.serve.fleet as fleet
    import ray_lightning_tpu.serve.fleet.router as router
    from ray_lightning_tpu.serve.scheduler import Scheduler
    return types.SimpleNamespace(fleet=fleet, router=router, peer=peer,
                                 Scheduler=Scheduler)


def _port():
    import ray_lightning_tpu_torch.cluster.peer as peer
    import ray_lightning_tpu_torch.serve.fleet as fleet
    import ray_lightning_tpu_torch.serve.fleet.router as router
    from ray_lightning_tpu_torch.serve.scheduler import Scheduler
    return types.SimpleNamespace(fleet=fleet, router=router, peer=peer,
                                 Scheduler=Scheduler)


PACKAGES = {"jax": _jax, "torch": _port}


# -- host-side units ------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {},
    {"min_replicas": 2, "max_replicas": 4, "grow_queue_depth": 1.5,
     "grow_ttft_p99_ms": 100.0, "cooldown_s": 3.0, "tick_interval_s": 0.2},
    {"roles": ("prefill", "decode"), "kvship_codec": "int8",
     "prefix_fed": True, "prefix_fed_ttl_s": 5.0, "prefix_fed_fetches": 3,
     "sticky_slack": 0, "shrink_occupancy": 0.5, "patience_ticks": 3},
], ids=["defaults", "scaling", "roles-federation"])
def test_fleet_config_env_round_trip_equals_jax(kw, monkeypatch):
    """The same fields give the same ``worker_env``, whose round trip
    through ``resolve(None)`` gives the config back in both packages,
    and the same role assignment."""
    jcfg = _jax().fleet.FleetConfig(**kw)
    cfg = FleetConfig(**kw)
    env = cfg.worker_env()
    assert env == jcfg.worker_env()
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert FleetConfig.resolve(None) == cfg
    assert [cfg.role_for(i) for i in range(5)] \
        == [jcfg.role_for(i) for i in range(5)]
    assert FleetConfig.resolve(dict(kw)) == cfg
    assert FleetConfig.resolve(cfg) is cfg


@pytest.mark.parametrize("kw, match", [
    ({"min_replicas": 0}, "min_replicas"),
    ({"min_replicas": 3, "max_replicas": 2}, "max_replicas"),
    ({"grow_queue_depth": 0}, "grow_queue_depth"),
    ({"shrink_occupancy": 1.5}, "shrink_occupancy"),
    ({"patience_ticks": 0}, "patience_ticks"),
    ({"cooldown_s": -1}, "cooldown_s"),
    ({"tick_interval_s": 0}, "tick_interval_s"),
    ({"sticky_slack": -1}, "sticky_slack"),
    ({"roles": ("prefill", "verify")}, "role"),
    ({"kvship_codec": "zstd"}, "kvship_codec"),
    ({"prefix_fed_ttl_s": 0}, "prefix_fed_ttl_s"),
    ({"prefix_fed_fetches": 0}, "prefix_fed_fetches"),
])
def test_fleet_config_refuses_what_jax_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        _jax().fleet.FleetConfig(**kw)
    with pytest.raises(ValueError, match=match):
        FleetConfig(**kw)
    with pytest.raises(TypeError):
        FleetConfig.resolve(3)


def test_autoscaler_decisions_equal_jax_on_a_script():
    """One scripted signal stream through both state machines under the
    same fake clock: every tick's decision, the actuation notes, the
    cooldowns and the event log are equal."""
    rng = np.random.default_rng(0)
    cfg = dict(min_replicas=1, max_replicas=3, grow_queue_depth=2.0,
               grow_ttft_p99_ms=50.0, shrink_occupancy=0.3,
               patience_ticks=2, cooldown_s=1.0)
    logs = []
    for pkg in (_jax(), _port()):
        clock = [0.0]
        auto = pkg.fleet.Autoscaler(pkg.fleet.FleetConfig(**cfg),
                                    clock=lambda: clock[0])
        replicas, log = 1, []
        for t in range(300):
            clock[0] = t * 0.25
            sig = {"replicas": replicas,
                   "queued": int(rng.integers(0, 12)) if t % 50 < 20 else 0,
                   "active": int(rng.integers(0, 8)),
                   "slots_total": 8 * replicas,
                   "ttft_p99_ms": float(rng.uniform(0, 80))
                   if t % 7 else None}
            d = auto.tick(sig)
            log.append((t, d, auto.in_cooldown, auto.actuating))
            if d is not None and t % 3:
                replicas += 1 if d["action"] == "grow" else -1
                auto.note_actuated(0.5 * (t % 5), ok=t % 11 != 0)
            elif d is not None:
                log.append(("pending", t))
        log.append([{k: e[k] for k in ("action", "reason", "seconds", "ok")}
                    for e in auto.events])
        st = auto.stats()
        log.append({k: st[k] for k in ("grows", "shrinks", "in_cooldown",
                                       "actuating")})
        logs.append(log)
        rng = np.random.default_rng(0)
    assert logs[0] == logs[1]
    assert any(e["action"] == "grow" for e in logs[1][-2])
    assert any(e["action"] == "shrink" for e in logs[1][-2])


def test_prefix_directory_equals_jax_on_a_script():
    """Register, re-register, look up (exclusion, longest match), affinity,
    invalidate, replica invalidation and ttl expiry under a fake clock:
    every answer and the stats equal the JAX directory's."""
    logs = []
    for pkg in (_jax(), _port()):
        rng = np.random.default_rng(1)
        clock = [0.0]
        d = pkg.fleet.PrefixDirectory(page_size=8, ttl_s=5.0,
                                      clock=lambda: clock[0])
        heads = [rng.integers(1, 50, 32) for _ in range(4)]
        log = []
        for step in range(400):
            clock[0] = step * 0.05
            op = rng.integers(0, 6)
            toks = np.concatenate([heads[rng.integers(0, 4)][
                :int(rng.integers(0, 33))], rng.integers(1, 50, 5)])
            rid, slot = int(rng.integers(0, 3)), int(rng.integers(0, 4))
            if op == 0:
                log.append(("reg", d.register(rid, slot, toks)))
            elif op == 1:
                log.append(("lookup", d.lookup(toks)))
            elif op == 2:
                log.append(("lookup-x", d.lookup(toks, exclude_rid=rid)))
            elif op == 3:
                log.append(("aff", sorted(d.affinity(toks).items())))
            elif op == 4:
                d.invalidate(rid, slot)
            elif step % 40 == 5:
                d.invalidate_replica(rid)
            log.append((d.entries(), d.pages()))
        log.append(d.stats())
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[1][-1]["hits"] > 10 and logs[1][-1]["invalidations"] > 5
    with pytest.raises(ValueError):
        PrefixDirectory(page_size=0)
    with pytest.raises(ValueError):
        PrefixDirectory(page_size=8, ttl_s=0)


def test_pick_replica_equals_jax_on_random_rows():
    """Random load rows (roles, saturation, ties), stickiness, slack,
    pools, spill and affinity: the same pick in both packages."""
    jpick = _jax().router.pick_replica
    rng = np.random.default_rng(2)
    assert pick_replica([]) is None
    for _ in range(3000):
        n = int(rng.integers(1, 5))
        rows = [{"rid": i, "active": int(rng.integers(0, 5)),
                 "queued": int(rng.integers(0, 3)), "slots": 4,
                 **({"role": ("prefill", "decode", "pooled")[
                     int(rng.integers(0, 3))]} if rng.random() < .7
                    else {})}
                for i in range(n)]
        kw = {"sticky_rid": int(rng.integers(0, 5))
              if rng.random() < .5 else None,
              "sticky_slack": int(rng.integers(0, 3)),
              "pool": ("prefill", "decode", None)[int(rng.integers(0, 3))],
              "spill": bool(rng.random() < .5),
              "affinity": {int(r): int(rng.integers(0, 3)) * 8
                           for r in rng.integers(0, 5, 2)}
              if rng.random() < .5 else None}
        assert pick_replica(rows, **kw) == jpick(rows, **kw), (rows, kw)


def test_mailbox_equals_jax(monkeypatch):
    """Out-of-order tagged delivery, a take that outlives its timeout
    (with and without ``RLT_PEER_RETRIES``): the same payloads, the same
    ``PeerTimeout`` message, and the bounded retries' count."""
    monkeypatch.setenv("RLT_PEER_BACKOFF_S", "0.001")
    for retries in ("0", "2"):
        monkeypatch.setenv("RLT_PEER_RETRIES", retries)
        msgs = []
        for pkg in (_jax(), _port()):
            box = pkg.peer.Mailbox()
            box.put(("a", 2), "two")
            box.put(("a", 1), {"one": 1})
            assert len(box) == 2
            assert box.take(("a", 1), 1.0) == {"one": 1}
            assert box.take(("a", 2), 1.0) == "two"
            t0 = time.monotonic()
            with pytest.raises(pkg.peer.PeerTimeout) as err:
                box.take(("a", 3), 0.02, who="decode replica 1",
                         src="prefill replica 0")
            assert time.monotonic() - t0 >= 0.02 * (int(retries) + 1)
            msgs.append(str(err.value))
            late = threading.Timer(0.05, box.put, (("b",), "late"))
            late.start()
            assert box.take(("b",), 5.0) == "late"
        assert msgs[0] == msgs[1]
        assert f"after {int(retries) + 1} attempt(s)" in msgs[1]


# -- the router over scripted fake replicas ---------------------------------------

class _SyncThread:
    """``threading.Thread`` whose ``start`` runs the target in the caller:
    the router's boot, grow, reap and shrink threads become steps of the
    test's script."""

    def __init__(self, target=None, args=(), kwargs=None, **_):
        self._run = lambda: target(*args, **(kwargs or {}))

    def start(self):
        self._run()

    def join(self, timeout=None):
        pass

    def is_alive(self):
        return False


class _Inline:
    """The KV-ship pool, run in the caller."""

    def submit(self, fn, *args):
        fn(*args)

    def shutdown(self, **_):
        pass


def _rows(n: int, seed: int) -> np.ndarray:
    """Fabricated donor rows [2 layers, 1, n, 2 heads, 4] (never all
    zeros)."""
    return (np.arange(2 * n * 8, dtype=np.float32).reshape(2, 1, n, 2, 4)
            / 7.0 + 1.0 + seed)


def _digest(a) -> str:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return hashlib.sha1(np.ascontiguousarray(a, np.float32).tobytes()
                        ).hexdigest()[:12]


class _Fake:
    """``Server``-surface double over a package's REAL ``Scheduler``:
    fabricated step results (first token 7, then 9; ship-bound
    prefills return fabricated rows), stepped by the test; every call
    the router makes is logged."""

    def __init__(self, pkg, log, rid, slots=2, paged=None):
        self.scheduler = pkg.Scheduler(buckets=(16, 32), slots=slots,
                                       max_seq_len=64,
                                       max_prefills_per_step=slots,
                                       default_max_new_tokens=3,
                                       paged=paged)
        self.buckets = (16, 32)
        self.log, self.rid = log, rid
        self._error = None
        self.failure_report = None
        self.started = False

    def start(self):
        self.started = True
        self.log.append(("start", self.rid))
        return self

    def step(self):
        plan = self.scheduler.plan()
        if plan is None:
            return None
        result = {"prefill": {p["slot"]: 7 for p in plan["prefills"]},
                  "decode": {}}
        for p in plan["prefills"]:
            if p.get("export_kv") is not None:
                b = p["export_kv"]["bucket"]
                result.setdefault("kv_export", {})[p["slot"]] = (
                    _rows(b, self.rid), _rows(b, self.rid + 10))
        if plan["decode"] is not None:
            result["decode"] = {s: 9 for s in plan["decode"]["slots"]}
        self.scheduler.apply(plan, result)
        return plan

    def submit(self, prompt, tenant="default", max_new_tokens=None,
               ship_kv=False):
        if self._error is not None:
            raise RuntimeError("replica failed") from self._error
        self.log.append(("submit", self.rid, tuple(int(t) for t in prompt),
                         tenant, max_new_tokens, ship_kv))
        return self.scheduler.submit(prompt, tenant=tenant,
                                     max_new_tokens=max_new_tokens,
                                     ship_kv=ship_kv)

    def can_ship_kv(self):
        return self.started and self.scheduler.pages is not None

    def can_adopt_kv(self):
        sched = self.scheduler
        if sched.pages is None:
            return False
        with sched._lock:
            return (sched.allocator.free_count > 0
                    or sched.pages.donor_count > 0)

    def export_kv(self, prompt_tokens, req_id=None):
        sched = self.scheduler
        if sched.pages is None or not self.started:
            return None
        if req_id is not None:
            boxed = sched.pop_kv_export(int(req_id))
            if boxed is not None:
                self.log.append(("export", self.rid, "outbox", boxed[2]))
                return boxed
        prompt_tokens = np.asarray(prompt_tokens, np.int32).reshape(-1)
        with sched._lock:
            hit = sched.pages.match(prompt_tokens)
        self.log.append(("export", self.rid, "match", hit))
        if hit is None:
            return None
        return _rows(32, self.rid), _rows(32, self.rid + 10), int(hit[1])

    def import_kv(self, prompt_tokens, k_rows, v_rows):
        prompt_tokens = np.asarray(prompt_tokens, np.int32).reshape(-1)
        slot = self.scheduler.adopt_imported(prompt_tokens)
        self.log.append(("import", self.rid, tuple(prompt_tokens.tolist()),
                         slot, _digest(k_rows), _digest(v_rows)))
        if slot is None:
            return False
        self.scheduler.adopt_commit(slot, prompt_tokens)
        return True

    def die(self, error):
        self.log.append(("die", self.rid))
        self._error = error
        self.failure_report = {"cause": repr(error),
                               "flight_paths": {0: "flight_0.json"}}
        self.scheduler.fail_all(error)

    def shutdown(self, graceful=True):
        self.log.append(("shutdown", self.rid, graceful))


class _Script:
    """One package's router over fakes, stepped by hand."""

    def __init__(self, name, monkeypatch, n=2, slots=2, paged=None,
                 **kw):
        self.pkg = PACKAGES[name]()
        monkeypatch.setattr(self.pkg.router, "threading", types.SimpleNamespace(
            Thread=_SyncThread, RLock=threading.RLock, Event=threading.Event,
            Lock=threading.Lock))
        self.log: list = []
        self.fakes: dict = {}
        if paged is not None:
            paged = self.pkg.fleet.PageConfig(True, paged.page_size)
        kw["paged"] = paged if paged is not None else False
        kw.setdefault("autoscale", False)

        def factory(rid):
            self.fakes[rid] = _Fake(self.pkg, self.log, rid, slots, paged)
            return self.fakes[rid]

        self.fleet = self.pkg.router.FleetServer(
            object(), replicas=n, telemetry=False, replica_factory=factory,
            **kw)
        self.fleet._pump_loop = lambda: None
        self.fleet._kvship_executor = lambda: _Inline()
        self.fleet.start()
        self.reqs: list = []

    def submit(self, prompt, tenant="default", **kw):
        fr = self.fleet.submit(np.asarray(prompt), tenant=tenant, **kw)
        self.reqs.append(fr)
        return fr

    def tick(self):
        f = self.fleet
        f._poll_completions()
        f._scan_failures()
        f._dispatch_pending()
        f._tick_autoscaler()

    def step(self, rids=None):
        for rid in sorted(self.fakes) if rids is None else rids:
            if rid in self.fakes and self.fakes[rid]._error is None:
                self.fakes[rid].step()

    def run(self, rounds=60, rids=None):
        for _ in range(rounds):
            self.tick()
            self.step(rids)
        self.tick()

    def record(self) -> list:
        f = self.fleet
        out = list(self.log)
        for fr in self.reqs:
            out.append(("request", fr.id, fr.replica, fr.requeues,
                        None if not fr.done() or fr.error is not None
                        else fr._tokens.tolist(),
                        None if fr.error is None
                        else (type(fr.error).__name__, str(fr.error),
                              getattr(fr.error, "flight_paths", None))))
        out.append(("failovers", [{k: e[k] for k in (
            "replica", "cause", "flight_paths", "requeued", "failed")}
            for e in f.failovers]))
        out.append(("counts", f.completed, f.failed, f.requeued,
                    dict(f._sticky), dict(f.kvship), dict(f.federation)))
        out.append(("autoscale", [{k: e[k] for k in ("action", "reason",
                                                     "ok")}
                                  for e in f.autoscaler.events]))
        out.append(("replicas", sorted((rid, r.state, r.role)
                                       for rid, r in f._replicas.items())))
        out.append(("pages", f.pages_stats()))
        if f.directory is not None:
            out.append(("directory", f.directory.stats()))
        return out

    def close(self):
        self.fleet.shutdown(graceful=False)


PAGED = types.SimpleNamespace(page_size=8)
SHARED = np.arange(1, 17)                       # two whole pages


def _mixed(s):
    for t in ("a", "b", "a", "b", "a", "b", "c", "c"):
        s.submit(np.arange(1, 6), tenant=t)
    s.run(30)


def _quota(s):
    for _ in range(5):
        s.submit(np.arange(1, 4), tenant="greedy")
    for _ in range(3):
        s.submit(np.arange(1, 4), tenant="quiet")
    peaks = []
    for _ in range(40):
        s.tick()
        peaks.append(s.fleet._tenant_inflight.get("greedy", 0))
        s.step()
    s.log.append(("greedy peaks", peaks))
    assert max(peaks) == 1


def _failover(s):
    for _ in range(3):
        s.submit(np.arange(1, 5), tenant="t")
    s.tick()
    s.fakes[0].step()                       # admit one (slots=1)
    s.fakes[0].die(RuntimeError("chaos: replica 0 lost"))
    s.run(20, rids=[1, 2])


def _grow_shrink(s):
    for i in range(3):
        s.submit(np.arange(1, 6) + i)
    s.tick()                                # dispatch, then a grow
    for i in range(3):
        s.submit(np.arange(10, 14) + i)
    s.run(30)
    s.submit(np.arange(1, 4))               # after the shrink
    s.run(10)


def _drain(s):
    for _ in range(4):
        s.submit(np.arange(1, 4))
    s.fleet._draining = True
    s.run(20)
    s.fleet.drain(timeout=1)
    with pytest.raises(RuntimeError, match="draining"):
        s.fleet.submit([1, 2])


def _seed_donor(s, prompt=SHARED):
    """One request served on replica 0, retained as a donor and
    advertised."""
    s.submit(prompt, tenant="alice")
    s.run(8, rids=[0])


def _affinity(s):
    """A prompt whose prefix replica 0 holds lands there (affinity beats
    least-loaded inside the slack); a cold one goes least-loaded."""
    _seed_donor(s)
    s.submit(np.arange(60, 70), tenant="carol")
    s.tick()
    s.submit(np.concatenate([SHARED, [99]]), tenant="bob")
    s.run(10)


def _federated(s):
    """Replica 0 busy, so slack-0 routing sends the shared prompt to
    replica 1, which pulls the pages over the KV-ship plane first."""
    _seed_donor(s)
    s.submit(np.arange(40, 52), tenant="carol")
    s.tick()
    s.fakes[0].step()
    s.submit(np.concatenate([SHARED, [99]]), tenant="bob")
    s.run(10)


def _stale(s):
    """The donor evicted behind the directory's back: the fetch finds no
    donor, heals the entry and the request prefills locally."""
    _seed_donor(s)
    pages = s.fakes[0].scheduler.pages
    slot = next(iter(pages._donors))
    pages._donors.pop(slot)
    pages.index.drop(slot)
    s.submit(np.arange(40, 52), tenant="carol")
    s.tick()
    s.fakes[0].step()
    s.submit(np.concatenate([SHARED, [99]]), tenant="bob")
    s.run(10)


def _chaos(s):
    """A dropped federated pull: bounded retries, then a local prefill;
    the live donor's advertisement stays."""
    s.fleet.arm_kvship_drop(1)
    _federated(s)


def _disagg(s):
    """A prefill and a decode replica: shared-prefix prompts ship their
    pages, a sub-page prompt stays pooled, a dropped ship fails over to
    a local prefill, and a burst past the decode replica's slots skips
    ships it could not adopt."""
    for i in range(3):
        s.submit(np.concatenate([SHARED, [20 + i]]), max_new_tokens=4)
        s.run(12)
    s.submit(np.arange(1, 7))
    s.run(12)
    s.fleet.arm_kvship_drop(1)
    s.submit(np.concatenate([SHARED, [20]]))
    s.run(12)
    for i in range(5):
        s.submit(np.concatenate([np.arange(30, 46) + i, [5]]))
    s.run(30)


SCRIPTS = {
    "mixed": (_mixed, {}),
    "quota": (_quota, {"tenant_quotas": {"greedy": 1}}),
    "failover": (_failover, {"slots": 1, "fleet": {"sticky_slack": 5}}),
    "grow-shrink": (_grow_shrink, {
        "n": 1, "slots": 1, "autoscale": True,
        "fleet": {"min_replicas": 1, "max_replicas": 2,
                  "grow_queue_depth": 1.0, "patience_ticks": 1,
                  "cooldown_s": 0.0, "tick_interval_s": 1e-6,
                  "shrink_occupancy": 0.01}}),
    "drain": (_drain, {"n": 1}),
    "affinity": (_affinity, {"paged": PAGED,
                             "fleet": {"prefix_fed": True,
                                       "sticky_slack": 1}}),
    "federated": (_federated, {"paged": PAGED,
                               "fleet": {"prefix_fed": True,
                                         "sticky_slack": 0}}),
    "stale-donor": (_stale, {"paged": PAGED,
                             "fleet": {"prefix_fed": True,
                                       "sticky_slack": 0}}),
    "chaos-peerdrop": (_chaos, {"paged": PAGED,
                                "fleet": {"prefix_fed": True,
                                          "sticky_slack": 0}}),
    "disagg-fp8": (_disagg, {"paged": PAGED, "fleet": {
        "roles": ("prefill", "decode"), "kvship_codec": "fp8"}}),
    "disagg-raw": (_disagg, {"paged": PAGED, "fleet": {
        "roles": ("prefill", "decode"), "kvship_codec": "raw"}}),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_router_decisions_equal_jax(script, monkeypatch):
    """The same script through both packages' ``FleetServer``: equal
    decision logs (every replica call, every request's replica,
    requeues, tokens or error, failovers, counters, autoscale events,
    replicas, prefix and directory stats)."""
    monkeypatch.setenv("RLT_PEER_RETRIES", "2")
    monkeypatch.setenv("RLT_PEER_BACKOFF_S", "0.001")
    monkeypatch.setenv("RLT_KVSHIP_TIMEOUT_S", "0.01")
    run, kw = SCRIPTS[script]
    records = {}
    for name in ("jax", "torch"):
        s = _Script(name, monkeypatch, **kw)
        try:
            run(s)
            records[name] = s.record()
        finally:
            s.close()
    assert records["torch"] == records["jax"]
    # and each script did what it is named for
    port, f = s, s.fleet
    last = {r[0]: r[1] for r in records["torch"]
            if r[0] in ("pages", "replicas")}
    pages = last["pages"]
    assert all(fr.done() for fr in port.reqs)
    if script == "failover":
        assert f.failovers[0]["requeued"] == 2 and f.failed == 1
        assert isinstance(port.reqs[0].error, FleetReplicaLost)
        assert [r[1] for r in last["replicas"]] == ["serving"] * 2
    elif script == "grow-shrink":
        acts = [e["action"] for e in f.autoscaler.events]
        assert "grow" in acts and "shrink" in acts and f.failed == 0
    elif script == "federated":
        assert f.federation["ships"] == 1
        assert pages["federated_tokens_reused"] == 16
    elif script == "stale-donor":
        assert f.federation["ships"] == 0 and f.directory.stats()[
            "invalidations"] == 1
    elif script == "chaos-peerdrop":
        assert f.federation["failovers"] == 1 \
            and f.federation["retries"] == 2
        assert f.directory.affinity(SHARED).get(0) == 16
    elif script.startswith("disagg"):
        kv = f.status()["fleet"]["kvship"]
        assert kv["ships"] >= 3 and kv["failovers"] == 1, kv
        assert kv["skipped"] > 0, kv
        assert kv["compression_ratio"] == (1.0 if script.endswith("raw")
                                           else 3.7647), kv
        assert [r["status"] for r in f.ship_log].count("ok") == kv["ships"]
    assert f.goodput_stats() is None


def test_router_refuses_what_is_not_ported(monkeypatch):
    """The telemetry plane and the RLT_FAULT form of peerdrop raise,
    naming their ROADMAP.md items."""
    with pytest.raises(NotImplementedError, match="item 13"):
        FleetServer(object(), telemetry={"metrics_port": 0})
    monkeypatch.setenv("RLT_FAULT", "peerdrop:rank=0,step=1,count=1")
    with pytest.raises(NotImplementedError, match="item 10"):
        FleetServer(object(), fleet={"roles": ("prefill", "decode")})
    monkeypatch.delenv("RLT_FAULT")
    fleet = FleetServer(object(), replicas=2)
    with pytest.raises(RuntimeError, match="start"):
        fleet.submit([1, 2])
    assert Autoscaler(fleet.cfg).stats()["grows"] == 0


# -- real fleets over CPU serve actors --------------------------------------------

TINY = dict(vocab_size=128, block_size=32, n_layer=2, n_head=2, n_embd=32,
            remat=False)
BUCKETS = (16, 32)
NEW_TOKENS = 6
PROMPTS = [np.concatenate([np.arange(1, 17), [20 + i]]) for i in range(6)] \
    + [np.arange(40, 45), np.arange(60, 80)]
TENANTS = ["alice", "bob"] * 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the CPU workers take."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX engine's fp32 params and greedy tokens for each prompt
    (one request at a time, dense decode), and its whole-sequence
    forward's next-token logits (the near-tie rule's reference)."""
    import jax
    import jax.numpy as jnp

    from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
    from ray_lightning_tpu.models.gpt import GPTLightningModule as JaxModule
    from ray_lightning_tpu.parallel.strategy import DataParallelStrategy
    from ray_lightning_tpu.serve.engine import ServeEngine as JaxEngine
    from ray_lightning_tpu.serve.scheduler import Scheduler as JaxScheduler
    from ray_lightning_tpu.serve.worker import ServeWorker as JaxWorker

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RLT_BF16_PARAMS", "0")
        mp.setenv("RLT_DECODE_IMPL", "dense")
        module = JaxModule(JaxConfig(**TINY, dtype=jnp.float32))
        eng = JaxEngine(module, DataParallelStrategy(), buckets=BUCKETS,
                        slots=4, max_seq_len=TINY["block_size"],
                        seed=0).setup()
        worker = JaxWorker()
        worker._engine = eng
        worker._rank = 0
        tokens = []
        for p in PROMPTS:
            sched = JaxScheduler(buckets=BUCKETS, slots=4,
                                 max_seq_len=TINY["block_size"],
                                 default_max_new_tokens=NEW_TOKENS)
            r = sched.submit(p)
            while not sched.idle():
                plan = sched.plan()
                sched.apply(plan, worker.serve_step(plan))
            tokens.append(r.result(1).tolist())
    params = jax.device_get(eng.params)
    jmodel = module.configure_decode_model()

    def logits(prompt, gen):
        seq = np.asarray([list(prompt) + list(gen[:-1])], np.int32)
        out = np.asarray(jmodel.apply({"params": params}, seq, True),
                         np.float32)
        return out[0, len(prompt) - 1:]

    return params, tokens, logits


def assert_tokens(got, want, prompt, logits, tol=2e-5):
    """fp32: the JAX engine's tokens up to the first step whose two
    greedy choices lie within ``tol`` (teacher-forced), each token the
    reference argmax or within ``tol`` of it."""
    ref = logits(prompt, got)
    for i, tok in enumerate(got):
        best = int(np.argmax(ref[i]))
        assert tok == best or ref[i][tok] >= ref[i][best] - tol, \
            (prompt, i, tok, best)
    n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             len(got))
    assert got[:n] == want[:n]
    if n < len(got):
        assert abs(ref[n][got[n]] - ref[n][want[n]]) <= tol, (got, want)


def _module(params):
    module = GPTLightningModule(GPTConfig(**TINY, dtype=torch.float32))
    module._trained_state = flax_to_torch(params)
    return module


def _kw(**extra):
    return dict(num_workers=1, platform="cpu", buckets=BUCKETS,
                max_batch_slots=4, max_new_tokens=NEW_TOKENS,
                paged={"page_size": 8}, **extra)


def test_pooled_fleet_serves_the_jax_engines_tokens(jax_reference,
                                                    monkeypatch):
    """Two pooled paged replicas behind the router (prefix reuse per
    replica): every request completes with the JAX engine's fp32 tokens,
    both replicas serve, the reuse counters move, and a drain then a
    shutdown leave nothing behind."""
    monkeypatch.setenv("RLT_BF16_PARAMS", "0")
    params, want, logits = jax_reference
    fleet = FleetServer(_module(params), replicas=2, autoscale=False,
                        tenant_quotas={"bob": 2}, **_kw()).start()
    try:
        reqs = [fleet.submit(p, tenant=t) for p, t in zip(PROMPTS, TENANTS)]
        got = [r.result(WAIT_S).tolist() for r in reqs]
        fleet.drain(timeout=WAIT_S)
        st = fleet.status()["fleet"]
        pages = fleet.pages_stats()
    finally:
        fleet.shutdown()
    for p, g, w in zip(PROMPTS, got, want):
        assert_tokens(g, w, p, logits)
    assert st["completed"] == len(PROMPTS) and st["failed"] == 0
    assert {r.replica for r in reqs} == {0, 1}
    assert pages["prefix_hits"] > 0 and pages["prefix_reuse_ratio"] > 0
    assert "kvship" not in st and not fleet._replicas


def test_fleet_autoscales_up_and_down(jax_reference, monkeypatch):
    """One replica, bounds [1, 2]: a burst grows the fleet, the idle tail
    shrinks it back, no request is lost, tokens hold, and a late request
    lands on the survivor."""
    monkeypatch.setenv("RLT_BF16_PARAMS", "0")
    params, want, logits = jax_reference
    fleet = FleetServer(_module(params), replicas=1, fleet={
        "min_replicas": 1, "max_replicas": 2, "grow_queue_depth": 1.0,
        "patience_ticks": 1, "cooldown_s": 0.2, "tick_interval_s": 0.05},
        **_kw()).start()
    try:
        reqs = [fleet.submit(p, tenant=t)
                for p, t in zip(PROMPTS * 2, TENANTS * 2)]
        got = [r.result(WAIT_S).tolist() for r in reqs]
        deadline = time.monotonic() + WAIT_S
        while fleet.autoscaler.stats()["shrinks"] < 1 \
                or len(fleet._replicas) != 1:
            assert time.monotonic() < deadline, fleet.autoscaler.stats()
            time.sleep(0.05)
        late = fleet.generate(PROMPTS[0], timeout=WAIT_S).tolist()
        events = fleet.autoscaler.stats()["events"]
    finally:
        fleet.shutdown()
    assert [e["action"] for e in events][:2] == ["grow", "shrink"]
    assert all(e["ok"] and e["seconds"] is not None for e in events)
    assert fleet.failed == 0 and not fleet.failovers
    for p, g, w in zip(PROMPTS * 2 + [PROMPTS[0]], got + [late],
                       want * 2 + [want[0]]):
        assert_tokens(g, w, p, logits)


def test_fleet_fails_over_a_killed_worker(jax_reference, monkeypatch):
    """A replica's worker killed while it holds admitted and queued
    requests: its queued ones complete on the survivor with the JAX
    engine's tokens, its admitted ones fail with ``FleetReplicaLost``
    caused by the worker's death, and the fleet grows back to two."""
    monkeypatch.setenv("RLT_BF16_PARAMS", "0")
    params, want, logits = jax_reference
    fleet = FleetServer(_module(params), replicas=2, autoscale=False,
                        fleet={"sticky_slack": 100}, **_kw()).start()
    try:
        victim = fleet._replicas[0]
        pid = victim.server.stats()["workers"][0]["pid"]
        sched = victim.server.scheduler
        # one tenant, a wide slack: every request sticks to replica 0
        reqs = [fleet.submit(p, tenant="t", max_new_tokens=24)
                for p in PROMPTS * 2]
        deadline = time.monotonic() + WAIT_S
        while not (sched.queued_count and sched.active_count):
            assert time.monotonic() < deadline
            time.sleep(0.001)
        os.kill(pid, signal.SIGKILL)
        outcomes = []
        for r in reqs:
            try:
                outcomes.append(r.result(WAIT_S).tolist())
            except FleetReplicaLost as e:
                assert "died" in repr(e.__cause__), repr(e.__cause__)
                outcomes.append(None)
        while sum(r.state == "serving"
                  for r in fleet._replicas.values()) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        event = fleet.failovers[0]
    finally:
        fleet.shutdown(graceful=False)
    lost = outcomes.count(None)
    assert lost >= 1 and event["failed"] == lost and event["requeued"] >= 1
    assert event["replica"] == 0 and "died" in event["cause"]
    for p, g in zip(PROMPTS * 2, outcomes):
        if g is not None:
            assert len(g) == min(24, TINY["block_size"] - len(p) + 1)
            ref = logits(p, g)
            for i, tok in enumerate(g):
                best = int(np.argmax(ref[i]))
                assert tok == best or ref[i][tok] >= ref[i][best] - 2e-5
    for p, g, w in zip(PROMPTS, outcomes, want):
        if g is not None:
            assert_tokens(g[:NEW_TOKENS], w, p, logits)
