"""Serve-plane selfcheck: ``python -m ray_lightning_tpu_torch.serve.selfcheck``.

Counterpart of ``ray_lightning_tpu/serve/selfcheck.py``: cheap,
deterministic, no pytest, on the CPU; it asserts the invariants that
would otherwise fail only deep inside a live fleet:

1. bucket resolution and padding (the static-shape contract);
2. the scheduler's invariants in a simulated multi-tenant run on a fake
   fleet: unique slots, the per-tenant quota, fair progress (no tenant
   starved), every request completed;
3. the speculative fold's accounting with fabricated draft and verify
   results (``emitted == accepted + corrected``, accept-0, accept-k,
   mid-prefix, the ``max_new`` cut) and its fallback to plain decode;
4. the prefill, decode, draft and verify programs run on a tiny model
   on the CPU (the JAX check lowers them on a CPU mesh; here a step is
   eager code, so running it once at a tiny size is the check);
5. a layout's KV blocks (parallel/strategy.py ``kv_cache_block``) on a
   ``tensor=2`` mesh, and on ``data=2 x tensor=2``, cover every (slot,
   head) of the cache exactly once, and a ``sequence`` axis's ranks
   hold the same block (replicas); the ranks' bytes add up to the
   cache's;
6. the planner's speculative cost model (plan/cost.py
   ``expected_accepted``, ``speculative_speedup``).

The JAX selfcheck also checks the serve metric names on the metrics
lint; the serve metrics wait for the metrics plane (ROADMAP.md queue 1
item 13).
"""

from __future__ import annotations

import sys


def _check_buckets() -> None:
    from ray_lightning_tpu_torch.serve.buckets import (bucket_for,
                                                       pad_to_bucket,
                                                       resolve_buckets)
    bs = resolve_buckets(None, 300)
    assert bs[-1] == 300 and list(bs) == sorted(bs), bs
    assert resolve_buckets((16, 64), 64) == (16, 64)
    assert bucket_for(1, bs) == bs[0]
    assert bucket_for(33, (32, 64)) == 64
    for bad in (lambda: bucket_for(65, (32, 64)),
                lambda: resolve_buckets((128,), 64),
                lambda: resolve_buckets((), 64)):
        try:
            bad()
        except ValueError:
            pass
        else:
            raise AssertionError("expected ValueError")
    padded = pad_to_bucket([5, 6, 7], 8)
    assert padded.shape == (1, 8) and list(padded[0, :3]) == [5, 6, 7]
    print("serve selfcheck: bucket resolution + padding OK")


def _check_scheduler() -> None:
    import numpy as np

    from ray_lightning_tpu_torch.serve.scheduler import Scheduler

    sched = Scheduler(buckets=(8, 16), slots=4, max_seq_len=32,
                      quotas={"greedy": 1}, max_prefills_per_step=2,
                      default_max_new_tokens=4)
    reqs = []
    for i in range(6):
        reqs.append(sched.submit(np.arange(1, 4 + i % 3), tenant="greedy"))
        reqs.append(sched.submit(np.arange(1, 5), tenant="quiet"))
    steps = 0
    while not sched.idle():
        steps += 1
        assert steps < 200, "scheduler failed to converge"
        plan = sched.plan()
        if plan is None:
            break
        live = sched.allocator.in_use()
        assert len(live) == len(set(live)) <= 4
        greedy = sched.stats()["per_tenant"].get("greedy", {})
        assert greedy.get("active", 0) <= 1, "quota violated"
        result = {"prefill": {p["slot"]: 7 for p in plan["prefills"]},
                  "decode": {}}
        if plan["decode"] is not None:
            result["decode"] = {s: 9 for s in plan["decode"]["slots"]}
        sched.apply(plan, result)
    assert all(r.done() for r in reqs), "requests starved"
    assert sched.completed == len(reqs)
    st = sched.stats()
    assert st["per_tenant"]["quiet"]["served_tokens"] > 0
    assert 0 < st["batch_occupancy"] <= 1.0
    print(f"serve selfcheck: scheduler invariants OK "
          f"({sched.completed} requests in {steps} steps, occupancy "
          f"{st['batch_occupancy']:.2f})")


def _check_spec_fold() -> None:
    import numpy as np

    from ray_lightning_tpu_torch.serve.scheduler import Scheduler
    from ray_lightning_tpu_torch.serve.spec import SpecConfig

    spec = SpecConfig(enabled=True, k=3, window=4, min_accept=0.5)
    sched = Scheduler(buckets=(8, 16), slots=2, max_seq_len=32,
                      default_max_new_tokens=7, spec=spec)
    req = sched.submit(np.arange(1, 5))
    plan = sched.plan()
    assert plan["prefills"] and plan["prefills"][0]["draft"], plan
    slot = plan["prefills"][0]["slot"]
    sched.apply(plan, {"prefill": {slot: 7}, "decode": {}})

    def round_(draft, verify):
        plan = sched.plan()
        assert plan["decode"]["spec"] is True
        sched.apply(plan, {"prefill": {}, "decode": {
            slot: {"draft": list(draft), "verify": list(verify)}}})

    round_([10, 11, 12], [10, 11, 12, 13])    # accept-k: 4 emitted
    round_([20, 21, 22], [30, 31, 32, 33])    # accept-0: 1 corrected
    round_([40, 41, 42], [40, 50, 51, 52])    # mid-prefix: accept 1
    # 7 tokens in all: max_new is reached mid-round (the cut)
    assert req.done() and list(req.generated) == \
        [7, 10, 11, 12, 13, 30, 40], list(req.generated)
    s = sched.stats()["spec"]
    assert s["emitted"] == s["accepted"] + s["corrected"] == 6, s
    assert s["accepted"] == 4 and s["corrected"] == 2, s
    assert s["drafted"] == 9 and s["slot_steps"] == 3, s
    assert s["tokens_per_target_forward"] == 2.0, s

    # fallback: acceptance under min_accept turns speculation off for the
    # request's remaining life, verify[:1] only
    req2 = sched.submit(np.arange(1, 5))
    plan = sched.plan()
    slot = plan["prefills"][0]["slot"]
    sched.apply(plan, {"prefill": {slot: 7}, "decode": {}})
    for i in range(2):       # the window arms at window // 2 = 2 entries
        assert not req2.spec_off, i
        round_([60 + i, 61, 62], [70 + i, 71, 72, 73])
    assert req2.spec_off, "acceptance floor did not trip"
    assert sched.stats()["spec"]["fallbacks"] == 1
    plan = sched.plan()
    assert plan["decode"].get("spec") is not True, plan["decode"]
    print("serve selfcheck: spec fold accounting + fallback OK")


def _check_programs_run() -> None:
    import torch

    from ray_lightning_tpu_torch.core.steps import (build_decode_step,
                                                    build_draft_step,
                                                    build_prefill_step,
                                                    build_verify_step)
    from ray_lightning_tpu_torch.models.gpt import (GPTConfig,
                                                    GPTLightningModule)

    module = GPTLightningModule(GPTConfig(
        vocab_size=64, block_size=16, n_layer=2, n_head=2, n_embd=32,
        remat=False))
    model = module.configure_decode_model(device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    draft = module.configure_draft(layers=1, device="cpu")
    draft.load_state_dict({k: v for k, v in model.state_dict().items()
                           if k in draft.state_dict()})
    S, L, H, D, k = 2, 16, 2, 16, 3
    bf16 = torch.bfloat16        # the config's compute dtype
    kv = [torch.zeros(2, S, L, H, D, dtype=bf16) for _ in range(2)]
    dkv = [torch.zeros(1, S, L, H, D, dtype=bf16) for _ in range(2)]
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    with torch.inference_mode():
        first = build_prefill_step(model, 8)(
            *kv, torch.ones(1, 8, dtype=torch.long),
            torch.zeros(1, dtype=torch.long),
            torch.full((1,), 8, dtype=torch.long))
        assert first.shape == () and 0 <= int(first) < 64
        assert kv[0][:, 0, :8].abs().sum() > 0
        assert build_decode_step(model, "dense")(
            *kv, i32(S), i32(S) + 8).shape == (S,)
        assert build_draft_step(draft, k, "dense")(
            *dkv, i32(S), i32(S)).shape == (S, k)
        assert build_verify_step(model, "dense")(
            *kv, i32(S, k + 1), i32(S, k + 1) + 9).shape == (S, k + 1)
    print("serve selfcheck: prefill/decode/draft/verify programs run on "
          "the CPU")


def _check_kv_blocks() -> None:
    import numpy as np

    from ray_lightning_tpu_torch.models.gpt import gpt_partition_rules
    from ray_lightning_tpu_torch.parallel.mesh import Mesh
    from ray_lightning_tpu_torch.parallel.strategy import SpmdStrategy
    from ray_lightning_tpu_torch.serve.kvcache import KVCacheSpec

    slots, heads = 8, 32
    whole = KVCacheSpec(24, slots, 2048, heads, 64)
    for sizes in ({"data": 1, "tensor": 2}, {"data": 2, "tensor": 2},
                  {"data": 2, "sequence": 2, "tensor": 2}):
        names = tuple(sizes)
        strategy = SpmdStrategy(gpt_partition_rules(), names, sizes)
        world = int(np.prod(list(sizes.values())))
        replicas = sizes.get("sequence", 1)
        cover = np.zeros((slots, heads), int)
        nbytes = 0
        for rank in range(world):
            mesh = Mesh(names, [sizes[a] for a in names], rank)
            (lo, hi), (hlo, hhi) = strategy.kv_cache_block(mesh, slots,
                                                           heads)
            nbytes += whole.block((lo, hi), (hlo, hhi)).nbytes()
            assert hi - lo == slots // sizes["data"], (sizes, lo, hi)
            assert hhi - hlo == heads // sizes["tensor"], (sizes, hlo, hhi)
            cover[lo:hi, hlo:hhi] += 1
        assert (cover == replicas).all(), (sizes, cover)
        assert nbytes == replicas * whole.nbytes(), (sizes, nbytes)
        spec = tuple(strategy.kv_cache_spec(mesh))
        assert spec == (None, "data", None, "tensor", None), spec
    try:
        strategy.kv_cache_block(mesh, 5, heads)
    except ValueError:
        pass
    else:
        raise AssertionError("5 slots over 2 data shards: no raise")
    print("serve selfcheck: tensor=2 KV slot and head blocks cover the "
          "cache exactly once")


def _check_spec_cost_model() -> None:
    from ray_lightning_tpu_torch.plan.cost import (expected_accepted,
                                                   speculative_speedup)
    assert expected_accepted(1.0, 4) == 4.0
    assert expected_accepted(0.0, 4) == 0.0
    assert abs(expected_accepted(0.5, 2) - 0.75) < 1e-12
    assert speculative_speedup(0.9, 4, 0.25) > 1.0
    assert speculative_speedup(0.05, 4, 0.5) < 1.0
    print("serve selfcheck: speculative cost model OK")


def run() -> int:
    _check_buckets()
    _check_scheduler()
    _check_spec_fold()
    _check_programs_run()
    _check_kv_blocks()
    _check_spec_cost_model()
    return 0


if __name__ == "__main__":
    sys.exit(run())
