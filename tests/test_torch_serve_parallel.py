"""PyTorch/CUDA port, serving under the training strategies: the port's
``ServeEngine(strategy=...)`` and ``Server(strategy=...)`` against the
JAX package's ``ServeEngine`` under the same strategy.

The JAX engine runs on the conftest's virtual CPU devices with its mesh
sized to the port's ranks (``tensor=2``, ``fsdp=2``, ``data=2 x
tensor=2``, and a ``sequence=2`` mesh whose ranks serve as replicas);
its seeded fp32 params go to the port through ``convert.flax_to_torch``.
The port's ranks are gloo CPU processes (tests/torch_gloo.py), or the
``Server``'s CPU serve actors.  Held here:

- each rank's prefill and first-decode logits within fp32 2e-5 of the
  JAX model's (the vocab-split logits gathered whole), and each rank's
  KV cache within 2e-5 of its slot and head block of the JAX cache;
- the ``Server``'s greedy tokens equal the JAX engine's, up to a step
  where the two greedy choices lie within 2e-5 of each other;
- paged prefix reuse and speculation under ``tensor=2`` give the tokens
  of the unsharded port engine; a KV ship between a ``tensor=2`` server
  and a one-rank server installs the rows bit for bit, both ways;
- ``devices_per_worker=2`` equals ``num_workers=2``;
- what the JAX engine refuses (a routed GPT, a module without a decode
  model) raises its error class, before any actor starts; slots that do
  not divide by the data shards raise naming both numbers.

JAX is imported inside the fixtures only, so that importing this module
(as a rank process does to unpickle a name of it) stays free of JAX.
"""

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch import (GPTLightningModule, Scheduler, Server,
                                     ServeEngine, ServeWorker, flax_to_torch)
from ray_lightning_tpu_torch.models.gpt import GPTConfig, gpt_partition_rules
from ray_lightning_tpu_torch.parallel.strategy import (FullyShardedStrategy,
                                                       SpmdStrategy)
from ray_lightning_tpu_torch.serve import (PageConfig, SpecConfig,
                                           bucket_for, pad_to_bucket)
from torch_gloo import run_gloo

TINY = dict(vocab_size=128, block_size=32, n_layer=2, n_head=4, n_embd=64,
            remat=False)
BUCKETS = (8, 16)
L = TINY["block_size"]
TOL = 2e-5
NEW_TOKENS = 6
#: fp32 params and the dense decode on both sides
ENV = {"RLT_BF16_PARAMS": "0", "RLT_DECODE_IMPL": "dense"}
#: layout -> (port ranks, slots, the port's strategy, the JAX strategy's
#: constructor arguments: class name, axis names, axis sizes)
LAYOUTS = {
    "tensor2": (2, 4, ("spmd", ("data", "tensor"),
                       {"data": 1, "tensor": 2})),
    # the JAX FSDP clamps its data axis to gcd(devices, slots) = 2
    "fsdp2": (2, 6, ("fsdp", None, None)),
    "data2_tensor2": (4, 4, ("spmd", ("data", "tensor"),
                             {"data": 2, "tensor": 2})),
    "sequence2": (2, 4, ("spmd", ("data", "sequence"),
                         {"data": 1, "sequence": 2})),
}


def _prompts(n: int) -> list:
    rng = np.random.default_rng(5)
    return [rng.integers(1, TINY["vocab_size"], size=int(k))
            for k in rng.integers(3, 14, size=n)]


def _port_strategy(name, axes, sizes):
    if name == "fsdp":
        return FullyShardedStrategy()
    return SpmdStrategy(gpt_partition_rules(), axes, sizes)


def _module() -> GPTLightningModule:
    return GPTLightningModule(GPTConfig(**TINY, dtype=torch.float32,
                                        attention_impl="dot"))


@pytest.fixture(autouse=True, scope="module")
def _fp32_dense():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(n)


def _jax_strategy(name, axes, sizes):
    from ray_lightning_tpu.models.gpt import (
        gpt_partition_rules as jax_rules)
    from ray_lightning_tpu.parallel import strategy as js
    if name == "fsdp":
        return js.FullyShardedStrategy()
    return js.SpmdStrategy(jax_rules(), axes, sizes)


def _jax_module():
    import jax.numpy as jnp
    from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
    from ray_lightning_tpu.models.gpt import GPTLightningModule as JaxModule
    return JaxModule(JaxConfig(**TINY, dtype=jnp.float32))


def _jax_tokens(engine, prompts, slots) -> list:
    """The JAX engine's greedy tokens for ``prompts`` through its own
    scheduler and worker (one tenant)."""
    from ray_lightning_tpu.serve.scheduler import Scheduler as JaxScheduler
    from ray_lightning_tpu.serve.worker import ServeWorker as JaxWorker
    sched = JaxScheduler(buckets=BUCKETS, slots=slots, max_seq_len=L,
                         default_max_new_tokens=NEW_TOKENS)
    worker = JaxWorker()
    worker._engine, worker._rank = engine, 0
    reqs = [sched.submit(p) for p in prompts]
    for _ in range(400):
        plan = sched.plan()
        if plan is None:
            break
        sched.apply(plan, worker.serve_step(plan))
    return [r.result(1).tolist() for r in reqs]


@pytest.fixture(scope="module", params=list(LAYOUTS))
def jax_layout(request):
    """The JAX engine under one layout: its mesh, params, first tokens,
    KV cache after every slot's prefill and one decode, the model's
    logits at those two steps, and its greedy tokens."""
    import jax
    import jax.numpy as jnp
    ranks, slots, (name, axes, sizes) = LAYOUTS[request.param]
    prompts = _prompts(slots)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        module = _jax_module()
        from ray_lightning_tpu.serve.engine import ServeEngine as JaxEngine
        eng = JaxEngine(module, _jax_strategy(name, axes, sizes),
                        buckets=BUCKETS, slots=slots, max_seq_len=L,
                        seed=0).setup()
        assert eng._mesh.devices.size == ranks, eng._mesh.shape
        first = [eng.prefill(s, pad_to_bucket(p, bucket_for(len(p),
                                                            BUCKETS)),
                             len(p), bucket_for(len(p), BUCKETS))
                 for s, p in enumerate(prompts)]
        eng.decode(np.asarray(first, np.int32),
                   np.asarray([len(p) for p in prompts], np.int32))
        k = np.asarray(jax.device_get(eng._k))
        v = np.asarray(jax.device_get(eng._v))
        params = jax.device_get(eng.params)
        seqs = np.zeros((slots, L), np.int32)
        for i, (p, t) in enumerate(zip(prompts, first)):
            seqs[i, :len(p) + 1] = list(p) + [t]
        logits = np.asarray(jnp.asarray(module.configure_decode_model(
            ).apply({"params": params}, seqs, True), jnp.float32))
        tokens = _jax_tokens(eng, prompts, slots)
    pre = np.stack([logits[i, len(p) - 1] for i, p in enumerate(prompts)])
    dec = np.stack([logits[i, len(p)] for i, p in enumerate(prompts)])
    return {"layout": request.param, "params": params, "prompts": prompts,
            "first": first, "k": k, "v": v, "pre": pre, "dec": dec,
            "tokens": tokens, "slots": slots, "ranks": ranks,
            "strategy": _port_strategy(name, axes, sizes)}


def _rank_serve(rank, world, strategy, weights, prompts, first, slots):
    """One rank: the engine under ``strategy`` on the converted weights,
    every prompt's prefill logits (every rank computes them: the
    forward's collectives span the mesh), the prefills of its block (the
    others' on the scratch slot under lockstep), one decode's logits of
    its block; its cache and blocks."""
    from ray_lightning_tpu_torch.serve import bucket_for, pad_to_bucket
    eng = ServeEngine(_module(), BUCKETS, slots, L, weights=weights,
                      device="cpu", strategy=strategy).setup()
    lo, hi = eng.slot_block
    model = eng.model
    pre = []
    with torch.inference_mode():
        for s, p in enumerate(prompts):
            b = bucket_for(len(p), BUCKETS)
            ids = pad_to_bucket(p, b)
            x, _ = model.hidden_with_kv(torch.as_tensor(ids).long())
            pre.append(model.head(x[0, len(p) - 1]).numpy())
            if lo <= s < hi:
                assert eng.prefill(s - lo, ids, len(p), b) == first[s]
            elif eng.lockstep:
                eng.shadow_prefill({"slot": s, "tokens": ids,
                                    "length": len(p), "bucket": b})
        toks = torch.as_tensor(first[lo:hi], dtype=torch.int32)
        pos = torch.as_tensor([len(p) for p in prompts[lo:hi]],
                              dtype=torch.int32)
        dec = model.decode(toks, pos, eng._k, eng._v).numpy()
    return {"block": eng.slot_block, "heads": eng.head_block,
            "leader": eng.leader, "lockstep": eng.lockstep,
            "pre": np.stack(pre), "dec": dec, "k": eng._k.numpy(),
            "v": eng._v.numpy(), "kv_bytes": eng.stats()["kv_bytes"],
            "shards": {n: tuple(p.shape) for n, p in
                       model.named_parameters()}}


def test_ranks_match_the_jax_engine_under_the_strategy(jax_layout):
    """Every rank's logits within 2e-5 of the JAX model's and its KV
    cache within 2e-5 of its block of the JAX engine's cache; the blocks
    cover the cache once a replica, and only one rank a block leads."""
    j = jax_layout
    outs = run_gloo(_rank_serve, j["ranks"], j["strategy"],
                    flax_to_torch(j["params"]), j["prompts"], j["first"],
                    j["slots"], timeout=240)
    H = TINY["n_head"]
    cover = np.zeros((j["slots"], H), int)
    for out in outs:
        np.testing.assert_allclose(out["pre"], j["pre"], rtol=0, atol=TOL)
        lo, hi = out["block"]
        hlo, hhi = out["heads"]
        np.testing.assert_allclose(out["dec"], j["dec"][lo:hi], rtol=0,
                                   atol=TOL)
        for got, want in ((out["k"], j["k"]), (out["v"], j["v"])):
            np.testing.assert_allclose(got, want[:, lo:hi, :, hlo:hhi],
                                       rtol=0, atol=TOL)
        n_layer, _, _, _, D = j["k"].shape
        assert out["kv_bytes"] == 2 * n_layer * (hi - lo) * L \
            * (hhi - hlo) * D * 4
        if out["leader"]:
            cover[lo:hi, hlo:hhi] += 1
    leaders = [o for o in outs if o["leader"]]
    assert len(leaders) == j["slots"] // (outs[0]["block"][1]
                                          - outs[0]["block"][0])
    # the leaders' blocks tile the slots; under tensor each holds its
    # heads, so the replicas' union of heads is all of them
    assert (cover.sum(axis=1) > 0).all()
    assert outs[0]["lockstep"] == (j["layout"] == "fsdp2")
    if j["layout"] == "tensor2":
        # each rank its half of the column-split qkv
        assert outs[0]["shards"]["h.0.attn.qkv.weight"] == (
            3 * TINY["n_embd"] // 2, TINY["n_embd"])


def _rank_first_step(rank, world, strategy, weights, prompts, slots):
    """One tensor=2 rank: its block's prefills (the engine's own first
    tokens) and one decode's fp32 logits, gathered whole over the
    vocab."""
    from ray_lightning_tpu_torch.serve import bucket_for, pad_to_bucket
    eng = ServeEngine(_module(), BUCKETS, slots, L, weights=weights,
                      device="cpu", strategy=strategy).setup()
    lo, hi = eng.slot_block
    first = []
    with torch.inference_mode():
        for s in range(lo, hi):
            p = prompts[s]
            b = bucket_for(len(p), BUCKETS)
            first.append(eng.prefill(s - lo, pad_to_bucket(p, b), len(p), b))
        dec = eng.model.decode(
            torch.as_tensor(first, dtype=torch.int32),
            torch.as_tensor([len(p) for p in prompts[lo:hi]],
                            dtype=torch.int32), eng._k, eng._v).numpy()
    return {"block": (lo, hi), "first": first, "dec": dec}


def test_f16_tensor2_first_step_logits_hold_the_fp32_bar():
    """F16's bar, on the CPU: two gloo ranks under tensor=2 at tiny
    width in fp32 serve a first decode step whose logits lie within
    fp32 2e-5 (atol = rtol) of the JAX package's unsharded forward over
    the same tokens, with every slot's argmax equal.  A tensor=2
    row-parallel product sums its K in two partial sums added by an
    all-reduce, an order neither unsharded route uses; 2e-5 is the
    port's fp32 bar, which the card's fp32 leg is held to too
    (``chip_smoke.py --serve-parallel-logits``)."""
    import jax
    import jax.numpy as jnp
    _, slots, (name, axes, sizes) = LAYOUTS["tensor2"]
    prompts = _prompts(slots)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        module = _jax_module()
        model = module.configure_decode_model()
        params = jax.device_get(model.init(
            jax.random.PRNGKey(3), np.zeros((1, L), np.int32),
            True)["params"])
    outs = run_gloo(_rank_first_step, 2,
                    _port_strategy(name, axes, sizes),
                    flax_to_torch(params), prompts, slots, timeout=240)
    leaders = {o["block"]: o for o in outs}
    assert sorted(leaders) == [(0, slots)], sorted(leaders)
    got = leaders[(0, slots)]
    seqs = np.zeros((slots, L), np.int32)
    for i, (p, t) in enumerate(zip(prompts, got["first"])):
        seqs[i, :len(p) + 1] = list(p) + [t]
    logits = np.asarray(jnp.asarray(model.apply({"params": params}, seqs,
                                                True), jnp.float32))
    want = np.stack([logits[i, len(p)] for i, p in enumerate(prompts)])
    np.testing.assert_allclose(got["dec"], want, rtol=TOL, atol=TOL)
    assert (got["dec"].argmax(-1) == want.argmax(-1)).all()
    for o in outs:      # both tensor ranks computed the same logits
        np.testing.assert_array_equal(o["dec"], got["dec"])


def _near_tie_equal(mine, theirs, prompts, params):
    """Equal up to the first step where the greedy choice is a near-tie
    within 2e-5 of the JAX whole-sequence forward (after it the
    sequences differ)."""
    import jax.numpy as jnp
    module = _jax_module().configure_decode_model()
    for p, a, b in zip(prompts, mine, theirs):
        n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 len(a))
        assert a[:n] == b[:n], (p, a, b)
        if n < len(a):
            seq = np.zeros((1, L), np.int32)
            row = list(p) + list(a[:n])
            seq[0, :len(row)] = row
            logits = np.asarray(module.apply({"params": params}, seq, True)
                                .astype(jnp.float32))[0, len(row) - 1]
            assert abs(logits[a[n]] - logits[b[n]]) <= TOL, (p, a, b)


def _server(strategy, slots, weights=None, **kw) -> Server:
    module = _module()
    module._trained_state = weights
    kw.setdefault("num_workers", 2)
    return Server(module, platform="cpu", buckets=BUCKETS,
                  max_batch_slots=slots, max_new_tokens=NEW_TOKENS,
                  strategy=strategy, worker_env=dict(ENV), **kw)


def _blocks(engine) -> tuple:
    """(in a rank, ``Server.call_ranks``) its slots, heads and leader."""
    return engine.slot_block, engine.head_block, engine.leader


def _served(server, prompts) -> list:
    with server:
        reqs = [server.submit(p) for p in prompts]
        tokens = [r.result(120).tolist() for r in reqs]
        stats = server.stats()
        stats["blocks"] = server.call_ranks(_blocks)
    return tokens, stats


def test_server_tokens_match_the_jax_engine(jax_layout):
    """``Server(strategy=...)`` over the layout's ranks serves the JAX
    engine's greedy tokens; the ranks report their blocks, and only the
    leaders returned results."""
    j = jax_layout
    workers = 1 if j["layout"] == "data2_tensor2" else j["ranks"]
    dpw = j["ranks"] // workers
    tokens, stats = _served(
        _server(j["strategy"], j["slots"], flax_to_torch(j["params"]),
                num_workers=workers, devices_per_worker=dpw), j["prompts"])
    _near_tie_equal(tokens, j["tokens"], j["prompts"], j["params"])
    ranks = stats["workers"]
    assert len(ranks) == j["ranks"]
    assert sum(r["leader"] for r in ranks) * (
        ranks[0]["slot_block"][1] - ranks[0]["slot_block"][0]) \
        == j["slots"]
    assert all(r["ungraphed"] is None for r in ranks)   # the CPU: eager
    assert stats["scheduler"]["completed"] == len(j["prompts"])


SHARED = np.arange(3, 11)      # a page-aligned 8-token prefix


def _tensor2():
    return SpmdStrategy(gpt_partition_rules(), ("data", "tensor"),
                        {"data": 1, "tensor": 2})


def _reuse_prompts() -> list:
    rng = np.random.default_rng(9)
    return [np.concatenate([SHARED, rng.integers(1, 128, size=k)])
            for k in (2, 3, 5, 1, 4, 6)]


def test_paged_reuse_and_speculation_under_tensor_parallelism():
    """``tensor=2`` with paged prefix reuse and speculative decoding
    (k=2, a one-layer draft that shares the target's pieces) serves the
    unsharded port engine's tokens; prefixes were reused and drafts
    verified on both."""
    prompts = _reuse_prompts()
    kw = dict(paged=PageConfig(True, 8), spec=SpecConfig(True, k=2,
                                                         draft_layers=1))
    eng = ServeEngine(_module(), BUCKETS, 4, L, seed=3, device="cpu",
                      **kw).setup()
    sched = Scheduler(buckets=BUCKETS, slots=4, max_seq_len=L,
                      default_max_new_tokens=NEW_TOKENS, **kw)
    worker = ServeWorker(eng)
    reqs = [sched.submit(p) for p in prompts]
    for _ in range(400):
        plan = sched.plan()
        if plan is None:
            break
        sched.apply(plan, worker.serve_step(plan))
    want = [r.result(1).tolist() for r in reqs]
    got, stats = _served(_server(_tensor2(), 4, seed=3, **kw), prompts)
    assert got == want
    assert stats["scheduler"]["pages"]["reused_prefills"] > 0, \
        stats["scheduler"]
    assert stats["scheduler"]["spec"]["drafted"] > 0
    assert all(r["calls"]["verify"] > 0 and r["spec"]["draft_shares_weights"]
               for r in stats["workers"])
    assert sched.stats()["pages"]["reused_prefills"] > 0


def test_kv_ship_between_tensor_parallel_and_one_rank_servers():
    """A donor's rows exported by a ``tensor=2`` server (its heads
    gathered in rank order) install bit for bit on a one-rank server,
    and that server's rows install bit for bit back on the first (each
    rank its heads)."""
    paged = PageConfig(True, 8)
    a = _server(_tensor2(), 4, seed=1, paged=paged, kvship=True)
    b = _server("ddp", 4, seed=1, paged=paged, kvship=True, num_workers=1)
    p, q = _reuse_prompts()[:2]
    with a, b:
        a.generate(p, timeout=120)
        k, v, matched = a.export_kv(p)
        assert tuple(k.shape)[3] == TINY["n_head"] and matched == 8
        assert b.import_kv(p, k, v)
        k2, v2, _ = b.export_kv(p)
        assert torch.equal(k2, k) and torch.equal(v2, v)
        b.generate(q, timeout=120)
        k3, v3, _ = b.export_kv(q)
        assert a.import_kv(q, k3, v3)
        k4, v4, _ = a.export_kv(q)
        assert torch.equal(k4, k3) and torch.equal(v4, v3)
        # the same seed: the unsharded rows are the sharded ones to fp32
        # rounding of the row-parallel sums
        np.testing.assert_allclose(k3.numpy(), a.export_kv(q)[0].numpy())


def test_devices_per_worker_equals_num_workers():
    """``Server(num_workers=1, devices_per_worker=2)`` is two ranks, as
    ``num_workers=2`` is: the same mesh and the same tokens."""
    prompts = _prompts(4)
    one, s1 = _served(_server(_tensor2(), 4, seed=2, num_workers=1,
                              devices_per_worker=2), prompts)
    two, s2 = _served(_server(_tensor2(), 4, seed=2, num_workers=2),
                      prompts)
    assert one == two
    assert len(s1["workers"]) == len(s2["workers"]) == 2
    assert s1["blocks"] == s2["blocks"] == [((0, 4), (0, 2), True),
                                            ((0, 4), (2, 4), False)]
    assert s1["setup"][0]["mesh"] == s2["setup"][0]["mesh"] == {
        "data": 1, "tensor": 2}


def _refusal(jax_side):
    """The error the JAX engine raises on a module it cannot serve."""
    from ray_lightning_tpu.serve.engine import ServeEngine as JaxEngine
    module, strategy = jax_side()
    with pytest.raises(Exception) as err:
        JaxEngine(module, strategy, buckets=BUCKETS, slots=4,
                  max_seq_len=L).setup()
    return err.value


def _jax_moe():
    import jax.numpy as jnp
    from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
    from ray_lightning_tpu.models.gpt import GPTLightningModule as JaxModule
    return (JaxModule(JaxConfig(**TINY, n_experts=4, dtype=jnp.float32)),
            _jax_strategy("spmd", ("data", "expert"),
                          {"data": 1, "expert": 2}))


def _jax_pipelined():
    import jax.numpy as jnp
    from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
    from ray_lightning_tpu.models.pipeline_gpt import PipelinedGPT
    from ray_lightning_tpu.parallel.pipeline import PipelineStrategy
    return (PipelinedGPT(JaxConfig(**TINY, dtype=jnp.float32)),
            PipelineStrategy(stages=2, axis_sizes={"data": 1}))


@pytest.mark.parametrize("case", ["moe_on_expert", "pipelined"])
def test_refused_strategies_raise_the_jax_error(case):
    """A routed GPT on an ``expert`` axis and a pipelined GPT on a
    ``stage`` axis: the JAX engine raises, and the port's ``Server``
    (before any actor starts) and ``ServeEngine`` raise the same class
    (a routed GPT with the same message)."""
    from ray_lightning_tpu_torch.models.pipeline_gpt import PipelinedGPT
    from ray_lightning_tpu_torch.parallel.pipeline import PipelineStrategy
    if case == "moe_on_expert":
        want = _refusal(_jax_moe)
        module = GPTLightningModule(GPTConfig(**TINY, n_experts=4))
        strategy = SpmdStrategy(gpt_partition_rules(), ("data", "expert"),
                                {"data": 1, "expert": 2})
    else:
        want = _refusal(_jax_pipelined)
        module = PipelinedGPT(GPTConfig(**TINY))
        strategy = PipelineStrategy(stages=2, axis_sizes={"data": 1})
    with pytest.raises(type(want)) as err:
        Server(module, platform="cpu", buckets=BUCKETS, max_batch_slots=4,
               num_workers=2, strategy=strategy)
    with pytest.raises(type(want)):
        ServeEngine(module, BUCKETS, 4, L, device="cpu").setup()
    if case == "moe_on_expert":
        assert str(err.value) == str(want)


def test_slots_must_divide_by_the_data_shards():
    """The JAX rule (``build_mesh(batch_hint=slots)``): over several
    ranks the slots divide by the data shards, else ``ValueError``
    naming both numbers; the scheduler counts the data shards."""
    with pytest.raises(ValueError, match="batch 6 does not divide across "
                                         "4 data shards"):
        Server(_module(), platform="cpu", buckets=BUCKETS,
               max_batch_slots=6, num_workers=4, strategy="fsdp")
    server = Server(_module(), platform="cpu", buckets=BUCKETS,
                    max_batch_slots=4, num_workers=4,
                    strategy=SpmdStrategy(gpt_partition_rules(),
                                          ("data", "tensor"),
                                          {"data": 2, "tensor": 2}))
    assert server.data_shards == 2 and server.scheduler._block == 2
    assert server._worker_env_base()["RLT_NUM_PROCESSES"] == "4"
