"""PyTorch/CUDA port, the serving front door: ``ray_lightning_tpu_torch``'s
``Server`` over CPU serve actors against the JAX package's engine.

The JAX ``ServeEngine`` (dense decode, the tests/test_serve.py TINY
shape of tests/test_torch_serve.py) serves six prompts from two tenants
(``np.arange(1, 4 + i % 5)``, tests/test_serve.py:448) through its own
``Scheduler`` in process; its seeded params go to the port through
``convert.flax_to_torch`` as the module's ``_trained_state`` (the
train -> serve handoff), and the port's ``Server`` serves the same
prompts over one and two ``platform="cpu"`` workers.  fp32 tokens must
be equal, except that a step where the two greedy choices lie within
2e-5 of each other may diverge; bf16 tokens must pass the
teacher-forced near-tie rule at 2e-2 against the JAX whole-sequence
forward.  The other weights paths (a port ``Trainer`` checkpoint, the
seeded init), the lifecycle, a worker killed mid-serve, the slot split
and the options that are not ported are held here too.

JAX is imported inside the fixture only, so that importing this module
(as a worker does to unpickle a name of it) stays free of JAX.
"""

import os
import signal

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch import (GPTLightningModule, Scheduler, Server,
                                     ServeEngine, ServeWorker, Trainer,
                                     flax_to_torch)
from ray_lightning_tpu_torch.models.gpt import GPTConfig
from ray_lightning_tpu_torch.serve import PageConfig

TINY = dict(vocab_size=128, block_size=32, n_layer=2, n_head=2, n_embd=32,
            remat=False)
BUCKETS = (8, 16)
SLOTS = 4
NEW_TOKENS = 8
QUOTAS = {"alice": 2}
PROMPTS = [np.arange(1, 4 + i % 5) for i in range(6)]
TENANTS = ["alice", "bob"] * 3
#: (torch dtype, RLT_BF16_PARAMS, tolerance of the near-tie rule)
DTYPES = {"float32": (torch.float32, "0", 2e-5),
          "bfloat16": (torch.bfloat16, "1", 2e-2)}
#: the most a request may take here, or a failure take to reach it
WAIT_S = 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the CPU workers take: the suite runs
    files in parallel processes, and the in-process reference below
    must add its floats in the workers' order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _module(dtype=torch.float32) -> GPTLightningModule:
    return GPTLightningModule(GPTConfig(**TINY, dtype=dtype))


def _server(module, **kw) -> Server:
    kw.setdefault("num_workers", 1)
    return Server(module, platform="cpu", buckets=BUCKETS,
                  max_batch_slots=SLOTS, max_new_tokens=NEW_TOKENS,
                  tenant_quotas=QUOTAS, **kw)


def _submit_all(submit) -> list:
    return [submit(p, tenant=t) for p, t in zip(PROMPTS, TENANTS)]


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def jax_served(request):
    """The JAX engine's params and greedy tokens over the six prompts
    for one dtype, and its whole-sequence forward's next-token logits
    for any tokens (the near-tie rule's reference)."""
    import jax
    import jax.numpy as jnp

    from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
    from ray_lightning_tpu.models.gpt import (
        GPTLightningModule as JaxModule)
    from ray_lightning_tpu.parallel.strategy import DataParallelStrategy
    from ray_lightning_tpu.serve.engine import ServeEngine as JaxEngine
    from ray_lightning_tpu.serve.scheduler import (
        Scheduler as JaxScheduler)
    from ray_lightning_tpu.serve.worker import ServeWorker as JaxWorker

    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[request.param]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RLT_BF16_PARAMS", DTYPES[request.param][1])
        mp.setenv("RLT_DECODE_IMPL", "dense")
        module = JaxModule(JaxConfig(**TINY, dtype=jdt))
        eng = JaxEngine(module, DataParallelStrategy(), buckets=BUCKETS,
                        slots=SLOTS, max_seq_len=TINY["block_size"],
                        seed=0).setup()
        sched = JaxScheduler(buckets=BUCKETS, slots=SLOTS,
                             max_seq_len=TINY["block_size"], quotas=QUOTAS,
                             default_max_new_tokens=NEW_TOKENS)
        worker = JaxWorker()
        worker._engine = eng
        worker._rank = 0
        reqs = _submit_all(sched.submit)
        while not sched.idle():
            plan = sched.plan()
            sched.apply(plan, worker.serve_step(plan))
    params = jax.device_get(eng.params)
    jmodel = module.configure_decode_model()

    def reference(generated):
        L = TINY["block_size"]
        seqs = np.zeros((len(PROMPTS), L), np.int32)
        for i, (p, g) in enumerate(zip(PROMPTS, generated)):
            row = list(p) + list(g[:-1])
            seqs[i, :len(row)] = row
        logits = np.asarray(jnp.asarray(
            jmodel.apply({"params": params}, seqs, True), jnp.float32))
        return [logits[i, len(p) - 1:len(p) - 1 + len(g)]
                for i, (p, g) in enumerate(zip(PROMPTS, generated))]

    return (request.param, params, [r.result(1).tolist() for r in reqs],
            reference)


def _assert_parity(dtype, mine, theirs, refs):
    """Each token is the reference argmax or within the dtype's
    tolerance of it (teacher-forced); in fp32 the tokens are the JAX
    engine's up to the first such near-tie."""
    tol = DTYPES[dtype][2]
    for prompt, got, want, ref in zip(PROMPTS, mine, theirs, refs):
        for i, tok in enumerate(got):
            best = int(np.argmax(ref[i]))
            assert tok == best or ref[i][tok] >= ref[i][best] - tol, \
                (prompt, i, tok, best)
        if dtype == "float32":
            n = next((i for i, (a, b) in enumerate(zip(got, want))
                      if a != b), len(got))
            assert got[:n] == want[:n]
            if n < len(got):
                assert abs(ref[n][got[n]] - ref[n][want[n]]) <= tol, \
                    (prompt, got, want)


@pytest.mark.parametrize("workers", [1, 2])
def test_server_serves_the_jax_engines_tokens(jax_served, workers,
                                              monkeypatch):
    """The trained weights through ``Server`` over CPU actors: the JAX
    engine's greedy tokens, the scheduler's accounting, the slots split
    S / W over the ranks, a graceful drain, and ``submit`` refused
    before ``start`` and after ``shutdown``."""
    dtype, params, theirs, reference = jax_served
    tdt, bf16_params, _ = DTYPES[dtype]
    monkeypatch.setenv("RLT_BF16_PARAMS", bf16_params)
    module = _module(tdt)
    module._trained_state = flax_to_torch(params)
    server = _server(module, num_workers=workers)
    with pytest.raises(RuntimeError, match="start"):
        server.submit(PROMPTS[0])
    with server:
        reqs = _submit_all(server.submit)
        mine = [r.result(WAIT_S).tolist() for r in reqs]
        server.drain()
        stats = server.stats()
    _assert_parity(dtype, mine, theirs, reference(mine))
    sched = stats["scheduler"]
    assert sched["completed"] == 6
    assert sched["per_tenant"]["alice"]["served_tokens"] == 24
    assert sched["per_tenant"]["bob"]["served_tokens"] == 24
    assert 0 < sched["batch_occupancy"] <= 1.0
    per = SLOTS // workers
    assert [w["slots"] for w in stats["setup"]] == [per] * workers
    assert [w["slot_block"] for w in stats["workers"]] == [
        [r * per, (r + 1) * per] for r in range(workers)]
    assert len({w["pid"] for w in stats["workers"]}) == workers
    # on the CPU the programs run eagerly: nothing is captured
    assert all(w["captures"] == {} and w["recaptures"] == {}
               for w in stats["workers"])
    assert stats["pump"]["steps"] > 0
    assert set(stats["start"]) == {"spawn_s", "setup_s", "capture_s",
                                   "total_s"}
    with pytest.raises(RuntimeError, match="start"):
        server.submit(PROMPTS[0])


def _in_process_tokens(weights=None) -> list:
    """The six prompts through the port's in-process loop: the same
    engine, scheduler and serve step as one worker runs."""
    eng = ServeEngine(_module(), BUCKETS, SLOTS, TINY["block_size"],
                      weights=weights, device="cpu").setup()
    sched = Scheduler(BUCKETS, SLOTS, TINY["block_size"], quotas=QUOTAS,
                      default_max_new_tokens=NEW_TOKENS)
    worker = ServeWorker(eng)
    reqs = _submit_all(sched.submit)
    while not sched.idle():
        plan = sched.plan()
        sched.apply(plan, worker.serve_step(plan))
    return [r.result(1).tolist() for r in reqs]


def test_server_serves_a_trainer_checkpoint(tmp_path, monkeypatch):
    """``checkpoint=``: the weights of a port ``Trainer`` checkpoint,
    served by a worker, give the in-process engine's tokens on those
    weights, which differ from the seeded init's."""
    monkeypatch.setenv("RLT_BF16_PARAMS", "0")
    module = _module()
    trainer = Trainer(max_steps=2, device="cpu", enable_checkpointing=False,
                      logger=False, default_root_dir=str(tmp_path))
    trainer.fit(module)
    path = str(tmp_path / "served.ckpt")
    trainer.save_checkpoint(path)
    params = Trainer.load_checkpoint_dict(path, "cpu")["state"]["params"]
    want = _in_process_tokens(params)
    assert want != _in_process_tokens()
    with _server(_module(), checkpoint=path) as server:
        got = [r.result(WAIT_S).tolist()
               for r in _submit_all(server.submit)]
    assert got == want


def test_server_fails_every_waiter_when_a_worker_dies(monkeypatch):
    """The seeded init served by one worker gives the in-process
    tokens; then the worker is killed mid-serve: every waiter raises
    within the bound, the failure is recorded, and ``submit`` refuses."""
    monkeypatch.setenv("RLT_BF16_PARAMS", "0")
    server = _server(_module()).start()
    try:
        got = [r.result(WAIT_S).tolist()
               for r in _submit_all(server.submit)]
        assert got == _in_process_tokens()
        pid = server.stats()["workers"][0]["pid"]
        reqs = [server.submit(p, max_new_tokens=24) for p in PROMPTS * 2]
        os.kill(pid, signal.SIGKILL)
        for r in reqs:
            with pytest.raises(Exception) as err:
                r.result(WAIT_S)
            assert not isinstance(err.value, TimeoutError), err.value
        assert "failure" in server.stats()
        with pytest.raises(RuntimeError, match="failed"):
            server.submit(PROMPTS[0])
    finally:
        server.shutdown()


def test_server_workers_run_on_the_card_unless_asked(monkeypatch):
    """A worker without CUDA, when the caller did not ask for the CPU,
    raises instead of serving on the CPU, and ``start`` leaves no actor
    behind."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    server = Server(_module(), buckets=BUCKETS, max_batch_slots=SLOTS)
    with pytest.raises(Exception, match="CUDA is not available"):
        server.start()
    assert server._workers == [] and not server._started


@pytest.mark.parametrize("kw, item", [
    ({"telemetry": {"metrics_port": 0}}, 13),
    ({"compile_cache": "cache"}, 12),
    ({"strategy": "auto"}, 12),
], ids=["telemetry", "compile_cache", "auto"])
def test_server_refuses_what_is_not_ported(kw, item):
    """The option the port lacks (telemetry, item 13) raises before any
    actor starts, naming its ROADMAP.md item.  Item 12's two are
    answered now: ``compile_cache=`` is taken, its env riding to every
    serve actor (compile/cache.py); ``strategy="auto"`` plans a training
    step, so a server refuses it as the JAX one does when it builds the
    mesh (``AutoStrategy``: "must be resolved by the planner")."""
    if item == 13:
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP.md queue 1 item {item}"):
            _server(_module(), **kw)
    elif "compile_cache" in kw:
        env = _server(_module(), **kw)._worker_env_base()
        assert env["RLT_COMPILE_CACHE"] == "1"
        assert env["RLT_COMPILE_CACHE_DIR"] == "cache"
    else:
        with pytest.raises(RuntimeError, match="resolved by the planner"):
            _server(_module(), **kw)


@pytest.mark.parametrize("kw", [
    {"kvship": True, "paged": PageConfig(True, 8)},
    {"paged": PageConfig(True, 8), "num_workers": 2},
], ids=["kvship", "paged-ranks"])
def test_server_takes_what_was_ported_since(kw):
    """KV shipping (the fleet's disaggregation) and prefix reuse across
    ranks are ported: the options construct, the worker env and spec
    carry ``kvship``, the scheduler keeps a reuse inside a rank's block
    (tests/test_torch_kvship.py serves both)."""
    server = _server(_module(), **kw)
    assert server.kvship == kw.get("kvship", False)
    assert ("RLT_SERVE_KVSHIP" in server._worker_env_base()) \
        == server.kvship
    workers = kw.get("num_workers", 1)
    assert server.scheduler._block == SLOTS // workers
    assert server.scheduler.pages is not None


def test_server_slot_split_and_kv_shipping():
    """Slots that do not divide by the workers raise; before ``start``
    a server ships nothing: it offers no KV, exports no donor and adopts
    no rows (without paging never)."""
    with pytest.raises(ValueError, match="divide"):
        _server(_module(), num_workers=3)
    server = _server(_module())
    assert not server.can_ship_kv() and not server.can_adopt_kv()
    assert server.export_kv(PROMPTS[0]) is None
    assert server.import_kv(PROMPTS[0], None, None) is False
    paged = _server(_module(), kvship=True, paged=PageConfig(True, 8))
    assert not paged.can_ship_kv() and not paged.can_adopt_kv()
    assert paged.export_kv(np.arange(1, 20)) is None
