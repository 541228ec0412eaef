"""PyTorch/CUDA port, the serving slice: ``ray_lightning_tpu_torch``'s
``Scheduler`` -> ``ServeWorker.serve_step`` -> ``ServeEngine`` against
the JAX package's same loop, plus the package's import and device rules.

The slice test builds the JAX ``ServeEngine`` on the test_serve TINY
config, converts the weights it holds, and drives each engine with its
own ``Scheduler`` over the same 6 prompts (tests/test_serve.py:339-340).
fp32 tokens must be equal, except that a step where the two greedy
choices lie within 2e-5 of each other may diverge; bf16 tokens must pass
the teacher-forced near-tie rule at 2e-2 against the JAX package's
whole-sequence forward, as the JAX engine's own do.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
from ray_lightning_tpu.models.gpt import (
    GPTLightningModule as JaxModule)
from ray_lightning_tpu.parallel.strategy import DataParallelStrategy
from ray_lightning_tpu.serve.engine import ServeEngine as JaxEngine
from ray_lightning_tpu.serve.scheduler import Scheduler as JaxScheduler
from ray_lightning_tpu.serve.worker import ServeWorker as JaxWorker
from ray_lightning_tpu_torch import (GPT, GPTLightningModule, Scheduler,
                                     ServeEngine, ServeWorker,
                                     flax_to_torch)
from ray_lightning_tpu_torch.models.gpt import GPTConfig
from ray_lightning_tpu_torch.serve import (KVCacheSpec, SlotAllocator,
                                           bucket_for, pad_to_bucket,
                                           resolve_buckets)

TINY = dict(vocab_size=128, block_size=32, n_layer=2, n_head=2, n_embd=32,
            remat=False)
BUCKETS = (8, 16)
SLOTS = 4
DTYPES = {"float32": (jnp.float32, torch.float32, "0", 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, "1", 2e-2)}
PROMPTS = [np.arange(1, 4 + (i % 5)) for i in range(5)] + [np.arange(2, 13)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and torch's default of a thread per core would crowd the
    other workers' time-bounded distributed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drive(sched, worker):
    """Every prompt through plan -> serve_step -> apply; returns each
    request's tokens and the number of steps that mixed an admitting
    prefill with a live decode."""
    reqs = [sched.submit(p, tenant=("alice", "bob")[i % 2])
            for i, p in enumerate(PROMPTS)]
    mixed = 0
    for _ in range(200):
        plan = sched.plan()
        if plan is None:
            break
        mixed += bool(plan["prefills"]) and plan["decode"] is not None
        sched.apply(plan, worker.serve_step(plan))
    assert all(r.done() for r in reqs)
    return [r.result(1).tolist() for r in reqs], mixed


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def jax_served(request):
    """The JAX engine's params and tokens for one dtype (built once)."""
    jdt, _, bf16_params, _ = DTYPES[request.param]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RLT_BF16_PARAMS", bf16_params)
        mp.setenv("RLT_DECODE_IMPL", "dense")
        module = JaxModule(JaxConfig(**TINY, dtype=jdt))
        eng = JaxEngine(module, DataParallelStrategy(), buckets=BUCKETS,
                        slots=SLOTS, max_seq_len=TINY["block_size"],
                        seed=0).setup()
        sched = JaxScheduler(buckets=BUCKETS, slots=SLOTS,
                             max_seq_len=TINY["block_size"],
                             default_max_new_tokens=6)
        worker = JaxWorker()
        worker._engine = eng
        worker._rank = 0
        tokens, _ = _drive(sched, worker)
    params = jax.device_get(eng.params)
    model = module.configure_decode_model()
    return request.param, params, model, tokens


def _reference_logits(jmodel, params, prompts, generated):
    """The JAX whole-sequence forward's next-token logits at every step
    of each request's tokens: one causal forward over prompt +
    generated[:-1] per row, right-padded to the context (padding after
    a position cannot reach its logits), all rows in one batch."""
    L = TINY["block_size"]
    seqs = np.zeros((len(prompts), L), np.int32)
    for i, (p, g) in enumerate(zip(prompts, generated)):
        row = list(p) + list(g[:-1])
        seqs[i, :len(row)] = row
    logits = np.asarray(jnp.asarray(
        jmodel.apply({"params": params}, seqs, True), jnp.float32))
    return [logits[i, len(p) - 1:len(p) - 1 + len(g)]
            for i, (p, g) in enumerate(zip(prompts, generated))]


def _assert_near_tie_parity(ref, got, atol):
    """Teacher-forced greedy rule: each token is the reference argmax or
    within ``atol`` of it."""
    for i, tok in enumerate(got):
        best = int(np.argmax(ref[i]))
        assert tok == best or ref[i][tok] >= ref[i][best] - atol, \
            (i, tok, best, float(ref[i][tok]), float(ref[i][best]))


@pytest.mark.parametrize("impls", [("dense", "dot"),
                                   ("flash_decode", "flash")],
                         ids=["dense", "flash-plain"])
def test_serve_slice_matches_jax_engine(jax_served, impls, monkeypatch):
    """The port's engine on the JAX engine's weights, converted, through
    its own Scheduler and ServeWorker: the same tokens.  ``flash-plain``
    routes prefill and decode attention through the kernel wrappers,
    which take their plain versions on these CPU tensors."""
    dtype, params, jmodel, jax_tokens = jax_served
    _, tdt, bf16_params, tol = DTYPES[dtype]
    decode_impl, attention_impl = impls
    monkeypatch.setenv("RLT_BF16_PARAMS", bf16_params)
    monkeypatch.setenv("RLT_DECODE_IMPL", decode_impl)
    module = GPTLightningModule(GPTConfig(**TINY, dtype=tdt,
                                          attention_impl=attention_impl))
    eng = ServeEngine(module, buckets=BUCKETS, slots=SLOTS,
                      max_seq_len=TINY["block_size"],
                      weights=flax_to_torch(params), device="cpu").setup()
    assert eng.stats()["decode_kernel"] == decode_impl
    assert eng.model.wte.weight.dtype == tdt
    sched = Scheduler(buckets=BUCKETS, slots=SLOTS,
                      max_seq_len=TINY["block_size"],
                      default_max_new_tokens=6)
    tokens, mixed = _drive(sched, ServeWorker(eng))
    assert mixed >= 2, mixed       # admissions landed in live decodes
    refs = _reference_logits(jmodel, params, PROMPTS, tokens)
    for prompt, mine, theirs, ref in zip(PROMPTS, tokens, jax_tokens, refs):
        _assert_near_tie_parity(ref, mine, tol)
        if dtype == "float32":
            # equal up to the first step where the greedy choice is a
            # near-tie within 2e-5 (after it the sequences differ)
            n = next((i for i, (a, b) in enumerate(zip(mine, theirs))
                      if a != b), len(mine))
            assert mine[:n] == theirs[:n]
            if n < len(mine):
                assert abs(ref[n][mine[n]] - ref[n][theirs[n]]) <= tol, \
                    (prompt, mine, theirs)
    stats = eng.stats()
    assert stats["calls"]["prefill"] == len(PROMPTS)
    assert stats["kernel_launches"] == {"flash_fwd": 0, "flash_decode": 0}


def test_engine_without_device_needs_cuda(monkeypatch):
    """Entry points run on the card unless the caller asks for the CPU:
    without CUDA, ``device=None`` raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(GPTLightningModule(GPTConfig(**TINY)), buckets=BUCKETS,
                    slots=SLOTS, max_seq_len=TINY["block_size"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(GPTLightningModule(GPTConfig(**TINY)), buckets=BUCKETS,
                    slots=SLOTS, max_seq_len=TINY["block_size"],
                    device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPT(GPTConfig(**TINY))
    assert GPT(GPTConfig(**TINY), device="cpu").wpe.device.type == "cpu"


def test_engine_rejects_what_is_not_ported():
    mod = GPTLightningModule(GPTConfig(**TINY))
    for kw in ({"strategy": object()}, {"paged": object()},
               {"spec": object()}, {"kvship": True},
               {"compile_cache": "dir"}):
        with pytest.raises(NotImplementedError, match="not ported"):
            ServeEngine(mod, buckets=BUCKETS, slots=SLOTS,
                        max_seq_len=32, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="not ported"):
        Scheduler(buckets=BUCKETS, slots=SLOTS, max_seq_len=32,
                  spec=dataclasses.make_dataclass("S", ["enabled"])(True))
    with pytest.raises(NotImplementedError, match="not ported"):
        Scheduler(buckets=BUCKETS, slots=SLOTS,
                  max_seq_len=32).submit([1, 2], ship_kv=True)


def test_engine_seeded_init_and_position_validation():
    """A seeded engine is reproducible; decode positions outside the
    cache are refused on the host before any device write."""
    mod = GPTLightningModule(GPTConfig(**TINY, dtype=torch.float32))
    a = ServeEngine(mod, BUCKETS, SLOTS, 32, seed=7, device="cpu").setup()
    b = ServeEngine(mod, BUCKETS, SLOTS, 32, seed=7, device="cpu").setup()
    prompt = pad_to_bucket([3, 1, 4, 1, 5], 8)
    assert a.prefill(0, prompt, 5, 8) == b.prefill(0, prompt, 5, 8)
    assert a.kv_spec.shape == (2, SLOTS, 32, 2, 16)
    with pytest.raises(ValueError, match="positions"):
        a.decode(np.zeros(SLOTS, np.int32), np.full(SLOTS, 32, np.int32))
    with pytest.raises(ValueError, match="token ids"):
        a.prefill(1, pad_to_bucket([3, TINY["vocab_size"]], 8), 2, 8)


def test_serve_step_keeps_decode_before_prefill():
    """The decode's dummy write at position 0 of idle slots must land
    before an admitting prefill writes that slot, or it would clobber
    the prompt's first K/V row (worker.py serve_step docstring)."""
    calls = []

    class Recorder:
        def decode(self, tokens, positions):
            calls.append("decode")
            return np.zeros(SLOTS, np.int32)

        def prefill(self, slot, tokens, length, bucket):
            calls.append("prefill")
            return 1

    plan = {"prefills": [{"slot": 1, "tokens": pad_to_bucket([1], 8),
                          "length": 1, "bucket": 8}],
            "decode": {"tokens": np.zeros(SLOTS, np.int32),
                       "positions": np.zeros(SLOTS, np.int32),
                       "slots": [0]}}
    out = ServeWorker(Recorder()).serve_step(plan)
    assert calls == ["decode", "prefill"]
    assert out == {"prefill": {1: 1}, "decode": {0: 0}}
    with pytest.raises(NotImplementedError, match="not ported"):
        ServeWorker(Recorder()).serve_step(
            {"prefills": [], "decode": {**plan["decode"], "spec": True}})


# -- the copied host modules -------------------------------------------------

def test_buckets_and_slot_allocator_copies():
    bs = resolve_buckets(None, 300)
    assert bs[-1] == 300 and list(bs) == sorted(set(bs))
    assert bucket_for(17, (16, 64)) == 64
    with pytest.raises(ValueError, match="exceeds"):
        bucket_for(65, (16, 64))
    assert pad_to_bucket([3, 1, 4], 8)[0].tolist() == [3, 1, 4, 0, 0, 0, 0,
                                                        0]
    alloc = SlotAllocator(2)
    s0, s1 = alloc.acquire(), alloc.acquire()
    assert {s0, s1} == {0, 1} and alloc.acquire() is None
    alloc.release(s0)
    assert alloc.acquire() == s0
    spec = KVCacheSpec.from_capture([torch.zeros(1, 16, 4, 32)] * 2,
                                    slots=8, max_seq_len=64)
    assert spec.shape == (2, 8, 64, 4, 32)
    assert spec.nbytes(2) == 2 * 2 * 8 * 64 * 4 * 32 * 2


def _fake_step(sched):
    plan = sched.plan()
    if plan is None:
        return None
    result = {"prefill": {p["slot"]: 7 for p in plan["prefills"]},
              "decode": {}}
    if plan["decode"] is not None:
        result["decode"] = {s: 9 for s in plan["decode"]["slots"]}
    sched.apply(plan, result)
    return plan


def test_scheduler_copy_quota_fairness_eos_and_cap():
    sched = Scheduler(buckets=(8,), slots=4, max_seq_len=16,
                      quotas={"greedy": 1}, max_prefills_per_step=4,
                      default_max_new_tokens=3)
    reqs = [sched.submit([1, 2, 3], tenant="greedy") for _ in range(3)]
    quiet = sched.submit([1, 2], tenant="quiet")
    for _ in range(100):
        if sched.idle():
            break
        assert sched.stats()["per_tenant"]["greedy"]["active"] <= 1
        _fake_step(sched)
    assert all(r.done() for r in reqs) and quiet.done()
    assert quiet.t_admit <= reqs[1].t_admit    # not starved by greedy
    capped = Scheduler(buckets=(8,), slots=1, max_seq_len=8,
                       default_max_new_tokens=100).submit(np.arange(1, 7))
    assert capped.max_new_tokens == 8 - 6 + 1
    eos = Scheduler(buckets=(8,), slots=1, max_seq_len=32,
                    default_max_new_tokens=10, eos_token=9)
    req = eos.submit([1, 2, 3])
    _fake_step(eos)
    _fake_step(eos)
    assert req.result(1).tolist() == [7, 9]
    eos.submit([4])
    eos.fail_all(RuntimeError("fleet died"))
    assert eos.failed == 1 and eos.idle()


# -- package rules -----------------------------------------------------------

def test_package_imports_no_jax():
    """``import ray_lightning_tpu_torch`` pulls in neither jax, flax nor
    the JAX package (a fresh interpreter: this one imported them)."""
    code = (
        "import sys, ray_lightning_tpu_torch\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', "
        "'optax', 'ray_lightning_tpu') or m.startswith(('jax.', "
        "'flax.', 'optax.', 'ray_lightning_tpu.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stdout + out.stderr
