#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_lightning_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed 0]

Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``), and the build of
   every kernel from ``ray_lightning_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together);
2. kernels: each kernel against its plain PyTorch version on the card
   at the serve path's shapes (max abs error against the stated
   tolerance), timed with CUDA events beside its plain version, a
   PyTorch library call computing the same function (a yardstick the
   port never calls) and its bound (bytes at 3.35 TB/s or flops at
   989 TFLOP/s, whichever is larger, from this run's inputs);
3. serve: gpt2-small at full width (12 layers, 12 heads, n_embd 768,
   vocab 50304, context 1024), bf16, seeded weights, buckets
   (128, 256, 512, 1024), 16 slots; 16 requests from two tenants over
   all four buckets, 32 new tokens each, through ``Scheduler`` ->
   ``ServeWorker.serve_step`` -> ``ServeEngine``.  Every request must
   complete; the greedy tokens of four of them (one per bucket) must
   pass the teacher-forced parity rule against the whole-sequence
   forward with the plain attention (a bf16 near-tie within 2e-2 is
   allowed); each kernel must have launched exactly once per layer per
   prefill (flash_fwd) or decode step (flash_decode), counted from 0
   just before the serve loop;
4. profile: where a decode step and a bucket-1024 prefill spend their
   time (host wall, device kernel time by name, device busy share).

The next-to-last line is the ``{"kernels": [...]}`` JSON record; the
last is ``{"ok": true, "device": {...}}``.  Without CUDA the script
prints an error and exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from ray_lightning_tpu_torch.models.gpt import (  # noqa: E402
    GPT, GPTLightningModule)
from ray_lightning_tpu_torch.ops import _kernels  # noqa: E402
from ray_lightning_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_fwd, flash_attention_fwd_plain)
from ray_lightning_tpu_torch.ops.flash_decode import (  # noqa: E402
    flash_decode_attention, flash_decode_attention_plain)
from ray_lightning_tpu_torch.serve import (  # noqa: E402
    Scheduler, ServeEngine, ServeWorker)

#: H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense bf16
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
#: bf16 tolerance of the package's parity tests (tests/test_ops.py)
BF16_TOL = 2e-2
#: lse is fp32 from the same bf16 operands: only summation order and
#: the fast exp differ
LSE_TOL = 1e-3
#: L2 is 50 MB: writing 256 MB between launches evicts it
FLUSH_BYTES = 256 * 2 ** 20

H, D = 12, 64
C = H * D
SERVE_BUCKETS = (128, 256, 512, 1024)
SERVE_SLOTS = 16
NEW_TOKENS = 32
PROMPT_LENS = (17, 64, 100, 128, 150, 200, 256, 300, 400, 512, 600, 700,
               800, 900, 950, 990)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


#: GPU cycles of the ``torch.cuda._sleep`` that holds the stream while
#: the host queues a timed loop (~10 ms at H100 clocks): the events then
#: time the kernels back to back, not the host's launch rate
HOLD_CYCLES = 20_000_000


def time_ms(fn, *, iters: int = 30, warmup: int = 3,
            flush: "torch.Tensor | None" = None) -> float:
    """Mean device ms of ``fn`` over ``iters`` launches, timed with CUDA
    events behind a device-side sleep, so the host's launch cost stays
    out of the timing.  With ``flush`` each launch is timed alone after
    a write that evicts L2, so its inputs come from device memory
    cold."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    if flush is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    total = 0.0
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    for start, end in pairs:
        total += start.elapsed_time(end)
    return total / iters


def bound(nbytes: float, flops: float) -> "tuple[float, str]":
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record(name: str, replaces: str, shape: str, err: float,
           r: dict) -> dict:
    """One entry of the ``kernels`` JSON line.  ``max_abs_err``/``ms``
    and ``max_err``/``kernel_ms`` carry the same numbers under the two
    names readers of the line use; ``launches`` is filled in from the
    serve phase."""
    return {
        "name": name, "route": "cuda",
        "source": f"ray_lightning_tpu_torch/csrc/{name}.cu",
        "replaces": replaces, "shape": shape,
        "max_abs_err": err, "max_err": err, "tol": BF16_TOL,
        "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
    }


def check_close(name: str, err: float, tol: float) -> None:
    if not err <= tol:        # also catches NaN
        raise AssertionError(f"{name}: max abs error {err} > tol {tol}")


# -- phase 2: kernels --------------------------------------------------------


def kernel_flash_fwd(gen: torch.Generator) -> dict:
    """flash_fwd at B=1, H=12, D=64, causal, bf16, on the strided q/k/v
    views of a fused qkv projection (the prefill's layout).  Timed with
    a warm L2, as the prefill finds q/k/v just written by the qkv
    projection."""
    worst = 0.0
    rows = {}
    for T in (128, 200, 1024):
        qkv = torch.randn(1, T, 3 * C, generator=gen, device="cuda").to(
            torch.bfloat16)
        q, k, v = (x.view(1, T, H, D) for x in qkv.split(C, dim=-1))
        o, lse = flash_attention_fwd(q, k, v, causal=True)
        o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        finite = bool(torch.isfinite(o.float()).all())
        log(f"  flash_fwd T={T}: max_abs_err {err:.3e} (tol {BF16_TOL}), "
            f"lse max_abs_err {lse_err:.3e} (tol {LSE_TOL}), "
            f"finite {finite}")
        check_close(f"flash_fwd T={T}", err, BF16_TOL)
        check_close(f"flash_fwd lse T={T}", lse_err, LSE_TOL)
        if not finite:
            raise AssertionError(f"flash_fwd T={T}: non-finite output")
        worst = max(worst, err)
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
        plain_ms = time_ms(
            lambda: flash_attention_fwd_plain(q, k, v, causal=True))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        nbytes = 4 * T * C * 2 + H * T * 4        # q, k, v, o; fp32 lse
        flops = 4 * H * D * T * (T + 1) / 2       # QK^T + PV, causal
        b_ms, b_by = bound(nbytes, flops)
        log(f"  flash_fwd T={T}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        rows[T] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by)
    entry = record("flash_fwd",
                   "ray_lightning_tpu/ops/flash_attention.py:298",
                   "B=1 T=1024 H=12 D=64 causal bf16", worst, rows[1024])
    entry["ms_by_T"] = {str(t): rows[t]["ms"] for t in rows}
    return entry


def kernel_flash_decode(gen: torch.Generator, flush) -> dict:
    """flash_decode at S=16, L=1024, H=12, D=64, bf16; positions span
    the tile edges and the ends, the rest random."""
    S, L = SERVE_SLOTS, 1024
    fixed = [0, 1, 127, 128, 500, 1023]
    rand = torch.randint(0, L, (S - len(fixed),), generator=gen,
                         device="cuda")
    positions = torch.cat([torch.tensor(fixed, device="cuda"),
                           rand]).to(torch.int32)
    qkv = torch.randn(S, 1, 3 * C, generator=gen, device="cuda").to(
        torch.bfloat16)
    q = qkv[..., :C].view(S, 1, H, D)
    kc = torch.randn(S, L, H, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    vc = torch.randn(S, L, H, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    o = flash_decode_attention(q, kc, vc, positions)
    o_ref = flash_decode_attention_plain(q, kc, vc, positions)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    finite = bool(torch.isfinite(o.float()).all())
    log(f"  flash_decode S={S} L={L}: max_abs_err {err:.3e} "
        f"(tol {BF16_TOL}), finite {finite}, positions "
        f"{positions.tolist()}")
    check_close("flash_decode", err, BF16_TOL)
    if not finite:
        raise AssertionError("flash_decode: non-finite output")
    ms = time_ms(lambda: flash_decode_attention(q, kc, vc, positions),
                 flush=flush)
    plain_ms = time_ms(
        lambda: flash_decode_attention_plain(q, kc, vc, positions),
        flush=flush)
    mask = (torch.arange(L, device="cuda")[None, :]
            <= positions[:, None].long())[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, kc, vc))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), flush=flush)
    live_rows = int((positions.long() + 1).sum())
    nbytes = 2 * S * C * 2 + 2 * live_rows * C * 2 + S * 4
    flops = 4 * live_rows * C
    b_ms, b_by = bound(nbytes, flops)
    log(f"  flash_decode: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); "
        f"{live_rows} live rows, L2 flushed before each launch")
    return record("flash_decode", "ray_lightning_tpu/ops/flash_decode.py:158",
                  "S=16 L=1024 H=12 D=64 bf16, mixed positions", err,
                  dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by))


# -- phase 3: serve ----------------------------------------------------------


def check_parity(ref: GPT, req) -> "tuple[int, int]":
    """Teacher-forced greedy parity on the engine's own tokens: each
    generated token is the reference argmax, or a near-tie within the
    bf16 tolerance.  One causal forward over prompt + generated[:-1]
    gives every step's reference logits.  Returns (exact, near-ties)."""
    gen = [int(t) for t in req.result(0)]
    prompt = [int(t) for t in req.tokens]
    seq = torch.tensor([prompt + gen[:-1]], device="cuda")
    with torch.inference_mode():
        logits = ref(seq)[0, len(prompt) - 1:].float()
    if logits.shape[0] != len(gen) or not torch.isfinite(logits).all():
        raise AssertionError(f"request {req.id}: bad reference logits")
    exact = ties = 0
    for i, tok in enumerate(gen):
        best = int(logits[i].argmax())
        if tok == best:
            exact += 1
        elif logits[i, tok] >= logits[i, best] - BF16_TOL:
            ties += 1
        else:
            raise AssertionError(
                f"request {req.id} (prompt {len(prompt)}) step {i}: token "
                f"{tok} logit {float(logits[i, tok]):.4f} vs argmax {best} "
                f"{float(logits[i, best]):.4f}")
    return exact, ties


def serve_phase(seed: int) -> dict:
    module = GPTLightningModule("gpt2-small")
    cfg = module.config
    t0 = time.monotonic()
    engine = ServeEngine(module, buckets=SERVE_BUCKETS, slots=SERVE_SLOTS,
                         max_seq_len=cfg.block_size, seed=seed,
                         device="cuda").setup()
    log(f"  engine setup {time.monotonic() - t0:.2f} s: kv "
        f"{engine.kv_spec.shape}, decode attention {engine.decode_kernel}")
    if engine.decode_kernel != "flash_decode":
        raise AssertionError(f"decode runs {engine.decode_kernel}, not the "
                             f"flash_decode kernel")
    sched = Scheduler(buckets=engine.buckets, slots=engine.slots,
                      max_seq_len=engine.max_seq_len,
                      default_max_new_tokens=NEW_TOKENS)
    worker = ServeWorker(engine)
    rng = np.random.default_rng(seed)
    reqs = [sched.submit(rng.integers(0, cfg.vocab_size, n),
                         tenant=("alice", "bob")[i % 2])
            for i, n in enumerate(PROMPT_LENS)]

    calls0 = dict(engine.calls)
    secs0 = dict(engine.seconds)
    _kernels.reset_launches()
    t0 = time.monotonic()
    steps = 0
    while not sched.idle():
        plan = sched.plan()
        if plan is None or steps > 10_000:
            raise AssertionError("scheduler stalled with work left")
        sched.apply(plan, worker.serve_step(plan))
        steps += 1
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _kernels.launch_counts()
    prefills = engine.calls["prefill"] - calls0["prefill"]
    decodes = engine.calls["decode"] - calls0["decode"]

    if not all(r.done() and r.error is None for r in reqs):
        raise AssertionError("not every request completed")
    for r in reqs:
        toks = r.result(0)
        if len(toks) != NEW_TOKENS or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r.id}: bad tokens {toks}")
    n_layer = cfg.n_layer
    want = {"flash_fwd": n_layer * prefills,
            "flash_decode": n_layer * decodes}
    for name, n in want.items():
        if launches[name] != n or n == 0:
            raise AssertionError(
                f"{name} launched {launches[name]} times in the serve "
                f"phase; {n_layer} layers x steps want {n}")
    log(f"  {len(reqs)} requests done in {steps} steps, {wall:.3f} s; "
        f"{prefills} prefills, {decodes} decode steps; launches "
        f"{launches} (= {n_layer} x steps)")

    # reference: the same weights, whole-sequence forward, plain attention
    ref = GPT(dataclasses.replace(engine.model.config,
                                  attention_impl="dot"))
    ref.load_state_dict(engine.model.state_dict())
    ref.to(dtype=torch.bfloat16).eval()
    by_bucket = {}
    for r in reqs:
        by_bucket[r.bucket] = r      # the longest prompt of each bucket
    checked = []
    for b in SERVE_BUCKETS:
        r = by_bucket[b]
        exact, ties = check_parity(ref, r)
        checked.append((len(r.tokens), b, exact, ties))
        log(f"  parity: prompt {len(r.tokens)} (bucket {b}): {exact} "
            f"exact, {ties} near-ties of {NEW_TOKENS}")

    ttfts = sorted(r.ttft_s for r in reqs)
    tokens = sum(len(r.result(0)) for r in reqs)
    decode_ms = (engine.seconds["decode"] - secs0["decode"]) / decodes * 1e3
    prefill_ms = ((engine.seconds["prefill"] - secs0["prefill"])
                  / prefills * 1e3)
    stats = {
        "ttft_p50_ms": float(np.percentile(ttfts, 50)) * 1e3,
        "decode_step_ms": decode_ms,
        "prefill_ms": prefill_ms,
        "tokens_per_s": tokens / wall,
        "wall_s": wall,
        "requests": len(reqs),
        "prefills": prefills,
        "decode_steps": decodes,
        "parity_checked": checked,
    }
    log(f"  serve: TTFT p50 {stats['ttft_p50_ms']:.2f} ms, decode step "
        f"{decode_ms:.3f} ms, prefill {prefill_ms:.3f} ms, "
        f"{stats['tokens_per_s']:.1f} tokens/s")
    log("serve " + json.dumps(stats))
    return {"launches": launches, "engine": engine}


def _device_us(event) -> float:
    """Device time of a kernel-side profiler event (0 for host ops,
    whose self device time would count their kernels a second time)."""
    from torch.autograd import DeviceType
    if event.device_type != DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def profile_phase(engine, steps: int = 5) -> dict:
    """Where the serve loop's time goes: ``steps`` decode steps with all
    16 slots live at position 512, then one prefill at bucket 1024, each
    timed bare (host clock, ending in the token read) and under
    torch.profiler (device kernel time by name).  The device busy share
    is kernel time over the profiled wall; the profiler's own host cost
    makes it a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    S = engine.slots
    toks = np.ones(S, np.int32)
    pos = np.full(S, 512, np.int32)
    prompt = np.ones((1, 1024), np.int32)
    out = {}
    for kind, fn in (
            ("decode", lambda: engine.decode(toks, pos)),
            ("prefill_1024", lambda: engine.prefill(0, prompt, 1000, 1024))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        bare_ms = (time.perf_counter() - t0) / steps * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            prof_ms = (time.perf_counter() - t0) / steps * 1e3
        averages = prof.key_averages()
        events = [e for e in averages if _device_us(e) > 0]
        device_ms = sum(_device_us(e) for e in events) / steps / 1e3
        top = sorted(events, key=_device_us, reverse=True)[:8]
        host_top = sorted((e for e in averages if _device_us(e) == 0),
                          key=lambda e: e.self_cpu_time_total,
                          reverse=True)[:8]
        out[kind] = {
            "host_ms": bare_ms, "profiled_host_ms": prof_ms,
            "device_ms": device_ms,
            "device_busy_share": device_ms / prof_ms if prof_ms else None,
            "kernels_launched": sum(e.count for e in events) // steps,
            "top_device_ms": {e.key[:60]: _device_us(e) / steps / 1e3
                              for e in top},
            "top_host_self_ms": {
                e.key[:60]: e.self_cpu_time_total / steps / 1e3
                for e in host_top},
            "host_calls": {e.key[:60]: e.count // steps for e in host_top},
        }
        log(f"  {kind}: host {bare_ms:.3f} ms/step bare, {prof_ms:.3f} "
            f"profiled; device {device_ms:.3f} ms "
            f"({out[kind]['kernels_launched']} kernels); busy share "
            f"{out[kind]['device_busy_share']:.3f}")
        for name, ms in out[kind]["top_device_ms"].items():
            log(f"    device {ms:.4f} ms  {name}")
        for name, ms in out[kind]["top_host_self_ms"].items():
            log(f"    host {ms:.4f} ms  {out[kind]['host_calls'][name]}x "
                f"{name}")
    if not out["decode"]["device_ms"] > 0:
        raise AssertionError("the profiler saw no device time")
    log("profile " + json.dumps(out))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 1

    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    build_s = _kernels.build()
    log(f"build: {build_s:.2f} s for {sorted(_kernels.REGISTRY)}")
    for name, k in _kernels.REGISTRY.items():
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    log("kernel phase")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    entries = [kernel_flash_fwd(gen),
               kernel_flash_decode(gen, flush)]
    del flush

    log("serve phase")
    served = serve_phase(args.seed)
    for e in entries:
        e["launches"] = served["launches"][e["name"]]

    log("profile phase")
    profile_phase(served["engine"])

    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
