#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_lightning_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed 0]

Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``), and the build of
   every kernel from ``ray_lightning_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together);
2. kernels: each kernel against its plain PyTorch version on the card
   at the serve and training paths' shapes (max abs error within 2e-2;
   flash_bwd's dq, dk, dv in relative L2 within 1e-3), timed with CUDA events beside its plain version, a
   PyTorch library call computing the same function (a yardstick the
   port never calls) and its bound (bytes at 3.35 TB/s or flops at
   989 TFLOP/s, whichever is larger, from this run's inputs): flash_fwd
   at the serve shapes (B=1) and the training shape (B=8, T=1024),
   flash_bwd at B=8, T=128, 200 (ragged) and 1024, flash_decode at 16
   slots;
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
4. train: ``Trainer(max_steps=N).fit(GPTLightningModule("gpt2-small",
   batch_size=8))`` at full width, T=1024, bf16-resident params with the
   fp32 master, N=20 steps (warmup 2): every loss finite and the last
   below the first; flash_fwd and flash_bwd each launched exactly 12 x N
   times in the fit, counted from 0 at its start; one step's gradients
   against the same model with plain attention (``attention_impl="dot"``,
   plain autograd) on the same weights and batch, per-tensor relative L2
   error within 2e-2; the first 3 losses of a 3-step fit of that model
   within 2e-2 of the flash run's; step ms (median after the first two,
   host wall, synced), tokens/s, peak memory and MFU (model flops over
   989 TFLOP/s);
5. profile: where a decode step, a bucket-1024 prefill and a train step
   spend their time (host wall, device kernel time by name, device busy
   share).

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

from ray_lightning_tpu_torch import Callback, Trainer  # noqa: E402
from ray_lightning_tpu_torch.core.module import StepContext  # noqa: E402
from ray_lightning_tpu_torch.models.gpt import (  # noqa: E402
    CONFIGS, GPT, GPTLightningModule)
from ray_lightning_tpu_torch.ops import _kernels  # noqa: E402
from ray_lightning_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_fwd_plain)
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
#: the training path's shape: gpt2-small at B=8, T=1024 (bench.py)
TRAIN_B, TRAIN_T = 8, 1024
TRAIN_STEPS = 20
#: gradient parity against plain attention: per-tensor relative L2
GRAD_TOL = 2e-2
#: flash_bwd against its plain backward: per-tensor relative L2.  The
#: two share every rounding point and differ only in summation order;
#: a fault confined to one 64-row tile moves a T=1024 gradient's
#: relative L2 by a few percent, far past this limit
BWD_TOL = 1e-3
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
           r: dict, tol: float = BF16_TOL) -> dict:
    """One entry of the ``kernels`` JSON line.  ``max_abs_err``/``ms``
    and ``max_err``/``kernel_ms`` carry the same numbers under the two
    names readers of the line use; ``launches`` is filled in from the
    serve and train phases."""
    return {
        "name": name, "route": "cuda",
        "source": f"ray_lightning_tpu_torch/csrc/{name}.cu",
        "replaces": replaces, "shape": shape,
        "max_abs_err": err, "max_err": err, "tol": tol,
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
    entry["train_shape"] = fwd_train_shape(gen)
    return entry


def fwd_train_shape(gen: torch.Generator) -> dict:
    """flash_fwd at the training shape (B=8, T=1024, fused-qkv views),
    timed as the serve rows are, with its bound and the SDPA yardstick."""
    B, T = TRAIN_B, TRAIN_T
    qkv = torch.randn(B, T, 3 * C, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = (x.view(B, T, H, D) for x in qkv.split(C, dim=-1))
    o, _ = flash_attention_fwd(q, k, v, causal=True)
    o_ref, _ = flash_attention_fwd_plain(q, k, v, causal=True)
    err = (o.float() - o_ref.float()).abs().max().item()
    check_close(f"flash_fwd B={B} T={T}", err, BF16_TOL)
    ms = time_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
    plain_ms = time_ms(lambda: flash_attention_fwd_plain(q, k, v,
                                                         causal=True))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    nbytes = B * (4 * T * C * 2 + H * T * 4)
    flops = B * 4 * H * D * T * (T + 1) / 2
    b_ms, b_by = bound(nbytes, flops)
    log(f"  flash_fwd B={B} T={T}: max_abs_err {err:.3e}; kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by})")
    return dict(shape=f"B={B} T={T} H=12 D=64 causal bf16", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by)


def rel_l2(got, want) -> float:
    """||got - want|| / ||want||, the denominator at least that of a
    tensor of RMS 1e-3: dq and dk at T=1 are zero but for rounding."""
    got, want = got.float(), want.float()
    floor = 1e-3 * want.numel() ** 0.5
    return ((got - want).norm() / want.norm().clamp_min(floor)).item()


def max_over_rms(got, want) -> float:
    """max |got - want| over the RMS of ``want`` (reported beside the
    relative L2: it sees an error confined to a few rows)."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.pow(2).mean().sqrt()).item()


def kernel_flash_bwd(gen: torch.Generator) -> dict:
    """flash_bwd at B=8, H=12, D=64, causal, bf16, on the fused-qkv
    views, at T=128, 200 (ragged) and 1024, against the plain backward
    on the same o, lse and dO: each of dq, dk, dv within ``BWD_TOL``
    in relative L2, its max abs error over RMS reported.  Timed at T=1024
    beside the plain version and the SDPA backward
    (``torch.autograd.grad`` of ``scaled_dot_product_attention`` with a
    retained graph, the backward alone)."""
    B = TRAIN_B
    worst = worst_abs = worst_mr = 0.0
    for T in (128, 200, TRAIN_T):
        qkv = torch.randn(B, T, 3 * C, generator=gen, device="cuda").to(
            torch.bfloat16)
        q, k, v = (x.view(B, T, H, D) for x in qkv.split(C, dim=-1))
        do = torch.randn(B, T, H, D, generator=gen, device="cuda").to(
            torch.bfloat16)
        o, lse = flash_attention_fwd(q, k, v, causal=True)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
        torch.cuda.synchronize()
        names = ("dq", "dk", "dv")
        errs = {n: rel_l2(a, b) for n, a, b in zip(names, got, want)}
        mrs = {n: max_over_rms(a, b) for n, a, b in zip(names, got, want)}
        abs_err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got, want))
        finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
        log(f"  flash_bwd T={T}: relative L2 "
            + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
            + f" (tol {BWD_TOL}); max abs error over RMS "
            + ", ".join(f"{n} {e:.3e}" for n, e in mrs.items())
            + f"; max abs error {abs_err:.3e}; finite {finite}")
        for n, e in errs.items():
            if not e <= BWD_TOL:        # also catches NaN
                raise AssertionError(f"flash_bwd {n} T={T}: relative L2 "
                                     f"{e} > tol {BWD_TOL}")
        if not finite:
            raise AssertionError(f"flash_bwd T={T}: non-finite output")
        worst = max(worst, *errs.values())
        worst_mr = max(worst_mr, *mrs.values())
        worst_abs = max(worst_abs, abs_err)
    ms = time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                             causal=True))
    plain_ms = time_ms(lambda: flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal=True), iters=10)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    gout = do.transpose(1, 2)
    lib_ms = time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), gout, retain_graph=True))
    del out
    T = TRAIN_T
    # q, k, v, o, dO read and dq, dk, dv written, fp32 lse read; five
    # causal [T, T] products of T^2 D multiply-adds over two a head
    nbytes = B * (8 * T * C * 2 + H * T * 4)
    flops = B * H * 5 * 2 * D * T * (T + 1) / 2
    b_ms, b_by = bound(nbytes, flops)
    log(f"  flash_bwd B={B} T={T}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, sdpa backward {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB")
    entry = record("flash_bwd",
                   "ray_lightning_tpu/ops/flash_attention.py:329",
                   f"B={B} T={T} H=12 D=64 causal bf16", worst_abs,
                   dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=b_ms, bound_by=b_by), tol=BWD_TOL)
    entry.update(err_metric="per-tensor relative L2 (tol applies)",
                 rel_l2=worst, max_abs_over_rms=worst_mr)
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


# -- phase 4: train -----------------------------------------------------------


class StepClock(Callback):
    """Per-step host wall (synced before and after the step) and loss."""

    def __init__(self):
        self.ms: "list[float]" = []
        self.losses: "list[float]" = []

    def on_train_batch_start(self, trainer, module, batch, batch_idx):
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx):
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - self._t0) * 1e3)
        self.losses.append(float(outputs["loss"]))


def fit(module, steps: int, seed: int):
    clock = StepClock()
    trainer = Trainer(max_steps=steps, enable_checkpointing=False,
                      num_sanity_val_steps=0, limit_val_batches=0,
                      seed=seed, callbacks=[clock], device="cuda")
    trainer.fit(module)
    return trainer, clock


def gpt2_small(attention_impl: str = "auto"):
    cfg = dataclasses.replace(CONFIGS["gpt2-small"],
                              attention_impl=attention_impl)
    return GPTLightningModule(cfg, batch_size=TRAIN_B, warmup_steps=2,
                              dataset_size=TRAIN_B * TRAIN_STEPS)


def first_batch(module):
    return tuple(x.to("cuda") for x in next(iter(module.train_dataloader())))


def step_grads(attention_impl: str, seed: int, batch) -> dict:
    """One step's gradients of the loss on ``batch`` for gpt2-small with
    the seeded init cast to bf16, as the trainer makes it."""
    module = gpt2_small(attention_impl)
    module.init_params(torch.Generator(device="cuda").manual_seed(seed))
    module.model.to(dtype=module.param_dtype)
    params = dict(module.model.named_parameters())
    loss = module.training_step(StepContext(module, training=True), batch)
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def model_flops_per_step(cfg, B: int, T: int) -> float:
    """6 x (matmul params + tied head) x tokens + causal attention: the
    QK^T and PV products, 2 T^2 C multiply-adds over two a layer per
    sequence forward, times 3 for forward and backward."""
    L, Cm, V = cfg.n_layer, cfg.n_embd, cfg.vocab_size
    return 6 * B * T * (12 * L * Cm * Cm + V * Cm) + 6 * B * L * T * T * Cm


def train_phase(seed: int, card: str) -> dict:
    n = TRAIN_STEPS
    module = gpt2_small()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.monotonic()
    trainer, clock = fit(module, n, seed)
    wall = time.monotonic() - t0
    launches = _kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = clock.losses
    log(f"  fit: {n} steps in {wall:.2f} s (set-up included); losses "
        + " ".join(f"{x:.4f}" for x in losses))
    if len(losses) != n or trainer.global_step != n:
        raise AssertionError(f"fit ran {len(losses)} steps, want {n}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    cfg = module.config
    for name in ("flash_fwd", "flash_bwd"):
        if launches[name] != cfg.n_layer * n:
            raise AssertionError(
                f"{name} launched {launches[name]} times in the fit; "
                f"{cfg.n_layer} layers x {n} steps want {cfg.n_layer * n}")
    log(f"  launches in the fit: {launches} (= {cfg.n_layer} x {n} for "
        f"flash_fwd and flash_bwd)")
    p_dtypes = {str(p.dtype) for p in module.model.parameters()}
    master = trainer.state.opt_state.master
    log(f"  params {sorted(p_dtypes)}, fp32 master of {len(master)} "
        f"tensors")

    step_ms = float(np.median(clock.ms[2:]))
    tokens = TRAIN_B * TRAIN_T
    flops = model_flops_per_step(cfg, TRAIN_B, TRAIN_T)
    mfu = flops / (step_ms / 1e3) / BF16_FLOPS_PER_S
    stats = {"card": card, "steps": n, "batch": TRAIN_B, "seq": TRAIN_T,
             "step_ms_median": step_ms, "step_ms": clock.ms,
             "tokens_per_s": tokens / (step_ms / 1e3),
             "peak_memory_gb": peak_gb,
             "memory_before_fit_gb": base_gb, "model_flops_per_step": flops,
             "mfu": mfu, "losses": losses}
    log(f"  [{card}] step {step_ms:.3f} ms (median of steps 3-{n}, host "
        f"wall, synced), {stats['tokens_per_s']:.0f} tokens/s, peak "
        f"memory {peak_gb:.2f} GB ({base_gb:.2f} GB held before the fit: "
        f"the serve engine), model flops {flops / 1e12:.3f} TFLOP a "
        f"step (6 x (12 L C^2 + V C) x B T + 6 B L T^2 C), MFU {mfu:.4f} "
        f"of 989 TFLOP/s")

    # the profile phase runs the fit's own step on its state and batch
    batch = first_batch(module)

    def train_step():
        trainer.state, _ = trainer._train_step(trainer.state, batch)

    # gradient parity: one step from the same weights and batch, plain
    # attention under autograd as the reference
    g_flash = step_grads("auto", seed, batch)
    g_dot = step_grads("dot", seed, batch)
    rel = {k: ((g_flash[k].float() - g_dot[k].float()).norm()
               / g_dot[k].float().norm().clamp_min(1e-30)).item()
           for k in g_dot}
    worst = sorted(rel.items(), key=lambda kv: -kv[1])
    log(f"  grad parity vs dot attention: per-tensor relative L2 max "
        f"{worst[0][1]:.3e} ({worst[0][0]}), median "
        f"{float(np.median(list(rel.values()))):.3e} (tol {GRAD_TOL}); "
        f"worst: " + ", ".join(f"{k} {v:.3e}" for k, v in worst[:4]))
    if not all(np.isfinite(v) and v <= GRAD_TOL for v in rel.values()):
        raise AssertionError(f"gradient parity: {worst[:4]}")
    del g_flash, g_dot
    torch.cuda.empty_cache()

    # the same data: the dataset's draws depend on its size
    _, dot_clock = fit(gpt2_small("dot"), 3, seed)
    diffs = [abs(a - b) for a, b in zip(losses[:3], dot_clock.losses)]
    log(f"  first 3 losses: flash {losses[:3]}, dot {dot_clock.losses}; "
        f"abs diff {max(diffs):.3e} (tol {BF16_TOL})")
    if len(dot_clock.losses) != 3 or not max(diffs) <= BF16_TOL:
        raise AssertionError("first 3 losses disagree with the dot run")
    stats.update(grad_rel_l2_max=worst[0][1], loss_diff_first3=max(diffs))
    log("train " + json.dumps(stats))
    torch.cuda.empty_cache()
    return {"launches": launches, "stats": stats, "train_step": train_step}


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


#: device-kernel name fragments -> the layer they belong to
CATEGORIES = (("flash_", "attention kernels"), ("nvjet", "GEMM"),
              ("gemm", "GEMM"), ("cutlass", "GEMM"), ("xmma", "GEMM"),
              ("multi_tensor_apply", "optimizer (foreach)"),
              ("layer_norm", "layer norm"), ("reduce_kernel", "reductions"),
              ("index", "gather / scatter"), ("scatter", "gather / scatter"),
              ("gather", "gather / scatter"), ("elementwise", "elementwise"))


def category(name: str) -> str:
    low = name.lower()
    return next((c for frag, c in CATEGORIES if frag in low), "other")


def profile_phase(engine, train_step, steps: int = 5) -> dict:
    """Where the time goes: ``steps`` decode steps with all 16 slots live
    at position 512, one prefill at bucket 1024 and one gpt2-small train
    step at B=8, T=1024 (``train_step()``, 3 times), each timed bare (host
    clock, ending in a sync) and under torch.profiler (device kernel time
    by name).  The device busy share is kernel time over the profiled
    wall; the profiler's own host cost makes it a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    S = engine.slots
    toks = np.ones(S, np.int32)
    pos = np.full(S, 512, np.int32)
    prompt = np.ones((1, 1024), np.int32)
    out = {}
    for kind, fn, steps in (
            ("decode", lambda: engine.decode(toks, pos), steps),
            ("prefill_1024", lambda: engine.prefill(0, prompt, 1000, 1024),
             steps),
            ("train_step", train_step, 3)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        bare_ms = (time.perf_counter() - t0) / steps * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) / steps * 1e3
        averages = prof.key_averages()
        events = [e for e in averages if _device_us(e) > 0]
        device_ms = sum(_device_us(e) for e in events) / steps / 1e3
        top = sorted(events, key=_device_us, reverse=True)[:10]
        by_cat: "dict[str, float]" = {}
        for e in events:
            c = category(e.key)
            by_cat[c] = by_cat.get(c, 0.0) + _device_us(e) / steps / 1e3
        host_top = sorted((e for e in averages if _device_us(e) == 0),
                          key=lambda e: e.self_cpu_time_total,
                          reverse=True)[:8]
        out[kind] = {
            "host_ms": bare_ms, "profiled_host_ms": prof_ms,
            "device_ms": device_ms,
            "device_busy_share": device_ms / prof_ms if prof_ms else None,
            "device_share_of_bare_ms": device_ms / bare_ms,
            "kernels_launched": sum(e.count for e in events) // steps,
            "top_device_ms": [[e.key[:100], _device_us(e) / steps / 1e3]
                              for e in top],
            "device_ms_by_category": dict(sorted(
                by_cat.items(), key=lambda kv: -kv[1])),
            "top_host_self_ms": {
                e.key[:60]: e.self_cpu_time_total / steps / 1e3
                for e in host_top},
            "host_calls": {e.key[:60]: e.count // steps for e in host_top},
        }
        log(f"  {kind}: host {bare_ms:.3f} ms/step bare, {prof_ms:.3f} "
            f"profiled; device {device_ms:.3f} ms "
            f"({out[kind]['kernels_launched']} kernels); busy share "
            f"{out[kind]['device_busy_share']:.3f} of the profiled wall, "
            f"{out[kind]['device_share_of_bare_ms']:.3f} of the bare one")
        for name, ms in out[kind]["device_ms_by_category"].items():
            log(f"    device {ms:.4f} ms  [{name}]")
        for name, ms in out[kind]["top_device_ms"]:
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
    entries = [kernel_flash_fwd(gen), kernel_flash_bwd(gen),
               kernel_flash_decode(gen, flush)]
    del flush
    torch.cuda.empty_cache()

    card = card_line()
    log("serve phase")
    served = serve_phase(args.seed)
    log("train phase")
    trained = train_phase(args.seed, card)
    for e in entries:
        by_path = {"serve": served["launches"][e["name"]],
                   "train": trained["launches"][e["name"]]}
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path

    log("profile phase")
    profile_phase(served["engine"], trained["train_step"])

    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
