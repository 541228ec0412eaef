"""PyTorch/CUDA port, kernels on the card: each hand-written CUDA kernel
of ``ray_lightning_tpu_torch`` against its plain PyTorch version, at the
serve and training paths' shapes and at edge lengths, in bf16: outputs
within 2e-2 in max abs error; the backward's dq, dk, dv in per-tensor
relative L2, within 1e-3 of the plain backward (same rounding points)
and within 1e-2 of plain attention under autograd (which rounds
elsewhere).  A max abs error would have to allow for the few rows whose
gradients grow past 1 with T, and would then miss a fault confined to a
tile of small gradients.

The strategies' collectives are held on NCCL too: at one rank in a
process group of the test process (the DDP sync and the metric mean an
identity, ZeRO-1's update equal to the unsharded one), and, with two or
more cards, through the plugins' workers, one a card (ZeRO-1 against
DDP).  The workers unpickle this module's callbacks by name.  The loop
engine's graphed chunks (``steps_per_execution`` on the card) equal the
eager fits bit for bit, in process, under a one-rank NCCL group and,
with two or more cards, cached across workers against one process.  The
serve engine captures each program once at setup, each replay equals
the eager step it was captured from bit for bit, and, with two or more
cards, ``Server(num_workers=2)`` puts a worker on each.  The sharded
strategies: under ``"fsdp"`` and ``"spmd"`` a graphed chunk equals the
eager fit in process; ``tensor=2`` over two ranks against one (both on
card 0 over gloo, or NCCL with two cards); with two cards FSDP against
DDP bit for bit over NCCL and a two-rank sharded checkpoint restored in
one process.  Serving under ``tensor=2`` with two cards: NCCL serves the
tokens gloo on card 0 serves, and each rank's captured decode and
prefill equal their eager steps bit for bit.

Every test here is marked ``cuda`` and skips without a card (decided
when the test runs, never while the module is imported).  The file
imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: tests/conftest.py sets up JAX for the rest of the
suite.)
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch import (GPT, BertLightningModule,
                                     BertMLMModule, Callback,
                                     GPTLightningModule, Scheduler,
                                     ServeEngine, ServeWorker, Server,
                                     Trainer)
from ray_lightning_tpu_torch.models.bert import CONFIGS as BERT_CONFIGS
from ray_lightning_tpu_torch.models.gpt import GPTConfig
from ray_lightning_tpu_torch.ops import _kernels
from ray_lightning_tpu_torch.ops.attention import dot_product_attention
from ray_lightning_tpu_torch.ops.flash_attention import (
    HEAD_DIMS, flash_attention, flash_attention_bwd,
    flash_attention_bwd_passes, flash_attention_bwd_plain,
    flash_attention_fwd, flash_attention_fwd_plain)
from ray_lightning_tpu_torch.ops import flash_attention as fa
from ray_lightning_tpu_torch.ops import flash_decode as fd
from ray_lightning_tpu_torch.ops import random as trandom
from ray_lightning_tpu_torch.ops.flash_decode import (
    flash_decode_attention, flash_decode_attention_plain,
    flash_decode_paged_attention, flash_decode_paged_attention_plain,
    flash_decode_split_plain)
from ray_lightning_tpu_torch.serve import PageConfig, SpecConfig


@pytest.fixture
def cuda_device():
    """The card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 16, 63, 65, 127, 128, 129, 200, 1024,
                               2050])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_cuda_flash_fwd_kernel_matches_plain(D, causal, T, cuda_device):
    """Every head dim the kernel takes, causal and not, at lengths that
    cross each 64- and 128-row tile boundary, 25 heads (GPT-2 XL's, which
    the JAX package folds) as strided views of a fused qkv projection: o
    within 2e-2 and lse within 1e-3 of the plain version, one launch a
    call, and a second launch equal bit for bit (no atomics)."""
    g = torch.Generator(device=cuda_device).manual_seed(T * D + causal)
    B, H = 2, 25
    qkv = torch.randn(B, T, 3 * H * D, generator=g,
                      device=cuda_device).to(torch.bfloat16)
    q, k, v = (x.view(B, T, H, D) for x in qkv.split(H * D, dim=-1))
    before = _kernels.REGISTRY["flash_fwd"].launches
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    o2, lse2 = flash_attention_fwd(q, k, v, causal=causal)
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _kernels.REGISTRY["flash_fwd"].launches == before + 2
    assert o.shape == (B, T, H, D) and lse.shape == (B, H, T)
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def _rel_l2(got, want) -> float:
    """||got - want|| / ||want||, the denominator at least that of a
    tensor of RMS 1e-3: dq and dk at T=1 are zero but for rounding."""
    got, want = got.float(), want.float()
    floor = 1e-3 * want.numel() ** 0.5
    return ((got - want).norm() / want.norm().clamp_min(floor)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T", [1, 16, 128, 200, 1024])
def test_cuda_flash_bwd_kernel_matches_plain(T, D, causal, cuda_device):
    """dq, dk, dv of the kernel against the plain backward on the same
    o, lse and do, with q/k/v the strided views of a fused projection;
    one launch per backward call."""
    g = torch.Generator(device=cuda_device).manual_seed(T * D)
    B, H = 2, 12
    qkv = torch.randn(B, T, 3 * H * D, generator=g,
                      device=cuda_device).to(torch.bfloat16)
    q, k, v = (x.view(B, T, H, D) for x in qkv.split(H * D, dim=-1))
    do = torch.randn(B, T, H, D, generator=g, device=cuda_device).to(
        torch.bfloat16)
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    before = _kernels.REGISTRY["flash_bwd"].launches
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert _kernels.REGISTRY["flash_bwd"].launches == before + 1
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == (B, T, H, D)
        assert torch.isfinite(a.float()).all(), name
        assert _rel_l2(a, b) <= 1e-3, (name, _rel_l2(a, b))


def _bwd_inputs(g, B, T, H, D, device):
    """q, k, v as the strided views of a fused qkv projection, and do."""
    qkv = torch.randn(B, T, 3 * H * D, generator=g,
                      device=device).to(torch.bfloat16)
    q, k, v = (x.view(B, T, H, D) for x in qkv.split(H * D, dim=-1))
    do = torch.randn(B, T, H, D, generator=g, device=device).to(
        torch.bfloat16)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 128, 129, 200])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_cuda_flash_bwd_kernel_matches_plain_at_tile_edges(D, causal, T,
                                                           cuda_device):
    """The backward's tile edges: its 64-row streamed tiles and 128-row
    resident blocks (T = 1, 63, 64, 65, 127, 128, 129, 200), every head
    dim, causal and not, 25 heads as strided views of a fused qkv
    projection.  dq, dk, dv within 1e-3 relative L2 of the plain
    backward, one launch a call, and two calls equal bit for bit (no
    atomics)."""
    g = torch.Generator(device=cuda_device).manual_seed(T * D + causal)
    B, H = 2, 25
    q, k, v, do = _bwd_inputs(g, B, T, H, D, cuda_device)
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    before = _kernels.REGISTRY["flash_bwd"].launches
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert _kernels.REGISTRY["flash_bwd"].launches == before + 2
    for name, a, a2, b in zip(("dq", "dk", "dv"), got, again, want):
        assert a.dtype == torch.bfloat16 and a.shape == (B, T, H, D)
        assert torch.isfinite(a.float()).all(), name
        assert torch.equal(a, a2), name
        assert _rel_l2(a, b) <= 1e-3, (name, _rel_l2(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_bwd_passes_in_order_equal_one_call(causal, cuda_device):
    """The per-pass entry points (delta, dk/dv, dq; for timing a pass)
    called in order give one call's dq, dk, dv bit for bit, and count on
    their own kernels, not on ``flash_bwd``."""
    g = torch.Generator(device=cuda_device).manual_seed(3 + causal)
    B, T, H, D = 2, 333, 4, 64
    q, k, v, do = _bwd_inputs(g, B, T, H, D, cuda_device)
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    want = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    _kernels.reset_launches()
    passes, got = flash_attention_bwd_passes(q, k, v, o, lse, do,
                                             causal=causal)
    for name in ("delta", "dkdv", "dq"):
        passes[name]()
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    assert counts["flash_bwd"] == 0
    assert all(counts[f"flash_bwd_{n}"] == 1 for n in passes)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("T", [2048, 2050, 4096])
def test_cuda_flash_kernels_match_plain_at_long_context(T, cuda_device):
    """The long-context lengths: T=2048 (where the JAX package takes its
    row-resident kernels), 4096 (its triangular backward) and a ragged
    2050, two heads of 64 on fused-qkv views.  o within 2e-2, lse within
    1e-3, dq, dk, dv within 1e-3 relative L2 of the plain versions; one
    launch each.  A second forward (the remat recompute) gives the same
    o and lse bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(T)
    B, H, D = 2, 2, 64
    qkv = torch.randn(B, T, 3 * H * D, generator=g,
                      device=cuda_device).to(torch.bfloat16)
    q, k, v = (x.view(B, T, H, D) for x in qkv.split(H * D, dim=-1))
    do = torch.randn(B, T, H, D, generator=g, device=cuda_device).to(
        torch.bfloat16)
    _kernels.reset_launches()
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["flash_fwd"] == 1
    assert _kernels.launch_counts()["flash_bwd"] == 1
    o2, lse2 = flash_attention_fwd(q, k, v, causal=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, causal=True)
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a.float()).all(), name
        assert _rel_l2(a, b) <= 1e-3, (name, _rel_l2(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,D,causal", [
    (4, 512, 12, 64, False),     # bert-base's heads, bidirectional
    (2, 200, 12, 64, False),     # ragged, bidirectional
    (2, 64, 2, 32, False),       # the tiny BERT: heads that do not pack
    (2, 64, 2, 32, True),
    (2, 1024, 2, 32, True),      # the tiny-width GPT fits
    (2, 2048, 2, 32, True),
    (2, 2050, 2, 32, False),
])
def test_cuda_flash_kernels_match_plain_on_folded_routes(B, T, H, D, causal,
                                                         cuda_device):
    """The shapes of the JAX package's folded routes and of BERT: non-
    causal at T=512 and a ragged 200, and D=32 causal and not, on the
    views of a fused projection (strides 3 H D).  o within 2e-2, lse
    within 1e-3, dq, dk, dv within 1e-3 relative L2 of the plain
    versions; one launch each."""
    g = torch.Generator(device=cuda_device).manual_seed(T + D + causal)
    qkv = torch.randn(B, T, 3 * H * D, generator=g,
                      device=cuda_device).to(torch.bfloat16)
    q, k, v = (x.view(B, T, H, D) for x in qkv.split(H * D, dim=-1))
    do = torch.randn(B, T, H, D, generator=g, device=cuda_device).to(
        torch.bfloat16)
    _kernels.reset_launches()
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    assert counts["flash_fwd"] == counts["flash_bwd"] == 1
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, causal=causal)
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a.float()).all(), name
        assert _rel_l2(a, b) <= 1e-3, (name, _rel_l2(a, b))


@pytest.mark.cuda
def test_cuda_flash_kernels_refuse_a_grid_past_cuda_limits(cuda_device):
    """Both kernels run a block per (b * h, 128-row block of T): B * H is
    grid x (CUDA caps it at 2**31 - 1) and the row blocks grid y (at
    65535).  So B * H = 65536, past grid y's cap, runs the forward and
    the backward and both match their plain versions, and a T past
    65535 blocks raises in each wrapper instead of launching a grid the
    card refuses."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(65536, 1, 1, 64, generator=g,
                    device=cuda_device).to(torch.bfloat16)
    o, lse = flash_attention_fwd(x, x, x)
    o_ref, lse_ref = flash_attention_fwd_plain(x, x, x)
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    do = torch.randn(65536, 1, 1, 64, generator=g,
                     device=cuda_device).to(torch.bfloat16)
    got = flash_attention_bwd(x, x, x, o, lse, do)
    want = flash_attention_bwd_plain(x, x, x, o, lse, do)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a.float()).all(), name
        assert _rel_l2(a, b) <= 1e-3, (name, _rel_l2(a, b))
    T = 65535 * 128 + 1
    long = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16,
                       device=cuda_device).expand(1, T, 1, 64)
    with pytest.raises(ValueError, match="T <= 8388480"):
        flash_attention_fwd(long, long, long)
    long_lse = torch.zeros(1, 1, T, device=cuda_device)
    with pytest.raises(ValueError, match="T <= 8388480"):
        flash_attention_bwd(long, long, long, long, long_lse, long)


@pytest.mark.cuda
def test_cuda_flash_attention_trains_through_the_kernels(cuda_device):
    """The fault this guards: ``flash_attention`` on a CUDA tensor used to
    launch the forward on raw pointers, so q/k/v got no gradient.  Now
    autograd reaches the backward kernel: one forward and one backward
    launch, non-zero gradients that match plain attention's within 1e-2
    relative L2 (the two round at different points)."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    B, T, H, D = 2, 256, 12, 64
    qkv = torch.randn(B, T, 3 * H * D, generator=g, device=cuda_device).to(
        torch.bfloat16).requires_grad_()
    w = torch.randn(B, T, H, D, generator=g, device=cuda_device)

    def grads(attend):
        q, k, v = (x.view(B, T, H, D) for x in qkv.split(H * D, dim=-1))
        out = attend(q, k, v, causal=True, dtype=torch.bfloat16)
        return torch.autograd.grad((out.float() * w).sum(), qkv)[0]

    _kernels.reset_launches()
    got = grads(flash_attention)
    counts = _kernels.launch_counts()
    assert counts["flash_fwd"] == 1 and counts["flash_bwd"] == 1
    want = grads(dot_product_attention)
    for part, ref in zip(got.split(H * D, -1), want.split(H * D, -1)):
        assert part.float().abs().max().item() > 0
        assert _rel_l2(part, ref) <= 1e-2, _rel_l2(part, ref)


@pytest.mark.cuda
def test_cuda_flash_decode_kernel_matches_plain(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    S, L, H, D = 16, 1024, 12, 64
    q = torch.randn(S, 1, H, D, generator=g, device=cuda_device).to(
        torch.bfloat16)
    kc = torch.randn(S, L, H, D, generator=g, device=cuda_device).to(
        torch.bfloat16)
    vc = torch.randn(S, L, H, D, generator=g, device=cuda_device).to(
        torch.bfloat16)
    pos = torch.tensor([0, 1, 63, 64, 127, 128, 500, 1023] * 2,
                       dtype=torch.int32, device=cuda_device)
    before = _kernels.REGISTRY["flash_decode"].launches
    o = flash_decode_attention(q, kc, vc, pos)
    o_ref = flash_decode_attention_plain(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert _kernels.REGISTRY["flash_decode"].launches == before + 1
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2


def _plan(S: int, H: int, L: int) -> "tuple[int, int]":
    """The split plan the wrappers take on this card."""
    return fd.decode_split_plan(S, H, L, fd._sm_count(0))


def _force_chunk(monkeypatch, chunk: int) -> None:
    """Every decode launch takes ``chunk`` rows a split: the wrappers
    look the plan up by its name in the module."""
    monkeypatch.setattr(fd, "decode_split_plan",
                        lambda S, H, L, sms: (chunk, -(-L // chunk)))


def _split_edges(chunk: int, L: int) -> list:
    """Positions at 0, around the first two split edges and at the end."""
    return [p for p in (0, chunk - 1, chunk, chunk + 1, 2 * chunk - 1,
                        2 * chunk, L - 2, L - 1) if p < L]


def _position_sets(positions: list, S: int, device) -> list:
    """``positions`` spread over calls of ``S`` slots: each value in some
    slot of some call (a call's list repeated to fill its slots)."""
    return [torch.tensor((positions[i:i + S] * S)[:S], dtype=torch.int32,
                         device=device)
            for i in range(0, len(positions), S)]


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1024, 1000])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("S", [1, 4, 16])
def test_cuda_flash_decode_matches_plain_at_split_edges(S, D, L,
                                                        cuda_device):
    """Row 13 at 1, 4 and 16 slots (the plan's 128- and 192-row chunks
    at H=12), every head dim, an L that is a multiple of the chunk and one
    that is not: positions at 0, on each side of the first split edges
    and at L - 1, each slot in turn, within 2e-2 of the plain version,
    and a second call equal bit for bit (the merge takes the splits in
    index order, whichever block arrives last)."""
    g = torch.Generator(device=cuda_device).manual_seed(S * D + L)
    H = 12
    chunk, _ = _plan(S, H, L)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device).to(
            torch.bfloat16)

    q, kc, vc = rand(S, 1, H, D), rand(S, L, H, D), rand(S, L, H, D)
    for pos in _position_sets(_split_edges(chunk, L), S, cuda_device):
        o = flash_decode_attention(q, kc, vc, pos)
        again = flash_decode_attention(q, kc, vc, pos)
        o_ref = flash_decode_attention_plain(q, kc, vc, pos)
        torch.cuda.synchronize()
        assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2, pos
        assert torch.equal(o, again), pos


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [64, 128, 1024])
def test_cuda_flash_decode_any_chunk_matches_plain(chunk, cuda_device,
                                                   monkeypatch):
    """The kernel under a chunk other than the plan's: 16 splits of 64
    rows (a merge over 16 parts), 8 of 128, one of 1024 (the ring wraps
    past its stages)."""
    _force_chunk(monkeypatch, chunk)
    g = torch.Generator(device=cuda_device).manual_seed(chunk)
    S, L, H, D = 16, 1024, 12, 64
    q, kc, vc = (torch.randn(*shape, generator=g, device=cuda_device).to(
        torch.bfloat16) for shape in ((S, 1, H, D), (S, L, H, D),
                                      (S, L, H, D)))
    pos = torch.tensor(_split_edges(64, L) + _split_edges(128, L),
                       dtype=torch.int32, device=cuda_device)
    o = flash_decode_attention(q, kc, vc, pos)
    o_ref = flash_decode_attention_plain(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    assert torch.equal(o, flash_decode_attention(q, kc, vc, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [64, 128, 192])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_cuda_flash_decode_matches_split_arithmetic(D, chunk, cuda_device,
                                                    monkeypatch):
    """Both kernels against ``flash_decode_split_plain``, the same
    split, warp-group and merge arithmetic in plain PyTorch, to about a
    bf16 ulp of the output (rtol 8e-3, atol 1e-3; the two differ only
    in the order of fp32 sums): every head dim, chunks of 1, 2 and 3
    tiles, L=1008 (a multiple of no chunk, 63 pages of 16), positions
    at 0, on each side of the first split edges and at L - 1; the paged
    kernel through a permuted table."""
    _force_chunk(monkeypatch, chunk)
    g = torch.Generator(device=cuda_device).manual_seed(D + chunk)
    S, L, H, ps = 4, 1008, 12, 16
    P = L // ps

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device).to(
            torch.bfloat16)

    q, kc, vc = rand(S, 1, H, D), rand(S, L, H, D), rand(S, L, H, D)
    perm = torch.randperm(S * P, generator=g, device=cuda_device).to(
        torch.int32).view(S, P)
    kq, vq = (torch.empty(S * P, ps, H, D, dtype=torch.bfloat16,
                          device=cuda_device) for _ in range(2))
    kq[perm.flatten().long()] = kc.view(S * P, ps, H, D)
    vq[perm.flatten().long()] = vc.view(S * P, ps, H, D)
    for pos in _position_sets(_split_edges(chunk, L), S, cuda_device):
        want = flash_decode_split_plain(q, kc, vc, pos, chunk).float()
        for o in (flash_decode_attention(q, kc, vc, pos),
                  flash_decode_paged_attention(q, kq, vq, pos, perm)):
            torch.testing.assert_close(o.float(), want, rtol=8e-3,
                                       atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [16, 64])
@pytest.mark.parametrize("S", [1, 4, 16])
def test_cuda_flash_decode_paged_equals_flat_under_any_table(S, page_size,
                                                             cuda_device):
    """Row 14 on the page view of one logical cache, under the identity
    table and with its pages scattered by a random permutation: equal
    to row 13 on the slot-contiguous cache bit for bit (one body, one
    plan, one order of arithmetic), within 2e-2 of the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(S + page_size)
    L, H, D, ps = 1024, 12, 64, page_size
    P = L // ps

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device).to(
            torch.bfloat16)

    q, kc, vc = rand(S, 1, H, D), rand(S, L, H, D), rand(S, L, H, D)
    chunk, _ = _plan(S, H, L)
    ident = torch.arange(S * P, dtype=torch.int32,
                         device=cuda_device).view(S, P)
    perm = torch.randperm(S * P, generator=g, device=cuda_device).to(
        torch.int32).view(S, P)
    kp, vp = kc.view(S * P, ps, H, D), vc.view(S * P, ps, H, D)
    kq, vq = torch.empty_like(kp), torch.empty_like(vp)
    kq[perm.flatten().long()] = kp
    vq[perm.flatten().long()] = vp
    edges = _split_edges(chunk, L) + [ps - 1, ps, 700]
    for pos in _position_sets(edges, S, cuda_device):
        flat = flash_decode_attention(q, kc, vc, pos)
        for k_pages, v_pages, table in ((kp, vp, ident), (kq, vq, perm)):
            o = flash_decode_paged_attention(q, k_pages, v_pages, pos,
                                             table)
            o_ref = flash_decode_paged_attention_plain(q, k_pages, v_pages,
                                                       pos, table)
            torch.cuda.synchronize()
            assert torch.equal(o, flat), pos
            assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda_device):
    """A CUDA tensor the kernel does not take raises; it never takes the
    plain version."""
    x = torch.zeros(1, 8, 2, 64, device=cuda_device)      # fp32
    with pytest.raises(TypeError, match="bf16"):
        flash_attention_fwd(x, x, x)
    lse = torch.zeros(1, 2, 8, device=cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        flash_attention_bwd(x, x, x, x, lse, x)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_cuda_kernels_cover_every_head_dim(D, cuda_device):
    """Every instantiation of both kernels, causal and not, at ragged
    lengths, against the plain versions."""
    g = torch.Generator(device=cuda_device).manual_seed(D)
    T, H, S, L = 77, 3, 5, 100

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device).to(
            torch.bfloat16)

    q, k, v = rand(2, T, H, D), rand(2, T, H, D), rand(2, T, H, D)
    for causal in (True, False):
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, causal=causal)
        assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
        assert (lse - lse_ref).abs().max().item() <= 1e-3
    pos = torch.tensor([0, 1, 63, 64, L - 1], dtype=torch.int32,
                       device=cuda_device)
    qd, kc, vc = rand(S, 1, H, D), rand(S, L, H, D), rand(S, L, H, D)
    o = flash_decode_attention(qd, kc, vc, pos)
    o_ref = flash_decode_attention_plain(qd, kc, vc, pos)
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_cuda_engine_serves_through_the_kernels(cuda_device):
    """A small model served on the card: every prefill and decode step
    launches each kernel once per layer, and the greedy tokens pass the
    teacher-forced near-tie rule (2e-2) against the plain-attention
    whole-sequence forward on the same weights."""
    cfg = GPTConfig(vocab_size=256, block_size=64, n_layer=2, n_head=2,
                    n_embd=64, remat=False)
    eng = ServeEngine(GPTLightningModule(cfg), buckets=(16, 32), slots=4,
                      max_seq_len=64, seed=0).setup()
    assert eng.decode_kernel == "flash_decode"
    sched = Scheduler(buckets=(16, 32), slots=4, max_seq_len=64,
                      default_max_new_tokens=8)
    rng = np.random.default_rng(0)
    reqs = [sched.submit(rng.integers(0, 256, n)) for n in (3, 16, 20, 31,
                                                           9)]
    _kernels.reset_launches()
    calls0 = dict(eng.calls)
    worker = ServeWorker(eng)
    while not sched.idle():
        sched.apply(plan := sched.plan(), worker.serve_step(plan))
    counts = _kernels.launch_counts()
    assert counts["flash_fwd"] == 2 * (eng.calls["prefill"]
                                       - calls0["prefill"]) > 0
    assert counts["flash_decode"] == 2 * (eng.calls["decode"]
                                          - calls0["decode"]) > 0
    ref = GPT(dataclasses.replace(eng.model.config, attention_impl="dot"))
    ref.load_state_dict(eng.model.state_dict())
    ref.to(dtype=torch.bfloat16)
    for r in reqs:
        gen = r.result(1).tolist()
        seq = torch.tensor([list(r.tokens) + gen[:-1]], device=cuda_device)
        with torch.inference_mode():
            logits = ref(seq)[0, len(r.tokens) - 1:]
        for i, tok in enumerate(gen):
            best = int(logits[i].argmax())
            assert tok == best or logits[i, tok] >= logits[i, best] - 2e-2


@pytest.mark.cuda
def test_cuda_trainer_fits_tiny_through_the_kernels(cuda_device):
    """A 3-step ``Trainer.fit`` of tiny on the card: finite losses, bf16
    params beside the fp32 master, and each attention kernel launched
    once per layer per step (2 layers x 3 steps)."""
    losses = []

    class Losses(Callback):
        def on_train_batch_end(self, trainer, module, outputs, batch, i):
            losses.append(float(outputs["loss"]))

    module = GPTLightningModule("tiny", warmup_steps=2, dataset_size=32)
    trainer = Trainer(max_steps=3, enable_checkpointing=False,
                      logger=False, seed=0, num_sanity_val_steps=0,
                      limit_val_batches=0, callbacks=[Losses()],
                      device=cuda_device)
    _kernels.reset_launches()
    trainer.fit(module)
    counts = _kernels.launch_counts()
    assert counts["flash_fwd"] == counts["flash_bwd"] == 2 * 3
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert trainer.global_step == 3
    assert {p.dtype for p in module.model.parameters()} == {torch.bfloat16}
    master = trainer.state.opt_state.master
    assert all(m.dtype == torch.float32 and m.is_cuda
               for m in master.values())


@pytest.mark.cuda
@pytest.mark.parametrize("module", ["mlm", "finetune"])
def test_cuda_bert_fits_tiny_through_the_kernels(module, cuda_device):
    """A 3-step ``Trainer.fit`` of the tiny BERT on the card, masked LM
    and fine-tune: finite losses, fp32-resident params and moments (no
    master), each attention kernel launched once per layer per step,
    non-causal (2 layers x 3 steps)."""
    losses = []

    class Losses(Callback):
        def on_train_batch_end(self, trainer, module, outputs, batch, i):
            losses.append(float(outputs["loss"]))

    lm = (BertMLMModule("tiny", train_size=32) if module == "mlm"
          else BertLightningModule("tiny", train_size=32, warmup_steps=1))
    trainer = Trainer(max_steps=3, enable_checkpointing=False,
                      logger=False, seed=0, num_sanity_val_steps=0,
                      limit_val_batches=0, callbacks=[Losses()],
                      device=cuda_device)
    _kernels.reset_launches()
    trainer.fit(lm)
    counts = _kernels.launch_counts()
    assert counts["flash_fwd"] == counts["flash_bwd"] == 2 * 3
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert {p.dtype for p in lm.model.parameters()} == {torch.float32}
    assert all(m.dtype == torch.float32 and m.is_cuda
               for m in trainer.state.opt_state.mu.values())
    if module == "finetune":
        assert 0.0 <= trainer.callback_metrics["train_accuracy"] <= 1.0


@pytest.mark.cuda
def test_cuda_trainer_fits_under_remat_through_the_kernels(cuda_device):
    """A 3-step fit of a 2-layer model with remat "full" at T=256: the
    attention forward launches twice a layer a step (forward and the
    recompute in the backward pass), the backward once; losses finite."""
    losses = []

    class Losses(Callback):
        def on_train_batch_end(self, trainer, module, outputs, batch, i):
            losses.append(float(outputs["loss"]))

    cfg = GPTConfig(vocab_size=512, block_size=256, n_layer=2, n_head=2,
                    n_embd=128, remat=True)
    module = GPTLightningModule(cfg, warmup_steps=2, dataset_size=24)
    trainer = Trainer(max_steps=3, enable_checkpointing=False,
                      logger=False, seed=0, num_sanity_val_steps=0,
                      limit_val_batches=0, callbacks=[Losses()],
                      device=cuda_device)
    _kernels.reset_launches()
    trainer.fit(module)
    counts = _kernels.launch_counts()
    assert module.model.remat_policy == "full"
    assert counts["flash_fwd"] == 2 * 2 * 3 and counts["flash_bwd"] == 2 * 3
    assert len(losses) == 3 and np.isfinite(losses).all()


def _tensors(tree, prefix=""):
    """The tensors of a nested checkpoint dict by path."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_tensors(v, f"{prefix}/{k}"))
    return out


@pytest.mark.cuda
def test_cuda_checkpoint_round_trip_keeps_state(cuda_device, tmp_path):
    """A fit of tiny on the card (bf16 params, fp32 master, bf16 mu),
    ``save_checkpoint``, then a new ``Trainer`` resumed from the file at
    ``max_steps`` (so it runs no step): every restored tensor, params,
    master and both moments, equals the saved state bit for bit, on the
    card, in its saved dtype; the counters and the step seed too."""
    def trainer():
        return Trainer(max_steps=3, seed=0, num_sanity_val_steps=0,
                       limit_val_batches=0, device=cuda_device,
                       default_root_dir=str(tmp_path))

    first = trainer()
    first.fit(GPTLightningModule("tiny", warmup_steps=2, dataset_size=32))
    path = str(tmp_path / "state.ckpt")
    first.save_checkpoint(path)
    saved = first.dump_checkpoint()
    resumed = trainer()
    resumed.fit(GPTLightningModule("tiny", warmup_steps=2,
                                   dataset_size=32), ckpt_path=path)
    got = resumed.dump_checkpoint()
    want_t, got_t = _tensors(saved["state"]), _tensors(got["state"])
    assert set(got_t) == set(want_t) and len(want_t) > 0
    dtypes = set()
    for k, w in want_t.items():
        g = got_t[k]
        assert g.is_cuda and g.dtype == w.dtype and torch.equal(g, w), k
        dtypes.add(g.dtype)
    assert dtypes == {torch.bfloat16, torch.float32}
    for k in ("epoch", "global_step"):
        assert got[k] == saved[k]
    assert (got["state"]["step"], got["state"]["rng"]) == (
        saved["state"]["step"], saved["state"]["rng"])
    assert resumed.state.generator.device.type == "cuda"


# -- the paged decode kernel (TPU row 14) and the paths that run it -----------

def _paged_inputs(g, S, L, H, D, ps, device):
    def rand(*shape):
        return torch.randn(*shape, generator=g, device=device).to(
            torch.bfloat16)

    P = L // ps
    pages_k, pages_v = rand(S * P, ps, H, D), rand(S * P, ps, H, D)
    perm = torch.randperm(S * P, generator=g, device=device)
    return rand(S, 1, H, D), pages_k, pages_v, perm.view(S, P).to(
        torch.int32).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [1, 16, 64])
def test_cuda_flash_decode_paged_kernel_matches_plain(page_size,
                                                      cuda_device):
    """Row 14 against its plain version over a randomly permuted table,
    positions on and around page (and 64-row tile) boundaries; over the
    identity table it equals the slot-contiguous kernel bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(page_size)
    S, L, H, D, ps = 8, 1024, 12, 64, page_size
    q, kp, vp, table = _paged_inputs(g, S, L, H, D, ps, cuda_device)
    pos = torch.tensor([0, ps - 1, ps, 2 * ps + 1, 63, 64, 700, L - 1],
                       dtype=torch.int32, device=cuda_device)
    before = _kernels.REGISTRY["flash_decode_paged"].launches
    o = flash_decode_paged_attention(q, kp, vp, pos, table)
    o_ref = flash_decode_paged_attention_plain(q, kp, vp, pos, table)
    torch.cuda.synchronize()
    assert _kernels.REGISTRY["flash_decode_paged"].launches == before + 1
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    ident = torch.arange(S * (L // ps), dtype=torch.int32,
                         device=cuda_device).view(S, L // ps)
    flat = flash_decode_attention(q, kp.view(S, L, H, D),
                                  vp.view(S, L, H, D), pos)
    assert torch.equal(flash_decode_paged_attention(q, kp, vp, pos, ident),
                       flat)


@pytest.mark.cuda
def test_cuda_paged_wrapper_raises(cuda_device):
    """What the paged kernel does not take raises on a CUDA tensor: no
    fall back to the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, kp, vp, table = _paged_inputs(g, 2, 64, 2, 64, 16, cuda_device)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        flash_decode_paged_attention(q.float(), kp, vp, pos, table)
    with pytest.raises(TypeError, match="contiguous int32"):
        flash_decode_paged_attention(q, kp, vp, pos, table.long())
    with pytest.raises(TypeError, match="contiguous int32"):
        flash_decode_paged_attention(q, kp, vp, pos, table.t().contiguous(
            ).t())
    with pytest.raises(ValueError, match="page table must be"):
        flash_decode_paged_attention(q, kp, vp, pos, table[:1])
    strided = torch.empty(*kp.shape[:3], 2 * kp.shape[3],
                          dtype=kp.dtype, device=cuda_device)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        flash_decode_paged_attention(q, strided, vp, pos, table)
    with pytest.raises(ValueError, match="one device"):
        flash_decode_paged_attention(q, kp, vp, pos, table.cpu())
    k = kp.view(2, 64, 2, 64)
    from ray_lightning_tpu_torch.ops.attention import cached_attention
    with pytest.raises(ValueError, match="cannot tile"):
        cached_attention(q, k, k, pos, impl="paged", page_table=table[:, :3])


def _paged_engine(spec=None):
    """A 12-layer narrow model on the card, paged at page size 16."""
    cfg = GPTConfig(vocab_size=256, block_size=128, n_layer=12, n_head=2,
                    n_embd=64, remat=False)
    return ServeEngine(GPTLightningModule(cfg), buckets=(32, 64), slots=4,
                       max_seq_len=128, seed=0, paged=PageConfig(True, 16),
                       spec=spec).setup()


def _drive(eng, spec=None):
    sched = Scheduler(buckets=(32, 64), slots=4, max_seq_len=128,
                      default_max_new_tokens=9, paged=PageConfig(True, 16),
                      spec=spec)
    shared = np.arange(1, 33)
    reqs = [sched.submit(np.concatenate([shared, [40 + i] * (1 + i)]))
            for i in range(6)]
    worker = ServeWorker(eng)
    while not sched.idle():
        sched.apply(plan := sched.plan(), worker.serve_step(plan))
    assert all(r.done() and len(r.result(0)) == 9 for r in reqs)
    return sched


@pytest.mark.cuda
def test_cuda_paged_engine_launches_the_paged_kernel(cuda_device,
                                                     monkeypatch):
    """Paged serving with prefix reuse: each decode step and each suffix
    step launches the paged kernel once per layer (12), and nothing runs
    the slot-contiguous one."""
    monkeypatch.setenv("RLT_DECODE_IMPL", "paged")
    eng = _paged_engine()
    assert eng.decode_kernel == "paged"
    _kernels.reset_launches()
    calls0 = dict(eng.calls)
    sched = _drive(eng)
    counts = _kernels.launch_counts()
    steps = {k: eng.calls[k] - calls0[k] for k in eng.calls}
    assert steps["decode"] > 0 and steps["suffix"] > 0
    assert sched.pages.stats()["reused_prefills"] >= 3
    assert counts["flash_decode_paged"] == 12 * (steps["decode"]
                                                 + steps["suffix"])
    assert counts["flash_decode"] == 0
    assert counts["flash_fwd"] == 12 * steps["prefill"]


@pytest.mark.cuda
def test_cuda_verify_round_launches_k_plus_one_per_layer(cuda_device,
                                                         monkeypatch):
    """A speculative round on the paged engine: the verify launches the
    paged kernel 12 x (k+1) times, the draft (6 layers) 6 x (k+1) (k
    drafts and the row of the last)."""
    monkeypatch.setenv("RLT_DECODE_IMPL", "paged")
    k = 3
    eng = _paged_engine(SpecConfig(True, k=k))
    assert eng.draft_layers == 6
    S = eng.slots
    toks = np.ones(S, np.int32)
    pos = np.array([5, 64, 126, 127], np.int32)
    _kernels.reset_launches()
    drafts = eng.draft(toks, pos)
    assert _kernels.launch_counts()["flash_decode_paged"] == 6 * (k + 1)
    _kernels.reset_launches()
    ver = eng.verify(toks, pos, drafts)
    assert _kernels.launch_counts()["flash_decode_paged"] == 12 * (k + 1)
    assert drafts.shape == (S, k) and ver.shape == (S, k + 1)
    sched = _drive(eng, SpecConfig(True, k=k))
    st = sched.stats()["spec"]
    assert st["emitted"] == st["accepted"] + st["corrected"] > 0


# -- the strategies' collectives on NCCL at world size 1 -------------------------

@pytest.fixture
def nccl_group(cuda_device):
    """A one-rank NCCL process group in this process (no actors), torn
    down after the test."""
    import torch.distributed as dist

    from ray_lightning_tpu_torch.cluster.protocol import find_free_port
    device = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            init_method=f"tcp://127.0.0.1:{find_free_port()}")
    try:
        yield device
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_strategy_sync_is_identity_at_one_rank(nccl_group):
    """DDP's gradient sync (one fp32 buffer, NCCL's sum over one rank, a
    divide by 1, the cast back), the metric mean and the sum over ranks
    give back their inputs bit for bit, in each dtype."""
    from ray_lightning_tpu_torch.parallel import strategy

    gen = torch.Generator(device=nccl_group).manual_seed(0)
    grads = [torch.randn(s, generator=gen, device=nccl_group).to(dt)
             for s, dt in (((768, 2304), torch.bfloat16),
                           ((50304, 768), torch.bfloat16),
                           ((768,), torch.float32), ((3, 5), torch.float32))]
    synced = strategy.average_grads(grads)
    for g, s in zip(grads, synced):
        assert s.dtype == g.dtype and s.shape == g.shape
        assert torch.equal(s, g)
    metrics = [torch.tensor(2.718281828, device=nccl_group),
               torch.tensor(0.1, device=nccl_group, dtype=torch.bfloat16)]
    for m, r in zip(metrics, strategy.mean_over_ranks(metrics)):
        assert r.dtype == m.dtype and torch.equal(r, m)
    sums = torch.tensor([1.0 / 3, 7.25], dtype=torch.float64,
                        device=nccl_group)
    assert torch.equal(strategy.sum_over_ranks(sums), sums)


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [None, 1.0])
def test_cuda_zero1_update_equals_the_unsharded_one(clip, nccl_group):
    """ZeRO-1 at one rank over NCCL (the reduce over one rank, AdamW on
    the flat fp32 master, the gather into bf16 params) against the
    unsharded ``fp32_master(AdamW)``, three steps: the params, master
    and moments bit for bit, without and with a clip."""
    from ray_lightning_tpu_torch.ops.optim import (AdamW, chain,
                                                   clip_by_global_norm,
                                                   fp32_master)
    from ray_lightning_tpu_torch.parallel.strategy import Zero1Strategy

    def tx():
        t = fp32_master(AdamW(3e-3, warmup_steps=1, weight_decay=0.01,
                              mu_dtype=torch.bfloat16))
        return t if clip is None else chain(clip_by_global_norm(clip), t)

    gen = torch.Generator(device=nccl_group).manual_seed(1)
    shapes = {"a": (768, 2304), "b": (2304,), "c": (1,), "d": (50, 7)}
    init = {k: torch.randn(s, generator=gen, device=nccl_group) * 0.02
            for k, s in shapes.items()}
    plain = {k: v.clone() for k, v in init.items()}
    sharded = {k: v.clone() for k, v in init.items()}
    opt_p, opt_z = tx(), Zero1Strategy().wrap_optimizer(tx())
    st_p, st_z = opt_p.init(plain), opt_z.init(sharded)
    for d in (plain, sharded):
        for k in d:
            d[k] = d[k].to(torch.bfloat16)
    for _ in range(3):
        grads = {k: (torch.randn(s, generator=gen, device=nccl_group)
                     * 0.5).to(torch.bfloat16) for k, s in shapes.items()}
        opt_p.update(grads, st_p, plain)
        opt_z.update(grads, st_z, sharded)
    want, got = st_p.state_dict(), st_z.state_dict()

    def flat(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    got = dict(flat(got))
    for k, v in flat(want):
        if torch.is_tensor(v):
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        else:
            assert got[k] == v, k
    for k in shapes:
        assert torch.equal(sharded[k], plain[k]), k


# -- the plugins across cards (NCCL at W > 1) ---------------------------------

#: per-step losses of rank 0, relayed by ``RelayLosses`` to the driver
RELAYED_LOSSES: list = []


def _record_losses(losses):
    RELAYED_LOSSES.append(losses)


class RelayLosses(Callback):
    """In a worker: rank 0's per-step losses go to the driver's
    ``RELAYED_LOSSES`` (module level: the worker imports it by name)."""

    def on_fit_start(self, trainer, module):
        self.losses = []

    def on_train_batch_end(self, trainer, module, outputs, batch, i):
        # a chunk of k steps ends once, with its k losses
        self.losses.extend(outputs["loss"].detach().float().reshape(-1)
                           .tolist())

    def on_fit_end(self, trainer, module):
        from ray_lightning_tpu_torch import session
        if trainer.is_global_zero:
            session.put_queue(functools.partial(_record_losses,
                                                self.losses))


class SaveAtEnd(Callback):
    """``save_checkpoint`` at the fit's end, on every rank (collective)."""

    def __init__(self, path):
        self.path = path

    def on_fit_end(self, trainer, module):
        trainer.save_checkpoint(self.path)


@pytest.fixture
def cards(cuda_device):
    """The number of cards, or a skip below two."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    return n


def _state(path) -> dict:
    out = {}

    def walk(prefix, d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}/", v)
            else:
                out[f"{prefix}{k}"] = v

    walk("", Trainer.load_checkpoint_dict(path, "cpu")["state"])
    return out


@pytest.mark.cuda
def test_cuda_plugins_zero1_equals_ddp_across_cards(cards, tmp_path):
    """``RayPlugin`` and ``RayShardedPlugin`` with one worker a card, over
    NCCL, on the tiny GPT through the kernels (bf16 params, the fp32
    master): at W=2 the end states (params, master, moments, count) and
    the losses equal bit for bit, without and with a clip that triggers
    (a sum of two ranks has one order); on every card, when there are
    more than two, the losses within 1e-5 and each state tensor within
    1e-3 (a sum of more ranks may be ordered otherwise by the
    all-reduce than by the reduce-scatter)."""
    from ray_lightning_tpu_torch import RayPlugin, RayShardedPlugin

    def run(cls, W, clip):
        root = tmp_path / f"{cls.__name__}{W}{clip}"
        end = str(root / "end.ckpt")
        trainer = Trainer(
            plugins=[cls(num_workers=W, timeout_s=300)], max_steps=6,
            seed=0, limit_val_batches=1, num_sanity_val_steps=0,
            enable_checkpointing=False, logger=False,
            gradient_clip_val=clip, default_root_dir=str(root),
            callbacks=[RelayLosses(), SaveAtEnd(end)])
        RELAYED_LOSSES.clear()
        trainer.fit(GPTLightningModule(
            GPTConfig(vocab_size=512, block_size=64, n_layer=2, n_head=2,
                      n_embd=64), batch_size=2, dataset_size=64))
        [losses] = RELAYED_LOSSES
        ckpt = Trainer.load_checkpoint_dict(end, "cpu")
        assert (ckpt["world_size"], ckpt["strategy"]) == (
            W, trainer.strategy.name)
        return losses, _state(end)

    for W, clip in [(2, None), (2, 0.05)] + [(cards, None)] * (cards > 2):
        (dl, ds), (zl, zs) = run(RayPlugin, W, clip), run(RayShardedPlugin,
                                                          W, clip)
        assert set(ds) == set(zs) and len(dl) == 6
        assert np.isfinite(dl).all()
        for k, v in ds.items():
            if not torch.is_tensor(v):
                assert zs[k] == v, (W, clip, k)
            elif W == 2:
                assert torch.equal(zs[k], v), (W, clip, k)
            else:
                torch.testing.assert_close(zs[k].float(), v.float(),
                                           atol=1e-3, rtol=0, msg=k)
        if W == 2:
            assert zl == dl
        else:
            np.testing.assert_allclose(zl, dl, atol=1e-5, rtol=1e-5)


# -- Tune trials on the card ----------------------------------------------------

class HoldAtTrainEnd(Callback):
    """Waits at the end of training until every trial of the barrier is
    there (so their fits overlap)."""

    def __init__(self, barrier):
        self.barrier = barrier

    def on_train_end(self, trainer, module):
        self.barrier.wait()


@pytest.mark.cuda
def test_cuda_tune_trials_train_concurrently_on_disjoint_cards(cards,
                                                               tmp_path):
    """Two in-process trials, each with a lease of one card and a
    ``Trainer`` given no device, train at the same time (a barrier at
    the end of training shows it) on two different cards, every
    parameter on the trial's own card."""
    import threading

    from ray_lightning_tpu_torch import tune

    barrier = threading.Barrier(2, timeout=120)
    seen = {}

    def fn(config):
        trainer = Trainer(max_steps=3, seed=0, num_sanity_val_steps=0,
                          limit_val_batches=0, enable_checkpointing=False,
                          default_root_dir=tune.get_trial_dir(),
                          callbacks=[HoldAtTrainEnd(barrier),
                                     tune.TuneReportCallback(
                                         on="train_epoch_end")])
        module = GPTLightningModule("tiny", warmup_steps=2, dataset_size=32)
        trainer.fit(module)
        seen[config["tag"]] = (trainer.device, {
            p.device for p in module.model.parameters()})

    analysis = tune.run(
        fn, config={"tag": tune.grid_search([0, 1])},
        resources_per_trial=tune.get_tune_resources(num_workers=1,
                                                    use_gpu=True),
        max_concurrent_trials=2, local_dir=str(tmp_path))
    assert all(t.status == "TERMINATED" for t in analysis.trials)
    devices = [d for d, _ in seen.values()]
    assert len(set(devices)) == 2 and all(d.type == "cuda" for d in devices)
    for device, params in seen.values():
        assert params == {device}
    for t in analysis.trials:
        assert t.leased_devices == [str(seen[t.config["tag"]][0])]


@pytest.mark.cuda
def test_cuda_relayed_checkpoint_resumes_in_process(cuda_device, tmp_path):
    """A ``RayPlugin(num_workers=1)`` trial on the card relays its
    checkpoint at the end of a 1-epoch fit: the file holds the weights
    the driver got back, bit for bit, and a fit resumed from it in
    process for a second epoch equals the uninterrupted 2-epoch fit in
    process, bit for bit."""
    from ray_lightning_tpu_torch import RayPlugin, tune

    common = dict(seed=0, limit_train_batches=3, limit_val_batches=0,
                  num_sanity_val_steps=0, enable_checkpointing=False,
                  logger=False)

    def module():
        return GPTLightningModule("tiny", warmup_steps=2, dataset_size=32)

    modules = []

    def fn(config):
        trainer = Trainer(plugins=[RayPlugin(num_workers=1, timeout_s=300)],
                          max_epochs=1, default_root_dir=tune.get_trial_dir(),
                          callbacks=[tune.TuneReportCheckpointCallback(
                              on="train_end")], **common)
        modules.append(module())
        trainer.fit(modules[-1])

    analysis = tune.run(fn, config={}, metric="loss",
                        stop={"training_iteration": 2},
                        local_dir=str(tmp_path))
    (trial,) = analysis.trials
    assert trial.status == "TERMINATED" and len(trial.history) == 1
    path = f"{trial.latest_checkpoint}/checkpoint"
    ckpt = Trainer.load_checkpoint_dict(path, "cpu")
    assert (ckpt["epoch"], ckpt["global_step"]) == (1, 3)
    saved = {**ckpt["state"]["params"], **ckpt["state"]["model_state"]}
    for k, v in modules[0]._trained_state.items():
        assert torch.equal(saved[k], v), k

    resumed, whole = module(), module()
    Trainer(max_epochs=2, device=cuda_device, **common).fit(
        resumed, ckpt_path=path)
    Trainer(max_epochs=2, device=cuda_device, **common).fit(whole)
    got, want = resumed.model.state_dict(), whole.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


# -- ResNet on the card -----------------------------------------------------------

def _resnet(cfg, device, state=None):
    """A ResNet on ``device``: flax's init from seed 0 with every
    BatchNorm scale 1 (flax starts each block's last at 0, which would
    leave the residual branches out), or ``state``."""
    from ray_lightning_tpu_torch.models.resnet import BatchNorm, ResNet
    model = ResNet(cfg, device=device)
    if state is not None:
        model.load_state_dict(state)
        return model
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("bottleneck", [False, True])
def test_cuda_resnet_channels_last_bf16_matches_cpu(bottleneck, cuda_device,
                                                    monkeypatch):
    """A bf16 ResNet (2 stages of width 16) on the card against the same
    weights on the CPU: train logits, the running statistics after it
    and eval logits within 2e-2; every conv on the card gets its input
    and kernel channels-last (the NHWC batch viewed as NCHW)."""
    from ray_lightning_tpu_torch.models import resnet as tres
    cfg = tres.ResNetConfig(stage_sizes=(1, 1), width=16,
                            bottleneck=bottleneck)
    cpu = _resnet(cfg, "cpu")
    card = _resnet(cfg, cuda_device, cpu.state_dict())
    layouts = []
    conv2d = torch.nn.functional.conv2d

    def spy(x, w, *a, **k):
        if x.is_cuda:
            cl = torch.channels_last
            layouts.append(x.is_contiguous(memory_format=cl)
                           and w.is_contiguous(memory_format=cl))
        return conv2d(x, w, *a, **k)

    monkeypatch.setattr(tres.F, "conv2d", spy)
    x = torch.randn(8, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    want = cpu(x, True)
    got = card(x.to(cuda_device), True)
    assert layouts and all(layouts)
    torch.testing.assert_close(got.cpu(), want.detach(), atol=2e-2,
                               rtol=2e-2)
    for k, v in cpu.state_dict().items():
        torch.testing.assert_close(card.state_dict()[k].cpu(), v,
                                   atol=2e-2, rtol=2e-2, msg=k)
    with torch.no_grad():
        torch.testing.assert_close(card(x.to(cuda_device), False).cpu(),
                                   cpu(x, False), atol=2e-2, rtol=2e-2)


def cudnn_fp32() -> None:
    """fp32 convs in full fp32: cuDNN's default rounds their operands to
    TF32 (a worker's ``init_hook``; module level, so it can be sent)."""
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
def test_cuda_resnet_ddp_across_cards_equals_one_process(cards, tmp_path,
                                                         monkeypatch):
    """``RayPlugin(num_workers=2)`` over NCCL, one card a worker, batch 4
    a rank, against one process at batch 8 on the first card: the tiny
    ResNet in fp32, 2 epochs of 3 steps, the same seed; losses, every
    param and running statistic within fp32's 2e-5 (each rank's
    BatchNorm takes the moments of the global batch).  TF32 is off in
    both: it rounds the conv operands to 10 mantissa bits, so a last-bit
    difference of the two summation orders can move an operand by a TF32
    step, past the bar (seen on four H100s with it on: the losses within
    2e-5, ``stem.weight`` not)."""
    from ray_lightning_tpu_torch import RayPlugin, ResNetLightningModule
    from ray_lightning_tpu_torch.models.resnet import ResNetConfig

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)

    class Losses(Callback):
        def __init__(self):
            self.losses = []

        def on_train_batch_end(self, trainer, module, outputs, batch, i):
            self.losses.append(float(outputs["loss"]))

    def run(plugins, batch, callback, **kw):
        module = ResNetLightningModule(
            ResNetConfig(stage_sizes=(1, 1), width=8, bottleneck=False,
                         dtype=torch.float32), lr=0.05, batch_size=batch,
            train_size=24, val_size=8)
        trainer = Trainer(plugins=plugins, max_epochs=2, seed=0,
                          limit_val_batches=1, num_sanity_val_steps=0,
                          enable_checkpointing=False, logger=False,
                          default_root_dir=str(tmp_path),
                          callbacks=[callback], **kw)
        RELAYED_LOSSES.clear()
        trainer.fit(module)
        return module, list(RELAYED_LOSSES)

    ddp, [ddp_losses] = run([RayPlugin(num_workers=2, timeout_s=300,
                                       init_hook=cudnn_fp32)], 4,
                            RelayLosses())
    local = Losses()
    one, _ = run(None, 8, local, device="cuda:0")
    one_losses = local.losses
    assert len(ddp_losses) == len(one_losses) == 6
    np.testing.assert_allclose(ddp_losses, one_losses, atol=2e-5, rtol=2e-5)
    want = {k: v.detach().cpu() for k, v in one.model.state_dict().items()}
    assert set(ddp._trained_state) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(ddp._trained_state[k], v, atol=2e-5,
                                   rtol=2e-5, msg=k)



@pytest.mark.cuda
def test_cuda_resnet_cached_chunks_across_cards_equal_one_process(
        cards, tmp_path, monkeypatch):
    """The same W=2 fit with ``steps_per_execution=3`` and the cache:
    each rank holds half the train set, the repack is one NCCL
    all-to-all, and each epoch's chunk of 3 steps is one graph replay
    whose captured collectives (the gradient all-reduce, BatchNorm's
    moments both ways, the metric mean) run across the two cards; the
    losses and every param and running statistic within 2e-5 of one
    process's streamed eager fit (TF32 off in both)."""
    from ray_lightning_tpu_torch import RayPlugin, ResNetLightningModule
    from ray_lightning_tpu_torch.models.resnet import ResNetConfig

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)

    def module(batch):
        return ResNetLightningModule(
            ResNetConfig(stage_sizes=(1, 1), width=8, bottleneck=False,
                         dtype=torch.float32), lr=0.05, batch_size=batch,
            train_size=24, val_size=8)

    kw = dict(max_epochs=2, seed=0, limit_val_batches=1,
              num_sanity_val_steps=0, enable_checkpointing=False,
              logger=False, default_root_dir=str(tmp_path))
    RELAYED_LOSSES.clear()
    ddp = module(4)
    Trainer(plugins=[RayPlugin(num_workers=2, timeout_s=300,
                               init_hook=cudnn_fp32)],
            callbacks=[RelayLosses()], steps_per_execution=3,
            cache_train_dataset=True, **kw).fit(ddp)
    [ddp_losses] = RELAYED_LOSSES
    class Losses(Callback):
        losses: list = []

        def on_train_batch_end(self, trainer, module, outputs, batch, i):
            self.losses.append(float(outputs["loss"]))

    local = Losses()
    one = module(8)
    Trainer(device="cuda:0", callbacks=[local], **kw).fit(one)
    assert len(ddp_losses) == len(local.losses) == 6
    np.testing.assert_allclose(ddp_losses, local.losses, atol=2e-5,
                               rtol=2e-5)
    for k, v in one.model.state_dict().items():
        torch.testing.assert_close(ddp._trained_state[k], v.detach().cpu(),
                                   atol=2e-5, rtol=2e-5, msg=k)


# -- the epoch engine's graphed chunks (steps_per_execution on the card) -------

def _engine_fit(device, steps, module, **kw):
    """A fit of ``steps`` steps on ``device``: the trainer, its end state
    (params, buffers and optimizer state by path) and the launches."""
    trainer = Trainer(max_steps=steps, enable_checkpointing=False,
                      logger=False, seed=0, num_sanity_val_steps=0,
                      limit_val_batches=0, device=device, **kw)
    _kernels.reset_launches()
    trainer.fit(module)
    torch.cuda.synchronize()
    state = {k: v.detach().clone() for k, v in
             module.model.state_dict().items()}
    state.update({f"opt{k}": v.detach().clone() for k, v in _tensors(
        trainer.state.opt_state.state_dict()).items()})
    return trainer, state, _kernels.launch_counts()


def _tiny_gpt(**cfg):
    return GPTLightningModule(
        GPTConfig(vocab_size=512, block_size=64, n_layer=2, n_head=2,
                  n_embd=128, remat=False, **cfg), batch_size=4,
        warmup_steps=2,
        dataset_size=4 * 10)


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [dict(steps_per_execution=4),
                                   dict(steps_per_execution=4,
                                        cache_train_dataset=True),
                                   dict(steps_per_execution=3,
                                        cache_train_dataset=True,
                                        gradient_clip_val=0.5)],
                         ids=["streamed", "cached", "cached_clip"])
def test_cuda_graphed_chunks_equal_the_eager_fit(knobs, cuda_device):
    """10 steps of the tiny GPT (bf16 params, the fp32 master, AdamW
    under warmup) with each knob: every full chunk is one replay of one
    captured graph, the rest run eagerly, and the end state equals the
    eager k=1 fit's bit for bit; the kernels count 2 layers x k launches
    a replay, and 2 x (10 + the warm-up step) in all."""
    k = knobs["steps_per_execution"]
    clip = {"gradient_clip_val": knobs.get("gradient_clip_val")}
    _, want, _ = _engine_fit(cuda_device, 10, _tiny_gpt(), **clip)
    trainer, got, launches = _engine_fit(cuda_device, 10, _tiny_gpt(),
                                         **knobs)
    assert trainer.global_step == 10
    stats = trainer.graph_stats
    assert stats["captures"] == 1 and stats["replays"] == 10 // k
    assert stats["launches_per_replay"] == {"flash_fwd": 2 * k,
                                            "flash_bwd": 2 * k}
    assert launches["flash_fwd"] == launches["flash_bwd"] == 2 * (10 + 1)
    assert set(got) == set(want)
    diff = [n for n in want if not torch.equal(got[n], want[n])]
    assert not diff, diff[:8]


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["ddp", "zero1"])
def test_cuda_graphed_chunks_capture_the_collectives(strategy, nccl_group):
    """Under a one-rank NCCL group the step's collectives (DDP's
    all-reduce, ZeRO-1's reduce-scatter and all-gather, the metric mean)
    are captured in the graph: 8 steps at k=4 equal the eager fit bit for
    bit."""
    _, want, _ = _engine_fit(nccl_group, 8, _tiny_gpt(), strategy=strategy)
    trainer, got, _ = _engine_fit(nccl_group, 8, _tiny_gpt(),
                                  strategy=strategy, steps_per_execution=4)
    assert trainer.graph_stats["replays"] == 2
    assert all(torch.equal(got[n], want[n]) for n in want)


def _tiny_bert_mlm():
    cfg = dataclasses.replace(BERT_CONFIGS["tiny"], dropout=0.1)
    return BertMLMModule(cfg, batch_size=4, train_size=40, val_size=8)


@pytest.mark.cuda
@pytest.mark.parametrize("make", [lambda: _tiny_gpt(dropout=0.1),
                                  _tiny_bert_mlm],
                         ids=["gpt_dropout", "bert_mlm"])
def test_cuda_random_draws_in_a_graphed_chunk_equal_eager(make,
                                                          cuda_device):
    """Keyed draws (dropout 0.1, the masked LM's mask) in a graphed chunk:
    each step's key words ride the chunk's static input, so 8 steps at
    k=4 (two replays of one graph) equal the eager k=1 fit bit for bit,
    and the draw kernel launches as often in a replay as in k eager
    steps."""
    _, want, eager = _engine_fit(cuda_device, 8, make())
    trainer, got, graphed = _engine_fit(cuda_device, 8, make(),
                                        steps_per_execution=4)
    stats = trainer.graph_stats
    assert stats["captures"] == 1 and stats["replays"] == 2
    per_replay = stats["launches_per_replay"]["philox_uniform"]
    assert per_replay > 0 and eager["philox_uniform"] == 2 * per_replay
    diff = [n for n in want if not torch.equal(got[n], want[n])]
    assert not diff, diff[:8]


class _RawGenerator(GPTLightningModule):
    """Draws from a torch.Generator (``make_rng``) in its step."""

    def training_step(self, ctx, batch):
        noise = torch.rand(1, generator=ctx.make_rng(), device="cuda")
        return super().training_step(ctx, batch) + 0 * noise.sum()


@pytest.mark.cuda
def test_cuda_make_rng_in_a_graphed_chunk_raises(cuda_device):
    """A raw ``torch.Generator`` draw cannot be captured (the graph would
    replay one seed): the fit raises naming the graph-safe draw."""
    cfg = dataclasses.replace(_tiny_gpt().config)
    with pytest.raises(NotImplementedError, match="make_key"):
        _engine_fit(cuda_device, 4, _RawGenerator(cfg, batch_size=4,
                                                  dataset_size=40),
                    steps_per_execution=2)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4, 5, 1023, 2 ** 20 + 3])
def test_cuda_philox_kernel_matches_plain(n, cuda_device):
    """``csrc/philox.cu`` against its plain version on the card and on
    the CPU, bit for bit, one launch a call; another stream id or key
    draws other numbers."""
    key = torch.tensor([0x243F6A88, 0x85A308D3], device=cuda_device)
    stream = (0x03707344 << 32) | 0x13198A2E
    before = _kernels.REGISTRY["philox_uniform"].launches
    got = trandom.philox_uniform(key, stream, (n,))
    assert _kernels.REGISTRY["philox_uniform"].launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, trandom.philox_uniform_plain(key, stream, (n,)))
    assert torch.equal(got.cpu(), trandom.philox_uniform_plain(
        key.cpu(), stream, (n,)))
    if n > 4:
        assert not torch.equal(got, trandom.philox_uniform(
            key, stream + 1, (n,)))


@pytest.mark.cuda
def test_cuda_custom_ops_under_capture(cuda_device):
    """The kernels as custom ops: opcheck's schema, fake-tensor and
    autograd checks on card tensors; a CUDA graph captured over
    ``rlt::flash_fwd`` + ``rlt::flash_bwd`` (through autograd),
    ``rlt::flash_decode`` and ``rlt::philox_uniform`` replays equal to the
    eager calls, with a fresh key read from device memory at each
    replay."""
    checks = ("test_schema", "test_faketensor", "test_autograd_registration")
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(2, 128, 4, 64, generator=g, device=cuda_device)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    torch.library.opcheck(fa.FWD_OP, (q, k, v, True, 0.125),
                          test_utils=checks)
    S, L = 4, 256
    qd = torch.randn(S, 1, 4, 64, generator=g, device=cuda_device).to(
        torch.bfloat16)
    kc, vc = (torch.randn(S, L, 4, 64, generator=g, device=cuda_device)
              .to(torch.bfloat16) for _ in range(2))
    pos = torch.tensor([0, 63, 64, 255], dtype=torch.int32,
                       device=cuda_device)
    key = torch.tensor([1, 2], device=cuda_device)

    def step():
        o = flash_attention(q, k, v, causal=True)
        grads = torch.autograd.grad(o.float().square().sum(), [q, k, v])
        with torch.no_grad():
            dec = flash_decode_attention(qd, kc, vc, pos)
        return (o.detach(), *grads, dec, trandom.philox_uniform(
            key, 7, (1000,)))

    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        step()                            # warm-up on the capture stream
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):   # the decode's scratch
        out = step()
    for words in ([1, 2], [3, 4]):
        key.copy_(torch.tensor(words, device=cuda_device))
        graph.replay()
        torch.cuda.synchronize()
        want = step()
        assert all(torch.equal(a, b) for a, b in zip(out, want)), words


@pytest.mark.cuda
def test_cuda_stream_prefetch_equals_no_prefetch(cuda_device, monkeypatch):
    """The double-buffered stream (pinned copies on a copy stream) trains
    exactly as the unbuffered one."""
    _, want, _ = _engine_fit(cuda_device, 6, _tiny_gpt())
    monkeypatch.setenv("RLT_STREAM_PREFETCH", "0")
    _, got, _ = _engine_fit(cuda_device, 6, _tiny_gpt())
    assert all(torch.equal(got[n], want[n]) for n in want)


# -- the serve engine's CUDA graphs and the Server over card workers ----------

def _spec_engine():
    """The paged 12-layer engine with speculation (k=3): every program
    the engine has, each captured at setup."""
    return _paged_engine(SpecConfig(True, k=3))


def _serve_mixed(eng, spec):
    """Every bucket, several slots and lengths, prefix reuse and spec
    rounds: the shared-prefix traffic of ``_drive``, then prompts of
    5-60 tokens."""
    _drive(eng, spec)
    sched = Scheduler(buckets=(32, 64), slots=4, max_seq_len=128,
                      default_max_new_tokens=6, paged=PageConfig(True, 16),
                      spec=spec)
    reqs = [sched.submit(np.arange(1, n)) for n in (5, 21, 40, 61, 9)]
    worker = ServeWorker(eng)
    while not sched.idle():
        sched.apply(plan := sched.plan(), worker.serve_step(plan))
    assert all(len(r.result(0)) == 6 for r in reqs)


@pytest.mark.cuda
def test_cuda_engine_captures_each_program_once(cuda_device, monkeypatch):
    """Setup captures one graph per program (one suffix graph a slot);
    serving every bucket, several slots and lengths, prefix reuse and
    spec rounds replays them and captures nothing more."""
    monkeypatch.setenv("RLT_DECODE_IMPL", "paged")
    spec = SpecConfig(True, k=3)
    eng = _spec_engine()
    want = {"prefill_32": 1, "prefill_64": 1, "decode": 1, "kv_copy": 1,
            "suffix": 4, "draft_prefill_32": 1, "draft_prefill_64": 1,
            "draft": 1, "verify": 1}
    assert eng.stats()["captures"] == want
    _serve_mixed(eng, spec)
    # a spec scheduler plans draft + verify rounds only
    eng.decode(np.ones(4, np.int32), np.array([3, 30, 60, 127], np.int32))
    stats = eng.stats()
    assert stats["captures"] == want
    assert stats["recaptures"] == {n: 0 for n in want}
    assert all(stats["calls"][p] > 0 for p in eng.PROGRAMS), stats["calls"]
    assert stats["capture_ms"] > 0 and stats["pool_bytes"] > 0


def _caches(eng) -> list:
    return [c for c in (eng._k, eng._v, eng._dk, eng._dv) if c is not None]


def _snapshot(eng):
    return [c.clone() for c in _caches(eng)]


@torch.inference_mode()
def _restore(eng, snap):
    for c, s in zip(_caches(eng), snap):
        c.copy_(s)


@pytest.mark.cuda
def test_cuda_replayed_programs_equal_their_eager_steps(cuda_device,
                                                        monkeypatch):
    """Each program's replay against the eager step it was captured
    from, on the same caches (those of real traffic) and inputs: the
    same outputs and the same caches after, bit for bit."""
    monkeypatch.setenv("RLT_DECODE_IMPL", "paged")
    eng = _spec_engine()
    _serve_mixed(eng, SpecConfig(True, k=3))
    S, k1 = eng.slots, eng.spec.k + 1
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, S).astype(np.int32)
    pos = np.array([7, 40, 90, 127], np.int32)
    cases = [("decode", (toks, pos), None),
             ("kv_copy", ([0], [2]), None),
             ("suffix", ([11], [45]), 2),
             ("draft", (toks, pos), None),
             # consecutive positions, as the engine sends them: slot 3's
             # run past the cache end (their rows are dropped)
             ("verify", (rng.integers(0, 256, (S, k1)),
                         pos[:, None] + np.arange(k1)), None)]
    for b in eng.buckets:
        ids = np.zeros((1, b), np.int64)
        ids[0, :b - 3] = rng.integers(0, 256, b - 3)
        cases += [(f"prefill_{b}", (ids, [1], [b - 3]), None),
                  (f"draft_prefill_{b}", (ids, [3], [b - 3]), None)]
    with torch.inference_mode():
        for name, values, variant in cases:
            snap = _snapshot(eng)
            out = eng._run(name, *values, variant=variant)
            got = None if out is None else out.clone()
            after = _snapshot(eng)
            _restore(eng, snap)
            want = eng.run_eager(name, *values, variant=variant)
            assert (want is None) == (got is None), name
            assert want is None or torch.equal(got, want), name
            assert all(torch.equal(a, b)
                       for a, b in zip(after, _snapshot(eng))), name


@pytest.mark.cuda
def test_cuda_decode_replay_survives_a_larger_launch_on_its_stream(
        cuda_device):
    """The decode kernels keep tickets and a workspace per stream; a
    larger launch on the capture stream grows them after the capture,
    and the old ones stay allocated, so the decode graph's replay still
    gives the eager step's tokens even when the freed blocks would be
    handed out again (filled with garbage here)."""
    # L=512: four 128-row splits, three live at position 300, so the
    # replay's merge goes through the tickets
    cfg = GPTConfig(vocab_size=256, block_size=512, n_layer=2, n_head=2,
                    n_embd=64, remat=False)
    eng = ServeEngine(GPTLightningModule(cfg), buckets=(512,), slots=4,
                      max_seq_len=512, seed=0).setup()
    prompt = np.zeros((1, 512), np.int64)
    prompt[0, :300] = np.arange(300) % 255 + 1
    for slot in range(4):
        eng.prefill(slot, prompt, 300, 512)
    toks = np.arange(1, 5, dtype=np.int32)
    pos = np.full(4, 300, np.int32)
    snap = _snapshot(eng)
    with torch.inference_mode():
        want = eng.run_eager("decode", toks, pos).clone()
    _restore(eng, snap)
    key = (cuda_device.index or 0, eng._stream.cuda_stream)
    tickets = fd._SCRATCH[key][0]
    old_n, old_ptr = tickets.numel(), tickets.data_ptr()
    del tickets
    g = torch.Generator(device="cuda").manual_seed(0)
    S2, L, H, D = 64, 512, 2, 32
    q = torch.randn(S2, 1, H, D, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    kv = torch.randn(S2, L, H, D, generator=g, device="cuda",
                     dtype=torch.bfloat16)
    with torch.cuda.stream(eng._stream):
        flash_decode_attention(q, kv, kv, torch.full(
            (S2,), L - 1, dtype=torch.int32, device="cuda"))
    torch.cuda.current_stream().wait_stream(eng._stream)
    assert fd._SCRATCH[key][0].numel() > old_n
    # a freed block goes back to its stream's pool: take blocks of the
    # old tickets' size there until the old address would come back,
    # poisoned so that a replay into it could not merge its splits
    with torch.cuda.stream(eng._stream):
        junk = []
        for _ in range(8192):
            junk.append(torch.full((old_n,), 2 ** 30, dtype=torch.int32,
                                   device="cuda"))
            if junk[-1].data_ptr() == old_ptr:
                break
    torch.cuda.current_stream().wait_stream(eng._stream)
    got = eng.decode(toks, pos)
    assert np.array_equal(got, want.cpu().numpy()), (got, want)
    assert all(t.data_ptr() != old_ptr for t in junk)


@pytest.mark.cuda
def test_cuda_server_workers_take_one_card_each(cards):
    """``Server(num_workers=2)`` puts one worker on each card, each over
    half the slots, with every program captured once: each request's
    tokens equal one worker's, or differ first at a bf16 near-tie
    (2e-2) of the whole-sequence forward."""
    cfg = GPTConfig(vocab_size=256, block_size=64, n_layer=2, n_head=2,
                    n_embd=64, remat=False)
    prompts = [np.arange(1, n) for n in (4, 17, 30, 9, 40, 12)]
    outs, infos = [], []
    for w in (1, 2):
        with Server(GPTLightningModule(cfg), num_workers=w,
                    buckets=(16, 32, 64), max_batch_slots=4,
                    max_new_tokens=8) as server:
            reqs = [server.submit(p) for p in prompts]
            outs.append([r.result(120).tolist() for r in reqs])
            infos.append(server.stats())
    devices = [i["device"] for i in infos[1]["setup"]]
    assert devices == ["cuda:0", "cuda:1"], devices
    for st in infos:
        for wk in st["workers"]:
            assert wk["recaptures"] and not any(wk["recaptures"].values())
    ref = GPT(dataclasses.replace(cfg, attention_impl="dot"))
    eng = ServeEngine(GPTLightningModule(cfg), buckets=(16,), slots=1,
                      max_seq_len=64, seed=0).setup()
    ref.load_state_dict(eng.model.state_dict())
    ref.to(dtype=torch.bfloat16)
    for p, one, two in zip(prompts, *outs):
        n = next((i for i, (a, b) in enumerate(zip(one, two)) if a != b),
                 None)
        if n is None:
            continue
        seq = torch.tensor([list(p) + one[:n]], device="cuda")
        with torch.inference_mode():
            logits = ref(seq)[0, -1].float()
        assert abs(logits[one[n]] - logits[two[n]]) <= 2e-2, (p, one, two)


# -- KV shipping, the int8 draft and the fleet on the card ---------------------

def _ship_engine(spec=None):
    """``_paged_engine`` with the KV import programs (and ``spec``)."""
    cfg = GPTConfig(vocab_size=256, block_size=128, n_layer=12, n_head=2,
                    n_embd=64, remat=False)
    return ServeEngine(GPTLightningModule(cfg), buckets=(32, 64), slots=4,
                       max_seq_len=128, seed=0, paged=PageConfig(True, 16),
                       spec=spec, kvship=True).setup()


@pytest.mark.cuda
def test_cuda_kv_import_replays_equal_their_eager_steps(cuda_device,
                                                        monkeypatch):
    """``kvship=True`` captures one ``kv_import_{b}`` graph a bucket at
    setup; each replay, on caches of real traffic, leaves the caches its
    eager step leaves, bit for bit, and ``import_kv`` (host cast to the
    cache dtype, then the replay) captures nothing more."""
    monkeypatch.setenv("RLT_DECODE_IMPL", "paged")
    eng = _ship_engine()
    caps = eng.stats()["captures"]
    assert caps["kv_import_32"] == 1 and caps["kv_import_64"] == 1, caps
    assert eng.stats()["programs"] == 2 + 2 + 2 + 2
    _drive(eng)
    nl, _, _, nh, hd = eng.kv_spec.shape
    g = torch.Generator().manual_seed(0)
    for b, slot in ((32, 1), (64, 3)):
        rows = [torch.randn(nl, 1, b, nh, hd, generator=g).to(torch.bfloat16)
                for _ in range(2)]
        snap = _snapshot(eng)
        with torch.inference_mode():
            eng._run(f"kv_import_{b}", *rows, [slot])
        after = _snapshot(eng)
        _restore(eng, snap)
        with torch.inference_mode():
            eng.run_eager(f"kv_import_{b}", *rows, [slot])
        assert all(torch.equal(a, c) for a, c in zip(after, _snapshot(eng)))
        # fp32 rows through import_kv: cast on the host, then the replay
        eng.import_kv(slot, rows[0].float(), rows[1].float())
        assert torch.equal(eng._k[:, slot, :b].cpu(), rows[0][:, 0])
        assert torch.equal(eng._v[:, slot, :b].cpu(), rows[1][:, 0])
    stats = eng.stats()
    assert not any(stats["recaptures"].values()), stats["recaptures"]
    assert stats["calls"]["kv_import"] == 2


@pytest.mark.cuda
def test_cuda_export_import_across_engines_gives_cold_tokens(cuda_device,
                                                             monkeypatch):
    """A prompt prefilled on engine A, its whole pages exported and
    imported into engine B's cache bit for bit; B serves prompt + first
    token through a reuse of the imported rows, and every token is the
    cold whole-sequence forward's argmax or within a bf16 near-tie
    (2e-2) of it, as A's own tokens are."""
    monkeypatch.setenv("RLT_DECODE_IMPL", "paged")
    a, b = _ship_engine(), _ship_engine()
    pages = PageConfig(True, 16)
    prompt = np.arange(3, 43) % 250 + 1            # 40 tokens, 2 pages
    sched_a = Scheduler(buckets=(32, 64), slots=4, max_seq_len=128,
                        default_max_new_tokens=1, paged=pages)
    leg1 = sched_a.submit(prompt, ship_kv=True)
    worker_a = ServeWorker(a)
    while not sched_a.idle():
        sched_a.apply(plan := sched_a.plan(), worker_a.serve_step(plan))
    k_rows, v_rows, matched = sched_a.pop_kv_export(leg1.id)
    assert matched == 32 and k_rows.dtype == torch.bfloat16
    assert torch.equal(k_rows[:, 0], a._k[:, leg1.slot, :32].cpu())
    sched_b = Scheduler(buckets=(32, 64), slots=4, max_seq_len=128,
                        default_max_new_tokens=8, paged=pages)
    slot = sched_b.adopt_imported(prompt)
    ServeWorker(b).serve_import_kv(slot, k_rows, v_rows)
    sched_b.adopt_commit(slot, prompt)
    assert torch.equal(b._k[:, slot, :32].cpu(), k_rows[:, 0])
    assert torch.equal(b._v[:, slot, :32].cpu(), v_rows[:, 0])
    t1 = int(leg1.result(0)[0])
    leg2 = sched_b.submit(np.concatenate([prompt, [t1]]))
    worker_b = ServeWorker(b)
    reused = 0
    while not sched_b.idle():
        plan = sched_b.plan()
        reused += sum("reuse" in p for p in plan["prefills"])
        sched_b.apply(plan, worker_b.serve_step(plan))
    assert reused == 1
    assert sched_b.pages.stats()["remote_imports"] == 1
    tokens = [t1] + leg2.result(0).tolist()
    ref = GPT(dataclasses.replace(a.model.config, attention_impl="dot"))
    ref.load_state_dict(a.model.state_dict())
    ref.to(dtype=torch.bfloat16).eval()
    seq = torch.tensor([list(prompt) + tokens[:-1]], device="cuda")
    with torch.inference_mode():
        logits = ref(seq)[0, len(prompt) - 1:].float()
    for i, tok in enumerate(tokens):
        best = int(logits[i].argmax())
        assert tok == best or logits[i, tok] >= logits[i, best] - 2e-2, \
            (i, tok, best)


@pytest.mark.cuda
def test_cuda_int8_draft_graphs_equal_their_eager_steps(cuda_device,
                                                        monkeypatch):
    """``draft_quant="int8"``: the draft's weights stay resident as int8
    pairs and each draft program dequantizes them inside its graph; the
    draft and draft-prefill replays equal their eager steps bit for bit,
    and the drafts equal a bf16 draft holding the dequantized weights."""
    monkeypatch.setenv("RLT_DECODE_IMPL", "paged")
    eng = _ship_engine(SpecConfig(True, k=3, draft_quant="int8"))
    sp = eng.stats()["spec"]
    assert sp["draft_quant"] == "int8"
    assert 0 < sp["draft_resident_bytes"] < sp["draft_fp_bytes"]
    _serve_mixed(eng, SpecConfig(True, k=3, draft_quant="int8"))
    S = eng.slots
    toks = np.arange(5, 5 + S).astype(np.int32)
    pos = np.array([7, 40, 90, 120], np.int32)
    ids = np.zeros((1, 32), np.int64)
    ids[0, :29] = np.arange(1, 30)
    for name, values in (("draft", (toks, pos)),
                         ("draft_prefill_32", (ids, [2], [29]))):
        snap = _snapshot(eng)
        with torch.inference_mode():
            out = eng._run(name, *values)
            got = None if out is None else out.clone()
        after = _snapshot(eng)
        _restore(eng, snap)
        with torch.inference_mode():
            want = eng.run_eager(name, *values)
        assert (got is None) == (want is None), name
        assert got is None or torch.equal(got, want), name
        assert all(torch.equal(x, y) for x, y in zip(after, _snapshot(eng)))
    stats = eng.stats()
    assert not any(stats["recaptures"].values()), stats["recaptures"]


_FLEET_SCRIPT = r"""
import numpy as np, torch
from ray_lightning_tpu_torch import FleetServer, GPTLightningModule
from ray_lightning_tpu_torch.models.bert import CONFIGS as BERT_CONFIGS
from ray_lightning_tpu_torch.models.gpt import GPTConfig
cfg = GPTConfig(vocab_size=256, block_size=64, n_layer=2, n_head=2,
                n_embd=64, remat=False)
fleet = FleetServer(GPTLightningModule(cfg), replicas=2, autoscale=False,
                    fleet={"roles": ("prefill", "decode")},
                    buckets=(16, 32, 64), max_batch_slots=4,
                    max_new_tokens=6).start()
try:
    shared = np.arange(1, 33)
    outs = [fleet.generate(np.concatenate([shared, [40 + i]]), timeout=120)
            for i in range(3)]
    kv = fleet.status()["fleet"]["kvship"]
finally:
    fleet.shutdown()
assert all(len(o) == 6 for o in outs), outs
assert kv["ships"] == 3 and kv["failovers"] == 0, kv
assert not torch.cuda.is_initialized(), "the driver initialised CUDA"
print("FLEET_OK", kv["compression_ratio"])
"""


@pytest.mark.cuda
def test_cuda_fleet_leaves_the_driver_off_cuda(cuda_device, tmp_path):
    """A two-replica disaggregated fleet on the card (both replicas' workers
    on card 0) ships every request's pages, fp8 on the wire, and its
    driver never initialises CUDA (a fresh process: this one has)."""
    import subprocess
    import sys
    root = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "-c", _FLEET_SCRIPT],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(tmp_path),
                         env={**__import__("os").environ,
                              "PYTHONPATH": root})
    assert out.returncode == 0 and "FLEET_OK" in out.stdout, \
        out.stdout[-2000:] + out.stderr[-4000:]


# -- sharded training beyond ZeRO-1 (FSDP, tensor parallelism) ------------

class SaveShardedAtEnd(Callback):
    """``save_sharded_checkpoint`` at the fit's end, on every rank."""

    def __init__(self, path):
        self.path = path

    def on_fit_end(self, trainer, module):
        trainer.save_sharded_checkpoint(self.path)


def _plugin_gpt(**kw):
    """The tiny GPT of the plugin-path tests below (its own name: the
    engine tests above keep their ``_tiny_gpt``)."""
    return GPTLightningModule(GPTConfig(**{
        **dict(vocab_size=512, block_size=64, n_layer=2, n_head=2,
               n_embd=64), **kw}), batch_size=2, dataset_size=64)


def _tp(**sizes):
    from ray_lightning_tpu_torch.models.gpt import gpt_partition_rules
    from ray_lightning_tpu_torch.parallel.strategy import SpmdStrategy
    return SpmdStrategy(gpt_partition_rules(), ("data", "fsdp", "tensor"),
                        sizes)


def _plugin_fit(plugin, module, root, steps=6, callbacks=()):
    trainer = Trainer(plugins=[plugin], max_steps=steps, seed=0,
                      limit_val_batches=1, num_sanity_val_steps=0,
                      enable_checkpointing=False, logger=False,
                      default_root_dir=str(root),
                      callbacks=[RelayLosses(), *callbacks])
    RELAYED_LOSSES.clear()
    trainer.fit(module)
    [losses] = RELAYED_LOSSES
    return losses, module._trained_state


@pytest.mark.cuda
def test_cuda_fsdp_equals_ddp_across_cards(cards, tmp_path):
    """``RaySpmdPlugin(strategy="fsdp")`` over NCCL, one worker a card, on
    the tiny GPT through the kernels (bf16 params, the fp32 master): at
    W=2 the losses and the whole weights after 6 steps equal
    ``RayPlugin`` DDP's bit for bit (a sum of two ranks has one
    order)."""
    from ray_lightning_tpu_torch import RayPlugin, RaySpmdPlugin
    dl, dw = _plugin_fit(RayPlugin(num_workers=2, timeout_s=300),
                         _plugin_gpt(), tmp_path / "ddp")
    fl, fw = _plugin_fit(RaySpmdPlugin(num_workers=2, strategy="fsdp",
                                       timeout_s=300),
                         _plugin_gpt(), tmp_path / "fsdp")
    assert fl == dl and np.isfinite(dl).all()
    assert all(torch.equal(fw[k], dw[k]) for k in dw)


def _rel_l2_exact(a, b) -> float:
    """||a - b|| / ||b|| with no floor: the sharded and parallel fits'
    bar (``_rel_l2`` above floors the denominator for the kernels'
    T=1 cases)."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("one_card", [False, True],
                         ids=["nccl_two_cards", "gloo_one_card"])
def test_cuda_tensor_parallel_matches_one_rank(one_card, cuda_device,
                                               tmp_path, monkeypatch):
    """``SpmdStrategy(gpt_partition_rules(), tensor=2)`` over two workers
    (NCCL on two cards; or both on card 0 over gloo,
    ``RLT_ONE_CARD_GLOO=1``) against one worker, the tiny GPT in bf16
    through the kernels at H/2 heads a rank: the losses within 2e-2 and
    each weight within 2e-2 in relative L2 after 6 steps, no entry more
    than 2 x lr x steps away (the k third of each qkv bias apart: its
    gradient is identically zero, so Adam turns rounding into steps of
    up to lr, ROADMAP.md F5)."""
    from ray_lightning_tpu_torch import RayPlugin, RaySpmdPlugin
    if not one_card and torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    if one_card:
        monkeypatch.setenv("RLT_ONE_CARD_GLOO", "1")
    tl, tw = _plugin_fit(RaySpmdPlugin(num_workers=2, strategy=_tp(tensor=2),
                                       timeout_s=300),
                         _plugin_gpt(n_head=4), tmp_path / "tp")
    monkeypatch.delenv("RLT_ONE_CARD_GLOO", raising=False)
    ol, ow = _plugin_fit(RayPlugin(num_workers=1, timeout_s=300),
                         _plugin_gpt(n_head=4), tmp_path / "one")
    np.testing.assert_allclose(tl, ol, rtol=2e-2, atol=2e-2)
    assert {k: v.shape for k, v in tw.items()} == \
        {k: v.shape for k, v in ow.items()}
    C, lr = 64, 3e-4
    for k in ow:
        a, b = tw[k].float().reshape(-1), ow[k].float().reshape(-1)
        assert (a - b).abs().max() <= 2 * lr * 6, k
        if k.endswith("attn.qkv.bias"):
            a, b = torch.cat([a[:C], a[2 * C:]]), torch.cat([b[:C], b[2 * C:]])
        if b.norm() > 0:
            assert _rel_l2_exact(a, b) <= 2e-2, k


@pytest.mark.cuda
def test_cuda_sharded_checkpoint_two_cards_to_one(cards, tmp_path):
    """A sharded checkpoint saved by two FSDP workers (each writing its
    own blocks) restores into one process on the card bit for bit: the
    weights equal the fit's, and a fit resumed at its last step runs
    none."""
    from ray_lightning_tpu_torch import RaySpmdPlugin
    ckdir = str(tmp_path / "sharded")
    _, saved = _plugin_fit(RaySpmdPlugin(num_workers=2, strategy="fsdp",
                                         timeout_s=300),
                           _plugin_gpt(), tmp_path / "a",
                           callbacks=[SaveShardedAtEnd(ckdir)])
    module = _plugin_gpt()
    trainer = Trainer(max_steps=6, seed=0, num_sanity_val_steps=0,
                      limit_val_batches=0, enable_checkpointing=False,
                      logger=False, default_root_dir=str(tmp_path / "b"),
                      strategy="fsdp", resume_from_checkpoint=ckdir)
    trainer.fit(module)
    assert trainer.global_step == 6
    got = {k: v.cpu() for k, v in module._trained_state.items()}
    assert all(torch.equal(got[k], saved[k]) for k in saved)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["fsdp", "spmd"])
def test_cuda_sharded_strategies_graph_their_chunks(strategy, cuda_device,
                                                    tmp_path):
    """In process on the card, ``steps_per_execution=4`` under a sharded
    strategy is one CUDA graph a chunk, bit for bit with the eager k=1
    fit (weights and losses)."""
    class Losses(Callback):
        losses: list = []

        def on_train_batch_end(self, trainer, module, outputs, batch, i):
            self.losses = self.losses + outputs["loss"].detach().float(
            ).reshape(-1).tolist()

    runs = {}
    for k in (1, 4):
        module = _plugin_gpt()
        rec = Losses()
        trainer = Trainer(max_steps=8, seed=0, num_sanity_val_steps=0,
                          limit_val_batches=0, enable_checkpointing=False,
                          logger=False, strategy=strategy,
                          steps_per_execution=k, callbacks=[rec],
                          default_root_dir=str(tmp_path / f"k{k}"))
        trainer.fit(module)
        runs[k] = (rec.losses, module._trained_state, trainer.graph_stats)
    assert runs[4][2]["captures"] == 1 and runs[4][2]["replays"] == 2
    assert runs[4][0] == runs[1][0]
    assert all(torch.equal(runs[4][1][n], runs[1][1][n]) for n in runs[1][1])


# -- the sequence, stage and expert axes (ring, pipeline, experts) ---------

def _close_fits(got, want, lr: float, steps: int, C: int) -> None:
    """Losses within 2e-2 and each weight (a pipelined model's layer by
    layer) within 2e-2 in relative L2, the k third of each qkv bias
    apart, no entry more than 2 x lr x steps away (ROADMAP.md F5)."""
    from ray_lightning_tpu_torch.convert import unstack_blocks
    (gl, gw), (wl, ww) = got, want
    np.testing.assert_allclose(gl, wl, rtol=2e-2, atol=2e-2)
    gw, ww = unstack_blocks(gw), unstack_blocks(ww)
    assert {k: v.shape for k, v in gw.items()} == \
        {k: v.shape for k, v in ww.items()}
    for k in ww:
        a, b = gw[k].float().reshape(-1), ww[k].float().reshape(-1)
        assert (a - b).abs().max() <= 2 * lr * steps, k
        if k.endswith("attn.qkv.bias"):
            a, b = torch.cat([a[:C], a[2 * C:]]), torch.cat([b[:C], b[2 * C:]])
        if b.norm() > 0:
            assert _rel_l2_exact(a, b) <= 2e-2, k


@pytest.mark.cuda
def test_cuda_ring_sequence_matches_one_rank(cards, tmp_path):
    """``attention_impl="ring"`` on (data=1, sequence=2) over NCCL, one
    worker a card, the tiny GPT in bf16: each rank its half of every
    sequence; against one worker (a ring of one: blockwise) within
    2e-2."""
    from ray_lightning_tpu_torch import RayPlugin, RaySpmdPlugin
    from ray_lightning_tpu_torch.parallel.strategy import SpmdStrategy
    seq = SpmdStrategy(axis_names=("data", "sequence"),
                       axis_sizes={"sequence": 2})
    got = _plugin_fit(RaySpmdPlugin(num_workers=2, strategy=seq,
                                    timeout_s=300),
                      _plugin_gpt(attention_impl="ring"), tmp_path / "ring")
    want = _plugin_fit(RayPlugin(num_workers=1, timeout_s=300),
                       _plugin_gpt(attention_impl="ring"), tmp_path / "one")
    _close_fits(got, want, 3e-4, 6, 64)


@pytest.mark.cuda
def test_cuda_pipeline_stages_match_one_rank(cards, tmp_path):
    """``PipelinedGPT`` (tiny, bf16 compute, the flash kernels inside each
    stage) under ``PipelineStrategy(stages=2)`` over NCCL against one
    worker (no stage axis: a loop over the layers) within 2e-2."""
    from ray_lightning_tpu_torch import RayPlugin, RaySpmdPlugin
    from ray_lightning_tpu_torch.models.pipeline_gpt import PipelinedGPT
    from ray_lightning_tpu_torch.parallel.pipeline import PipelineStrategy

    def module():
        return PipelinedGPT(GPTConfig(vocab_size=512, block_size=64,
                                      n_layer=2, n_head=2, n_embd=64),
                            n_microbatches=2, batch_size=4,
                            dataset_size=64)

    got = _plugin_fit(RaySpmdPlugin(num_workers=2,
                                    strategy=PipelineStrategy(stages=2),
                                    timeout_s=300), module(),
                      tmp_path / "pipe")
    want = _plugin_fit(RayPlugin(num_workers=1, timeout_s=300), module(),
                       tmp_path / "one")
    _close_fits(got, want, 3e-4, 6, 64)


@pytest.mark.cuda
def test_cuda_expert_parallel_matches_one_rank(cards, tmp_path):
    """moe-tiny (bf16) at expert=2 over NCCL, each worker two of the four
    experts of every routed layer, against one worker within 2e-2."""
    from ray_lightning_tpu_torch import RayPlugin, RaySpmdPlugin
    from ray_lightning_tpu_torch.models.gpt import gpt_partition_rules
    from ray_lightning_tpu_torch.parallel.strategy import SpmdStrategy
    ep = SpmdStrategy(gpt_partition_rules(), ("data", "expert"),
                      {"expert": 2})
    got = _plugin_fit(RaySpmdPlugin(num_workers=2, strategy=ep,
                                    timeout_s=300),
                      _plugin_gpt(n_experts=4), tmp_path / "ep")
    want = _plugin_fit(RayPlugin(num_workers=1, timeout_s=300),
                       _plugin_gpt(n_experts=4), tmp_path / "one")
    _close_fits(got, want, 3e-4, 6, 64)


# -- the comm plane (compressed gradient collectives) -------------------------

#: graph stats the workers relayed, appended on the driver
RELAYED_GRAPHS: list = []


def _record_graphs(stats):
    RELAYED_GRAPHS.append(stats)


class RelayGraphs(Callback):
    """Rank 0 relays its chunk graphs' stats at the fit's end."""

    def on_fit_end(self, trainer, module):
        from ray_lightning_tpu_torch import session
        if trainer.is_global_zero:
            session.put_queue(functools.partial(_record_graphs, {
                k: trainer.graph_stats.get(k) for k in (
                    "captures", "replays", "ungraphed", "eager_chunks")}))


def _comm_psums(rank, world, x, device):
    """The comm plane's collectives on this rank's row of ``x`` on
    ``device`` ("cuda": this process's card), returned on the host."""
    from ray_lightning_tpu_torch.comm import collectives as tc
    dev = torch.device(device, rank) if device == "cuda" else \
        torch.device("cpu")
    t = torch.from_numpy(x[rank]).to(dev)
    out = {}
    for mode in ("int8", "bf16", "fp8", "int4"):
        shard, _, err = tc.compressed_reduce_scatter(t, None, world,
                                                     mode=mode,
                                                     with_error=True)
        ps, pe = tc.compressed_psum(t, None, world, mode=mode, mean=True,
                                    with_error=True)
        out[mode] = [a.cpu().numpy() for a in (shard, err, ps, pe)]
    return out


@pytest.mark.cuda
def test_cuda_compressed_psum_over_nccl_equals_gloo_cpu(cards):
    """The compressed reduce-scatter and psum (with their errors) in all
    four codecs over NCCL on two cards equal the gloo CPU ranks' bit for
    bit: the same codec bytes, the same fp32 sums in rank order."""
    from torch_gloo import run_gloo
    x = np.random.default_rng(1).standard_normal((2, 4099)).astype(
        np.float32)
    got = run_gloo(_comm_psums, 2, x, "cuda", backend="nccl")
    want = run_gloo(_comm_psums, 2, x, "cpu")
    for r in range(2):
        for mode, arrays in want[r].items():
            for i, a in enumerate(arrays):
                assert np.array_equal(got[r][mode][i], a), (r, mode, i)


@pytest.mark.cuda
@pytest.mark.parametrize("zero1", [False, True], ids=["ddp", "zero1"])
def test_cuda_graphed_compressed_fit_equals_eager(zero1, cards, tmp_path):
    """Two workers over NCCL, the tiny GPT under int8 with stochastic
    rounding (ZeRO-1: with the bf16 param gather in buckets): 6 steps at
    ``steps_per_execution=2`` (the sync, the residual's update and the
    keyed draws captured in each chunk's graph) equal the eager fit bit
    for bit."""
    from ray_lightning_tpu_torch import (CommPolicy, RayPlugin,
                                         RayShardedPlugin)
    pol = CommPolicy("int8", axes=("data",), stochastic_rounding=True,
                     **(dict(param_gather="bf16", gather_bucket_bytes=1 << 14)
                        if zero1 else {}))
    cls = RayShardedPlugin if zero1 else RayPlugin

    def fit(k, root):
        RELAYED_GRAPHS.clear()
        trainer = Trainer(plugins=[cls(num_workers=2, timeout_s=300)],
                          max_steps=6, seed=0, limit_val_batches=0,
                          num_sanity_val_steps=0, enable_checkpointing=False,
                          logger=False, default_root_dir=str(root),
                          comm_policy=pol, steps_per_execution=k,
                          callbacks=[RelayLosses(), RelayGraphs()])
        RELAYED_LOSSES.clear()
        module = _plugin_gpt()
        trainer.fit(module)
        [losses], [graphs] = RELAYED_LOSSES, RELAYED_GRAPHS
        return losses, module._trained_state, graphs

    el, ew, _ = fit(1, tmp_path / "eager")
    gl, gw, graphs = fit(2, tmp_path / "graphed")
    assert graphs["captures"] == 1 and graphs["replays"] == 3, graphs
    assert graphs["ungraphed"] is None
    assert gl == el
    assert all(torch.equal(gw[k], ew[k]) for k in ew)


@pytest.mark.cuda
def test_cuda_gloo_chunk_on_card_equals_k1(cuda_device, tmp_path,
                                           monkeypatch):
    """Both workers on card 0 over gloo (``RLT_ONE_CARD_GLOO=1``), whose
    collectives a graph cannot hold: ``steps_per_execution=2`` with the
    cached train set runs each chunk as 2 eager steps, says so in
    ``graph_stats``, and equals the k=1 fit bit for bit, under the comm
    plane too."""
    from ray_lightning_tpu_torch import CommPolicy, RayPlugin
    monkeypatch.setenv("RLT_ONE_CARD_GLOO", "1")
    for pol in (None, CommPolicy("int8", axes=("data",))):
        runs = []
        for kw in (dict(), dict(steps_per_execution=2,
                                cache_train_dataset=True)):
            RELAYED_GRAPHS.clear()
            RELAYED_LOSSES.clear()
            module = _plugin_gpt()
            Trainer(plugins=[RayPlugin(num_workers=2, timeout_s=300)],
                    max_steps=6, seed=0, limit_val_batches=0,
                    num_sanity_val_steps=0, enable_checkpointing=False,
                    logger=False, default_root_dir=str(tmp_path),
                    comm_policy=pol, callbacks=[RelayLosses(), RelayGraphs()],
                    **kw).fit(module)
            runs.append((RELAYED_LOSSES[0], module._trained_state,
                         RELAYED_GRAPHS[0]))
        (el, ew, _), (gl, gw, graphs) = runs
        assert graphs["captures"] == 0 and graphs["eager_chunks"] == 3
        assert "gloo" in graphs["ungraphed"]
        assert gl == el
        assert all(torch.equal(gw[k], ew[k]) for k in ew)


# -- serving under the training strategies ----------------------------------

#: a tiny GPT whose two tensor ranks each hold two heads of 32 (bf16)
_TP_SERVE = GPTConfig(vocab_size=256, block_size=64, n_layer=2, n_head=4,
                      n_embd=128, remat=False)
_TP_PROMPTS = [np.arange(1, n) % 256 * 7 % 256 for n in (5, 19, 33, 9, 47,
                                                       12)]


def _tensor2():
    from ray_lightning_tpu_torch.models.gpt import gpt_partition_rules
    from ray_lightning_tpu_torch.parallel.strategy import SpmdStrategy
    return SpmdStrategy(gpt_partition_rules(), ("data", "tensor"),
                        {"data": 1, "tensor": 2})


def _tp_serve(prompts) -> "tuple[list, dict]":
    with Server(GPTLightningModule(_TP_SERVE), num_workers=2,
                strategy=_tensor2(), buckets=(16, 32, 64),
                max_batch_slots=4, max_new_tokens=8, seed=3) as server:
        reqs = [server.submit(p) for p in prompts]
        tokens = [r.result(120).tolist() for r in reqs]
        return tokens, server.stats()


@pytest.mark.cuda
def test_cuda_tensor_parallel_serving_nccl_equals_gloo(cards, monkeypatch):
    """``Server(num_workers=2, tensor=2)`` over NCCL on two cards (every
    program one CUDA graph, its collectives inside) serves the tokens
    it serves with both ranks on card 0 over gloo (eager): the same
    kernels and the same fp32 sums in rank order."""
    nccl, st = _tp_serve(_TP_PROMPTS)
    assert [i["device"] for i in st["setup"]] == ["cuda:0", "cuda:1"]
    for w in st["workers"]:
        assert w["ungraphed"] is None and w["captures"]
        assert not any(w["recaptures"].values()), w["recaptures"]
        assert w["head_block"] == [2 * w["rank"], 2 * w["rank"] + 2]
    monkeypatch.setenv("RLT_ONE_CARD_GLOO", "1")
    gloo, st = _tp_serve(_TP_PROMPTS)
    assert [i["device"] for i in st["setup"]] == ["cuda:0", "cuda:0"]
    for w in st["workers"]:
        assert "gloo" in w["ungraphed"] and not w["captures"]
    assert nccl == gloo


def _tp_graphed_rank(rank, world, prompts):
    """(a rank over NCCL) the tensor=2 engine's prefill and decode
    replays against the eager steps they were captured from, on the same
    caches: outputs and caches bit for bit."""
    from ray_lightning_tpu_torch.serve import bucket_for, pad_to_bucket
    eng = ServeEngine(GPTLightningModule(_TP_SERVE), (16, 32, 64), 4, 64,
                      seed=3, device=torch.device("cuda", rank),
                      strategy=_tensor2()).setup()
    assert eng.ungraphed is None and eng.stats()["captures"]["decode"] == 1
    out = {"head_block": eng.head_block}
    with torch.inference_mode():
        for s, p in enumerate(prompts[:4]):
            b = bucket_for(len(p), eng.buckets)
            eng.prefill(s, pad_to_bucket(p, b), len(p), b)
        toks = np.array([5, 9, 13, 200], np.int32)
        pos = np.array([len(p) for p in prompts[:4]], np.int32)
        cases = [("decode", (toks, pos)),
                 ("prefill_32", (pad_to_bucket(prompts[2], 32), [1], [20]))]
        for name, args in cases:
            snap = [eng._k.clone(), eng._v.clone()]
            replay = eng._run(name, *args).clone()
            after = [eng._k.clone(), eng._v.clone()]
            eng._k.copy_(snap[0])
            eng._v.copy_(snap[1])
            eager = eng.run_eager(name, *args)
            torch.cuda.synchronize()
            out[name] = (torch.equal(replay, eager),
                         torch.equal(after[0], eng._k)
                         and torch.equal(after[1], eng._v))
    return out


@pytest.mark.cuda
def test_cuda_graphed_tensor_parallel_decode_equals_eager(cards):
    """Over NCCL on two cards, each tensor rank's captured decode and
    prefill (their all-reduces and the vocab gather inside the graphs)
    equal their eager steps bit for bit, outputs and caches."""
    from torch_gloo import run_gloo
    outs = run_gloo(_tp_graphed_rank, 2, _TP_PROMPTS, backend="nccl",
                    timeout=300)
    assert [o["head_block"] for o in outs] == [(0, 2), (2, 4)]
    for o in outs:
        assert o["decode"] == (True, True) and o["prefill_32"] == (True,
                                                                   True), o


# -- the elastic plane ----------------------------------------------------------


@pytest.mark.cuda
def test_cuda_parity_recovery_round_trips_the_escrow(cuda_device, tmp_path,
                                                     monkeypatch):
    """The parity route on one card: two ZeRO-1 workers on card 0 over
    gloo (``RLT_ONE_CARD_GLOO=1``) train gpt2-small's width at 2 layers,
    rank 1 is killed at step 3, and the fit ends on one worker at step 5,
    resumed at step 3 with no snapshot read.  The escrow round trip is
    bit for bit: the shard rebuilt from parity hashes to the digest rank
    1 sent with its blob, and its bf16 first moments are among the
    rebuilt leaves as bf16."""
    from ray_lightning_tpu_torch import RayPlugin
    from ray_lightning_tpu_torch.models.gpt import CONFIGS
    monkeypatch.setenv("RLT_ONE_CARD_GLOO", "1")
    cfg = dataclasses.replace(CONFIGS["gpt2-small"], n_layer=2)
    module = GPTLightningModule(cfg, batch_size=2, dataset_size=2 * 2 * 5)
    trainer = Trainer(
        plugins=[RayPlugin(num_workers=2, strategy="zero1", timeout_s=300,
                           worker_env={"RLT_FAULT": "kill:rank=1,step=3"})],
        max_epochs=10, max_steps=5, seed=0, limit_val_batches=0,
        num_sanity_val_steps=0, enable_checkpointing=False, logger=False,
        default_root_dir=str(tmp_path),
        elastic={"snapshot_every_n_steps": 2, "max_restarts": 1,
                 "redundancy": 1, "snapshot_dir": str(tmp_path / "snap")})
    trainer.fit(module)
    rep = trainer._elastic_report
    assert trainer.global_step == 5
    assert (rep["recovery"], rep["resumed_step"], rep["workers"]) \
        == ("parity", 3, 1)
    assert rep.get("snapshot_restores", 0) == 0
    assert rep["dead_digest"] == rep["escrowed_digest"]
    rebuilt = rep["rebuilt_leaves"]
    mu = [k for k in rebuilt if "/mu/" in k]
    assert mu and all(rebuilt[k] == "bfloat16" for k in mu), rebuilt
    assert all(torch.isfinite(v.float()).all()
               for v in module._trained_state.values())
