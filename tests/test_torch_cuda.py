"""PyTorch/CUDA port, kernels on the card: each hand-written CUDA kernel
of ``ray_lightning_tpu_torch`` against its plain PyTorch version, at the
serve and training paths' shapes and at edge lengths, in bf16: outputs
within 2e-2 in max abs error; the backward's dq, dk, dv in per-tensor
relative L2, within 1e-3 of the plain backward (same rounding points)
and within 1e-2 of plain attention under autograd (which rounds
elsewhere).  A max abs error would have to allow for the few rows whose
gradients grow past 1 with T, and would then miss a fault confined to a
tile of small gradients.

Every test here is marked ``cuda`` and skips without a card (decided
when the test runs, never while the module is imported).  The file
imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: tests/conftest.py sets up JAX for the rest of the
suite.)
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch import (GPT, BertLightningModule,
                                     BertMLMModule, Callback,
                                     GPTLightningModule, Scheduler,
                                     ServeEngine, ServeWorker, Trainer)
from ray_lightning_tpu_torch.models.gpt import GPTConfig
from ray_lightning_tpu_torch.ops import _kernels
from ray_lightning_tpu_torch.ops.attention import dot_product_attention
from ray_lightning_tpu_torch.ops.flash_attention import (
    HEAD_DIMS, flash_attention, flash_attention_bwd,
    flash_attention_bwd_passes, flash_attention_bwd_plain,
    flash_attention_fwd, flash_attention_fwd_plain)
from ray_lightning_tpu_torch.ops.flash_decode import (
    flash_decode_attention, flash_decode_attention_plain,
    flash_decode_paged_attention, flash_decode_paged_attention_plain)
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
    trainer = Trainer(max_steps=3, enable_checkpointing=False, seed=0,
                      num_sanity_val_steps=0, limit_val_batches=0,
                      callbacks=[Losses()], device=cuda_device)
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
    trainer = Trainer(max_steps=3, enable_checkpointing=False, seed=0,
                      num_sanity_val_steps=0, limit_val_batches=0,
                      callbacks=[Losses()], device=cuda_device)
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
    trainer = Trainer(max_steps=3, enable_checkpointing=False, seed=0,
                      num_sanity_val_steps=0, limit_val_batches=0,
                      callbacks=[Losses()], device=cuda_device)
    _kernels.reset_launches()
    trainer.fit(module)
    counts = _kernels.launch_counts()
    assert module.model.remat_policy == "full"
    assert counts["flash_fwd"] == 2 * 2 * 3 and counts["flash_bwd"] == 2 * 3
    assert len(losses) == 3 and np.isfinite(losses).all()


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
