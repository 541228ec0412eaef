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

from ray_lightning_tpu_torch import (GPT, Callback, GPTLightningModule,
                                     Scheduler, ServeEngine, ServeWorker,
                                     Trainer)
from ray_lightning_tpu_torch.models.gpt import GPTConfig
from ray_lightning_tpu_torch.ops import _kernels
from ray_lightning_tpu_torch.ops.attention import dot_product_attention
from ray_lightning_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_fwd, flash_attention_fwd_plain)
from ray_lightning_tpu_torch.ops.flash_decode import (
    flash_decode_attention, flash_decode_attention_plain)


@pytest.fixture
def cuda_device():
    """The card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 16, 128, 200])
def test_cuda_flash_fwd_kernel_matches_plain(T, cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(T)
    H, D = 12, 64
    qkv = torch.randn(1, T, 3 * H * D, generator=g,
                      device=cuda_device).to(torch.bfloat16)
    q, k, v = (x.view(1, T, H, D) for x in qkv.split(H * D, dim=-1))
    before = _kernels.REGISTRY["flash_fwd"].launches
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _kernels.REGISTRY["flash_fwd"].launches == before + 1
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3


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
def test_cuda_flash_kernels_refuse_a_grid_past_cuda_limits(cuda_device):
    """Grid y is B * H, which CUDA caps at 65535: past it the wrappers
    raise instead of launching a grid the card refuses."""
    x = torch.zeros(65536, 1, 1, 64, dtype=torch.bfloat16,
                    device=cuda_device)
    with pytest.raises(ValueError, match="65535"):
        flash_attention_fwd(x, x, x)
    lse = torch.zeros(65536, 1, 1, device=cuda_device)
    with pytest.raises(ValueError, match="65535"):
        flash_attention_bwd(x, x, x, x, lse, x)


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
