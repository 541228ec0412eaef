"""PyTorch/CUDA port, long-context training path: ``ray_lightning_tpu_torch``
against the JAX package on the same numpy-seeded inputs and converted
weights.

- (a) the causal multi-block attention kernels: the JAX
  ``flash_attention`` (Pallas under the interpreter) at shapes and block
  sizes whose dispatch reaches TPU kernel rows 3 + 9 (row-resident
  forward and backward), 2 + 7 + 8 (triangular forward, dk/dv and dq)
  and 3 + 7 + 8, asserted with the JAX package's own gates and by the
  kernel bodies its ``pallas_call`` receives; against them the port's
  plain forward and backward (what its kernel wrappers take on a CPU
  tensor) and ``flash_attention`` under autograd;
- (b) remat: "full" gives the gradients of "off" bit for bit and runs
  the attention forward twice a layer; unported policies raise;
- (c) the slice as a whole: one train step (loss and every gradient) of
  a narrow 2-layer model under remat "full" with the chunked CE, against
  the JAX package's on converted weights, its attention on rows 3 + 9.

Tolerances: fp32 5e-5 (tests/test_ops.py's for the multi-block kernels),
bf16 2e-2, as ``atol = rtol``.  The shapes are small (T <= 256, two
heads of 64), so the file runs in well under a minute on one core.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.module import StepContext as JaxStepContext
from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
from ray_lightning_tpu_torch.core.module import StepContext
from ray_lightning_tpu_torch.core.remat import policy_object
from ray_lightning_tpu_torch.models.gpt import GPTConfig, GPTLightningModule
from tests.test_torch_train import _JaxFixed, _seeded_params, _TorchFixed

# the modules, not the functions of the same name their packages export
jfa = importlib.import_module("ray_lightning_tpu.ops.flash_attention")
tfa = importlib.import_module("ray_lightning_tpu_torch.ops.flash_attention")

DTYPES = {"float32": (jnp.float32, torch.float32, 5e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

#: TPU kernel rows -> the Pallas kernel bodies their pallas_call runs
ROW_KERNELS = {2: "_fwd_tri_packed_kernel", 3: "_fwd_rowres_kernel",
               7: "_bwd_dkdv_tri_packed_kernel",
               8: "_bwd_dq_tri_packed_kernel", 9: "_bwd_rowres_kernel"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and torch's default of a thread per core would crowd the
    other workers' time-bounded distributed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x, jnp.float32)))


def _pallas_kernels(monkeypatch) -> "list[str]":
    """The names of the kernel bodies the JAX package hands to
    ``pl.pallas_call`` from now on in this test."""
    seen = []
    real = jfa.pl.pallas_call

    def spy(kernel, *args, **kwargs):
        seen.append(getattr(kernel, "func", kernel).__name__)
        return real(kernel, *args, **kwargs)

    monkeypatch.setattr(jfa.pl, "pallas_call", spy)
    return seen


# -- (a) the multi-block kernels ---------------------------------------------

#: (route, T, block, dtype, sm_scale): the rows each route reaches
ROUTES = {"rowres": (3, 9), "tri": (2, 7, 8), "rowres_fwd_tri_bwd": (3, 7, 8)}
CASES = [
    # sm_scale 0.1 takes the row-resident kernels' no-fold branch (the
    # scale is not a power of two); 1/8 folds into q
    ("rowres", 64, 16, "float32", 0.1),
    ("rowres", 128, 32, "bfloat16", None),
    ("tri", 256, 64, "float32", None),
    ("tri", 256, 64, "bfloat16", None),
    ("rowres_fwd_tri_bwd", 192, 64, "float32", None),
]


@pytest.mark.parametrize("route,T,block,dtype,sm_scale", CASES)
def test_multiblock_kernels_match_jax(route, T, block, dtype, sm_scale,
                                      monkeypatch):
    """o, dq, dk, dv of the port's plain forward and backward (from its
    own o and lse) and of ``flash_attention`` under autograd,
    against ``jax.vjp`` of the JAX ``flash_attention`` whose dispatch
    takes the route's rows: the default gates give rows 3 + 9,
    ``RLT_FLASH_ROWRES=0`` rows 2 + 7 + 8, the backward's row-resident
    gate patched off rows 3 + 7 + 8 (as tests/test_ops.py does)."""
    B, H, D = 1, 2, 64
    if route == "tri":
        monkeypatch.setenv("RLT_FLASH_ROWRES", "0")
    elif route == "rowres_fwd_tri_bwd":
        monkeypatch.setattr(jfa, "_use_row_resident", lambda t, w=128: False)
    pack = jfa._head_pack(D, H)
    assert pack == 2 and jfa._use_tri(True, block, block, T // block)
    assert jfa._use_row_resident_fwd(T, pack * D) == (route != "tri")
    assert jfa._use_row_resident(T, pack * D) == (route == "rowres")
    kernels = _pallas_kernels(monkeypatch)

    rng = np.random.default_rng(T + block)
    jdt, tdt, tol = DTYPES[dtype]
    draws = [rng.standard_normal((B, T, H, D)).astype(np.float32)
             for _ in range(4)]
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in draws)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in draws)
    want_o, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(
        q, k, v, causal=True, dtype=jdt, sm_scale=sm_scale, block_q=block,
        block_k=block, interpret=True), jq, jk, jv)
    want = vjp(jdo)
    assert sorted(kernels) == sorted(ROW_KERNELS[r] for r in ROUTES[route])

    o, lse = tfa.flash_attention_fwd(tq, tk, tv, causal=True,
                                     sm_scale=sm_scale)
    plain = tfa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=True,
                                    sm_scale=sm_scale)
    qkv = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = tfa.flash_attention(*qkv, causal=True, dtype=tdt,
                              sm_scale=sm_scale)
    autograd = torch.autograd.grad(out, qkv, tdo)
    assert torch.equal(out.detach(), o)
    np.testing.assert_allclose(_np(o), _np(want_o), atol=tol, rtol=tol,
                               err_msg="o")
    for name, a, b, w in zip(("dq", "dk", "dv"), plain, autograd, want):
        assert a.dtype == tdt and a.shape == (B, T, H, D)
        assert torch.equal(a, b), name
        np.testing.assert_allclose(_np(a), _np(w), atol=tol, rtol=tol,
                                   err_msg=name)


# -- (b) remat ---------------------------------------------------------------

#: the narrow 2-layer model of this file: two heads of 64 (packable, so
#: the JAX dispatch takes the head-packed kernels), T = 128
NARROW = dict(vocab_size=512, block_size=128, n_layer=2, n_head=2,
              n_embd=128, remat=False, attention_impl="dot")


def _batch(seed=5, B=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, NARROW["vocab_size"],
                        (B, NARROW["block_size"] + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _torch_loss_and_grads(cfg, batch):
    mod = _TorchFixed(_seeded_params(**NARROW), config=cfg)
    mod.init_params(torch.Generator())
    params = dict(mod.model.named_parameters())
    loss = mod.training_step(StepContext(mod, training=True), batch)
    return mod, loss, dict(zip(params, torch.autograd.grad(
        loss, list(params.values()))))


def test_remat_full_matches_off_bit_for_bit(monkeypatch):
    """The loss and every gradient of a 2-layer model with flash
    attention under remat "full" equal those with remat off, bit for
    bit; under "full" the attention forward runs twice a layer (forward
    and recompute), once without."""
    calls = []
    fwd = tfa.flash_attention_fwd

    def counting(*args, **kwargs):
        calls.append(1)
        return fwd(*args, **kwargs)

    monkeypatch.setattr(tfa, "flash_attention_fwd", counting)
    batch = tuple(torch.from_numpy(x) for x in _batch())
    cfg = GPTConfig(**{**NARROW, "attention_impl": "flash"},
                    dtype=torch.float32)
    results = {}
    for policy in ("off", "full"):
        calls.clear()
        mod, loss, grads = _torch_loss_and_grads(
            dataclasses.replace(cfg, remat=True, remat_policy=policy),
            batch)
        assert mod.model.remat_policy == policy
        results[policy] = (loss, grads, len(calls))
    (loss_off, g_off, n_off), (loss_full, g_full, n_full) = (
        results["off"], results["full"])
    assert (n_off, n_full) == (2, 4)
    assert torch.equal(loss_off, loss_full)
    assert g_off.keys() == g_full.keys()
    for k in g_off:
        assert torch.equal(g_off[k], g_full[k]), k


@pytest.mark.parametrize("config_policy,env,outcome", [
    ("dots", None, "dots"),
    ("dots_no_batch", None, "dots_no_batch"),
    ("full", "dots_moe", "dots_moe"),
    ("no_such", None, ValueError),
    ("dots", "off", "off"),
    ("off", "full", "full"),
])
def test_remat_policies(config_policy, env, outcome, monkeypatch):
    """``RLT_REMAT_POLICY`` overrides the config's policy, as in the JAX
    package; "dots", "dots_no_batch" and the MoE save lists build (a
    selective checkpoint, core/remat.py), an unknown name raises naming
    the options, and the serve model is built with remat off whatever
    the policy."""
    if env:
        monkeypatch.setenv("RLT_REMAT_POLICY", env)
    module = GPTLightningModule(GPTConfig(**{**NARROW, "remat": True},
                                          remat_policy=config_policy))
    if isinstance(outcome, str):
        assert module.configure_model("cpu").remat_policy == outcome
    else:
        with pytest.raises(outcome, match="options"):
            module.configure_model("cpu")
    assert module.configure_decode_model("cpu").remat_policy == "off"
    assert policy_object("off") is None


# -- (c) the slice as a whole ------------------------------------------------

def test_train_step_under_remat_matches_jax(monkeypatch):
    """One train step of the narrow model in fp32: remat "full", the
    chunked CE over 4 chunks, flash attention.  The JAX step runs its
    Pallas kernels under the interpreter with 32-row blocks, so T=128
    takes rows 3 + 9; the port's step runs ``flash_attention``
    under ``torch.utils.checkpoint``.  The loss and every gradient agree
    within 5e-5."""
    monkeypatch.setenv("RLT_FLASH_BLOCK_Q", "32")
    monkeypatch.setenv("RLT_FLASH_BLOCK_K", "32")
    kernels = _pallas_kernels(monkeypatch)
    params = _seeded_params(**NARROW)
    slice_cfg = {**NARROW, "remat": True, "attention_impl": "flash",
                 "chunked_ce": 4}
    x, y = _batch(seed=9)

    jmod = _JaxFixed(params, config=JaxConfig(**slice_cfg,
                                              dtype=jnp.float32))
    jmod.setup_model()
    jparams = jmod.init_params(None, None)["params"]

    def jloss(p):
        ctx = JaxStepContext(jmod, p, {}, None, training=True)
        return jmod.training_step(ctx, (jnp.asarray(x), jnp.asarray(y)))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(jparams)
    assert {ROW_KERNELS[3], ROW_KERNELS[9]} == set(kernels)

    from ray_lightning_tpu_torch.convert import flax_to_torch
    want = flax_to_torch(jax.device_get(want_grads))
    mod, loss, grads = _torch_loss_and_grads(
        GPTConfig(**slice_cfg, dtype=torch.float32),
        (torch.from_numpy(x), torch.from_numpy(y)))
    assert mod.model.remat_policy == "full"
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=5e-5,
                               rtol=5e-5)
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        assert g.dtype == torch.float32, k
        np.testing.assert_allclose(_np(g), _np(want[k]), atol=5e-5,
                                   rtol=5e-5, err_msg=k)
