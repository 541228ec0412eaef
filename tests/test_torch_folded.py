"""PyTorch/CUDA port, the folded attention routes: TPU kernel rows 4, 5,
10, 11, 12, 15 and 16 of the JAX package's ``flash_attention`` (the
``[B*H, T, D]`` kernels it takes when the heads do not pack, or when a
multi-block shape is not causal with square blocks), held against the
port on the same numpy-seeded inputs.

- (a) each route: the JAX ``flash_attention`` with its Pallas kernels
  under the interpreter, through ``jax.vjp``, the route asserted by the
  kernel bodies ``pl.pallas_call`` receives; against it the port's plain
  forward (what ``flash_attention_fwd`` takes on a CPU tensor), its
  plain backward from its own o and lse, and ``flash_attention``
  under autograd;
- (b) ``tpu_rows``, the port's copy of the JAX gates, against the JAX
  dispatch itself over a grid of shapes, block sizes and the
  ``RLT_FLASH_*`` overrides: there ``pallas_call`` is replaced by a spy
  that records the kernel and returns zeros, under ``jax.eval_shape``,
  so nothing is computed.

Tolerances: fp32 2e-5 forward and 5e-5 gradients (tests/test_ops.py),
bf16 2e-2, as ``atol = rtol``.  Each interpret-mode call costs seconds,
so the cases are few and small (T <= 128, two heads).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the modules, not the functions of the same name their packages export
jfa = importlib.import_module("ray_lightning_tpu.ops.flash_attention")
tfa = importlib.import_module("ray_lightning_tpu_torch.ops.flash_attention")

#: the Pallas kernel bodies -> their TPU kernel rows (PERF.md's table)
KERNEL_ROWS = {"_fwd_packed_kernel": 1, "_fwd_tri_packed_kernel": 2,
               "_fwd_rowres_kernel": 3, "_fwd_tri_kernel": 4,
               "_fwd_kernel": 5, "_bwd_packed_kernel": 6,
               "_bwd_dkdv_tri_packed_kernel": 7,
               "_bwd_dq_tri_packed_kernel": 8, "_bwd_rowres_kernel": 9,
               "_bwd_fused_kernel": 10, "_bwd_dkdv_tri_kernel": 11,
               "_bwd_dq_tri_kernel": 12, "_bwd_dkdv_kernel": 15,
               "_bwd_dq_kernel": 16}
#: dtype -> (jax, torch, forward tol, gradient tol)
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5, 5e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2, 2e-2)}
ENV = ("RLT_FLASH_BLOCK_Q", "RLT_FLASH_BLOCK_K", "RLT_FLASH_TRI",
       "RLT_FLASH_ROWRES")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and torch's default of a thread per core would crowd the
    other workers' time-bounded distributed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_flash_env(monkeypatch):
    """The gates read these; a case sets the ones it needs."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x, jnp.float32)))


def _spy(monkeypatch, run: bool = True) -> "list[int]":
    """The rows of the kernel bodies the JAX package hands to
    ``pl.pallas_call`` from now on in this test.  With ``run=False`` the
    call computes nothing and returns zeros of its output shapes."""
    seen = []
    real = jfa.pl.pallas_call

    def spy(kernel, *args, **kwargs):
        seen.append(KERNEL_ROWS[getattr(kernel, "func", kernel).__name__])
        if run:
            return real(kernel, *args, **kwargs)
        out = kwargs["out_shape"]
        return lambda *a: jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype), out)

    monkeypatch.setattr(jfa.pl, "pallas_call", spy)
    return seen


# -- (a) the seven rows -------------------------------------------------------

#: (H, D, T, blocks (q, k) or None, causal, env, dtype, rows)
CASES = [
    # the tiny family's heads (h=2, d=32) do not pack: one block folds
    (2, 32, 64, None, True, {}, "float32", {5, 10}),
    (2, 32, 64, None, False, {}, "bfloat16", {5, 10}),
    # causal square blocks, more than one: the triangular grid
    (2, 32, 128, (32, 32), True, {}, "float32", {4, 11, 12}),
    (2, 32, 128, (32, 32), True, {}, "bfloat16", {4, 11, 12}),
    # packable heads, but non-causal multi-block
    (2, 64, 128, (32, 32), False, {}, "float32", {5, 15, 16}),
    (2, 64, 128, (32, 32), False, {}, "bfloat16", {5, 15, 16}),
    # causal square blocks with the triangular grid switched off
    (2, 64, 128, (32, 32), True, {"RLT_FLASH_TRI": "0"}, "float32",
     {5, 15, 16}),
    # causal, uneven blocks
    (2, 64, 128, (64, 32), True, {}, "float32", {5, 15, 16}),
]


@pytest.mark.parametrize("H,D,T,blocks,causal,env,dtype,rows", CASES)
def test_folded_kernels_match_jax(H, D, T, blocks, causal, env, dtype, rows,
                                  monkeypatch):
    """o, dq, dk, dv of the port's plain forward and backward (from its
    own o and lse) and of ``flash_attention`` under autograd,
    against ``jax.vjp`` of the JAX ``flash_attention`` whose dispatch
    takes the case's rows (asserted by the kernel bodies it runs and by
    ``tpu_rows``).  The port's lse [B, H, T] equals the reference's
    softmax statistics: held against the plain forward's, which the
    backward consumes."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    bq, bk = blocks or (None, None)
    fwd_row, bwd_rows = tfa.tpu_rows(T, H, D, causal, bq, bk)
    assert {fwd_row, *bwd_rows} == rows
    seen = _spy(monkeypatch)

    B = 2
    jdt, tdt, tol, gtol = DTYPES[dtype]
    rng = np.random.default_rng(T + D + causal)
    draws = [rng.standard_normal((B, T, H, D)).astype(np.float32)
             for _ in range(4)]
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in draws)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in draws)
    want_o, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(
        q, k, v, causal=causal, dtype=jdt, block_q=bq, block_k=bk,
        interpret=True), jq, jk, jv)
    want = vjp(jdo)
    assert set(seen) == rows and len(seen) == len(rows)

    o, lse = tfa.flash_attention_fwd(tq, tk, tv, causal=causal)
    plain = tfa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=causal)
    qkv = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = tfa.flash_attention(*qkv, causal=causal, dtype=tdt)
    autograd = torch.autograd.grad(out, qkv, tdo)
    assert torch.equal(out.detach(), o)
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(o), _np(want_o), atol=tol, rtol=tol,
                               err_msg="o")
    for name, a, b, w in zip(("dq", "dk", "dv"), plain, autograd, want):
        assert a.dtype == tdt and a.shape == (B, T, H, D)
        assert torch.equal(a, b), name
        np.testing.assert_allclose(_np(a), _np(w), atol=gtol, rtol=gtol,
                                   err_msg=name)


def test_tpu_rows_rejects_a_nonpositive_length():
    """``tpu_rows`` names no route for T < 1."""
    with pytest.raises(ValueError, match="positive"):
        tfa.tpu_rows(0, 2, 32, True)


# -- (b) the gates --------------------------------------------------------------

#: (T, H, D): packable and folding heads, powers of two and not
SHAPES = [(64, 2, 32), (64, 4, 32), (64, 2, 64), (200, 12, 64),
          (512, 12, 64), (1024, 25, 64), (1024, 2, 32), (1536, 12, 64),
          (2048, 25, 64), (2048, 32, 64), (2048, 2, 32), (4096, 12, 64),
          (16384, 12, 64), (256, 3, 128), (384, 2, 256), (96, 3, 48)]
#: (block_q, block_k, env): defaults, arguments (incl. ones that do not
#: divide T), the env overrides
BLOCKS = [(None, None, {}), (128, 128, {}), (64, 32, {}), (96, 96, {}),
          (None, None, {"RLT_FLASH_BLOCK_Q": "128",
                        "RLT_FLASH_BLOCK_K": "128"}),
          (None, None, {"RLT_FLASH_TRI": "0"}),
          (None, None, {"RLT_FLASH_ROWRES": "0"}),
          (256, 256, {"RLT_FLASH_ROWRES": "0"})]


@pytest.mark.parametrize("T,H,D", SHAPES)
def test_tpu_rows_match_jax_dispatch(T, H, D, monkeypatch):
    """For each shape, block choice and override, causal and not: the
    rows ``tpu_rows`` names are the kernels the JAX ``flash_attention``
    dispatches (forward, then backward, in that order)."""
    seen = _spy(monkeypatch, run=False)
    x = jax.ShapeDtypeStruct((1, T, H, D), jnp.bfloat16)
    for bq, bk, env in BLOCKS:
        for name in ENV:
            monkeypatch.delenv(name, raising=False)
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        for causal in (True, False):
            seen.clear()

            def fwd_bwd(q, k, v, do):
                o, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(
                    q, k, v, causal=causal, block_q=bq, block_k=bk,
                    interpret=True), q, k, v)
                return vjp(do)

            jax.eval_shape(fwd_bwd, x, x, x, x)
            fwd_row, bwd_rows = tfa.tpu_rows(T, H, D, causal, bq, bk)
            assert seen == [fwd_row, *bwd_rows], (T, H, D, bq, bk, env,
                                                  causal)
