"""PyTorch/CUDA port, kernel modules: ``ray_lightning_tpu_torch.ops``
against the JAX package on the same numpy-seeded inputs.

- flash forward: the JAX side is the real Pallas ``_fwd_packed_kernel``
  under the interpreter (``interpret=True``), at T=128 (one block) and
  T=512 (the 256-row causal staircase); the port side is the kernel
  wrapper on a CPU tensor, i.e. its plain version.  fp32 within 2e-5,
  bf16 within 2e-2 (the JAX package's own tolerances, tests/test_ops.py).
- decode attention: the JAX side is ``cached_attention(impl="dense")``
  (the Pallas decode kernel does not lower on this jax, so the JAX
  package's own test holds it against the same oracle); the port side is
  both ``flash_decode_attention``'s plain path and ``cached_attention``.
The kernels themselves are held against their plain versions on the
card by tests/test_torch_cuda.py, which imports no JAX.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.ops.attention import (
    cached_attention as jax_cached_attention)
from ray_lightning_tpu.ops.flash_attention import _fwd as jax_flash_fwd
from ray_lightning_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention)
from ray_lightning_tpu_torch.ops import _kernels
from ray_lightning_tpu_torch.ops.attention import (cached_attention,
                                                   dot_product_attention)
from ray_lightning_tpu_torch.ops import flash_attention as fa
from ray_lightning_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_fwd)
from ray_lightning_tpu_torch.ops import flash_decode as fd
from ray_lightning_tpu_torch.ops.flash_decode import (
    decode_split_plan, flash_decode_attention, flash_decode_attention_plain,
    flash_decode_split_plain, resolve_decode_impl)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and torch's default of a thread per core would crowd the
    other workers' time-bounded distributed tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(rng, shape, dtype):
    """One numpy draw as a JAX array and a torch tensor holding the same
    values in ``dtype`` (both round the fp32 draw to nearest even)."""
    jdt, tdt, _ = DTYPES[dtype]
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# -- flash forward -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [128, 512])
def test_flash_forward_matches_jax_pallas_kernel(T, dtype):
    """T=128 takes the packed kernel's single block, T=512 its causal
    staircase; both hold the port within the dtype's tolerance."""
    rng = np.random.default_rng(T)
    shape = (1, T, 4, 64)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, shape, dtype)
                                    for _ in range(3))
    jdt, tdt, tol = DTYPES[dtype]
    want = jax_flash_attention(jq, jk, jv, causal=True, dtype=jdt,
                               interpret=True)
    got = flash_attention(tq, tk, tv, causal=True, dtype=tdt)
    assert got.dtype == tdt and got.shape == shape
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_flash_forward_lse_matches_jax_and_logsumexp():
    """The port's fp32 lse [B, H, T] equals the JAX kernel's (packed
    [B, H/2, T, 2] layout) and the logsumexp of the masked scores."""
    rng = np.random.default_rng(1)
    B, T, H, D = 1, 128, 4, 64
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (B, T, H, D), "float32")
                                    for _ in range(3))
    scale = 1.0 / math.sqrt(D)
    _, jlse = jax_flash_fwd(jq.reshape(B, T, H * D), jk.reshape(B, T, H * D),
                            jv.reshape(B, T, H * D), H, True, scale, T, T,
                            True)
    jlse = np.asarray(jlse).transpose(0, 1, 3, 2).reshape(B, H, T)
    _, lse = flash_attention_fwd(tq, tk, tv, causal=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, T)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=2e-5, rtol=2e-5)
    s = torch.einsum("bqhd,bkhd->bhqk", tq, tk) * scale
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(),
                      float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               atol=2e-5, rtol=2e-5)


def test_flash_forward_strided_views_and_ragged_length():
    """The prefill hands the wrapper split views of the fused qkv
    projection and any bucket length; the plain version agrees with the
    plain attention there, without copies of the inputs."""
    rng = np.random.default_rng(2)
    T, H, D = 13, 2, 16
    qkv = torch.from_numpy(
        rng.standard_normal((1, T, 3 * H * D)).astype(np.float32))
    q, k, v = (x.view(1, T, H, D) for x in qkv.split(H * D, dim=-1))
    assert not q.is_contiguous()
    got = flash_attention(q, k, v, causal=True, dtype=torch.float32)
    want = dot_product_attention(q, k, v, causal=True, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


def test_flash_wrappers_reject_unsupported_head_dims():
    x = torch.zeros(1, 8, 2, 48)
    with pytest.raises(ValueError, match="head_dim 48"):
        flash_attention_fwd(x, x, x)
    q = torch.zeros(2, 1, 2, 48)
    kc = torch.zeros(2, 8, 2, 48)
    with pytest.raises(ValueError, match="head_dim 48"):
        flash_decode_attention(q, kc, kc, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="one"):
        flash_attention_fwd(torch.zeros(1, 8, 2, 16), x, x)


def test_plain_paths_on_cpu_never_count_as_launches():
    """The launch counters count kernel launches only: the plain versions
    a CPU tensor takes leave them alone."""
    before = _kernels.launch_counts()
    x = torch.zeros(1, 8, 2, 16)
    flash_attention_fwd(x, x, x)
    q = torch.zeros(2, 1, 2, 16)
    kc = torch.zeros(2, 8, 2, 16)
    flash_decode_attention(q, kc, kc, torch.zeros(2, dtype=torch.int32))
    assert _kernels.launch_counts() == before
    assert set(before) >= {"flash_fwd", "flash_decode"}


# -- decode attention --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax_dense(dtype):
    """Slot s attends rows <= positions[s]; positions include the first
    and the last row.  Both port paths agree with the JAX dense path."""
    rng = np.random.default_rng(3)
    S, L, H, D = 6, 48, 4, 32
    jq, tq = _pair(rng, (S, 1, H, D), dtype)
    jk, tk = _pair(rng, (S, L, H, D), dtype)
    jv, tv = _pair(rng, (S, L, H, D), dtype)
    pos = np.array([0, L - 1, 5, 17, 31, 40], np.int32)
    jdt, tdt, tol = DTYPES[dtype]
    want = _np(jax_cached_attention(jq, jk, jv, jnp.asarray(pos), dtype=jdt,
                                    impl="dense"))
    tpos = torch.from_numpy(pos)
    plain = flash_decode_attention(tq, tk, tv, tpos)
    assert plain.dtype == tdt and plain.shape == (S, 1, H, D)
    np.testing.assert_allclose(_np(plain), want, atol=tol, rtol=tol)
    for impl in ("dense", "flash_decode"):
        got = cached_attention(tq, tk, tv, tpos, dtype=tdt, impl=impl)
        np.testing.assert_allclose(_np(got), want, atol=tol, rtol=tol,
                                   err_msg=impl)


def test_decode_plain_reads_nothing_past_the_position():
    """Rows past positions[s] (stale padding, a previous tenant's
    leftovers) cannot move the output, even when they are NaN."""
    rng = np.random.default_rng(4)
    S, L, H, D = 3, 20, 2, 16
    q = torch.from_numpy(rng.standard_normal((S, 1, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((S, L, H, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((S, L, H, D)).astype(np.float32))
    pos = torch.tensor([0, 7, L - 1], dtype=torch.int32)
    base = flash_decode_attention_plain(q, k, v, pos)
    k2, v2 = k.clone(), v.clone()
    for s, p in enumerate(pos.tolist()):
        k2[s, p + 1:] = float("nan")
        v2[s, p + 1:] = float("nan")
    got = flash_decode_attention_plain(q, k2, v2, pos)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, base, atol=0, rtol=0)


# -- the decode kernels' split plan ------------------------------------------

@pytest.mark.parametrize("S,H,L", [
    (16, 12, 1024), (4, 12, 1024), (1, 12, 1024), (8, 12, 1000),
    (16, 12, 16384), (1, 1, 100), (2, 2, 30), (64, 25, 2048),
    (256, 12, 1024), (3, 7, 65)])
def test_decode_split_plan_invariants(S, H, L):
    """The plan comes from the shapes and the card's SM count alone (no
    positions among its arguments, the same answer each call); its
    chunk is a whole number of 64-row tiles, at most 16; its splits
    cover L, none of them empty; it gives every SM several blocks
    wherever the cache has the tiles for it: on the H100's 132 SMs and
    on a card of 114."""
    for sms in (132, 114):
        chunk, n = decode_split_plan(S, H, L, sms)
        assert (chunk, n) == decode_split_plan(S, H, L, sms)
        assert chunk % fd.DECODE_TILE == 0
        assert 1 <= chunk // fd.DECODE_TILE <= fd.DECODE_MAX_CHUNK_TILES
        assert (n - 1) * chunk < L <= n * chunk
        tiles = -(-L // fd.DECODE_TILE)
        if tiles >= fd.DECODE_MIN_CHUNK_TILES:
            assert chunk >= fd.DECODE_MIN_CHUNK_TILES * fd.DECODE_TILE
        if (chunk // fd.DECODE_TILE > fd.DECODE_MIN_CHUNK_TILES
                and chunk // fd.DECODE_TILE < fd.DECODE_MAX_CHUNK_TILES):
            # a longer chunk only where the split count already fills
            # the card
            assert S * H * n >= 4 * sms


def test_decode_split_plan_examples():
    """The serve paths' shapes at gpt2-small's 12 heads and L=1024, on
    the H100's 132 SMs; fewer SMs, fewer splits where the chunk can
    grow."""
    assert decode_split_plan(16, 12, 1024, 132) == (192, 6)
    assert decode_split_plan(4, 12, 1024, 132) == (128, 8)
    assert decode_split_plan(1, 12, 1024, 132) == (128, 8)
    assert decode_split_plan(16, 12, 1024, 66) == (384, 3)
    with pytest.raises(ValueError, match="S, H, L, sms"):
        decode_split_plan(0, 12, 1024, 132)
    with pytest.raises(ValueError, match="S, H, L, sms"):
        decode_split_plan(16, 12, 1024, 0)


def test_decode_wrappers_take_a_chunk_of_whole_tiles():
    """The wrappers' chunk is the plan's, a whole number of tiles, never
    the caller's (they take no ``chunk``); the split reference takes a
    chunk as the plan gives it, a positive multiple of the tile, and
    refuses any other; on a CPU tensor the wrappers take the plain
    version."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((2, 1, 2, 16)).astype(
        np.float32))
    kc = torch.from_numpy(rng.standard_normal((2, 100, 2, 16)).astype(
        np.float32))
    pos = torch.tensor([3, 99], dtype=torch.int32)
    for bad in (0, 32, 96):
        with pytest.raises(ValueError, match="multiple of 64"):
            flash_decode_split_plain(q, kc, kc, pos, bad)
    with pytest.raises(TypeError, match="chunk"):
        flash_decode_attention(q, kc, kc, pos, chunk=64)
    torch.testing.assert_close(
        flash_decode_attention(q, kc, kc, pos),
        flash_decode_attention_plain(q, kc, kc, pos), atol=0, rtol=0)
    np.testing.assert_allclose(
        _np(flash_decode_split_plain(q, kc, kc, pos, 64)),
        _np(flash_decode_attention_plain(q, kc, kc, pos)),
        atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("chunk", [None, 64, 128, 192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_plain_matches_plain_across_split_edges(dtype, chunk):
    """The kernels' split-and-merge arithmetic (warp groups of 16 rows,
    running max per group, merges by e^(m_j - M)) against the one-pass
    plain version, positions on each side of the split edges and at
    both ends, L=300 (no multiple of any chunk), every head dim's lane
    layout at D=16 and 64: fp32 within 2e-5, bf16 within 2e-2."""
    rng = np.random.default_rng(7)
    _, tdt, tol = DTYPES[dtype]
    L, H = 300, 3
    c = chunk or decode_split_plan(9, H, L, 132)[0]
    pos = torch.tensor([0, 15, 16, c - 1, c, c + 1, 2 * c, L - 2, L - 1],
                       dtype=torch.int32).clamp(max=L - 1)
    S = len(pos)
    for D in (16, 64):
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(tdt) for shape in ((S, 1, H, D), (S, L, H, D),
                                               (S, L, H, D)))
        got = flash_decode_split_plain(q, k, v, pos, c)
        want = flash_decode_attention_plain(q, k, v, pos)
        assert got.dtype == tdt and got.shape == (S, 1, H, D)
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_split_plain_reads_nothing_past_the_position():
    """As the plain version: NaN rows past positions[s], in the split
    that holds the position and in those past it, leave the output as
    it was."""
    rng = np.random.default_rng(8)
    S, L, H, D = 3, 300, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((S, 1, H, D), (S, L, H, D), (S, L, H, D)))
    pos = torch.tensor([0, 130, L - 1], dtype=torch.int32)
    base = flash_decode_split_plain(q, k, v, pos, 64)
    k2, v2 = k.clone(), v.clone()
    for s, p in enumerate(pos.tolist()):
        k2[s, p + 1:] = float("nan")
        v2[s, p + 1:] = float("nan")
    got = flash_decode_split_plain(q, k2, v2, pos, 64)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, base, atol=0, rtol=0)


def test_resolve_decode_impl(monkeypatch):
    monkeypatch.delenv("RLT_DECODE_IMPL", raising=False)
    assert resolve_decode_impl(None, "cpu") == "dense"
    assert resolve_decode_impl(None, "cuda") == "flash_decode"
    assert resolve_decode_impl("dense", "cuda") == "dense"
    monkeypatch.setenv("RLT_DECODE_IMPL", "flash_decode")
    assert resolve_decode_impl(None, "cpu") == "flash_decode"
    # the paged kernel is ported: an explicit choice on any device
    monkeypatch.setenv("RLT_DECODE_IMPL", "paged")
    assert resolve_decode_impl(None, "cuda") == "paged"
    assert resolve_decode_impl(None, "cpu") == "paged"
    with pytest.raises(ValueError, match="RLT_DECODE_IMPL"):
        resolve_decode_impl("bogus", "cuda")


# -- kernel build keying -----------------------------------------------------

def test_kernel_library_is_keyed_by_its_source(tmp_path, monkeypatch):
    """A changed source builds a new library; an existing library makes
    ``build`` a no-op (so only the first use pays for nvcc)."""
    monkeypatch.setattr(_kernels, "REGISTRY", {})
    monkeypatch.setattr(_kernels, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "csrc").mkdir()
    src = tmp_path / "csrc" / "k.cu"
    src.write_text("// v1\n")
    k = _kernels.Kernel("k", "k.cu", "rlt_k", "p")
    first = k.library_path()
    src.write_text("// v2\n")
    assert k.library_path() != first
    k.library_path().parent.mkdir(parents=True)
    k.library_path().write_bytes(b"")
    assert _kernels.build() == 0.0
    assert _kernels.launch_counts() == {"k": 0}


def test_entry_points_of_one_source_share_one_build(tmp_path, monkeypatch):
    """The slot-contiguous and paged decode kernels live in one source:
    ``build`` runs one compiler for it (two would race on one output),
    and both bind the same library."""
    monkeypatch.setattr(_kernels, "REGISTRY", {})
    monkeypatch.setattr(_kernels, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text("// two entry points\n")
    (tmp_path / "csrc" / "j.cu").write_text("// one\n")
    log = tmp_path / "calls"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    # a stand-in compiler: records each call, writes its -o output
    nvcc.write_text("#!/bin/sh\necho \"$@\" >> " + str(log) + "\n"
                    "while [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then : > \"$2\"; fi; shift\n"
                    "done\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    a = _kernels.Kernel("a", "k.cu", "rlt_a", "p")
    b = _kernels.Kernel("b", "k.cu", "rlt_b", "p")
    c = _kernels.Kernel("c", "j.cu", "rlt_c", "p")
    assert a.library_path() == b.library_path() != c.library_path()
    _kernels.build()
    calls = log.read_text().splitlines()
    assert len(calls) == 2 and sum("k.cu" in x for x in calls) == 1
    assert a.library_path().is_file() and c.library_path().is_file()
    assert a.build_log == b.build_log
    assert _kernels.build() == 0.0


def test_backward_passes_share_the_backward_build(tmp_path, monkeypatch):
    """``flash_bwd``'s per-pass entry points (delta, dk/dv, dq, for timing
    a pass) are entry points of ``flash_bwd.cu`` itself: one library,
    one compiler run for all four, each entry point defined in the
    source with the whole backward's arguments."""
    source = (_kernels.CSRC / "flash_bwd.cu").read_text()
    monkeypatch.setattr(_kernels, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "flash_bwd.cu").write_text(source)
    log = tmp_path / "calls"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\necho \"$@\" >> " + str(log) + "\n"
                    "while [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then : > \"$2\"; fi; shift\n"
                    "done\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    kernels = [fa.BWD_KERNEL, *fa.BWD_PASS_KERNELS.values()]
    assert sorted(fa.BWD_PASS_KERNELS) == ["delta", "dkdv", "dq"]
    assert len({k.library_path() for k in kernels}) == 1
    assert len({k.entry for k in kernels}) == 4
    assert all(k.signature == fa.BWD_KERNEL.signature for k in kernels)
    for k in kernels:
        assert f'extern "C" int {k.entry}(RLT_BWD_PARAMS)' in source
        assert _kernels.REGISTRY[k.name] is k
    _kernels.build(kernels)
    assert len(log.read_text().splitlines()) == 1
    assert len({k.build_log for k in kernels}) == 1


def test_backward_passes_take_cuda_tensors_only():
    """The passes are the kernel's: a CPU tensor (whose backward is the
    plain version, which has none) raises."""
    x = torch.zeros(1, 8, 2, 16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention_bwd_passes(x, x, x, x, lse, x)


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd"])
@pytest.mark.parametrize("B,T,H,ok", [
    (65536, 1, 1, True),            # past grid y's cap: B * H is grid x
    (2 ** 27, 1, 16, False),        # B * H = 2**31
    (2 ** 27 - 1, 1, 16, True),
    (1, 65535 * 128, 1, True),      # 65535 row blocks of 128
    (1, 65535 * 128 + 1, 1, False),
])
def test_grid_check_follows_cuda_limits(kernel, B, T, H, ok):
    """Both kernels run a block per (b * h, 128-row block of T): B * H
    up to 2**31 - 1 (grid x) and T up to 65535 blocks (grid y) pass, and
    one more raises before any launch."""
    if ok:
        fa._check_grid(kernel, B, T, H)
    else:
        with pytest.raises(ValueError, match=f"{kernel} kernel takes"):
            fa._check_grid(kernel, B, T, H)


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    """A kernel that must be built on a machine without nvcc raises (no
    silent fall back to the plain version)."""
    monkeypatch.setattr(_kernels, "REGISTRY", {})
    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    (tmp_path / "k.cu").write_text("// kernel\n")
    k = _kernels.Kernel("k", "k.cu", "rlt_k", "p")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        k.function()
