"""PyTorch/CUDA port, ring attention on a ``sequence`` axis
(parallel/ring.py) against the JAX package's (``ray_lightning_tpu/
parallel/ring.py``) on numpy-seeded inputs:

- ``_block_update`` and ``blockwise_attention`` at fp32 2e-5;
- ``ring_attention`` over a gloo group of 2 and 4 CPU processes, causal
  and not, each rank holding its slice of the sequence, joined against
  JAX's ``ring_attention`` on as many virtual devices at 2e-5 (JAX's
  bar, ``tests/test_ring_attention.py``), and on a (sequence=2,
  tensor=2) mesh with each rank's heads;
- dq, dk and dv of ``sum(sin(o))`` at JAX's own 5e-5;
- a tiny GPT fit with ``attention_impl="ring"`` over ``RaySpmdPlugin``
  on (data=1, sequence=4) against the JAX ``SpmdStrategy`` fit at the
  strategy bar (rtol 2e-4, atol 1e-5, tests/test_torch_sharded.py);
  sequence=2 at dropout 0.1 equals sequence=1 (the masks are the whole
  sequence's, drawn whole and sliced);
- no fallback: on a sequence mesh an attention other than ``"ring"``
  raises, and a sequence group runs the ring, never blockwise.

The op-level cases of one group size run in one spawn of gloo processes
(tests/torch_gloo.py); the JAX side runs on the conftest's virtual
devices.  No JAX at this module's top: the processes import it.
"""

import numpy as np
import pytest
import torch

from test_torch_sharded import (ATOL, RTOL, STEPS, TINY, _close, _fit,
                                _jax_fit, _one_torch_thread, _plugin,
                                _seeded_gpt_params, _tiny_gpt, fp32,
                                gpt_state)
from torch_gloo import run_gloo

from ray_lightning_tpu_torch.parallel.strategy import SpmdStrategy

__all__ = ["_one_torch_thread", "fp32", "gpt_state"]   # fixtures, reused

B, T, H, D = 2, 64, 2, 16
TOL, GRAD_TOL = 2e-5, 5e-5


def _qkv(b=B, t=T, h=H, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, D)).astype(np.float32)
            for _ in range(3)]


def _ring_rank(rank, world, sizes, cases):
    """One rank of the ring: per case (causal), this rank's output slice
    and its slices of dq, dk, dv of ``sum(sin(o))``."""
    from ray_lightning_tpu_torch.parallel.mesh import build_device_mesh
    from ray_lightning_tpu_torch.parallel.ring import ring_attention
    names = tuple(sizes)
    mesh = build_device_mesh(names, sizes)
    n, i = mesh.shape["sequence"], mesh.coords["sequence"]
    tp = mesh.shape.get("tensor", 1)
    j = mesh.coords.get("tensor", 0)
    out = {}
    for causal, (q, k, v) in cases:
        t, h = q.shape[1] // n, q.shape[2] // tp
        xs = [torch.from_numpy(a[:, i * t:(i + 1) * t, j * h:(j + 1) * h]
                               ).clone().requires_grad_() for a in (q, k, v)]
        o = ring_attention(*xs, causal=causal, dtype=torch.float32,
                           mesh=mesh)
        torch.sin(o).sum().backward()
        out[causal] = [o.detach().numpy()] + [x.grad.numpy() for x in xs]
    return out


def _joined(parts, ring, tp=1):
    """The ranks' slices (row-major over sequence, tensor) joined into
    the whole [B, T, H, D]."""
    rows = [np.concatenate(parts[r * tp:(r + 1) * tp], axis=2)
            for r in range(ring)]
    return np.concatenate(rows, axis=1)


def _jax_ring(ring, q, k, v, causal, sizes=None):
    import jax
    import jax.numpy as jnp
    from ray_lightning_tpu.parallel.mesh import build_device_mesh
    from ray_lightning_tpu.parallel.ring import ring_attention
    sizes = sizes or {"data": 1, "sequence": ring}
    n = int(np.prod(list(sizes.values())))
    mesh = build_device_mesh(tuple(sizes), sizes, devices=jax.devices()[:n])

    def loss(q, k, v):
        o = ring_attention(q, k, v, causal=causal, dtype=jnp.float32,
                           mesh=mesh)
        return jnp.sum(jnp.sin(o)), o

    (_, o), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(o)] + [np.asarray(g) for g in grads]


@pytest.fixture(scope="module", params=[2, 4], ids=["ring2", "ring4"])
def ring_runs(request):
    ring = request.param
    cases = [(causal, _qkv(seed=int(causal))) for causal in (True, False)]
    got = run_gloo(_ring_rank, ring, {"data": 1, "sequence": ring}, cases)
    want = {causal: _jax_ring(ring, *qkv, causal) for causal, qkv in cases}
    return ring, cases, got, want


def test_block_update_matches_jax():
    """One block folded into random accumulators, causal at offsets that
    mask part of it, against the JAX function."""
    from ray_lightning_tpu.parallel.ring import _block_update as jblock
    from ray_lightning_tpu_torch.parallel.ring import _block_update
    rng = np.random.default_rng(1)
    q, k, v = _qkv(t=16)
    m = rng.standard_normal((B, H, 16, 1)).astype(np.float32)
    l = rng.random((B, H, 16, 1)).astype(np.float32) + 0.5
    acc = rng.standard_normal((B, 16, H, D)).astype(np.float32)
    for causal, q_off, k_off in ((True, 16, 8), (True, 0, 0),
                                 (False, 0, 32)):
        want = jblock((m, l, acc), q, k, v, q_off, k_off, causal, 0.25)
        got = _block_update(tuple(map(torch.from_numpy, (m, l, acc))),
                            *map(torch.from_numpy, (q, k, v)), q_off,
                            k_off, causal, 0.25)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                       atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_matches_jax(causal):
    from ray_lightning_tpu.parallel.ring import blockwise_attention as jbw
    from ray_lightning_tpu_torch.parallel.ring import blockwise_attention
    import jax.numpy as jnp
    q, k, v = _qkv()
    want = jbw(q, k, v, causal=causal, dtype=jnp.float32, block_size=16)
    got = blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, dtype=torch.float32,
                              block_size=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_jax(ring_runs, causal):
    """Each rank's output slice, joined, against JAX's ring on as many
    devices."""
    ring, _, got, want = ring_runs
    out = _joined([g[causal][0] for g in got], ring)
    np.testing.assert_allclose(out, want[causal][0], rtol=TOL, atol=TOL)


def test_ring_grads_match_jax(ring_runs):
    """dq, dk, dv (each rank's slice, the dK/dV accumulators home after
    the ring) at JAX's 5e-5, causal and not."""
    ring, cases, got, want = ring_runs
    for causal, _ in cases:
        for n, name in ((1, "dq"), (2, "dk"), (3, "dv")):
            np.testing.assert_allclose(
                _joined([g[causal][n] for g in got], ring), want[causal][n],
                rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=f"{name} {causal}")


def test_ring_with_tensor_axis_matches_jax():
    """(sequence=2, tensor=2) over four processes, each rank its slice of
    the sequence and its heads, against JAX's ring on that mesh."""
    sizes = {"data": 1, "sequence": 2, "tensor": 2}
    q, k, v = _qkv(h=4, seed=3)
    got = run_gloo(_ring_rank, 4, sizes, [(True, (q, k, v))])
    want = _jax_ring(2, q, k, v, True, sizes)
    for n in range(4):
        np.testing.assert_allclose(
            _joined([g[True][n] for g in got], 2, tp=2), want[n],
            rtol=GRAD_TOL, atol=GRAD_TOL)


def _seq_strategy(n):
    return SpmdStrategy(axis_names=("data", "sequence"),
                        axis_sizes={"sequence": n})


def test_gpt_sequence_fit_matches_jax(gpt_state, tmp_path, fp32):
    """The tiny GPT with ``attention_impl="ring"`` on (data=1,
    sequence=4) workers, batch 4: each rank its quarter of every
    sequence (inputs and targets), positions from rank x 16, the loss
    averaged over the ranks, the gradients over data x sequence; against
    the JAX ``SpmdStrategy`` fit on four devices."""
    from ray_lightning_tpu.models.gpt import GPTLightningModule as JaxModule
    from ray_lightning_tpu.parallel.strategy import SpmdStrategy as JaxSpmd
    from ray_lightning_tpu_torch.convert import torch_to_flax
    got = _fit(_plugin(4, _seq_strategy(4)),
               _tiny_gpt(gpt_state, 4, attention_impl="ring"), tmp_path)
    assert len(got[0]) == STEPS
    jcfg, params = _seeded_gpt_params()
    params = torch_to_flax(gpt_state, params)
    import dataclasses

    class JaxFixed(JaxModule):
        def init_params(self, rng, batch):
            import jax
            import jax.numpy as jnp
            return {"params": jax.tree_util.tree_map(jnp.asarray, params)}

    jl, jw = _jax_fit(JaxFixed(config=dataclasses.replace(
        jcfg, attention_impl="ring"), lr=3e-3, warmup_steps=2,
        batch_size=4, dataset_size=32),
        JaxSpmd(axis_names=("data", "sequence"),
                axis_sizes={"sequence": 4}), 4, tmp_path)
    np.testing.assert_allclose(got[0], jl, rtol=RTOL, atol=ATOL)
    _close(got[1], jw, TINY["n_embd"])


def test_sequence_dropout_equals_unsharded(gpt_state, tmp_path, fp32):
    """Dropout 0.1 with ring attention: sequence=2 over two workers
    against one process (ring of one: blockwise), the masks the whole
    sequence's on both."""
    one = _fit("cpu", _tiny_gpt(gpt_state, 4, dropout=0.1,
                                attention_impl="ring"), tmp_path)
    two = _fit(_plugin(2, _seq_strategy(2)),
               _tiny_gpt(gpt_state, 4, dropout=0.1, attention_impl="ring"),
               tmp_path)
    plain = _fit("cpu", _tiny_gpt(gpt_state, 4, attention_impl="ring"),
                 tmp_path)
    assert one[0] != plain[0]
    np.testing.assert_allclose(two[0], one[0], rtol=RTOL, atol=ATOL)
    _close(two[1], one[1], TINY["n_embd"])


def _sequence_model(world, **cfg):
    """The tiny GPT (fp32) cut for a (data=1, sequence=world) mesh of
    the process group, as the trainer cuts it (its modules take their
    sequence group from the layout)."""
    from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig
    from ray_lightning_tpu_torch.parallel.layout import ShardLayout
    from ray_lightning_tpu_torch.parallel.mesh import build_device_mesh
    strategy = _seq_strategy(world)
    mesh = build_device_mesh(strategy.axis_names,
                             strategy.axis_sizes(world))
    model = GPT(GPTConfig(**{**TINY, "dtype": torch.float32, **cfg}), "cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    ShardLayout.of_model(model, strategy, mesh).apply(model)
    return model


def _no_fallback_rank(rank, world):
    """On a sequence=2 mesh: "auto" raises in the attention; "ring" runs
    the ring's exchanges (counted), never blockwise."""
    from ray_lightning_tpu_torch.parallel import ring
    idx = torch.zeros(2, 32, dtype=torch.int64)
    raised = False
    try:
        _sequence_model(world, attention_impl="auto")(idx)
    except ValueError as e:
        raised = "attention_impl='ring'" in str(e)
    calls = {"ring": 0, "blockwise": 0}
    orig_p, orig_b = ring.ppermute, ring.blockwise_attention

    def counted_p(*a, **k):
        calls["ring"] += 1
        return orig_p(*a, **k)

    def counted_b(*a, **k):
        calls["blockwise"] += 1
        return orig_b(*a, **k)

    ring.ppermute, ring.blockwise_attention = counted_p, counted_b
    try:
        _sequence_model(world, attention_impl="ring")(idx).sum().backward()
    finally:
        ring.ppermute, ring.blockwise_attention = orig_p, orig_b
    return raised, calls


def test_sequence_mesh_has_no_fallback():
    for raised, calls in run_gloo(_no_fallback_rank, 2):
        assert raised
        # per layer: one hop forward, one in the backward and one home
        assert calls == {"ring": 3 * TINY["n_layer"], "blockwise": 0}


def test_predict_on_a_sequence_mesh(gpt_state, tmp_path, fp32):
    """``predict`` over (data=1, sequence=2) workers: each rank's slice of
    the tokens joined, equal to the one-process ring's (blockwise)."""
    from ray_lightning_tpu_torch import Trainer
    preds = []
    for where in (dict(device="cpu"),
                  dict(plugins=[_plugin(2, _seq_strategy(2))])):
        trainer = Trainer(enable_checkpointing=False, logger=False,
                          default_root_dir=str(tmp_path),
                          limit_predict_batches=2, **where)
        preds.append(trainer.predict(
            _tiny_gpt(gpt_state, 4, attention_impl="ring")))
    assert len(preds[1]) == 2
    for got, want in zip(preds[1], preds[0]):
        assert got.shape == (4, TINY["block_size"])
        assert torch.equal(got, want)


def _remat_rank(rank, world):
    """The tiny ring GPT's gradients on a sequence=2 mesh with each block
    under the "full" remat policy and without, the backward (and so the
    recompute, ring exchanges included) on another thread, as the
    autograd engine's device threads run it; and the ring's hops of the
    remat run, none of them blockwise."""
    import threading
    from ray_lightning_tpu_torch.parallel import ring
    idx = torch.from_numpy(np.random.default_rng(rank).integers(
        0, TINY["vocab_size"], (2, 32)))
    grads, calls = [], {"ring": 0, "blockwise": 0}
    orig_p, orig_b = ring.ppermute, ring.blockwise_attention

    def counted_p(*a, **k):
        calls["ring"] += 1
        return orig_p(*a, **k)

    def counted_b(*a, **k):
        calls["blockwise"] += 1
        return orig_b(*a, **k)

    for remat in (False, True):
        model = _sequence_model(world, attention_impl="ring", remat=remat)
        if remat:
            ring.ppermute, ring.blockwise_attention = counted_p, counted_b
        try:
            loss = (model(idx) ** 2).mean()
            t = threading.Thread(target=loss.backward)
            t.start()
            t.join()
        finally:
            ring.ppermute, ring.blockwise_attention = orig_p, orig_b
        grads.append({k: p.grad.clone() for k, p in
                      model.named_parameters()})
    same = all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0])
    return same, calls


def test_ring_under_remat_recomputes_alike():
    """"full" remat re-runs the ring's exchanges in the backward, in the
    same order on every rank, on the backward's thread: the gradients
    equal those without remat bit for bit, and each layer hops once
    forward, once in the recompute, once in the backward and once
    home."""
    for same, calls in run_gloo(_remat_rank, 2):
        assert same
        assert calls == {"ring": 4 * TINY["n_layer"], "blockwise": 0}
