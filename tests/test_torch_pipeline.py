"""PyTorch/CUDA port, GPipe pipeline parallelism on a ``stage`` axis
(parallel/pipeline.py, models/pipeline_gpt.py) against the JAX package's
(``ray_lightning_tpu/parallel/pipeline.py``, ``models/pipeline_gpt.py``)
on numpy-seeded inputs and converted weights:

- ``pipeline_forward`` of a toy layer stack at (stages, microbatches) =
  (2, 2), (4, 4) and (2, 4) over gloo CPU processes against JAX's on as
  many virtual devices, and its gradients on (data=2, stage=2) at JAX's
  5e-4 / 5e-5 (``tests/test_pipeline.py``);
- without a stage axis a plain loop; the ``ValueError``s for layers that
  do not divide over the stages ("divide") and microbatches that do not
  divide the batch ("microbatches"), for dropout and MoE configs;
  ``"auto"`` attention becomes ``"local"``; remat gives the same
  gradients;
- ``PipelineStrategy``'s specs equal JAX's, as tuples, for every
  parameter of gpt2-small's ``PipelinedGPT`` (abstract shapes);
- a tiny ``PipelinedGPT`` fit on (data=2, stage=2) workers against the
  JAX fit at the strategy bar (rtol 2e-4, atol 1e-5); ``predict`` on the
  stage mesh returns the one-process tokens in dataset order; the JAX
  stacked weights round-trip through the port's.

The op-level cases of one group size run in one spawn of gloo processes
(tests/torch_gloo.py).  No JAX at this module's top: the processes
import it.
"""

import numpy as np
import pytest
import torch

from test_torch_sharded import (ATOL, RTOL, STEPS, _close, _fit, _jax_fit,
                                _one_torch_thread, _plugin)
from torch_gloo import run_gloo

from ray_lightning_tpu_torch.models.gpt import GPTConfig
from ray_lightning_tpu_torch.models.pipeline_gpt import PipelinedGPT
from ray_lightning_tpu_torch.parallel.pipeline import (PipelineStrategy,
                                                       pipeline_forward)

__all__ = ["_one_torch_thread"]   # the fixture, reused

PIPE_TINY = dict(vocab_size=512, block_size=64, n_layer=2, n_head=2,
                 n_embd=64, remat=False, attention_impl="dot")
LR = 3e-3


def _toy_stack(n_layers, width, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((n_layers, width, width)) * 0.3
                  ).astype(np.float32),
            "b": (rng.standard_normal((n_layers, width)) * 0.1
                  ).astype(np.float32)}


def _toy_x(rows, width, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (rows, width)).astype(np.float32)


def _toy_stage_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _pipe_rank(rank, world, cases):
    """Per case ``(data, stages, micro, layers, grads)``: this rank's
    output (of its data shard's rows) and, with ``grads``, its stage's
    slices of d(sum out^2)/d params; or the error a bad case raises."""
    from ray_lightning_tpu_torch.parallel.mesh import build_device_mesh
    out = []
    for data, stages, micro, layers, grads in cases:
        mesh = build_device_mesh(("data", "stage"),
                                 {"data": data, "stage": stages})
        params = {k: torch.from_numpy(v).requires_grad_()
                  for k, v in _toy_stack(layers, 8 if grads else 16
                                         ).items()}
        x = torch.from_numpy(_toy_x(8, 8 if grads else 16))
        b = x.shape[0] // data
        i = mesh.coords["data"]
        try:
            y = pipeline_forward(_toy_stage_fn, params, x[i * b:(i + 1) * b],
                                 n_microbatches=micro, mesh=mesh)
        except ValueError as e:
            out.append(str(e))
            continue
        res = {"out": y.detach().numpy()}
        if grads:
            (y ** 2).sum().backward()
            n, s = layers // stages, mesh.coords["stage"]
            res.update({k: p.grad[s * n:(s + 1) * n].numpy()
                        for k, p in params.items()})
        out.append(res)
    return out


def _jax_pipeline(data, stages, micro, layers, grads):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from ray_lightning_tpu.parallel.pipeline import pipeline_forward as jpf
    width = 8 if grads else 16
    params = {k: jnp.asarray(v) for k, v in _toy_stack(layers, width).items()}
    x = jnp.asarray(_toy_x(8, width))
    mesh = Mesh(np.array(jax.devices()[:data * stages]).reshape(
        data, stages), ("data", "stage"))

    def stage_fn(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def loss(p):
        y = jpf(stage_fn, p, x, n_microbatches=micro, mesh=mesh)
        return jnp.sum(y ** 2), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(y), {k: np.asarray(v) for k, v in g.items()}


#: (data, stages, microbatches, layers, grads) by group size
CASES = {2: [(1, 2, 2, 8, False), (1, 2, 4, 8, False),
             (1, 2, 2, 3, False), (1, 2, 3, 8, False)],
         4: [(1, 4, 4, 8, False), (2, 2, 2, 4, True)]}


@pytest.fixture(scope="module")
def pipe_runs():
    return {w: run_gloo(_pipe_rank, w, cases) for w, cases in CASES.items()}


@pytest.mark.parametrize("world,case", [(2, 0), (4, 0), (2, 1)],
                         ids=["stages2_micro2", "stages4_micro4",
                              "stages2_micro4"])
def test_pipeline_matches_jax(pipe_runs, world, case):
    """Every stage holds the last stage's outputs (the broadcast): each
    equals JAX's at 2e-5."""
    want, _ = _jax_pipeline(*CASES[world][case])
    for r in pipe_runs[world]:
        np.testing.assert_allclose(r[case]["out"], want, rtol=2e-5,
                                   atol=2e-5)


def test_pipeline_gradients_match_jax(pipe_runs):
    """(data=2, stage=2), two microbatches a data shard: each stage's
    layers' gradients, summed over the data shards, against JAX's
    gradient of the global sum at 5e-4 / 5e-5."""
    case = CASES[4][1]
    _, want = _jax_pipeline(*case)
    got = pipe_runs[4]
    for k in want:
        # rank = data * 2 + stage (stage innermost)
        stages = [got[s][1][k] + got[2 + s][1][k] for s in range(2)]
        np.testing.assert_allclose(np.concatenate(stages), want[k],
                                   rtol=5e-4, atol=5e-5, err_msg=k)


def test_pipeline_errors(pipe_runs):
    """3 layers over 2 stages, 3 microbatches of a batch of 8: the JAX
    messages' words."""
    for r in pipe_runs[2]:
        assert "divide" in r[2] and "stages" in r[2]
        assert "microbatches" in r[3]


def test_no_stage_axis_is_a_loop():
    params = {k: torch.from_numpy(v) for k, v in _toy_stack(4, 8).items()}
    x = torch.from_numpy(_toy_x(4, 8))
    want = x
    for j in range(4):
        want = _toy_stage_fn({k: v[j] for k, v in params.items()}, want)
    got = pipeline_forward(_toy_stage_fn, params, x, mesh=None)
    assert torch.equal(got, want)


def test_config_errors_and_local_attention():
    with pytest.raises(ValueError, match="dropout"):
        PipelinedGPT(GPTConfig(vocab_size=64, block_size=16, n_layer=2,
                               n_head=2, n_embd=32, dropout=0.1))
    with pytest.raises(ValueError, match="MoE"):
        PipelinedGPT("moe-tiny")
    assert PipelinedGPT("tiny").config.attention_impl == "local"
    cfg = GPTConfig(**{**PIPE_TINY, "attention_impl": "ring"})
    assert PipelinedGPT(cfg).config.attention_impl == "local"
    with pytest.raises(NotImplementedError, match="item 11"):
        PipelinedGPT("tiny").configure_mpmd()
    # the remat probes are ported (tests/test_torch_remat.py)
    from ray_lightning_tpu_torch.core.remat import POLICY_LADDER
    spec = PipelinedGPT("tiny").configure_remat()
    assert spec.policies == POLICY_LADDER and spec.default == "off"


def test_remat_gives_the_same_gradients():
    """``remat=True`` (each layer under the "full" policy) against
    ``remat=False`` on the same weights: the same gradients."""
    grads = []
    idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, 64, (4, 16)))
    for remat in (False, True):
        cfg = GPTConfig(vocab_size=64, block_size=16, n_layer=2, n_head=2,
                        n_embd=32, remat=remat, dtype=torch.float32)
        model = PipelinedGPT(cfg, n_microbatches=2).configure_model("cpu")
        model.init_weights(torch.Generator().manual_seed(0))
        (model(idx) ** 2).sum().backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-4,
                                   atol=1e-5)


def test_specs_equal_the_jax_package():
    """Every parameter of gpt2-small's ``PipelinedGPT`` (abstract shapes
    from ``jax.eval_shape``, the port's on the meta device) under
    ``PipelineStrategy(stages=4)`` and (data=2, stage=2): param, opt and
    batch specs equal as tuples."""
    import jax
    import jax.numpy as jnp
    from ray_lightning_tpu.models.pipeline_gpt import PipelinedGPT as JP
    from ray_lightning_tpu.parallel.pipeline import PipelineStrategy as JPS
    from ray_lightning_tpu.parallel.strategy import _path_str
    from ray_lightning_tpu_torch.convert import flax_path
    from ray_lightning_tpu_torch.parallel.layout import ShardLayout
    from ray_lightning_tpu_torch.parallel.mesh import Mesh
    jmod = JP("gpt2-small", n_microbatches=4)
    x = jnp.zeros((8, 1024), jnp.int32)
    tree = jax.eval_shape(lambda r: jmod.init_params(r, (x, x))["params"],
                          jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    avals = {_path_str(p): a for p, a in flat}
    model = PipelinedGPT("gpt2-small", n_microbatches=4).configure_model(
        "meta")
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    paths = {k: flax_path(k)[0] for k in shapes}
    assert sorted(paths.values()) == sorted(avals)
    for sizes in ({"data": 1, "stage": 4}, {"data": 2, "stage": 2}):
        ours, theirs = PipelineStrategy(sizes["stage"]), JPS(sizes["stage"])
        n = sizes["data"] * sizes["stage"]
        jmesh = theirs.build_mesh(jax.devices()[:n])
        mesh = Mesh.abstract(("data", "stage"), sizes)
        assert dict(jmesh.shape) == mesh.shape
        layout = ShardLayout(shapes, ours, mesh)
        for name, info in layout.params.items():
            aval = avals[paths[name]]
            assert tuple(info.spec) == tuple(theirs.param_spec(
                jmesh, paths[name], aval)), name
            assert tuple(ours.opt_spec(mesh, paths[name], aval.shape)) == \
                tuple(theirs.opt_spec(jmesh, paths[name], aval)), name
            if name.startswith("blocks."):
                assert info.local_shape[0] == 12 // sizes["stage"]
        for ndim in (0, 1, 2):
            assert tuple(ours.batch_spec(mesh, ndim)) == tuple(
                theirs.batch_spec(jmesh, ndim))


class FixedPipelined(PipelinedGPT):
    """The port's ``PipelinedGPT`` from given whole weights."""

    def __init__(self, state, **kw):
        super().__init__(**kw)
        self._state = state

    def init_params(self, generator):
        self.setup_model(generator.device)
        self.model.load_state_dict(self._state)
        return self.model.state_dict()


@pytest.fixture(scope="module")
def jax_pipe_params():
    """The JAX tiny ``PipelinedGPT``'s own init (fp32), as numpy."""
    import jax
    import jax.numpy as jnp
    from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
    from ray_lightning_tpu.models.pipeline_gpt import PipelinedGPT as JP
    jcfg = JaxConfig(**PIPE_TINY, dtype=jnp.float32)
    x = jnp.zeros((2, 64), jnp.int32)
    params = JP(jcfg).init_params(jax.random.PRNGKey(0), (x, x))["params"]
    return jcfg, jax.tree_util.tree_map(np.asarray, params)


def _tiny_pipe(state, batch_size):
    return FixedPipelined(state, config=GPTConfig(**PIPE_TINY,
                                                  dtype=torch.float32),
                          n_microbatches=2, lr=LR, batch_size=batch_size,
                          dataset_size=32)


def test_pipelined_fit_matches_jax(jax_pipe_params, tmp_path):
    """(data=2, stage=2) workers, a batch of 4 a data shard in two
    microbatches, against the JAX ``PipelineStrategy(stages=2)`` fit on
    four devices (global batch 8): losses and whole weights."""
    from ray_lightning_tpu.models.pipeline_gpt import PipelinedGPT as JP
    from ray_lightning_tpu.parallel.pipeline import PipelineStrategy as JPS
    from ray_lightning_tpu_torch.convert import (flax_to_torch,
                                                 unstack_blocks)
    jcfg, params = jax_pipe_params
    got = _fit(_plugin(4, PipelineStrategy(stages=2)),
               _tiny_pipe(flax_to_torch(params), 4), tmp_path)
    assert len(got[0]) == STEPS
    assert {k: tuple(v.shape) for k, v in got[1].items()} == \
        {k: tuple(v.shape) for k, v in flax_to_torch(params).items()}

    class JaxFixed(JP):
        def init_params(self, rng, batch):
            import jax
            import jax.numpy as jnp
            return {"params": jax.tree_util.tree_map(jnp.asarray, params)}

    jl, jw = _jax_fit(JaxFixed(jcfg, n_microbatches=2, lr=LR, batch_size=8,
                               dataset_size=32), JPS(stages=2), 4, tmp_path)
    np.testing.assert_allclose(got[0], jl, rtol=RTOL, atol=ATOL)
    # layer by layer: each layer's qkv bias has its k third apart
    _close(unstack_blocks(got[1]), unstack_blocks(jw), PIPE_TINY["n_embd"])


def test_predict_on_the_stage_mesh(jax_pipe_params, tmp_path):
    """``predict`` over (data=1, stage=2) workers: dataset-order token
    ids equal to the one-process model's."""
    from ray_lightning_tpu_torch import Trainer
    from ray_lightning_tpu_torch.convert import flax_to_torch
    state = flax_to_torch(jax_pipe_params[1])
    preds = []
    for where in (dict(device="cpu"),
                  dict(plugins=[_plugin(2, PipelineStrategy(stages=2))])):
        trainer = Trainer(enable_checkpointing=False, logger=False,
                          default_root_dir=str(tmp_path),
                          limit_predict_batches=2, **where)
        preds.append(trainer.predict(_tiny_pipe(state, 4)))
    assert len(preds[1]) == 2
    for got, want in zip(*preds[::-1]):
        assert got.shape == (4, PIPE_TINY["block_size"])
        assert torch.equal(got, want)


def test_stacked_weights_round_trip(jax_pipe_params):
    """JAX stacked ``blocks/...`` -> the port's stacked tensors (each
    layer's kernel transposed) -> back, equal; per-layer ``h.{i}.``
    names and back, equal; one layer's ``h.1.attn.qkv.weight`` is the
    JAX kernel of layer 1 transposed."""
    from ray_lightning_tpu_torch.convert import (flax_to_torch,
                                                 stack_blocks,
                                                 torch_to_flax,
                                                 unstack_blocks)
    _, params = jax_pipe_params
    state = flax_to_torch(params)
    back = torch_to_flax(state, params)
    import jax
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)))
    layers = unstack_blocks(state)
    assert np.array_equal(layers["h.1.attn.qkv.weight"].numpy(),
                          params["blocks"]["attn"]["qkv"]["kernel"][1].T)
    again = stack_blocks(layers)
    assert set(again) == set(state)
    assert all(torch.equal(again[k], state[k]) for k in state)


def test_flax_to_shards_takes_each_stage_s_layers(jax_pipe_params):
    """``convert.flax_to_shards`` under ``PipelineStrategy(stages=2)``:
    each stage's blocks are its layer of every stacked tensor, the rest
    whole; the two stages' blocks stack back to the whole tensors."""
    from ray_lightning_tpu_torch.convert import flax_to_shards, flax_to_torch
    from ray_lightning_tpu_torch.parallel.layout import ShardLayout
    from ray_lightning_tpu_torch.parallel.mesh import Mesh
    _, params = jax_pipe_params
    full = flax_to_torch(params)
    shapes = {k: tuple(v.shape) for k, v in full.items()}
    parts = [flax_to_shards(params, ShardLayout(
        shapes, PipelineStrategy(stages=2),
        Mesh(("data", "stage"), (1, 2), rank=r))) for r in range(2)]
    for k, whole in full.items():
        if k.startswith("blocks."):
            assert all(p[k].shape[0] == 1 for p in parts), k
            assert torch.equal(torch.cat([p[k] for p in parts]), whole), k
        else:
            assert all(torch.equal(p[k], whole) for p in parts), k
