"""PyTorch/CUDA port, expert parallelism on an ``expert`` axis (ops/moe.py
``MoEMLP`` with its expert group, parallel/layout.py) against the JAX
package's routed layer and ``SpmdStrategy`` on numpy-seeded inputs and
converted weights:

- the ``MoEMLP`` layer at expert=2 (two gloo CPU processes, each with
  two of the four experts) and at (expert=2, tensor=2) (four, each
  expert's FFN Megatron-split): its output, load-balance loss and the
  gradients of ``sum(out * r) + aux`` (input, router, each rank's
  experts) against the JAX layer at fp32 2e-5, so the router's gradient
  is counted once (its combine share summed over the expert group, its
  aux share replicated);
- the specs on (data=2, expert=2, tensor=2) for every parameter of
  moe-tiny and gpt2-moe-8e under ``gpt_partition_rules``, as tuples
  equal to JAX's (abstract shapes, the conftest's virtual devices);
- a moe-tiny fit at (expert=2, tensor=2) over ``RaySpmdPlugin`` against
  the JAX fit on four devices at the strategy bar (rtol 2e-4, atol
  1e-5), ``moe_aux`` included;
- a rule set that splits anything but the routed layers' experts on
  ``expert`` raises at set-up.

No JAX at this module's top: the gloo processes import it.
"""

import functools

import numpy as np
import pytest
import torch

from test_torch_sharded import (ATOL, RTOL, STEPS, TINY, _close,
                                _jax_shapes, _one_torch_thread, _plugin,
                                fp32)
from torch_gloo import run_gloo

from ray_lightning_tpu_torch import (Callback, GPTLightningModule, Trainer,
                                     session)
from ray_lightning_tpu_torch.models.gpt import GPTConfig, gpt_partition_rules
from ray_lightning_tpu_torch.parallel.layout import ShardLayout
from ray_lightning_tpu_torch.parallel.mesh import Mesh
from ray_lightning_tpu_torch.parallel.strategy import SpmdStrategy

__all__ = ["_one_torch_thread", "fp32"]   # fixtures, reused

M, E, FF, TOL = 64, 4, 256, 2e-5
NAMES = ("data", "expert", "tensor")
MOE_TINY = dict(TINY, n_experts=4)
LR = 3e-3
RELAYED: list = []


def _layer_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"router": (rng.standard_normal((M, E)) * 0.5).astype(np.float32),
            "w1": (rng.standard_normal((E, M, FF)) * 0.1).astype(np.float32),
            "w2": (rng.standard_normal((E, FF, M)) * 0.1).astype(np.float32)}


def _inputs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, M)).astype(np.float32)
    return x, rng.standard_normal(x.shape).astype(np.float32)


def _moe_rank(rank, world, sizes, params, x, r):
    """This rank's layer (its experts, its tensor slice of each): output,
    aux and the gradients (input, router, its w1 / w2 blocks)."""
    from torch import nn
    from ray_lightning_tpu_torch.ops.moe import MoEMLP
    from ray_lightning_tpu_torch.parallel.mesh import (axis_group,
                                                       build_device_mesh)
    mesh = build_device_mesh(NAMES, sizes)
    ep, tp = axis_group("expert", mesh), axis_group("tensor", mesh)
    n, lo = E // ep.size, ep.rank * (E // ep.size)
    w1, w2 = params["w1"][lo:lo + n], params["w2"][lo:lo + n]
    if tp is not None:
        f = FF // tp.size
        w1 = w1[:, :, tp.rank * f:(tp.rank + 1) * f]
        w2 = w2[:, tp.rank * f:(tp.rank + 1) * f]
    layer = MoEMLP(M, E, FF, 2, 1.25, torch.float32)
    layer.router = nn.Parameter(torch.from_numpy(params["router"]))
    layer.w1 = nn.Parameter(torch.from_numpy(np.ascontiguousarray(w1)))
    layer.w2 = nn.Parameter(torch.from_numpy(np.ascontiguousarray(w2)))
    layer.ep, layer.tp = ep, tp
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = layer(tx)
    loss = (out * torch.from_numpy(r)).sum() + aux
    grads = torch.autograd.grad(loss, [tx, layer.router, layer.w1,
                                       layer.w2])
    return ([out.detach().numpy(), float(aux)]
            + [g.numpy() for g in grads])


def _jax_layer(params, x, r):
    import jax
    import jax.numpy as jnp
    from ray_lightning_tpu.ops.moe import MoEMLP as JaxMoE
    from ray_lightning_tpu.ops.moe import total_aux_loss
    layer = JaxMoE(n_experts=E, d_ff=FF, top_k=2, capacity_factor=1.25,
                   dtype=jnp.float32)

    def loss(p, xx):
        out, state = layer.apply({"params": p}, xx, mutable=["losses"])
        aux = total_aux_loss(state)
        return jnp.sum(out * r) + aux, (out, aux)

    (_, (out, aux)), (g, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    return np.asarray(out), float(aux), np.asarray(gx), {
        k: np.asarray(v) for k, v in g.items()}


@pytest.fixture(scope="module")
def jax_layer():
    return _jax_layer(_layer_params(), *_inputs())


@pytest.mark.parametrize("sizes", [{"data": 1, "expert": 2, "tensor": 1},
                                   {"data": 1, "expert": 2, "tensor": 2}],
                         ids=["expert2", "expert2_tensor2"])
def test_moe_layer_matches_jax(sizes, jax_layer):
    params = _layer_params()
    x, r = _inputs()
    world = sizes["expert"] * sizes["tensor"]
    got = run_gloo(_moe_rank, world, sizes, params, x, r)
    out, aux, gx, g = jax_layer
    tp = sizes["tensor"]
    n, f = E // sizes["expert"], FF // tp
    for rank, (o, a, dx, drouter, dw1, dw2) in enumerate(got):
        e, t = divmod(rank, tp)
        np.testing.assert_allclose(o, out, rtol=TOL, atol=TOL)
        assert abs(a - aux) <= TOL * max(1.0, abs(aux))
        np.testing.assert_allclose(dx, gx, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(drouter, g["router"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(
            dw1, g["w1"][e * n:(e + 1) * n, :, t * f:(t + 1) * f],
            rtol=TOL, atol=TOL)
        np.testing.assert_allclose(
            dw2, g["w2"][e * n:(e + 1) * n, t * f:(t + 1) * f],
            rtol=TOL, atol=TOL)


@pytest.mark.parametrize("model", ["moe-tiny", "gpt2-moe-8e"])
def test_specs_on_an_expert_mesh_equal_jax(model):
    """(data=2, expert=2, tensor=2) and (data=1, expert=4, tensor=2):
    param, opt and batch specs as tuples equal to the JAX
    ``SpmdStrategy``'s under the rule sets; each rank holds E / expert
    experts."""
    import jax
    from ray_lightning_tpu.models.gpt import gpt_partition_rules as jgr
    from ray_lightning_tpu.parallel import strategy as js
    from ray_lightning_tpu_torch.convert import flax_path
    avals, tmodel = _jax_shapes(model)
    shapes = {k: tuple(p.shape) for k, p in tmodel.named_parameters()}
    paths = {k: flax_path(k)[0] for k in shapes}
    n_experts = tmodel.config.n_experts
    for sizes in ({"data": 2, "expert": 2, "tensor": 2},
                  {"data": 1, "expert": 4, "tensor": 2}):
        ours = SpmdStrategy(gpt_partition_rules(), NAMES, sizes)
        theirs = js.SpmdStrategy(jgr(), NAMES, sizes)
        jmesh = theirs.build_mesh(jax.devices()[:8])
        mesh = Mesh.abstract(NAMES, sizes)
        layout = ShardLayout(shapes, ours, mesh)
        layout.check_local_plan(tmodel)
        for name, info in layout.params.items():
            aval = avals[paths[name]]
            assert tuple(info.spec) == tuple(theirs.param_spec(
                jmesh, paths[name], aval)), (name, sizes)
            assert tuple(ours.opt_spec(mesh, paths[name], aval.shape)) == \
                tuple(theirs.opt_spec(jmesh, paths[name], aval)), name
            if name.endswith(("moe.w1", "moe.w2")):
                assert info.local_shape[0] == n_experts // sizes["expert"]
        for ndim in (0, 1, 2):
            assert tuple(ours.batch_spec(mesh, ndim)) == tuple(
                theirs.batch_spec(jmesh, ndim))


def test_rules_the_routed_layers_cannot_honour_raise():
    """The router, a LayerNorm or ``w1`` along another dim split on
    ``expert``: refused at set-up."""
    model = GPTLightningModule(GPTConfig(**MOE_TINY)).configure_model("meta")
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    mesh = Mesh.abstract(NAMES, {"data": 1, "expert": 2, "tensor": 1})
    for rule in (("moe/router$", (None, "expert")),
                 ("ln1/scale", ("expert",)),
                 ("moe/w1$", (None, None, "expert"))):
        layout = ShardLayout(shapes, SpmdStrategy(
            [rule] + gpt_partition_rules(), NAMES, {"expert": 2}), mesh)
        with pytest.raises(ValueError, match="expert"):
            layout.check_local_plan(model)


def _record(rank, item):
    RELAYED.append((rank, item))


class LossAndAux(Callback):
    """Each step's loss and ``moe_aux`` (rank 0's; every rank holds the
    same), relayed from a worker."""

    def on_fit_start(self, trainer, module):
        self.seen = []

    def on_train_batch_end(self, trainer, module, outputs, batch, i):
        self.seen.append((float(outputs["loss"]), float(outputs["moe_aux"])))

    def on_fit_end(self, trainer, module):
        if trainer.plugin.remote and trainer.global_rank == 0:
            session.put_queue(functools.partial(_record, 0, self.seen))


class FixedMoE(GPTLightningModule):
    def __init__(self, state, **kw):
        super().__init__(**kw)
        self._state = state

    def init_params(self, generator):
        self.setup_model(generator.device)
        self.model.load_state_dict(self._state)
        return self.model.state_dict()


def _seeded_moe_params():
    import jax
    import jax.numpy as jnp
    from ray_lightning_tpu.models.gpt import GPT as JaxGPT
    from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
    jcfg = JaxConfig(**MOE_TINY, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: JaxGPT(jcfg).init(
        k, jnp.zeros((1, 8), jnp.int32))["params"], jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jcfg, jax.tree_util.tree_map_with_path(
        lambda p, x: (np.full(x.shape, p[-1].key == "scale", np.float32)
                      if p[-1].key in ("scale", "bias") else
                      (rng.standard_normal(x.shape) * (
                          0.5 if p[-1].key == "router" else 0.02)).astype(
                          np.float32)), shapes)


def _jax_fit_with_aux(jmodule, strategy, n, tmp_path):
    import jax
    from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
    from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
    from ray_lightning_tpu.plugins import LocalPlugin
    from ray_lightning_tpu_torch.convert import flax_to_torch
    seen = []

    class Rec(JaxCallback):
        def on_train_batch_end(self, trainer, module, outputs, batch, i):
            seen.append((float(outputs["loss"]), float(outputs["moe_aux"])))

    JaxTrainer(plugins=[LocalPlugin(strategy, devices=jax.devices()[:n])],
               callbacks=[Rec()], logger=False, max_steps=STEPS,
               max_epochs=2, limit_val_batches=1, num_sanity_val_steps=0,
               seed=0, enable_checkpointing=False,
               default_root_dir=str(tmp_path)).fit(jmodule)
    return seen, flax_to_torch(jax.device_get(
        jmodule._trained_variables["params"]))


def test_moe_fit_on_an_expert_mesh_matches_jax(tmp_path, fp32):
    """moe-tiny (fp32) at (expert=2, tensor=2) over four workers, batch 4
    (every rank the same rows), against the JAX ``SpmdStrategy`` fit on
    four devices: losses, ``moe_aux`` and whole weights."""
    from ray_lightning_tpu.models.gpt import GPTLightningModule as JaxModule
    from ray_lightning_tpu.models.gpt import gpt_partition_rules as jgr
    from ray_lightning_tpu.parallel.strategy import SpmdStrategy as JaxSpmd
    from ray_lightning_tpu_torch.convert import flax_to_torch
    jcfg, params = _seeded_moe_params()
    sizes = {"expert": 2, "tensor": 2}
    RELAYED.clear()
    trainer = Trainer(plugins=[_plugin(4, SpmdStrategy(
        gpt_partition_rules(), NAMES, sizes))], max_steps=STEPS,
        max_epochs=2, limit_val_batches=1, num_sanity_val_steps=0, seed=0,
        callbacks=[LossAndAux()], enable_checkpointing=False, logger=False,
        default_root_dir=str(tmp_path))
    module = FixedMoE(flax_to_torch(params), config=GPTConfig(
        **MOE_TINY, dtype=torch.float32), lr=LR, warmup_steps=2,
        batch_size=4, dataset_size=32)
    trainer.fit(module)
    [(_, seen)] = RELAYED
    RELAYED.clear()

    class JaxFixed(JaxModule):
        def init_params(self, rng, batch):
            # the module's own variables (with the sown ``losses``
            # collection the aux loss is read from), these params
            import jax
            import jax.numpy as jnp
            return {**super().init_params(rng, batch), "params":
                    jax.tree_util.tree_map(jnp.asarray, params)}

    want, jw = _jax_fit_with_aux(
        JaxFixed(config=jcfg, lr=LR, warmup_steps=2, batch_size=4,
                 dataset_size=32), JaxSpmd(jgr(), NAMES, sizes), 4,
        tmp_path)
    assert len(seen) == STEPS
    np.testing.assert_allclose(np.array(seen), np.array(want), rtol=RTOL,
                               atol=ATOL)
    _close(module._trained_state, jw, MOE_TINY["n_embd"])


def test_flax_to_shards_takes_each_rank_s_experts():
    """``convert.flax_to_shards`` on (expert=2, tensor=2): each rank's
    ``w1`` is its two experts' column slice, and the four ranks' blocks
    tile the whole tensor."""
    from ray_lightning_tpu_torch.convert import flax_to_shards, flax_to_torch
    _, params = _seeded_moe_params()
    full = flax_to_torch(params)
    shapes = {k: tuple(v.shape) for k, v in full.items()}
    strategy = SpmdStrategy(gpt_partition_rules(), NAMES,
                            {"expert": 2, "tensor": 2})
    w1 = full["h.1.moe.w1"]
    got = torch.zeros_like(w1)
    for rank in range(4):
        e, t = divmod(rank, 2)
        part = flax_to_shards(params, ShardLayout(
            shapes, strategy, Mesh(NAMES, (1, 2, 2), rank=rank)))
        n, f = w1.shape[0] // 2, w1.shape[2] // 2
        assert part["h.1.moe.w1"].shape == (n, w1.shape[1], f)
        got[e * n:(e + 1) * n, :, t * f:(t + 1) * f] = part["h.1.moe.w1"]
        assert torch.equal(part["h.1.moe.router"], full["h.1.moe.router"])
    assert torch.equal(got, w1)
