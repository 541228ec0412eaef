"""PyTorch/CUDA port, sharded training beyond ZeRO-1: ``"fsdp"`` /
``"zero3"``, ``SpmdStrategy`` under ``gpt_partition_rules`` /
``bert_partition_rules`` and ``RaySpmdPlugin``, with CPU workers on gloo
where W > 1.

- the specs: the port's ``param_spec`` / ``opt_spec`` / ``batch_spec``
  equal the JAX package's, as tuples, for every parameter of gpt2-1p3b,
  bert-base and moe-tiny (abstract shapes, the JAX conftest's virtual
  devices; no fit), under ``"fsdp"`` at 2, 4 and 8 and under
  ``SpmdStrategy`` with each rule set on (data, fsdp, tensor) meshes;
  the rule sets equal the JAX functions';
- in process (W=1) ``"fsdp"``, ``"zero3"`` and ``"spmd"`` equal
  ``"ddp"`` bit for bit;
- ``RaySpmdPlugin(num_workers=2, strategy="fsdp")`` equals ``RayPlugin``
  DDP at W=2 bit for bit (no clip), and the JAX ``"fsdp"`` fit on two
  devices within fp32 2e-5 (the sums are DDP's: two terms an element);
- ``tensor=2`` (W=2) and ``data=2 x tensor=2`` (W=4) tiny GPT fits and a
  ``tensor=2`` tiny BERT masked-LM fit (masks carried in the data)
  against the JAX ``SpmdStrategy`` at the same axis sizes.  The row-
  parallel products and the vocab-parallel loss sum in another order
  than GSPMD's, so these hold the JAX package's own strategy-against-
  strategy bar (``tests/test_trainer_local.py:266-279``: rtol 2e-4,
  atol 1e-5) on the losses, and its rtol on each parameter in relative
  L2 with no entry more than 2 x lr x steps away, the k third of each
  qkv bias apart (its gradient is identically zero): Adam turns the
  rounding of a near-zero gradient into steps of up to lr (ROADMAP.md
  F5), as tests/test_torch_bert.py and the DDP parity test hold it;
- ``tensor=2`` at dropout 0.1 equals ``tensor=1`` (the masks fall on
  the whole activations, drawn alike on both ranks), within the same
  bar; a tensor-parallel fit's ``_trained_state`` has whole shapes; a
  rule set the model cannot honour (a LayerNorm split on ``expert``, a
  parameter on ``sequence``, a partial tensor plan) raises at set-up; ``steps_per_execution=2``
  under tensor parallelism (two eager steps a chunk on the CPU) equals
  k=1 bit for bit; the JAX params carried to each rank's blocks
  (``convert.flax_to_shards``) tile the whole tensors.

Workers unpickle this module's modules and callbacks by import path, so
it imports no JAX at its top.  fp32 params and moments on both sides
(``RLT_BF16_PARAMS=0 RLT_BF16_MOMENTS=0``, ROADMAP.md F4).
"""

import functools

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch import (Callback, GPTLightningModule, RayPlugin,
                                     RaySpmdPlugin, Trainer, session)
from ray_lightning_tpu_torch.core.data import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.models import bert as tbert
from ray_lightning_tpu_torch.models.gpt import GPTConfig, gpt_partition_rules
from ray_lightning_tpu_torch.ops.moe import moe_partition_rules
from ray_lightning_tpu_torch.parallel.layout import ShardLayout
from ray_lightning_tpu_torch.parallel.mesh import Mesh
from ray_lightning_tpu_torch.parallel.strategy import (FullyShardedStrategy,
                                                       SpmdStrategy,
                                                       resolve_strategy)

RUN_TIMEOUT_S = 120
TINY = dict(vocab_size=512, block_size=64, n_layer=2, n_head=2, n_embd=64,
            remat=False, attention_impl="dot")
BERT_TINY = dict(vocab_size=512, max_len=64, n_layer=2, n_head=2, n_embd=64,
                 intermediate=128)
LR, STEPS = 3e-3, 4
#: the JAX package's strategy-against-strategy bar
RTOL, ATOL = 2e-4, 1e-5
MESHES = [{"tensor": 2}, {"fsdp": 2, "tensor": 2}, {"fsdp": 4},
          {"data": 2, "fsdp": 2, "tensor": 2}]

#: items the workers relayed, appended on the driver
RELAYED: list = []


def _record(rank, item):
    RELAYED.append((rank, item))


class Losses(Callback):
    """Relays rank 0's per-step losses (every rank holds the same)."""

    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, outputs, batch, i):
        # a chunk of k steps ends once, with its k losses
        self.losses.extend(outputs["loss"].float().reshape(-1).tolist())

    def on_fit_end(self, trainer, module):
        if trainer.plugin.remote:
            session.put_queue(functools.partial(
                _record, session.get_actor_rank(), {"losses": self.losses}))


class FixedGPT(GPTLightningModule):
    """The GPT module starting from given whole weights (a state dict):
    the sharded layout then cuts them."""

    def __init__(self, state, **kw):
        super().__init__(**kw)
        self._state = state

    def init_params(self, generator):
        self.setup_model(generator.device)
        self.model.load_state_dict(self._state)
        return self.model.state_dict()


def _mlm_data(n, seed):
    toks = np.random.default_rng(seed).integers(
        0, BERT_TINY["vocab_size"] - 1,
        (n, BERT_TINY["max_len"])).astype(np.int32)
    mask = np.random.default_rng(seed + 100).random(toks.shape) < 0.15
    return toks, mask


class FixedMLM(tbert.BertMLMModule):
    """The port's masked LM from given weights, its masks in the data."""

    def __init__(self, state, **kw):
        super().__init__(**kw)
        self._state = state

    def init_params(self, generator):
        self.setup_model(generator.device)
        self.model.load_state_dict(self._state)
        return self.model.state_dict()

    def training_step(self, ctx, batch):
        loss = self._mlm_loss(ctx, batch[0], mask=batch[1])
        ctx.log("loss", loss)
        return loss

    def validation_step(self, ctx, batch):
        ctx.log("val_loss", self._mlm_loss(ctx, batch[0], mask=batch[1]))

    def _loader(self, n, seed, shuffle=False):
        return DataLoader(ArrayDataset(*_mlm_data(n, seed)),
                          batch_size=self.batch_size, shuffle=shuffle,
                          drop_last=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fp32(monkeypatch):
    monkeypatch.setenv("RLT_BF16_PARAMS", "0")
    monkeypatch.setenv("RLT_BF16_MOMENTS", "0")


def _spmd(rules, **sizes):
    return SpmdStrategy(rules=rules, axis_names=("data", "fsdp", "tensor"),
                        axis_sizes=sizes)


def _fit(plugin_or_device, module, tmp_path, **kw):
    """A fit of ``STEPS`` steps; its losses and trained weights."""
    RELAYED.clear()
    rec = Losses()
    where = (dict(device=plugin_or_device)
             if isinstance(plugin_or_device, str)
             else dict(plugins=[plugin_or_device]))
    trainer = Trainer(max_steps=STEPS, max_epochs=2, limit_val_batches=1,
                      num_sanity_val_steps=0, seed=0, callbacks=[rec],
                      enable_checkpointing=False, logger=False,
                      default_root_dir=str(tmp_path), **where, **kw)
    trainer.fit(module)
    losses = rec.losses or {r: it["losses"] for r, it in RELAYED}[0]
    RELAYED.clear()
    return losses, module._trained_state, trainer


def _plugin(n, strategy, **kw):
    return RaySpmdPlugin(num_workers=n, platform="cpu", strategy=strategy,
                         timeout_s=RUN_TIMEOUT_S, **kw)


def _seeded_gpt_params():
    """Seeded fp32 params of the JAX tiny GPT (numpy draws; the tree from
    ``jax.eval_shape``, which compiles nothing)."""
    import jax
    import jax.numpy as jnp
    from ray_lightning_tpu.models.gpt import GPT as JaxGPT
    from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
    jcfg = JaxConfig(**TINY, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda r: JaxGPT(jcfg).init(
        r, jnp.zeros((1, 8), jnp.int32))["params"], jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jcfg, jax.tree_util.tree_map_with_path(
        lambda p, x: (np.full(x.shape, p[-1].key == "scale", np.float32)
                      if p[-1].key in ("scale", "bias") else
                      (rng.standard_normal(x.shape) * 0.02).astype(
                          np.float32)), shapes)


def _jax_fit(jmodule, strategy, n_devices, tmp_path):
    import jax
    from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
    from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
    from ray_lightning_tpu.plugins import LocalPlugin as JaxLocalPlugin

    class JaxLosses(JaxCallback):
        def __init__(self):
            self.losses = []

        def on_train_batch_end(self, trainer, module, outputs, batch, i):
            self.losses.append(float(outputs["loss"]))

    rec = JaxLosses()
    jt = JaxTrainer(plugins=[JaxLocalPlugin(
        strategy, devices=jax.devices()[:n_devices])], callbacks=[rec],
        logger=False, max_steps=STEPS, max_epochs=2, limit_val_batches=1,
        num_sanity_val_steps=0, seed=0, enable_checkpointing=False,
        default_root_dir=str(tmp_path))
    jt.fit(jmodule)
    from ray_lightning_tpu_torch.convert import flax_to_torch
    return rec.losses, flax_to_torch(jax.device_get(
        jmodule._trained_variables["params"]))


def _close(got: dict, want: dict, C: int, tol=RTOL) -> None:
    """Every parameter within ``tol`` in relative L2 (the k third of each
    qkv bias apart) and no entry more than 2 x lr x steps away (F5)."""
    assert set(got) == set(want)
    for k, v in got.items():
        a = v.float().numpy().ravel()
        b = want[k].float().numpy().ravel()
        assert np.abs(a - b).max() <= 2 * LR * STEPS, k
        if k.endswith("attn.qkv.bias"):
            a, b = np.delete(a, np.s_[C:2 * C]), np.delete(b, np.s_[C:2 * C])
        assert np.linalg.norm(a - b) <= tol * np.linalg.norm(b), k


# -- the specs ------------------------------------------------------------

def _jax_shapes(model: str):
    """``{flax path: aval}`` of the JAX model (abstract) and the port's
    model on the meta device."""
    import jax
    import jax.numpy as jnp
    from ray_lightning_tpu.models import bert as jbert
    from ray_lightning_tpu.models import gpt as jgpt
    from ray_lightning_tpu.parallel.strategy import _path_str
    if model.startswith("bert"):
        jmod = jbert.BertForMaskedLM(jbert.CONFIGS[model])
        tmodel = tbert.BertForMaskedLM(tbert.CONFIGS[model], device="meta")
    else:
        jmod = jgpt.GPT(jgpt.CONFIGS[model])
        tmodel = GPTLightningModule(model).configure_model("meta")
    tree = jax.eval_shape(lambda r: jmod.init(
        r, jnp.zeros((1, 8), jnp.int32))["params"], jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): a for p, a in flat}, tmodel


@pytest.mark.parametrize("model", ["gpt2-1p3b", "bert-base", "moe-tiny"])
def test_specs_equal_the_jax_package(model):
    """Each parameter's spec (flax layout) under ``"fsdp"`` at W = 2, 4,
    8 and under ``SpmdStrategy`` with the model's rule set on (data,
    fsdp, tensor) meshes, its optimizer state's spec, and the batch's:
    tuples equal to the JAX strategies' on meshes of the conftest's
    virtual CPU devices."""
    import jax
    from ray_lightning_tpu.models.bert import bert_partition_rules as jbr
    from ray_lightning_tpu.models.gpt import gpt_partition_rules as jgr
    from ray_lightning_tpu.parallel import strategy as js
    avals, tmodel = _jax_shapes(model)
    shapes = {k: tuple(p.shape) for k, p in tmodel.named_parameters()}
    from ray_lightning_tpu_torch.convert import flax_path
    paths = {k: flax_path(k)[0] for k in shapes}
    assert sorted(paths.values()) == sorted(avals)
    bert = model.startswith("bert")
    cases = [(FullyShardedStrategy(), js.FullyShardedStrategy(),
              ("data",), {"data": n}, n) for n in (2, 4, 8)]
    rules = (tbert.bert_partition_rules() if bert else gpt_partition_rules(),
             jbr() if bert else jgr())
    for sizes in MESHES:
        n = int(np.prod(list(sizes.values())))
        names = ("data", "fsdp", "tensor")
        cases.append((SpmdStrategy(rules[0], names, sizes),
                      js.SpmdStrategy(rules[1], names, sizes), names,
                      {"data": 1, "fsdp": 1, "tensor": 1, **sizes}, n))
    devices = jax.devices()
    for ours, theirs, names, sizes, n in cases:
        jmesh = theirs.build_mesh(devices[:n])
        mesh = Mesh.abstract(names, sizes)
        assert dict(jmesh.shape) == mesh.shape
        layout = ShardLayout(shapes, ours, mesh)
        for name, info in layout.params.items():
            aval = avals[paths[name]]
            assert tuple(info.spec) == tuple(theirs.param_spec(
                jmesh, paths[name], aval)), (name, sizes)
            assert tuple(ours.opt_spec(mesh, paths[name], aval.shape)) == \
                tuple(theirs.opt_spec(jmesh, paths[name], aval)), name
        for ndim in (0, 1, 2):
            assert tuple(ours.batch_spec(mesh, ndim)) == tuple(
                theirs.batch_spec(jmesh, ndim))


def test_rule_sets_equal_the_jax_functions():
    from ray_lightning_tpu.models.bert import bert_partition_rules as jbr
    from ray_lightning_tpu.models.gpt import gpt_partition_rules as jgr
    from ray_lightning_tpu.ops.moe import moe_partition_rules as jmr
    for ours, theirs in ((gpt_partition_rules(), jgr()),
                         (tbert.bert_partition_rules(), jbr()),
                         (moe_partition_rules(), jmr())):
        assert [(r, tuple(s)) for r, s in ours] == \
            [(r, tuple(s)) for r, s in theirs]


def test_unported_axes_and_unhonoured_rules_raise():
    """A rule set that splits a LayerNorm on ``expert`` (a rank's pieces
    there are only its routed layers' experts) or any parameter on
    ``sequence`` (an axis of activations) raises at set-up; so does one
    that splits what the tensor-parallel forward cannot (only ``qkv``,
    or a LayerNorm); the strategy names resolve."""
    model = GPTLightningModule(GPTConfig(**TINY)).configure_model("meta")
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    for axis in ("expert", "sequence"):
        rules = [("ln1/scale", (axis,))] + gpt_partition_rules()
        with pytest.raises(ValueError, match=axis):
            ShardLayout(shapes, SpmdStrategy(rules, ("data", axis),
                                             {axis: 2}),
                        Mesh.abstract(("data", axis), {"data": 1, axis: 2})
                        ).check_local_plan(model)
    assert isinstance(resolve_strategy("zero3"), FullyShardedStrategy)
    assert resolve_strategy("spmd").name == "spmd"
    mesh = Mesh.abstract(("data", "tensor"), {"data": 1, "tensor": 2})
    for rules in ([("attn/qkv/kernel", (None, "tensor"))],
                  gpt_partition_rules() + [("ln1/scale", ("tensor",))],
                  [("ln1/scale", ("tensor",))] + gpt_partition_rules()):
        layout = ShardLayout(shapes, SpmdStrategy(rules, ("data", "tensor"),
                                                  {"tensor": 2}), mesh)
        with pytest.raises((ValueError, NotImplementedError)):
            layout.check_tensor_plan(model)
    ShardLayout(shapes, SpmdStrategy(gpt_partition_rules(),
                                     ("data", "tensor"), {"tensor": 2}),
                mesh).check_tensor_plan(model)


def test_flax_weights_to_shards_and_back():
    """``convert.flax_to_shards``: each rank's blocks of the JAX tiny
    GPT's params under (fsdp=2, tensor=2) are the slices its coordinates
    select (the fused qkv kernel by heads of each third), so the four
    ranks' blocks tile the whole tensors; ``shards_to_flax`` at one rank
    is the identity."""
    from ray_lightning_tpu_torch.convert import (flax_to_shards,
                                                 flax_to_torch,
                                                 shards_to_flax)
    _, params = _seeded_gpt_params()
    full = flax_to_torch(params)
    strategy = _spmd(gpt_partition_rules(), fsdp=2, tensor=2)
    names = ("data", "fsdp", "tensor")
    blocks = []
    for rank in range(4):
        mesh = Mesh(names, (1, 2, 2), rank=rank)
        layout = ShardLayout({k: tuple(v.shape) for k, v in full.items()},
                             strategy, mesh)
        blocks.append((layout, flax_to_shards(params, layout)))
    for name, whole in full.items():
        info = blocks[0][0].params[name]
        got = torch.zeros(info.storage)
        for layout, shards in blocks:
            idx = tuple(
                slice(layout.mesh.index(*axes) * n,
                      (layout.mesh.index(*axes) + 1) * n)
                for axes, n in zip(info.axes, info.local_storage))
            got[idx] = shards[name].reshape(info.local_storage)
        assert torch.equal(got.reshape(whole.shape), whole), name
    one = ShardLayout({k: tuple(v.shape) for k, v in full.items()},
                      FullyShardedStrategy(), Mesh(("data",), (1,)))
    back = shards_to_flax(flax_to_shards(params, one), one, params)
    import jax
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)))


# -- fits -----------------------------------------------------------------

def _tiny_gpt(state, batch_size, **cfg):
    return FixedGPT(state, config=GPTConfig(**{**TINY, **cfg},
                                            dtype=torch.float32),
                    lr=LR, warmup_steps=2, batch_size=batch_size,
                    dataset_size=32)


@pytest.fixture(scope="module")
def gpt_state():
    model = GPTLightningModule(GPTConfig(**TINY)).configure_model("cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    return {k: v.float() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("strategy", ["fsdp", "zero3", "spmd"])
def test_in_process_strategies_equal_ddp(strategy, gpt_state, tmp_path,
                                         fp32):
    """W=1: every piece is the whole parameter, every gather a no-op."""
    want = _fit("cpu", _tiny_gpt(gpt_state, 4), tmp_path, strategy="ddp")
    got = _fit("cpu", _tiny_gpt(gpt_state, 4), tmp_path, strategy=strategy)
    assert got[0] == want[0]
    assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])


def test_fsdp_plugin_equals_ddp_and_jax(gpt_state, tmp_path, fp32):
    """``RaySpmdPlugin(2, strategy="fsdp")`` at batch 2 a rank: the
    params after 4 steps equal ``RayPlugin`` DDP's bit for bit, and the
    JAX ``"fsdp"`` fit on two devices at batch 4 within 2e-5 (losses
    and every parameter)."""
    from ray_lightning_tpu.models.gpt import GPTLightningModule as JaxModule
    from ray_lightning_tpu_torch.convert import torch_to_flax
    ddp = _fit(RayPlugin(num_workers=2, platform="cpu",
                         timeout_s=RUN_TIMEOUT_S),
               _tiny_gpt(gpt_state, 2), tmp_path)
    fsdp = _fit(_plugin(2, "fsdp"), _tiny_gpt(gpt_state, 2), tmp_path)
    assert fsdp[0] == ddp[0]
    assert all(torch.equal(fsdp[1][k], ddp[1][k]) for k in ddp[1])
    jcfg, params = _seeded_gpt_params()
    params = torch_to_flax(gpt_state, params)

    class JaxFixed(JaxModule):
        def init_params(self, rng, batch):
            import jax.numpy as jnp
            import jax
            return {"params": jax.tree_util.tree_map(jnp.asarray, params)}

    jl, jw = _jax_fit(JaxFixed(config=jcfg, lr=LR, warmup_steps=2,
                               batch_size=4, dataset_size=32),
                      "fsdp", 2, tmp_path)
    np.testing.assert_allclose(fsdp[0], jl, rtol=2e-5, atol=2e-5)
    _close(fsdp[1], jw, TINY["n_embd"], tol=2e-5)


@pytest.mark.parametrize("sizes", [{"tensor": 2}, {"data": 2, "tensor": 2}],
                         ids=["tensor2", "data2_tensor2"])
def test_tensor_parallel_gpt_matches_jax(sizes, gpt_state, tmp_path, fp32):
    """The tiny GPT under ``SpmdStrategy(gpt_partition_rules())`` over W
    = 2 or 4 workers against the JAX ``SpmdStrategy`` on as many
    devices, global batch 4; the driver's weights are whole."""
    from ray_lightning_tpu.models.gpt import GPTLightningModule as JaxModule
    from ray_lightning_tpu.models.gpt import gpt_partition_rules as jgr
    from ray_lightning_tpu.parallel.strategy import (
        SpmdStrategy as JaxSpmd)
    from ray_lightning_tpu_torch.convert import torch_to_flax
    n = int(np.prod(list(sizes.values())))
    data = sizes.get("data", 1)
    got = _fit(_plugin(n, _spmd(gpt_partition_rules(), **sizes)),
               _tiny_gpt(gpt_state, 4 // data), tmp_path)
    assert {k: tuple(v.shape) for k, v in got[1].items()} == \
        {k: tuple(v.shape) for k, v in gpt_state.items()}
    jcfg, params = _seeded_gpt_params()
    params = torch_to_flax(gpt_state, params)

    class JaxFixed(JaxModule):
        def init_params(self, rng, batch):
            import jax
            import jax.numpy as jnp
            return {"params": jax.tree_util.tree_map(jnp.asarray, params)}

    jl, jw = _jax_fit(JaxFixed(config=jcfg, lr=LR, warmup_steps=2,
                               batch_size=4, dataset_size=32),
                      JaxSpmd(jgr(), ("data", "fsdp", "tensor"), sizes),
                      n, tmp_path)
    np.testing.assert_allclose(got[0], jl, rtol=RTOL, atol=ATOL)
    _close(got[1], jw, TINY["n_embd"])


def test_tensor_parallel_bert_matches_jax(tmp_path, fp32):
    """The tiny BERT masked LM (masks carried in the data) under
    ``bert_partition_rules`` at tensor=2 against the JAX fit."""
    import jax
    import jax.numpy as jnp
    import optax
    from ray_lightning_tpu.core.data import ArrayDataset as JaxArrayDataset
    from ray_lightning_tpu.core.data import DataLoader as JaxDataLoader
    from ray_lightning_tpu.models import bert as jbert
    from ray_lightning_tpu.parallel.strategy import SpmdStrategy as JaxSpmd
    from ray_lightning_tpu_torch.convert import flax_to_torch
    jcfg = jbert.BertConfig(**BERT_TINY, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda r: jbert.BertForMaskedLM(jcfg).init(
        r, jnp.zeros((1, 8), jnp.int32))["params"], jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (np.full(x.shape, p[-1].key == "scale", np.float32)
                      if p[-1].key in ("scale", "bias") else
                      (rng.standard_normal(x.shape) * 0.02).astype(
                          np.float32)), shapes)

    class JaxMLM(jbert.BertMLMModule):
        def init_params(self, rng, batch):
            return {"params": jax.tree_util.tree_map(jnp.asarray, params)}

        def _masked(self, ctx, batch):
            tokens, mask = batch
            inputs = jnp.where(mask, self.config.vocab_size - 1, tokens)
            logits = ctx.apply(inputs, not ctx.training)
            ce = optax.softmax_cross_entropy_with_integer_labels(logits,
                                                                 tokens)
            w = mask.astype(jnp.float32)
            return (ce * w).sum() / jnp.maximum(w.sum(), 1.0)

        def training_step(self, ctx, batch):
            loss = self._masked(ctx, batch)
            ctx.log("loss", loss)
            return loss

        def validation_step(self, ctx, batch):
            ctx.log("val_loss", self._masked(ctx, batch))

        def _loader(self, n, seed, shuffle=False):
            return JaxDataLoader(JaxArrayDataset(*_mlm_data(n, seed)),
                                 batch_size=self.batch_size,
                                 shuffle=shuffle, drop_last=True)

    kw = dict(lr=LR, batch_size=4, train_size=16, val_size=8)
    got = _fit(_plugin(2, _spmd(tbert.bert_partition_rules(), tensor=2)),
               FixedMLM(flax_to_torch(params), config=tbert.BertConfig(
                   **BERT_TINY, dtype=torch.float32), **kw), tmp_path)
    jl, jw = _jax_fit(JaxMLM(config=jcfg, **kw),
                      JaxSpmd(jbert.bert_partition_rules(),
                              ("data", "fsdp", "tensor"), {"tensor": 2}),
                      2, tmp_path)
    np.testing.assert_allclose(got[0], jl, rtol=RTOL, atol=ATOL)
    _close(got[1], jw, BERT_TINY["n_embd"])


def test_chunks_of_steps_under_tensor_parallelism(gpt_state, tmp_path, fp32):
    """``steps_per_execution=2`` at tensor=2 over two workers: on the CPU
    a chunk is two eager steps, so the fit equals the k=1 fit bit for
    bit (losses and whole weights)."""
    one = _fit(_plugin(2, _spmd(gpt_partition_rules(), tensor=2)),
               _tiny_gpt(gpt_state, 4), tmp_path)
    two = _fit(_plugin(2, _spmd(gpt_partition_rules(), tensor=2)),
               _tiny_gpt(gpt_state, 4), tmp_path, steps_per_execution=2)
    assert two[0] == one[0] and len(one[0]) == STEPS
    assert all(torch.equal(two[1][k], one[1][k]) for k in one[1])


def test_tensor_parallel_dropout_equals_unsharded(gpt_state, tmp_path,
                                                  fp32):
    """Dropout 0.1 at tensor=2 (W=2) against one process: the masks fall
    on the whole activations after each row-parallel sum, and both ranks
    of the group draw them from the same key (its batch shard's), so the
    fits agree to the summation order."""
    one = _fit("cpu", _tiny_gpt(gpt_state, 4, dropout=0.1), tmp_path)
    two = _fit(_plugin(2, _spmd(gpt_partition_rules(), tensor=2)),
               _tiny_gpt(gpt_state, 4, dropout=0.1), tmp_path)
    plain = _fit("cpu", _tiny_gpt(gpt_state, 4), tmp_path)
    assert one[0] != plain[0]             # the masks moved the losses
    np.testing.assert_allclose(two[0], one[0], rtol=RTOL, atol=ATOL)
    _close(two[1], one[1], TINY["n_embd"])
