"""PyTorch/CUDA port, the training leftovers of ROADMAP.md queue 1 item 9:

- ZeRO-1 over any chain of the port's transforms
  (parallel/strategy.py ``Zero1Optimizer``): ``fp32_master`` over a
  chain, a clip that is not first, and a transform of the caller's with
  per-parameter tensors in its state.  In one process (W=1) each update
  equals the unsharded optimizer's bit for bit; over two gloo workers a
  fit's end state (params and the optimizer's single-device state dict)
  equals DDP's bit for bit without a clip and within 1e-6 with one, as
  ``tests/test_torch_plugin_distributed.py::test_zero1_equals_ddp``
  holds today's chain;
- ``cache_train_dataset`` on a mesh with a ``tensor`` axis over 1: the
  cached set repacked over the batch shards, every rank of a tensor
  group taking the same rows, equals the streamed fit bit for bit
  (tensor=2 alone, and data=2 x tensor=2), in steps and in chunks of 2.

Workers unpickle this module's modules and callbacks by import path, so
it imports no JAX.
"""

import functools

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch import (BoringModel, Callback,
                                     GPTLightningModule, RayPlugin,
                                     RayShardedPlugin, RaySpmdPlugin,
                                     Trainer, session)
from ray_lightning_tpu_torch.models.gpt import GPTConfig, gpt_partition_rules
from ray_lightning_tpu_torch.ops.optim import (SGD, AdamW, EmptyState,
                                               add_decayed_weights, chain,
                                               clip_by_global_norm,
                                               fp32_master)
from ray_lightning_tpu_torch.parallel.strategy import (SpmdStrategy,
                                                       Zero1Strategy)

RUN_TIMEOUT_S = 120
RELAYED: list = []


def _record(rank, item):
    RELAYED.append((rank, item))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class EMAState:
    """A caller's state: one tensor a parameter, and a step count."""

    def __init__(self, ema, steps=0):
        self.ema, self.steps = ema, steps

    def state_dict(self):
        return {"ema": dict(self.ema), "steps": self.steps}

    def load_state_dict(self, state):
        self.ema, self.steps = dict(state["ema"]), int(state["steps"])


class EMAGrads:
    """A caller's gradient map: each gradient replaced by an exponential
    moving average of it (elementwise, a tensor a parameter in its
    state, a count beside them)."""

    def __init__(self, decay=0.5):
        self.decay = decay

    def init(self, params):
        return EMAState({k: torch.zeros_like(p, dtype=torch.float32)
                         for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads, state, params=None):
        state.steps += 1
        for k, g in grads.items():
            state.ema[k].mul_(self.decay).add_(g.float(),
                                               alpha=1 - self.decay)
        return {k: state.ema[k].to(grads[k].dtype) for k in grads}


CHAINS = {
    "master_over_chain": lambda: fp32_master(chain(
        add_decayed_weights(1e-2), AdamW(3e-3, weight_decay=0.0))),
    "clip_not_first": lambda: chain(add_decayed_weights(1e-3),
                                    clip_by_global_norm(0.05),
                                    SGD(0.05, momentum=0.9)),
    "user_transform": lambda: chain(EMAGrads(0.5),
                                    SGD(0.05, momentum=0.9,
                                        nesterov=True)),
}


class ChainModel(BoringModel):
    """The boring model under one of :data:`CHAINS`."""

    def __init__(self, name, **kw):
        super().__init__(**kw)
        self.chain_name = name

    def configure_optimizers(self):
        return CHAINS[self.chain_name]()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_zero1_update_equals_unsharded_in_process(name):
    """W=1: three updates of each chain through ``Zero1Optimizer`` equal
    the chain's own on the same params and gradients, state dict
    included, bit for bit."""
    gen = torch.Generator().manual_seed(0)
    shapes = {"a": (33, 7), "b": (7,), "c": (1,), "d": (5, 4)}
    init = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    plain = {k: v.clone() for k, v in init.items()}
    sharded = {k: v.clone() for k, v in init.items()}
    tx_p = CHAINS[name]()
    tx_z = Zero1Strategy().wrap_optimizer(CHAINS[name]())
    st_p, st_z = tx_p.init(plain), tx_z.init(sharded)
    for _ in range(3):
        grads = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
        tx_p.update(grads, st_p, plain)
        tx_z.update(grads, st_z, sharded)
    for k in shapes:
        assert torch.equal(sharded[k], plain[k]), k
    want, got = _flat(st_p.state_dict()), _flat(st_z.state_dict())
    assert set(got) == set(want)
    for k, v in want.items():
        if torch.is_tensor(v):
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        else:
            assert got[k] == v, k
    st_z.load_state_dict(st_p.state_dict())
    again = _flat(st_z.state_dict())
    assert all(torch.equal(again[k], v) if torch.is_tensor(v)
               else again[k] == v for k, v in want.items())


class EndState(Callback):
    """Rank 0 relays the optimizer's single-device state dict (every
    rank joins its gather) at the fit's end."""

    def on_fit_end(self, trainer, module):
        sd = trainer.state.opt_state.state_dict()
        if trainer.is_global_zero:
            session.put_queue(functools.partial(_record, 0, _flat(sd)))


def _chain_fit(name, zero1, tmp_path):
    RELAYED.clear()
    cls = RayShardedPlugin if zero1 else RayPlugin
    trainer = Trainer(plugins=[cls(num_workers=2, platform="cpu",
                                   timeout_s=RUN_TIMEOUT_S)],
                      max_steps=8, max_epochs=100, limit_val_batches=0,
                      num_sanity_val_steps=0, enable_checkpointing=False,
                      logger=False, seed=0, callbacks=[EndState()],
                      default_root_dir=str(tmp_path))
    module = ChainModel(name, lr=0.05, batch_size=4)
    trainer.fit(module)
    opt = dict(RELAYED)[0]
    RELAYED.clear()
    return module._trained_state, opt


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_zero1_chain_equals_ddp(name, tmp_path):
    """Two gloo workers: ZeRO-1's end state equals DDP's bit for bit,
    within 1e-6 where a clip takes the norm a shard at a time."""
    atol = 1e-6 if name == "clip_not_first" else 0.0
    ddp = _chain_fit(name, False, tmp_path / "ddp")
    zero = _chain_fit(name, True, tmp_path / "zero1")
    for got, want in zip(zero, ddp):
        assert set(got) == set(want)
        for k, v in want.items():
            if not torch.is_tensor(v):
                assert got[k] == v, k
            elif atol:
                torch.testing.assert_close(got[k], v, atol=atol, rtol=0)
            else:
                assert torch.equal(got[k], v), k


# -- cache_train_dataset on a tensor axis ------------------------------------

TINY = dict(vocab_size=512, block_size=64, n_layer=2, n_head=2, n_embd=64,
            remat=False, attention_impl="dot")


class Losses(Callback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, outputs, batch, i):
        self.losses.extend(outputs["loss"].float().reshape(-1).tolist())

    def on_fit_end(self, trainer, module):
        if trainer.is_global_zero:
            session.put_queue(functools.partial(_record, 0, self.losses))


def _tp_fit(world, tmp_path, **kw):
    RELAYED.clear()
    strategy = SpmdStrategy(rules=gpt_partition_rules(),
                            axis_names=("data", "tensor"),
                            axis_sizes={"tensor": 2})
    trainer = Trainer(plugins=[RaySpmdPlugin(
        num_workers=world, platform="cpu", strategy=strategy,
        timeout_s=RUN_TIMEOUT_S)], max_steps=6, max_epochs=3,
        limit_val_batches=0, num_sanity_val_steps=0,
        enable_checkpointing=False, logger=False, seed=0,
        callbacks=[Losses()], default_root_dir=str(tmp_path), **kw)
    module = GPTLightningModule(GPTConfig(**TINY), lr=3e-3, warmup_steps=2,
                                batch_size=2, dataset_size=16)
    trainer.fit(module)
    losses = dict(RELAYED)[0]
    RELAYED.clear()
    return losses, module._trained_state


@pytest.mark.parametrize("world", [2, 4])
def test_cache_train_dataset_on_a_tensor_axis(world, tmp_path):
    """tensor=2 (and data=2 x tensor=2): the cached fit, stepwise and in
    chunks of 2, equals the streamed one bit for bit (the rows a batch
    shard holds are its tensor group's)."""
    want = _tp_fit(world, tmp_path / "stream")
    for kw in (dict(cache_train_dataset=True),
               dict(cache_train_dataset=True, steps_per_execution=2)):
        got = _tp_fit(world, tmp_path / "cache", **kw)
        assert got[0] == want[0], kw
        assert all(torch.equal(got[1][k], want[1][k]) for k in want[1]), kw
