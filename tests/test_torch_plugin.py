"""PyTorch/CUDA port, the plugins and strategies without processes:
``RayPlugin`` / ``RayShardedPlugin``, ``LocalPlugin``,
``resolve_strategy``, ``DataLoader.shard`` and the checkpoint's
``world_size`` / ``strategy``, against the JAX package's
``RayXlaPlugin``, ``resolve_strategy``, loader and ``Trainer``.

- the plugin's constructor (resource precedence, ``num_workers=0``, the
  run's bound on by default),
  pickling without live handles, ``_assign_local_ranks`` on the same
  node lists, the NCCL over-subscription check;
- every strategy name of the JAX package: the same strategy, or
  ``NotImplementedError`` naming its ROADMAP item, or the same
  ``ValueError``;
- ``DataLoader.shard``: the indices of every shard and epoch, as the JAX
  loader's;
- ``Trainer(strategy="ddp" | "zero1")`` without a plugin: the default
  fit, bit for bit (``torch.equal`` on the params, the fp32 master and
  the moments), and checkpoints whose ``world_size`` and ``strategy``
  are the JAX ``Trainer``'s for the same local fits.

Everything here runs in this process: the actor runs are in
tests/test_torch_plugin_distributed.py.
"""

import pickle

import jax
import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.data import ArrayDataset as JaxArrayDataset
from ray_lightning_tpu.core.data import DataLoader as JaxDataLoader
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.boring import BoringModel as JaxBoring
from ray_lightning_tpu.parallel import strategy as jax_strategy
from ray_lightning_tpu.plugins import RayXlaPlugin, RayXlaShardedPlugin
from ray_lightning_tpu_torch import (BoringModel, GPTLightningModule,
                                     RayPlugin, RayShardedPlugin, Trainer)
from ray_lightning_tpu_torch.core.data import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.models.gpt import GPTConfig
from ray_lightning_tpu_torch.parallel import strategy as torch_strategy
from ray_lightning_tpu_torch.plugins import LocalPlugin

#: tiny's widths, dot attention
TINY = dict(vocab_size=512, block_size=64, n_layer=2, n_head=2, n_embd=64,
            remat=False, attention_impl="dot")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the plugin's surface ------------------------------------------------------

def test_resources_per_worker_precedence_matches_jax():
    """``resources_per_worker`` overrides the convenience arguments as in
    the JAX plugin, with ``"GPU"`` where it reads ``"TPU"``."""
    res = {"CPU": 3, "extra": 1}
    jp = RayXlaPlugin(num_workers=2, num_cpus_per_worker=8,
                      resources_per_worker={**res, "TPU": 1})
    tp = RayPlugin(num_workers=2, num_cpus_per_worker=8,
                   resources_per_worker={**res, "GPU": 1})
    assert tp.num_cpus_per_worker == jp.num_cpus_per_worker == 3
    assert tp.use_gpu and jp.use_tpu
    assert tp.additional_resources == jp.additional_resources == {
        "extra": 1}
    assert tp._worker_resources() == {"CPU": 3, "extra": 1, "GPU": 1}
    assert jp._worker_resources() == {"CPU": 3, "extra": 1, "TPU": 1}
    off = RayPlugin(use_gpu=True, resources_per_worker={"GPU": 0})
    assert not off.use_gpu and off.platform == "cpu"
    assert "GPU" not in off._worker_resources()
    for p in (RayPlugin(platform="cpu"), RayPlugin(use_gpu=False)):
        assert (p.use_gpu, p.platform) == (False, "cpu")
    assert (RayPlugin().use_gpu, RayPlugin().platform) == (True, "cuda")
    assert RayShardedPlugin().strategy.name == \
        RayXlaShardedPlugin().strategy.name == "zero1"
    assert RayPlugin().strategy.name == RayXlaPlugin().strategy.name == "ddp"


def test_invalid_num_workers_raises_as_jax():
    for cls in (RayPlugin, RayXlaPlugin):
        with pytest.raises(ValueError, match="num_workers"):
            cls(num_workers=0)


def test_run_bound_is_positive_and_on_by_default():
    """A run always has a deadline: ``RUN_TIMEOUT_S`` unless the caller
    gives another, and ``None`` or a non-positive bound is refused."""
    from ray_lightning_tpu_torch.plugins.ray_ddp import RUN_TIMEOUT_S
    assert RayPlugin().timeout_s == RayShardedPlugin().timeout_s == \
        RUN_TIMEOUT_S > 0
    assert RayPlugin(timeout_s=7).timeout_s == 7.0
    for bad in (None, 0, -1):
        with pytest.raises(ValueError, match="timeout_s"):
            RayPlugin(timeout_s=bad)


def test_plugin_pickle_drops_handles():
    """The payload carries the plugin without its live handles and
    without the ``init_hook``, which ran before shipping."""
    for cls in (RayPlugin, RayXlaPlugin):
        p = cls(num_workers=2, init_hook=print)
        p._workers = ["sentinel"]
        p._backend = "backend"
        q = pickle.loads(pickle.dumps(p))
        assert q._workers == [] and q._backend is None
        assert q.init_hook is None and q.num_workers == 2
        assert p._workers == ["sentinel"]


@pytest.mark.parametrize("ips", [
    ["1", "2", "1", "2"], ["a"], ["b", "a", "b", "a", "c"],
    ["10.0.0.2", "10.0.0.1", "10.0.0.1"]])
def test_assign_local_ranks_matches_jax(ips):
    info = [{"ip": ip} for ip in ips]
    assert RayPlugin._assign_local_ranks(info) == \
        RayXlaPlugin._assign_local_ranks(info)


def test_gpu_oversubscription_raises_value_error():
    """Two GPU workers on a node that sees one GPU raise ``ValueError``
    naming the counts, before any rendezvous; as many workers as GPUs
    pass, and a node without GPUs is left to its workers."""
    info = [{"ip": "n1", "num_gpus": 1}, {"ip": "n1", "num_gpus": 1},
            {"ip": "n2", "num_gpus": 2}]
    ranks = RayPlugin._assign_local_ranks(info)
    with pytest.raises(ValueError, match="hosts 2 GPU workers but sees 1"):
        RayPlugin._check_gpu_fit(info, ranks)
    fit = [{"ip": "n1", "num_gpus": 2}] * 2 + [{"ip": "n2", "num_gpus": 0}]
    RayPlugin._check_gpu_fit(fit, RayPlugin._assign_local_ranks(fit))


def test_trainer_takes_the_plugin_and_its_device_from_it():
    """A remote plugin's ``Trainer`` resolves no device (its workers
    take theirs); ``device=`` beside one is refused; ``strategy=``
    overrides the plugin's; one execution plugin at most."""
    t = Trainer(plugins=[RayPlugin(num_workers=2)], strategy="sharded",
                logger=False)
    assert t.device is None and t.strategy.name == "zero1"
    assert (t.world_size, t.global_rank, t.is_global_zero) == (1, 0, True)
    with pytest.raises(ValueError, match="take their own devices"):
        Trainer(plugins=[RayPlugin()], device="cpu")
    with pytest.raises(ValueError, match="At most one"):
        Trainer(plugins=[RayPlugin(), RayPlugin()])
    local = Trainer(device="cpu", logger=False)
    assert isinstance(local.plugin, LocalPlugin)
    assert local.strategy.name == "ddp"
    assert local.device == torch.device("cpu")


# -- strategies ------------------------------------------------------------

@pytest.mark.parametrize("name", [*jax_strategy.strategy_names(), None,
                                  "DDP", "bogus"])
def test_resolve_strategy_names_match_jax(name):
    """Each JAX strategy name resolves to the same strategy (by its
    ``name``), or raises ``NotImplementedError`` naming its ROADMAP.md
    item when it is not ported; an unknown one raises ``ValueError`` in
    both packages."""
    if name == "bogus":
        for mod in (jax_strategy, torch_strategy):
            with pytest.raises(ValueError, match="Unknown strategy"):
                mod.resolve_strategy(name)
        return
    want = jax_strategy.resolve_strategy(name).name
    if want in ("ddp", "zero1"):
        got = torch_strategy.resolve_strategy(name)
        assert got.name == want
        assert type(got).__name__ == type(
            jax_strategy.resolve_strategy(name)).__name__
        return
    with pytest.raises(NotImplementedError,
                       match=r"not ported yet \(ROADMAP.md queue 1 item "
                             r"(9|11|12)\)"):
        torch_strategy.resolve_strategy(name)


def test_zero1_min_shard_elements_keeps_small_params_whole():
    """Params under ``max(2, min_shard_elements)`` elements form the
    replicated group; the rest one sharded flat vector."""
    params = {"a": torch.zeros(5), "b": torch.zeros(1),
              "c": torch.zeros(3, 4)}
    from ray_lightning_tpu_torch.ops.optim import SGD
    for mse, whole in ((0, ["b"]), (6, ["a", "b"])):
        opt = torch_strategy.Zero1Strategy(mse).wrap_optimizer(SGD(0.1))
        state = opt.init(params)
        assert [g.names for g in state.groups] == [
            [k for k in params if k not in whole], whole]


# -- the loader's shards ---------------------------------------------------

@pytest.mark.parametrize("n,shards,shuffle,drop_last,epoch", [
    (10, 2, False, False, 0), (10, 3, True, False, 1),
    (11, 4, True, True, 2), (7, 2, False, True, 0), (16, 4, True, False, 5),
    (5, 8, False, False, 0)])
def test_loader_shard_indices_match_jax(n, shards, shuffle, drop_last,
                                        epoch):
    """Every shard's batches, index for index, as the JAX loader's:
    wrap-around padding, then a stride; ``set_epoch`` reshuffles."""
    data = np.arange(n, dtype=np.int64)
    for r in range(shards):
        tl = DataLoader(ArrayDataset(data), batch_size=2, shuffle=shuffle,
                        drop_last=drop_last, seed=3).shard(shards, r)
        jl = JaxDataLoader(JaxArrayDataset(data), batch_size=2,
                           shuffle=shuffle, drop_last=drop_last, seed=3,
                           prefetch=False).shard(shards, r)
        tl.set_epoch(epoch)
        jl.set_epoch(epoch)
        got = [b.numpy().tolist() for b in tl]
        want = [np.asarray(b).tolist() for b in jl]
        assert got == want and len(tl) == len(jl) == len(got), (
            r, got, want)


# -- Trainer(strategy=...) without a plugin ---------------------------------

def _state(trainer, module) -> dict:
    """Clones of the params and the optimizer state's tensors, by name."""
    out = {f"param {k}": v.clone()
           for k, v in module.model.state_dict().items()}

    def walk(prefix, d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}/", v)
            else:
                out[f"{prefix}{k}"] = v.clone() if torch.is_tensor(v) else v

    walk("opt/", trainer.state.opt_state.state_dict())
    return out


def _gpt_fit(root, **kw):
    trainer = Trainer(max_epochs=2, limit_train_batches=3,
                      limit_val_batches=1, num_sanity_val_steps=0, seed=0,
                      device="cpu", default_root_dir=str(root), **kw)
    module = GPTLightningModule(GPTConfig(**TINY), lr=3e-3, warmup_steps=2,
                                batch_size=2, dataset_size=8)
    trainer.fit(module)
    return trainer, module


@pytest.mark.parametrize("clip", [None, 0.1])
def test_local_strategy_fit_equals_default_fit(clip, tmp_path):
    """``Trainer(strategy="ddp" | "zero1")`` goes through ``LocalPlugin``
    at world size 1: the same fit as the default, bit for bit, on the
    tiny GPT (bf16 params, the fp32 master, a bf16 first moment), with
    and without a clip that triggers."""
    base_t, base_m = _gpt_fit(tmp_path / "base", gradient_clip_val=clip)
    want = _state(base_t, base_m)
    for name in ("ddp", "zero1"):
        t, m = _gpt_fit(tmp_path / name, strategy=name,
                        gradient_clip_val=clip)
        got = _state(t, m)
        assert t.strategy.name == name
        assert set(got) == set(want)
        for k, w in want.items():
            if torch.is_tensor(w):
                assert got[k].dtype == w.dtype and torch.equal(got[k], w), \
                    (name, k)
            else:
                assert got[k] == w, (name, k)
        assert t.callback_metrics == base_t.callback_metrics


@pytest.mark.parametrize("strategy", [None, "zero1"])
def test_checkpoint_world_size_and_strategy_match_jax(strategy, tmp_path):
    """A local fit's checkpoint holds the JAX ``Trainer``'s
    ``world_size`` and ``strategy``: 1 and ``"ddp"`` by default (a local
    fit resolves DDP), 1 and ``"zero1"`` under ``strategy="zero1"``."""
    kw = dict(max_epochs=1, limit_train_batches=2, limit_val_batches=1,
              num_sanity_val_steps=0, seed=0, strategy=strategy)
    jt = JaxTrainer(default_root_dir=str(tmp_path / "jax"), logger=False,
                    **kw)
    jt.fit(JaxBoring())
    tt = Trainer(default_root_dir=str(tmp_path / "torch"), device="cpu",
                 **kw)
    tt.fit(BoringModel())
    want = JaxTrainer.load_checkpoint_dict(
        jt.checkpoint_callback.best_model_path)
    got = Trainer.load_checkpoint_dict(tt.checkpoint_callback.best_model_path)
    assert (got["world_size"], got["strategy"]) == (
        want["world_size"], want["strategy"]) == (1, strategy or "ddp")
    assert jax.process_count() == 1
