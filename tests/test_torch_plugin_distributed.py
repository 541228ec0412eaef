"""PyTorch/CUDA port, training over subprocess actors: ``RayPlugin`` (DDP)
and ``RayShardedPlugin`` (ZeRO-1) with CPU workers on gloo
(``platform="cpu"``), on the built-in actor backend.

- against the JAX package: a 2-worker DDP fit of the tiny GPT in fp32
  against the JAX ``Trainer`` on 2 devices (``LocalPlugin("ddp")``) with
  the same global batch: per-step losses within 2e-5; each param tensor
  within 2e-5 in relative L2 (the k third of each qkv bias apart) and no
  entry more than 2 x lr x steps away (ROADMAP.md F5);
- ZeRO-1 against DDP at W=2 on the tiny GPT (bf16 params, the fp32
  master, a bf16 first moment): bit for bit (``torch.equal`` on the
  params, master, moments and count) without clipping, within 1e-6 with
  a clip that triggers; a rank holds ceil(N / W) master elements; a
  1-epoch fit and its resume equal the 2-epoch fit bit for bit; a W=2
  checkpoint restores bit for bit in a one-process ``Trainer``, and a
  one-process checkpoint in W=2 workers;
- the behaviours of tests/test_plugin_distributed.py: training with 1
  and 2 workers (weights changed, round-tripped to the driver),
  ``best_model_path`` and the metrics on the driver, ``init_hook`` and
  ``worker_env`` in the workers, the world info inside them, a raising
  or dying rank failing the fit with its log tail, a rank stuck past
  the run's bound failing it with ``TimeoutError``, no child process
  left, validate without a fit (the batch-size-weighted mean over every
  rank's batches), predict (every rank's rows), dropout seeds that differ across ranks and repeat
  across runs;
- guards: a worker imports no ``jax``, ``flax``, ``optax`` or
  ``ray_lightning_tpu``; a GPU worker on a machine without CUDA fails
  the fit with its own error; a reply the driver cannot unpickle fails
  its call.

Workers unpickle this module's callbacks, modules and relayed items by
import path (stdlib pickle), so it imports no JAX at its top: the JAX
side of the parity test imports inside that test.  Every run carries its
bound (``RayPlugin(timeout_s=RUN_TIMEOUT_S)``), so none can hang the
suite.
"""

import functools
import os
import sys
import time
import types

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch import (BoringModel, Callback,
                                     GPTLightningModule, ModelCheckpoint,
                                     RayPlugin, Trainer, session)
from ray_lightning_tpu_torch.cluster import RemoteActorError, get_backend
from ray_lightning_tpu_torch.models.gpt import GPTConfig
from ray_lightning_tpu_torch.ops.attention import dropout_keep_mask
from ray_lightning_tpu_torch.parallel.strategy import Zero1State

#: a run's bound: the driver's wait for its workers and each collective
RUN_TIMEOUT_S = 90
#: tiny's widths, dot attention
TINY = dict(vocab_size=512, block_size=64, n_layer=2, n_head=2, n_embd=64,
            remat=False, attention_impl="dot")
BANNED = ("jax", "jaxlib", "flax", "optax", "ray_lightning_tpu")

#: items the workers relayed, appended on the driver by ``_record``
RELAYED: list = []


def _record(rank, item):
    RELAYED.append((rank, item))


def relay(trainer, item) -> None:
    """In a worker: send ``item`` to the driver's ``RELAYED`` (nothing
    in a one-process run)."""
    if trainer.plugin.remote:
        session.put_queue(functools.partial(
            _record, session.get_actor_rank(), item))


def relayed(items, key) -> dict:
    """``rank -> item[key]`` over the relayed dicts holding ``key``."""
    return {r: it[key] for r, it in items if key in it}


def fit(trainer, module, stage="fit", **kw):
    """Run a stage; the items its workers relayed."""
    RELAYED.clear()
    out = getattr(trainer, stage)(module, **kw)
    items = list(RELAYED)
    RELAYED.clear()
    return out, items


def cpu_plugin(n, **kw) -> RayPlugin:
    kw.setdefault("timeout_s", RUN_TIMEOUT_S)
    return RayPlugin(num_workers=n, platform="cpu", **kw)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- worker-side helpers (module level: the workers import them) ------------

def touch_marker():
    """``init_hook``: a file named after this worker's pid."""
    open(os.path.join(os.environ["RLT_TEST_MARKERS"],
                      f"pid_{os.getpid()}"), "w").close()


class Probe(Callback):
    """Relays what a rank sees: world info, environment, device, the
    modules it imported, its dropout seeds and its metrics."""

    def on_fit_start(self, trainer, module):
        relay(trainer, {"world": [trainer.world_size, trainer.global_rank,
                         trainer.local_rank, trainer.node_rank,
                         trainer.is_global_zero],
               "pid": os.getpid(), "flag": os.environ.get("RLT_TEST_FLAG"),
               "device": str(trainer.device),
               "strategy": trainer.strategy.name,
               "banned": sorted(m for m in sys.modules
                                if m.split(".")[0] in BANNED)})

    def on_fit_end(self, trainer, module):
        relay(trainer, {"seeds": list(module.seeds),
               "metrics": dict(trainer.callback_metrics)})


class ProbeModel(BoringModel):
    """``BoringModel`` recording each train step's first dropout seed."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.seeds = []

    def training_step(self, ctx, batch):
        self.seeds.append(ctx.dropout_seed(0.5))
        return super().training_step(ctx, batch)


class Pid(Callback):
    def on_fit_start(self, trainer, module):
        relay(trainer, {"pid": os.getpid()})


class Crash(Callback):
    """Rank 1 fails at its second batch: raises, or exits the process."""

    def __init__(self, how: str):
        self.how = how

    def on_train_batch_start(self, trainer, module, batch, batch_idx):
        if trainer.global_rank == 1 and batch_idx == 1:
            print("rank 1 fails now", flush=True)
            if self.how == "exit":
                os._exit(3)
            raise RuntimeError("boom from rank 1")


#: how long ``stall`` and ``Stall`` hold a worker: far past any bound the
#: tests set, the actor is killed first
STALL_S = 300


def stall():
    """``init_hook`` that holds the worker past the run's bound."""
    time.sleep(STALL_S)


class Stall(Callback):
    """Holds the rank at fit start, outside any collective."""

    def on_fit_start(self, trainer, module):
        time.sleep(STALL_S)


class Losses(Callback):
    """Relays the rank's per-step losses at the end of the fit."""

    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, outputs, batch, i):
        self.losses.append(float(outputs["loss"]))

    def on_fit_end(self, trainer, module):
        relay(trainer, {"losses": self.losses})


class SaveAtEnd(Callback):
    """``save_checkpoint`` at the end of the fit, on every rank (it is
    collective), so the file holds the next epoch, as after a fit; with
    ``relay_state``, each rank's restored optimizer state and params at
    the fit's start go to the driver (rank 0's)."""

    def __init__(self, path: str, relay_state: bool = False):
        self.path = path
        self.relay_state = relay_state

    def on_fit_start(self, trainer, module):
        opt = trainer.state.opt_state
        if isinstance(opt, Zero1State):
            relay(trainer, {"shards": [[g.size, g.n, g.shards] for g in opt.groups],
                   "master": [m.numel() for m in opt.masters
                              if m is not None]})
        if self.relay_state:
            sd = opt.state_dict()               # collective
            relay(trainer, {"restored": {"opt": sd, "params": {
                k: v.clone() for k, v in
                module.model.state_dict().items()}}})

    def on_fit_end(self, trainer, module):
        trainer.save_checkpoint(self.path)


class FixedGPT(GPTLightningModule):
    """The GPT module starting from given weights (a state dict)."""

    def __init__(self, state, **kw):
        super().__init__(**kw)
        self._state = state

    def init_params(self, generator):
        self.setup_model(generator.device)
        self.model.load_state_dict(self._state)
        return self.model.state_dict()


# -- train, metrics, hooks, world info, dropout ------------------------------

@pytest.mark.parametrize("num_workers", [1, 2])
def test_train(num_workers, tmp_path):
    """The driver's module after a plugin fit holds the trained weights
    (changed from the init, never built on the driver); a local
    ``validate`` on them gives the plugin's final ``val_loss`` (rank r's
    batch i holds the samples of the one-process batches of that
    validation)."""
    kw = dict(max_epochs=1, limit_train_batches=4, num_sanity_val_steps=0,
              seed=0, enable_checkpointing=False, logger=False,
              default_root_dir=str(tmp_path))
    trainer = Trainer(plugins=[cpu_plugin(num_workers)],
                      limit_val_batches=1, **kw)
    module = BoringModel()
    fit(trainer, module)
    assert module.model is None and trainer.global_step == 4
    init = BoringModel()
    init.init_params(torch.Generator().manual_seed(0))
    trained = module._trained_state
    assert set(trained) == set(init.model.state_dict())
    assert all(t.device.type == "cpu" for t in trained.values())
    assert not any(torch.equal(trained[k], v)
                   for k, v in init.model.state_dict().items())
    local = Trainer(device="cpu", limit_val_batches=num_workers, **kw)
    [res] = local.validate(module)
    np.testing.assert_allclose(res["val_loss"],
                               trainer.callback_metrics["val_loss"],
                               rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """Two identical 2-worker fits of ``ProbeModel`` with ``Probe``, an
    ``init_hook`` and a ``worker_env``: 2 epochs of 4 steps, a validation
    of 2 batches after each, the best checkpoint by ``val_loss`` and the
    CSV log."""
    runs = []
    for i in range(2):
        root = tmp_path_factory.mktemp(f"probe{i}")
        markers = root / "markers"
        markers.mkdir()
        plugin = cpu_plugin(2, init_hook=touch_marker, worker_env={
            "RLT_TEST_MARKERS": str(markers), "RLT_TEST_FLAG": "on"})
        trainer = Trainer(plugins=[plugin], max_epochs=2,
                          limit_train_batches=4, limit_val_batches=2,
                          num_sanity_val_steps=0, log_every_n_steps=1,
                          seed=0, callbacks=[
                              Probe(), ModelCheckpoint(monitor="val_loss")],
                          default_root_dir=str(root))
        module = ProbeModel()
        _, items = fit(trainer, module)
        runs.append(types.SimpleNamespace(
            trainer=trainer, module=module, items=items, root=root,
            markers=sorted(os.listdir(markers))))
    return runs


def test_init_hook_and_worker_env_reach_the_workers(probe):
    run = probe[0]
    pids = relayed(run.items, "pid")
    assert run.markers == sorted(f"pid_{p}" for p in pids.values())
    assert relayed(run.items, "flag") == {0: "on", 1: "on"}


def test_world_info_inside_the_workers(probe):
    """Each rank sees the process group's world: size 2, its rank, its
    local rank on the one node, node 0; its CPU device; the strategy."""
    info = relayed(probe[0].items, "world")
    assert info == {0: [2, 0, 0, 0, True], 1: [2, 1, 1, 0, False]}
    assert relayed(probe[0].items, "device") == {0: "cpu", 1: "cpu"}
    assert relayed(probe[0].items, "strategy") == {0: "ddp", 1: "ddp"}


def test_best_model_path_and_metrics_round_trip(probe):
    """The driver's trainer holds rank 0's ``best_model_path`` (the file
    exists, the epoch-0 file was evicted), counters and
    ``callback_metrics``, which every rank holds alike (global metrics);
    ``metrics.csv`` has one row a step: only global zero writes it."""
    run = probe[0]
    t = run.trainer
    best = t.checkpoint_callback.best_model_path
    assert os.path.basename(best) == "epoch=1-step=8.ckpt"
    assert os.listdir(run.root / "checkpoints") == [os.path.basename(best)]
    assert t.checkpoint_callback.best_model_score == \
        t.callback_metrics["val_loss"]
    assert (t.global_step, t.current_epoch) == (8, 2)
    metrics = relayed(run.items, "metrics")
    assert metrics[0] == metrics[1] == t.callback_metrics
    assert set(t.callback_metrics) == {"loss", "val_loss"}
    assert all(np.isfinite(v) for v in t.callback_metrics.values())
    rows = (run.root / "logs" / "metrics.csv").read_text().splitlines()
    assert sum(1 for r in rows[1:] if r.split(",")[1]) == 8
    ckpt = Trainer.load_checkpoint_dict(best)
    assert (ckpt["world_size"], ckpt["strategy"]) == (2, "ddp")


def test_no_child_process_is_left_alive(probe):
    for run in probe:
        for pid in relayed(run.items, "pid").values():
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)
    assert get_backend()._actors == {}


def test_dropout_differs_across_ranks_and_repeats_across_runs(probe):
    """Each step's dropout seed joins the rank: rank 0's and rank 1's
    masks differ at every step; two runs draw the same seeds."""
    seeds = [relayed(run.items, "seeds") for run in probe]
    assert seeds[0] == seeds[1]
    assert len(seeds[0][0]) == len(seeds[0][1]) == 8
    for s0, s1 in zip(seeds[0][0], seeds[0][1]):
        m0, m1 = (dropout_keep_mask((256,), 0.5, s, "cpu") for s in (s0, s1))
        assert not torch.equal(m0, m1)


def test_worker_imports_no_jax(probe):
    assert relayed(probe[0].items, "banned") == {0: [], 1: []}


def test_evaluate_without_fit(tmp_path):
    """``validate`` over 2 workers with no fit: the batch-size-weighted
    mean over both ranks' batches, as one process validating the same
    samples."""
    kw = dict(seed=0, enable_checkpointing=False, logger=False,
              default_root_dir=str(tmp_path))
    res, _ = fit(Trainer(plugins=[cpu_plugin(2)], limit_val_batches=3,
                         **kw), BoringModel(), stage="validate")
    [want] = Trainer(device="cpu", limit_val_batches=6, **kw).validate(
        BoringModel())
    assert set(res[0]) == {"val_loss"}
    np.testing.assert_allclose(res[0]["val_loss"], want["val_loss"],
                               rtol=2e-5, atol=2e-5)


def test_predict_returns_every_rank_rows(tmp_path):
    """``predict`` over 2 workers: each batch holds rank 0's rows, then
    rank 1's (the loader's stride puts samples 4i and 4i+2 on rank 0,
    4i+1 and 4i+3 on rank 1), the same outputs as one process predicting
    those samples."""
    kw = dict(seed=0, enable_checkpointing=False, logger=False,
              limit_predict_batches=3, default_root_dir=str(tmp_path))
    got, _ = fit(Trainer(plugins=[cpu_plugin(2)], **kw), BoringModel(),
                 stage="predict")
    want = Trainer(device="cpu", **kw).predict(BoringModel(batch_size=4))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape == (4, 2)
        np.testing.assert_allclose(g.numpy(), w[[0, 2, 1, 3]].numpy(),
                                   rtol=2e-5, atol=2e-5)


# -- failures and guards ------------------------------------------------------

@pytest.mark.parametrize("how", ["raise", "exit"])
def test_failing_rank_fails_the_fit_with_its_log_tail(how, tmp_path):
    """Rank 1 raises (or dies) at its second step while rank 0 waits in
    the gradient all-reduce: the fit fails on the driver at once with a
    ``RemoteActorError`` carrying rank 1's error and its log tail, and
    both workers are gone."""
    trainer = Trainer(plugins=[cpu_plugin(2)], max_epochs=1,
                      limit_train_batches=4, limit_val_batches=0,
                      num_sanity_val_steps=0, enable_checkpointing=False,
                      logger=False, seed=0, callbacks=[Pid(), Crash(how)],
                      default_root_dir=str(tmp_path))
    t0 = time.monotonic()
    with pytest.raises(RemoteActorError) as err:
        fit(trainer, BoringModel())
    assert time.monotonic() - t0 < RUN_TIMEOUT_S / 2
    text = str(err.value)
    assert "worker log tail" in text and "rank 1 fails now" in text
    assert ("boom from rank 1" in text) if how == "raise" else (
        "died" in text)
    assert get_backend()._actors == {}


@pytest.mark.parametrize("where", ["init_hook", "fit_start"])
def test_worker_past_the_bound_fails_the_fit_with_timeout(where, tmp_path):
    """A worker stuck outside any collective (in ``init_hook``, or at fit
    start) fails the fit with ``TimeoutError`` once the plugin's
    ``timeout_s`` has passed, and the actor is killed."""
    bound = 4
    plugin = cpu_plugin(1, timeout_s=bound,
                        init_hook=stall if where == "init_hook" else None)
    trainer = Trainer(plugins=[plugin], max_epochs=1, logger=False,
                      enable_checkpointing=False,
                      callbacks=[Stall()] if where == "fit_start" else [],
                      default_root_dir=str(tmp_path))
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=f"after {bound} s"):
        trainer.fit(BoringModel())
    assert bound <= time.monotonic() - t0 < RUN_TIMEOUT_S / 2
    assert get_backend()._actors == {}


def _refuse_to_load():
    raise RuntimeError("this object does not load here")


class Unreadable:
    """Pickles anywhere; unpickling it raises."""

    def __reduce__(self):
        return (_refuse_to_load, ())


def test_unreadable_result_fails_the_call():
    """A reply the driver cannot unpickle fails the call with a
    ``RemoteActorError`` instead of leaving it pending."""
    from ray_lightning_tpu_torch.cluster import RLTExecutor
    from ray_lightning_tpu_torch.util import process_results
    backend = get_backend()
    actor = backend.create_actor(RLTExecutor)
    try:
        with pytest.raises(RemoteActorError,
                           match="could not be read on the driver"):
            process_results([actor.call("execute", Unreadable)], backend,
                            timeout=RUN_TIMEOUT_S)
    finally:
        actor.kill()


def test_gpu_worker_without_cuda_fails_the_fit():
    """``use_gpu=True`` (the default) on a machine without CUDA: the
    worker raises its own error, the driver re-raises it; nothing trains
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    trainer = Trainer(plugins=[RayPlugin(num_workers=1,
                                         timeout_s=RUN_TIMEOUT_S)],
                      max_epochs=1, enable_checkpointing=False, logger=False)
    with pytest.raises(RemoteActorError, match="CUDA is not available"):
        trainer.fit(BoringModel())


# -- parity with the JAX package's DDP ----------------------------------------

def test_ddp_matches_jax_two_device_fit(tmp_path, monkeypatch):
    """``RayPlugin(num_workers=2, platform="cpu")`` at batch 2 a rank
    against the JAX ``Trainer`` with ``LocalPlugin("ddp", devices=jax.
    devices()[:2])`` at batch 4, the tiny GPT in fp32 (params and both
    moments) from the same weights: 2 epochs of 3 steps, losses within
    2e-5; as in
    tests/test_torch_bert.py's fits, each param tensor within 2e-5 in
    relative L2 (the k third of each qkv bias apart: its gradient is
    identically zero) and no entry more than 2 x lr x steps from the JAX
    one (ROADMAP.md F5: Adam turns the rounding of a near-zero gradient
    into steps of up to lr)."""
    import jax
    import jax.numpy as jnp

    from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
    from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
    from ray_lightning_tpu.models.gpt import GPT as JaxGPT
    from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
    from ray_lightning_tpu.models.gpt import GPTLightningModule as JaxModule
    from ray_lightning_tpu.plugins import LocalPlugin as JaxLocalPlugin
    from ray_lightning_tpu_torch.convert import flax_to_torch

    monkeypatch.setenv("RLT_BF16_PARAMS", "0")
    # an fp32 first moment too: the jitted JAX step keeps b1 * mu in fp32
    # where eager optax, and the port, round it to bf16 (ROADMAP.md F4)
    monkeypatch.setenv("RLT_BF16_MOMENTS", "0")
    jcfg = JaxConfig(**TINY, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda r: JaxGPT(jcfg).init(
        r, jnp.zeros((1, 8), jnp.int32))["params"], jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (np.full(x.shape, p[-1].key == "scale", np.float32)
                      if p[-1].key in ("scale", "bias") else
                      (rng.standard_normal(x.shape) * 0.02).astype(
                          np.float32)), shapes)

    class JaxFixed(JaxModule):
        def init_params(self, rng, batch):
            return {"params": jax.tree_util.tree_map(jnp.asarray, params)}

    class JaxLosses(JaxCallback):
        def __init__(self):
            self.losses = []

        def on_train_batch_end(self, trainer, module, outputs, batch, i):
            self.losses.append(float(outputs["loss"]))

    common = dict(max_epochs=2, limit_train_batches=3, limit_val_batches=1,
                  num_sanity_val_steps=0, seed=0, enable_checkpointing=False,
                  default_root_dir=str(tmp_path))
    kw = dict(lr=3e-3, warmup_steps=2, dataset_size=16)
    jrec = JaxLosses()
    jt = JaxTrainer(plugins=[JaxLocalPlugin(
        "ddp", devices=jax.devices()[:2])], callbacks=[jrec], logger=False,
        **common)
    jmod = JaxFixed(config=jcfg, batch_size=4, **kw)
    jt.fit(jmod)

    tt = Trainer(plugins=[cpu_plugin(2)], callbacks=[Losses()],
                 logger=False, **common)
    tmod = FixedGPT(flax_to_torch(params),
                    config=GPTConfig(**TINY, dtype=torch.float32),
                    batch_size=2, **kw)
    _, items = fit(tt, tmod)
    losses = relayed(items, "losses")
    assert losses[0] == losses[1] and len(losses[0]) == 6
    np.testing.assert_allclose(losses[0], jrec.losses, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tt.callback_metrics["val_loss"],
                               jt.callback_metrics["val_loss"], atol=2e-5,
                               rtol=2e-5)
    assert (tt.global_step, tt.current_epoch) == (jt.global_step,
                                                  jt.current_epoch) == (6, 2)
    want = flax_to_torch(jax.device_get(jmod._trained_variables["params"]))
    got = tmod._trained_state
    C = TINY["n_embd"]
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == torch.float32
        a, b = v.numpy().ravel(), want[k].numpy().ravel()
        assert np.abs(a - b).max() <= 2 * kw["lr"] * 6, k
        if k.endswith("attn.qkv.bias"):
            a, b = np.delete(a, np.s_[C:2 * C]), np.delete(b, np.s_[C:2 * C])
        assert np.linalg.norm(a - b) <= 2e-5 * np.linalg.norm(b), k


# -- ZeRO-1 against DDP, resume, checkpoints across world sizes ------------------

def _gpt_module(batch_size=2):
    return GPTLightningModule(GPTConfig(**TINY), lr=3e-3, warmup_steps=2,
                              batch_size=batch_size, dataset_size=16)


def _gpt_trainer(plugins, root, epochs, clip=None, callbacks=(), **kw):
    return Trainer(plugins=plugins, max_epochs=epochs, limit_val_batches=1,
                   num_sanity_val_steps=0, seed=0, gradient_clip_val=clip,
                   enable_checkpointing=False, logger=False,
                   default_root_dir=str(root), callbacks=list(callbacks),
                   **kw)


@pytest.fixture(scope="module")
def gpt_runs(tmp_path_factory):
    """2-worker fits of the tiny GPT (4 steps an epoch), each saving its
    end state, made on first use: ``(strategy, epochs, clip)``, and
    ``"resume"``, 1 more epoch of ZeRO-1 from ``("zero1", 1, None)``."""
    cache = {}

    def get(key):
        if key not in cache:
            root = tmp_path_factory.mktemp("gpt")
            end = str(root / "end.ckpt")
            if key == "resume":
                strategy, epochs, clip = "zero1", 2, None
                ckpt = get(("zero1", 1, None)).end
            else:
                (strategy, epochs, clip), ckpt = key, None
            trainer = _gpt_trainer(
                [cpu_plugin(2, strategy=strategy)], root, epochs, clip,
                callbacks=[Losses(), SaveAtEnd(end)])
            _, items = fit(trainer, _gpt_module(), ckpt_path=ckpt)
            cache[key] = types.SimpleNamespace(
                trainer=trainer, items=items, end=end,
                ckpt=Trainer.load_checkpoint_dict(end))
        return cache[key]

    return get


def _cloned(d: dict) -> dict:
    return {k: _cloned(v) if isinstance(v, dict)
            else v.clone() if torch.is_tensor(v) else v
            for k, v in d.items()}


def _flat(d, prefix=""):
    """A checkpoint's state as ``path -> value``."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_same_state(got: dict, want: dict, atol: float = 0.0):
    g, w = _flat(got["state"]), _flat(want["state"])
    assert set(g) == set(w)
    for k, v in w.items():
        if not torch.is_tensor(v):
            assert g[k] == v, k
            continue
        assert g[k].dtype == v.dtype, k
        if atol == 0:
            assert torch.equal(g[k], v), k
        else:
            torch.testing.assert_close(g[k].float(), v.float(), atol=atol,
                                       rtol=0, msg=k)


@pytest.mark.parametrize("clip", [None, 0.05])
def test_zero1_equals_ddp(clip, gpt_runs):
    """Without clipping ZeRO-1's end state (params, fp32 master, both
    moments, count) equals DDP's bit for bit; with a clip that triggers
    every step, within 1e-6 (ZeRO-1 sums the squares a shard at a time).
    The per-step losses are the same."""
    ddp, zero = gpt_runs(("ddp", 2, clip)), gpt_runs(("zero1", 2, clip))
    _assert_same_state(zero.ckpt, ddp.ckpt, atol=0.0 if clip is None
                       else 1e-6)
    assert relayed(zero.items, "losses") == relayed(ddp.items, "losses")
    assert (zero.ckpt["strategy"], ddp.ckpt["strategy"]) == ("zero1", "ddp")
    assert zero.ckpt["world_size"] == ddp.ckpt["world_size"] == 2


def test_zero1_rank_holds_a_shard_of_the_master(gpt_runs):
    """Each rank's fp32 master holds ceil(N / 2) of the N parameter
    elements; the optimizer's count and moments ride the same shard."""
    run = gpt_runs(("zero1", 2, None))
    n = sum(v.numel() for v in run.ckpt["state"]["params"].values())
    shards = relayed(run.items, "shards")
    assert shards[0] == shards[1] == [[-(-n // 2), n, 2]]
    assert relayed(run.items, "master") == {0: [-(-n // 2)],
                                            1: [-(-n // 2)]}


def test_zero1_resume_equals_the_uninterrupted_fit(gpt_runs):
    whole, resumed = gpt_runs(("zero1", 2, None)), gpt_runs("resume")
    _assert_same_state(resumed.ckpt, whole.ckpt)
    assert relayed(resumed.items, "losses")[0] == relayed(
        whole.items, "losses")[0][4:]
    assert (resumed.ckpt["epoch"], resumed.ckpt["global_step"]) == (2, 8)


def test_zero1_checkpoint_moves_between_world_sizes(gpt_runs, tmp_path):
    """The W=2 ZeRO-1 checkpoint restores bit for bit in a one-process
    ``Trainer`` (batch 4: the same global batch), whose next epoch's
    losses follow the W=2 fit's within 2e-2 (bf16); and a one-process
    ZeRO-1 checkpoint restores bit for bit in W=2 workers, each rank
    gathering its shards back into the single-device layout."""
    half = gpt_runs(("zero1", 1, None))
    whole = gpt_runs(("zero1", 2, None))
    restored = {}

    class Restored(Callback):
        def on_fit_start(self, trainer, module):
            # clones: the fit goes on to update the master in place
            restored["opt"] = _cloned(trainer.state.opt_state.state_dict())
            restored["params"] = {k: v.clone() for k, v in
                                  module.model.state_dict().items()}

    losses = Losses()
    one = _gpt_trainer(None, tmp_path / "one", 2, device="cpu",
                       callbacks=[Restored(), losses])
    one.fit(_gpt_module(batch_size=4), ckpt_path=half.end)
    _assert_same_state({"state": {"opt_state": restored["opt"],
                                  "params": restored["params"]}},
                       {"state": {k: half.ckpt["state"][k]
                                  for k in ("opt_state", "params")}})
    np.testing.assert_allclose(losses.losses,
                               relayed(whole.items, "losses")[0][4:],
                               atol=2e-2, rtol=2e-2)

    end = str(tmp_path / "one_end.ckpt")
    _gpt_trainer(None, tmp_path / "one1", 1, device="cpu", strategy="zero1",
                 callbacks=[SaveAtEnd(end)]).fit(_gpt_module(batch_size=4))
    trainer = _gpt_trainer([cpu_plugin(2, strategy="zero1")],
                           tmp_path / "two", 2,
                           callbacks=[SaveAtEnd(str(tmp_path / "x.ckpt"),
                                                relay_state=True)])
    _, items = fit(trainer, _gpt_module(), ckpt_path=end)
    want = Trainer.load_checkpoint_dict(end)
    _assert_same_state({"state": {"opt_state": relayed(items, "restored")[0][
        "opt"], "params": relayed(items, "restored")[0]["params"]}},
        {"state": {k: want["state"][k] for k in ("opt_state", "params")}})
