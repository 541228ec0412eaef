"""PyTorch/CUDA port, Tune in this process: ``tune.run``, the search
spaces, ASHA and PBT, the report and checkpoint callbacks, trial retries
and the GPU leases of in-process trials, against the JAX package's
``tune``.

- the behaviours of tests/test_tune.py: iteration counts, grid x
  samples, ``best_checkpoint``, ASHA stopping the worst trial, a PBT
  exploit, the resource bundles (in GPUs), retries (from the latest
  checkpoint, not of ``SystemExit``, exhausted), ``report`` outside a
  trial, an MNIST sweep that learns;
- its four tests over eight fake JAX devices, as leases of a patched
  list of visible cards (``runner._visible_devices``): disjoint leases
  for concurrent trials, one lease serializing trials, the warning about
  cards a lease size strands, a demand above the visible count failing
  its trial; and, unpatched, a trial whose ``"GPU"`` demand fails on a
  machine without CUDA instead of training on the CPU; an in-process
  ``Trainer`` given no device trains on its lease;
- parity: ``generate_variants`` gives the JAX package's configs for one
  space and seed (every domain, grid x samples, exactly); ASHA and PBT
  give its decisions, configs and donors on one scripted stream of
  results (exactly); a 2-trial ``BoringModel`` sweep reports its
  ``val_loss`` per iteration within 2e-5 (``atol = rtol``), from the
  same weights (``convert.flax_to_torch``).

The port's fits run with ``device="cpu"`` where no lease is under test.
Trials on worker processes are in tests/test_torch_tune_actors.py.
"""

import logging
import os
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu import tune as jax_tune
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.boring import BoringModel as JaxBoring
from ray_lightning_tpu.tune import schedulers as jax_schedulers
from ray_lightning_tpu.tune.search import \
    generate_variants as jax_generate_variants
from ray_lightning_tpu_torch import (BoringModel, Callback,
                                     LightningMNISTClassifier, Trainer, tune)
from ray_lightning_tpu_torch.convert import flax_to_torch
from ray_lightning_tpu_torch.tune import runner, schedulers
from ray_lightning_tpu_torch.tune.search import generate_variants
from ray_lightning_tpu_torch.tune.session import get_trial_devices

FP32 = 2e-5
#: every fit here: a few batches, no sanity pass, no checkpoint files
FIT = dict(limit_train_batches=4, limit_val_batches=2,
           num_sanity_val_steps=0, enable_checkpointing=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cards(n: int) -> list:
    return [torch.device("cuda", i) for i in range(n)]


def train_fn(config, checkpoint_dir=None, max_epochs=2):
    trainer = Trainer(max_epochs=max_epochs, device="cpu",
                      callbacks=[tune.TuneReportCallback(
                          on="validation_end")],
                      default_root_dir=tune.get_trial_dir(), **FIT)
    trainer.fit(BoringModel())


# -- tests/test_tune.py's behaviours ----------------------------------------

def test_tune_iteration_counts(tmp_path, seed):
    """Each trial reports exactly max_epochs iterations, in its own
    directory (per-trial isolation)."""
    analysis = tune.run(train_fn, config={"lr": tune.loguniform(1e-4, 1e-1)},
                        num_samples=2, metric="val_loss", mode="min",
                        local_dir=str(tmp_path))
    assert len(analysis.trials) == 2
    for t in analysis.trials:
        assert t.status == "TERMINATED"
        assert t.last_result["training_iteration"] == 2
        assert os.path.isfile(os.path.join(t.logdir, "logs",
                                           "metrics.csv"))


def test_tune_grid_and_samples(tmp_path):
    reported = []

    def fn(config):
        reported.append(config["a"])
        tune.report(loss=float(config["a"]))

    analysis = tune.run(fn, config={"a": tune.grid_search([1, 2, 3])},
                        num_samples=2, metric="loss", mode="min",
                        local_dir=str(tmp_path))
    assert sorted(reported) == [1, 1, 2, 2, 3, 3]
    assert analysis.best_trial.config["a"] == 1


def test_tune_checkpointing(tmp_path, seed):
    """``best_checkpoint`` exists and loads: the relayed bytes are
    ``save_checkpoint``'s, at the trial's last step."""

    def fn(config):
        trainer = Trainer(max_epochs=2, device="cpu",
                          callbacks=[tune.TuneReportCheckpointCallback(
                              on="validation_end")],
                          default_root_dir=tune.get_trial_dir(), **FIT)
        trainer.fit(BoringModel(lr=config["lr"]))
        trainer.save_checkpoint(os.path.join(tune.get_trial_dir(),
                                             "saved.ckpt"))

    analysis = tune.run(fn, config={"lr": tune.choice([0.05, 0.1])},
                        num_samples=2, metric="val_loss", mode="min",
                        local_dir=str(tmp_path))
    best = analysis.best_checkpoint
    assert best is not None and os.path.isdir(best)
    assert best.endswith("checkpoint_000008")
    ckpt = Trainer.load_checkpoint_dict(os.path.join(best, "checkpoint"))
    assert ckpt["global_step"] == 8 and "state" in ckpt
    saved = Trainer.load_checkpoint_dict(os.path.join(
        analysis.best_trial.logdir, "saved.ckpt"))
    for k, v in saved["state"]["params"].items():
        assert torch.equal(ckpt["state"]["params"][k], v)


def test_tune_asha_stops_bad_trials(tmp_path):
    iters = {}

    def fn(config):
        for i in range(16):
            iters[config["level"]] = i + 1
            tune.report(loss=float(config["level"]))

    tune.run(fn, config={"level": tune.grid_search([0.0, 1.0, 2.0, 3.0])},
             scheduler=tune.ASHAScheduler(metric="loss", mode="min",
                                          max_t=16, grace_period=2,
                                          reduction_factor=2),
             local_dir=str(tmp_path))
    assert iters[0.0] == 16
    assert iters[3.0] < 16


def test_tune_pbt_exploits(tmp_path):
    """A bottom-quantile trial restarts from a donor's checkpoint."""
    restores = []
    barrier = threading.Barrier(2, timeout=30)

    def fn(config, checkpoint_dir=None):
        start = 0.0
        if checkpoint_dir:
            restores.append(checkpoint_dir)
            with open(os.path.join(checkpoint_dir, "v.txt")) as f:
                start = float(f.read())
        else:
            # the population must coexist before either races ahead
            try:
                barrier.wait()
            except threading.BrokenBarrierError:
                pass
        score = start
        for step in range(1, 9):
            time.sleep(0.02)     # keep the population interleaved
            score += config["rate"]
            with tune.checkpoint_dir(step) as d:
                with open(os.path.join(d, "v.txt"), "w") as f:
                    f.write(str(score))
            tune.report(score=score)

    analysis = tune.run(
        fn, config={"rate": tune.grid_search([0.01, 1.0])},
        scheduler=tune.PopulationBasedTraining(
            metric="score", mode="max", perturbation_interval=2,
            hyperparam_mutations={"rate": [0.01, 1.0]}),
        local_dir=str(tmp_path))
    assert restores, "no exploit happened"
    best = analysis.get_best_trial("score", "max")
    assert best.last_result["score"] > 1.0


def test_stop_ends_a_trial_that_pbt_keeps_at_the_bottom(tmp_path):
    """A trial that each exploit leaves at the bottom (its donor done,
    its own score tied with the donor's checkpoint) ends at the ``stop``
    iteration: the stop comes before the exploit, as in ray.tune (the
    trainable gives up after 3N calls instead of restarting for ever)."""
    N = 4
    calls: dict = {}

    def fn(config, checkpoint_dir=None):
        tid = tune.get_trial_id()
        calls[tid] = calls.get(tid, 0) + 1
        if calls[tid] > 3 * N:
            raise SystemExit("restarted without end")   # not retried
        score = 0.0
        if checkpoint_dir:
            with open(os.path.join(checkpoint_dir, "v.txt")) as f:
                score = float(f.read())
        for step in range(1, 2 * N):
            score += config["rate"]
            with tune.checkpoint_dir(step) as d:
                with open(os.path.join(d, "v.txt"), "w") as f:
                    f.write(str(score))
            tune.report(score=score)

    analysis = tune.run(
        fn, config={"rate": tune.grid_search([1.0, 0.0])},
        max_concurrent_trials=1, stop={"training_iteration": N},
        scheduler=tune.PopulationBasedTraining(
            metric="score", mode="max", perturbation_interval=1,
            hyperparam_mutations={"rate": [0.0]}),
        local_dir=str(tmp_path), raise_on_failed_trial=False)
    for t in analysis.trials:
        assert t.status == "TERMINATED", t.error
        assert [r["training_iteration"] for r in t.history] == [1, 2, 3, 4]
    assert calls == {"trial_00000": 1, "trial_00001": N}


def test_get_tune_resources_bundles():
    res = tune.get_tune_resources(num_workers=4, num_cpus_per_worker=2,
                                  use_gpu=True, gpus_per_worker=2)
    assert len(res.bundles) == 5          # head + 4 workers
    assert res.bundles[0] == {"CPU": 1}   # the trial driver (tune.py:50-53)
    assert res.bundles[1] == {"CPU": 2, "GPU": 2}
    assert res.strategy == "PACK"
    assert tune.get_tune_resources(num_workers=2).bundles[1] == {"CPU": 1}


def test_get_tune_resources_override_precedence():
    res = tune.get_tune_resources(
        num_workers=2, num_cpus_per_worker=8,
        resources_per_worker={"CPU": 3, "GPU": 2, "extra": 1})
    assert res.bundles[1] == {"CPU": 3, "extra": 1, "GPU": 2}
    off = tune.get_tune_resources(num_workers=1, use_gpu=True,
                                  resources_per_worker={"GPU": 0})
    assert off.bundles[1] == {"CPU": 1}


def test_get_tune_resources_deprecated_shim():
    with pytest.warns(DeprecationWarning):
        res = tune.get_tune_resources(num_workers=1, cpus_per_worker=5)
    assert res.bundles[1]["CPU"] == 5


def test_trial_device_demand_counts_gpus():
    demand = runner._trial_device_demand
    assert demand(tune.get_tune_resources(num_workers=3, use_gpu=True,
                                          gpus_per_worker=2)) == 6
    assert demand(tune.get_tune_resources(num_workers=3)) is None
    assert demand({"GPU": 4}) == 4
    assert demand({"CPU": 4}) is None and demand(None) is None


def test_concurrent_trials_get_disjoint_leases(tmp_path, monkeypatch):
    """Two trials holding their leases at the same time (a barrier shows
    it) hold disjoint halves of eight cards when each asks for four."""
    monkeypatch.setattr(runner, "_visible_devices", lambda: cards(8))
    barrier = threading.Barrier(2, timeout=60)
    seen = {}

    def fn(config):
        seen[config["tag"]] = [str(d) for d in get_trial_devices()]
        barrier.wait()
        tune.report(loss=1.0)

    analysis = tune.run(
        fn, config={"tag": tune.grid_search([0, 1])},
        resources_per_trial=tune.get_tune_resources(
            num_workers=1, use_gpu=True, gpus_per_worker=4),
        max_concurrent_trials=2, local_dir=str(tmp_path))
    halves = [{f"cuda:{i}" for i in range(4)},
              {f"cuda:{i}" for i in range(4, 8)}]
    assert sorted(map(set, seen.values()), key=sorted) == halves
    for t in analysis.trials:
        assert t.leased_devices == seen[t.config["tag"]]


def test_one_lease_serializes_trials(tmp_path, monkeypatch):
    """Trials that each ask for all eight cards cannot overlap, even at
    max_concurrent_trials=2: the lease is held from the first ask to the
    trial's end."""
    monkeypatch.setattr(runner, "_visible_devices", lambda: cards(8))
    intervals = {}

    def fn(config):
        get_trial_devices()
        t0 = time.monotonic()
        time.sleep(0.1)      # widen the window an overlap would show in
        tune.report(loss=1.0)
        intervals[config["tag"]] = (t0, time.monotonic())

    tune.run(fn, config={"tag": tune.grid_search([0, 1])},
             resources_per_trial={"GPU": 8}, max_concurrent_trials=2,
             local_dir=str(tmp_path))
    (a0, a1), (b0, b1) = intervals[0], intervals[1]
    assert a1 <= b0 or b1 <= a0, "whole-machine trials overlapped"


def test_stranded_cards_warn(tmp_path, monkeypatch, caplog):
    """Leases of three over eight cards: two leases, and a warning that
    names the two cards left idle."""
    monkeypatch.setattr(runner, "_visible_devices", lambda: cards(8))
    seen = []

    def fn(config):
        seen.append(tuple(str(d) for d in get_trial_devices()))
        tune.report(loss=1.0)

    with caplog.at_level(logging.WARNING, logger=runner.__name__):
        tune.run(fn, config={"tag": tune.grid_search([0, 1, 2])},
                 resources_per_trial={"GPU": 3}, max_concurrent_trials=3,
                 local_dir=str(tmp_path))
    assert "2 GPU(s) (cuda:6, cuda:7) will sit idle" in caplog.text
    assert set(seen) <= {("cuda:0", "cuda:1", "cuda:2"),
                         ("cuda:3", "cuda:4", "cuda:5")}
    assert len(seen) == 3


def test_trial_demand_exceeding_cards_errors(tmp_path, monkeypatch):
    """A trial asking for more cards than are visible fails with a clear
    error, raised in the trial when its fit takes the lease."""
    monkeypatch.setattr(runner, "_visible_devices", lambda: cards(8))
    fits = []

    class Started(Callback):
        def on_fit_start(self, trainer, module):
            fits.append(trainer.device)

    def fn(config):
        Trainer(max_epochs=1, callbacks=[Started()], logger=False,
                **FIT).fit(BoringModel(batch_size=8))

    analysis = tune.run(fn, config={}, resources_per_trial={"GPU": 16},
                        local_dir=str(tmp_path),
                        raise_on_failed_trial=False)
    (trial,) = analysis.trials
    assert trial.status == "ERROR"
    assert "wants 16 GPUs but only 8 are visible" in trial.error
    assert fits == []


def test_gpu_trial_without_cuda_fails_instead_of_training(tmp_path):
    """Without a card: an in-process trial whose resources ask for a GPU
    fails with the leaser's error and never trains on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    fits = []

    class Started(Callback):
        def on_fit_start(self, trainer, module):
            fits.append(trainer.device)

    def fn(config):
        Trainer(max_epochs=1, callbacks=[Started()], logger=False,
                **FIT).fit(BoringModel())

    analysis = tune.run(
        fn, config={}, local_dir=str(tmp_path), raise_on_failed_trial=False,
        resources_per_trial=tune.get_tune_resources(num_workers=1,
                                                    use_gpu=True))
    (trial,) = analysis.trials
    assert trial.status == "ERROR" and fits == []
    assert "wants 1 GPUs but only 0 are visible" in trial.error
    assert trial.leased_devices == []


def test_in_process_trainer_trains_on_its_lease(tmp_path, monkeypatch):
    """A ``Trainer`` given no device in a trial that declares a GPU takes
    the lease's device when its fit starts (here the one "card" is the
    CPU); two such trials at max_concurrent_trials=2 train one after the
    other."""
    monkeypatch.setattr(runner, "_visible_devices",
                        lambda: [torch.device("cpu")])
    spans, devices = {}, {}

    class Span(Callback):
        def on_train_start(self, trainer, module):
            self.t0 = time.monotonic()

        def on_train_end(self, trainer, module):
            time.sleep(0.05)
            spans[trainer.lightning_module.lr] = (self.t0, time.monotonic())

    def fn(config):
        trainer = Trainer(max_epochs=1, callbacks=[
            Span(), tune.TuneReportCallback(on="train_epoch_end")],
            default_root_dir=tune.get_trial_dir(), **FIT)
        assert trainer.device is None       # taken when the fit starts
        trainer.fit(BoringModel(lr=config["lr"]))
        devices[config["lr"]] = trainer.device

    analysis = tune.run(
        fn, config={"lr": tune.grid_search([0.05, 0.1])},
        resources_per_trial=tune.get_tune_resources(num_workers=1,
                                                    use_gpu=True),
        max_concurrent_trials=2, local_dir=str(tmp_path))
    assert all(t.status == "TERMINATED" for t in analysis.trials)
    assert all(t.leased_devices == ["cpu"] for t in analysis.trials)
    assert set(devices.values()) == {torch.device("cpu")}
    (a0, a1), (b0, b1) = spans.values()
    assert a1 <= b0 or b1 <= a0


def test_trial_retry_on_failure(tmp_path):
    attempts = {"n": 0}

    def fn(config):
        attempts["n"] += 1
        if attempts["n"] == 1:
            raise RuntimeError("flaky init")
        tune.report(loss=1.0)

    analysis = tune.run(fn, config={}, max_failures=1, metric="loss",
                        mode="min", local_dir=str(tmp_path))
    (trial,) = analysis.trials
    assert trial.status == "TERMINATED"
    assert attempts["n"] == 2
    assert trial.last_result["loss"] == 1.0


def test_trial_retry_resumes_from_checkpoint(tmp_path):
    attempts = {"n": 0}

    def fn(config, checkpoint_dir=None):
        attempts["n"] += 1
        start = 0
        if checkpoint_dir:
            with open(os.path.join(checkpoint_dir, "v.txt")) as f:
                start = int(f.read())
        for step in range(start + 1, 7):
            with tune.checkpoint_dir(step) as d:
                with open(os.path.join(d, "v.txt"), "w") as f:
                    f.write(str(step))
            tune.report(progress=step)
            if attempts["n"] == 1 and step == 3:
                raise RuntimeError("mid-training crash")

    analysis = tune.run(fn, config={}, max_failures=2, metric="progress",
                        mode="max", local_dir=str(tmp_path))
    (trial,) = analysis.trials
    assert trial.status == "TERMINATED"
    assert attempts["n"] == 2
    assert trial.last_result["progress"] == 6
    assert [r["progress"] for r in trial.history] == [1, 2, 3, 4, 5, 6]


def test_trial_retry_skips_deliberate_exits(tmp_path):
    attempts = {"n": 0}

    def fn(config):
        attempts["n"] += 1
        raise SystemExit(1)

    analysis = tune.run(fn, config={}, max_failures=3,
                        local_dir=str(tmp_path), raise_on_failed_trial=False)
    assert analysis.trials[0].status == "ERROR"
    assert attempts["n"] == 1


def test_trial_retries_exhausted(tmp_path):
    attempts = {"n": 0}

    def fn(config):
        attempts["n"] += 1
        raise RuntimeError("always broken")

    analysis = tune.run(fn, config={}, max_failures=2,
                        local_dir=str(tmp_path), raise_on_failed_trial=False)
    (trial,) = analysis.trials
    assert trial.status == "ERROR"
    assert attempts["n"] == 3          # the first try and 2 retries
    assert "always broken" in trial.error
    with pytest.raises(RuntimeError, match="1 trial"):
        tune.run(fn, config={}, local_dir=str(tmp_path))


def test_report_outside_trial_raises():
    with pytest.raises(RuntimeError):
        tune.report(loss=1.0)
    with pytest.raises(RuntimeError):
        with tune.checkpoint_dir(1):
            pass
    assert tune.get_trial_dir() is None
    assert tune.get_trial_id() == "default"


def test_tune_mnist_learns(tmp_path, seed):
    """A short MNIST sweep finds a config with accuracy well above
    chance (the example's tune_mnist)."""

    def fn(config):
        trainer = Trainer(max_epochs=2, limit_train_batches=8,
                          limit_val_batches=4, num_sanity_val_steps=0,
                          enable_checkpointing=False, device="cpu",
                          default_root_dir=tune.get_trial_dir(),
                          callbacks=[tune.TuneReportCallback(
                              {"acc": "ptl/val_accuracy"},
                              on="validation_end")])
        trainer.fit(LightningMNISTClassifier(config))

    analysis = tune.run(fn, config={"lr": tune.choice([1e-2, 1e-3]),
                                    "batch_size": 32},
                        num_samples=2, metric="acc", mode="max",
                        local_dir=str(tmp_path))
    assert analysis.best_result["acc"] > 0.3


def test_tune_exposes_the_jax_names_without_the_planes():
    assert set(jax_tune.__all__) <= set(tune.__all__)
    assert tune.TUNE_INSTALLED is True
    from ray_lightning_tpu_torch.tune import session
    # the compile-cache and planner hooks are ported
    # (tests/test_torch_compile_cache.py, tests/test_torch_plan.py); the
    # telemetry plane's are not (ROADMAP.md queue 1 item 13)
    for name in ("get_compile_cache_dir", "note_plan_report"):
        assert hasattr(session, name)
    trial = runner.Trial("t", {}, "/nowhere")
    assert trial.plan_report is None
    for name in ("metrics_url", "telemetry_dir"):
        assert not hasattr(trial, name)


# -- parity with the JAX package -------------------------------------------

def _space(pkg):
    return {"layer_1": pkg.choice([32, 64, 128]),
            "lr": pkg.loguniform(1e-4, 1e-1),
            "momentum": pkg.uniform(0.1, 0.9),
            "width": pkg.randint(8, 64),
            "act": pkg.grid_search(["relu", "gelu"]),
            "depth": pkg.grid_search([1, 2, 3]),
            "fixed": 7}


@pytest.mark.parametrize("num_samples,seed_", [(1, 0), (3, 0), (4, 123)])
def test_generate_variants_match_jax(num_samples, seed_):
    got = generate_variants(_space(tune), num_samples, seed_)
    want = jax_generate_variants(_space(jax_tune), num_samples, seed_)
    assert len(got) == 6 * num_samples
    assert got == want


def _replay(sched, trials, stream):
    """Feed ``stream`` (trial index, iteration, score) to ``sched`` as
    the runner does: a stopped trial reports no more, an exploit takes
    the donor's perturbed config and checkpoint.  The decisions."""
    out, stopped = [], set()
    for i, it, score in stream:
        if i in stopped:
            continue
        t = trials[i]
        t.latest_checkpoint = f"ckpt/{t.trial_id}/{it}"
        d = sched.on_result(t, {"training_iteration": it, "m": score})
        out.append((d.action, d.config, d.checkpoint))
        if d.action == "STOP":
            stopped.add(i)
        elif d.action == "EXPLOIT":
            t.config, t.latest_checkpoint = dict(d.config), d.checkpoint
    return out


def _trials(n, config=None):
    return [types.SimpleNamespace(trial_id=f"trial_{i:05d}",
                                  config=dict(config or {"i": i}),
                                  latest_checkpoint=None)
            for i in range(n)]


@pytest.mark.parametrize("mode,rf", [("min", 2), ("max", 3)])
def test_asha_decisions_match_jax(mode, rf):
    rng = np.random.default_rng(7)
    stream = [(i, it, float(rng.normal()))
              for it in range(1, 17) for i in rng.permutation(6)]
    got = _replay(schedulers.ASHAScheduler("m", mode, max_t=16,
                                           grace_period=1,
                                           reduction_factor=rf),
                  _trials(6), stream)
    want = _replay(jax_schedulers.ASHAScheduler("m", mode, max_t=16,
                                                grace_period=1,
                                                reduction_factor=rf),
                   _trials(6), stream)
    assert got == want
    assert {a for a, *_ in got} == {"CONTINUE", "STOP"}


def test_pbt_decisions_match_jax():
    rng = np.random.default_rng(3)
    stream = [(i, it, float(rng.normal()))
              for it in range(1, 9) for i in rng.permutation(4)]
    config = {"lr": 1e-3, "batch_size": 64, "wd": 0.1, "tag": "x"}

    def pbt(pkg, sched_mod):
        return sched_mod.PopulationBasedTraining(
            "m", "max", perturbation_interval=2, quantile_fraction=0.25,
            seed=11, hyperparam_mutations={
                "lr": pkg.loguniform(1e-4, 1e-1),
                "batch_size": [32, 64, 128], "wd": None,
                "tag": lambda: "y"})

    got = _replay(pbt(tune, schedulers), _trials(4, config), stream)
    want = _replay(pbt(jax_tune, jax_schedulers), _trials(4, config),
                   stream)
    assert got == want
    assert sum(a == "EXPLOIT" for a, *_ in got) >= 2


def _dense_params(sizes, seed=1):
    """Seeded flax ``Dense_{i}`` params."""
    rng = np.random.default_rng(seed)
    return {f"Dense_{i}": {
        "kernel": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(
            np.float32),
        "bias": (rng.standard_normal(b) * 0.1).astype(np.float32)}
        for i, (a, b) in enumerate(zip(sizes, sizes[1:]))}


PARAMS = _dense_params((32, 2))


class JaxFixedBoring(JaxBoring):
    def init_params(self, rng, batch):
        return {"params": jax.tree_util.tree_map(jnp.asarray, PARAMS)}


class FixedBoring(BoringModel):
    def init_params(self, generator):
        self.setup_model(generator.device)
        self.model.load_state_dict(flax_to_torch(PARAMS))
        return self.model.state_dict()


def test_boring_sweep_reports_match_jax(tmp_path):
    """A 2-trial grid over lr, ``TuneReportCallback`` at each of 2
    epochs' validations: the same iterations and ``val_loss`` in both
    packages, within 2e-5, from the same weights."""

    def sweep(pkg, trainer_cls, module_cls, extra, root):
        def fn(config):
            trainer = trainer_cls(
                max_epochs=2, seed=0, callbacks=[pkg.TuneReportCallback(
                    "val_loss", on="validation_end")],
                default_root_dir=pkg.get_trial_dir(), **FIT, **extra)
            trainer.fit(module_cls(lr=config["lr"]))

        analysis = pkg.run(fn, config={"lr": pkg.grid_search([0.05, 0.2])},
                           metric="val_loss", mode="min",
                           local_dir=str(root))
        return [[(r["training_iteration"], r["val_loss"])
                 for r in t.history] for t in analysis.trials]

    want = sweep(jax_tune, JaxTrainer, JaxFixedBoring, dict(logger=False),
                 tmp_path / "jax")
    got = sweep(tune, Trainer, FixedBoring, dict(device="cpu"),
                tmp_path / "torch")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert [i for i, _ in g] == [i for i, _ in w] == [1, 2]
        np.testing.assert_allclose([v for _, v in g], [v for _, v in w],
                                   atol=FP32, rtol=FP32)
    assert got[0] != got[1]          # the two lrs train differently
