"""PyTorch/CUDA port, Tune trials that train in actor workers:
``RayPlugin`` / ``RayShardedPlugin`` with CPU workers on gloo
(``platform="cpu"``) inside ``tune.run``.

- a report relayed through the worker queue to the trial's thread (the
  reference's grandchild relay, tests/test_tune.py's
  ``test_tune_report_through_actor_queue``), and two trials on threads
  at once each receiving only their own workers' reports;
- a checkpoint relay under ``RayShardedPlugin(num_workers=2)``: every
  rank builds the checkpoint (ZeRO-1 gathers its shards), global zero
  sends it, and the trial's file equals the weights the driver gets
  back, bit for bit, with whole (gathered) moments;
- an ASHA stop and a PBT exploit, each raised inside the driver's drain
  while the workers run: the exception leaves ``Trainer.fit`` as it
  was raised, every worker of the sweep is gone, and a PBT restart
  begins at its donor checkpoint's ``global_step`` (the trials' first
  reports in lockstep, so the population exists before the worse trial
  can run out of iterations);
- a ``max_failures`` retry after a worker fails, resumed from the
  trial's last relayed checkpoint.

Workers unpickle this module's callbacks, modules and relayed items by
import path, so it imports no JAX.  Every run carries its bound
(``timeout_s``) and every barrier its timeout.
"""

import functools
import os
import threading
import time

import pytest
import torch

from ray_lightning_tpu_torch import (BoringModel, Callback,
                                     GPTLightningModule, RayPlugin,
                                     RayShardedPlugin, Trainer, session,
                                     tune)
from ray_lightning_tpu_torch.cluster import RemoteActorError, get_backend
from ray_lightning_tpu_torch.models.gpt import GPTConfig

#: a run's bound: the driver's wait for its workers and each collective
RUN_TIMEOUT_S = 90
#: tiny's widths, dot attention
TINY = dict(vocab_size=512, block_size=64, n_layer=2, n_head=2, n_embd=64,
            remat=False, attention_impl="dot")
FIT = dict(limit_train_batches=4, limit_val_batches=2,
           num_sanity_val_steps=0, enable_checkpointing=False, seed=0)

#: what the workers relayed, appended on the driver (in each trial's
#: thread) by ``_record``: (trial id, item)
RECORDS: list = []


def _record(item: dict) -> None:
    RECORDS.append((tune.get_trial_id(), item))


def records(key: str) -> list:
    return [(tid, it[key]) for tid, it in RECORDS if key in it]


@pytest.fixture(autouse=True)
def _clear_records():
    RECORDS.clear()
    yield
    RECORDS.clear()


def cpu_plugin(n: int, cls=RayPlugin, **kw):
    return cls(num_workers=n, platform="cpu", timeout_s=RUN_TIMEOUT_S, **kw)


def assert_workers_gone() -> None:
    for _, pid in records("pid"):
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    assert get_backend()._actors == {}


# -- worker-side helpers (module level: the workers import them) ------------

class Probe(Callback):
    """Relays, from global zero, the worker's pid, device and the
    ``global_step`` the fit starts at (after a restore); with
    ``epoch_s``, holds each epoch that long (keeps trials interleaved)."""

    def __init__(self, epoch_s: float = 0.0):
        self.epoch_s = epoch_s

    def on_fit_start(self, trainer, module):
        if trainer.is_global_zero:
            session.put_queue(functools.partial(_record, {
                "pid": os.getpid(), "device": str(trainer.device),
                "start_step": trainer.global_step}))

    def on_train_epoch_end(self, trainer, module):
        time.sleep(self.epoch_s)


class CrashAtEpoch(Callback):
    """Fails the rank at the start of epoch ``epoch``."""

    def __init__(self, epoch: int):
        self.epoch = epoch

    def on_train_epoch_start(self, trainer, module):
        if trainer.current_epoch == self.epoch:
            raise RuntimeError("worker crash at an epoch start")


class TaggedBoring(BoringModel):
    """``BoringModel`` whose validation also logs ``tag`` (its lr) and a
    ``level`` the test sets: metrics a sweep can tell apart."""

    def __init__(self, level: float = 0.0, **kw):
        super().__init__(**kw)
        self.level = level

    def validation_step(self, ctx, batch):
        super().validation_step(ctx, batch)
        ctx.log("tag", torch.tensor(self.lr))
        ctx.log("level", torch.tensor(self.level))


def _sweep_errors(fn):
    """``fn`` run as a trainable that records the type of whatever leaves
    its ``Trainer.fit``."""
    left = []

    @functools.wraps(fn)
    def trainable(config, checkpoint_dir=None):
        try:
            fn(config, checkpoint_dir)
        except BaseException as e:
            left.append(type(e).__name__)
            raise

    return trainable, left


# -- reports and checkpoints through the queue --------------------------------

def test_report_through_the_actor_queue(tmp_path):
    """Training in 2 workers: ``TuneReportCallback`` fires on rank 0, the
    report rides the queue and runs in the trial's thread."""

    def fn(config):
        trainer = Trainer(plugins=[cpu_plugin(2)], max_epochs=2,
                          callbacks=[Probe(), tune.TuneReportCallback(
                              on="validation_end")],
                          default_root_dir=tune.get_trial_dir(), **FIT)
        trainer.fit(BoringModel(lr=config["lr"]))

    analysis = tune.run(fn, config={"lr": 0.05}, metric="val_loss",
                        mode="min", stop={"training_iteration": 3},
                        local_dir=str(tmp_path))
    t = analysis.trials[0]
    assert t.status == "TERMINATED"
    assert [r["training_iteration"] for r in t.history] == [1, 2]
    assert "val_loss" in t.last_result
    assert [d for _, d in records("device")] == ["cpu"]
    assert_workers_gone()


def test_concurrent_actor_trials_keep_their_reports(tmp_path):
    """Two trials training in workers at the same time: each trial's
    reports carry its own lr, so no report reached another trial's
    thread."""

    def fn(config):
        trainer = Trainer(plugins=[cpu_plugin(1)], max_epochs=3,
                          callbacks=[Probe(epoch_s=0.2),
                                     tune.TuneReportCallback(
                                         on="validation_end")],
                          default_root_dir=tune.get_trial_dir(), **FIT)
        trainer.fit(TaggedBoring(lr=config["lr"]))

    analysis = tune.run(fn, config={"lr": tune.grid_search([0.05, 0.1])},
                        max_concurrent_trials=2, metric="val_loss",
                        stop={"training_iteration": 4},
                        local_dir=str(tmp_path))
    for t in analysis.trials:
        assert t.status == "TERMINATED"
        assert len(t.history) == 3
        assert all(r["tag"] == pytest.approx(t.config["lr"])
                   for r in t.history)
    assert_workers_gone()


def test_checkpoint_relay_under_zero1(tmp_path):
    """``TuneReportCheckpointCallback`` under ``RayShardedPlugin`` at
    W=2: both ranks build each checkpoint (a rank-0-only build would
    wait in the gather until the collective's bound), the relayed file
    of the last validation holds the weights the driver got back bit for
    bit, and whole moments."""
    modules = []

    def fn(config):
        trainer = Trainer(plugins=[cpu_plugin(2, RayShardedPlugin)],
                          max_epochs=2, callbacks=[
                              tune.TuneReportCheckpointCallback(
                                  on="validation_end")],
                          default_root_dir=tune.get_trial_dir(),
                          **{**FIT, "limit_val_batches": 1})
        module = GPTLightningModule(GPTConfig(**TINY), lr=3e-3,
                                    warmup_steps=2, batch_size=2,
                                    dataset_size=16)
        trainer.fit(module)
        modules.append(module)

    t0 = time.monotonic()
    analysis = tune.run(fn, config={}, metric="val_loss",
                        stop={"training_iteration": 3},
                        local_dir=str(tmp_path))
    assert time.monotonic() - t0 < RUN_TIMEOUT_S
    (trial,) = analysis.trials
    assert trial.status == "TERMINATED" and len(trial.history) == 2
    ckpt = Trainer.load_checkpoint_dict(
        os.path.join(trial.latest_checkpoint, "checkpoint"), "cpu")
    assert (ckpt["global_step"], ckpt["world_size"], ckpt["strategy"]) == (
        8, 2, "zero1")
    trained = modules[0]._trained_state
    saved = {**ckpt["state"]["params"], **ckpt["state"]["model_state"]}
    assert set(saved) == set(trained)
    for k, v in trained.items():
        assert saved[k].dtype == v.dtype and torch.equal(saved[k], v), k
    inner = ckpt["state"]["opt_state"]["inner"]
    for k, p in ckpt["state"]["params"].items():
        assert inner["mu"][k].shape == p.shape
        assert ckpt["state"]["opt_state"]["master"][k].shape == p.shape


# -- scheduler decisions raised inside the drain -----------------------------

def test_asha_stop_comes_out_of_the_fit_with_every_worker_gone(tmp_path):
    """ASHA stops the worse trial at its first rung: ``_StopTrial`` is
    raised by the report the driver's drain runs while the workers train,
    leaves ``Trainer.fit`` as raised, the actors are killed, and the next
    trial's rendezvous finds a free port."""

    def fit(config, checkpoint_dir):
        trainer = Trainer(plugins=[cpu_plugin(1)], max_epochs=20,
                          callbacks=[Probe(), tune.TuneReportCallback(
                              {"loss": "level"}, on="validation_end")],
                          default_root_dir=tune.get_trial_dir(), **FIT)
        trainer.fit(TaggedBoring(level=config["level"]))

    trainable, left = _sweep_errors(fit)
    analysis = tune.run(
        trainable, config={"level": tune.grid_search([0.0, 1.0])},
        scheduler=tune.ASHAScheduler(metric="loss", mode="min", max_t=4,
                                     grace_period=1, reduction_factor=2),
        stop={"training_iteration": 5}, local_dir=str(tmp_path))
    best, worse = analysis.trials
    assert best.status == worse.status == "TERMINATED"
    assert len(best.history) == 4 and len(worse.history) == 1
    assert left == ["_StopTrial", "_StopTrial"]
    assert len(records("pid")) == 2
    assert_workers_gone()


class LockstepPBT(tune.PopulationBasedTraining):
    """PBT whose trials each wait, after their first report is recorded
    and decided, until every trial of the population has made its first
    (bounded: past ``timeout_s`` the wait raises ``BrokenBarrierError``
    out of the report and fails the trial).  So the population exists
    before any trial's second report is decided, whatever the workers'
    start-up times: without it a trial whose worker started late could
    find the other trial's four reports all made and decided against a
    population of one, with nothing to exploit."""

    def __init__(self, population: int, timeout_s: float = 120, **kw):
        super().__init__(**kw)
        self._first = threading.Barrier(population, timeout=timeout_s)

    def on_result(self, trial, metrics: dict):
        decision = super().on_result(trial, metrics)
        if int(metrics.get("training_iteration", 0)) == 1:
            self._first.wait()
        return decision


def test_pbt_exploit_restarts_at_the_donor_step(tmp_path):
    """Two trials under PBT, each in a worker, relaying a checkpoint and
    a report each epoch, their first reports in lockstep
    (:class:`LockstepPBT`): the worse trial exploits, ``_ExploitTrial``
    leaves its fit, and its restarted fit begins at the donor
    checkpoint's ``global_step``; every worker is gone."""
    restores = []

    def fit(config, checkpoint_dir):
        ckpt = None
        if checkpoint_dir:
            ckpt = os.path.join(checkpoint_dir, "checkpoint")
            restores.append((tune.get_trial_id(), Trainer.load_checkpoint_dict(
                ckpt, "cpu")["global_step"]))
        trainer = Trainer(plugins=[cpu_plugin(1)], max_epochs=20,
                          callbacks=[Probe(),
                                     tune.TuneReportCheckpointCallback(
                                         on="validation_end")],
                          default_root_dir=tune.get_trial_dir(), **FIT)
        trainer.fit(BoringModel(lr=config["lr"]), ckpt_path=ckpt)

    trainable, left = _sweep_errors(fit)
    analysis = tune.run(
        trainable, config={"lr": tune.grid_search([0.1, 0.0])},
        scheduler=LockstepPBT(
            2, metric="val_loss", mode="min", perturbation_interval=1,
            hyperparam_mutations={"lr": [0.1, 0.05]}),
        stop={"training_iteration": 4}, local_dir=str(tmp_path))
    assert all(t.status == "TERMINATED" for t in analysis.trials)
    assert restores, "no exploit happened"
    assert "_ExploitTrial" in left
    starts = records("start_step")
    for tid, step in restores:
        later = [s for t, s in starts if t == tid]
        assert step in later[1:], (tid, step, later)
    for t in analysis.trials:
        assert [r["training_iteration"] for r in t.history] == [1, 2, 3, 4]
    assert_workers_gone()


# -- retries -----------------------------------------------------------------

def test_retry_resumes_from_the_relayed_checkpoint(tmp_path):
    """A worker fails at its second epoch's start; ``max_failures=1``
    retries the trial from the checkpoint its first epoch relayed, and
    the retried fit begins at that checkpoint's step."""
    attempts = []

    def fn(config, checkpoint_dir=None):
        attempts.append(checkpoint_dir)
        ckpt = (os.path.join(checkpoint_dir, "checkpoint")
                if checkpoint_dir else None)
        crash = [] if checkpoint_dir else [CrashAtEpoch(1)]
        trainer = Trainer(plugins=[cpu_plugin(1)], max_epochs=2,
                          callbacks=[Probe(), *crash,
                                     tune.TuneReportCheckpointCallback(
                                         on="validation_end")],
                          default_root_dir=tune.get_trial_dir(), **FIT)
        trainer.fit(BoringModel(), ckpt_path=ckpt)

    analysis = tune.run(fn, config={}, max_failures=1, metric="val_loss",
                        stop={"training_iteration": 4},
                        local_dir=str(tmp_path))
    (trial,) = analysis.trials
    assert trial.status == "TERMINATED"
    assert attempts[0] is None and attempts[1].endswith("checkpoint_000004")
    assert [s for _, s in records("start_step")] == [0, 4]
    # a resume reruns the epoch its checkpoint was saved in
    assert [r["training_iteration"] for r in trial.history] == [1, 2, 3]
    assert_workers_gone()


def test_failing_worker_fails_the_trial_with_its_error(tmp_path):
    """Without retries the worker's error fails the trial, carried as
    ``RemoteActorError``."""

    def fn(config):
        Trainer(plugins=[cpu_plugin(1)], max_epochs=2,
                callbacks=[CrashAtEpoch(0)], logger=False,
                default_root_dir=tune.get_trial_dir(), **FIT).fit(
                    BoringModel())

    analysis = tune.run(fn, config={}, local_dir=str(tmp_path),
                        raise_on_failed_trial=False)
    (trial,) = analysis.trials
    assert trial.status == "ERROR"
    assert RemoteActorError.__name__ in trial.error
    assert "worker crash at an epoch start" in trial.error
    assert get_backend()._actors == {}
