"""PyTorch/CUDA port, the bridge to a live Ray Tune / Train session: the
Tune callbacks deliver into it when one is live, as the JAX package's do
(tests/test_ray_tune_bridge.py, the same 15 behaviours).

Ray is not installed here, so each API generation is a stub module with
exactly the surface the bridge binds: classic
``ray.tune.is_session_enabled`` / ``report`` / ``checkpoint_dir`` (the
reference's own calls, ``tune.py:130-134, 161-178``), the public
``ray.tune.get_context()`` with ``tune.report(metrics,
checkpoint=...)``, the Train API's ``ray.train.report(metrics,
checkpoint=...)`` through its private session, and a mid-generation Ray
whose ``tune.report`` is still keyword-only.  A relayed checkpoint is
the port's ``torch.save`` stream (``Trainer.serialize_checkpoint``).
The two actor cases run 2 CPU workers on gloo, bounded by ``timeout_s``.
"""

import contextlib
import os
import sys
import types

import pytest
import torch

from ray_lightning_tpu_torch import BoringModel, RayPlugin, Trainer, tune
from ray_lightning_tpu_torch.utils.states import load_state_stream


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fit(callback, **trainer_kwargs):
    trainer_kwargs.setdefault("device", "cpu")
    if "plugins" in trainer_kwargs:
        del trainer_kwargs["device"]
    module = BoringModel()
    trainer = Trainer(
        max_epochs=2, limit_train_batches=4, limit_val_batches=2,
        num_sanity_val_steps=0, enable_checkpointing=False, logger=False,
        seed=0, callbacks=[callback], **trainer_kwargs)
    trainer.fit(module)
    return trainer


def _actor_plugin():
    return RayPlugin(num_workers=2, platform="cpu", timeout_s=90)


@pytest.fixture
def classic_session(monkeypatch, tmp_path):
    """Stub of Ray's classic function-trainable session: live
    ``is_session_enabled``, recording ``report``/``checkpoint_dir``."""
    state = {"reports": [], "ckpt_dirs": []}
    ray = types.ModuleType("ray")
    tune_mod = types.ModuleType("ray.tune")
    tune_mod.is_session_enabled = lambda: True

    def report(**metrics):
        state["reports"].append(metrics)

    @contextlib.contextmanager
    def checkpoint_dir(step):
        d = tmp_path / f"checkpoint_{step:06d}"
        d.mkdir(parents=True, exist_ok=True)
        state["ckpt_dirs"].append(str(d))
        yield str(d)

    tune_mod.report = report
    tune_mod.checkpoint_dir = checkpoint_dir
    ray.tune = tune_mod
    monkeypatch.setitem(sys.modules, "ray", ray)
    monkeypatch.setitem(sys.modules, "ray.tune", tune_mod)
    return state


@pytest.fixture
def modern_session(monkeypatch):
    """Stub of the modern Ray Train API: a live internal session,
    ``train.report(metrics, checkpoint=...)`` and ``Checkpoint``."""
    state = {"reports": []}
    ray = types.ModuleType("ray")
    train_mod = types.ModuleType("ray.train")
    internal = types.ModuleType("ray.train._internal")
    session_mod = types.ModuleType("ray.train._internal.session")
    session_mod.get_session = lambda: object()

    class Checkpoint:
        def __init__(self, path):
            self.path = path

        @classmethod
        def from_directory(cls, path):
            return cls(path)

    def report(metrics, checkpoint=None):
        files = {}
        if checkpoint is not None:
            # snapshot before the bridge reclaims the staging dir
            for name in os.listdir(checkpoint.path):
                with open(os.path.join(checkpoint.path, name), "rb") as f:
                    files[name] = f.read()
        state["reports"].append({"metrics": metrics, "files": files})

    train_mod.report = report
    train_mod.Checkpoint = Checkpoint
    ray.train = train_mod
    for name, mod in [("ray", ray), ("ray.train", train_mod),
                      ("ray.train._internal", internal),
                      ("ray.train._internal.session", session_mod)]:
        monkeypatch.setitem(sys.modules, name, mod)
    return state


@pytest.fixture
def context_session(monkeypatch):
    """Stub of the PUBLIC context API generation (newer ray):
    ``tune.get_context()`` with a live trial id, ``tune.report(metrics,
    checkpoint=...)`` positional-dict signature, ``tune.Checkpoint``.
    No ``is_session_enabled`` and no ``ray.train._internal`` — the
    generation where both older surfaces are gone."""
    state = {"reports": []}
    ray = types.ModuleType("ray")
    tune_mod = types.ModuleType("ray.tune")

    class _Ctx:
        def get_trial_id(self):
            return "trial_0001"

    tune_mod.get_context = lambda: _Ctx()

    class Checkpoint:
        def __init__(self, path):
            self.path = path

        @classmethod
        def from_directory(cls, path):
            return cls(path)

    def report(metrics, checkpoint=None):
        files = {}
        if checkpoint is not None:
            for name in os.listdir(checkpoint.path):
                with open(os.path.join(checkpoint.path, name), "rb") as f:
                    files[name] = f.read()
        state["reports"].append({"metrics": metrics, "files": files})

    tune_mod.report = report
    tune_mod.Checkpoint = Checkpoint
    ray.tune = tune_mod
    monkeypatch.setitem(sys.modules, "ray", ray)
    monkeypatch.setitem(sys.modules, "ray.tune", tune_mod)
    return state


def test_classic_report_lands_in_ray_session(classic_session):
    _fit(tune.TuneReportCallback(on="validation_end"))
    assert len(classic_session["reports"]) == 2
    for r in classic_session["reports"]:
        assert "val_loss" in r


def test_classic_checkpoint_then_report(classic_session):
    """TuneReportCheckpointCallback inside a (stubbed) genuine Ray Tune
    trial records both the checkpoint and the metric, checkpoint first
    so Tune associates it with the reported iteration."""
    _fit(tune.TuneReportCheckpointCallback(on="validation_end"))
    assert len(classic_session["reports"]) == 2
    assert len(classic_session["ckpt_dirs"]) == 2
    for d in classic_session["ckpt_dirs"]:
        path = os.path.join(d, "checkpoint")
        assert os.path.isfile(path)
    ckpt = Trainer.load_checkpoint_dict(path)
    assert ckpt["global_step"] > 0 and "state" in ckpt


def test_modern_report_attaches_staged_checkpoint(modern_session):
    """Under the modern Train API a checkpoint can only ride a report:
    the staged blob must arrive attached to the next report, and the
    staging dir must be reclaimed."""
    _fit(tune.TuneReportCheckpointCallback(on="validation_end"))
    reports = modern_session["reports"]
    assert len(reports) == 2
    for r in reports:
        assert "val_loss" in r["metrics"]
        blob = r["files"]["checkpoint"]
        ckpt = load_state_stream(blob)
        assert ckpt["global_step"] > 0 and "state" in ckpt


def test_modern_plain_report_without_checkpoint(modern_session):
    _fit(tune.TuneReportCallback(on="validation_end"))
    reports = modern_session["reports"]
    assert len(reports) == 2
    assert all(r["files"] == {} for r in reports)


def test_context_report_lands_in_public_api(context_session):
    """The public get_context() generation delivers reports — the leg
    that keeps working when a release drops both is_session_enabled and
    ray.train._internal."""
    _fit(tune.TuneReportCallback(on="validation_end"))
    reports = context_session["reports"]
    assert len(reports) == 2
    for r in reports:
        assert "val_loss" in r["metrics"]
        assert r["files"] == {}


def test_context_report_attaches_staged_checkpoint(context_session):
    _fit(tune.TuneReportCheckpointCallback(on="validation_end"))
    reports = context_session["reports"]
    assert len(reports) == 2
    for r in reports:
        blob = r["files"]["checkpoint"]
        ckpt = load_state_stream(blob)
        assert ckpt["global_step"] > 0 and "state" in ckpt


def test_probe_order_classic_beats_context(classic_session, monkeypatch):
    """Transitional Ray versions expose BOTH is_session_enabled and
    get_context: the classic leg (the reference's own surface) must win,
    and the context report signature must never be hit."""
    tune_mod = sys.modules["ray.tune"]

    class _Ctx:
        def get_trial_id(self):
            return "trial_0001"

    hits = {"context": 0}
    real_report = tune_mod.report

    def guarded_report(*args, **kwargs):
        if args:  # positional dict = context-generation signature
            hits["context"] += 1
        return real_report(*args, **kwargs)

    monkeypatch.setattr(tune_mod, "get_context", lambda: _Ctx(),
                        raising=False)
    monkeypatch.setattr(tune_mod, "report", guarded_report)
    _fit(tune.TuneReportCallback(on="validation_end"))
    assert len(classic_session["reports"]) == 2
    assert hits["context"] == 0


def test_probe_order_context_beats_private_session(context_session,
                                                   monkeypatch):
    """When both the public context and the private train session exist,
    the PUBLIC surface must be used (the private one may vanish)."""
    internal = types.ModuleType("ray.train._internal")
    session_mod = types.ModuleType("ray.train._internal.session")
    session_mod.get_session = lambda: object()
    train_mod = types.ModuleType("ray.train")
    hits = {"private": 0}

    def private_report(*a, **k):
        hits["private"] += 1

    train_mod.report = private_report
    sys.modules["ray"].train = train_mod
    for name, mod in [("ray.train", train_mod),
                      ("ray.train._internal", internal),
                      ("ray.train._internal.session", session_mod)]:
        monkeypatch.setitem(sys.modules, name, mod)
    _fit(tune.TuneReportCallback(on="validation_end"))
    assert len(context_session["reports"]) == 2
    assert hits["private"] == 0


def test_builtin_session_still_wins_over_context(context_session, tmp_path):
    """Probe order root: the builtin runner's thread-local session beats
    every bridge generation (a nested builtin sweep must not leak
    reports into an outer real-Ray trial)."""
    analysis = tune.run(
        lambda config: tune.report(loss=1.0),
        config={}, num_samples=1, metric="loss", mode="min",
        local_dir=str(tmp_path))
    assert analysis.trials[0].last_result["loss"] == 1.0
    assert context_session["reports"] == []


def test_builtin_session_still_wins(classic_session, tmp_path):
    """The builtin runner's thread-local session takes precedence over
    any ambient real-Ray session (a nested builtin sweep must not leak
    reports into an outer Ray trial)."""
    analysis = tune.run(
        lambda config: tune.report(loss=1.0),
        config={}, num_samples=1, metric="loss", mode="min",
        local_dir=str(tmp_path))
    assert analysis.trials[0].last_result["loss"] == 1.0
    assert classic_session["reports"] == []


def test_classic_session_through_actor_queue(classic_session):
    """The §3.3 grandchild relay against a REAL-Ray-style session:
    training runs in actor subprocesses, the report payload rides the
    worker→driver queue, and executes driver-side into the (stubbed)
    genuine ray.tune session — the reference's exact topology
    (tune.py:130-134 + util.py:47-52)."""
    _fit(tune.TuneReportCallback(on="validation_end"),
         plugins=[_actor_plugin()])
    assert len(classic_session["reports"]) == 2
    for r in classic_session["reports"]:
        assert "val_loss" in r


def test_classic_checkpoint_through_actor_queue(classic_session):
    """Checkpoint bytes assembled on remote rank 0 ride the queue and
    land in the (stubbed) genuine ray.tune checkpoint_dir, checkpoint
    before report (reference tune.py:161-178, :234-236)."""
    _fit(tune.TuneReportCheckpointCallback(on="validation_end"),
         plugins=[_actor_plugin()])
    assert len(classic_session["reports"]) == 2
    assert len(classic_session["ckpt_dirs"]) == 2
    path = os.path.join(classic_session["ckpt_dirs"][-1], "checkpoint")
    ckpt = Trainer.load_checkpoint_dict(path)
    assert ckpt["global_step"] > 0 and "state" in ckpt


@pytest.fixture
def midgen_session(monkeypatch):
    """Stub of a MID-generation Ray: ``tune.get_context`` exists (so the
    context probe fires) but ``tune.report`` still has the classic
    kwargs-only signature — calling it with a positional dict would
    TypeError.  No ``is_session_enabled``."""
    state = {"kw_reports": [], "train_reports": []}
    ray = types.ModuleType("ray")
    tune_mod = types.ModuleType("ray.tune")

    class _Ctx:
        def get_trial_id(self):
            return "trial_0001"

    tune_mod.get_context = lambda: _Ctx()

    def kw_report(**kwargs):
        state["kw_reports"].append(kwargs)

    tune_mod.report = kw_report
    ray.tune = tune_mod
    monkeypatch.setitem(sys.modules, "ray", ray)
    monkeypatch.setitem(sys.modules, "ray.tune", tune_mod)
    return state


def test_midgen_report_falls_back_to_kwargs(midgen_session):
    """Context live + kwargs-only tune.report + no train session: the
    bridge must deliver metrics classic-style instead of raising
    TypeError mid-trial."""
    _fit(tune.TuneReportCallback(on="validation_end"))
    assert len(midgen_session["kw_reports"]) == 2
    for r in midgen_session["kw_reports"]:
        assert "val_loss" in r


def test_midgen_prefers_train_session_for_checkpoints(midgen_session,
                                                      monkeypatch):
    """Context live + kwargs-only tune.report + a train session present:
    reports (and staged checkpoints) must route through train.report —
    the only generation-appropriate surface that can attach them."""
    internal = types.ModuleType("ray.train._internal")
    session_mod = types.ModuleType("ray.train._internal.session")
    session_mod.get_session = lambda: object()
    train_mod = types.ModuleType("ray.train")

    class Checkpoint:
        def __init__(self, path):
            self.path = path

        @classmethod
        def from_directory(cls, path):
            return cls(path)

    def train_report(metrics, checkpoint=None):
        files = {}
        if checkpoint is not None:
            for name in os.listdir(checkpoint.path):
                with open(os.path.join(checkpoint.path, name), "rb") as f:
                    files[name] = f.read()
        midgen_session["train_reports"].append(
            {"metrics": metrics, "files": files})

    train_mod.report = train_report
    train_mod.Checkpoint = Checkpoint
    sys.modules["ray"].train = train_mod
    for name, mod in [("ray.train", train_mod),
                      ("ray.train._internal", internal),
                      ("ray.train._internal.session", session_mod)]:
        monkeypatch.setitem(sys.modules, name, mod)
    _fit(tune.TuneReportCheckpointCallback(on="validation_end"))
    assert midgen_session["kw_reports"] == []
    reports = midgen_session["train_reports"]
    assert len(reports) == 2
    for r in reports:
        assert "val_loss" in r["metrics"]
        blob = r["files"]["checkpoint"]
        ckpt = load_state_stream(blob)
        assert ckpt["global_step"] > 0 and "state" in ckpt


def test_midgen_staged_checkpoint_lands_in_classic_dir(midgen_session,
                                                       monkeypatch,
                                                       tmp_path):
    """Mid-generation with classic tune.checkpoint_dir still present:
    a staged checkpoint must be written there (not silently dropped)
    when the kwargs-only report goes out."""
    tune_mod = sys.modules["ray.tune"]
    dirs = []

    @contextlib.contextmanager
    def checkpoint_dir(step):
        d = tmp_path / f"ckpt_{step}_{len(dirs)}"
        d.mkdir()
        dirs.append(str(d))
        yield str(d)

    tune_mod.checkpoint_dir = checkpoint_dir
    _fit(tune.TuneReportCheckpointCallback(on="validation_end"))
    assert len(midgen_session["kw_reports"]) == 2
    assert len(dirs) == 2
    for d in dirs:
        path = os.path.join(d, "checkpoint")
        assert os.path.isfile(path)
    ckpt = Trainer.load_checkpoint_dict(path)
    assert ckpt["global_step"] > 0 and "state" in ckpt
