"""PyTorch/CUDA port, the epoch engine across actors and the data check
(core/datacheck.py), with CPU workers on gloo (``platform="cpu"``).

- the ``RLT_STREAM_PREFETCH`` A/B across two workers: rank 0's per-step
  losses identical with the prefetch on and off;
- ``RLT_DATA_CHECK=1``: silent on a loader that keeps the shared-order
  contract (the same losses again), and the divergent-loader canary (odd
  ranks iterate their shard reversed) fails the fit on the driver with
  "divergent data order", naming the rank
  (``tests/test_plugin_distributed.py:280-403``); the fingerprinter and
  the validator also in process;
- W=2 fits across actors with ``steps_per_execution=4``,
  ``cache_train_dataset`` (each rank holds half the rows; the repack is
  one gloo ``all_to_all_single``) and both (``tests/test_plugin_
  distributed.py:78-90, 246-280``): equal bit for bit to the streamed
  W=2 fit, and within ``rtol=1e-5, atol=1e-6`` to one process training
  on the same global batches.

Workers unpickle this module's callbacks and modules by import path
(stdlib pickle), so it imports no JAX and keeps its classes at module
level.  Every run carries its bound (``RayPlugin(timeout_s=...)``).
"""

import json

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch import BoringModel, Callback, RayPlugin, Trainer
from ray_lightning_tpu_torch.core import datacheck
from ray_lightning_tpu_torch.core.data import DataLoader
from ray_lightning_tpu_torch.models.boring import RandomDataset

#: a run's bound: the driver's wait for its workers and each collective
RUN_TIMEOUT_S = 90
QUIET = dict(enable_checkpointing=False, num_sanity_val_steps=0,
             limit_val_batches=0, logger=False, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class DumpLosses(Callback):
    """Rank 0 writes its per-step losses (a chunk's ``[k]`` flattened)
    to ``path`` at the end of training."""

    def __init__(self, path: str):
        self.path = path
        self.losses: list = []

    def on_train_batch_end(self, trainer, module, outputs, batch, idx):
        self.losses.extend(np.atleast_1d(
            outputs["loss"].detach().double().numpy()).tolist())

    def on_train_end(self, trainer, module):
        if trainer.global_rank == 0:
            with open(self.path, "w") as f:
                json.dump(self.losses, f)


class SourceProbe(Callback):
    """Rank 0 writes whether its fit trained from the device-resident
    set (the cache built, so it did not fall back to streaming)."""

    def __init__(self, path: str):
        self.path = path

    def on_train_end(self, trainer, module):
        if trainer.global_rank == 0:
            with open(self.path, "w") as f:
                json.dump({"cached": trainer._cache_source is not None,
                           "world_size": trainer.world_size}, f)


class DivergentLoader(DataLoader):
    """Canary: odd ranks iterate their shard REVERSED, breaking the
    shared-loader contract (only the shard stride may differ)."""

    def shard(self, num_shards, shard_index):
        clone = DivergentLoader(
            self.dataset, batch_size=self.batch_size, shuffle=self.shuffle,
            drop_last=self.drop_last, seed=self.seed, num_shards=num_shards,
            shard_index=shard_index)
        clone._epoch = self._epoch
        return clone

    def _indices(self):
        idx = super()._indices()
        return idx[::-1].copy() if self.shard_index % 2 else idx


class DivergentBoring(BoringModel):
    def train_dataloader(self):
        return DivergentLoader(RandomDataset(32, self.dataset_length, 0),
                               batch_size=self.batch_size)


def _traj(tmp_path, tag, module, prefetch, extra_env=None, **kw):
    """Rank 0's per-step losses of a 2-worker fit of 8 steps."""
    out = str(tmp_path / f"{tag}.json")
    plugin = RayPlugin(num_workers=2, platform="cpu",
                       timeout_s=RUN_TIMEOUT_S,
                       worker_env={"RLT_STREAM_PREFETCH": prefetch,
                                   **(extra_env or {})})
    trainer = Trainer(max_epochs=1, limit_train_batches=8,
                      plugins=[plugin], callbacks=[DumpLosses(out)],
                      default_root_dir=str(tmp_path / tag), **QUIET, **kw)
    trainer.fit(module)
    assert trainer.global_step == 8
    with open(out) as f:
        losses = json.load(f)
    assert len(losses) == 8
    return losses


@pytest.fixture(scope="module")
def prefetch_on(tmp_path_factory):
    """The prefetching contract-keeping run, shared by the A/B and the
    honest data check."""
    return _traj(tmp_path_factory.mktemp("pf_on"), "pf_on",
                 BoringModel(batch_size=8, dataset_length=128), "1")


def test_stream_prefetch_ab_across_actors(tmp_path, prefetch_on):
    """Prefetching moves the copy under the previous step, never the data
    it carries: the same losses with it off."""
    off = _traj(tmp_path, "pf_off",
                BoringModel(batch_size=8, dataset_length=128), "0")
    assert off == prefetch_on


def test_data_check_is_silent_on_honest_loader(tmp_path, prefetch_on):
    checked = _traj(tmp_path, "dc_honest",
                    BoringModel(batch_size=8, dataset_length=128), "1",
                    extra_env={datacheck.ENV_DATA_CHECK: "1"})
    assert checked == prefetch_on


def test_divergent_loader_order_is_detected(tmp_path):
    """The driver raises on the relayed fingerprints, naming the rank."""
    with pytest.raises(Exception, match="divergent data order") as err:
        _traj(tmp_path, "dc_skew",
              DivergentBoring(batch_size=8, dataset_length=128), "1",
              extra_env={datacheck.ENV_DATA_CHECK: "1"})
    assert "rank 1" in str(err.value)


def test_fingerprints_and_validator_in_process():
    """Each rank's batches of an honest sharded loader match their
    contract fingerprints; a reversed shard's do not, and the validator
    names its rank; two ranks with different base orders fail too."""
    def relay(loader, rank):
        items = []
        fp = datacheck.BatchFingerprinter(loader, rank, 0, items.append)
        for i, batch in enumerate(loader):
            fp.observe(i, batch)
        return items

    honest = DataLoader(RandomDataset(32, 40, 0), batch_size=4,
                        shuffle=True, seed=5)
    v = datacheck.DataCheckValidator()
    for r in range(2):
        for item in relay(honest.shard(2, r), r):
            assert item["fp"] == item["expected_fp"]
            assert v.maybe_ingest(item)
    v.verify()
    assert v.checked == 10 and not v.maybe_ingest(("not", "an item"))

    skew = DivergentLoader(RandomDataset(32, 40, 0), batch_size=4)
    v = datacheck.DataCheckValidator()
    for r in range(2):
        for item in relay(skew.shard(2, r), r):
            v.maybe_ingest(item)
    with pytest.raises(RuntimeError, match="rank 1 consumed"):
        v.verify()

    v = datacheck.DataCheckValidator()
    for r, seed in ((0, 5), (1, 6)):
        loader = DataLoader(RandomDataset(32, 40, 0), batch_size=4,
                            shuffle=True, seed=seed)
        v.maybe_ingest(relay(loader.shard(2, r), r)[0])
    with pytest.raises(RuntimeError, match="divergent base order"):
        v.verify()


def _actor_fit(tmp_path, tag, **kw):
    """A 2-worker fit of BoringModel (B=8 a rank) over 2 epochs of 8
    steps: the trainer and the weights on the driver."""
    module = BoringModel(batch_size=8, dataset_length=128)
    probe = str(tmp_path / f"{tag}_source.json")
    trainer = Trainer(max_epochs=2, limit_train_batches=8,
                      plugins=[RayPlugin(num_workers=2, platform="cpu",
                                         timeout_s=RUN_TIMEOUT_S)],
                      callbacks=[SourceProbe(probe)],
                      default_root_dir=str(tmp_path / tag), **QUIET, **kw)
    trainer.fit(module)
    assert trainer.global_step == 16
    with open(probe) as f:
        assert json.load(f) == {"cached": kw.get("cache_train_dataset",
                                                 False), "world_size": 2}
    return trainer, module._trained_state


@pytest.fixture(scope="module")
def streamed_w2(tmp_path_factory):
    return _actor_fit(tmp_path_factory.mktemp("w2"), "streamed")


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """One process over the same global batches: B=16, rank 0's rows
    then rank 1's (the loader's stride of the same order)."""
    module = BoringModel(batch_size=16, dataset_length=128)
    trainer = Trainer(max_epochs=2, limit_train_batches=8, device="cpu",
                      default_root_dir=str(tmp_path_factory.mktemp("one")),
                      **QUIET)
    trainer.fit(module)
    return trainer, {k: v.detach().clone()
                     for k, v in module.model.state_dict().items()}


@pytest.mark.parametrize("knobs", [dict(steps_per_execution=4),
                                   dict(cache_train_dataset=True),
                                   dict(steps_per_execution=4,
                                        cache_train_dataset=True)],
                         ids=["chunked", "cached", "cached_chunked"])
def test_knobs_across_actors(knobs, tmp_path, streamed_w2, one_process):
    """Each knob across two gloo workers trains as the streamed W=2 fit
    does, bit for bit, and as one process on the same global batches
    within fp32's tolerance."""
    trainer, got = _actor_fit(tmp_path, "knobs", **knobs)
    want_trainer, want = streamed_w2
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert trainer.callback_metrics["loss"] == \
        want_trainer.callback_metrics["loss"]
    ref_trainer, ref = one_process
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(trainer.callback_metrics["loss"],
                               ref_trainer.callback_metrics["loss"],
                               rtol=1e-5, atol=1e-6)
