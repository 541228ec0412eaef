"""PyTorch/CUDA port, the C++ prefetch runtime
(``ray_lightning_tpu_torch/native``): the cases of ``tests/test_native.py``
against the port's loader, each batch compared with the port's Python
path and with the JAX package's loader on the same arrays (bit for bit:
a gather moves bytes), plus a ``Trainer`` fit through it.  The runtime
builds with ``g++`` at first use; without a toolchain the tests skip,
as the JAX package's do.
"""

import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.data import ArrayDataset as JaxArrayDataset
from ray_lightning_tpu.core.data import DataLoader as JaxDataLoader
from ray_lightning_tpu_torch import BoringModel, Trainer, native
from ray_lightning_tpu_torch.core.data import ArrayDataset, DataLoader


@pytest.fixture(scope="module")
def lib():
    lib = native.load_library()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    return lib


def test_gather_matches_numpy(lib):
    rng = np.random.default_rng(0)
    src = rng.standard_normal((512, 33)).astype(np.float32)
    idx = rng.integers(0, 512, size=300)
    np.testing.assert_array_equal(native.gather(src, idx), src[idx])


def test_gather_large_multithreaded(lib):
    rng = np.random.default_rng(1)
    src = rng.standard_normal((4096, 512)).astype(np.float32)
    idx = rng.permutation(4096)
    np.testing.assert_array_equal(native.gather(src, idx, n_threads=4),
                                  src[idx])


def test_gather_int_and_3d(lib):
    rng = np.random.default_rng(2)
    src = rng.integers(0, 100, size=(64, 4, 7)).astype(np.int64)
    idx = np.array([3, 3, 0, 63])
    np.testing.assert_array_equal(native.gather(src, idx), src[idx])


def _collect(loader):
    return [tuple(np.array(b) for b in batch) for batch in loader]


def _arrays(n):
    return (np.arange(n * 3, dtype=np.float32).reshape(n, 3),
            np.arange(n, dtype=np.int32))


def _loaders(n=37, batch=8, **kw):
    ds = ArrayDataset(*_arrays(n))
    return (DataLoader(ds, batch_size=batch, prefetch=True, **kw),
            DataLoader(ds, batch_size=batch, prefetch=False, **kw))


@pytest.mark.parametrize("kw", [
    {},                                        # partial last batch
    {"drop_last": True},
    {"shuffle": True, "seed": 7},
    {"num_shards": 2, "shard_index": 1},
    {"shuffle": True, "num_shards": 2, "shard_index": 0},
])
def test_loader_parity(lib, kw):
    """The native path's batches equal the Python path's and the JAX
    loader's, in order; they are CPU tensors and went through the
    runtime."""
    fast, slow = _loaders(**kw)
    before = native.stats["batches"]
    got, want = _collect(fast), _collect(slow)
    assert native.stats["batches"] - before == len(got) > 0
    jax = _collect(JaxDataLoader(JaxArrayDataset(*_arrays(37)),
                                 batch_size=8, prefetch=True, **kw))
    assert len(got) == len(want) == len(jax) == len(fast)
    for g, w, j in zip(got, want, jax):
        for a, b, c in zip(g, w, j):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in next(iter(fast)))


def test_loader_parity_across_epochs(lib):
    fast, slow = _loaders(shuffle=True)
    for epoch in range(3):
        fast.set_epoch(epoch)
        slow.set_epoch(epoch)
        for g, w in zip(_collect(fast), _collect(slow)):
            np.testing.assert_array_equal(g[0], w[0])
    assert fast.shard(2, 1).prefetch


def test_dict_dataset(lib):
    ds = ArrayDataset(a=np.arange(20, dtype=np.float32),
                      b=np.arange(20, dtype=np.int64) * 2)
    batches = list(DataLoader(ds, batch_size=6, prefetch=True))
    assert set(batches[0].keys()) == {"a", "b"}
    np.testing.assert_array_equal(batches[-1]["a"].numpy(),
                                  np.array([18.0, 19.0], dtype=np.float32))


def test_early_exit_does_not_hang(lib):
    fast, _ = _loaders(n=1000, batch=4)
    it = iter(fast)
    next(it)
    next(it)
    it.close()  # abort mid-epoch; the prefetcher stops cleanly
    assert len(_collect(fast)) == len(fast)


def test_prefetcher_batches_are_owned(lib):
    """Yielded batches pass ownership: every retained batch stays intact
    through the epoch (no ring slot reused under the consumer)."""
    n = 64
    x = np.arange(n, dtype=np.int64)
    pf = native.NativePrefetcher([x], batch_size=4, queue_depth=2)
    retained = [buf for (buf,) in pf.iter_epoch(np.arange(n))]
    for k, buf in enumerate(retained):
        np.testing.assert_array_equal(buf, x[k * 4:(k + 1) * 4])
    pf.close()


def test_prefetcher_clamps_queue_depth(lib):
    pf = native.NativePrefetcher([np.arange(8, dtype=np.int64)],
                                 batch_size=2, queue_depth=1)
    assert pf.queue_depth == 2
    batches = [np.array(b) for (b,) in pf.iter_epoch(np.arange(8))]
    np.testing.assert_array_equal(np.concatenate(batches), np.arange(8))
    pf.close()


def test_loader_batches_retained_across_epoch(lib):
    """``list(loader)`` keeps every batch's values: the tensors share
    memory with buffers the runtime never reuses."""
    n, batch = 40, 4
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    batches = list(DataLoader(ArrayDataset(x), batch_size=batch,
                              prefetch=True))
    for k, b in enumerate(batches):
        np.testing.assert_array_equal(b.numpy(), x[k * batch:(k + 1) * batch])


def test_non_contiguous_falls_back(lib):
    """Transposed leaves take the Python path (no hidden per-epoch copy of
    the dataset) and still yield the right batches."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4).T
    before = native.stats["epochs"]
    loader = DataLoader(ArrayDataset(x), batch_size=2, prefetch=True)
    got = np.concatenate([b.numpy() for b in loader])
    np.testing.assert_array_equal(got, np.ascontiguousarray(x))
    assert native.stats["epochs"] == before


def test_malformed_thread_env(lib, monkeypatch):
    monkeypatch.setenv("RLT_NATIVE_THREADS", "auto")
    assert native.default_threads() >= 1
    monkeypatch.setenv("RLT_NATIVE_THREADS", "3")
    assert native.default_threads() == 3


def test_disabled_via_env(lib, monkeypatch):
    monkeypatch.setenv("RLT_NATIVE", "0")
    assert native.load_library() is None
    before = native.stats["epochs"]
    fast, slow = _loaders()
    for g, w in zip(_collect(fast), _collect(slow)):
        np.testing.assert_array_equal(g[0], w[0])
    assert native.stats["epochs"] == before


def test_library_is_keyed_by_source_under_build(lib):
    """The library lives under ``build/ray_lightning_tpu_torch`` (ignored
    by git), named by a hash of the source and flags; no build failed."""
    path = native.library_path()
    assert path.is_file() and path.parent.name == "ray_lightning_tpu_torch"
    assert path.parent.parent.name == "build"
    assert native.stats["build_failures"] == 0


def test_trainer_end_to_end_with_native_loader(lib, tmp_path):
    """A fit whose batches come through the runtime."""
    before = native.stats["batches"]
    trainer = Trainer(max_epochs=1, limit_train_batches=4,
                      limit_val_batches=2, num_sanity_val_steps=0,
                      enable_checkpointing=False, logger=False,
                      default_root_dir=str(tmp_path), device="cpu")
    trainer.fit(BoringModel())
    assert "loss" in trainer.callback_metrics
    assert native.stats["batches"] - before >= 4
