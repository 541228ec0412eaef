"""Data loading: numpy datasets, batches as torch tensors.

Counterpart of ``ray_lightning_tpu/core/data.py`` (``ArrayDataset``,
``DataLoader``, ``default_collate``): the same index order (``shuffle``
draws ``default_rng(seed + epoch)``), ``drop_last`` and per-rank
sharding (:meth:`DataLoader.shard`), with each numpy batch handed out
as CPU torch tensors, which the ``Trainer`` moves to its device
(:func:`to_device`).  An ``ArrayDataset`` of contiguous arrays is
assembled by the C++ prefetch runtime (ray_lightning_tpu_torch/native:
a background thread and a threaded row-gather) unless ``prefetch=False``
or ``RLT_NATIVE=0``, with the Python path's order and ownership; without
a toolchain the Python path serves, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch


def _to_numpy(x: Any) -> Any:
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "__array__"):
        return np.asarray(x)
    return x


def default_collate(samples: Sequence[Any]) -> Any:
    """Stack a list of samples (arrays / tuples / dicts) into a batch."""
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return type(first)(
            default_collate([s[i] for s in samples])
            for i in range(len(first)))
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    arrs = [_to_numpy(s) for s in samples]
    if np.isscalar(arrs[0]) or (isinstance(arrs[0], np.ndarray)
                                and arrs[0].ndim == 0):
        return np.asarray(arrs)
    return np.stack(arrs)


def to_device(batch: Any, device: "torch.device | str | None",
              float_dtype: "torch.dtype | None" = None) -> Any:
    """A batch pytree with every array as a torch tensor on ``device``
    (numpy arrays go through ``torch.from_numpy``, without a copy on the
    CPU).  With ``float_dtype`` the floating leaves are cast to it on the
    host before the copy, as the JAX ``Trainer._host_cast`` casts them to
    bf16 under ``precision="bf16"`` (half the bytes to move); integer
    leaves keep their dtype."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(to_device(x, device, float_dtype) for x in batch)
    if isinstance(batch, dict):
        return {k: to_device(v, device, float_dtype)
                for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    if not isinstance(batch, torch.Tensor):
        return batch
    if float_dtype is not None and batch.is_floating_point():
        batch = batch.to(float_dtype)
    if device is not None:
        return batch.to(device, non_blocking=True)
    return batch


class ArrayDataset:
    """Dataset over a tuple/dict of equal-length arrays."""

    def __init__(self, *arrays: Any, **named: Any):
        if arrays and named:
            raise ValueError("Pass either positional or named arrays.")
        self._tree = named if named else (
            arrays[0] if len(arrays) == 1 and isinstance(arrays[0], dict)
            else tuple(arrays))
        leaves = (list(self._tree.values())
                  if isinstance(self._tree, dict) else list(self._tree))
        if not leaves:
            raise ValueError("Empty dataset.")
        self._leaves = [_to_numpy(a) for a in leaves]
        self._len = len(self._leaves[0])
        for a in self._leaves:
            if len(a) != self._len:
                raise ValueError("All arrays must share the leading dim.")

    def __len__(self) -> int:
        return self._len

    def _rebuild(self, leaves):
        if isinstance(self._tree, dict):
            return dict(zip(self._tree.keys(), leaves))
        if isinstance(self._tree, tuple) and len(leaves) == 1:
            return leaves[0]
        return tuple(leaves)

    def __getitem__(self, idx):
        return self._rebuild([a[idx] for a in self._leaves])

    def take(self, indices: np.ndarray):
        """Vectorized gather of a batch of indices."""
        return self._rebuild([a[indices] for a in self._leaves])


class DataLoader:
    """Minimal batch loader over a map-style dataset, yielding CPU torch
    tensors."""

    def __init__(self, dataset: Any, batch_size: int = 1,
                 shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0, collate_fn: "Callable | None" = None,
                 num_shards: int = 1, shard_index: int = 0,
                 prefetch: bool = True, seq_shards: int = 1,
                 seq_index: int = 0):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.collate_fn = collate_fn or default_collate
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        self.seq_shards = seq_shards
        self.seq_index = seq_index
        self._epoch = 0

    def shard(self, num_shards: int, shard_index: int) -> "DataLoader":
        """A copy of this loader restricted to one rank's shard (the
        ``DistributedSampler`` analog)."""
        return self._clone(num_shards=num_shards, shard_index=shard_index)

    def slice_sequence(self, seq_shards: int, seq_index: int
                       ) -> "DataLoader":
        """A copy of this loader whose batches hold one sequence rank's
        slice of dim 1 of every leaf with two or more dims (a
        ``sequence`` mesh axis' batch spec, ``P(data, "sequence")``)."""
        return self._clone(seq_shards=seq_shards, seq_index=seq_index)

    def _clone(self, **kw) -> "DataLoader":
        args = dict(batch_size=self.batch_size, shuffle=self.shuffle,
                    drop_last=self.drop_last, seed=self.seed,
                    collate_fn=self.collate_fn, num_shards=self.num_shards,
                    shard_index=self.shard_index, prefetch=self.prefetch,
                    seq_shards=self.seq_shards, seq_index=self.seq_index)
        clone = DataLoader(self.dataset, **{**args, **kw})
        clone._epoch = self._epoch
        return clone

    def _seq_slice(self, batch):
        if self.seq_shards == 1:
            return batch
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._seq_slice(b) for b in batch)
        if isinstance(batch, dict):
            return {k: self._seq_slice(v) for k, v in batch.items()}
        if not isinstance(batch, torch.Tensor) or batch.dim() < 2:
            return batch
        t, n = batch.shape[1], self.seq_shards
        if t % n:
            raise ValueError(f"a sequence of {t} does not split over "
                             f"{n} sequence ranks")
        return batch.narrow(1, self.seq_index * (t // n),
                            t // n).contiguous()

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle deterministically per epoch."""
        self._epoch = int(epoch)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self._epoch).permutation(n)
        else:
            idx = np.arange(n)
        if self.num_shards > 1:
            # wrap-around padding so every shard has as many samples
            # (DistributedSampler's), then a stride
            pad = (-len(idx)) % self.num_shards
            if pad:
                idx = np.concatenate([idx, idx[:pad]])
            idx = idx[self.shard_index::self.num_shards]
        return idx

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.num_shards > 1:
            n = -(-n // self.num_shards)     # the padded shard's length
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Any]:
        idx = self._indices()
        fast = isinstance(self.dataset, ArrayDataset)
        end = ((len(idx) // self.batch_size) * self.batch_size
               if self.drop_last else len(idx))
        if fast and self.prefetch and end > 0:
            native_iter = self._native_iter(idx[:end])
            if native_iter is not None:
                for batch in native_iter:
                    yield self._seq_slice(batch)
                return
        for start in range(0, end, self.batch_size):
            batch_idx = idx[start:start + self.batch_size]
            if fast:
                batch = self.dataset.take(batch_idx)
            else:
                batch = self.collate_fn([self.dataset[int(i)]
                                         for i in batch_idx])
            yield self._seq_slice(to_device(batch, None))

    def _native_iter(self, idx: np.ndarray) -> "Iterator[Any] | None":
        """The epoch through the C++ prefetch runtime
        (ray_lightning_tpu_torch/native): the same order (the index order
        is computed here and handed over) and caller-owned batches (each
        batch's buffers pass to the consumer; the CPU tensors share their
        memory).  ``None`` (the Python path) without the library, or for
        leaves that are not contiguous numpy arrays: the runtime would
        copy the whole dataset every epoch."""
        from ray_lightning_tpu_torch import native
        ds = self.dataset
        if not all(isinstance(a, np.ndarray) and a.dtype != object
                   and a.flags.c_contiguous for a in ds._leaves):
            return None
        if not native.native_available():
            return None

        def gen():
            pf = native.NativePrefetcher(ds._leaves, self.batch_size)
            try:
                for bufs in pf.iter_epoch(idx):
                    yield to_device(ds._rebuild(bufs), None)
            finally:
                pf.close()
        return gen()


__all__ = ["ArrayDataset", "DataLoader", "default_collate", "to_device"]
