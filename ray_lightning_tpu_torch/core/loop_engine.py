"""Batch sources for the trainer's single epoch engine.

Counterpart of ``ray_lightning_tpu/core/loop_engine.py``.  The engine
has ONE loop (``Trainer._train_epoch``) over a *batch source*; the
dispatch shape (one step, a k-step chunk, a gather from the
device-resident train set) is the source's business, the semantics
(limits, callbacks, metrics, the validation cadence) are the engine's
and exist once.

- :class:`StreamSource`: host batches from the loader.  Taken one at a
  time it is the plain streamed loop, and on the card it
  double-buffers: the next ``PREFETCH_DEPTH`` batches are copied from
  pinned host memory on a copy stream while the current step runs, and
  the compute stream waits on each copy's event
  (``RLT_STREAM_PREFETCH=0`` turns it off).  Full k-step takes stack
  into one chunk (``Trainer(steps_per_execution=k)``: a CUDA graph
  replay on the card, core/steps.py ``ChunkRunner``).
- :class:`CachedSource`: the device-resident train set
  (``Trainer(cache_train_dataset=True)``).  The samples are uploaded
  ONCE in dataset order as flat ``[N, ...]`` tensors; each epoch the
  loader's own index order (shuffle included) drives a device-side
  repack into ``[n_batches, B, ...]``, so each batch holds the samples
  the streamed loop would have assembled.  Each step then gathers its
  batch on the device by index: only indices cross the host link.  A
  trailing partial batch (``drop_last=False``) cannot ride the
  fixed-shape cache and goes through the single-step path as a host
  batch.  Across ranks each batch shard holds only its own rows of the
  set (shard b the rows ``[b N/W, (b+1) N/W)``), and the repack is one
  all-to-all among the shards (parallel/strategy.py ``exchange_rows``).
  On a mesh with a tensor, expert, sequence or stage axis over 1 every
  rank of such a group is one batch shard and holds the same rows (its
  sequence slice of them, under a ``sequence`` axis), and the
  all-to-all runs over the group of the batch axes.

At world size > 1 with ``RLT_DATA_CHECK=1`` the stream source relays a
fingerprint of every batch to the driver, which checks the ranks
against the shared-loader contract (core/datacheck.py).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.core.data import (ArrayDataset,
                                               default_collate, to_device)
from ray_lightning_tpu_torch.core.steps import (signature, tree_leaves,
                                                tree_map)
from ray_lightning_tpu_torch.parallel.strategy import exchange_rows

_log = logging.getLogger(__name__)


@dataclass
class Item:
    """One pending training step.

    ``payload`` is a host batch (``kind="host"``) or an int batch index
    into the source's repacked device cache (``kind="cached"``).
    ``device`` is a :class:`Transfer` in flight when the stream source
    prefetched this batch.  :meth:`batch` materializes the host batch
    for callbacks; the engine calls it only when some callback
    overrides a per-batch hook and reads the batch
    (``Trainer._batch_hook_plan``), so cached epochs under the default
    callbacks never pay host collation."""

    batch_idx: int
    kind: str                      # "host" | "cached"
    payload: Any
    _batch_fn: Optional[Callable[[], Any]] = None
    device: Any = None
    _materialized: Any = None

    def batch(self):
        if self._materialized is None and self._batch_fn is not None:
            self._materialized = self._batch_fn()
            self._batch_fn = None
        return self._materialized if self._materialized is not None \
            else self.payload


class Transfer:
    """A host batch on its way to ``device``.  On the card: copied from
    pinned memory on ``stream`` (the copy stream) into tensors allocated
    there; :meth:`wait` makes the current stream wait on the copy's event
    and records the tensors on it, so the caching allocator does not
    hand their memory to the next copy while the step still reads it.
    Elsewhere the batch is just moved."""

    def __init__(self, host: Any, device: torch.device,
                 stream: "torch.cuda.Stream | None"):
        self._device = device
        self._event = None
        if device.type != "cuda":
            self._tree = to_device(host, device)
            return
        with torch.cuda.stream(stream):
            self._tree = tree_map(lambda x: x.pin_memory().to(
                device, non_blocking=True), host)
            self._event = torch.cuda.Event()
            self._event.record(stream)

    def wait(self) -> Any:
        if self._event is not None:
            compute = torch.cuda.current_stream(self._device)
            compute.wait_event(self._event)
            for x in tree_leaves(self._tree):
                x.record_stream(compute)
            self._event = None
        return self._tree


class StreamSource:
    """Host batches straight from the loader, one fresh pass per epoch
    (module docstring).  Prefetching runs only when steps dispatch one
    at a time (``steps_per_execution == 1``): a chunk stacks its host
    batches itself.  Multi-process runs prefetch the same way: a copy
    is local to its rank, and every rank pulls in the same order."""

    PREFETCH_DEPTH = 2

    def __init__(self, trainer, loader):
        self._trainer = trainer
        self._it = enumerate(loader)
        self._buf: list = []            # pre-pulled items, copies live
        self._prefetch = (trainer.steps_per_execution == 1
                          and os.environ.get("RLT_STREAM_PREFETCH",
                                             "1") != "0")
        self._stream = None
        self._fingerprinter = None
        if trainer.world_size > 1:
            from ray_lightning_tpu_torch.core import datacheck
            self._fingerprinter = datacheck.BatchFingerprinter.maybe_create(
                loader, trainer.global_rank, trainer.current_epoch)
        self.exhausted = False

    def _pull(self) -> "Item | None":
        """One batch from the loader, honoring ``limit_train_batches``,
        which counts loader POSITIONS."""
        t = self._trainer
        if self.exhausted:
            return None
        try:
            batch_idx, batch = next(self._it)
        except StopIteration:
            self.exhausted = True
            return None
        if t.limit_train_batches is not None \
                and batch_idx >= t.limit_train_batches:
            self.exhausted = True
            return None
        if self._fingerprinter is not None:
            self._fingerprinter.observe(batch_idx, batch)
        return Item(batch_idx=batch_idx, kind="host", payload=batch)

    def _start_transfer(self, item: Item) -> None:
        if item.device is not None:
            return
        t = self._trainer
        if t.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(t.device)
        item.device = Transfer(t._host_cast(item.payload), t.device,
                               self._stream)

    def take(self, n: int) -> list:
        out: list = []
        while len(out) < n:
            item = self._buf.pop(0) if self._buf else self._pull()
            if item is None:
                break
            out.append(item)
        if self._prefetch:
            for it in out:
                self._start_transfer(it)
            while len(self._buf) < self.PREFETCH_DEPTH:
                nxt = self._pull()
                if nxt is None:
                    break
                self._start_transfer(nxt)
                self._buf.append(nxt)
        return out

    def chunkable(self, items: list) -> bool:
        """A chunk stacks host batches: every leaf's shape and dtype
        must agree (a ragged final batch does not stack)."""
        if any(it.kind != "host" for it in items):
            return False
        sigs = [signature(it.payload) for it in items]
        return all(s == sigs[0] for s in sigs)

    def run_one(self, trainer, item: Item):
        batch = (item.device.wait() if item.device is not None
                 else trainer._to_device(item.payload))
        trainer.state, metrics = trainer._train_step(trainer.state, batch)
        return metrics

    def run_chunk(self, trainer, items: list):
        # [k, B, ...] leaf by leaf, then cast as a single batch is
        stacked = trainer._host_cast(default_collate(
            [it.payload for it in items]))
        trainer.state, metrics = trainer._multi_train_step.run(
            trainer.state, stacked)
        return metrics


class CachedSource:
    """The device-resident train set, repacked each epoch in the
    loader's order (module docstring).  Built once per fit;
    :meth:`new_epoch` refreshes the plan from the loader's index
    order."""

    def __init__(self, trainer, loader):
        self._trainer = trainer
        self._loader = loader
        self._flat = None              # device tree: this rank's rows
        self._repacked = None          # device tree [nb, B, ...]
        self._last_perm: Optional[np.ndarray] = None
        self._plan: list = []          # the epoch's Items
        self._pos = 0
        self._host_memo: Optional[dict] = None
        self._host_memo_perm: Optional[np.ndarray] = None
        self._promise_broken = False   # order changed without shuffle
        self.exhausted = False

    # -- construction -----------------------------------------------------

    @staticmethod
    def usable(loader) -> bool:
        """The cache needs the loader's anatomy (dataset, index order,
        collate); other loaders stream instead, with a warning."""
        ok = all(hasattr(loader, a) for a in
                 ("dataset", "_indices", "collate_fn", "batch_size",
                  "drop_last")) \
            and hasattr(loader.dataset, "__len__") \
            and hasattr(loader.dataset, "__getitem__") \
            and len(loader.dataset) > 0 and loader.batch_size > 0
        if not ok:
            _log.warning(
                "cache_train_dataset needs a ray_lightning_tpu_torch "
                "DataLoader over an indexable dataset; got %r: streaming "
                "instead.", type(loader).__name__)
        return ok

    def _gather_host(self, sample_ids) -> Any:
        """The host batch of the given sample ids, cast as the trainer
        casts batches: a view for contiguous ids over an
        ``ArrayDataset``, a vectorized gather otherwise, per-sample
        collation for other datasets."""
        ds = self._loader.dataset
        ids = np.asarray(sample_ids)
        if isinstance(ds, ArrayDataset):
            if len(ids) and np.array_equal(
                    ids, np.arange(ids[0], ids[0] + len(ids))):
                host = ds[slice(int(ids[0]), int(ids[0]) + len(ids))]
            else:
                host = ds.take(ids)
        else:
            host = self._loader.collate_fn([ds[int(i)] for i in ids])
        seq_slice = getattr(self._loader, "_seq_slice", None)
        if seq_slice is not None:
            host = seq_slice(host)
        return self._trainer._host_cast(host)

    @property
    def _n_shards(self) -> int:
        return max(1, getattr(self._loader, "num_shards", 1))

    def build(self) -> bool:
        """Upload this rank's rows of the set in dataset order; False:
        unusable (the caller streams; nothing was read from the loader's
        iterator: the cache reads the DATASET).  At W ranks rank r holds
        the rows ``[r N/W, (r+1) N/W)``, which needs W to divide N."""
        n = len(self._loader.dataset)
        W = self._n_shards
        if n % W:
            _log.warning(
                "cache_train_dataset: dataset size %d does not divide "
                "across %d ranks; streaming instead.", n, W)
            return False
        rows = n // W
        lo = getattr(self._loader, "shard_index", 0) * rows
        flat = self._gather_host(np.arange(lo, lo + rows))
        leaves = tree_leaves(flat)
        if not leaves or any(x.dim() == 0 or x.shape[0] != rows
                             for x in leaves):
            _log.warning(
                "cache_train_dataset: the collated dataset is not [N, ...] "
                "shaped; streaming instead.")
            return False
        self._flat = self._trainer._to_device(flat)
        return True

    # -- the epoch's plan -------------------------------------------------

    def _epoch_plan(self):
        """``(want, local_ids, nb, tail)``: per rank the sample ids of its
        ``nb`` full batches in its batch order (each rank's streamed
        loader would take exactly these), this rank's ids per batch (the
        callbacks' batches), and this rank's ids of the partial tail.
        Every rank rebuilds the unsharded order and strides it as
        ``DataLoader.shard`` does, so every rank computes the same
        plan."""
        loader = self._loader
        B = loader.batch_size
        P = self._n_shards
        rank = getattr(loader, "shard_index", 0)
        if P == 1:
            per_rank = [np.asarray(loader._indices())]
        else:
            full = np.asarray(loader.shard(1, 0)._indices())
            pad = (-len(full)) % P
            if pad:
                full = np.concatenate([full, full[:pad]])
            per_rank = [full[r::P] for r in range(P)]
        nb = len(per_rank[0]) // B
        want = [pr[:nb * B] for pr in per_rank]
        local = [per_rank[rank][j * B:(j + 1) * B] for j in range(nb)]
        return want, local, nb, per_rank[rank][nb * B:]

    def _repack(self, want: list, nb: int) -> None:
        """This epoch's ``[nb, B, ...]`` batches into persistent buffers
        (a graphed chunk holds their addresses)."""
        B = self._loader.batch_size
        mesh = self._trainer._mesh
        group = mesh.group(*mesh.batch_axes) if mesh is not None else None

        def fill(flat, old):
            shape = (nb, B) + tuple(flat.shape[1:])
            out = old if old is not None and tuple(old.shape) == shape \
                and old.dtype == flat.dtype else flat.new_empty(shape)
            if nb:
                exchange_rows(flat, want, out.view(nb * B, *shape[2:]),
                              group)
            return out

        old = tree_leaves(self._repacked) if self._repacked is not None \
            else None
        it = iter(old) if old is not None else None
        self._repacked = tree_map(
            lambda f: fill(f, next(it) if it is not None else None),
            self._flat)

    def new_epoch(self) -> "CachedSource":
        t = self._trainer
        loader = self._loader
        want, local_ids, nb, tail = self._epoch_plan()
        if t.limit_train_batches is not None \
                and nb > t.limit_train_batches:
            nb = t.limit_train_batches
            want = [w[:nb * loader.batch_size] for w in want]
            local_ids = local_ids[:nb]
        perm = np.concatenate(want).astype(np.int64)
        if self._last_perm is None or not np.array_equal(
                perm, self._last_perm):
            if self._flat is None:
                # the flat upload was dropped (shuffle=False promised a
                # fixed order), yet the order changed: upload once more
                # and keep it from now on
                _log.warning(
                    "cache_train_dataset: loader %s changed its epoch "
                    "index order despite shuffle=False; uploading the "
                    "train set again and keeping it resident (set "
                    "shuffle=True to declare this upfront).",
                    type(loader).__name__)
                self._promise_broken = True
                if not self.build():
                    raise RuntimeError("cache_train_dataset: the train set "
                                       "no longer uploads")
            self._repack(want, nb)
            self._last_perm = perm
            if not getattr(loader, "shuffle", False) \
                    and not self._promise_broken:
                # a fixed order: drop the flat copy rather than hold the
                # train set twice on the card all fit long
                self._flat = None
        # host batches for callback arguments, valid while the order is
        if self._host_memo is None or not np.array_equal(
                perm, self._host_memo_perm):
            self._host_memo = {}
            self._host_memo_perm = perm

        def memo_batch(j, sample_ids):
            got = self._host_memo.get(j)
            if got is None:
                got = self._host_memo[j] = self._gather_host(sample_ids)
            return got

        self._plan = [
            Item(batch_idx=j, kind="cached", payload=j,
                 _batch_fn=(lambda j=j, s=local_ids[j]: memo_batch(j, s)))
            for j in range(nb)]
        under_limit = (t.limit_train_batches is None
                       or nb < t.limit_train_batches)
        if len(tail) and not loader.drop_last and under_limit:
            self._plan.append(Item(batch_idx=nb, kind="host",
                                   payload=self._gather_host(tail)))
        self._pos = 0
        self.exhausted = not self._plan
        return self

    # -- the engine's surface ---------------------------------------------

    def take(self, n: int) -> list:
        out = self._plan[self._pos:self._pos + n]
        self._pos += len(out)
        if self._pos >= len(self._plan):
            self.exhausted = True
        return out

    def chunkable(self, items: list) -> bool:
        return all(it.kind == "cached" for it in items)

    def run_one(self, trainer, item: Item):
        if item.kind == "host":
            batch = trainer._to_device(item.payload)
        else:
            batch = tree_map(lambda d: d[item.payload], self._repacked)
        trainer.state, metrics = trainer._train_step(trainer.state, batch)
        return metrics

    def run_chunk(self, trainer, items: list):
        idxs = np.asarray([it.payload for it in items], dtype=np.int64)
        trainer.state, metrics = trainer._multi_train_step.run_cached(
            trainer.state, self._repacked, idxs)
        return metrics


__all__ = ["CachedSource", "Item", "StreamSource", "Transfer"]
