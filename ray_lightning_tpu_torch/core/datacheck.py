"""Opt-in divergent-loader detection (``RLT_DATA_CHECK=1``).

Counterpart of ``ray_lightning_tpu/core/datacheck.py``.  The
multi-process data contract (core/loop_engine.py ``StreamSource``):
every process derives its batch order from the SAME loader state; only
the shard stride differs.  A loader that breaks it (a per-rank seed, an
order-changing subclass) trains on silently skewed batch pairings (rank
A's step k meets rank B's step n-1-k) without a crash.  This module
detects it:

- worker side (:class:`BatchFingerprinter`, created each epoch by the
  stream source when enabled): for each batch, a crc32 fingerprint of
  the batch's bytes AND of the batch the contract says this rank takes
  at that loader position (rebuilt from the shared base order, strided
  as ``DataLoader.shard`` strides it).  Both ride the worker-to-driver
  queue as marked items.
- driver side (:class:`DataCheckValidator`, made by the distributed
  plugin for a run, plugins/base.py ``data_check_validator``): raises
  when a rank's batch differs from its contract batch, or when two
  ranks disagree on the base order of an epoch (a per-rank shuffle).
  The raise happens in the driver's poll loop (util.py
  ``process_results``), naming the rank, the epoch and the step.

Cost: one more dataset gather and two crc32 a step, only with the knob
set: a debugging and CI tool.
"""

from __future__ import annotations

import logging
import os
import threading
import zlib
from typing import Any, Callable, Optional

import numpy as np

from ray_lightning_tpu_torch.core.data import ArrayDataset, to_device
from ray_lightning_tpu_torch.core.steps import tree_leaves

_log = logging.getLogger(__name__)

ENV_DATA_CHECK = "RLT_DATA_CHECK"
DATA_CHECK_KEY = "__rlt_data_check__"


def enabled(env: "dict | None" = None) -> bool:
    """The knob, in ``env`` (default: this process's environment)."""
    env = os.environ if env is None else env
    return str(env.get(ENV_DATA_CHECK, "")).strip() == "1"


def tree_fingerprint(batch: Any) -> int:
    """crc32 over every leaf's shape, dtype and bytes, in order (a
    batch at another position MUST change it).  Tensors and numpy
    arrays of the same values fingerprint alike."""
    crc = 0
    for leaf in tree_leaves(to_device(batch, None)):
        a = np.ascontiguousarray(leaf.detach().cpu().numpy())
        crc = zlib.crc32(repr((a.shape, str(a.dtype))).encode(), crc)
        crc = zlib.crc32(a.tobytes(), crc)
    return crc


class BatchFingerprinter:
    """Worker-side fingerprint relay for one epoch of one loader."""

    def __init__(self, loader, rank: int, epoch: int,
                 send: Callable[[Any], None]):
        self._loader = loader
        self._rank = rank
        self._epoch = epoch
        self._send = send
        # the shared base order, rebuilt as every honest shard strides
        # it (DataLoader._indices, CachedSource._epoch_plan)
        base = np.asarray(loader.shard(1, 0)._indices())
        self._base_fp = zlib.crc32(
            np.ascontiguousarray(base, np.int64).tobytes())
        P = max(1, getattr(loader, "num_shards", 1))
        pad = (-len(base)) % P
        if pad:
            base = np.concatenate([base, base[:pad]])
        self._expected_ids = base[getattr(loader, "shard_index", 0)::P]

    @classmethod
    def maybe_create(cls, loader, rank: int,
                     epoch: int) -> "Optional[BatchFingerprinter]":
        """None unless the knob is set, this process is a launched
        worker (it has a session queue) and the loader exposes what the
        check needs."""
        if not enabled():
            return None
        from ray_lightning_tpu_torch.session import get_session
        try:
            session = get_session()
        except ValueError:
            return None
        ok = all(hasattr(loader, a) for a in
                 ("shard", "_indices", "dataset", "collate_fn",
                  "batch_size")) \
            and hasattr(loader.dataset, "__len__") \
            and hasattr(loader.dataset, "__getitem__")
        if not ok:
            _log.warning("%s=1 needs a ray_lightning_tpu_torch DataLoader "
                         "over an indexable dataset; got %r: no data "
                         "check.", ENV_DATA_CHECK, type(loader).__name__)
            return None
        return cls(loader, rank, epoch, session.put_queue)

    def _expected_batch(self, batch_idx: int):
        """The batch the contract says this rank takes at loader position
        ``batch_idx`` (``DataLoader.__iter__``'s gather)."""
        B = self._loader.batch_size
        ids = self._expected_ids[batch_idx * B:(batch_idx + 1) * B]
        if len(ids) == 0:
            return None
        ds = self._loader.dataset
        if isinstance(ds, ArrayDataset):
            return ds.take(np.asarray(ids))
        return self._loader.collate_fn([ds[int(i)] for i in ids])

    def observe(self, batch_idx: int, batch: Any) -> None:
        """Fingerprint one batch and relay the check item.  A failure to
        fingerprint is logged, never raised into the step."""
        try:
            expected = self._expected_batch(batch_idx)
            item = {
                DATA_CHECK_KEY: 1,
                "rank": self._rank,
                "epoch": self._epoch,
                "step": batch_idx,
                "fp": tree_fingerprint(batch),
                "expected_fp": (tree_fingerprint(expected)
                                if expected is not None else None),
                "base_fp": self._base_fp,
            }
        except Exception:   # noqa: BLE001 - a check never fails a step
            _log.warning("data-check fingerprint failed", exc_info=True)
            return
        self._send(item)


class DataCheckValidator:
    """Driver-side cross-rank validation of the relayed fingerprints."""

    def __init__(self):
        self._lock = threading.Lock()
        self._base: "dict[int, dict[int, int]]" = {}  # epoch -> rank -> fp
        self._failure: Optional[str] = None
        self.checked = 0

    def maybe_ingest(self, item: Any) -> bool:
        """Take ``item`` if it is a check item (True), else leave it."""
        if not (isinstance(item, dict) and item.get(DATA_CHECK_KEY)):
            return False
        rank = item.get("rank", -1)
        epoch = item.get("epoch", 0)
        step = item.get("step", -1)
        with self._lock:
            self.checked += 1
            if item.get("expected_fp") is not None \
                    and item["fp"] != item["expected_fp"] \
                    and self._failure is None:
                self._failure = (
                    f"divergent data order detected: rank {rank} consumed "
                    f"a batch at epoch {epoch} step {step} that does not "
                    f"match the shared loader order (actual fingerprint "
                    f"{item['fp']:#x} != contract {item['expected_fp']:#x})"
                    f"; every process must derive its order from the "
                    f"same loader state (core/loop_engine.py contract)")
            ranks = self._base.setdefault(epoch, {})
            ranks[rank] = item["base_fp"]
            if len(set(ranks.values())) > 1 and self._failure is None:
                self._failure = (
                    f"divergent base order detected at epoch {epoch}: "
                    f"ranks disagree on the unsharded index order "
                    f"({ {r: hex(f) for r, f in ranks.items()} }); "
                    f"per-rank seeds or shuffles break the shared-loader "
                    f"contract")
        return True

    def verify(self) -> None:
        """Raise on any recorded divergence."""
        if self._failure is not None:
            raise RuntimeError(self._failure)


__all__ = ["BatchFingerprinter", "DATA_CHECK_KEY", "DataCheckValidator",
           "ENV_DATA_CHECK", "enabled", "tree_fingerprint"]
