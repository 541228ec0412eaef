"""Slot-indexed, device-resident KV cache for continuous batching (a
copy of ``ray_lightning_tpu/serve/kvcache.py``, with a rank's block).

The cache is two tensors ``[n_layer, S, L, H, D]`` (keys / values): ``S``
batch slots x ``L`` max context, living on the device for the whole life
of the engine.  In-flight request insertion and eviction are SLOT INDEX
operations:

- insert  = the bucket prefill writes a prompt's K/V block into its slot
  (core/steps.py build_prefill_step);
- advance = the decode step writes one position per slot in place
  (ops/attention.py MultiHeadAttention.decode);
- evict   = the driver frees the slot index — NO device work.  Stale
  K/V beyond a slot's position bound are unreachable by construction
  (the per-slot position mask), so a freed slot is reusable the moment
  the next prefill overwrites its prefix.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class KVCacheSpec:
    """Host-side description of the device cache.  Under a strategy
    (serve/engine.py) it describes one rank's block, ``[n_layer, slots /
    data, L, H / tensor, D]``, and :meth:`nbytes` is that rank's share
    (:meth:`block` cuts the whole cache's spec to it)."""

    n_layer: int
    slots: int
    max_seq_len: int
    n_head: int
    head_dim: int

    @property
    def shape(self) -> tuple[int, int, int, int, int]:
        return (self.n_layer, self.slots, self.max_seq_len, self.n_head,
                self.head_dim)

    def nbytes(self, itemsize: int = 2) -> int:
        """Device residency of BOTH cache arrays (k and v) at the given
        element size (bf16 default)."""
        return 2 * int(np.prod(self.shape, dtype=np.int64)) * itemsize

    def block(self, slots: "tuple[int, int]",
              heads: "tuple[int, int]") -> "KVCacheSpec":
        """The spec of the rank holding slots ``[lo, hi)`` and heads
        ``[lo, hi)`` of this cache (parallel/strategy.py
        ``kv_cache_block``)."""
        return KVCacheSpec(self.n_layer, slots[1] - slots[0],
                           self.max_seq_len, heads[1] - heads[0],
                           self.head_dim)

    @classmethod
    def from_capture(cls, kv_shapes, slots: int,
                     max_seq_len: int) -> "KVCacheSpec":
        """Derive the cache geometry from a prefill capture:
        ``kv_shapes`` is any per-layer K list (tensors or anything with a
        ``shape``) with entries shaped ``[B, T, H, D]``."""
        n_layer = len(kv_shapes)
        if n_layer == 0:
            raise ValueError("model captured no K/V entries; does its "
                             "hidden_with_kv() return every layer's "
                             "(k, v)? "
                             "(models/gpt.py)")
        _, _, n_head, head_dim = kv_shapes[0].shape
        return cls(n_layer=n_layer, slots=slots, max_seq_len=max_seq_len,
                   n_head=int(n_head), head_dim=int(head_dim))


class SlotAllocator:
    """Driver-side free-list of cache slots (the host half of
    insert/evict; the device half is the index writes above)."""

    def __init__(self, slots: int):
        if slots < 1:
            raise ValueError(f"need >= 1 slot, got {slots}")
        self.slots = slots
        self._free = list(range(slots))
        self._used: set[int] = set()

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return len(self._used)

    def acquire(self) -> "int | None":
        if not self._free:
            return None
        slot = self._free.pop(0)
        self._used.add(slot)
        return slot

    def acquire_in(self, lo: int, hi: int) -> "int | None":
        """The first free slot in ``[lo, hi)`` (a serve rank's block),
        or ``None``."""
        for i, slot in enumerate(self._free):
            if lo <= slot < hi:
                self._used.add(self._free.pop(i))
                return slot
        return None

    def release(self, slot: int) -> None:
        if slot not in self._used:
            raise ValueError(f"slot {slot} is not in use")
        self._used.remove(slot)
        self._free.append(slot)

    def in_use(self) -> tuple[int, ...]:
        return tuple(sorted(self._used))


__all__ = ["KVCacheSpec", "SlotAllocator"]
