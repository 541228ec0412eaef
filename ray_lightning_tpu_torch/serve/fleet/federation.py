"""Fleet-level prefix-cache federation: the router-resident directory
that turns any replica's donor pages into a hit for every OTHER
replica ("prefill once per fleet"); a copy of
``ray_lightning_tpu/serve/fleet/federation.py``.

Per-replica prefix reuse (pages.py PrefixIndex) only hits when routing
happens to land a prompt on the replica that already holds its prefix —
tenant stickiness makes that likely, nothing makes it true.  And a
disaggregated fleet's prefill pool re-prefills prefixes the decode pool
already adopted.  :class:`PrefixDirectory` closes both gaps:

- **Advertise** — a replica's :class:`~ray_lightning_tpu_torch.serve.fleet.
  pages.PagedKV` advertises every donor RETENTION here
  (``bind_federation`` installs the hook): page-aligned prefix hashes →
  (replica, slot, page count, liveness stamp).  Only retained donors
  advertise, never live slots — a donor is pinnable for the export leg
  (pages.py ``pin``), so its rows cannot be overwritten between the
  directory hit and the worker fetch; a live slot's rows could be.

- **Invalidate** — donor eviction (LRU pressure, slot reuse,
  ``drop_all``) drops the entry; replica death/shrink drops the whole
  replica (router ``_fold_pages``); a fetch that finds the donor gone
  anyway (the lookup→fetch race) heals the stale entry itself.

- **Lookup** — longest page-aligned matching prefix across the fleet,
  with the SAME exact-token verification as the local index: the
  directory stores the registered tokens, so a hash collision can
  never route a fetch, and the donor side re-verifies against its own
  index before exporting a single row.  Entries older than ``ttl_s``
  are treated as dead (liveness: a wedged replica's advertisements age
  out instead of attracting doomed fetches forever).

The directory is pure bookkeeping — the actual page movement rides the
KV-ship plane (export → codec → mailbox → import) unchanged, now
pull-driven (router fetches on a directory hit) as well as push-driven
(disagg prefill→decode ships).  Size is bounded by construction: one
entry per retained (replica, slot) donor, replaced on re-registration —
``pages()`` can never exceed the fleet's retained page total.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np

from ray_lightning_tpu_torch.serve.fleet.pages import _prefix_hash


class PrefixDirectory:
    """Fleet-wide donor registry: page-aligned prefix hash → (replica,
    slot, pages, liveness).  Router-resident; replicas' PagedKV
    instances call in via the ``bind_federation`` hooks.  Thread-safe
    and a leaf lock — no method calls back into a scheduler."""

    def __init__(self, page_size: int, ttl_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        if ttl_s <= 0:
            raise ValueError("ttl_s must be > 0")
        self.page_size = int(page_size)
        self.ttl_s = float(ttl_s)
        self._clock = clock
        #: (rid, slot) -> registered prefix tokens (whole pages)
        self._regs: dict = {}
        #: hash(prefix of k pages) -> set of (rid, slot) registering it
        self._by_hash: dict = {}
        #: (rid, slot) -> last advertisement time (liveness)
        self._stamp: dict = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    # -- advertisement -----------------------------------------------------

    def register(self, rid: int, slot: int, tokens) -> int:
        """Advertise ``(rid, slot)`` as a fleet donor for its tokens'
        whole pages (re-registration replaces — one entry per donor,
        which is what bounds the directory by retained pages).
        Returns the registered length in tokens."""
        tokens = np.asarray(tokens, dtype=np.int32).reshape(-1)
        n_pages = len(tokens) // self.page_size
        key = (int(rid), int(slot))
        with self._lock:
            self._drop(key)
            if n_pages == 0:
                return 0
            reg = tokens[:n_pages * self.page_size].copy()
            self._regs[key] = reg
            self._stamp[key] = self._clock()
            for k in range(1, n_pages + 1):
                h = _prefix_hash(reg[:k * self.page_size])
                self._by_hash.setdefault(h, set()).add(key)
            return len(reg)

    def _drop(self, key) -> None:
        reg = self._regs.pop(key, None)
        self._stamp.pop(key, None)
        if reg is None:
            return
        for k in range(1, len(reg) // self.page_size + 1):
            h = _prefix_hash(reg[:k * self.page_size])
            keys = self._by_hash.get(h)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._by_hash[h]

    # -- invalidation ------------------------------------------------------

    def invalidate(self, rid: int, slot: int) -> None:
        """Donor gone (evicted, slot reused, or a fetch found it
        missing): drop its advertisement."""
        with self._lock:
            if (int(rid), int(slot)) in self._regs:
                self.invalidations += 1
            self._drop((int(rid), int(slot)))

    def invalidate_replica(self, rid: int) -> None:
        """Replica gone (failover, shrink, drop_all): every entry it
        advertised is dead."""
        rid = int(rid)
        with self._lock:
            for key in [k for k in self._regs if k[0] == rid]:
                self.invalidations += 1
                self._drop(key)

    # -- lookup ------------------------------------------------------------

    def _live(self, key, now: float) -> bool:
        return now - self._stamp.get(key, -1e18) <= self.ttl_s

    def lookup(self, tokens, exclude_rid: Optional[int] = None
               ) -> "tuple[int, int, int] | None":
        """Longest page-aligned matching prefix fleet-wide:
        ``(rid, slot, matched_tokens)`` or ``None``.  Exact-token
        verified (hash collisions can't route a fetch); expired
        entries are pruned in passing, not returned."""
        tokens = np.asarray(tokens, dtype=np.int32).reshape(-1)
        max_pages = len(tokens) // self.page_size
        now = self._clock()
        with self._lock:
            for k in range(max_pages, 0, -1):
                prefix = tokens[:k * self.page_size]
                keys = self._by_hash.get(_prefix_hash(prefix))
                best = None
                for key in sorted(keys or ()):
                    if exclude_rid is not None and key[0] == exclude_rid:
                        continue
                    if not self._live(key, now):
                        continue
                    reg = self._regs.get(key)
                    if reg is not None and len(reg) >= len(prefix) \
                            and np.array_equal(reg[:len(prefix)], prefix):
                        # freshest stamp wins; sorted() makes ties
                        # deterministic by (rid, slot)
                        if best is None or self._stamp[key] \
                                > self._stamp[best]:
                            best = key
                if best is not None:
                    self.hits += 1
                    return best[0], best[1], len(prefix)
            # prune what aged out so size tracks live donors
            for key in [k for k in self._stamp
                        if not self._live(k, now)]:
                self._drop(key)
            self.misses += 1
            return None

    def affinity(self, tokens) -> "dict[int, int]":
        """Per-replica longest matched prefix (tokens) for the router's
        prefix-affinity routing — which replica already holds how much
        of this prompt."""
        tokens = np.asarray(tokens, dtype=np.int32).reshape(-1)
        max_pages = len(tokens) // self.page_size
        now = self._clock()
        out: dict = {}
        with self._lock:
            for k in range(max_pages, 0, -1):
                prefix = tokens[:k * self.page_size]
                for key in self._by_hash.get(_prefix_hash(prefix), ()):
                    if key[0] in out or not self._live(key, now):
                        continue
                    reg = self._regs.get(key)
                    if reg is not None and len(reg) >= len(prefix) \
                            and np.array_equal(reg[:len(prefix)], prefix):
                        out[key[0]] = len(prefix)
        return out

    # -- evidence ----------------------------------------------------------

    def pages(self) -> int:
        """Total advertised pages — bounded by the fleet's retained
        pages (one replaced-on-reregister entry per donor slot)."""
        with self._lock:
            return sum(len(r) // self.page_size
                       for r in self._regs.values())

    def entries(self) -> int:
        with self._lock:
            return len(self._regs)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._regs),
                "pages": sum(len(r) // self.page_size
                             for r in self._regs.values()),
                "replicas": len({k[0] for k in self._regs}),
                "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
                "ttl_s": self.ttl_s,
            }


__all__ = ["PrefixDirectory"]
