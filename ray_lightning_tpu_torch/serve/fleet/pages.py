"""Paged KV accounting + prefix-hash reuse (the host half of the
fleet's "prefill once per replica" story): a copy of
``ray_lightning_tpu/serve/fleet/pages.py``, numpy only, line for line
(the fleet federation's hooks included), so the parity tests hold the
two to equal ``stats()`` after every operation.

The device cache stays the slot-contiguous ``[n_layer, S, L, H, D]``
pair (serve/kvcache.py) — preallocated like every static-shape array in
this framework — so "paging" here is NOT physical indirection but the
two host-side structures that make page-granular reuse sound:

- :class:`PagePool` — a free-list over the ``S * (L // page_size)``
  fixed-size pages backing the cache.  Live slots consume pages lazily
  as their position advances; a finished slot can be RETAINED as a
  prefix donor, keeping only its registered prefix pages on the books.
  The pool is what bounds retention: when every slot is held
  (live + donors) the scheduler evicts the least-recently-used donor to
  admit new work.  Invariant: ``free + allocated
  == total`` after every operation.

- :class:`PrefixIndex` — a hash table over token prefixes at page
  granularity.  A slot's prompt registers one entry per whole page
  (``hash(tokens[:k*page_size])``); a new prompt looks up its LONGEST
  page-aligned matching prefix, with an exact token comparison on the
  candidate so a hash collision can never alias two different prompts
  onto one K/V block.  A hit means the matched pages are copied
  device-side from the donor slot (engine ``kv_copy`` program) and only
  the suffix is computed — prefill tokens actually computed vs
  requested is the measured ``prefix_reuse`` savings number the bench
  reports.

Soundness of reuse: a K/V cache row is a pure per-token value —
``k/v = Dense(embed(token) + wpe[pos])`` — so identical (token,
position) prefixes have identical rows whatever bucket or slot computed
them.  Donor rows stay valid because (a) live slots only ever write at
their own advancing position, and (b) with paging enabled the scheduler
points idle slots' dummy decode writes at ``max_seq_len - 1`` (outside
every registered page; registration is capped below that row) instead
of position 0, which would corrupt the very first page of every
retained donor.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import os
from typing import Optional

import numpy as np


def _env_flag(name: str, default: bool) -> bool:
    raw = os.environ.get(name, "").strip()
    if raw in ("0", "false", "False"):
        return False
    if raw in ("1", "true", "True"):
        return True
    return default


@dataclasses.dataclass(frozen=True)
class PageConfig:
    """Paged-KV knobs, resolved like every other plane config.

    enabled: master switch — off keeps the serve plane byte-identical
        to the pre-fleet behavior (no copy/suffix programs built, dummy
        decode writes stay at position 0).
    page_size: tokens per page; prefix matching and donor retention
        happen at whole-page granularity.  Smaller pages match more,
        cost more index entries.
    """

    enabled: bool = False
    page_size: int = 16

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")

    @classmethod
    def resolve(cls, value) -> "PageConfig":
        """``Server(paged=...)`` → a config.  ``None`` defers to the
        ``RLT_SERVE_PAGED`` / ``RLT_SERVE_PAGE_SIZE`` env knobs (the
        worker_env round-trip, mirroring RLT_COMM*/RLT_ELASTIC*)."""
        if isinstance(value, cls):
            return value
        if isinstance(value, bool):
            return cls(enabled=value)
        if isinstance(value, int):
            return cls(enabled=True, page_size=value)
        if isinstance(value, dict):
            cfg = dict(value)
            cfg.setdefault("enabled", True)
            return cls(**cfg)
        if value is not None:
            raise TypeError(f"bad paged config: {value!r}")
        return cls(
            enabled=_env_flag("RLT_SERVE_PAGED", False),
            page_size=int(os.environ.get("RLT_SERVE_PAGE_SIZE", "16")
                          or 16),
        )

    def worker_env(self) -> dict:
        """Env mapping reproducing this config via :meth:`resolve` in a
        worker process (replica actors inherit it under both cluster
        backends)."""
        if not self.enabled:
            return {}
        return {"RLT_SERVE_PAGED": "1",
                "RLT_SERVE_PAGE_SIZE": str(self.page_size)}


def identity_page_table(slots: int, max_seq_len: int,
                        page_size: int) -> np.ndarray:
    """``[slots, pages_per_slot]`` int32 physical-page table for the
    slot-contiguous device cache: page ``p`` of slot ``s`` lives at
    physical page ``s * pages_per_slot + p`` of the
    ``[slots * pages_per_slot, page_size, C]`` page view.

    This is the table the paged flash-decode kernel
    (ops/flash_decode.py) walks in its KV BlockSpec index_map.  Today
    the mapping is the identity because the cache IS slot-contiguous
    (module docstring: paging is host accounting, not physical
    indirection) — but the kernel contract is already the indirect one,
    so physical page sharing later only changes this table, not the
    kernel.  Requires ``page_size`` to tile ``max_seq_len`` exactly
    (a ragged final page would alias rows of the next slot)."""
    if max_seq_len % page_size:
        raise ValueError(
            f"page_size {page_size} must tile max_seq_len "
            f"{max_seq_len} for the paged decode kernel")
    pages_per_slot = max_seq_len // page_size
    return (np.arange(slots, dtype=np.int32)[:, None] * pages_per_slot
            + np.arange(pages_per_slot, dtype=np.int32)[None, :])


class PagePool:
    """Free-list over the fixed-size pages backing the slot cache.

    Pages are accounting units (the arrays are preallocated); what the
    pool genuinely arbitrates is donor retention: retained prefix pages
    hold real cache rows hostage, and the free-list is what decides
    when a donor must be evicted to admit new work.
    """

    def __init__(self, slots: int, max_seq_len: int, page_size: int):
        if page_size < 1 or page_size > max_seq_len:
            raise ValueError(
                f"page_size {page_size} must be in [1, {max_seq_len}]")
        self.slots = int(slots)
        self.max_seq_len = int(max_seq_len)
        self.page_size = int(page_size)
        self.pages_per_slot = -(-max_seq_len // page_size)  # ceil
        self.total_pages = self.slots * self.pages_per_slot
        #: pages currently on the books per slot (live growth + donors)
        self._held: dict[int, int] = {}

    def _pages_for(self, length: int) -> int:
        return -(-max(0, int(length)) // self.page_size)

    @property
    def allocated(self) -> int:
        return sum(self._held.values())

    @property
    def free(self) -> int:
        return self.total_pages - self.allocated

    def note_written(self, slot: int, written_len: int) -> None:
        """Record that ``slot`` now holds K/V rows ``[0, written_len)``
        — page allocation is lazy, charged as the position advances."""
        need = min(self._pages_for(written_len), self.pages_per_slot)
        if need > self._held.get(slot, 0):
            self._held[slot] = need

    def shrink_to(self, slot: int, keep_len: int) -> int:
        """Keep only the pages covering ``[0, keep_len)`` (donor
        retention keeps the registered prefix, frees the decode tail).
        Returns pages freed."""
        keep = min(self._pages_for(keep_len), self.pages_per_slot)
        held = self._held.get(slot, 0)
        if keep <= 0:
            return self.release(slot)
        self._held[slot] = keep
        return max(0, held - keep)

    def release(self, slot: int) -> int:
        """Free every page the slot holds; returns pages freed."""
        return self._held.pop(slot, 0)

    def held(self, slot: int) -> int:
        return self._held.get(slot, 0)

    def check(self) -> None:
        """The structural invariant."""
        assert 0 <= self.allocated <= self.total_pages, self._held
        assert self.free + self.allocated == self.total_pages
        for slot, n in self._held.items():
            assert 0 <= slot < self.slots and 0 < n <= self.pages_per_slot


def _prefix_hash(tokens: np.ndarray) -> bytes:
    return hashlib.blake2b(
        np.ascontiguousarray(tokens, dtype=np.int32).tobytes(),
        digest_size=16).digest()


class PrefixIndex:
    """Longest page-aligned prefix lookup with exact-token verification.

    One entry per registered slot; per-page hashes let lookup walk from
    the longest candidate down.  Collisions are harmless: every hash hit
    is verified against the stored tokens before it can donate.
    """

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        #: slot -> registered prefix tokens (np.int32, whole pages)
        self._tokens: dict[int, np.ndarray] = {}
        #: hash(prefix of k pages) -> set of slots registering it
        self._by_hash: dict[bytes, set] = {}
        self.hits = 0
        self.misses = 0

    def register(self, slot: int, tokens, limit: Optional[int] = None
                 ) -> int:
        """Register ``slot`` as a donor for its prompt's whole pages
        (capped at ``limit`` rows — the scheduler passes
        ``max_seq_len - 1`` so the dummy-write row is never donatable).
        Returns the registered length in tokens (0 = nothing to offer).
        """
        self.drop(slot)
        tokens = np.asarray(tokens, dtype=np.int32).reshape(-1)
        n = len(tokens)
        if limit is not None:
            n = min(n, int(limit))
        n_pages = n // self.page_size
        if n_pages == 0:
            return 0
        reg = tokens[:n_pages * self.page_size].copy()
        self._tokens[slot] = reg
        for k in range(1, n_pages + 1):
            h = _prefix_hash(reg[:k * self.page_size])
            self._by_hash.setdefault(h, set()).add(slot)
        return len(reg)

    def drop(self, slot: int) -> None:
        reg = self._tokens.pop(slot, None)
        if reg is None:
            return
        for k in range(1, len(reg) // self.page_size + 1):
            h = _prefix_hash(reg[:k * self.page_size])
            slots = self._by_hash.get(h)
            if slots is not None:
                slots.discard(slot)
                if not slots:
                    del self._by_hash[h]

    def lookup(self, tokens, exclude: Optional[int] = None
               ) -> "tuple[int, int] | None":
        """Longest page-aligned matching prefix among registered slots:
        ``(donor_slot, matched_tokens)`` or ``None``.  The candidate's
        stored tokens are compared exactly — a hash collision can
        never alias."""
        tokens = np.asarray(tokens, dtype=np.int32).reshape(-1)
        max_pages = len(tokens) // self.page_size
        for k in range(max_pages, 0, -1):
            prefix = tokens[:k * self.page_size]
            for slot in self._by_hash.get(_prefix_hash(prefix), ()):
                if slot == exclude:
                    continue
                reg = self._tokens.get(slot)
                if reg is not None and len(reg) >= len(prefix) \
                        and np.array_equal(reg[:len(prefix)], prefix):
                    self.hits += 1
                    return slot, len(prefix)
        self.misses += 1
        return None

    def registered(self) -> "tuple[int, ...]":
        return tuple(sorted(self._tokens))


class PagedKV:
    """The scheduler's paging facade: pool + index + donor LRU +
    the prefill-token savings counters."""

    def __init__(self, cfg: PageConfig, slots: int, max_seq_len: int):
        self.cfg = cfg
        self.page_size = cfg.page_size
        self.max_seq_len = int(max_seq_len)
        self.pool = PagePool(slots, max_seq_len, cfg.page_size)
        self.index = PrefixIndex(cfg.page_size)
        #: slots retained as donors after their request finished,
        #: in retention order (front = least recently useful)
        self._donors: dict[int, int] = {}
        #: donors a KV-ship is about to export: admission pressure must
        #: not evict them (the export would skip — or worse, fetch rows
        #: a re-admitted slot already overwrote).  COUNTED, not a set:
        #: a finish-time hold and a concurrent export of a prefix-
        #: sharing prompt may pin the same slot independently
        self._pinned: dict[int, int] = {}
        self._lru = itertools.count()
        self.tokens_requested = 0
        self.tokens_computed = 0
        self.reused_prefills = 0
        #: fleet federation (serve/fleet/federation.py): the router
        #: binds (replica id, directory) so donor retention advertises
        #: fleet-wide and donor eviction invalidates.  Only RETAINED
        #: donors advertise — they are pinnable for the export leg, so
        #: their rows can't be overwritten mid-fetch; live slots could.
        self._fed = None
        self._fed_rid: Optional[int] = None
        #: slots whose donor rows were IMPORTED over the KV-ship plane
        #: (adopt_commit) rather than prefilled here — the remote-donor
        #: accounting behind the fleet's federated_reuse_ratio
        self._remote: set = set()
        self.remote_imports = 0
        self.federated_tokens_reused = 0

    # -- admission ---------------------------------------------------------

    def match(self, tokens) -> "tuple[int, int] | None":
        """Donor lookup for an admitting prompt; refreshes the donor's
        LRU stamp on a hit."""
        hit = self.index.lookup(tokens)
        if hit is not None and hit[0] in self._donors:
            self._donors[hit[0]] = next(self._lru)
        return hit

    def on_admit(self, slot: int, tokens, computed: int,
                 src: Optional[int] = None) -> None:
        """Account an admission: the slot leaves donor state (if the
        allocator handed back a retained slot), registers as a fresh
        donor for its own prompt, and charges its prompt pages.
        ``src`` names the donor a reuse hit copied from — when that
        donor's rows were IMPORTED (a federated fetch or a disagg
        ship), the avoided compute counts as federated reuse."""
        if src is not None and src in self._remote:
            self.federated_tokens_reused += max(
                0, len(np.atleast_1d(tokens)) - int(computed))
        self._fed_drop(slot)
        self._donors.pop(slot, None)
        self._remote.discard(slot)
        # the final cache row is the paging dummy-write target; never
        # donate it (module docstring)
        self.index.register(slot, tokens, limit=self.max_seq_len - 1)
        self.pool.note_written(slot, len(np.atleast_1d(tokens)))
        self.tokens_requested += len(np.atleast_1d(tokens))
        self.tokens_computed += int(computed)
        if computed < len(np.atleast_1d(tokens)):
            self.reused_prefills += 1

    # -- decode progress ---------------------------------------------------

    def on_advance(self, slot: int, pos: int) -> None:
        self.pool.note_written(slot, pos + 1)

    # -- eviction / retention ----------------------------------------------

    def retain(self, slot: int) -> bool:
        """Called when ``slot``'s request finishes: keep it as a donor
        when it has registered pages to offer (True = the scheduler
        must NOT release the slot), else free everything."""
        reg = self.index._tokens.get(slot)
        if reg is None or len(reg) == 0:
            self.index.drop(slot)
            self.pool.release(slot)
            return False
        self.pool.shrink_to(slot, len(reg))
        self._donors[slot] = next(self._lru)
        if self._fed is not None:
            # retention IS the fleet advertisement: from here until
            # eviction these rows are pinnable, so a federated fetch
            # can never race an overwrite
            self._fed.register(self._fed_rid, slot, reg)
        return True

    def pin(self, slot: int) -> None:
        """Shield a donor from LRU eviction while a KV-ship leg holds
        it (pinned until the export fetches its rows, or the router
        releases the hold on a failed leg)."""
        if slot in self._donors:
            self._pinned[slot] = self._pinned.get(slot, 0) + 1

    def unpin(self, slot: int) -> None:
        n = self._pinned.get(slot)
        if n is not None:
            if n <= 1:
                self._pinned.pop(slot)
            else:
                self._pinned[slot] = n - 1

    def evict_lru_donor(self, exclude: Optional[int] = None
                        ) -> "int | None":
        """Free the least-recently-useful donor's slot (admission
        pressure); returns the slot to hand back to the allocator.
        ``exclude`` protects the donor the admission is ABOUT to copy
        from (scheduler plan order: match, then evict) — evicting the
        one donor you need defeats the cache exactly under the slot
        pressure that makes it valuable.  Pinned donors (a KV-ship in
        flight) never evict: admission waits for the ship to release
        them instead of starving the export."""
        candidates = [s for s in self._donors
                      if s != exclude and s not in self._pinned]
        if not candidates:
            return None
        slot = min(candidates, key=self._donors.get)
        self._donors.pop(slot)
        self._remote.discard(slot)
        self.index.drop(slot)
        self.pool.release(slot)
        self._fed_drop(slot)
        return slot

    def drop_all(self) -> None:
        """fail_all reset: every slot's pages and index entries go."""
        for slot in list(self.index.registered()):
            self.index.drop(slot)
        self._donors.clear()
        self._pinned.clear()
        self._remote.clear()
        self.pool._held.clear()
        if self._fed is not None:
            self._fed.invalidate_replica(self._fed_rid)

    @property
    def donor_count(self) -> int:
        return len(self._donors)

    # -- fleet federation hooks --------------------------------------------

    def bind_federation(self, rid: int, directory) -> None:
        """Router hook: advertise this replica's donor retentions to
        the fleet directory (and invalidate on eviction) from here on.
        """
        self._fed_rid = int(rid)
        self._fed = directory

    def _fed_drop(self, slot: int) -> None:
        if self._fed is not None:
            self._fed.invalidate(self._fed_rid, slot)

    def mark_remote(self, slot: int) -> None:
        """Scheduler hook (adopt_commit): this donor's rows arrived
        over the wire, not from a local prefill."""
        self._remote.add(slot)
        self.remote_imports += 1

    # -- evidence ----------------------------------------------------------

    def stats(self) -> dict:
        return {
            "page_size": self.page_size,
            "pages_total": self.pool.total_pages,
            "pages_free": self.pool.free,
            "pages_allocated": self.pool.allocated,
            "donors": self.donor_count,
            "pinned_donors": len(self._pinned),
            "prefix_hits": self.index.hits,
            "prefix_misses": self.index.misses,
            "reused_prefills": self.reused_prefills,
            "prefill_tokens_requested": self.tokens_requested,
            "prefill_tokens_computed": self.tokens_computed,
            "prefix_reuse_ratio": round(
                1.0 - self.tokens_computed / self.tokens_requested, 4)
            if self.tokens_requested else 0.0,
            "remote_donors": len(self._remote & set(self._donors)),
            "remote_imports": self.remote_imports,
            "federated_tokens_reused": self.federated_tokens_reused,
        }


__all__ = ["PageConfig", "PagePool", "PrefixIndex", "PagedKV",
           "identity_page_table"]
