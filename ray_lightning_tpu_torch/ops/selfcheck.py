"""Ops selfcheck: the decode path's invariants, on the CPU, no card.

Counterpart of ``ray_lightning_tpu/ops/selfcheck.py``.  Run it as
``python -m ray_lightning_tpu_torch.ops.selfcheck`` (exit 1 and one line
per problem on a failure); ``tests/test_torch_selfcheck.py`` runs it.
It asserts:

- ``resolve_decode_impl``: an explicit value beats ``RLT_DECODE_IMPL``,
  which beats ``auto``; every valid impl round-trips; junk raises;
- the split-KV plan against the masking: for every shape of a grid,
  :func:`decode_split_plan`'s chunks are whole tiles within their
  limits and cover the cache exactly once, and a split the kernel
  visits for a position (``j * chunk <= pos``, the kernel's early exit)
  is exactly one that holds a live row: no live row is skipped, no
  split without one is merged (the JAX check's clamp-vs-guard);
- lowering sanity: the kernels' split-and-merge arithmetic
  (``flash_decode_split_plain``) equals the dense masked attention at
  ragged positions, fp32 within 2e-5;
- ``identity_page_table`` flattens to ``arange`` and rejects a page size
  that does not tile the cache; the paged decode over the identity table
  equals the slot-contiguous one bit for bit.
"""

from __future__ import annotations

import os


def _impl_order(problems: "list[str]") -> None:
    from ray_lightning_tpu_torch.ops.flash_decode import (
        VALID_DECODE_IMPLS, resolve_decode_impl)
    saved = os.environ.get("RLT_DECODE_IMPL")
    try:
        os.environ["RLT_DECODE_IMPL"] = "flash_decode"
        if resolve_decode_impl("dense", "cpu") != "dense":
            problems.append("explicit impl did not beat the env knob")
        if resolve_decode_impl(None, "cpu") != "flash_decode":
            problems.append("RLT_DECODE_IMPL not honoured")
        os.environ.pop("RLT_DECODE_IMPL")
        if resolve_decode_impl(None, "cpu") != "dense" \
                or resolve_decode_impl(None, "cuda") != "flash_decode":
            problems.append("auto did not pick dense on the CPU and "
                            "flash_decode on the card")
        for impl in VALID_DECODE_IMPLS:
            if impl != "auto" and resolve_decode_impl(impl, "cpu") != impl:
                problems.append(f"impl {impl!r} does not round-trip")
        try:
            resolve_decode_impl("warp", "cpu")
        except ValueError:
            pass
        else:
            problems.append("junk impl did not raise")
    finally:
        if saved is None:
            os.environ.pop("RLT_DECODE_IMPL", None)
        else:
            os.environ["RLT_DECODE_IMPL"] = saved


def _split_plan(problems: "list[str]") -> None:
    from ray_lightning_tpu_torch.ops.flash_decode import (
        DECODE_MAX_CHUNK_TILES, DECODE_TILE, decode_split_plan)
    for S in (1, 4, 16, 64):
        for H in (2, 12, 25):
            for L in (64, 100, 1024, 2048, 8192):
                for sms in (1, 132):
                    chunk, n = decode_split_plan(S, H, L, sms)
                    where = f"plan(S={S}, H={H}, L={L}, sms={sms})"
                    if chunk % DECODE_TILE or not \
                            DECODE_TILE <= chunk \
                            <= DECODE_MAX_CHUNK_TILES * DECODE_TILE:
                        problems.append(f"{where}: chunk {chunk} is not "
                                        f"a whole tile count in limits")
                    if not (n - 1) * chunk < L <= n * chunk:
                        problems.append(f"{where}: {n} chunks of {chunk} "
                                        f"do not cover {L} rows once")
    chunk = 2 * DECODE_TILE
    L = 5 * chunk
    n = -(-L // chunk)
    for pos in range(L):
        for j in range(n):
            visited = j * chunk <= pos
            live = any(r <= pos for r in range(j * chunk,
                                               min((j + 1) * chunk, L)))
            if visited != live:
                problems.append(f"split {j} at pos {pos}: visited "
                                f"{visited}, holds a live row {live}")


def _lowering(problems: "list[str]") -> None:
    import numpy as np
    import torch

    from ray_lightning_tpu_torch.ops.attention import cached_attention
    from ray_lightning_tpu_torch.ops.flash_decode import (
        DECODE_TILE, flash_decode_attention, flash_decode_paged_attention,
        flash_decode_split_plain)
    from ray_lightning_tpu_torch.serve.fleet.pages import identity_page_table

    S, L, H, D = 2, 4 * DECODE_TILE, 2, 16
    rng = np.random.default_rng(0)
    q, kc, vc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((S, 1, H, D), (S, L, H, D), (S, L, H, D)))
    pos = torch.tensor([3, L - 1], dtype=torch.int32)
    dense = cached_attention(q, kc, vc, pos, dtype=torch.float32,
                             impl="dense")
    for chunk in (DECODE_TILE, 2 * DECODE_TILE):
        split = flash_decode_split_plain(q, kc, vc, pos, chunk)
        err = float((dense - split).abs().max())
        if not err < 2e-5:
            problems.append(f"split arithmetic (chunk {chunk}) diverged "
                            f"from the dense reference: max abs err {err}")

    page = 16
    table = identity_page_table(S, L, page)
    if not np.array_equal(table.reshape(-1), np.arange(S * L // page)):
        problems.append("identity_page_table is not the identity")
    try:
        identity_page_table(2, 65, page)
    except ValueError:
        pass
    else:
        problems.append("a page size that does not tile L did not raise")
    view = (S * L // page, page, H, D)
    flat = flash_decode_attention(q, kc, vc, pos)
    paged = flash_decode_paged_attention(
        q, kc.view(view), vc.view(view), pos,
        torch.from_numpy(table).contiguous())
    if not torch.equal(flat, paged):
        problems.append("the paged decode over the identity table is not "
                        "the slot-contiguous decode bit for bit")


def run() -> "list[str]":
    """Every check; the problems found (none: all hold)."""
    problems: "list[str]" = []
    _impl_order(problems)
    _split_plan(problems)
    _lowering(problems)
    return problems


def _main(argv=None) -> int:   # noqa: ARG001 - argv kept for parity
    problems = run()
    for p in problems:
        print(f"ops selfcheck: {p}")
    if not problems:
        print("ops selfcheck: impl resolution, split plan vs masking, "
              "split arithmetic vs dense, identity table and paged == "
              "flat OK")
    return 1 if problems else 0


if __name__ == "__main__":   # pragma: no cover - run as a module
    import sys
    sys.exit(_main(sys.argv[1:]))
