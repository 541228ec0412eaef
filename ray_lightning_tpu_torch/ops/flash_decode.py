"""Flash-decode: the per-token serve kernels and their plain versions.

Counterpart of ``ray_lightning_tpu/ops/flash_decode.py``
``flash_decode_attention`` -> ``flash_decode_kernel`` (``_decode_body``)
over the slot-contiguous cache, and ``flash_decode_attention(...,
page_table=)`` -> ``flash_decode_paged_kernel`` over the page view.
Decode is bandwidth-bound — one query token per slot against its cache
rows — so the win is bytes not read, and bytes kept in flight: the
kernels (``csrc/flash_decode.cu``) walk each slot's cache only up to
``positions[s]``, split over several blocks per (slot, head) by
:func:`decode_split_plan` and merged in the same launch; the paged one
finds each page through the page table.

:func:`flash_decode_attention` and :func:`flash_decode_paged_attention`
are the wrappers: a CUDA tensor launches the kernel (or raises), a CPU
tensor takes the plain version.  :func:`flash_decode_split_plain` is
the kernel's split-and-merge arithmetic in plain PyTorch.
:func:`resolve_decode_impl` reads ``RLT_DECODE_IMPL`` as the JAX
package does.
"""

from __future__ import annotations

import functools
import math
import os

import torch

from ray_lightning_tpu_torch.ops._kernels import Kernel
from ray_lightning_tpu_torch.ops.flash_attention import HEAD_DIMS, NEG_INF

VALID_DECODE_IMPLS = ("auto", "dense", "flash_decode", "paged")

KERNEL = Kernel("flash_decode", "flash_decode.cu", "rlt_flash_decode",
                "ppppppp" + "i" * 14 + "f" + "i" + "p")
#: the page-table walk: the same library, its own entry point and count
PAGED_KERNEL = Kernel("flash_decode_paged", "flash_decode.cu",
                      "rlt_flash_decode_paged",
                      "pppppppp" + "i" * 16 + "f" + "i" + "p")

#: cache rows of a kernel tile (``csrc/flash_decode.cu`` BK); a split's
#: chunk is a multiple of it
DECODE_TILE = 64
#: the rows of a tile each of the kernel's 4 warps takes (its own online
#: softmax; :func:`flash_decode_split_plain` repeats the grouping)
WARP_ROWS = 16
#: blocks a decode launch aims for on each SM, so that the live ones
#: (positions end most splits early) still fill the card
DECODE_BLOCKS_PER_SM = 8
#: fewest tiles a split walks where L has them: a 2-stage ring in flight
#: (64-row chunks lost 3-5% to 128 at one and four slots on the H100)
DECODE_MIN_CHUNK_TILES = 2
#: most tiles one split walks: longer contexts get more splits
DECODE_MAX_CHUNK_TILES = 16


@functools.lru_cache(maxsize=256)
def decode_split_plan(S: int, H: int, L: int, sms: int
                      ) -> "tuple[int, int]":
    """The decode kernels' split plan for ``S`` slots, ``H`` heads and a
    cache of ``L`` rows on a card of ``sms`` SMs: ``(chunk, n_split)``,
    split ``j`` of a (slot, head) taking rows ``[j * chunk, (j + 1) *
    chunk)``.

    From the shapes alone (the positions stay on the device: reading
    them would sync every layer).  ``chunk`` is a multiple of
    :data:`DECODE_TILE`, at most :data:`DECODE_MAX_CHUNK_TILES` tiles;
    ``n_split`` is the least count of such chunks covering ``L``, as
    close as the tiles allow to ``DECODE_BLOCKS_PER_SM * sms / (S * H)``
    with chunks of at least :data:`DECODE_MIN_CHUNK_TILES` tiles: on the
    H100's 132 SMs, 128-row chunks at S=1 or 4 (L=1024, H=12), 192 at
    S=16."""
    if min(S, H, L, sms) < 1:
        raise ValueError(f"decode_split_plan needs S, H, L, sms >= 1, got "
                         f"{(S, H, L, sms)}")
    tiles = -(-L // DECODE_TILE)
    want = -(-DECODE_BLOCKS_PER_SM * sms // (S * H))
    per = -(-tiles // min(tiles, want))
    per = min(max(per, DECODE_MIN_CHUNK_TILES), DECODE_MAX_CHUNK_TILES,
              tiles)
    return per * DECODE_TILE, -(-tiles // per)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The SMs of card ``index``: the plan's ``sms``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


#: per (device, stream): the kernels' int32 tickets (zero between
#: launches: the merging block resets its own) and fp32 workspace
_SCRATCH: "dict[tuple, tuple[torch.Tensor, torch.Tensor]]" = {}
#: every scratch tensor a larger launch replaced: a CUDA graph captured
#: over the old one keeps writing to its address, so it is never freed
_OUTGROWN: "list[torch.Tensor]" = []


def _scratch(device: torch.device, stream: int, cells: int,
             floats: int) -> "tuple[torch.Tensor, torch.Tensor]":
    """The tickets (``cells`` of them) and workspace (``floats``) of a
    launch on ``stream``: allocated once and grown, never per call (the
    decode step is host-bound).  Keyed by stream, so launches that share
    them run in order.  A grown buffer's predecessor stays allocated
    (``_OUTGROWN``): graphs captured before the growth replay into it.
    A capture must not be the first launch of its size on its stream,
    or the buffer would come from the graph's private pool (the serve
    engine warms every program on its capture stream first)."""
    key = (device.index, stream)
    tickets, ws = _SCRATCH.get(key, (None, None))
    if tickets is None or tickets.numel() < cells:
        if tickets is not None:
            _OUTGROWN.append(tickets)
        tickets = torch.zeros(cells, dtype=torch.int32, device=device)
    if ws is None or ws.numel() < floats:
        if ws is not None:
            _OUTGROWN.append(ws)
        ws = torch.empty(floats, dtype=torch.float32, device=device)
    _SCRATCH[key] = (tickets, ws)
    return tickets, ws


def resolve_decode_impl(value: "str | None" = None,
                        device: "torch.device | str" = "cuda") -> str:
    """Decode attention impl: explicit value > ``RLT_DECODE_IMPL`` env >
    ``auto`` (CUDA -> ``flash_decode``; elsewhere the dense path stays
    the default, as the JAX package keeps it off the TPU).  ``dense``,
    ``flash_decode`` and ``paged`` are explicit choices on any device
    (a CPU tensor takes the kernels' plain versions); ``paged`` walks a
    page table where the caller has one (serve/engine.py)."""
    v = (value or os.environ.get("RLT_DECODE_IMPL") or "auto").lower()
    if v not in VALID_DECODE_IMPLS:
        raise ValueError(
            f"RLT_DECODE_IMPL must be one of {VALID_DECODE_IMPLS}, "
            f"got {v!r}")
    if v == "auto":
        return ("flash_decode" if torch.device(device).type == "cuda"
                else "dense")
    return v


def _check(q, k_cache, v_cache, positions) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [S, 1, H, D], got {tuple(q.shape)}")
    S, _, H, D = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or (k_cache.shape[0], k_cache.shape[2], k_cache.shape[3]) \
            != (S, H, D):
        raise ValueError(
            f"caches must be [S, L, H, D] = [{S}, L, {H}, {D}], got "
            f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if positions.shape != (S,):
        raise ValueError(
            f"positions must be [S] = [{S}], got {tuple(positions.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(
            f"head_dim {D} not supported; the kernel takes {HEAD_DIMS}")
    if len({q.device, k_cache.device, v_cache.device,
            positions.device}) != 1:
        raise ValueError("q, caches and positions must be on one device")
    _check_int32(positions, "positions")


def _check_int32(x, name: str) -> None:
    """The kernels read ``positions`` and the page table as packed int32;
    checked on every device, so the CPU tests see what the card needs."""
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise TypeError(f"{name} must be contiguous int32, got {x.dtype} "
                        f"with strides {x.stride()}")


def flash_decode_attention_plain(q, k_cache, v_cache, positions):
    """The kernel's function in plain PyTorch.

    Slot ``s`` attends cache rows ``<= positions[s]`` (clamped to the
    cache, as the kernel clamps): fp32 scores, ``NEG_INF`` masking, a
    max-shifted softmax whose unnormalized ``p`` is rounded to the cache
    dtype before the PV product (fp32 accumulation), divided by the fp32
    sum — the rounding points of ``_decode_body``.  Returns
    ``[S, 1, H, D]`` in ``q``'s dtype.
    """
    D = q.shape[-1]
    L = k_cache.shape[1]
    pos = positions.long().clamp(0, L - 1)
    qf = q.float().permute(0, 2, 1, 3)                      # [S, H, 1, D]
    kf = k_cache.float().permute(0, 2, 3, 1)                # [S, H, D, L]
    vf = v_cache.float().permute(0, 2, 1, 3)                # [S, H, L, D]
    s = torch.matmul(qf, kf) * (1.0 / math.sqrt(D))         # [S, H, 1, L]
    live = torch.arange(L, device=q.device)[None, :] <= pos[:, None]
    s = s.masked_fill(~live[:, None, None, :], NEG_INF)
    # the kernel never reads a row past the position: zero those rows so
    # that whatever they hold (even NaN) cannot reach the product
    vf = vf.masked_fill(~live[:, None, :, None], 0.0)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v_cache.dtype).float(), vf)     # [S, H, 1, D]
    return (acc / l).to(q.dtype).permute(0, 2, 1, 3).contiguous()


def flash_decode_split_plain(q, k_cache, v_cache, positions, chunk: int):
    """The kernels' split-and-merge arithmetic in plain PyTorch.

    The function of :func:`flash_decode_attention_plain`, computed as
    ``csrc/flash_decode.cu`` orders it with a plan of ``chunk`` rows a
    split (a multiple of :data:`DECODE_TILE`, as
    :func:`decode_split_plan` gives): split ``j`` takes rows
    ``[j * chunk, (j + 1) * chunk)`` in 64-row tiles,
    each tile's rows in 4 groups of :data:`WARP_ROWS` (the kernel's
    warps); a group keeps its own online softmax (running max ``m``,
    ``p = exp(s - m)`` rounded to the cache dtype before the PV product,
    ``l`` summing the unrounded ``p``, the accumulator rescaled when
    ``m`` grows); the groups merge into the split's ``(m_j, l_j,
    acc_j)``, and the splits with a live row into ``o = sum e^(m_j - M)
    acc_j / sum e^(m_j - M) l_j`` with ``M = max m_j``.  Returns
    ``[S, 1, H, D]`` in ``q``'s dtype."""
    S, _, H, D = q.shape
    L = k_cache.shape[1]
    if chunk < DECODE_TILE or chunk % DECODE_TILE:
        raise ValueError(f"chunk must be a positive multiple of "
                         f"{DECODE_TILE}, got {chunk}")
    n = -(-L // chunk)
    G = DECODE_TILE // WARP_ROWS
    nt = chunk // DECODE_TILE
    pos = positions.long().clamp(0, L - 1)
    pad = n * chunk - L

    def tiles(x):   # [S, L, H, D] -> [S, H, n, nt, G, WARP_ROWS, D]
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.view(S, n, nt, G, WARP_ROWS, H, D).permute(
            0, 5, 1, 2, 3, 4, 6)

    kf, vf = tiles(k_cache), tiles(v_cache)
    rows = torch.arange(n * chunk, device=q.device).view(
        n, nt, G, WARP_ROWS)
    live = rows[None] <= pos.view(S, 1, 1, 1, 1)          # [S, n, nt, G, R]
    live = live[:, None]                                  # [S, 1, n, nt, G, R]
    qf = q.float().view(S, H, 1, 1, 1, 1, D)
    sc = (qf * kf).sum(-1) * (1.0 / math.sqrt(D))         # [S, H, n, nt, G, R]
    sc = sc.masked_fill(~live, NEG_INF)
    vf = vf.masked_fill(~live[..., None], 0.0)
    shape = (S, H, n, G)
    m = torch.full(shape, NEG_INF, device=q.device)
    l = torch.zeros(shape, device=q.device)
    acc = torch.zeros(shape + (D,), device=q.device)
    for t in range(nt):
        s_t = sc[:, :, :, t]                              # [S, H, n, G, R]
        m_new = torch.maximum(m, s_t.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(live[:, :, :, t], torch.exp(s_t - m_new[..., None]),
                        torch.zeros((), device=q.device))
        pb = p.to(v_cache.dtype).float()
        acc = acc * alpha[..., None] + (pb[..., None] * vf[:, :, :, t]).sum(-2)
        l = l * alpha + p.sum(-1)
        m = m_new

    def merge(m, l, acc, dim):
        M = m.amax(dim, keepdim=True)
        e = torch.exp(m - M)
        return (M.squeeze(dim), (e * l).sum(dim),
                (e[..., None] * acc).sum(dim))

    m, l, acc = merge(m, l, acc, 3)                       # the warps
    split_live = (torch.arange(n, device=q.device)[None] * chunk
                  <= pos[:, None])[:, None]               # [S, 1, n]
    m = m.masked_fill(~split_live, NEG_INF)
    _, l, acc = merge(m, l, acc, 2)                       # the splits
    return (acc / l[..., None]).to(q.dtype).view(S, 1, H, D)


def flash_decode_attention(q, k_cache, v_cache, positions):
    """Length-aware decode attention over the slot cache.

    ``q`` [S, 1, H, D]; ``k_cache``/``v_cache`` [S, L, H, D];
    ``positions`` [S] int32 on the same device; returns [S, 1, H, D].
    A CUDA tensor launches ``csrc/flash_decode.cu`` (bf16, head_dim in
    :data:`HEAD_DIMS`, unit stride over D, 16-byte-aligned rows) with
    :func:`decode_split_plan`'s split for the card's SMs; a CPU tensor
    takes :func:`flash_decode_attention_plain`.  It has no
    backward (nor has the JAX kernel): under grad mode with an input that
    requires grad it raises rather than return an output that autograd
    would silently cut off from its inputs.
    """
    _check(q, k_cache, v_cache, positions)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k_cache, v_cache)):
        raise RuntimeError(
            "flash_decode_attention has no backward: call it under "
            "torch.no_grad() / torch.inference_mode(), or with inputs "
            "that do not require grad")
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k_cache, v_cache, positions)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention: unsupported device "
                         f"{q.device}")
    S, _, H, D = q.shape
    L = k_cache.shape[1]
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_decode kernel takes bf16, {name} is "
                            f"{x.dtype}")
        if x.stride(3) != 1 or x.data_ptr() % 16 \
                or any(st % 8 for st in x.stride()[:3]):
            raise ValueError(
                f"flash_decode kernel needs unit stride over D and "
                f"16-byte aligned rows; {name} has strides {x.stride()}")
        if max(x.stride()[:3]) >= 2 ** 31:
            raise ValueError(f"{name} strides overflow int32")
    _check_grid(S)
    o = torch.empty(S, 1, H, D, dtype=q.dtype, device=q.device)
    if S == 0:
        return o
    chunk, n = decode_split_plan(S, H, L, _sm_count(q.device.index or 0))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets, ws = _scratch(q.device, stream, S * H, S * H * n * (D + 2))
    KERNEL.launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  positions.data_ptr(), o.data_ptr(), ws.data_ptr(),
                  tickets.data_ptr(), S, L, H, D,
                  q.stride(0), q.stride(2),
                  k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
                  v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
                  chunk, n, 1.0 / math.sqrt(D), q.device.index or 0, stream)
    return o


def _check_grid(S: int) -> None:
    """The kernels' grid is (head, slot, split): at most 65535 slots
    (CUDA's y limit; the split count is far below its z limit)."""
    if S > 65535:
        raise ValueError(f"grid (heads, {S}, splits) past CUDA's limits: "
                         f"at most 65535 slots")


def _check_paged(q, k_pages, v_pages, positions, table) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [S, 1, H, D], got {tuple(q.shape)}")
    S, _, H, D = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape \
            or (k_pages.shape[2], k_pages.shape[3]) != (H, D):
        raise ValueError(
            f"page views must be [N, page_size, H, D] = [N, page_size, "
            f"{H}, {D}], got {tuple(k_pages.shape)}, "
            f"{tuple(v_pages.shape)}")
    if table.dim() != 2 or table.shape[0] != S or table.shape[1] < 1:
        raise ValueError(f"page table must be [S, P] = [{S}, P], got "
                         f"{tuple(table.shape)}")
    if positions.shape != (S,):
        raise ValueError(
            f"positions must be [S] = [{S}], got {tuple(positions.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(
            f"head_dim {D} not supported; the kernel takes {HEAD_DIMS}")
    if len({q.device, k_pages.device, v_pages.device, positions.device,
            table.device}) != 1:
        raise ValueError(
            "q, page views, positions and table must be on one device")
    _check_int32(positions, "positions")
    _check_int32(table, "page table")


def _gather_pages(pages, table):
    """``pages`` [N, page_size, H, D] and ``table`` [S, P] -> each
    slot's logical rows [S, P * page_size, H, D]: logical page ``p`` of
    slot ``s`` is physical page ``table[s, p]`` (clamped into
    ``[0, N)``, as the kernel clamps it)."""
    N, ps = pages.shape[:2]
    S, P = table.shape
    idx = table.long().clamp(0, N - 1)
    return pages[idx].reshape(S, P * ps, *pages.shape[2:])


def flash_decode_paged_attention_plain(q, k_pages, v_pages, positions,
                                       table):
    """The paged kernel's function in plain PyTorch: gather each slot's
    logical rows through the table, then exactly
    :func:`flash_decode_attention_plain` (the same rounding points), so
    over the identity table it equals the slot-contiguous version bit
    for bit."""
    return flash_decode_attention_plain(q, _gather_pages(k_pages, table),
                                        _gather_pages(v_pages, table),
                                        positions)


def flash_decode_paged_attention(q, k_pages, v_pages, positions, table):
    """Length-aware decode attention through a page table.

    ``q`` [S, 1, H, D]; ``k_pages``/``v_pages`` [N, page_size, H, D],
    the physical page view (the slot cache ``[S, L, H, D]`` viewed as
    ``[S * L / page_size, page_size, H, D]``); ``positions`` [S] int32;
    ``table`` [S, P] int32: logical page ``p`` of slot ``s`` lives in
    physical page ``table[s, p]``; slot ``s`` attends its logical rows
    ``<= positions[s]`` of ``L = P * page_size``.  Returns
    [S, 1, H, D].  A CUDA tensor launches the row-14 kernel of
    ``csrc/flash_decode.cu`` (bf16, head_dim in :data:`HEAD_DIMS`, any
    page_size, unit stride over D, 16-byte-aligned rows, a contiguous
    table) with the split plan of the same ``L`` as
    :func:`flash_decode_attention`, so it equals that kernel bit for bit
    on the same logical cache; a CPU tensor takes
    :func:`flash_decode_paged_attention_plain`.  The table's values stay
    on the device (reading them would sync every layer): a physical page
    id outside ``[0, N)`` is clamped into it, never read out of bounds.
    No backward, as :func:`flash_decode_attention`.
    """
    _check_paged(q, k_pages, v_pages, positions, table)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k_pages, v_pages)):
        raise RuntimeError(
            "flash_decode_paged_attention has no backward: call it under "
            "torch.no_grad() / torch.inference_mode(), or with inputs "
            "that do not require grad")
    if q.device.type == "cpu":
        return flash_decode_paged_attention_plain(q, k_pages, v_pages,
                                                  positions, table)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_paged_attention: unsupported "
                         f"device {q.device}")
    S, _, H, D = q.shape
    N, ps = k_pages.shape[:2]
    P = table.shape[1]
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_decode_paged kernel takes bf16, "
                            f"{name} is {x.dtype}")
        if x.stride(3) != 1 or x.data_ptr() % 16 \
                or any(st % 8 for st in x.stride()[:3]):
            raise ValueError(
                f"flash_decode_paged kernel needs unit stride over D and "
                f"16-byte aligned rows; {name} has strides {x.stride()}")
        if max(x.stride()[:3]) >= 2 ** 31:
            raise ValueError(f"{name} strides overflow int32")
    if P * ps >= 2 ** 31 or N >= 2 ** 31:
        raise ValueError(f"{P} pages of {ps} rows overflow int32")
    _check_grid(S)
    o = torch.empty(S, 1, H, D, dtype=q.dtype, device=q.device)
    if S == 0:
        return o
    chunk, n = decode_split_plan(S, H, P * ps,
                                 _sm_count(q.device.index or 0))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets, ws = _scratch(q.device, stream, S * H, S * H * n * (D + 2))
    PAGED_KERNEL.launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        positions.data_ptr(), table.data_ptr(), o.data_ptr(),
        ws.data_ptr(), tickets.data_ptr(),
        S, N, P, ps, H, D, q.stride(0), q.stride(2),
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
        chunk, n, 1.0 / math.sqrt(D), q.device.index or 0, stream)
    return o


__all__ = ["DECODE_TILE", "KERNEL", "NEG_INF", "PAGED_KERNEL",
           "VALID_DECODE_IMPLS", "decode_split_plan",
           "flash_decode_attention", "flash_decode_attention_plain",
           "flash_decode_paged_attention",
           "flash_decode_paged_attention_plain", "flash_decode_split_plain",
           "resolve_decode_impl"]
