"""Sort-based segmented reductions for duplicate-heavy aggregation.

Port of merian_quake_tpu/ops/segments.py in its sort-based form: rows
are sorted by cell into contiguous segments (a secondary key parks a
chosen "winner" row at each segment END), per-cell math runs on a
compacted array of segment-end rows, per-cell sums are adjacent
differences of a cumulative sum taken at the compacted end rows, and
per-row broadcast of per-cell results goes through a small (S, K)
scratch table.

Where the JAX package sorts all operands by two keys in one
``lax.sort``, this computes the permutation once from a single int64 key
(cell in the high half, an order-preserving image of the tiebreak in the
low half; stable, so equal keys keep row order) and gathers the columns.
Nothing here reads a device value from the host.

Weighted-reservoir winner selection uses the Efraimidis–Spirakis
exponential race: winner = min over the segment of -log(u)/weight; the
callers sort by the NEGATED race key ascending so the winner lands on
the segment end row, where compaction picks it up.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class Segments(NamedTuple):
    """Sorted segment structure over M rows.

    ``cell`` is ascending; rows whose input cell was the sentinel (any
    value >= the live-cell range chosen by the caller) sort last and
    form ordinary (ignorable) segments.
    """

    cell: torch.Tensor  # i32[M] ascending
    is_start: torch.Tensor  # bool[M] first row of its segment
    is_end: torch.Tensor  # bool[M] last row of its segment


def _order_image(key: torch.Tensor) -> torch.Tensor:
    """Order-preserving image of an f32 or i32 key in [0, 2^32), int64.
    Floats: -0 equals +0, NaN sorts last (the total order of the JAX
    package's sort)."""
    if key.dtype.is_floating_point:
        key = key.to(torch.float32)
        bits = (key + 0.0).contiguous().view(torch.int32).to(torch.int64)
        img = torch.where(bits < 0, ~bits & 0xFFFFFFFF, bits | 0x80000000)
        return torch.where(torch.isnan(key), 0xFFFFFFFF, img)
    return key.to(torch.int64) + (1 << 31)


def sort_segments(
    cell: torch.Tensor,
    values: Sequence[torch.Tensor],
    tiebreak: torch.Tensor | None = None,
) -> tuple[Segments, list[torch.Tensor]]:
    """Sort rows by (cell, tiebreak) ascending and build Segments.

    ``values``: (M,) or (M, K) tensors carried through the sort. With a
    ``tiebreak`` key (f32 or i32), the row with the LARGEST tiebreak in
    each segment ends up at the segment end (`is_end` row) — pass the
    negated reservoir race key to make the winner readable there.
    """
    cell = cell.to(torch.int32)
    key = cell.to(torch.int64)
    if tiebreak is not None:
        key = (key << 32) + _order_image(tiebreak)
    perm = torch.sort(key, stable=True).indices
    cell_s = cell[perm]
    vals_s = [v[perm] for v in values]

    edge = torch.full((1,), -1, dtype=torch.int32, device=cell.device)
    prev = torch.cat([edge, cell_s[:-1]])
    nxt = torch.cat([cell_s[1:], edge])
    return (
        Segments(cell=cell_s, is_start=cell_s != prev, is_end=cell_s != nxt),
        vals_s,
    )


class Compact(NamedTuple):
    """Per-segment (one row per touched cell) view of a sorted array.

    ``idx`` holds the positions of the first ``capacity`` segment-end
    rows (ascending = cell order); overflow segments are DROPPED.
    ``valid`` masks unused rows.
    """

    idx: torch.Tensor  # i64[capacity] end-row positions (M = none)
    valid: torch.Tensor  # bool[capacity]


def compact_indices(segs: Segments, capacity: int) -> Compact:
    """ONE single-operand sort: positions of segment-end rows, packed."""
    m = segs.cell.shape[0]
    iota = torch.arange(m, dtype=torch.int64, device=segs.cell.device)
    k = torch.where(segs.is_end, iota, m)
    idx = torch.sort(k).values[:capacity]
    if idx.shape[0] < capacity:  # tiny inputs (tests)
        idx = torch.nn.functional.pad(idx, (0, capacity - idx.shape[0]), value=m)
    return Compact(idx=idx, valid=idx < m)


def take_compact(comp: Compact, cols: torch.Tensor, fill=0) -> torch.Tensor:
    """Gather rows at the compacted end positions (a capacity-row take).
    Invalid rows read row 0 and are overwritten with ``fill``."""
    safe = torch.where(comp.valid, comp.idx, 0)
    out = cols[safe]
    mask = comp.valid
    if cols.dim() > 1:
        mask = mask[:, None]
    return torch.where(mask, out, torch.full((), fill, dtype=cols.dtype, device=cols.device))


# the chunk of :func:`scan_rows`' first level (elements of a row)
SCAN_CHUNK = 1024


def scan_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive sums along dim 1 of a contiguous (R, M) tensor, in an
    association fixed by the shapes alone, so a run repeats bit for bit.

    On the CPU this is ``torch.cumsum`` (a sequential scan). On the card
    torch sends a scan over a single row to CUB's look-back scan, whose
    float sums associate by timing (two frames from one state part in
    the guiding table), so the card runs :func:`chunked_scan`."""
    return chunked_scan(x) if x.is_cuda else torch.cumsum(x, dim=1)


def chunked_scan(x: torch.Tensor) -> torch.Tensor:
    """:func:`scan_rows` in chunks of SCAN_CHUNK elements: each chunk is
    scanned alone (torch's row scan over R·M/SCAN_CHUNK rows, one order),
    the chunks' totals are scanned the same way, and each chunk adds the
    sum of the chunks before it. A single row is scanned beside a row of
    zeros, so that torch never takes CUB's path."""
    r, m = x.shape
    if m <= SCAN_CHUNK:
        if r == 1:
            return torch.cumsum(torch.cat([x, torch.zeros_like(x)]), dim=1)[:1]
        return torch.cumsum(x, dim=1)
    b = -(-m // SCAN_CHUNK)
    xp = torch.nn.functional.pad(x, (0, b * SCAN_CHUNK - m)).view(r * b, SCAN_CHUNK)
    inner = torch.cumsum(xp, dim=1).view(r, b, SCAN_CHUNK)
    before = chunked_scan(inner[:, :, -1].contiguous())  # (r, b) chunk prefix totals
    before = torch.cat([torch.zeros_like(before[:, :1]), before[:, :-1]], dim=1)
    return (inner + before[:, :, None]).view(r, b * SCAN_CHUNK)[:, :m]


def compact_sums(comp: Compact, cols: torch.Tensor) -> torch.Tensor:
    """Per-segment totals on the compacted rows.

    ``cols``: f32[M] or f32[M, K] of per-row addends (already masked).
    cumsum + capacity-row gather + adjacent difference — the previous
    compacted row is exactly the previous segment's end, so no start
    index is ever materialized. The scan is :func:`scan_rows`, so the
    totals repeat bit for bit on the card.
    """
    squeeze = cols.dim() == 1
    if squeeze:
        cols = cols[:, None]
    # the scan runs along the contiguous dim of a (K, M) layout: along
    # dim 0 of (M, K) torch's CUDA scan took 541 ms a call at M = 2-4
    # million rows, K = 4-8 (NVIDIA H100 80GB HBM3, 700 W)
    cum = scan_rows(cols.T.contiguous()).T
    at_end = take_compact(comp, cum)  # (cap, K)
    prev = torch.cat([torch.zeros_like(at_end[:1]), at_end[:-1]], dim=0)
    tot = at_end - prev
    return tot[:, 0] if squeeze else tot


def scatter_rows(table: torch.Tensor, idx: torch.Tensor, rows) -> torch.Tensor:
    """``table`` with ``rows`` written at ``idx`` along dim 0, out of
    place. A row whose index is ``table.shape[0]`` (the callers'
    sentinel) is dropped: it lands in a scratch row past the end that is
    sliced off, so no mask is read on the host. The live indices must be
    unique."""
    n = table.shape[0]
    out = torch.cat([table, torch.zeros_like(table[:1])], dim=0)
    if isinstance(rows, torch.Tensor):
        out[idx.to(torch.int64)] = rows
    else:  # a number: filled on the device, not copied from the host
        out.index_fill_(0, idx.to(torch.int64), rows)
    return out[:n]


def scatter_table(
    comp: Compact, cell: torch.Tensor, cols: torch.Tensor, size: int, fill=0
) -> torch.Tensor:
    """Scatter compacted per-cell rows into a dense (size, K) table
    (capacity-row scatter; table gathers are the per-row broadcast).
    ``cell``: i32[capacity] target cells."""
    idx = torch.where(comp.valid & (cell < size), cell.to(torch.int64), size)
    out = torch.full((size,) + tuple(cols.shape[1:]), fill, dtype=cols.dtype, device=cols.device)
    return scatter_rows(out, idx, cols)
