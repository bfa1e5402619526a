"""World-space hash-grid index math for the guiding caches.

Port of merian_quake_tpu/ops/hashgrid.py, bit-exact on integer inputs.
Two independent hashes per cell: a primary hash for the buffer slot and
a 16-bit verification hash to detect collisions (collision → state
reset).

Cell indices are signed int32 tensors. Hashes are u32 values held in
int64 tensors in [0, 2^32), as in ops/rng.py: a signed index enters a
hash by its two's-complement bits (``rng._u32`` masks, never clamps),
and every multiply, add and left shift is masked back to 32 bits. A slot
is smaller than the table size, so it indexes a table as it is.

These are the plain versions of the hash-grid chains: on CUDA tensors a
whole cell selection (render/mcpg/grids.py::cell) is one launch of
csrc/u32_chains.cu, whose hashes and slots (csrc/hash_grid.cuh) follow
these functions in native u32.
"""
from __future__ import annotations

import torch

from .rng import _M32, _mul32, _u32


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 value in int64 → int32 with the same bits (values ≥ 2^31
    become negative). Written out: an out-of-range narrowing conversion
    is not the same on every device."""
    x = x.to(torch.int64)
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def grid_idx_closest(pos: torch.Tensor, width) -> torch.Tensor:
    """Cell index of the nearest cell center: round(pos/width). int32[..., 3]."""
    return torch.round(pos / width).to(torch.int32)


def grid_idx_interpolate(pos: torch.Tensor, width, u3: torch.Tensor) -> torch.Tensor:
    """Stochastic trilinear cell selection.

    Chooses one of the 8 surrounding cells with trilinear-weight
    probability: floor(pos/width - 0.5 + u3) where u3 ~ U[0,1)^3 (pos
    measured relative to cell centers).
    """
    return torch.floor(pos / width - 0.5 + u3).to(torch.int32)


def _hash_coords(vals) -> torch.Tensor:
    """xxhash-style avalanche over a list of u32 coordinates."""
    first = next(v for v in vals if isinstance(v, torch.Tensor))
    h = _u32(0x9E3779B1, first)
    for v in vals:
        v = _u32(v, first)
        h = h ^ _mul32(v, 0x85EBCA77)
        h = ((h << 13) & _M32) | (h >> 19)
        h = _mul32(h, 0xC2B2AE3D)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    return h


def _hash2_coords(vals) -> torch.Tensor:
    """Independent second hash (different constants) for verification."""
    first = next(v for v in vals if isinstance(v, torch.Tensor))
    h = _u32(0x27220A95, first)
    for v in vals:
        v = _u32(v, first)
        h = _mul32((h + _mul32(v, 0x165667B1)) & _M32, 0x01000193)
        h = h ^ (h >> 17)
    return h


def quantize_normal(normal: torch.Tensor) -> torch.Tensor:
    """Dominant-axis bucket 0..5 so states are split per face
    orientation (first-max tie-break like argmax)."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    ax, ay, az = nx.abs(), ny.abs(), nz.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    axis = torch.where(is_x, 0, torch.where(is_y, 1, 2))
    val = torch.where(is_x, nx, torch.where(is_y, ny, nz))
    return axis * 2 + (val < 0.0).to(torch.int64)


def _tiled_slot(idx, extra, size, tile_bits: int):
    """Locality-preserving slot: hash the TILE (idx >> tile_bits per
    axis), place the cell at bucket·T + linearized sub-coordinate
    (T = 8^tile_bits consecutive rows per tile). Arithmetic shift and
    mask on the signed index give floor semantics for negative cells."""
    t = 1 << (3 * tile_bits)
    mask = (1 << tile_bits) - 1
    sub = idx & mask  # per-axis 0..2^b-1, non-negative for any idx
    sub_lin = (
        sub[..., 0] | (sub[..., 1] << tile_bits) | (sub[..., 2] << (2 * tile_bits))
    ).to(torch.int64)
    tile = idx >> tile_bits
    h = _hash_coords([tile[..., 0], tile[..., 1], tile[..., 2]] + list(extra))
    buckets = max(int(size) // t, 1)
    return ((h % buckets) * t + sub_lin) & _M32


def hash_grid(idx: torch.Tensor, size, tile_bits: int = 0) -> torch.Tensor:
    """Primary slot for a cell: hash(idx) % size.

    ``tile_bits`` > 0 switches to the locality-preserving tiled layout
    (see _tiled_slot); 0 is the fully-scrambled layout."""
    if tile_bits:
        return _tiled_slot(idx, [], size, tile_bits)
    h = _hash_coords([idx[..., 0], idx[..., 1], idx[..., 2]])
    return h % int(size)


def hash_grid_normal_level(idx, normal, level, size, tile_bits: int = 0) -> torch.Tensor:
    """Primary slot including quantized normal and grid level."""
    if tile_bits:
        return _tiled_slot(idx, [quantize_normal(normal), level], size, tile_bits)
    h = _hash_coords(
        [idx[..., 0], idx[..., 1], idx[..., 2], quantize_normal(normal), level]
    )
    return h % int(size)


def hash2_grid(idx) -> torch.Tensor:
    """16-bit verification hash of a cell."""
    return _hash2_coords([idx[..., 0], idx[..., 1], idx[..., 2]]) & 0xFFFF


def hash2_grid_level(idx, level) -> torch.Tensor:
    """16-bit verification hash including the level."""
    return _hash2_coords([idx[..., 0], idx[..., 1], idx[..., 2], level]) & 0xFFFF
