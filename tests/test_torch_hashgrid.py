"""ops/hashgrid.py: port against JAX package, same numpy inputs.

Integer stages (index → slot, index → verification hash, the tiled
layout) are held bit for bit, on indices that include negative cells and
levels. The float → integer stages (cell selection, normal bucket) get
the same float inputs; they are single IEEE operations followed by a
floor or a compare, so they too are equal on every row here (read:
100%), and the tests say so.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu.ops import hashgrid as j_hg
from merian_quake_tpu_torch.ops import hashgrid as t_hg
from merian_quake_tpu_torch.ops import rng as rng_ops

torch.set_num_threads(min(2, torch.get_num_threads()))


def _idx(seed, n=4096, lo=-100000, hi=100000):
    idx = np.random.default_rng(seed).integers(lo, hi, size=(n, 3)).astype(np.int32)
    # the corners of the int32 range and small negative cells
    idx[:8] = [[-1, -1, -1], [0, 0, 0], [-2**31, 2**31 - 1, -1], [1, -1, 0],
               [-7, 8, -9], [2**31 - 1] * 3, [-2**31] * 3, [-1, 0, 1]]
    return idx


@pytest.mark.parametrize("size", [4096, 1 << 17, 147456, 800009])
@pytest.mark.parametrize("tile_bits", [0, 1, 2])
def test_hash_grid_slots_bit_exact(size, tile_bits):
    idx = _idx(3)
    want = np.asarray(j_hg.hash_grid(jnp.asarray(idx), size, tile_bits=tile_bits))
    got = t_hg.hash_grid(torch.from_numpy(idx), size, tile_bits=tile_bits)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert got.max() < size and got.min() >= 0


@pytest.mark.parametrize("tile_bits", [0, 2])
def test_hash_grid_normal_level_bit_exact(tile_bits):
    rng = np.random.default_rng(5)
    idx = _idx(4)
    normal = rng.normal(size=(idx.shape[0], 3)).astype(np.float32)
    level = rng.integers(0, 40, idx.shape[0]).astype(np.int32)
    level[:4] = [-1, 0, 39, -3]  # a negative level enters by its bits
    want = np.asarray(j_hg.hash_grid_normal_level(
        jnp.asarray(idx), jnp.asarray(normal), jnp.asarray(level).astype(jnp.uint32),
        1 << 16, tile_bits=tile_bits,
    ))
    got = t_hg.hash_grid_normal_level(
        torch.from_numpy(idx), torch.from_numpy(normal), torch.from_numpy(level),
        1 << 16, tile_bits=tile_bits,
    )
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_verification_hashes_bit_exact():
    idx = _idx(6)
    level = np.random.default_rng(7).integers(-2, 40, idx.shape[0]).astype(np.int32)
    want = np.asarray(j_hg.hash2_grid(jnp.asarray(idx)))
    np.testing.assert_array_equal(
        t_hg.hash2_grid(torch.from_numpy(idx)).numpy(), want.astype(np.int64))
    want = np.asarray(j_hg.hash2_grid_level(
        jnp.asarray(idx), jnp.asarray(level).astype(jnp.uint32)))
    got = t_hg.hash2_grid_level(torch.from_numpy(idx), torch.from_numpy(level))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert got.max() <= 0xFFFF


def test_quantize_normal_buckets_and_ties():
    n = np.asarray(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
         [1, 1, 0], [0, 1, 1], [1, 0, 1], [1, 1, 1], [-1, -1, -1], [0, 0, 0],
         [-0.0, -0.0, -0.0], [0.5, -0.5, 0.5]], np.float32,
    )
    rnd = np.random.default_rng(8).normal(size=(4096, 3)).astype(np.float32)
    n = np.concatenate([n, rnd, np.round(rnd)])  # rounded: many exact ties
    want = np.asarray(j_hg.quantize_normal(jnp.asarray(n)))
    got = t_hg.quantize_normal(torch.from_numpy(n)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert len(set(got[:6].tolist())) == 6


def test_grid_idx_interpolate_weights_and_equal_cells():
    # a point at fraction fx inside a cell (relative to centers) selects
    # the neighbor cell with trilinear probability
    pos = np.full((20000, 3), [10.3, 0.0, 0.0], np.float32)
    u = np.random.default_rng(2).uniform(size=(20000, 3)).astype(np.float32)
    idx = t_hg.grid_idx_interpolate(torch.from_numpy(pos), 1.0, torch.from_numpy(u)).numpy()
    assert idx.dtype == np.int32
    assert abs((idx[:, 0] == 10).mean() - 0.8) < 0.02
    assert set(np.unique(idx[:, 0])) == {9, 10}
    # the same floats through both packages, per-row widths and negative
    # positions: share of equal cells stated (read: 1.0)
    rng = np.random.default_rng(9)
    pos = (rng.normal(size=(20000, 3)) * 300.0).astype(np.float32)
    width = rng.uniform(0.01, 30.0, size=(20000, 1)).astype(np.float32)
    want = np.asarray(j_hg.grid_idx_interpolate(jnp.asarray(pos), jnp.asarray(width), jnp.asarray(u)))
    got = t_hg.grid_idx_interpolate(torch.from_numpy(pos), torch.from_numpy(width), torch.from_numpy(u)).numpy()
    assert (got == want).all(-1).mean() == 1.0
    assert (got < 0).any()
    want = np.asarray(j_hg.grid_idx_closest(jnp.asarray(pos), jnp.asarray(width)))
    got = t_hg.grid_idx_closest(torch.from_numpy(pos), torch.from_numpy(width)).numpy()
    assert (got == want).all(-1).mean() == 1.0


def test_hash_spread_and_independence():
    idx = torch.from_numpy(_idx(3, n=5000, lo=-100, hi=100))
    h = t_hg.hash_grid(idx, 1 << 16).numpy()
    h2 = t_hg.hash2_grid(idx).numpy()
    assert len(np.unique(t_hg.hash_grid(idx[:1000], 4096).numpy())) > 700
    assert abs(np.corrcoef(h, h2)[0, 1]) < 0.05


def test_u32_wraps_written_out():
    x = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.int64)
    i = t_hg.u32_to_i32(x)
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(x.numpy(), np.uint32).astype(np.int32))
    back = rng_ops._u32(i, i)
    np.testing.assert_array_equal(back.numpy(), x.numpy())
    assert int(rng_ops._u32(-1, i)) == 0xFFFFFFFF
