"""ops/segments.py: port against JAX package and a naive per-cell reference.

Twins of tests/test_segments.py (all eight), each also holding the
port's integers (sorted cells, carried columns, segment flags, compact
indices, valid masks, winner rows) bit for bit against the JAX
package's on the same numpy inputs. ``compact_sums`` differences of an
f32 cumulative sum: held to rtol 2e-4 / atol 1e-4 against a float64
bincount (as tests/test_segments.py:61) and to rtol 1e-4 / atol 2e-5
against the JAX package's (read: max |Δ| 3.1e-5 on sums of magnitude
up to 130).
"""
import jax.numpy as jnp
import numpy as np
import torch

from merian_quake_tpu.ops import segments as j_seg
from merian_quake_tpu_torch.ops import segments as t_seg

torch.set_num_threads(min(2, torch.get_num_threads()))

T = torch.from_numpy


def _both(cells, values, tiebreak=None):
    js, jv = j_seg.sort_segments(
        jnp.asarray(cells), [jnp.asarray(v) for v in values],
        tiebreak=None if tiebreak is None else jnp.asarray(tiebreak),
    )
    ts, tv = t_seg.sort_segments(
        T(cells), [T(v) for v in values], tiebreak=None if tiebreak is None else T(tiebreak)
    )
    for f in ("cell", "is_start", "is_end"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
    return js, jv, ts, tv


def _same_compact(jc, tc):
    np.testing.assert_array_equal(tc.idx.numpy(), np.asarray(jc.idx).astype(np.int64))
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))


def test_sort_segments_structure(rng):
    m, s = 4096, 37
    cells = rng.integers(0, s, m).astype(np.int32)
    vals = rng.normal(size=m).astype(np.float32)
    js, (jv,), segs, (v,) = _both(cells, [vals])
    # stable: equal cells keep row order, so the carried column is equal
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    cs = segs.cell.numpy()
    assert (np.diff(cs) >= 0).all()
    np.testing.assert_allclose(np.sort(v.numpy()[cs == 5]), np.sort(vals[cells == 5]))
    is_start, is_end = segs.is_start.numpy(), segs.is_end.numpy()
    assert is_start[0] and is_end[-1]
    assert (is_start[1:] == (cs[1:] != cs[:-1])).all()
    assert (is_end[:-1] == (cs[:-1] != cs[1:])).all()


def test_compact_indices_are_end_rows_in_cell_order(rng):
    m, s = 2048, 23
    cells = rng.integers(0, s, m).astype(np.int32)
    js, _, segs, _ = _both(cells, [])
    cap = 64
    comp = t_seg.compact_indices(segs, cap)
    _same_compact(j_seg.compact_indices(js, cap), comp)
    idx, valid = comp.idx.numpy(), comp.valid.numpy()
    uniq = np.unique(cells)
    assert valid.sum() == len(uniq)
    cs = segs.cell.numpy()
    np.testing.assert_array_equal(cs[idx[valid]], uniq)
    assert segs.is_end.numpy()[idx[valid]].all()
    cc = t_seg.take_compact(comp, segs.cell, fill=s)
    np.testing.assert_array_equal(cc.numpy()[valid], uniq)


def test_tiebreak_winner_at_compact_rows(rng):
    m, s = 2048, 11
    cells = rng.integers(0, s, m).astype(np.int32)
    race = rng.random(m).astype(np.float32)
    payload = np.arange(m, dtype=np.int32)
    js, (jp,), segs, (p,) = _both(cells, [payload], tiebreak=-race)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))  # the whole order
    comp = t_seg.compact_indices(segs, s)
    win = t_seg.take_compact(comp, p).numpy()
    np.testing.assert_array_equal(
        win, np.asarray(j_seg.take_compact(j_seg.compact_indices(js, s), jp)))
    for k, c in enumerate(np.unique(cells)):
        want = payload[cells == c][np.argmin(race[cells == c])]
        assert win[k] == want, c


def test_tiebreak_order_of_signed_zero_ties_and_int_keys(rng):
    """Two keys in one pass: -0 equals +0, equal keys keep row order,
    -3e38 (the replay's dead rows) sorts first in its cell; an int32
    tiebreak (the light cache's global row index, -1 on dead rows)
    orders like the JAX package's."""
    m, s = 4096, 13
    cells = rng.integers(0, s, m).astype(np.int32)
    key = rng.choice(np.asarray([0.0, -0.0, -3e38, -1.5, 2.0, -1e-30, 1e-30], np.float32), m)
    payload = np.arange(m, dtype=np.int32)
    _, (jp,), _, (p,) = _both(cells, [payload], tiebreak=key)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    ikey = rng.integers(-1, 50, m).astype(np.int32)
    _, (jp,), _, (p,) = _both(cells, [payload], tiebreak=ikey)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


def test_compact_sums_match_bincount(rng):
    m, s = 8192, 97
    cells = rng.integers(0, s, m).astype(np.int32)
    vals = rng.normal(size=(m, 3)).astype(np.float32)
    js, jcols, segs, cols = _both(cells, [vals[:, i] for i in range(3)])
    cap = 128
    comp = t_seg.compact_indices(segs, cap)
    tot = t_seg.compact_sums(comp, torch.stack(cols, dim=1)).numpy()
    j_tot = np.asarray(j_seg.compact_sums(j_seg.compact_indices(js, cap), jnp.stack(jcols, axis=1)))
    np.testing.assert_allclose(tot, j_tot, rtol=1e-4, atol=2e-5)
    want = np.stack([np.bincount(cells, vals[:, i].astype(np.float64), s) for i in range(3)], 1)
    uniq = np.unique(cells)
    np.testing.assert_allclose(tot[: len(uniq)], want[uniq], rtol=2e-4, atol=1e-4)


def test_compact_capacity_drops_overflow(rng):
    m, s = 1024, 50
    cells = rng.integers(0, s, m).astype(np.int32)
    js, _, segs, _ = _both(cells, [])
    cap = 8
    comp = t_seg.compact_indices(segs, cap)
    _same_compact(j_seg.compact_indices(js, cap), comp)
    assert comp.idx.shape == (cap,)
    cc = t_seg.take_compact(comp, segs.cell, fill=s).numpy()
    np.testing.assert_array_equal(cc, np.unique(cells)[:cap])
    vals = np.ones(m, np.float32)
    _, (v,) = t_seg.sort_segments(T(cells), [T(vals)])
    tot = t_seg.compact_sums(comp, v).numpy()
    for k, c in enumerate(np.unique(cells)[:cap]):
        assert tot[k] == (cells == c).sum()


def test_scatter_table_roundtrip(rng):
    m, s = 1024, 19
    cells = rng.integers(0, s, m).astype(np.int32)
    cells[cells == 4] = 5  # an untouched cell keeps the fill
    vals = rng.normal(size=m).astype(np.float32)
    js, (jv,), segs, (v,) = _both(cells, [vals])
    comp = t_seg.compact_indices(segs, s + 1)
    cell_c = t_seg.take_compact(comp, segs.cell, fill=s)
    ends = t_seg.take_compact(comp, v)
    tab = t_seg.scatter_table(comp, cell_c, ends[:, None], s + 1, fill=-7.0)
    jc = j_seg.compact_indices(js, s + 1)
    j_tab = j_seg.scatter_table(
        jc, j_seg.take_compact(jc, js.cell, fill=s), j_seg.take_compact(jc, jv)[:, None],
        s + 1, fill=-7.0,
    )
    np.testing.assert_array_equal(tab.numpy(), np.asarray(j_tab))
    assert tab[4, 0] == -7.0 and tab.shape == (s + 1, 1)
    back = tab[:, 0][segs.cell.long()].numpy()
    cs, v = segs.cell.numpy(), v.numpy()
    for c in np.unique(cells):
        np.testing.assert_allclose(back[cs == c], v[cs == c][-1])


def test_scatter_rows_drops_the_sentinel():
    table = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    idx = torch.tensor([6, 2, 6, 0, 6])
    rows = torch.full((5, 2), -1.0)
    out = t_seg.scatter_rows(table, idx, rows)
    assert out.shape == table.shape
    assert (out[[0, 2]] == -1.0).all() and torch.equal(out[[1, 3, 4, 5]], table[[1, 3, 4, 5]])
    assert table[0, 0] == 0.0  # out of place


def test_sentinel_rows_sort_last(rng):
    m, s = 512, 7
    cells = rng.integers(0, s, m).astype(np.int32)
    mask = rng.random(m) < 0.3
    cells_m = np.where(mask, cells, s).astype(np.int32)
    _, _, segs, _ = _both(cells_m, [])
    cs = segs.cell.numpy()
    assert (cs[: mask.sum()] < s).all()
    assert (cs[mask.sum():] == s).all()


def test_padded_capacity_beyond_m(rng):
    m, s = 64, 7
    cells = rng.integers(0, s, m).astype(np.int32)
    js, _, segs, _ = _both(cells, [])
    comp = t_seg.compact_indices(segs, 256)
    _same_compact(j_seg.compact_indices(js, 256), comp)
    assert comp.idx.shape == (256,)
    assert comp.valid.numpy().sum() == len(np.unique(cells))
    x = t_seg.take_compact(comp, segs.cell.to(torch.float32), fill=-1.0).numpy()
    assert (x[len(np.unique(cells)):] == -1.0).all()
