"""Row-slab rendering (parallel/render.py, post/sharded.py), port against
both packages' single-device frames: the PT frame, the denoised PT frame,
the slab context's exchanges, the queue regroup, and a halo mutant.

Four gloo ranks on the CPU, spawned once for the file
(tests/torch_parallel_cases.py), each rendering its slab through
``render_frame_sharded``; the slabs are stitched here. Tolerances are
tests/test_parallel.py's own (the JAX package's sharded frame against its
single-device one), held against the port's single-device frame and
against the JAX package's:

- PT (48×32, 8-row slabs, 1 frame): ldr and accum_irradiance within 2e-6
  of the port's frame (read: equal); ldr within 2e-6 of the JAX
  package's jitted frame (read: equal), accum_irradiance by the port's
  image rule against the JAX package (≥ 99.5% of pixels within 1e-3,
  mean |Δ| < 1e-4; read: 100%, 1.8e-7: XLA contracts multiply-adds).
- Denoised PT (48×32, 8-row slabs: the à-trous steps 1, 2 and 4 read
  halos, 8 and 16 the gathered image; 3 frames): hdr within 1e-4,
  svgf.irr within 1e-5, history lengths equal, ldr off by more than 1e-3
  on < 2% of pixels and by < 0.1 anywhere. Read against the port's
  frame: hdr, svgf.irr, history equal, ldr max 5.8e-5 (the exposure mean
  is an all-reduce of the slabs' means). The JAX package's jitted run
  spreads from its own op-by-op run on this scene (ldr 49% of pixels
  within 1e-3; flat walls leave the à-trous luminance weight ~0/0), and
  the port follows the op-by-op run, which is the reference here (read:
  hdr max 3.9e-7, svgf equal, ldr 99.8% within 1e-3, max 2.3e-3).
- Mutant: halos of the slab's own edge rows in place of the neighbour's
  rows fail the denoise bound (read: hdr off by 0.38).
"""
import numpy as np
import pytest
import torch

import torch_parallel_cases as C

torch.set_num_threads(min(2, torch.get_num_threads()))

NAMES = ("collectives", "pt", "denoise", "denoise_edge_halo")


@pytest.fixture(scope="module")
def runs():
    return C.sharded_runs(NAMES)


def test_collectives(runs):
    """halo_pad, roll1, gather_rows, gather_flat and mean on every rank
    against the same operations on the whole image."""
    from merian_quake_tpu_torch.render import layout

    parts = runs["collectives"]
    n, rows, width = len(parts), 6, 5
    y = torch.arange(rows * n, dtype=torch.float32)[:, None]
    whole = torch.stack([y * 10 + torch.arange(width), -(y * 10 + torch.arange(width))], -1)
    clamp = lambda i: whole[min(max(i, 0), rows * n - 1)]
    flat_whole = torch.cat([whole[r * rows:(r + 1) * rows].reshape(-1, 2) for r in range(n)])
    rolled = torch.roll(flat_whole, 1, 0)
    for r, p in enumerate(parts):
        halo = torch.stack([clamp(i) for i in range(r * rows - 2, (r + 1) * rows + 2)])
        np.testing.assert_array_equal(p["halo"], halo.numpy())
        np.testing.assert_array_equal(p["roll"], rolled[r * rows * width:(r + 1) * rows * width])
        np.testing.assert_array_equal(p["rows"], whole.numpy())
        np.testing.assert_array_equal(p["flat"], layout.image_to_flat(whole, width, rows * n))
        assert float(p["mean"]) == (n - 1) / 2


def test_regroup_restores_the_whole_image_order():
    """``regroup`` of (group, pixel)-ordered slab queues is the whole
    image's (group, pixel) order; without the transpose it is not. (Every
    gather of the frame is at groups = 1, where both are the slabs' rows
    end to end: the frame-level mutant is the MCPG file's local gather.)"""
    from merian_quake_tpu_torch.parallel.render import regroup

    n, groups, per = 4, 3, 5
    whole = torch.arange(groups * n * per).reshape(groups, n * per)  # (group, pixel)
    slabs = torch.stack([whole[:, r * per:(r + 1) * per].reshape(-1) for r in range(n)])
    assert torch.equal(regroup(slabs, groups), whole.reshape(-1))
    assert torch.equal(regroup(slabs, 1), slabs.reshape(-1))
    mutant = slabs.reshape(-1)  # the slabs end to end, no transpose
    assert not torch.equal(mutant, whole.reshape(-1))


@pytest.fixture(scope="module")
def pt_refs():
    return C.port_single("pt"), C.jax_single("pt")


def test_pt_matches_single_device(runs, pt_refs):
    parts, (port, jx) = runs["pt"], pt_refs
    for key in ("ldr", "accum_irradiance"):
        np.testing.assert_allclose(C.stitch(parts, key), port[key], atol=2e-6)
    np.testing.assert_allclose(C.stitch(parts, "ldr"), jx["ldr"], atol=2e-6)
    C.assert_within(C.stitch(parts, "accum_irradiance"), jx["accum_irradiance"], 0.995, 1e-4)


def _denoise_bound(parts, ref):
    np.testing.assert_allclose(C.stitch(parts, "hdr"), ref["hdr"], atol=1e-4)
    np.testing.assert_allclose(C.stitch(parts, "svgf_irr"), ref["svgf_irr"], atol=1e-5)
    np.testing.assert_array_equal(C.stitch(parts, "svgf_hist"), ref["svgf_hist"])
    ldr_d = np.abs(C.stitch(parts, "ldr") - ref["ldr"])
    assert (ldr_d > 1e-3).mean() < 0.02, (ldr_d > 1e-3).mean()
    assert ldr_d.max() < 0.1, ldr_d.max()


@pytest.fixture(scope="module")
def denoise_refs():
    return C.port_single("denoise"), C.jax_single("denoise", jit=False)


def test_denoise_matches_single_device(runs, denoise_refs):
    port, jx = denoise_refs
    _denoise_bound(runs["denoise"], port)
    _denoise_bound(runs["denoise"], jx)


def test_denoise_edge_halo_mutant_fails(runs, denoise_refs):
    with pytest.raises(AssertionError):
        _denoise_bound(runs["denoise_edge_halo"], denoise_refs[0])
