"""Slice 7 end to end: MCPG with the volume pass, port against JAX package.

4 frames of the fogged court (``outdoor_court(fog_mu_t=0.002)``) at
64×36, 1 spp, max path length 3, ``MCPGConfig(volume=VolumeConfig())``,
the same seed, on the CPU (both sides trace with the Möller–Trumbore
oracle), through ``render_sequence``.

The bounds are read from the JAX package's own spread between its jitted
run and an op-by-op run (``jax.disable_jit``) of the same frames. The
volume's history is reprojected along its motion vectors; with a still
camera those are the forward projection's rounding (±2e-5 pixels), so on
the image's border whether a pixel keeps its history is decided by an
ulp, and that pixel's volume and the frame's exposure move. The JAX
package's two runs differ so on 4.5% of the pixels (accum_volume_len);
ldr 94.922% within 1e-3, mean |Δ| 2.04e-3; hdr 94.792%, 4.40e-3; the
frame's own volume image 99.913%, 7.98e-6. The port reads, against the
jitted run: ldr 95.139%, 2.03e-3; hdr 95.009%, 3.94e-3; volume 99.913%,
8.0e-6 (against the op-by-op run: 98.741%, 9.6e-4; the volume image 100%,
5.1e-8; every ``mc.i`` row equal). Bounds: ldr and hdr ≥ 94% and 1.25×
the JAX package's mean; the volume image ≥ 99.5%, < 1e-5. The states:
distance-MC slots with sum_w > 0 (read: 116 on both) and live chain
states (16,857 against 16,858) within 2. A mutant, the phase pdf
dropped, fails the bound.

``production_config()`` equals the reference's field for field, and the
hash slots of its grid sizes equal the JAX package's on 200,000 random
cells (the default sizes are held in tests/test_torch_hashgrid.py).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu.models.procedural import outdoor_court as j_court
from merian_quake_tpu.models.types import RenderConfig as JConfig
from merian_quake_tpu.ops import hashgrid as j_hg
from merian_quake_tpu.render.mcpg import MCPGConfig as JMCPGConfig
from merian_quake_tpu.render.mcpg.config import production_config as j_production_config
from merian_quake_tpu.render.mcpg.volume import VolumeConfig as JVolumeConfig
from merian_quake_tpu.renderer import render_sequence as j_render_sequence
from merian_quake_tpu_torch.models.procedural import outdoor_court
from merian_quake_tpu_torch.models.types import RenderConfig
from merian_quake_tpu_torch.ops import hashgrid as t_hg
from merian_quake_tpu_torch.ops import phase
from merian_quake_tpu_torch.render.mcpg import MCPGConfig
from merian_quake_tpu_torch.render.mcpg import volume as t_vol
from merian_quake_tpu_torch.render.mcpg.config import production_config
from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig
from merian_quake_tpu_torch.renderer import render_sequence

torch.set_num_threads(min(2, torch.get_num_threads()))

W, H, FRAMES, MU = 64, 36, 4, 0.002
KW = dict(width=W, height=H, spp=1, max_path_length=3, integrator="mcpg")
BOUND = {"ldr": (0.94, 2.55e-3), "hdr": (0.94, 5.5e-3), "volume": (0.995, 1e-5)}


def _torch_frames():
    return render_sequence(outdoor_court(MU, device="cpu"), RenderConfig(**KW), frames=FRAMES,
                           mcpg_config=MCPGConfig(volume=VolumeConfig()), device="cpu")


@pytest.fixture(scope="module")
def runs():
    j_state, j_out = j_render_sequence(j_court(MU), JConfig(**KW), frames=FRAMES,
                                       mcpg_config=JMCPGConfig(volume=JVolumeConfig()))
    jax.block_until_ready(j_out["ldr"])
    return (j_state, j_out), _torch_frames()


def _agree(ours, ref, share, mean):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    d = np.abs(ours - ref)
    per_pixel = d.max(-1) if d.ndim == 3 else d
    assert (per_pixel <= 1e-3).mean() >= share, (per_pixel <= 1e-3).mean()
    assert d.mean() < mean, d.mean()


def _images_agree(t, j):
    for key, bound in BOUND.items():
        _agree(t[1][key], j[1][key], *bound)


@pytest.mark.parametrize("key", list(BOUND))
def test_volume_frames_match_jax(runs, key):
    j, t = runs
    _agree(t[1][key], j[1][key], *BOUND[key])
    assert t[0].iteration == int(j[0].iteration) == FRAMES
    assert float(t[1][key].std()) > 0.01


def test_volume_state_matches_jax(runs):
    (j_state, j_out), (t_state, t_out) = runs
    live_d = int((t_state.volume.dist_mc.sum_w > 0).sum())
    assert live_d > 50 and abs(live_d - int((np.asarray(j_state.volume.dist_mc.sum_w) > 0).sum())) <= 2
    live = int((t_state.mcpg.mc.sum_w > 0).sum())
    assert live > 5000 and abs(live - int((np.asarray(j_state.mcpg.mc.f)[:, 3] > 0).sum())) <= 2
    assert t_out["volume_mv"].shape == (H, W, 2) and t_state.accum_volume_len.shape == (H, W)
    assert float(t_state.accum_volume[..., :3].mean()) > 0.05  # the fog scatters
    assert int(t_state.accum_volume_len.max()) == FRAMES


def test_mutant_fails_the_bound(runs, monkeypatch):
    """The phase pdf dropped (taken as 1 in the MIS pdf and the estimate)."""
    shim = types.SimpleNamespace(**{**vars(phase), "draine_pdf": lambda c, g, a: torch.ones_like(c)})
    monkeypatch.setattr(t_vol, "phase_ops", shim)
    with pytest.raises(AssertionError):
        _images_agree(_torch_frames(), runs[0])


def test_production_config_equals_reference():
    got, want = production_config(), j_production_config()
    assert type(got).__name__ == type(want).__name__ == "MCPGConfig"
    assert got._fields == want._fields
    for f in got._fields:
        if f != "volume":
            assert getattr(got, f) == getattr(want, f), f
    assert got.volume._fields == want.volume._fields
    assert tuple(got.volume) == tuple(want.volume)
    assert (got.volume.draine_g, got.volume.draine_a) == (want.volume.draine_g, want.volume.draine_a)
    assert got.mc_total_size == want.mc_total_size == 33_577_268
    assert (got.lc_size, got.volume.volume_spp, got.volume.dist_guide_p) == (4_000_037, 2, 0.9)


@pytest.mark.parametrize("grid, size", [
    ("adaptive", 32_777_259), ("static", 800_009), ("light_cache", 4_000_037),
])
def test_production_hash_slots_bit_exact(grid, size):
    r = np.random.default_rng(size % 1000)
    n = 200_000
    idx = r.integers(-2**20, 2**20, (n, 3)).astype(np.int32)
    if grid == "static":
        want = np.asarray(j_hg.hash_grid(jnp.asarray(idx), size))
        got = t_hg.hash_grid(torch.from_numpy(idx), size)
    else:
        normal = r.normal(size=(n, 3)).astype(np.float32)
        level = r.integers(-4, 40, n).astype(np.int32)
        want = np.asarray(j_hg.hash_grid_normal_level(
            jnp.asarray(idx), jnp.asarray(normal), jnp.asarray(level).astype(jnp.uint32), size))
        got = t_hg.hash_grid_normal_level(torch.from_numpy(idx), torch.from_numpy(normal),
                                          torch.from_numpy(level), size)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert 0 <= got.min() and got.max() < size
