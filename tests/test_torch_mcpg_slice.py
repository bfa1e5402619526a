"""Slice 6 end to end: the guided (MCPG) frame, port against JAX package.

The 64×32 Cornell box of ``__graft_entry__._tiny_setup`` (1 spp, max path
length 3), ``integrator="mcpg"``, ``MCPGConfig()`` defaults (147,456
chain states, 65,536 light-cache cells), the same seed, on the CPU (both
sides trace with the Möller–Trumbore oracle), through ``init_state`` and
``render_frame``: frame 0 from an empty state, and a 4-frame sequence.

Guiding is a feedback loop, so the images are held as
tests/test_torch_slice.py holds PT's: the share of pixels within 1e-3
and the mean |Δ|, with the bound read from the JAX package's own spread
between its jitted run and an op-by-op run (``jax.disable_jit``) of the
same frames. On this scene that spread is nil (frame 0 and after 4
frames: 100% of pixels within 1e-3 on ldr, hdr and accum_irradiance,
used or not; mean |Δ| ≤ 2.4e-7; every ``mc.i`` row equal), so PT's
tolerance holds outright: ≥ 99.5% and < 1e-4. The port reads, against
the jitted run: frame 0 100%, ldr mean |Δ| 0, hdr 7.7e-9, irradiance
1.3e-7 (frame 0 is unguided: ``have_guiding`` is false everywhere); after
4 frames 100%, 5.6e-9 / 1.8e-8 / 2.4e-7, ``mc.i`` equal on 100% of rows
(492 live states), the light cache's N on 100% and its hash on 99.98%
of cells, both counters equal. Bounds for the integers: ≥ 99.5% of rows.

Mutants (each must fail the 4-frame bound; frame 0 is blind to the
first, since nothing is guided yet): a vMF density 5% too high in the
MIS pdf, and a hash rotation of 12 bits instead of 13.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu.accel.build import build_accel as j_build_accel
from merian_quake_tpu.models.procedural import cornell_box as j_cornell_box
from merian_quake_tpu.models.types import RenderConfig as JConfig
from merian_quake_tpu.render.mcpg import MCPGConfig as JMCPGConfig
from merian_quake_tpu.renderer import init_state as j_init_state
from merian_quake_tpu.renderer import render_frame as j_render_frame
from merian_quake_tpu_torch.accel.build import build_accel
from merian_quake_tpu_torch.models.procedural import cornell_box
from merian_quake_tpu_torch.models.types import RenderConfig
from merian_quake_tpu_torch.ops import hashgrid, rng as rng_ops, vmf
from merian_quake_tpu_torch.render.mcpg import MCPGConfig
from merian_quake_tpu_torch.render.mcpg import surface as t_surf
from merian_quake_tpu_torch.renderer import init_state, render_frame

torch.set_num_threads(min(2, torch.get_num_threads()))

W, H, FRAMES = 64, 32, 4
KW = dict(width=W, height=H, spp=1, max_path_length=3, integrator="mcpg")


def _torch_frames(frames):
    bundle = cornell_box(device="cpu")
    accel = build_accel(bundle.scene, bundle.atlas, device="cpu")
    config, mcfg = RenderConfig(**KW), MCPGConfig()
    state = init_state(config, mcfg, device="cpu")
    outs = []
    for i in range(frames):
        state, out = render_frame(
            accel, bundle.atlas, bundle.uniforms._replace(frame=i), config, state, mcfg)
        outs.append((state, out))
    return outs


@pytest.fixture(scope="module")
def runs():
    bundle = j_cornell_box()
    accel = j_build_accel(bundle.scene, bundle.atlas)
    config, mcfg = JConfig(**KW), JMCPGConfig()
    state = j_init_state(config, mcfg)
    j_outs = []
    for i in range(FRAMES):
        state, out = j_render_frame(
            accel, bundle.atlas, bundle.uniforms._replace(frame=jnp.uint32(i)), config, state, mcfg)
        j_outs.append((state, out))
    jax.block_until_ready(out["ldr"])
    return j_outs, _torch_frames(FRAMES)


def _agree(ours, ref, share=0.995, mean=1e-4, pixels=None):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    d = np.abs(ours - ref)
    per_pixel = d.max(-1) if d.ndim == 3 else d
    if pixels is not None:
        d, per_pixel = d[pixels], per_pixel[pixels]
    assert (per_pixel <= 1e-3).mean() >= share, (per_pixel <= 1e-3).mean()
    assert d.mean() < mean, d.mean()


def _images_agree(t, j):
    (t_state, t_out), (j_state, j_out) = t, j
    for key in ("ldr", "hdr", "irradiance"):
        _agree(t_out[key], j_out[key])
    for field in ("accum_irradiance", "accum_direct", "accum_albedo"):
        _agree(getattr(t_state, field), getattr(j_state, field))
    assert t_state.iteration == int(j_state.iteration)


@pytest.mark.parametrize("frame", [0, FRAMES - 1])
def test_frames_match_jax(runs, frame):
    j_outs, t_outs = runs
    _images_agree(t_outs[frame], j_outs[frame])
    assert float(t_outs[frame][1]["ldr"].std()) > 0.01


def test_frame_zero_is_unguided_and_learns(runs):
    """From an empty state nothing is guided; the replay then fills the
    chains and the light cache, as far as the JAX package's."""
    j_outs, t_outs = runs
    t_mc, j_mc = t_outs[0][0].mcpg, j_outs[0][0].mcpg
    live = int((t_mc.mc.sum_w > 0).sum())
    assert live == int((np.asarray(j_mc.mc.f)[:, 3] > 0).sum()) > 50
    assert int(t_mc.lc_updates_applied) == int(j_mc.lc_updates_applied) > 1000
    assert int(t_mc.lc_updates_merged) == int(j_mc.lc_updates_merged)
    assert torch.isfinite(t_mc.mc.f).all() and torch.isfinite(t_mc.lc.irr).all()


def test_guiding_state_matches_jax_after_four_frames(runs):
    j_outs, t_outs = runs
    t_mc, j_mc = t_outs[-1][0].mcpg, j_outs[-1][0].mcpg
    ji, ti = np.asarray(j_mc.mc.i), t_mc.mc.i.numpy()
    same = (ji == ti).all(-1)
    live = np.asarray(j_mc.mc.f)[:, 3] > 0
    assert live.sum() > 300 and same.mean() >= 0.995 and same[live].mean() >= 0.995
    np.testing.assert_allclose(
        t_mc.mc.f.numpy()[same & live], np.asarray(j_mc.mc.f)[same & live], rtol=1e-3, atol=1e-4)
    assert (t_mc.lc.N.numpy() == np.asarray(j_mc.lc.N)).mean() >= 0.995
    assert (t_mc.lc.hash.numpy() == np.asarray(j_mc.lc.hash).astype(np.int64)).mean() >= 0.995
    touched = np.asarray(j_mc.lc.N) > 0
    assert touched.sum() > 5000
    close = np.isclose(t_mc.lc.irr.numpy(), np.asarray(j_mc.lc.irr), rtol=1e-3, atol=1e-4).all(-1)
    assert close[touched].mean() >= 0.995
    for counter in ("lc_updates_applied", "lc_updates_merged"):
        a, b = int(getattr(t_mc, counter)), int(getattr(j_mc, counter))
        assert abs(a - b) <= 0.005 * b, (counter, a, b)


def _rot12(vals):
    first = next(v for v in vals if isinstance(v, torch.Tensor))
    h = rng_ops._u32(0x9E3779B1, first)
    for v in vals:
        h = h ^ rng_ops._mul32(rng_ops._u32(v, first), 0x85EBCA77)
        h = ((h << 12) & 0xFFFFFFFF) | (h >> 20)
        h = rng_ops._mul32(h, 0xC2B2AE3D)
    h = h ^ (h >> 16)
    h = rng_ops._mul32(h, 0x7FEB352D)
    return h ^ (h >> 15)


@pytest.mark.parametrize("mutant", ["mis_pdf", "hash_rotation"])
def test_mutant_fails_the_bound(runs, monkeypatch, mutant):
    j_outs, _ = runs
    if mutant == "mis_pdf":
        shim = types.SimpleNamespace(
            sample=vmf.sample, pdf=lambda w, mu, kappa: 1.05 * vmf.pdf(w, mu, kappa))
        monkeypatch.setattr(t_surf, "vmf", shim)  # the surface pass's own reference only
    else:
        monkeypatch.setattr(hashgrid, "_hash_coords", _rot12)
    t_outs = _torch_frames(FRAMES)
    with pytest.raises(AssertionError):
        _images_agree(t_outs[-1], j_outs[-1])
    if mutant == "mis_pdf":  # nothing is guided in frame 0
        _images_agree(t_outs[0], j_outs[0])
