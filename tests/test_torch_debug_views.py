"""Debug visualizations (render/mcpg/debug.py, render/restir/debug.py):
the cases of tests/test_debug_views.py on the port, and every view
against the JAX package's on the same state.

Two jitted JAX frames of the 48×32 box (MCPG with small tables, and
ReSTIR) make the state; ``interop`` carries it, the gbuffer, the
irradiance and the uniforms across. The JAX views run op by op, as its
tests call them. Bounds: every view within atol 1e-6 (read: at most
6.0e-8, views 2 and the ReSTIR direction) except view 3, within 2e-6:
its colour is computed in f64 and rounded once to f32 (so that the card
and the CPU draw the same colour, chip_smoke.py phase 28), where the JAX
package rounds each step of its OKLab transform in f32 (read: 1.0e-6;
the JAX package jitted against op by op: 7.2e-7). View 3's cell keys
(the 16-bit hash of each pixel's cell) are equal bit for bit.

A difference that stays: the JAX package's views 4 and 5 reshape the
irradiance IMAGE as if it were the flat buffer, which is the image's
order only where the size does not tile; the port reads the image
through ``layout.image_to_flat``. At 256×8 (two 8×128 tiles side by
side) the port's view 4 is the irradiance image and the JAX package's
is not (ROADMAP queue 3); at the tests' sizes the two are one.

Mutants, each failing its bound: view 3's cell hash taken with the
level (``hash2_grid_level``), and the ReSTIR M view over a clamp of 64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu.accel.build import build_accel as j_build_accel
from merian_quake_tpu.accel.build import scene_features as j_scene_features
from merian_quake_tpu.models.procedural import cornell_box as j_cornell_box
from merian_quake_tpu.models.types import RenderConfig as JConfig
from merian_quake_tpu.render.mcpg import MCPGConfig as JMCPGConfig
from merian_quake_tpu.render.mcpg import debug as j_mdebug
from merian_quake_tpu.render.restir import debug as j_rdebug
from merian_quake_tpu.renderer import init_state as j_init_state
from merian_quake_tpu.renderer import render_frame as j_render_frame
from merian_quake_tpu_torch import interop
from merian_quake_tpu_torch.models.types import RenderConfig
from merian_quake_tpu_torch.ops import hashgrid
from merian_quake_tpu_torch.render.hit import decompress_hit
from merian_quake_tpu_torch.render.mcpg import MCPGConfig
from merian_quake_tpu_torch.render.mcpg import debug as t_mdebug
from merian_quake_tpu_torch.render.restir import debug as t_rdebug

torch.set_num_threads(min(2, torch.get_num_threads()))

W, H = 48, 32
SIZES = dict(mc_adaptive_size=1 << 10, mc_static_size=1 << 8, lc_size=1 << 10)
ATOL = {3: 2e-6}


def _render(integrator, frames=2):
    bundle = j_cornell_box()
    accel = j_build_accel(bundle.scene, bundle.atlas)
    config = JConfig(width=W, height=H, spp=1, max_path_length=3, integrator=integrator,
                     features=j_scene_features(bundle.scene, bundle.uniforms, bundle.atlas))
    mcfg = JMCPGConfig(**SIZES) if integrator == "mcpg" else None
    state = j_init_state(config, mcfg)
    uniforms = bundle.uniforms
    for i in range(frames):
        uniforms = uniforms._replace(frame=jnp.uint32(i))
        state, outputs = j_render_frame(accel, bundle.atlas, uniforms, config, state, mcfg)
    jax.block_until_ready(outputs["ldr"])
    port = dict(config=RenderConfig(width=W, height=H, spp=1, max_path_length=3, integrator=integrator),
                uniforms=interop.uniforms_from_numpy(uniforms, "cpu"),
                gbuffer=interop.gbuffer_from_numpy(outputs["gbuffer"], "cpu"),
                irradiance=interop.tensor(outputs["irradiance"], "cpu"))
    if integrator == "mcpg":
        port["state"] = interop.mcpg_state_from_numpy(state.mcpg, "cpu")
    else:
        port["state"] = interop.restir_state_from_numpy(state.restir, "cpu")
    return (config, mcfg, state, uniforms, outputs), port


@pytest.fixture(scope="module")
def mcpg_run():
    return _render("mcpg")


@pytest.fixture(scope="module")
def restir_run():
    return _render("restir")


def mcpg_view(selector, port):
    return t_mdebug.render_mcpg_debug(selector, port["uniforms"], port["config"], MCPGConfig(**SIZES),
                                      port["state"], port["gbuffer"], port["irradiance"])


def mcpg_agrees(run, selector):
    (config, mcfg, state, uniforms, outputs), port = run
    ref = np.asarray(j_mdebug.render_mcpg_debug(selector, uniforms, config, mcfg, state.mcpg,
                                                outputs["gbuffer"], outputs["irradiance"]))
    img = mcpg_view(selector, port).numpy()
    assert img.shape == (H, W, 3) and np.isfinite(img).all(), f"view {selector} not finite"
    np.testing.assert_allclose(img, ref, rtol=0, atol=ATOL.get(selector, 1e-6))
    return img


@pytest.mark.parametrize("selector", range(9))
def test_mcpg_debug_views(mcpg_run, selector):
    mcpg_agrees(mcpg_run, selector)


def test_mcpg_debug_views_nontrivial(mcpg_run):
    """After training frames the guiding-state views must be non-zero
    (the box light is learnable from every visible surface)."""
    for selector in (1, 4):  # learned sum_w, irradiance
        assert mcpg_view(selector, mcpg_run[1]).max() > 0.0, f"view {selector} all-zero"


def test_mcpg_debug_bad_selector(mcpg_run):
    with pytest.raises(ValueError, match="unknown debug selector"):
        mcpg_view(99, mcpg_run[1])


def test_grid_cell_keys_match_jax(mcpg_run):
    """View 3's cell keys, bit for bit (u32)."""
    (config, mcfg, state, uniforms, outputs), port = mcpg_run
    from merian_quake_tpu.ops import hashgrid as j_hashgrid
    from merian_quake_tpu.render.hit import decompress_hit as j_decompress_hit
    from merian_quake_tpu.render.mcpg import grids as j_grids

    pos = j_decompress_hit(outputs["gbuffer"].hits).pos
    level = j_grids.adaptive_target_level(pos, uniforms.cam_x, mcfg)
    width = j_grids._adaptive_width_for_level(level, mcfg)
    ref = np.asarray(j_hashgrid.hash2_grid(j_hashgrid.grid_idx_closest(pos, width[..., None])))
    keys = t_mdebug.grid_cell_seed(decompress_hit(port["gbuffer"].hits).pos, port["uniforms"].cam_x,
                                   MCPGConfig(**SIZES))
    np.testing.assert_array_equal(keys.numpy(), ref.astype(np.int64))
    assert len(np.unique(ref)) > 20


def restir_agrees(run, selector):
    (config, _, state, _, outputs), port = run
    ref = np.asarray(j_rdebug.render_restir_debug(selector, config, state.restir, outputs["gbuffer"]))
    img = t_rdebug.render_restir_debug(selector, port["config"], port["state"], port["gbuffer"]).numpy()
    assert img.shape == (H, W, 3) and np.isfinite(img).all(), f"view {selector} not finite"
    np.testing.assert_allclose(img, ref, rtol=1e-6, atol=1e-6)
    return img


@pytest.mark.parametrize("selector", range(5))
def test_restir_debug_views(restir_run, selector):
    img = restir_agrees(restir_run, selector)
    if selector in (0, 2):  # W / radiance carry signal after 2 frames
        assert img.max() > 0.0


def test_irradiance_views_at_a_tiled_size(mcpg_run):
    """At 256×8 the port's view 4 is the irradiance image; the JAX
    package's reads the image in buffer order (the difference that
    stays)."""
    (config, mcfg, state, uniforms, outputs), port = mcpg_run
    irr = np.random.default_rng(3).uniform(0, 1, (8, 256, 4)).astype(np.float32)
    ref = np.asarray(j_mdebug.render_mcpg_debug(4, uniforms, config._replace(width=256, height=8), mcfg,
                                                state.mcpg, outputs["gbuffer"], jnp.asarray(irr)))
    img = t_mdebug.render_mcpg_debug(4, port["uniforms"], port["config"]._replace(width=256, height=8),
                                     MCPGConfig(**SIZES), port["state"], port["gbuffer"],
                                     torch.from_numpy(irr)).numpy()
    np.testing.assert_array_equal(img, irr[..., :3])
    assert not np.array_equal(ref, irr[..., :3])
    np.testing.assert_array_equal(np.sort(ref.ravel()), np.sort(irr[..., :3].ravel()))


def test_mutants_fail(mcpg_run, restir_run, monkeypatch):
    monkeypatch.setattr(hashgrid, "hash2_grid", lambda idx: hashgrid.hash2_grid_level(idx, 1))
    with pytest.raises(AssertionError):
        mcpg_agrees(mcpg_run, 3)
    plain = t_rdebug.render_restir_debug
    monkeypatch.setattr(t_rdebug, "render_restir_debug",
                        lambda s, c, st, g, m_clamp=640: plain(s, c, st, g, m_clamp=64))
    with pytest.raises(AssertionError):
        restir_agrees(restir_run, 1)
