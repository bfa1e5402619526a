"""The port's trace + shading and gbuffer against the JAX package's.

Both sides get the same scene (the port builds its own ``city``; the
outdoor court, which exercises the alpha, warp, fullbright and water
paths, is built by the JAX package and handed over as arrays) and the
same rays. XLA fuses multiply-adds on the CPU and PyTorch does not, so
floats agree to a few ulps: rtol 1e-5, atol 1e-4. World-space positions
(coordinates up to 4,000, sky points 10,000 from the camera, where one
f32 ulp is 5e-4 to 1e-3) and the depth terms made from them get an atol
of a few of those ulps. Rays whose nearest triangle differs on an exact
tie are left out of the per-ray comparison; there must be almost none.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu.accel.build import build_accel as j_build_accel
from merian_quake_tpu.accel.build import scene_features as j_scene_features
from merian_quake_tpu.models import procedural as j_procedural
from merian_quake_tpu.models.types import RenderConfig as JConfig
from merian_quake_tpu.models.types import SceneFeatures as JFeatures
from merian_quake_tpu.render.gbuffer import render_gbuffer as j_render_gbuffer
from merian_quake_tpu.render.trace import trace_ray as j_trace_ray
from merian_quake_tpu_torch import interop
from merian_quake_tpu_torch.accel.build import build_accel, scene_features
from merian_quake_tpu_torch.models import procedural
from merian_quake_tpu_torch.interop import tensor
from merian_quake_tpu_torch.models.types import RenderConfig
from merian_quake_tpu_torch.render.gbuffer import render_gbuffer
from merian_quake_tpu_torch.render.trace import ALL_FEATURES, trace_ray


def _t(x):
    """An array as a CPU tensor (the interop default is the card)."""
    return tensor(x, device="cpu")


# The suite runs several test processes side by side on a few cores;
# torch would start one thread per core in each and oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))


def _close(ours, ref, rtol=1e-5, atol=1e-4, mask=None):
    a, b = np.asarray(ours), np.asarray(ref)
    if mask is not None:
        a, b = a[mask], b[mask]
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _rays(rng, uniforms, n=1024):
    """Half camera-ish directions, half random ones from inside the scene."""
    cam = np.asarray(uniforms.cam_x)
    fwd = np.asarray(uniforms.cam_w) / np.linalg.norm(np.asarray(uniforms.cam_w))
    d = fwd + rng.normal(scale=0.6, size=(n, 3))
    d[n // 2:] = rng.normal(size=(n - n // 2, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(cam, (n, 3)).astype(np.float32).copy()
    o[n // 2:] += rng.uniform(-40, 40, (n - n // 2, 3)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("scene", ["city", "court_all_features"])
def test_trace_ray_matches_jax(rng, scene):
    if scene == "city":
        jb = j_procedural.city()
        tb = procedural.city(device="cpu")
        t_scene, t_atlas, t_uni = tb
        j_feat = j_scene_features(jb.scene, jb.uniforms, jb.atlas)
        t_feat = scene_features(t_scene, t_uni, t_atlas)
        assert t_feat == tuple(j_feat)
    else:
        jb = j_procedural.outdoor_court()
        t_scene = interop.scene_from_numpy(jb.scene, device="cpu")
        t_atlas = interop.atlas_from_numpy(jb.atlas, device="cpu")
        t_uni = interop.uniforms_from_numpy(jb.uniforms, device="cpu")
        j_feat = JFeatures(*ALL_FEATURES)
        t_feat = ALL_FEATURES
        assert t_feat.has_alpha_tris and t_feat.sky_mode == "cubemap"
    ja = j_build_accel(jb.scene, jb.atlas)
    ta = build_accel(t_scene, t_atlas)
    o, d = _rays(rng, jb.uniforms)
    ref = j_trace_ray(ja, jb.atlas, jb.uniforms, jnp.asarray(o), jnp.asarray(d),
                      features=j_feat, pixel_cone=0.01)
    ours = trace_ray(ta, t_atlas, t_uni, _t(o), _t(d), features=t_feat, pixel_cone=0.01)
    same = ours.hitrec.tri.numpy() == np.asarray(ref.hitrec.tri)
    assert same.mean() >= 0.999, same.mean()
    assert (np.asarray(ref.hitrec.tri) >= 0).mean() > 0.5
    np.testing.assert_array_equal(ours.flags.numpy()[same], np.asarray(ref.flags)[same])
    _close(ours.t, ref.t, rtol=1e-4, atol=1e-3, mask=same)
    _close(ours.throughput, ref.throughput, mask=same)
    _close(ours.contribution, ref.contribution, mask=same)
    for f in ("normal", "geo_normal", "albedo", "roughness", "wi"):
        _close(getattr(ours.hit, f), getattr(ref.hit, f), mask=same)
    # positions: 1e4 from the camera for sky points, so scale the atol
    for f in ("pos", "prev_pos"):
        _close(getattr(ours.hit, f), getattr(ref.hit, f), rtol=1e-6, atol=2e-3, mask=same)


def test_gbuffer_matches_jax_city():
    W, H = 48, 27
    jb, tb = j_procedural.city(), procedural.city(device="cpu")
    ja, ta = j_build_accel(jb.scene, jb.atlas), build_accel(tb.scene, tb.atlas)
    jc = JConfig(width=W, height=H, features=j_scene_features(jb.scene, jb.uniforms, jb.atlas))
    tc = RenderConfig(width=W, height=H, features=scene_features(tb.scene, tb.uniforms, tb.atlas))
    ref = j_render_gbuffer(ja, jb.atlas, jb.uniforms, jc)
    ours = render_gbuffer(ta, tb.atlas, tb.uniforms, tc)
    for f in ("irradiance", "albedo", "normal"):
        _close(getattr(ours, f), getattr(ref, f))
    # motion vectors and depth terms are differences of world positions
    # (~1e3): f32 ulps of the positions, in pixels / world units
    _close(ours.mv, ref.mv, atol=1e-3)
    _close(ours.linear_z, ref.linear_z, rtol=1e-5, atol=2e-3)
    _close(ours.z_grad, ref.z_grad, rtol=1e-4, atol=2e-2)
    _close(ours.z_vel, ref.z_vel, atol=2e-3)
    # compressed hits: octahedral codes and bf16 fields are equal
    for f in ("wi", "normal", "geo_normal"):
        np.testing.assert_array_equal(
            getattr(ours.hits, f).numpy().astype(np.uint32), np.asarray(getattr(ref.hits, f))
        )
    for f in ("mv", "albedo", "roughness"):
        np.testing.assert_array_equal(
            getattr(ours.hits, f).float().numpy(),
            np.asarray(getattr(ref.hits, f)).astype(np.float32),
        )
    _close(ours.hits.pos, ref.hits.pos, rtol=1e-6, atol=2e-3)


@pytest.mark.parametrize("size", [(256, 16), (48, 27)])  # tiled, scanline
def test_layout_matches_jax(rng, size):
    from merian_quake_tpu.render import layout as j_layout
    from merian_quake_tpu_torch.render import layout

    W, H = size
    assert layout.is_tiled(W, H) == j_layout.is_tiled(W, H)
    for a, b in zip(layout.gen_pixels(W, H, device="cpu"), j_layout.gen_pixels(W, H)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    flat = rng.normal(size=(W * H, 3)).astype(np.float32)
    img = layout.flat_to_image(_t(flat), W, H)
    np.testing.assert_array_equal(img.numpy(), np.asarray(j_layout.flat_to_image(jnp.asarray(flat), W, H)))
    np.testing.assert_array_equal(layout.image_to_flat(img, W, H).numpy(), flat)
    px = rng.integers(0, W, 100).astype(np.int32)
    py = rng.integers(0, H, 100).astype(np.int32)
    np.testing.assert_array_equal(
        layout.index_of(_t(px), _t(py), W, H).numpy(),
        np.asarray(j_layout.index_of(jnp.asarray(px), jnp.asarray(py), W, H)),
    )
