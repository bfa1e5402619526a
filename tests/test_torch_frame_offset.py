"""Frames numbered in the millions: port against JAX package.

Certification renders its ground truth from frame numbers
1,000,000·(r + 1) up to 4,000,255 (utils/certify.py). The frame number
seeds every pixel stream (``ops/rng.py::seed_pixel``, the MCPG replay,
the volume pass); the JAX package carries it as a u32, the port as a
Python int hashed in int64 masked to 32 bits. Two frames from an empty
state, starting at frame 1,000,000 and at 4,000,000, of

- PT on city at 48×27, 2 spp, max path length 3: ldr and hdr within
  1e-3 on ≥ 99.5% of pixels, mean |Δ| < 1e-4 (tests/test_torch_slice.py's
  bound; read at 1,000,000: 99.92% / 3.6e-5, at 4,000,000: 100% / 5e-8,
  at frame 0: 99.85% / 1.3e-5);
- MCPG on the 64×32 box, 1 spp, max path length 3, ``MCPGConfig()``:
  ldr, hdr and irradiance with the same bound
  (tests/test_torch_mcpg_slice.py's; read: 100%, ≤ 1.5e-7);
- SSMM on the 64×36 box, 2 spp: the raw irradiance within the JAX
  package's own jitted-vs-op-by-op spread, as
  tests/test_torch_ssmm_slice.py holds it (share ≥ 0.9362 − 0.02, mean
  ≤ 1.25 × 9.74e-2; read: 99.39% / 3.0e-2 and 3.6e-2, frame 0 99.31% /
  2.5e-2),

the JAX package's frames jitted. The mutant, frame numbers kept in 16
bits by the pixel seed (1,000,000 is then 16,960), fails every bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu import renderer as j_renderer
from merian_quake_tpu.accel.build import build_accel as j_build_accel
from merian_quake_tpu.accel.build import scene_features as j_scene_features
from merian_quake_tpu.models import procedural as j_procedural
from merian_quake_tpu.models.types import RenderConfig as JConfig
from merian_quake_tpu.render.mcpg import MCPGConfig as JMCPGConfig
from merian_quake_tpu_torch import renderer as t_renderer
from merian_quake_tpu_torch.accel.build import build_accel, scene_features
from merian_quake_tpu_torch.models import procedural
from merian_quake_tpu_torch.models.types import RenderConfig
from merian_quake_tpu_torch.ops import rng as rng_ops
from merian_quake_tpu_torch.render.mcpg import MCPGConfig
from torch_denoise_cases import reading, strong

torch.set_num_threads(min(2, torch.get_num_threads()))

STARTS = (1_000_000, 4_000_000)
SLICE = (0.995, 1e-4)
SSMM_SPREAD = (0.93620 - 0.02, 1.25 * 9.740e-2)
# integrator: (scene, render config, integrator configs (JAX, port), {output: bound})
CASES = {
    "pt": ("city", dict(width=48, height=27, spp=2, max_path_length=3), (None, None),
           {"ldr": SLICE, "hdr": SLICE}),
    "mcpg": ("cornell_box", dict(width=64, height=32, spp=1, max_path_length=3),
             (JMCPGConfig(), MCPGConfig()), {"ldr": SLICE, "hdr": SLICE, "irradiance": SLICE}),
    "ssmm": ("cornell_box", dict(width=64, height=36, spp=2), (None, None),
             {"irradiance": SSMM_SPREAD}),
}


class Runs:
    """Each case's JAX frames, made once (one jitted compile a case)."""

    def __init__(self):
        self.cache = {}

    def jax(self, integ, start):
        if (integ, start) not in self.cache:
            scene, kw, (j_icfg, _), _ = CASES[integ]
            b = getattr(j_procedural, scene)()
            acc = j_build_accel(b.scene, b.atlas)
            cfg = JConfig(integrator=integ, features=j_scene_features(b.scene, b.uniforms, b.atlas), **kw)
            state = strong(j_renderer.init_state(cfg, j_icfg))
            for i in range(2):
                state, out = j_renderer.render_frame(
                    acc, b.atlas, b.uniforms._replace(frame=jnp.uint32(start + i)), cfg, state, j_icfg)
                state = strong(state)
            jax.block_until_ready(out["ldr"])
            self.cache[(integ, start)] = {k: np.asarray(out[k]) for k in ("ldr", "hdr", "irradiance")}
        return self.cache[(integ, start)]


def port_frames(integ, start):
    scene, kw, (_, t_icfg), _ = CASES[integ]
    b = getattr(procedural, scene)(device="cpu")
    acc = build_accel(b.scene, b.atlas, device="cpu")
    cfg = RenderConfig(integrator=integ, features=scene_features(b.scene, b.uniforms, b.atlas), **kw)
    state = t_renderer.init_state(cfg, t_icfg, device="cpu")
    for i in range(2):
        state, out = t_renderer.render_frame(acc, b.atlas, b.uniforms._replace(frame=start + i), cfg,
                                             state, t_icfg)
    return out


def agrees(integ, out, ref):
    for key, (share, mean) in CASES[integ][3].items():
        got = reading(out[key], ref[key])
        assert got[0] >= share and got[1] <= mean, (integ, key, got, share, mean)


@pytest.fixture(scope="module")
def runs():
    return Runs()


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("integ", list(CASES))
def test_frames_in_the_millions_match_jax(runs, integ, start):
    out = port_frames(integ, start)
    assert bool(torch.isfinite(out["hdr"]).all()) and float(out["ldr"].std()) > 0.01
    agrees(integ, out, runs.jax(integ, start))


@pytest.mark.parametrize("integ", list(CASES))
def test_mutant_fails_the_bound(runs, integ, monkeypatch):
    """The pixel seed keeps 16 bits of the frame number."""
    plain = rng_ops.seed_pixel
    monkeypatch.setattr(rng_ops, "seed_pixel",
                        lambda px, py, frame, seed: plain(px, py, int(frame) & 0xFFFF, seed))
    with pytest.raises(AssertionError):
        agrees(integ, port_frames(integ, STARTS[0]), runs.jax(integ, STARTS[0]))
