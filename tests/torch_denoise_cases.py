"""Denoised frames of the port and of the JAX package, for
tests/test_torch_denoise_slice.py, test_torch_ssmm_slice.py and
test_torch_denoise_volume.py (each file's docstring gives its readings
and bounds).

A case renders ``FRAMES`` frames at 64×36 with ``denoise=True``: the JAX
package's jitted frames from an empty state (the reference of the
sequence) and, where the case asks for it, its op-by-op frame
``FRAMES - 1`` from its jitted state after the frames before (the
reference of one frame on carried state); the port renders the same
sequence and the same one frame from that state carried across by
``interop``. Bounds are pairs (share of pixels within 1e-3, mean |Δ|).
"""
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from merian_quake_tpu import renderer as j_renderer
from merian_quake_tpu.accel.build import build_accel as j_build_accel
from merian_quake_tpu.accel.build import scene_features as j_scene_features
from merian_quake_tpu.models import procedural as j_procedural
from merian_quake_tpu.models.types import RenderConfig as JConfig
from merian_quake_tpu.render.mcpg import MCPGConfig as JMCPGConfig
from merian_quake_tpu.render.mcpg.volume import VolumeConfig as JVolumeConfig
from merian_quake_tpu_torch import interop
from merian_quake_tpu_torch.accel.build import build_accel, scene_features
from merian_quake_tpu_torch.models import procedural
from merian_quake_tpu_torch.models.types import RenderConfig
from merian_quake_tpu_torch.render.mcpg import MCPGConfig
from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig
from merian_quake_tpu_torch.renderer import frame_core, render_sequence

W, H, FRAMES = 64, 36, 3
FOG_MU_T = 0.002
# (render config, JAX scene, port scene, JAX integrator config, port's)
CASES = {
    "pt": (dict(spp=2, max_path_length=3), j_procedural.cornell_box, procedural.cornell_box,
           None, None),
    "ssmm": (dict(spp=2, integrator="ssmm"), j_procedural.cornell_box, procedural.cornell_box,
             None, None),
    "volume": (dict(spp=1, max_path_length=3, integrator="mcpg"),
               lambda: j_procedural.outdoor_court(FOG_MU_T),
               lambda device: procedural.outdoor_court(FOG_MU_T, device=device),
               JMCPGConfig(volume=JVolumeConfig()), MCPGConfig(volume=VolumeConfig())),
}


def strong(state):
    """The state with every leaf a committed array, so that the jitted
    frame compiles once (frame 0's state has weakly typed leaves)."""
    return jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), state)


def pick(state, out, key):
    """An output image ("ldr", "hdr", "volume") or a state field
    ("svgf.irr", "volume_svgf.irr", "taa_prev")."""
    if "." in key:
        a, b = key.split(".")
        return getattr(getattr(state, a), b)
    return state.taa_prev if key == "taa_prev" else out[key]


def reading(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    d = np.abs(ours - ref)
    per_pixel = d.max(-1) if d.ndim == 3 else d
    return float((per_pixel <= 1e-3).mean()), float(d.mean())


def within(ours, ref, share, mean):
    got = reading(ours, ref)
    assert got[0] >= share and got[1] <= mean, (got, share, mean)


class Case:
    def __init__(self, name, one_frame_keys=()):
        kw, jb, tb, jm, tm = CASES[name]
        self.name, self.kw, self.tb, self.tm = name, dict(kw, width=W, height=H, denoise=True), tb, tm
        b = jb()
        acc = j_build_accel(b.scene, b.atlas)
        jcfg = JConfig(**self.kw, features=j_scene_features(b.scene, b.uniforms, b.atlas))
        step = jax.jit(lambda u, s: j_renderer.frame_core(acc, b.atlas, u, jcfg, s, mcpg_config=jm))
        uni = lambda i: b.uniforms._replace(frame=jnp.uint32(i))
        st = strong(j_renderer.init_state(jcfg, jm))
        for i in range(FRAMES):
            self.j_before = st
            st, out = step(uni(i), st)
            st = strong(st)
        self.j_state, self.j_out = st, out
        if one_frame_keys:
            with jax.disable_jit():
                self.d_state, self.d_out = j_renderer.frame_core(
                    acc, b.atlas, uni(FRAMES - 1), jcfg, self.j_before, mcpg_config=jm)
            # the JAX package's own spread on this one frame
            self.spread = {k: reading(pick(self.j_state, self.j_out, k), pick(self.d_state, self.d_out, k))
                           for k in one_frame_keys}
            tbun = tb(device="cpu")
            self.bundle, self.accel = tbun, build_accel(tbun.scene, tbun.atlas, device="cpu")
            self.cfg = RenderConfig(**self.kw, features=scene_features(tbun.scene, tbun.uniforms, tbun.atlas))
            self.uni = interop.uniforms_from_numpy(uni(FRAMES - 1), "cpu")

    def sequence(self):
        return render_sequence(self.tb(device="cpu"), RenderConfig(**self.kw), frames=FRAMES,
                               mcpg_config=self.tm, device="cpu")

    def one_frame(self):
        state = interop.frame_state_from_numpy(self.j_before, "cpu")
        return frame_core(self.accel, self.bundle.atlas, self.uni, self.cfg, state, mcpg_config=self.tm)


def sequence_agrees(case, run, spread, margin=0.02):
    """The port's sequence against the JAX package's jitted one: share at
    least the JAX package's own jitted-vs-op-by-op share less ``margin``,
    mean at most 1.25× its mean (``spread``: {key: (share, mean)})."""
    t_state, t_out = run
    assert t_state.iteration == FRAMES
    for key, (share, mean) in spread.items():
        within(pick(t_state, t_out, key), pick(case.j_state, case.j_out, key), share - margin,
               1.25 * mean)


def one_frame_agrees(case, run, bounds):
    """One frame on carried state: against the JAX package's op-by-op
    frame within ``bounds``, against its jitted frame within that frame's
    own spread (share less 0.02, 1.25× mean + 1e-6)."""
    t_state, t_out = run
    for key, bound in bounds.items():
        ours = pick(t_state, t_out, key)
        within(ours, pick(case.d_state, case.d_out, key), *bound)
        share, mean = case.spread[key]
        within(ours, pick(case.j_state, case.j_out, key), share - 0.02, 1.25 * mean + 1e-6)


def torch_with(**overrides):
    """The torch module's namespace with some functions replaced: set as a
    port module's ``torch`` to install a mutant there."""
    shim = types.SimpleNamespace(**{k: getattr(torch, k) for k in dir(torch) if not k.startswith("__")})
    for k, v in overrides.items():
        setattr(shim, k, v)
    return shim


def install_mutant(name, monkeypatch):
    """One mutant of the port's denoised frame."""
    mod = importlib.import_module
    if name == "taa history after fxaa":
        taa_mod, fxaa_mod = mod("merian_quake_tpu_torch.post.taa"), mod("merian_quake_tpu_torch.post.fxaa")
        taa, fxaa = taa_mod.taa, fxaa_mod.fxaa
        monkeypatch.setattr(taa_mod, "taa", lambda p, c, mv: fxaa(taa(p, c, mv)))
        monkeypatch.setattr(fxaa_mod, "fxaa", lambda x: x)
    elif name == "atrous step not doubling":
        svgf_mod = mod("merian_quake_tpu_torch.post.svgf")
        plain = svgf_mod.atrous_iteration
        monkeypatch.setattr(svgf_mod, "atrous_iteration",
                            lambda i, v, n, z, zg, step, p: plain(i, v, n, z, zg, 1, p))
    elif name == "roll flipped":
        monkeypatch.setattr(mod("merian_quake_tpu_torch.render.ssmm.ssmm"), "torch",
                            torch_with(roll=lambda x, s, d: torch.roll(x, -s, d)))
    elif name == "volume history added unfiltered":
        svgf_mod = mod("merian_quake_tpu_torch.post.svgf")
        plain, calls = svgf_mod.svgf, []

        def svgf(state, irr, *a, **k):
            calls.append(1)
            new_state, out = plain(state, irr, *a, **k)
            return new_state, (irr if len(calls) % 2 == 0 else out)

        monkeypatch.setattr(svgf_mod, "svgf", svgf)
    else:
        raise KeyError(name)
