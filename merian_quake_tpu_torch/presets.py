"""The tracked benchmark configurations (BASELINE.json).

Port of merian_quake_tpu/presets.py: the same six presets, each with the
JAX package's render config, integrator config, scene and frame count.
Quake game assets (id1/e1m1/ad_*) are not distributable, so each config
substitutes the closest procedural scene while keeping the rendering
setup (integrator, resolution, spp, camera motion, volumetrics,
animated entities) faithful.

config2, config4 and config5 move their camera along an orbit (config5
also animates an alias model): ``OrbitGame`` holds the orbit and makes
the ``game.state.GameState`` that ``run_preset`` steps, rebuilding the
accel each frame, as the JAX package does, into the tables of the one
compiled frame every preset runs through. Certification
(``utils/certify.py``) renders every preset with a still camera by design
and runs all six.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .models.procedural import alcove, cornell_box, outdoor_court
from .models.types import RenderConfig
from .render.mcpg import MCPGConfig
from .render.mcpg.volume import VolumeConfig
from .render.restir import ReSTIRConfig
from .render.ssmm import SSMMConfig


class Preset(NamedTuple):
    name: str
    description: str
    config: RenderConfig
    integ_config: object
    make_bundle: object  # (device=) -> SceneBundle
    make_game: object  # OrbitGame (moving content) | None
    frames: int


class OrbitGame(NamedTuple):
    """A preset's moving content: the camera orbits ``center`` at
    ``radius`` and ``height``, looking at the center; ``animated`` adds
    the JAX package's bouncing alias model 20 units above the center
    (merian_quake_tpu/presets.py:33-73). Calling it on a bundle, as the
    JAX package calls ``make_game(bundle)``, returns the GameState, on
    the bundle's device."""

    center: tuple
    radius: float
    height: float
    animated: bool = False

    def __call__(self, bundle):
        from .game.state import GameState, orbit_camera

        gs = GameState(bundle, dynamic_capacity=256, device=bundle.scene.v0.device)
        gs.camera_path = orbit_camera(self.center, self.radius, self.height,
                                      look_at=self.center)
        if self.animated:
            from .models.mdl import load_mdl, write_mdl

            skin = np.full((8, 8), 240, np.uint8)
            frames = np.stack([
                np.asarray([[0, 0, 0], [40, 0, 0], [0, 40, 0], [0, 0, 50]], np.float32)
                + [0, 0, 10 * i]
                for i in range(4)
            ])
            mdl = load_mdl(
                write_mdl(
                    [skin],
                    np.asarray([0, 7, 3, 1]),
                    np.asarray([0, 0, 7, 3]),
                    np.zeros(4, np.int64),
                    np.asarray([[0, 1, 2], [0, 2, 3]]),
                    np.asarray([1, 1]),
                    frames,
                    np.asarray([0.25, 0.25, 0.25], np.float32),
                    np.zeros(3, np.float32),
                ),
                "bouncer",
            )
            gs.add_alias_entity(mdl, origin=np.asarray(self.center, np.float32) + [0, 0, 20])
            gs.rebuild_atlas()
        return gs


def _fogged_court(device="cuda"):
    return outdoor_court(fog_mu_t=0.002, device=device)


PRESETS = {
    # (1) id1 start, static camera, plain PT, 1 spp, 640x360
    "config1": Preset(
        "config1",
        "static camera, plain unidirectional PT, 1 spp, 640x360",
        RenderConfig(width=640, height=360, spp=1, max_path_length=3),
        None,
        cornell_box,
        None,
        16,
    ),
    # (2) scripted camera path, 4 spp accumulation, 1280x720
    "config2": Preset(
        "config2",
        "scripted camera path, 4 spp accumulation, 1280x720",
        RenderConfig(width=1280, height=720, spp=4, max_path_length=3),
        None,
        alcove,
        OrbitGame((256, 256, 100), 160, 60),
        16,
    ),
    # (3) ReSTIR DI temporal+spatial, 1080p
    "config3": Preset(
        "config3",
        "ReSTIR DI with temporal+spatial reuse, 1080p",
        RenderConfig(
            width=1920, height=1080, spp=1, integrator="restir", denoise=True
        ),
        ReSTIRConfig(spatial_reuse_iterations=2, temporal_bias_correction=1),
        cornell_box,
        None,
        8,
    ),
    # (4) SSMM flythrough, 1080p
    "config4": Preset(
        "config4",
        "screen-space mixture-model guiding, flythrough, 1080p",
        RenderConfig(
            width=1920, height=1080, spp=1, integrator="ssmm", denoise=True
        ),
        SSMMConfig(),
        outdoor_court,
        OrbitGame((512, 384, 150), 300, 80),
        8,
    ),
    # (5) MCPG + single scattering, animated entities, 1080p
    "config5": Preset(
        "config5",
        "MCPG + single-scattering volumetrics, animated entities, 1080p",
        RenderConfig(
            width=1920, height=1080, spp=2, integrator="mcpg", denoise=True
        ),
        MCPGConfig(volume=VolumeConfig(volume_spp=1)),
        _fogged_court,
        OrbitGame((512, 384, 150), 280, 90, animated=True),
        8,
    ),
    # (6) guiding-bound certification preset: the occluded-light alcove —
    # the transport MCPG exists for — WITH the MCPG integrator; the scene
    # where certify's "guided integrators should be ≤ 1" criterion is
    # meaningful.
    "config6": Preset(
        "config6",
        "guiding-bound: occluded-light alcove with MCPG, static camera",
        RenderConfig(
            width=640, height=360, spp=1, max_path_length=3,
            integrator="mcpg",
        ),
        MCPGConfig(),
        alcove,
        None,
        16,
    ),
}


def run_preset(name: str, frames: int | None = None, out: str | None = None, device="cuda"):
    """Run a preset on ``device``; returns (state, outputs,
    seconds_per_frame), the mean over the frames after the first. Every
    frame runs through one ``renderer.compile_frame`` (the JAX package
    runs the jitted ``render_frame``): on the card the first call warms up
    on a clone of the state, captures the frame in a CUDA graph and
    replays it, and each later frame is one replay, ended in
    ``torch.cuda.synchronize()``. The state and outputs returned are the
    compiled frame's buffers (on the card, the graph's static buffers,
    which alias its state and outputs). A preset with moving content
    steps its GameState and builds the accel each frame, outside the
    timed render (merian_quake_tpu/presets.py:175-181), and writes it
    into the tables the frame was compiled on (accel.build.write_accel)."""
    import time

    import torch

    from .accel.build import build_accel, scene_features, write_accel
    from .renderer import compile_frame, init_state

    p = PRESETS[name]
    frames = frames if frames is not None else p.frames
    bundle = p.make_bundle(device=device)
    config = p.config._replace(
        features=scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    )
    game = p.make_game(bundle) if p.make_game is not None else None
    sync = torch.device(device).type == "cuda"
    state = init_state(config, p.integ_config, device=device)
    uniforms, atlas = bundle.uniforms, bundle.atlas
    accel = step = None
    if game is None:
        accel = build_accel(bundle.scene, atlas, device=device)
    else:
        atlas = game.static_bundle.atlas
    outputs = None
    t_total = 0.0
    for i in range(frames):
        if game is not None:
            scene, uniforms = game.step(1.0 / 30.0)
            frame_accel = build_accel(scene, atlas, device=device)
            accel = write_accel(accel, frame_accel) if accel is not None else frame_accel
        else:
            uniforms = uniforms._replace(frame=i)
        if step is None:
            step = compile_frame(accel, atlas, config, state, p.integ_config)
        t0 = time.perf_counter()
        state, outputs = step(uniforms)
        if sync:
            torch.cuda.synchronize(device)
        if i > 0:  # skip the cold frame (on the card: the warm-up and the capture)
            t_total += time.perf_counter() - t0
    spf = t_total / max(frames - 1, 1)
    if out:
        from .utils.image import save_png

        save_png(out, outputs["ldr"])
    return state, outputs, spf
