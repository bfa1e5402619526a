"""The tracked benchmark configurations (BASELINE.json).

Port of merian_quake_tpu/presets.py: the same six presets, each with the
JAX package's render config, integrator config, scene and frame count.
Quake game assets (id1/e1m1/ad_*) are not distributable, so each config
substitutes the closest procedural scene while keeping the rendering
setup (integrator, resolution, spp, camera motion, volumetrics,
animated entities) faithful.

config2, config4 and config5 move their camera along an orbit (config5
also animates an alias model): their game loop (``game/state.py``,
``models/mdl.py``) is not ported yet (ROADMAP queue 1, item 5). Their
orbits are kept here as data (``OrbitGame``); ``run_preset`` raises for
them rather than render them with a still camera under their name.
Certification (``utils/certify.py``) renders every preset with a still
camera by design and runs all six.
"""
from __future__ import annotations

from typing import NamedTuple

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
    """A preset's moving content as data: the camera orbits ``center`` at
    ``radius`` and ``height``, looking at the center; ``animated`` adds
    the JAX package's bouncing alias model 20 units above the center
    (merian_quake_tpu/presets.py:33-73). Calling it, as the JAX package
    calls ``make_game(bundle)``, raises until the game loop is ported."""

    center: tuple
    radius: float
    height: float
    animated: bool = False

    def __call__(self, bundle=None):
        raise NotImplementedError(
            "this preset moves its camera along an orbit (OrbitGame"
            f"{tuple(self)}): the game loop it needs (game/state.py, "
            "models/mdl.py) is ROADMAP queue 1, item 5, not ported yet"
        )


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
    seconds_per_frame), the mean over the frames after the first. On the
    card each timed frame ends in ``torch.cuda.synchronize()``. Raises
    NotImplementedError for the presets that move their camera (config2,
    config4, config5: ROADMAP queue 1, item 5)."""
    import time

    import torch

    from .accel.build import build_accel, scene_features
    from .renderer import init_state, render_frame

    p = PRESETS[name]
    if p.make_game is not None:
        p.make_game(None)  # raises: the orbit needs the game loop
    frames = frames if frames is not None else p.frames
    bundle = p.make_bundle(device=device)
    config = p.config._replace(
        features=scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    )
    sync = torch.device(device).type == "cuda"
    state = init_state(config, p.integ_config, device=device)
    accel = build_accel(bundle.scene, bundle.atlas, device=device)
    outputs = None
    t_total = 0.0
    uniforms = bundle.uniforms
    for i in range(frames):
        uniforms = uniforms._replace(frame=i)
        t0 = time.perf_counter()
        state, outputs = render_frame(
            accel, bundle.atlas, uniforms, config, state, p.integ_config
        )
        if sync:
            torch.cuda.synchronize(device)
        if i > 0:  # skip the cold frame
            t_total += time.perf_counter() - t0
    spf = t_total / max(frames - 1, 1)
    if out:
        from .utils.image import save_png

        save_png(out, outputs["ldr"])
    return state, outputs, spf
