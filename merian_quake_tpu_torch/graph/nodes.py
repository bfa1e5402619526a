"""Built-in node types (≈ the 6 registered app nodes + merian built-ins,
merian-quake.cpp:185-203 and default_config.json:402-727).

Port of merian_quake_tpu/graph/nodes.py: the same 17 node types in the
same registry order and the same three graph configs. Each node reaches
the port's functions in the order ``renderer.frame_core`` does, so a
graph wired like the frame (``default_pt_graph_config``,
``flagship_graph_config``) renders the frame's images
(tests/test_torch_graph.py). Node state lives on ``GraphContext.device``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.types import RenderConfig
from ..ops import color as color_ops
from ..post.accumulate import accumulate_reprojected
from ..post.fxaa import fxaa
from ..post.svgf import SVGFParams, init_svgf_state, svgf
from ..post.taa import taa
from ..post.tonemap import tonemap_reinhard_extended
from ..render.gbuffer import render_gbuffer
from ..render.pt import render_pt
from .graph import InputSpec, Node, register_node_type


class GraphContext(NamedTuple):
    """Shared context (≈ merian::Context + allocator): the scene, the
    static config, the integrator configs and the device node state is
    made on. Nodes trace on the default routes (no trace schedule)."""

    accel: object
    atlas: object
    config: RenderConfig
    mcpg_config: object = None
    restir_config: object = None
    ssmm_config: object = None
    device: object = "cuda"


@register_node_type
class GBufferNode(Node):
    TYPE = "gbuffer"

    def inputs(self):
        return [InputSpec("uniforms")]

    def outputs(self):
        return [
            "irradiance", "albedo", "mv", "hits", "normal", "linear_z",
            "z_grad", "z_vel", "gbuffer",
        ]

    def process(self, ctx, state, uniforms):
        g = render_gbuffer(ctx.accel, ctx.atlas, uniforms, ctx.config)
        return state, {
            "irradiance": g.irradiance,
            "albedo": g.albedo,
            "mv": g.mv,
            "hits": g.hits,
            "normal": g.normal,
            "linear_z": g.linear_z,
            "z_grad": g.z_grad,
            "z_vel": g.z_vel,
            "gbuffer": g,
        }


@register_node_type
class PathTracerNode(Node):
    """Reference-mode unidirectional PT (mcpg.comp REFERENCE_MODE)."""

    TYPE = "render_pt"

    def inputs(self):
        return [InputSpec("uniforms"), InputSpec("gbuffer")]

    def outputs(self):
        return ["irradiance"]

    def process(self, ctx, state, uniforms, gbuffer):
        irr = render_pt(ctx.accel, ctx.atlas, uniforms, ctx.config, gbuffer)
        return state, {"irradiance": irr}


@register_node_type
class MCPGNode(Node):
    """The guided surface pass, the volume pass when the MCPGConfig has a
    volume, and the replay of their queues: ``renderer._render_mcpg``,
    the function ``frame_core`` renders a guided frame through."""

    TYPE = "render_markovchain"

    def inputs(self):
        return [InputSpec("uniforms"), InputSpec("gbuffer")]

    def outputs(self):
        return ["irradiance", "volume", "volume_mv"]

    def init_state(self, ctx):
        from ..render.mcpg import MCPGConfig, init_mcpg_state
        from ..render.mcpg.volume import init_volume_state

        mcfg = ctx.mcpg_config or MCPGConfig()
        st = {"mcpg": init_mcpg_state(mcfg, device=ctx.device)}
        if mcfg.volume is not None:
            st["volume"] = init_volume_state(ctx.config, mcfg.volume, device=ctx.device)
        return st

    def process(self, ctx, state, uniforms, gbuffer):
        from ..render.mcpg import MCPGConfig
        from ..renderer import _render_mcpg

        mcfg = ctx.mcpg_config or MCPGConfig()
        irr, new_mcpg, vol = _render_mcpg(
            ctx.accel, ctx.atlas, uniforms, ctx.config, mcfg, state["mcpg"],
            state.get("volume"), gbuffer, None,
        )
        outs = {"irradiance": irr, "volume": None, "volume_mv": None}
        new_state = dict(state, mcpg=new_mcpg)
        if vol is not None:
            new_state["volume"], outs["volume"], outs["volume_mv"] = vol
        return new_state, outs


@register_node_type
class ReSTIRNode(Node):
    TYPE = "render_restir"

    def inputs(self):
        return [InputSpec("uniforms"), InputSpec("gbuffer")]

    def outputs(self):
        return ["irradiance"]

    def init_state(self, ctx):
        from ..render.restir import init_restir_state

        return init_restir_state(ctx.config.width, ctx.config.height, device=ctx.device)

    def process(self, ctx, state, uniforms, gbuffer):
        from ..render.restir import ReSTIRConfig, render_restir

        irr, new_state = render_restir(
            ctx.accel, ctx.atlas, uniforms, ctx.config,
            ctx.restir_config or ReSTIRConfig(), state, gbuffer,
        )
        return new_state, {"irradiance": irr}


@register_node_type
class SSMMNode(Node):
    TYPE = "render_ssmm"

    def inputs(self):
        return [InputSpec("uniforms"), InputSpec("gbuffer")]

    def outputs(self):
        return ["irradiance"]

    def init_state(self, ctx):
        from ..render.ssmm import init_ssmm_state

        return init_ssmm_state(ctx.config.width, ctx.config.height, device=ctx.device)

    def process(self, ctx, state, uniforms, gbuffer):
        from ..render.ssmm import SSMMConfig, render_ssmm

        irr, new_state = render_ssmm(
            ctx.accel, ctx.atlas, uniforms, ctx.config,
            ctx.ssmm_config or SSMMConfig(), state, gbuffer,
        )
        return new_state, {"irradiance": irr}


@register_node_type
class AccumulateNode(Node):
    """Temporal accumulation w/ MV reprojection + firefly filter
    (merian Accumulate, default_config.json:404-427).

    ``mode: "plain"`` uses the cumulative 1/N average without
    reprojection (renderer.frame_core's accumulate); a None src (e.g. a
    disabled volume path) passes None through."""

    TYPE = "accumulate"

    def inputs(self):
        return [InputSpec("src"), InputSpec("mv", optional=True)]

    def outputs(self):
        return ["out"]

    def init_state(self, ctx):
        H, W = ctx.config.height, ctx.config.width
        return {
            "history": torch.zeros((H, W, 4), device=ctx.device),
            "hist_len": torch.zeros((H, W), device=ctx.device),
            "iteration": 0,
        }

    def process(self, ctx, state, src, mv=None):
        if src is None:
            return state, {"out": None}
        alpha = float(self.props.get("alpha", 0.0))
        firefly = float(self.props.get("firefly_k", 0.0))
        if self.props.get("mode", "reproject") == "plain":
            from ..post.accumulate import accumulate as accumulate_plain

            out = accumulate_plain(
                state["history"], src, state["iteration"], alpha=alpha
            )
            new_state = dict(state)
            new_state["history"] = out
            new_state["iteration"] = state["iteration"] + 1
            return new_state, {"out": out}
        if mv is None:
            mv = torch.zeros(src.shape[:2] + (2,), device=src.device)
        out, n = accumulate_reprojected(
            state["history"], state["hist_len"], src, mv,
            alpha=alpha, firefly_k=firefly,
        )
        new_state = dict(state)
        new_state.update(history=out, hist_len=n,
                         iteration=state["iteration"] + 1)
        return new_state, {"out": out}


@register_node_type
class SVGFNode(Node):
    TYPE = "svgf"

    def inputs(self):
        return [
            InputSpec("irradiance"), InputSpec("albedo"), InputSpec("mv"),
            InputSpec("normal"), InputSpec("linear_z"), InputSpec("z_grad"),
        ]

    def outputs(self):
        return ["out"]

    def init_state(self, ctx):
        return init_svgf_state(ctx.config.height, ctx.config.width, device=ctx.device)

    def process(self, ctx, state, irradiance, albedo, mv, normal, linear_z, z_grad):
        if irradiance is None:
            # disabled upstream path (e.g. volume chain with no volume
            # config) passes None through, like the Accumulate node
            return state, {"out": None}
        params = SVGFParams(
            iterations=int(self.props.get("iterations", 5)),
        )
        new_state, out = svgf(
            state, irradiance[..., :3], irradiance[..., 3], mv, normal,
            linear_z, z_grad, albedo[..., :3], params,
        )
        return new_state, {"out": out}


@register_node_type
class AddNode(Node):
    TYPE = "add"

    def inputs(self):
        return [InputSpec("a"), InputSpec("b"), InputSpec("c", optional=True)]

    def outputs(self):
        return ["out"]

    def process(self, ctx, state, a, b, c=None):
        terms = [x for x in (a, b, c) if x is not None]
        out = terms[0][..., :3]
        for x in terms[1:]:
            out = out + x[..., :3]
        return state, {"out": out}


@register_node_type
class ModulateNode(Node):
    """Componentwise multiply (albedo re-modulation after denoise)."""

    TYPE = "modulate"

    def inputs(self):
        return [InputSpec("a"), InputSpec("b")]

    def outputs(self):
        return ["out"]

    def process(self, ctx, state, a, b):
        return state, {"out": a[..., :3] * torch.clamp_min(b[..., :3], 0.0)}


@register_node_type
class ExposureNode(Node):
    TYPE = "exposure"

    def inputs(self):
        return [InputSpec("src")]

    def outputs(self):
        return ["out"]

    def process(self, ctx, state, src):
        key = float(self.props.get("key", 0.18))
        lum = color_ops.yuv_luminance(src[..., :3])
        scale = key / torch.clamp_min(torch.exp(torch.log(lum + 1e-4).mean()), 1e-4)
        return state, {"out": src[..., :3] * scale}


@register_node_type
class TonemapNode(Node):
    TYPE = "tonemap"

    def inputs(self):
        return [InputSpec("src")]

    def outputs(self):
        return ["out"]

    def process(self, ctx, state, src):
        white = float(self.props.get("white", 4.0))
        return state, {"out": tonemap_reinhard_extended(src[..., :3], white=white)}


@register_node_type
class TAANode(Node):
    TYPE = "taa"

    def inputs(self):
        return [InputSpec("src"), InputSpec("mv")]

    def outputs(self):
        return ["out"]

    def init_state(self, ctx):
        return torch.zeros((ctx.config.height, ctx.config.width, 3), device=ctx.device)

    def process(self, ctx, state, src, mv):
        out = taa(state, src[..., :3], mv,
                  blend_alpha=float(self.props.get("alpha", 0.1)))
        return out, {"out": out}


@register_node_type
class FXAANode(Node):
    TYPE = "fxaa"

    def inputs(self):
        return [InputSpec("src")]

    def outputs(self):
        return ["out"]

    def process(self, ctx, state, src):
        return state, {"out": fxaa(src[..., :3])}


@register_node_type
class ImageWriteNode(Node):
    """Host-side PNG/PFM dump (merian Image Write). A due write reads its
    source back to the host (a synchronizing call); a writer without a
    path reads nothing, so a graph with disabled writers makes no host
    read."""

    TYPE = "image_write"

    def inputs(self):
        return [InputSpec("src")]

    def outputs(self):
        return ["out"]

    def init_state(self, ctx):
        return {"count": 0}

    def process(self, ctx, state, src):
        from ..utils.image import save_pfm, save_png

        count = state["count"]
        path = self.props.get("path", "")
        trigger = self.props.get("trigger", "every")
        if trigger == "pow2":
            # power-of-2 iteration trigger (reference HDR reference-render
            # workflow, default_config.json:536-567): frames 1, 2, 4, 8...
            due = count > 0 and (count & (count - 1)) == 0
        else:
            due = count % int(self.props.get("every", 1)) == 0
        if path and due:
            p = path.format(i=count)
            if p.endswith(".pfm"):
                save_pfm(p, src)
            else:
                save_png(p, src)
        return {"count": count + 1}, {"out": src}


@register_node_type
class HudNode(Node):
    """Game HUD compositor (≈ merian::QuakeHud, src/hud/hud.comp).

    ``hud`` is the per-frame HudState pushed through ``$frame`` by the
    app shell; without one the node passes the image through (headless
    reference renders)."""

    TYPE = "hud"

    def inputs(self):
        return [
            InputSpec("src"),
            InputSpec("linear_z", optional=True),
            InputSpec("hud", optional=True),
        ]

    def outputs(self):
        return ["out"]

    def process(self, ctx, state, src, linear_z=None, hud=None):
        if hud is None:
            return state, {"out": src}
        from ..game.hud import apply_hud

        if linear_z is None:
            linear_z = torch.full(src.shape[:2], 1e4, device=src.device)
        return state, {"out": apply_hud(src[..., :3], linear_z, hud)}


@register_node_type
class ColorNode(Node):
    """Constant-color image source (merian Color node — the reference's
    'one' node feeds an all-ones albedo to the volume denoiser). Each
    frame gets its own image, made by fills: no view of a shared buffer
    that a consumer could write into, and no host-to-device copy."""

    TYPE = "color"

    def outputs(self):
        return ["out"]

    def process(self, ctx, state, **kw):
        H, W = ctx.config.height, ctx.config.width
        color = self.props.get("color", [1.0, 1.0, 1.0, 1.0])
        img = torch.empty((H, W, len(color)), device=ctx.device)
        for i, c in enumerate(color):
            img.select(-1, i).fill_(float(c))
        return state, {"out": img}


def _blue_noise_texture(size: int = 64, channels: int = 4, seed: int = 1337):
    """Deterministic blue-noise via spectral shaping: white noise is
    re-weighted by |f| in Fourier space and rank-normalized. Stands in
    for the reference's bundled LDR_RGBA PNG (no redistributable assets
    in this environment). numpy, bit for bit the JAX package's."""
    import numpy as np

    rng = np.random.default_rng(seed)
    chans = []
    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.fftfreq(size)[None, :]
    w = np.sqrt(fx * fx + fy * fy)
    for _ in range(channels):
        x = rng.random((size, size))
        shaped = np.real(np.fft.ifft2(np.fft.fft2(x) * w))
        ranks = shaped.ravel().argsort().argsort().reshape(size, size)
        chans.append((ranks + 0.5) / (size * size))
    return np.stack(chans, axis=-1).astype(np.float32)


@register_node_type
class LDRImageNode(Node):
    """LDR image loader (merian LDR Image; the reference loads a blue-
    noise PNG, default_config.json:464-471). A missing/unset path
    yields a generated blue-noise texture of ``size``."""

    TYPE = "ldr_image"

    def outputs(self):
        return ["out"]

    def init_state(self, ctx):
        import os

        path = self.props.get("path", "")
        if path and os.path.exists(path):
            from ..utils.image import load_png

            img = load_png(path).astype("float32") / 255.0
        else:
            img = _blue_noise_texture(int(self.props.get("size", 64)))
        device = ctx.device if ctx is not None else "cuda"
        return {"image": torch.from_numpy(img).to(device)}

    def process(self, ctx, state, **kw):
        return state, {"out": state["image"]}


def flagship_graph_config() -> dict:
    """The full reference default pipeline as a graph config
    (the reference's res/default_config.json:2-372): MCPG renderer +
    volume accumulate (volume-MV reprojected) + a SECOND SVGF denoiser
    on the volume path + add(volume, filtered, direct emission) +
    auto-exposure + tonemap + TAA + FXAA + HUD, with
    power-of-2-triggered HDR/beauty image writers (paths empty =
    disabled, like the reference's trigger config) and the unconnected
    blue-noise loader the reference config also carries ('one' feeds
    the volume denoiser's albedo, default_config.json:439,328-372).
    The denoise chain reproduces renderer.frame_core's denoise path
    exactly (tested in tests/test_torch_graph.py)."""
    return {
        "nodes": {
            "gbuffer": {"type": "gbuffer"},
            "renderer": {"type": "render_markovchain"},
            "volume_accum": {
                "type": "accumulate", "properties": {"mode": "reproject"}
            },
            "volume_denoiser": {
                "type": "svgf", "properties": {"iterations": 5}
            },
            "denoiser": {"type": "svgf", "properties": {"iterations": 5}},
            "add": {"type": "add"},
            "exposure": {"type": "exposure"},
            "tonemap": {"type": "tonemap"},
            "taa": {"type": "taa"},
            "fxaa": {"type": "fxaa"},
            "hud": {"type": "hud"},
            "one": {"type": "color",
                    "properties": {"color": [1.0, 1.0, 1.0, 1.0]}},
            "blue_noise": {"type": "ldr_image", "properties": {"size": 64}},
            "beauty_write": {
                "type": "image_write",
                "properties": {"path": "", "trigger": "pow2"},
            },
            "hdr_write": {
                "type": "image_write",
                "properties": {"path": "", "trigger": "pow2"},
            },
        },
        "connections": [
            ["$frame", "uniforms", "gbuffer", "uniforms"],
            ["$frame", "uniforms", "renderer", "uniforms"],
            ["gbuffer", "gbuffer", "renderer", "gbuffer"],
            # volume chain: MV-reprojected accumulate + second SVGF
            # (default_config.json:289-372; volume_mv input :298-304)
            ["renderer", "volume", "volume_accum", "src"],
            ["renderer", "volume_mv", "volume_accum", "mv"],
            ["volume_accum", "out", "volume_denoiser", "irradiance"],
            ["one", "out", "volume_denoiser", "albedo"],
            ["renderer", "volume_mv", "volume_denoiser", "mv"],
            ["gbuffer", "normal", "volume_denoiser", "normal"],
            ["gbuffer", "linear_z", "volume_denoiser", "linear_z"],
            ["gbuffer", "z_grad", "volume_denoiser", "z_grad"],
            # denoise chain (frame_core denoise path)
            ["renderer", "irradiance", "denoiser", "irradiance"],
            ["gbuffer", "albedo", "denoiser", "albedo"],
            ["gbuffer", "mv", "denoiser", "mv"],
            ["gbuffer", "normal", "denoiser", "normal"],
            ["gbuffer", "linear_z", "denoiser", "linear_z"],
            ["gbuffer", "z_grad", "denoiser", "z_grad"],
            ["denoiser", "out", "add", "a"],
            ["gbuffer", "irradiance", "add", "b"],
            ["volume_denoiser", "out", "add", "c"],
            ["add", "out", "exposure", "src"],
            ["exposure", "out", "tonemap", "src"],
            ["tonemap", "out", "taa", "src"],
            ["gbuffer", "mv", "taa", "mv"],
            ["taa", "out", "fxaa", "src"],
            ["fxaa", "out", "hud", "src"],
            ["gbuffer", "linear_z", "hud", "linear_z"],
            ["$frame", "hud", "hud", "hud"],
            # writers (reference: beauty taps fxaa, HDR taps denoiser)
            ["fxaa", "out", "beauty_write", "src"],
            ["add", "out", "hdr_write", "src"],
        ],
    }


def default_graph_config(renderer_type: str = "render_pt") -> dict:
    """Reference-style default wiring for any renderer node type
    (render_pt | render_markovchain | render_restir | render_ssmm)."""
    cfg = default_pt_graph_config()
    cfg["nodes"]["renderer"] = {"type": renderer_type}
    return cfg


def default_pt_graph_config() -> dict:
    """The hand-wired renderer.frame_core pipeline as a graph config
    (≈ a reduced res/default_config.json)."""
    return {
        "nodes": {
            "gbuffer": {"type": "gbuffer"},
            "renderer": {"type": "render_pt"},
            "accum": {"type": "accumulate"},
            "accum_albedo": {"type": "accumulate"},
            "accum_direct": {"type": "accumulate"},
            "modulate": {"type": "modulate"},
            "add": {"type": "add"},
            "exposure": {"type": "exposure"},
            "tonemap": {"type": "tonemap"},
        },
        "connections": [
            ["$frame", "uniforms", "gbuffer", "uniforms"],
            ["$frame", "uniforms", "renderer", "uniforms"],
            ["gbuffer", "gbuffer", "renderer", "gbuffer"],
            ["renderer", "irradiance", "accum", "src"],
            ["gbuffer", "albedo", "accum_albedo", "src"],
            ["gbuffer", "irradiance", "accum_direct", "src"],
            ["accum", "out", "modulate", "a"],
            ["accum_albedo", "out", "modulate", "b"],
            ["modulate", "out", "add", "a"],
            ["accum_direct", "out", "add", "b"],
            ["add", "out", "exposure", "src"],
            ["exposure", "out", "tonemap", "src"],
        ],
    }
