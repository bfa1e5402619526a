"""The frame graph (graph/graph.py, graph/nodes.py) and the HUD
(game/hud.py): the nine cases of tests/test_graph.py on the port, and
the pieces held against the JAX package.

- The graph against the port's ``frame_core``, as the JAX package's
  graph is held against its own: the PT graph (``default_pt_graph_config``,
  whose accumulators reproject with zero motion where the frame averages
  plainly) within atol 1e-5 on the LDR (tests/test_graph.py's bound)
  and on the HDR image (read: equal; the box's LDR is black or white at
  this size, so the HDR is what tells a wrong term),
  and the flagship graph (MCPG, SVGF, exposure, tonemap, TAA, FXAA, the
  HUD passing through) equal to the denoised frame, HUD and add outputs
  and both SVGF histories, with ``assert_array_equal`` (read: equal).
  The graph's ``render_markovchain`` node renders through
  ``renderer._render_mcpg``, the function ``frame_core`` calls.
- ``res/default_graph.json`` and ``res/pt_graph.json`` load as they are
  and store the JAX package's config.
- ``apply_hud`` against the JAX package's on seeded images and depths,
  every liquid, a screen blend, armor, health out of range: within 1e-6
  (read: 6.0e-8; the JAX package jitted against op by op: 1.2e-7).
- ``_blue_noise_texture``: bit for bit.

Mutants, each failing its bound: the add node dropping the first-hit
emission in the PT graph,
the SVGF nodes running 4 à-trous passes in the flagship graph, and the
health bar filled to a tenth of the health.
The flagship graph on the fogged court against the JAX package's graph
is tests/test_torch_graph_volume.py.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu.game.hud import HudState as JHudState
from merian_quake_tpu.game.hud import apply_hud as j_apply_hud
from merian_quake_tpu.graph import Graph as JGraph
from merian_quake_tpu.graph.nodes import _blue_noise_texture as j_blue_noise
from merian_quake_tpu_torch.accel.build import build_accel
from merian_quake_tpu_torch.game import hud as t_hud
from merian_quake_tpu_torch.game.hud import HudState, apply_hud
from merian_quake_tpu_torch.graph import Graph, InputSpec, Node
from merian_quake_tpu_torch.graph import nodes as t_nodes
from merian_quake_tpu_torch.graph.graph import register_node_type
from merian_quake_tpu_torch.graph.nodes import (
    GraphContext, _blue_noise_texture, default_graph_config, default_pt_graph_config,
    flagship_graph_config,
)
from merian_quake_tpu_torch.models.procedural import cornell_box
from merian_quake_tpu_torch.models.types import RenderConfig
from merian_quake_tpu_torch.render.mcpg import MCPGConfig
from merian_quake_tpu_torch.renderer import frame_core, init_state, render_frame

torch.set_num_threads(min(2, torch.get_num_threads()))

RES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "res")
HUD_ATOL = 1e-6


@register_node_type
class _ConstNode(Node):
    TYPE = "_const"

    def outputs(self):
        return ["out"]

    def process(self, ctx, state, **kw):
        return state, {"out": torch.full((2, 2), float(self.props.get("v", 1.0)))}


@register_node_type
class _AddOneNode(Node):
    TYPE = "_addone"

    def inputs(self):
        return [InputSpec("src")]

    def outputs(self):
        return ["out"]

    def process(self, ctx, state, src):
        return state, {"out": src + 1.0}


@register_node_type
class _DelayNode(Node):
    TYPE = "_delay"

    def inputs(self):
        return [InputSpec("now"), InputSpec("prev", delay=1, optional=True)]

    def outputs(self):
        return ["out"]

    def process(self, ctx, state, now, prev):
        prev = torch.zeros_like(now) if prev is None else prev
        return state, {"out": now + prev}


def test_toposort_and_dataflow():
    g = Graph()
    g.add_node(_ConstNode("c", {"v": 2.0}))
    g.add_node(_AddOneNode("p1"))
    g.add_node(_AddOneNode("p2"))
    g.connect("c", "out", "p1", "src")
    g.connect("p1", "out", "p2", "src")
    st = g.init_state()
    st, out = g.run(st)
    np.testing.assert_allclose(out[("p2", "out")].numpy(), 4.0)


def test_cycle_without_delay_rejected():
    g = Graph()
    g.add_node(_AddOneNode("a"))
    g.add_node(_AddOneNode("b"))
    g.connect("a", "out", "b", "src")
    g.connect("b", "out", "a", "src")
    with pytest.raises(ValueError, match="cycle"):
        st = g.init_state()
        g.run(st)


def test_delayed_edge_reads_previous_frame():
    g = Graph()
    g.add_node(_ConstNode("c", {"v": 3.0}))
    g.add_node(_DelayNode("d"))
    g.connect("c", "out", "d", "now")
    g.connect("d", "out", "d", "prev")  # self-loop via delay (history)
    st = g.init_state()
    for want in (3.0, 6.0, 9.0):
        st, out = g.run(st)
        np.testing.assert_allclose(out[("d", "out")].numpy(), want)


def test_config_roundtrip(tmp_path):
    cfg = default_pt_graph_config()
    g = Graph.from_config(cfg)
    path = str(tmp_path / "graph.json")
    g.store(path)
    with open(path) as f:
        cfg2 = json.load(f)
    g2 = Graph.from_config(cfg2)
    assert set(g2.nodes) == set(g.nodes)
    assert g2.connections == g.connections
    assert g2.to_config() == g.to_config()
    # the repository's graph files load as they are, as the JAX package's do
    for name in ("default_graph.json", "pt_graph.json"):
        path = os.path.join(RES, name)
        assert Graph.from_config(path).to_config() == JGraph.from_config(path).to_config()
    assert Graph.from_config(default_graph_config("render_ssmm")).nodes["renderer"].TYPE == "render_ssmm"


def _box(config, mcfg=None):
    bundle = cornell_box(device="cpu")
    accel = build_accel(bundle.scene, bundle.atlas, device="cpu")
    ctx = GraphContext(accel=accel, atlas=bundle.atlas, config=config, mcpg_config=mcfg, device="cpu")
    return bundle, accel, ctx


def pt_graph_agrees(frames=2):
    config = RenderConfig(width=48, height=32, spp=1, max_path_length=3)
    bundle, accel, ctx = _box(config)
    g = Graph.from_config(default_pt_graph_config(), ctx)
    gstate, fstate = g.init_state(), init_state(config, device="cpu")
    for i in range(frames):
        uniforms = bundle.uniforms._replace(frame=i)
        gstate, out = g.run(gstate, {"uniforms": uniforms})
        fstate, fout = render_frame(accel, bundle.atlas, uniforms, config, fstate)
    np.testing.assert_allclose(out[("tonemap", "out")].numpy(), fout["ldr"].numpy(), atol=1e-5)
    np.testing.assert_allclose(out[("add", "out")].numpy(), fout["hdr"].numpy(), atol=1e-5)


def test_graph_matches_handwired_renderer():
    """The default graph must reproduce renderer.frame_core."""
    pt_graph_agrees()


MCFG = MCPGConfig(mc_adaptive_size=1 << 10, mc_static_size=1 << 8, lc_size=1 << 10)


def flagship_agrees(frames=3):
    config = RenderConfig(width=48, height=32, spp=1, max_path_length=3, integrator="mcpg",
                          denoise=True)
    bundle, accel, ctx = _box(config, MCFG)
    g = Graph.from_config(flagship_graph_config(), ctx)
    gstate, fstate = g.init_state(), init_state(config, MCFG, device="cpu")
    for i in range(frames):
        uniforms = bundle.uniforms._replace(frame=i)
        gstate, out = g.run(gstate, {"uniforms": uniforms})
        fstate, fout = frame_core(accel, bundle.atlas, uniforms, config, fstate, mcpg_config=MCFG)
    np.testing.assert_array_equal(out[("hud", "out")].numpy(), fout["ldr"].numpy())
    np.testing.assert_array_equal(out[("add", "out")].numpy(), fout["hdr"].numpy())
    for a, b in zip(gstate["nodes"]["denoiser"], fstate.svgf):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    return gstate, fstate


def test_flagship_graph_matches_handwired_denoise_path():
    """The flagship default graph (MCPG + SVGF + add + exposure + tonemap
    + TAA + FXAA + HUD passthrough) must reproduce renderer.frame_core's
    denoise path exactly."""
    gstate, fstate = flagship_agrees()
    assert gstate["nodes"]["renderer"].get("volume") is None and fstate.volume is None
    assert torch.equal(gstate["nodes"]["renderer"]["mcpg"].mc.f, fstate.mcpg.mc.f)


def test_image_write_pow2_trigger(tmp_path):
    """Power-of-2 iteration writer (default_config.json:536-567)."""
    from merian_quake_tpu_torch.graph.nodes import ImageWriteNode

    node = ImageWriteNode("w", {"path": str(tmp_path / "f_{i}.png"), "trigger": "pow2"})
    state = node.init_state(None)
    img = torch.zeros((4, 4, 3))
    for i in range(9):
        state, _ = node.process(None, state, img)
    written = sorted(os.listdir(tmp_path))
    assert written == ["f_1.png", "f_2.png", "f_4.png", "f_8.png"], written


def test_hud_color_bluenoise_nodes():
    from merian_quake_tpu_torch.graph.nodes import ColorNode, HudNode, LDRImageNode

    cfg = RenderConfig(width=32, height=16)
    ctx = GraphContext(accel=None, atlas=None, config=cfg, device="cpu")
    color = ColorNode("one", {"color": [1.0, 0.5, 0.25, 1.0]})
    _, out = color.process(ctx, None)
    assert out["out"].shape == (16, 32, 4)
    np.testing.assert_allclose(out["out"][0, 0].numpy(), [1.0, 0.5, 0.25, 1.0])
    _, again = color.process(ctx, None)
    assert again["out"].data_ptr() != out["out"].data_ptr()  # a frame's own image

    bn = LDRImageNode("blue_noise", {"size": 32})
    st = bn.init_state(ctx)
    _, out = bn.process(ctx, st)
    noise = out["out"].numpy()
    assert noise.shape == (32, 32, 4)
    # rank-normalized: every channel exactly covers (0, 1)
    assert abs(noise.mean() - 0.5) < 1e-3

    hud = HudNode("hud", {})
    src = torch.ones((16, 32, 3)) * 0.5
    _, out = hud.process(ctx, None, src, None, None)
    np.testing.assert_allclose(out["out"].numpy(), 0.5)  # passthrough
    _, out = hud.process(ctx, None, src, torch.full((16, 32), 100.0), HudState(health=50.0))
    assert not np.allclose(out["out"].numpy(), 0.5)  # bars drawn


def test_compiled_graph_matches_eager():
    config = RenderConfig(width=48, height=32, spp=1, max_path_length=2)
    bundle, _, ctx = _box(config)
    g = Graph.from_config(default_pt_graph_config(), ctx)
    step = g.compile()
    se, sj = g.init_state(), g.init_state()
    for i in range(2):
        uniforms = bundle.uniforms._replace(frame=i)
        se, oe = g.run(se, {"uniforms": uniforms})
        sj, oj = step(sj, {"uniforms": uniforms})
    np.testing.assert_allclose(oj[("tonemap", "out")].numpy(), oe[("tonemap", "out")].numpy(),
                               atol=1e-6)
    cfg = flagship_graph_config()
    cfg["nodes"]["beauty_write"]["properties"]["path"] = "frame_{i}.png"
    with pytest.raises(ValueError, match="host-side"):
        Graph.from_config(cfg, ctx).compile()


HUDS = [dict(), dict(health=37.3, armor=150.0, screen_blend=(1.0, 0.2, 0.1, 0.35), liquid=1),
        dict(health=-5.0, armor=12.5, liquid=2), dict(health=250.0, liquid=3,
                                                       screen_blend=(0.0, 0.0, 1.0, 0.9))]


def hud_agrees(hud, h, w):
    r = np.random.default_rng(h * w)
    ldr = r.uniform(0, 1, (h, w, 3)).astype(np.float32)
    z = r.uniform(0, 2000, (h, w)).astype(np.float32)
    ref = np.asarray(j_apply_hud(jnp.asarray(ldr), jnp.asarray(z), JHudState(**hud)))
    got = apply_hud(torch.from_numpy(ldr), torch.from_numpy(z), HudState(**hud)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=HUD_ATOL)


@pytest.mark.parametrize("size", [(36, 64), (17, 33)])
@pytest.mark.parametrize("hud", range(len(HUDS)))
def test_apply_hud_matches_jax(hud, size):
    hud_agrees(HUDS[hud], *size)


@pytest.mark.parametrize("size", [32, 64])
def test_blue_noise_bit_equal(size):
    np.testing.assert_array_equal(_blue_noise_texture(size), j_blue_noise(size))


def test_mutants_fail(monkeypatch):
    """The add node dropping the first-hit emission (PT graph), 4 à-trous
    passes (flagship), the health bar filled to a tenth of the health."""
    plain = t_nodes.AddNode.process
    monkeypatch.setattr(t_nodes.AddNode, "process", lambda self, ctx, st, a, b, c=None: plain(
        self, ctx, st, a, torch.zeros_like(b), c))
    with pytest.raises(AssertionError):
        pt_graph_agrees()
    monkeypatch.setattr(t_nodes.AddNode, "process", plain)
    plain_svgf = t_nodes.SVGFNode.process
    monkeypatch.setattr(t_nodes.SVGFNode, "process", lambda self, ctx, st, **k: plain_svgf(
        type(self)(self.name, {"iterations": 4}), ctx, st, **k))
    with pytest.raises(AssertionError):
        flagship_agrees(frames=1)
    plain_bar = t_hud._bar
    monkeypatch.setattr(t_hud, "_bar", lambda xx, yy, x0, y0, bw, bh, v: plain_bar(
        xx, yy, x0, y0, bw, bh, v / 10.0))
    with pytest.raises(AssertionError):
        hud_agrees(HUDS[1], 36, 64)
