"""The port must run where JAX is not installed (the GPU machine has
none): in a subprocess that blocks ``jax`` before anything is imported,
build cornell_box and render one 32×16 path-traced frame, one 32×16
ReSTIR frame, two 32×16 guided (MCPG) frames, two 32×16 MCPG frames
with the volume pass on the fogged court, one path-traced frame
under a trace schedule, two denoised path-traced frames and two SSMM
frames on the CPU, trace it under the schedule through ``woop.intersect_woop``'s glue,
time two frames through ``bench_torch.phases``, import ``interop``, ``presets``,
``utils.certify`` and both debug view modules, and run res/pt_graph.json
through the frame graph for one 16×8 frame. And the port's entry
points run on the card unless the caller asks for the CPU: without a
CUDA device, a call without ``device=`` raises."""
import os
import subprocess
import sys

import pytest
import torch

from merian_quake_tpu_torch.models.procedural import city, cornell_box
from merian_quake_tpu_torch.models.types import RenderConfig
from merian_quake_tpu_torch.renderer import render_sequence

_SCRIPT = """
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import torch
from merian_quake_tpu_torch.models.procedural import cornell_box
from merian_quake_tpu_torch.models.types import RenderConfig
from merian_quake_tpu_torch.renderer import render_sequence
state, out = render_sequence(cornell_box(device="cpu"), RenderConfig(width=32, height=16, spp=1), frames=1, device="cpu")
assert out["ldr"].shape == (16, 32, 3) and bool(torch.isfinite(out["hdr"]).all())
state, out = render_sequence(cornell_box(device="cpu"), RenderConfig(width=32, height=16, integrator="restir"), frames=1, device="cpu")
assert out["ldr"].shape == (16, 32, 3) and bool(torch.isfinite(out["hdr"]).all())
assert state.restir.reservoirs.M.shape == (32 * 16,)
from merian_quake_tpu_torch.render.mcpg import MCPGConfig
state, out = render_sequence(cornell_box(device="cpu"), RenderConfig(width=32, height=16, integrator="mcpg"), frames=2, mcpg_config=MCPGConfig(), device="cpu")
assert out["ldr"].shape == (16, 32, 3) and bool(torch.isfinite(out["hdr"]).all())
assert int((state.mcpg.mc.sum_w > 0).sum()) > 0 and int(state.mcpg.lc_updates_applied) > 0
from merian_quake_tpu_torch.models.procedural import outdoor_court
from merian_quake_tpu_torch.render.mcpg.config import production_config
from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig
state, out = render_sequence(outdoor_court(0.002, device="cpu"), RenderConfig(width=32, height=16, integrator="mcpg"), frames=2, mcpg_config=MCPGConfig(volume=VolumeConfig()), device="cpu")
assert out["volume"].shape == (16, 32, 4) and bool(torch.isfinite(out["hdr"]).all())
assert float(state.accum_volume[..., :3].mean()) > 0 and production_config().volume.volume_spp == 2
from merian_quake_tpu_torch.accel import build_accel, woop
sched = woop.TraceSchedule(True, 8, 32)
state, out = render_sequence(cornell_box(device="cpu"), RenderConfig(width=32, height=16, spp=1), frames=1, device="cpu", schedule=sched)
assert out["ldr"].shape == (16, 32, 3) and bool(torch.isfinite(out["hdr"]).all())
acc = build_accel(cornell_box(device="cpu").scene)
o, d = torch.zeros((256, 3)) + 0.5, torch.nn.functional.normalize(torch.rand((256, 3)) - 0.5, dim=-1)
hr = woop.intersect_woop(acc, o, d, 0.0, 1e4, sort_rays=True, schedule=sched)
assert torch.equal(hr.tri, woop.intersect_woop(acc, o, d, 0.0, 1e4).tri)
state, out = render_sequence(cornell_box(device="cpu"), RenderConfig(width=32, height=16, denoise=True), frames=2, device="cpu")
assert out["ldr"].shape == (16, 32, 3) and bool(torch.isfinite(out["ldr"]).all()) and state.svgf.history_len.max() == 2
state, out = render_sequence(cornell_box(device="cpu"), RenderConfig(width=32, height=16, spp=2, integrator="ssmm"), frames=2, device="cpu")
assert out["ldr"].shape == (16, 32, 3) and bool(torch.isfinite(out["ldr"]).all()) and float(state.ssmm.sum_w.max()) > 0
import merian_quake_tpu_torch.interop
import bench_torch
b = cornell_box(device="cpu")
t, peak = bench_torch.phases(b, build_accel(b.scene, b.atlas), RenderConfig(width=16, height=8, integrator="mcpg"), MCPGConfig(), {"cold": 0, "warm": 1}, 1, "cpu")
assert set(t) == {"cold", "warm"} and min(t.values()) > 0 and peak is None
import merian_quake_tpu_torch.presets, merian_quake_tpu_torch.utils.certify
import merian_quake_tpu_torch.render.mcpg.debug, merian_quake_tpu_torch.render.restir.debug
from merian_quake_tpu_torch.graph import Graph
from merian_quake_tpu_torch.graph.nodes import GraphContext
g = Graph.from_config("res/pt_graph.json", GraphContext(build_accel(b.scene, b.atlas), b.atlas, RenderConfig(width=16, height=8), device="cpu"))
st, out = g.run(g.init_state(), {"uniforms": b.uniforms})
assert out[("tonemap", "out")].shape == (8, 16, 3) and bool(torch.isfinite(out[("add", "out")]).all())
loaded = [m for m, mod in sys.modules.items() if mod is not None]
assert not [m for m in loaded if m in ("jax", "merian_quake_tpu") or m.startswith(("jax.", "merian_quake_tpu."))]
print("ok")
"""


def test_port_runs_without_jax():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=repo, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run on it")
    import bench_torch

    with pytest.raises(SystemExit):  # a measurement without a card fails
        bench_torch.main()
    # torch built for the CPU raises AssertionError, a CUDA build with no
    # device RuntimeError
    with pytest.raises((AssertionError, RuntimeError)):
        city()
    bundle = cornell_box(device="cpu")
    with pytest.raises((AssertionError, RuntimeError)):
        render_sequence(bundle, RenderConfig(width=8, height=4, spp=1))
    from merian_quake_tpu_torch.graph import Graph
    from merian_quake_tpu_torch.graph.nodes import GraphContext, default_pt_graph_config
    from merian_quake_tpu_torch.presets import run_preset
    from merian_quake_tpu_torch.utils.certify import certify_presets

    with pytest.raises((AssertionError, RuntimeError)):
        run_preset("config1", frames=1)
    with pytest.raises((AssertionError, RuntimeError)):
        certify_presets(["config1"], scale=0.05, frames=1, ref_frames=1, ref_runs=1)
    ctx = GraphContext(None, None, RenderConfig(width=8, height=4))
    with pytest.raises((AssertionError, RuntimeError)):
        Graph.from_config(default_pt_graph_config(), ctx).init_state()
