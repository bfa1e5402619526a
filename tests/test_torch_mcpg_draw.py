"""MCPG's guide-state draws (render/mcpg/draw.py) on the CPU.

``draw.draw_states`` runs the K-draw reservoir loop of a surface bounce
segment or a volume sample: on CUDA tensors one launch of csrc/mcpg_draw.cu,
on CPU tensors its plain version ``draw_states_reference``, the torch loop
that ``render_mcpg_surface`` and ``render_volume`` ran in place before.
Here:

- the CPU path gives, bit for bit, the RNG state, winner, winner row, score
  sum and per-draw lobes (mu, kappa, sum_w, N) of the frozen loops in
  ``quakebench/reference/render/mcpg/surface.py`` and ``volume.py``, run as
  they are written (their source text, executed on the same inputs with
  the reference's own helpers). The inputs are seeded; the table is laid
  out so that the draws meet hash matches and misses, tombstoned rows
  (sum_w < 0), dead lanes, the hemisphere test's rejection, a mixed slot
  (K·p = 3.5) and none (K·p = 3.0), and grid_tile_bits 0 and 2, each
  counted;
- ``render_mcpg_surface`` (full width and the compacted live prefix of
  ``surf_live_budget``) and ``render_volume`` on the CPU equal their frozen
  copies on a fogged court frame, every output leaf;
- the wrapper raises on another dtype, shape, device or layout, and on
  more draws than the kernel takes; nothing on the CPU loads the kernel
  library or counts a launch.

The kernel itself needs the card: the ``cuda`` test skips here and names
chip_smoke.py's phase 42, which holds it bit for bit against the torch
loop there (1080p surface and volume populations on the production-size
table, a 37x53 input, a captured live dungeon frame against eager frames).
"""
import math
import os
import textwrap
import types

import pytest
import torch

from merian_quake_tpu_torch import kernels
from merian_quake_tpu_torch.accel.build import build_accel, scene_features
from merian_quake_tpu_torch.capture import tree_leaves
from merian_quake_tpu_torch.models.procedural import outdoor_court
from merian_quake_tpu_torch.models.types import RenderConfig
from merian_quake_tpu_torch.render.gbuffer import render_gbuffer
from merian_quake_tpu_torch.render.mcpg import draw, surface as t_surface, volume as t_volume
from merian_quake_tpu_torch.render.mcpg.config import MCPGConfig
from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig
from merian_quake_tpu_torch.render.trace import trace_ray
from merian_quake_tpu_torch.renderer import init_state, render_frame
from quakebench.reference.ops import rng as r_rng
from quakebench.reference.render.mcpg import grids as r_grids
from quakebench.reference.render.mcpg import surface as r_surface
from quakebench.reference.render.mcpg import volume as r_volume

torch.set_num_threads(min(2, torch.get_num_threads()))

REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "quakebench", "reference", "render", "mcpg")
N = 3000
ADAPTIVE, STATIC = 1 << 12, 1 << 9


def _snippet(name, start, end):
    """The lines of the reference's ``name`` from the one that starts with
    ``start`` up to (without) the one that starts with ``end``, dedented."""
    src = open(os.path.join(REF, name)).read()
    a = src.index(start)
    return compile(textwrap.dedent(src[a:src.index(end, a)]), f"{name} (frozen loop)", "exec")


SURFACE_LOOP = _snippet("surface.py", "        lookup_level = grids.adaptive_target_level(",
                        "        have_guiding = score_sum > 0.0")
VOLUME_LOOP = _snippet("volume.py", "        score_sum = torch.zeros((n,), device=dev)\n",
                       "        have_guide = score_sum > 0.0")


class _Spy:
    """The reference's grids module, recording what each draw gathers and
    the hashes its finalize expects."""

    def __init__(self):
        self.rows, self.hashes = [], []

    def __getattr__(self, name):
        return getattr(r_grids, name)

    def gather_state_packed_draw(self, packed, idx):
        self.rows.append(idx.clone())
        self.hashes.append([])
        return r_grids.gather_state_packed_draw(packed, idx)

    def finalize_load(self, s, expected_hash, *args, **kw):
        self.hashes[-1].append(expected_hash.clone())
        return r_grids.finalize_load(s, expected_hash, *args, **kw)


def _frozen(kind, inp, mcfg, table, grids=r_grids):
    """The reference's loop as written: (rng, win, win_buf, score_sum, mus,
    kappas, sum_ws, Ns)."""
    ns = {"torch": torch, "math": math, "grids": grids, "rng_ops": r_rng, "mcfg": mcfg,
          "K": mcfg.mc_samples, "dev": torch.device("cpu"), "cam_x": inp["cam_x"],
          "uniforms": types.SimpleNamespace(cl_time=inp["cl_time"]), "mc_packed": table,
          "_select_state": r_surface._select_state}
    if kind == "surface":
        ns.update(nl=N, rng_state=inp["rng"], lookup_pos=inp["lookup"], done=inp["dead"],
                  cur=types.SimpleNamespace(pos=inp["pos"], normal=inp["normal"]))
        exec(SURFACE_LOOP, ns)
        return (ns["rng_state"], ns["win"], ns["win_buf"], ns["score_sum"], ns["mus"],
                ns["kappas"], ns["scores"], ns["draw_ns"])
    ns.update(n=N, rng=inp["rng"], pos=inp["pos"], vnormal=inp["normal"],
              ka_exact=mcfg.mc_samples * mcfg.mc_samples_adaptive_prob)
    exec(VOLUME_LOOP, ns)
    return (ns["rng"], ns["win"], ns["win_buf"], ns["score_sum"], ns["gmus"], ns["gkaps"],
            ns["gscores"], ns["gns"])


def _ours(kind, inp, mcfg, table):
    if kind == "surface":
        return draw.draw_states(inp["rng"], inp["lookup"], inp["pos"], inp["normal"],
                                inp["cam_x"], inp["cl_time"], table, mcfg, dead=inp["dead"],
                                hemisphere=True)
    return draw.draw_states(inp["rng"], inp["pos"], inp["pos"], inp["normal"], inp["cam_x"],
                            inp["cl_time"], table, mcfg)


def _inputs(kind, seed):
    """n lanes around the camera: positions 0.5-60 units away (adaptive
    levels from fine to coarse), unit normals, a tenth of the surface's
    lanes dead, its lookup position a small step off (sample 0's previous
    position) on half of them."""
    g = torch.Generator().manual_seed(seed)
    cam = torch.tensor([1.5, -2.0, 0.75])
    d = torch.randn(N, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    pos = cam + d * (0.5 + 60.0 * torch.rand(N, 1, generator=g) ** 2)
    nrm = torch.randn(N, 3, generator=g)
    nrm = nrm / nrm.norm(dim=-1, keepdim=True)
    rng = torch.randint(1, 1 << 32, (N,), generator=g, dtype=torch.int64)
    inp = {"rng": rng, "pos": pos, "normal": nrm, "cam_x": cam, "cl_time": torch.tensor(12.25)}
    if kind == "surface":
        step = 0.05 * torch.randn(N, 3, generator=g) * (torch.rand(N, 1, generator=g) < 0.5)
        inp["lookup"] = pos + step
        inp["dead"] = torch.rand(N, generator=g) < 0.1
    else:
        inp["normal"] = -d  # the volume's normal: the negated view direction
    return inp


def _table(kind, inp, mcfg, seed):
    """A draw table whose rows meet the lanes' draws: random states (targets
    around the lanes, a fifth tombstoned), then the hash each draw expects
    written into the row it gathers for 70% of the lanes (for a mixed slot
    the adaptive or the static cell's, at random), found by a first run of
    the frozen loop on a table of zeros."""
    g = torch.Generator().manual_seed(seed)
    S = mcfg.mc_total_size
    spy = _Spy()
    _frozen(kind, inp, mcfg, torch.zeros((S, 8), dtype=torch.int32), grids=spy)
    f = torch.empty((S, 5))
    f[:, 0:3] = 40.0 * torch.randn(S, 3, generator=g)
    f[:, 3] = torch.rand(S, generator=g) * 8.0
    f[:, 0:3] *= f[:, 3:4]  # w_tgt is a weighted target
    f[:, 3] = torch.where(torch.rand(S, generator=g) < 0.2, -1.0, f[:, 3])
    f[:, 4] = f[:, 3] * torch.rand(S, generator=g)
    i = torch.stack([torch.randint(-(1 << 31), 1 << 31, (S,), generator=g),
                     torch.randint(0, 1025, (S,), generator=g),
                     torch.randint(0, 1 << 16, (S,), generator=g)], -1).to(torch.int32)
    for rows, hashes in zip(spy.rows, spy.hashes):
        h = hashes[0] if len(hashes) == 1 else torch.where(
            torch.rand(N, generator=g) < 0.5, hashes[0], hashes[1])
        hit = torch.rand(N, generator=g) < 0.7
        i[rows[hit], 2] = h[hit].to(torch.int32)
    return torch.cat([f.view(torch.int32), i], 1)


CASES = [(kind, p, bits) for kind in ("surface", "volume") for p in (0.7, 0.6) for bits in (0, 2)]


@pytest.mark.parametrize("kind,p,bits", CASES,
                         ids=[f"{k}-kp{5 * p:.1f}-tile{b}" for k, p, b in CASES])
def test_draws_equal_frozen_loop(kind, p, bits):
    mcfg = MCPGConfig(mc_adaptive_size=ADAPTIVE, mc_static_size=STATIC,
                      mc_samples_adaptive_prob=p, grid_tile_bits=bits)
    seed = 7 + CASES.index((kind, p, bits))
    inp = _inputs(kind, seed)
    table = _table(kind, inp, mcfg, seed)
    spy = _Spy()
    want = _frozen(kind, inp, mcfg, table, grids=spy)
    got = _ours(kind, inp, mcfg, table)
    names = ("rng", "win", "win_buf", "score_sum", "mu", "kappa", "sum_w", "N")
    for name, a, b in zip(names, got, want):
        for j, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
            assert x.dtype == y.dtype and torch.equal(x, y), f"{name} leaf {j} differs"

    # the cases the table was laid out to meet
    rows = torch.stack(spy.rows)  # the row each draw gathered
    sw_row = table[rows, 3].view(torch.float32)
    taken = torch.stack(got.sum_w)
    assert (taken > 0).float().mean() > 0.2  # hash matches
    assert (taken == 0).float().mean() > 0.2  # misses, tombstones, rejections
    assert (sw_row < 0).any()  # tombstoned rows gathered
    if kind == "surface":
        assert inp["dead"].any()
        # static draws of a matching, live row the hemisphere test rejected
        static = slice(math.ceil(mcfg.mc_samples * p), None)
        hemi = (taken[static] == 0) & (sw_row[static] > 0) & ~inp["dead"]
        assert hemi.sum() > 10
    assert (got.win_buf >= 0).any() and (got.win_buf == -1).any()


def _court():
    bundle = outdoor_court(0.002, device="cpu")
    cfg = RenderConfig(width=48, height=32, spp=2, max_path_length=3, integrator="mcpg")
    cfg = cfg._replace(features=scene_features(bundle.scene, bundle.uniforms, bundle.atlas))
    return bundle, build_accel(bundle.scene, bundle.atlas, device="cpu"), cfg


@pytest.fixture(scope="module")
def court():
    """A fogged court after 3 frames (chains and distance states learned),
    the 4th frame's uniforms and gbuffer."""
    bundle, accel, cfg = _court()
    mcfg = MCPGConfig(mc_adaptive_size=ADAPTIVE, mc_static_size=STATIC,
                      volume=VolumeConfig(volume_spp=2, dist_guide_p=0.9,
                                          volume_use_light_cache=True))
    state = init_state(cfg, mcfg, device="cpu")
    for i in range(3):
        state, _ = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=i), cfg,
                                state, mcpg_config=mcfg)
    u = bundle.uniforms._replace(frame=3)
    return accel, bundle.atlas, u, cfg, mcfg, state, render_gbuffer(accel, bundle.atlas, u, cfg)


def _equal_leaves(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for j, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), f"leaf {j} differs"


@pytest.mark.parametrize("budget", [(), (0.5,)], ids=["full", "compacted"])
def test_surface_pass_equals_frozen_copy(court, budget, monkeypatch):
    accel, atlas, u, cfg, mcfg, state, gbuf = court
    mcfg = mcfg._replace(surf_live_budget=budget)
    monkeypatch.setattr(r_surface, "trace_ray", trace_ray)  # the port's oracle trace on both
    for mod in (t_surface, r_surface):
        monkeypatch.setattr(mod, "COMPACT_MIN_NS", 64)
    assert (state.mcpg.mc.f[:, 3] > 0).sum() > 50
    ours = t_surface.render_mcpg_surface(accel, atlas, u, cfg, mcfg, state.mcpg, gbuf)
    ref = r_surface.render_mcpg_surface(accel, atlas, u, cfg, mcfg, state.mcpg, gbuf)
    _equal_leaves(ours, ref)
    if budget:  # a segment ran on the live prefix of its 2,048-lane budget
        assert t_surface._seg_budgets(mcfg, 2, 2 * 48 * 32) == [2048, 2048]
        assert (ours.live_in <= 2048).any()


def test_volume_pass_equals_frozen_copy(court, monkeypatch):
    accel, atlas, u, cfg, mcfg, state, gbuf = court
    monkeypatch.setattr(r_volume, "trace_ray", trace_ray)
    args = (accel, atlas, u, cfg, mcfg, mcfg.volume, state.mcpg, state.volume, gbuf)
    _equal_leaves(t_volume.render_volume(*args), r_volume.render_volume(*args))


def _valid(kind="surface"):
    mcfg = MCPGConfig(mc_adaptive_size=ADAPTIVE, mc_static_size=STATIC)
    inp = _inputs(kind, 3)
    return inp, mcfg, torch.zeros((mcfg.mc_total_size, 8), dtype=torch.int32)


def test_cpu_path_never_reaches_the_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the kernel library")

    monkeypatch.setattr(kernels, "load_library", refuse)
    monkeypatch.setattr(kernels, "build_libraries", refuse)
    before = draw.draw_states.launches
    for kind in ("surface", "volume"):
        inp, mcfg, table = _valid(kind)
        _ours(kind, inp, mcfg, table)
    assert draw.draw_states.launches == before


def _bad(case):
    inp, mcfg, table = _valid()
    a = dict(rng_state=inp["rng"], lookup_pos=inp["lookup"], pos=inp["pos"],
             normal=inp["normal"], cam_x=inp["cam_x"], cl_time=inp["cl_time"], table=table,
             mcfg=mcfg, dead=inp["dead"], hemisphere=True)
    if case == "rng int32":
        a["rng_state"] = a["rng_state"].int()
    elif case == "rng strided":
        a["rng_state"] = torch.zeros(2 * N, dtype=torch.int64)[::2]
    elif case == "pos float64":
        a["pos"] = a["pos"].double()
    elif case == "normal 4 columns":
        a["normal"] = torch.zeros((N, 4))
    elif case == "lookup one lane short":
        a["lookup_pos"] = a["lookup_pos"][1:]
    elif case == "pos columns not adjacent":
        a["pos"] = a["pos"].t().contiguous().t()
    elif case == "normal a column slice":
        a["normal"] = torch.zeros((N, 4))[:, :3]
    elif case == "dead uint8":
        a["dead"] = a["dead"].to(torch.uint8)
    elif case == "cam_x 4 floats":
        a["cam_x"] = torch.zeros(4)
    elif case == "cl_time 1-d":
        a["cl_time"] = a["cl_time"].reshape(1)
    elif case == "table 9 columns":
        a["table"] = torch.zeros((mcfg.mc_total_size, 9), dtype=torch.int32)
    elif case == "table not contiguous":
        a["table"] = torch.zeros((mcfg.mc_total_size, 16), dtype=torch.int32)[:, :8]
    elif case == "table float32":
        a["table"] = table.view(torch.float32)
    elif case == "table on another device":
        a["table"] = table.to("meta")
    elif case == "17 draws":
        a["mcfg"] = mcfg._replace(mc_samples=draw.MAX_DRAWS + 1)
    return lambda: draw.draw_states(**a)


BAD = ["rng int32", "rng strided", "pos float64", "normal 4 columns", "lookup one lane short",
       "pos columns not adjacent", "normal a column slice", "dead uint8", "cam_x 4 floats", "cl_time 1-d",
       "table 9 columns", "table not contiguous", "table float32", "table on another device",
       "17 draws"]


@pytest.mark.parametrize("case", BAD)
def test_draw_states_refuses(case):
    with pytest.raises(ValueError):
        _bad(case)()


def test_max_draws_matches_the_source():
    src = open(os.path.join(kernels.CSRC_DIR, "mcpg_draw.cu")).read()
    assert f"constexpr int kMaxDraws = {draw.MAX_DRAWS};" in src


@pytest.mark.cuda
def test_draw_kernel_matches_torch_loop_on_card():
    """The kernel against the torch loop on the card, bit for bit on every
    output: the 1080p × 2 spp surface population and the 1080p volume
    population on the production-size table, a 37x53 input (chip_smoke.py
    phase 42 makes these comparisons, and holds a captured live dungeon
    mcpg_default frame against eager frames on the torch loop)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import chip_smoke

    worst = chip_smoke.draw_random(torch.device("cuda"), "")
    assert not {k: v for k, v in worst.items() if v[0]}
