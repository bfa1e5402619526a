"""The port's SSMM (render/ssmm/ssmm.py) against the benchmark's plain
reference (quakebench/reference/render/ssmm), on the CPU, with the
yardstick the card's runs are judged by: ``quakebench.check.leaf_error``
under ``check.LIMITS``.

Both sides are set up as the benchmark sets them up
(``quakebench.scenes.ProgramCell`` / ``ReferenceCell``): the ssmm_ad
configuration (1 spp, the denoise chain) at 256×16, where the image tiles
(two 8×128 tiles side by side), so that the roll runs over the tile-major
buffer order and not the image's, on ``cornell_box``. The SSMM states are
drawn from a seed: 60% of the chains carry a weight, N in [0, 1024], f > 0
everywhere, targets inside the box.

- One ``render_ssmm`` pass at 1 and 2 spp on the same gbuffer: every
  image and state leaf within its limit.
- 3 denoised frames of the compiled frame from a drawn state against the
  reference's frames from the adopted state: each frame's gbuffer, image
  and state leaves within their limits.
- Two mutants of the port's pass fail the same comparison: the score gate
  of the exchange dropped (every candidate scored by its f alone), and
  ``mc_state_add`` without its ``ml_min_alpha`` floor.
- The tracer: a frame recorded equals one not recorded, bit for bit; the
  six stage spans sit under ``ssmm``; the counters equal a direct
  computation on the same frame (the live pixels from its gbuffer, the
  valid chains and the guided lanes by a recomputation of the exchange
  and the lobe choice from the reference's helpers).
"""
import pytest
import torch

from merian_quake_tpu_torch.capture import tree_leaves
from merian_quake_tpu_torch.render.gbuffer import render_gbuffer
from merian_quake_tpu_torch.render.ssmm import ssmm as t_ssmm
from merian_quake_tpu_torch.renderer import render_frame
from merian_quake_tpu_torch.utils import profiler
from quakebench import check, scenes, spec
from quakebench.reference.ops import rng as r_rng
from quakebench.reference.render import layout as r_layout
from quakebench.reference.render.gbuffer import render_gbuffer as r_render_gbuffer
from quakebench.reference.render.hit import decompress_hit as r_decompress_hit
from quakebench.reference.render.ssmm import ssmm as r_ssmm

torch.set_num_threads(min(2, torch.get_num_threads()))

W, H = 256, 16
MIX = {"scene": {"make": "models.procedural.cornell_box", "args": {}}, "driver": "still",
       "features": {}, "fog": None, "settle_frames": 0}
SEED = 2200000017
STAGES = ("ssmm.inputs", "ssmm.exchange", "ssmm.sample", "ssmm.trace", "ssmm.chain", "ssmm.smis")


def _cfg(spp):
    return scenes.merge(spec.config("ssmm_ad"), {"render": {"width": W, "height": H, "spp": spp}})


class Cell:
    """The program and the reference of one configuration."""

    def __init__(self, spp):
        cfg = _cfg(spp)
        self.pc = scenes.ProgramCell(cfg, MIX, SEED, "cpu", scenes.Spans(False))
        b = self.pc.bundle
        self.ref = scenes.ReferenceCell(cfg, MIX, SEED, scenes.host_scene(b.scene),
                                        self.pc.textures, b.uniforms, "cpu")


@pytest.fixture(scope="module", params=[1, 2], ids=["spp1", "spp2"])
def cell(request):
    return Cell(request.param)


@pytest.fixture(scope="module")
def cell1():
    return Cell(1)


def drawn_state(n, seed):
    """SSMM chains drawn from ``seed``: 60% carry a weight (targets inside
    the box, mean cosines in [0, 1)), N in [0, 1024], f > 0."""
    g = torch.Generator().manual_seed(seed)
    weighted = torch.rand(n, generator=g) < 0.6
    sum_w = torch.where(weighted, 0.01 + 4.0 * torch.rand(n, generator=g), 0.0)
    target = torch.rand((n, 3), generator=g) * torch.tensor([512.0, 512.0, 256.0])
    mean_cos = torch.rand(n, generator=g)
    return t_ssmm.SSMMState(
        sum_tgt=target * sum_w[:, None], sum_w=sum_w,
        N=torch.randint(0, 1025, (n,), generator=g, dtype=torch.int32),
        sum_len=sum_w * mean_cos, f=1e-3 + 2.0 * torch.rand(n, generator=g),
    )


def _errors(prog, ref) -> dict:
    """{leaf path: error} of the reference's leaves."""
    p, r = check.leaves(prog), check.leaves(ref)
    return {k: check.leaf_error(p[k], v) for k, v in r.items()}


def _over(errors: dict, limit: float) -> dict:
    return {k: e for k, e in errors.items() if e > limit}


def _pass(c: Cell, state_seed: int):
    """One pass of each side on the program's gbuffer of frame 1 from a
    drawn state: ((image, state) of the program, of the reference)."""
    pc, ref = c.pc, c.ref
    u = pc.inputs(1)
    gbuf = render_gbuffer(pc.world.accel, pc.bundle.atlas, u, pc.config)
    st = drawn_state(W * H, state_seed)
    prog = t_ssmm.render_ssmm(pc.world.accel, pc.bundle.atlas, u, pc.config, pc.icfg, st, gbuf)
    r_u = ref.uniforms(u)
    r_gbuf = r_render_gbuffer(ref.accel, ref.atlas, r_u, ref.config)
    assert not _over(_errors(gbuf, r_gbuf), check.LIMITS["gbuffer"])
    r_st = scenes.adopt(r_ssmm.init_ssmm_state(W, H, device="cpu"), st)
    refo = r_ssmm.render_ssmm(ref.accel, ref.atlas, r_u, ref.config, ref.icfg, r_st,
                              scenes.adopt(r_gbuf, gbuf))
    return prog, refo


def test_render_ssmm_pass_matches_the_reference(cell):
    (p_img, p_st), (r_img, r_st) = _pass(cell, 11)
    assert not _over(_errors(p_img, r_img), check.LIMITS["image"])
    assert not _over(_errors(p_st, r_st), check.LIMITS["state"])
    # the pass did work: chains were taken from the drawn states and the
    # image is not black
    assert float(p_img[..., :3].abs().sum()) > 0.0
    assert int((p_st.N > 0).sum()) > W * H // 4


def _frames(c: Cell, state_seed: int, frames=3) -> list:
    """``frames`` denoised frames of the program's compiled frame from a
    drawn state and of the reference from the adopted one: each frame's
    {number: worst error}."""
    pc, ref = c.pc, c.ref
    start = pc.cf.state._replace(ssmm=drawn_state(W * H, state_seed))
    pc.cf.set_state(scenes.clone(start))
    r_state = scenes.adopt(ref.init_state(), start)
    out = []
    for i in range(1, frames + 1):
        state, outputs = pc.frame(i)
        r_state, r_out = ref.frame(r_state, ref.uniforms(pc.inputs(i)))
        out.append({
            "gbuffer": check.worst(outputs["gbuffer"], r_out["gbuffer"])[0],
            "image": check.worst({k: v for k, v in outputs.items() if k != "gbuffer"},
                                 {k: v for k, v in r_out.items() if k != "gbuffer"})[0],
            "state": check.worst(state, r_state)[0],
        })
    return out


def test_denoised_frames_match_the_reference(cell1):
    for numbers in _frames(cell1, 23):
        assert check.judge(numbers), numbers


def _no_score_gate(s, x, nx, normal_img, z_img, cam_x, idx):
    return s.f


def _no_min_alpha(add):
    return lambda s, x, w, d, y, cfg: add(s, x, w, d, y, cfg._replace(ml_min_alpha=0.0))


@pytest.mark.parametrize("mutant", ["score_gate_dropped", "no_min_alpha"])
def test_mutant_fails_the_comparison(cell1, monkeypatch, mutant):
    if mutant == "score_gate_dropped":
        monkeypatch.setattr(t_ssmm, "_state_score", _no_score_gate)
    else:
        monkeypatch.setattr(t_ssmm, "_state_add", _no_min_alpha(t_ssmm._state_add))
    (p_img, p_st), (r_img, r_st) = _pass(cell1, 11)
    bad = {**_over(_errors(p_img, r_img), check.LIMITS["image"]),
           **_over(_errors(p_st, r_st), check.LIMITS["state"])}
    assert bad, mutant


def _direct_counts(gbuf, sstate, u, config, scfg) -> dict:
    """The frame's counters at 1 spp, recomputed from the reference's
    helpers: the live pixels, the live pixels whose chain carries a weight
    after the exchange, and the live lanes whose lobe choice is the vMF."""
    n = W * H
    pxf, pyf = r_layout.gen_pixels(W, H, device="cpu")
    rng = r_rng.seed_pixel(pxf, pyf, u.frame, config.seed)
    surf = r_decompress_hit(gbuf.hits)
    live = (surf.albedo >= 1e-7).any(-1)
    normal_img = r_layout.image_to_flat(gbuf.normal, W, H)
    z_img = r_layout.image_to_flat(gbuf.linear_z, W, H)
    mv = r_layout.image_to_flat(gbuf.mv, W, H)
    bxi = r_ssmm._to_int(pxf.to(torch.float32) + mv[:, 0])
    byi = r_ssmm._to_int(pyf.to(torch.float32) + mv[:, 1])
    tent = r_ssmm._state_new(n, "cpu")
    score = lambda s, idx: r_ssmm._state_score(s, surf.pos, surf.normal, normal_img, z_img,
                                               u.cam_x, idx)
    score_sum = score(tent, r_layout.index_of(bxi.clamp(0, W - 1), byi.clamp(0, H - 1), W, H))
    for _ in range(scfg.smis_group_size):
        rng, a = r_rng.uniform4(rng)
        rng, b = r_rng.uniform4(rng)
        rng, c = r_rng.uniform4(rng)
        t = a[:, 0:2] + a[:, 2:4] + b[:, 0:2] + b[:, 2:4] + c[:, 0:2] + c[:, 2:4]
        off = torch.floor(15.0 * (t - 3.0)).to(torch.int64)
        rng, u_rep = r_rng.uniform(rng)
        idx = r_layout.index_of((bxi + off[:, 0]).clamp(0, W - 1),
                                (byi + off[:, 1]).clamp(0, H - 1), W, H)
        cand = r_ssmm.SSMMState(*[x[idx] for x in sstate])
        other = score(cand, idx)
        tent = r_ssmm._sel((score_sum <= 0.0) | (u_rep < other / (other + score_sum)), cand, tent)
        score_sum = score_sum + other
    valid = tent.sum_w > 0.0
    kappa = torch.where(valid, r_ssmm._state_vmf(tent, surf.pos, scfg)[1], 0.0)
    rng, u_b = r_rng.uniform(rng)
    vmf_lane = ~((kappa == 0.0) | (u_b < scfg.surf_bsdf_p))
    return {"ssmm.pixels_live": int(live.sum()), "ssmm.chains_valid": int((live & valid).sum()),
            "ssmm.guided": int((live & vmf_lane).sum())}


def test_spans_and_counters(cell1):
    pc, ref = cell1.pc, cell1.ref
    start = pc.cf.state._replace(ssmm=drawn_state(W * H, 31))
    u = pc.inputs(2)
    frame = lambda: render_frame(pc.world.accel, pc.bundle.atlas, u, pc.config,
                                 scenes.clone(start), pc.icfg)
    plain = frame()
    tracer = profiler.Profiler(enabled=True)
    prev = profiler.install(tracer)
    try:
        traced = frame()
    finally:
        profiler.install(prev)
    a, b = tree_leaves(plain), tree_leaves(traced)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    s = tracer.summary()
    assert s["frames"] == 1
    assert s["spans"]["ssmm"]["parent"] is None
    for name in STAGES:
        assert s["spans"][name]["parent"] == "ssmm" and s["spans"][name]["count"] == 1, name
    assert set(k for k, v in s["spans"].items() if v["parent"] == "ssmm") == set(STAGES)
    state, outputs = traced
    r_gbuf = scenes.adopt(r_render_gbuffer(ref.accel, ref.atlas, ref.uniforms(u), ref.config),
                          outputs["gbuffer"])
    r_start = scenes.adopt(r_ssmm.init_ssmm_state(W, H, device="cpu"), start.ssmm)
    want = _direct_counts(r_gbuf, r_start, ref.uniforms(u), ref.config, ref.icfg)
    assert {k: v for k, v in s["counters"].items() if k.startswith("ssmm.")} == want
    assert 0 < want["ssmm.guided"] < want["ssmm.chains_valid"] < want["ssmm.pixels_live"]
