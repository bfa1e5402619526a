"""K4 (target keys), K5 (block union entries) and the fused visit list of
csrc/woop_keys.cu: a torch model of the kernels' schedule
(tests/torch_keys_model.py) against their plain versions, bit for bit.

- The two facts the design rests on: a slab with its planes ordered per
  box and chosen once per ray gives the JAX slab's entry bits (inverted
  and empty boxes, +-0 directions, NaN origins, infinite and negative
  limits); a node box made of its members' ordered planes (as K4 makes
  it) is entered no later than any reached member, empty and NaN members
  included, while a node box of the raw bounds (woop.node_bounds) is not
  where a member is empty.
- The model (ordered planes, warp-uniform node skip, warp-uniform
  insertion, dead-warp skip; K5's live rays by octant
  with the planes each octant chooses; the bitonic (te, id) sort) equals woop.target_keys_reference,
  woop.te_union_reference and the stable row sort on city(1600) rays,
  the random soup and the edge-case boxes, at 1, 3, 32, 252 and 1,024
  boxes; the plain versions on the edge cases equal the JAX kernels in
  interpret mode.
- Mutants of the schedule fail: the node skip over raw-bound node boxes
  with no never-skip flag, unordered planes, the sort without the id, a
  <= insertion; a <=
  in the node skip gives the same keys (it visits a superset) and fails
  the schedule's slab count.

The CUDA kernels cannot run here; the ``cuda``-marked test and
chip_smoke phase 12 hold them against their plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_keys_model as model
from chip_smoke.fixtures import edge_boxes, edge_rays
from merian_quake_tpu.accel import woop as j_woop
from merian_quake_tpu_torch.accel import build_accel, woop
from merian_quake_tpu_torch.models.procedural import city
from merian_quake_tpu_torch.models.types import build_scene_from_soup
from test_torch_schedule import CITY, _bounce, _city_primary, _rays, _soup

# The suite runs several test processes side by side on a few cores;
# torch would start one thread per core in each and oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))


def _pack(o, d, t_max):
    n = o.shape[0]
    return woop._pack_rays(torch.as_tensor(o), torch.as_tensor(d), torch.zeros(n),
                           torch.as_tensor(t_max), woop.RAY_BLOCK)


@pytest.fixture(scope="module")
def city_1600():
    bundle = city(**CITY, device="cpu")
    return bundle, build_accel(bundle.scene, bundle.atlas)


def _population(name, rng, city_1600, few_empty=False):
    """(rays, cluster lo/hi as the accel has them, padded lo/hi)."""
    if name == "edge":
        lo, hi = edge_boxes(rng, 100, few_empty)
        return edge_rays(rng), lo, hi, lo, hi
    if name == "soup":
        v0, v1, v2 = _soup(rng, 64 * 30)
        acc = build_accel(build_scene_from_soup(v0, v1, v2, device="cpu"))
        o, d = _rays(rng, 512, misses=True)
        t_max = np.where(rng.random(512) < 0.2, -1.0, 1e4).astype(np.float32)
        rays = _pack(o, d, t_max)
    else:
        bundle, acc = city_1600
        if name == "city_primary":
            o, d = _city_primary(bundle, 32, 16)
            rays = _pack(o, d, torch.full((512,), 1e4))
        else:  # the first bounce, in pixel order or sorted by the target key
            o, d, t_max, _ = _bounce(bundle, acc, 32, 16)
            if name == "city_bounce_target":
                perm = torch.sort(woop.target_sort_key(acc, o, d, t_max), stable=True).indices
                o, d, t_max = o[perm], d[perm], t_max[perm]
            rays = _pack(o, d, t_max)
    return rays, acc.cluster_lo, acc.cluster_hi, *woop.padded_bounds(acc.cluster_lo,
                                                                     acc.cluster_hi)


POPULATIONS = ["city_primary", "city_bounce", "city_bounce_target", "soup", "edge"]


def _bits(x):
    return x.contiguous().view(torch.int32)


# ------------------------------------------------------------------ the two facts


def test_chosen_planes_give_the_jax_slab_bits(rng):
    """Fact 1 on 64,000 pairs: ordered planes, near and far chosen by the
    sign of the safe inverse, give te bit for bit as the 12-min/max slab."""
    lo, hi = edge_boxes(rng, 100)
    rays = edge_rays(rng)
    o, inv, t_max = model.ray_args(rays)
    reach, tn = model.entries(o, inv, t_max, lo, hi)
    te = torch.where(reach, tn + 0.0, torch.inf)
    ref = woop._slab_entry(o[:, None], inv[:, None], t_max[:, None], lo, hi)[1]
    assert torch.equal(_bits(te), _bits(ref))
    assert torch.isfinite(ref).sum() > 1000 and (ref == 0.0).sum() > 100
    # the unordered mutant changes entries on the inverted boxes
    reach_u, tn_u = model.entries(o, inv, t_max, lo, hi, mutant="unordered")
    assert not torch.equal(_bits(torch.where(reach_u, tn_u + 0.0, torch.inf)), _bits(ref))


def test_node_box_is_entered_no_later_than_its_members(rng):
    """Fact 2: a node box of the raw bounds (woop.node_bounds, the members'
    min/max) is entered no later than any member where every member is a
    box, and an empty member breaks it; K4's node box, the min/max of its
    members' ordered planes with NaN planes left out, holds it for every
    member, empty and NaN ones included, so every node may be skipped."""
    rays = edge_rays(rng)
    o, inv, t_max = model.ray_args(rays)
    cases = []
    for boxes in ("proper", "edge"):
        lo, hi = edge_boxes(rng, 101)  # a partial last node
        if boxes == "proper":
            lo, hi = model.ordered(lo.nan_to_num(0.0), hi)
            keep = (lo < 1e29).all(-1)
            lo, hi = lo[keep][:85], hi[keep][:85]
        cases += [(lo, hi, woop.node_bounds(lo, hi, model.KEY_NODE), boxes == "edge"),
                  (lo, hi, model.node_planes(lo, hi, model.KEY_NODE), False)]
    for lo, hi, (nlo, nhi), expect_violations in cases:
        te = woop._slab_entry(o[:, None], inv[:, None], t_max[:, None], lo, hi)[1]
        te_n = woop._slab_entry(o[:, None], inv[:, None], t_max[:, None], nlo, nhi)[1]
        member_of = torch.arange(lo.shape[0]) // model.KEY_NODE
        violations = int((te < te_n[:, member_of]).sum())
        assert (violations > 0) == expect_violations, violations
        assert torch.isfinite(te).sum() > 1000


# ------------------------------------------------------------------ the model vs the plain versions


@pytest.mark.parametrize("name", POPULATIONS)
def test_target_keys_model_matches_plain(rng, city_1600, name):
    rays, lo, hi, _, _ = _population(name, rng, city_1600, few_empty=True)
    ref = woop.target_keys_reference(rays, lo, hi)
    keys, counts = model.target_keys(rays, lo, hi)
    assert torch.equal(keys, ref)
    # the camera lies inside three clusters, so every primary ray keys them
    assert len(torch.unique(ref)) > (0 if name == "city_primary" else 10)
    assert (ref != model.SENTINEL).any()
    nw = rays.shape[1] // model.WARP
    assert 0 < counts["slabs"] <= model.WARP * nw * lo.shape[0]
    if name.startswith("city"):  # the node level skips members there
        assert counts["slabs"] < model.WARP * nw * lo.shape[0]


@pytest.mark.parametrize("nc", [1, 3, 32, 252, 256])
def test_target_keys_model_box_counts(rng, nc):
    """Random and edge-case boxes at every size K4 takes; box 255 is the
    sentinel's id."""
    lo, hi = edge_boxes(rng, nc, few_empty=True)
    rays = edge_rays(rng)
    assert torch.equal(model.target_keys(rays, lo, hi)[0], woop.target_keys_reference(rays, lo, hi))


@pytest.mark.parametrize("name", POPULATIONS)
def test_te_union_model_matches_plain(rng, city_1600, name):
    """Both modes on the cluster boxes (the accel's in the JAX mode, the
    padded ones in the walker's) and on node boxes of 8."""
    rays, lo, hi, plo, phi = _population(name, rng, city_1600)
    cases = [(lo, hi, False), (plo, phi, True),
             (*woop.node_bounds(lo, hi, 8), False), (*woop.node_bounds(plo, phi, 8), True)]
    for blo, bhi, slack in cases:
        ref = woop.te_union_reference(rays, blo, bhi, slack)
        assert torch.equal(_bits(model.te_union(rays, blo, bhi, slack)), _bits(ref))
        assert torch.isfinite(ref).any()


@pytest.mark.parametrize("m", [1, 3, 32, 252, 1024])
def test_visit_list_model_matches_stable_sort(rng, m):
    """The fused list against the stable row sort, at every list width up
    to the largest a resident table gives; the edge boxes leave many equal
    entries (+inf, 0) whose ids must stay in order."""
    lo, hi = edge_boxes(rng, m)
    rays = edge_rays(rng)
    te_s, order = model.visit_list(rays, lo, hi)
    ref_s, ref_o = woop.visit_list_reference(rays, lo, hi)
    assert torch.equal(_bits(te_s), _bits(ref_s)) and torch.equal(order, ref_o)
    assert torch.equal(ref_o, torch.sort(woop.te_union_reference(rays, lo, hi, True), dim=1,
                                         stable=True).indices.int())


@pytest.mark.parametrize("name", ["city_bounce_target", "soup"])
def test_visit_list_model_on_scenes(rng, city_1600, name):
    rays, _, _, plo, phi = _population(name, rng, city_1600)
    for blo, bhi in ((plo, phi), woop.node_bounds(plo, phi, 8)):
        te_s, order = model.visit_list(rays, blo, bhi)
        ref_s, ref_o = woop.visit_list_reference(rays, blo, bhi)
        assert torch.equal(_bits(te_s), _bits(ref_s)) and torch.equal(order, ref_o)


def test_plain_versions_match_jax_on_edge_cases(rng):
    """The plain versions on the edge-case boxes and rays against the JAX
    kernels in interpret mode (K4 at 40 boxes, K5 in the JAX mode)."""
    lo, hi = edge_boxes(rng, 40)
    rays = edge_rays(rng)
    j_rays = jnp.asarray(rays.numpy())
    ref = np.asarray(j_woop._target_keys(j_rays, jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()),
                                         woop.RAY_BLOCK, interpret=True))
    np.testing.assert_array_equal(woop.target_keys_reference(rays, lo, hi).numpy(), ref)
    ref = np.asarray(j_woop._te_union(j_rays, jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()),
                                      woop.RAY_BLOCK, interpret=True))
    np.testing.assert_array_equal(
        woop.te_union_reference(rays, lo, hi).numpy().view(np.int32), ref.view(np.int32))


# ------------------------------------------------------------------ the schedule


def test_node_skip_is_tight():
    """One warp along +x from the origin: node 0 holds three boxes entered
    at 1 (the third nearest is then 1), node 1 eight boxes entered at 1.
    Node 1's entry equals every lane's third, so the strict rule skips its
    members (the insertion would take none of them); a dead warp computes
    no slab at all."""
    lo = torch.tensor([[1.0, -1.0, -1.0]]).repeat(16, 1)
    hi = torch.tensor([[2.0, 1.0, 1.0]]).repeat(16, 1)
    lo[3:8, 1], hi[3:8, 1] = 50.0, 60.0  # unreached
    hi[8:, 0] = 3.0
    o = torch.zeros((64, 3))
    d = torch.tensor([[1.0, 0.0, 0.0]]).repeat(64, 1)
    t_max = torch.cat([torch.full((32,), 1e4), torch.full((32,), -1.0)])
    rays = _pack(o, d, t_max)
    keys, counts = model.target_keys(rays, lo, hi)
    assert torch.equal(keys, woop.target_keys_reference(rays, lo, hi))
    assert int(keys[0]) == (0 << 22) | (1 << 14) | (2 << 6)
    assert counts == {"slabs": 32 * 8, "node_slabs": 32 * 2, "inserts": 3}
    keys_le, counts_le = model.target_keys(rays, lo, hi, mutant="skip_le")
    assert torch.equal(keys_le, keys)  # a superset of visits: the same keys
    assert counts_le["slabs"] == 32 * 16  # the slab count catches it


MUTANTS = {
    "raw_node_boxes": ("target_keys", "edge"),
    "insert_le": ("target_keys", "edge"),
    "unordered": ("target_keys", "edge"),
    "unordered_union": ("te_union", "edge"),
    "sort_no_id": ("visit_list", "edge"),
}


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_mutants_fail(rng, city_1600, mutant):
    what, name = MUTANTS[mutant]
    rays, lo, hi, plo, phi = _population(name, rng, city_1600, few_empty=what == "target_keys")
    if what == "target_keys":
        assert not torch.equal(model.target_keys(rays, lo, hi, mutant=mutant)[0],
                               woop.target_keys_reference(rays, lo, hi))
    elif what == "te_union":
        assert not torch.equal(_bits(model.te_union(rays, lo, hi, mutant="unordered")),
                               _bits(woop.te_union_reference(rays, lo, hi)))
    else:
        te_s, order = model.visit_list(rays, plo, phi, mutant=mutant)
        ref_s, ref_o = woop.visit_list_reference(rays, plo, phi)
        assert torch.equal(te_s, ref_s) and not torch.equal(order, ref_o)


# ------------------------------------------------------------------ the wrappers


def test_list_width_limit_is_the_kernels():
    """The wrapper's limit is the kernel's, and every resident table fits."""
    assert woop.MAX_LIST_BOXES == model.MAX_LIST_BOXES
    assert woop.RESIDENT_MAX_TRIS // 64 == woop.MAX_LIST_BOXES


def test_key_and_list_wrappers_on_the_cpu(rng):
    """On CPU tensors the wrappers are the plain versions; they reject a
    list wider than the kernel's, counts on the CPU and bad shapes."""
    lo, hi = edge_boxes(rng, 40)
    rays = edge_rays(rng)
    assert torch.equal(woop.target_keys(rays, lo, hi), woop.target_keys_reference(rays, lo, hi))
    for a, b in zip(woop.visit_list(rays, lo, hi), woop.visit_list_reference(rays, lo, hi)):
        assert torch.equal(a, b)
    wide = torch.zeros((woop.MAX_LIST_BOXES + 1, 3))
    with pytest.raises(ValueError):
        woop.visit_list(rays, wide, wide)
    with pytest.raises(ValueError):
        woop.target_keys(rays, lo, hi, counts=torch.zeros((5, 3), dtype=torch.int64))
    with pytest.raises(ValueError):
        woop.visit_list(rays[:, :200], lo, hi)


@pytest.mark.cuda
def test_visit_list_kernel_matches_plain_on_card(rng):
    """The fused list on the card against its plain version, bit for bit
    (chip_smoke phase 12 makes this comparison on every population)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    lo, hi = (x.cuda() for x in edge_boxes(rng, 252))
    rays = edge_rays(rng).cuda()
    before = woop.visit_list.launches
    te_s, order = woop.visit_list(rays, lo, hi)
    assert woop.visit_list.launches == before + 1
    ref_s, ref_o = woop.visit_list_reference(rays, lo, hi)
    assert torch.equal(_bits(te_s), _bits(ref_s)) and torch.equal(order, ref_o)
    counts = torch.zeros((rays.shape[1] // woop.RAY_BLOCK, 3), dtype=torch.int64, device="cuda")
    assert torch.equal(woop.target_keys(rays, lo, hi, counts=counts),
                       woop.target_keys_reference(rays, lo, hi))
