"""Row-slab MCPG frames (parallel/render.py), port against both packages'
single-device frames: the guided surface, a width that tiles, and a
gather mutant (the volume pass: tests/test_torch_parallel_volume.py).

Four gloo ranks on the CPU, spawned once for the file
(tests/torch_parallel_cases.py); every rank gathers every slab's
compacted update queues and replays them into its replica of the guiding
state. Tolerances are tests/test_parallel.py's own (ldr 3e-5, ``mc``
sum_w and ``lc.irr`` 1e-5), held against the port's single-device frame
and against the JAX package's; the guiding state's replicas must be
bit-equal on every rank.

- MCPG (48×16, 4-row slabs, 2 frames): against the port's frame every
  compared array is equal; against the JAX package's jitted frame ldr is
  equal, sum_w within 2.9e-6, lc.irr equal.
- The tiled width (256×32, 8-row slabs laid out tile-major like the
  whole image, 2 frames): equal to the port's frame; against the JAX
  package's, sum_w is off by up to 1.6e-5 on a sum of 14.5, as the JAX
  package's jitted and op-by-op runs are off from each other, so sum_w
  is held within 1e-5 + 1e-5 relative there (read: 2.4e-6 relative).
- Mutant: each rank replays only its own slab's queue rows. The images
  of these two frames do not move, but the replicas part (rank 0's
  chain states off by up to 5e3, lc.irr by 0.31), so the bound fails.
"""
import pytest
import torch

import torch_parallel_cases as C

torch.set_num_threads(min(2, torch.get_num_threads()))

NAMES = ("mcpg", "mcpg_local_gather", "mcpg_tiled")


@pytest.fixture(scope="module")
def runs():
    return C.sharded_runs(NAMES)


@pytest.fixture(scope="module")
def mcpg_refs():
    return C.port_single("mcpg"), C.jax_single("mcpg")


def test_mcpg_matches_single_device(runs, mcpg_refs):
    parts = runs["mcpg"]
    C.assert_replicas(parts, C.MCPG_REPLICAS)
    assert (parts[0]["mc_f"][:, 3] > 0).sum() > 0
    for ref in mcpg_refs:
        C.mcpg_bound(parts, ref)


def test_mcpg_local_gather_mutant_fails(runs, mcpg_refs):
    parts = runs["mcpg_local_gather"]
    with pytest.raises(AssertionError):
        C.assert_replicas(parts, C.MCPG_REPLICAS)
    with pytest.raises(AssertionError):
        C.mcpg_bound(parts, mcpg_refs[0])


def test_mcpg_tiled_width_matches_single_device(runs):
    from merian_quake_tpu_torch.render import layout

    assert layout.is_tiled(256, 32 // C.RANKS) and layout.is_tiled(256, 32)
    parts = runs["mcpg_tiled"]
    C.assert_replicas(parts, C.MCPG_REPLICAS)
    C.mcpg_bound(parts, C.port_single("mcpg_tiled"))
    C.mcpg_bound(parts, C.jax_single("mcpg_tiled"), rtol=1e-5)
