"""Row-slab MCPG frames with the volume pass (parallel/render.py), port
against both packages' single-device frames.

Four gloo ranks on the CPU, spawned once for the file
(tests/torch_parallel_cases.py). Every rank gathers every slab's
compacted surface, volume and distance-grid queues and replays them into
its replicas of the guiding state and of the distance grid; the forward
projection of the volume's depth runs on the gathered image.
Tolerances are tests/test_parallel.py's own (ldr and accum_volume 3e-5,
``mc`` sum_w and ``lc.irr`` 1e-5, the distance grid's sum_w 1e-5, volume
depth 1e-3), held against the port's single-device frame and against the
JAX package's; the replicas must be bit-equal on every rank.

The fogged box (48×16, 4-row slabs, 2 frames): against the port's frame
ldr within 2.4e-7 (the exposure mean is an all-reduce), the rest equal.
The JAX package's jitted run spreads from its op-by-op run here (ldr
98.3% of pixels within 1e-3, the distance grid's sum_w 83%), and the port
follows the op-by-op run, the reference: ldr within 1.3e-5, the grid's
sum_w 9.5e-7, depth 3.1e-5, ``mc`` sum_w within 1e-5 + 1e-5 relative;
accum_volume (max 3.4e-4) by the port's image rule against the JAX
package, ≥ 99.5% of pixels within 1e-3 and mean |Δ| < 1e-4 (read: 100%,
3.7e-7).
"""
import numpy as np
import pytest
import torch

import torch_parallel_cases as C

torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.fixture(scope="module")
def runs():
    return C.sharded_runs(("mcpg_volume",))


def test_mcpg_volume_matches_single_device(runs):
    parts = runs["mcpg_volume"]
    C.assert_replicas(parts, C.MCPG_REPLICAS + ("dist_sum_w", "dist_n", "dist_moments"))
    assert float(C.stitch(parts, "accum_volume")[..., :3].max()) > 0.0
    port, jx = C.port_single("mcpg_volume"), C.jax_single("mcpg_volume", jit=False)
    for ref, rtol in ((port, 0.0), (jx, 1e-5)):
        C.mcpg_bound(parts, ref, rtol)
        np.testing.assert_allclose(parts[0]["dist_sum_w"], ref["dist_sum_w"], atol=1e-5)
        np.testing.assert_allclose(C.stitch(parts, "volume_depth"), ref["volume_depth"],
                                   atol=1e-3)
    np.testing.assert_allclose(C.stitch(parts, "accum_volume"), port["accum_volume"], atol=3e-5)
    C.assert_within(C.stitch(parts, "accum_volume"), jx["accum_volume"], 0.995, 1e-4)
