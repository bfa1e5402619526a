"""Row-slab ReSTIR (halo and gather routes) and SSMM frames
(parallel/render.py), port against both packages' single-device frames.

Four gloo ranks on the CPU, spawned once for the file
(tests/torch_parallel_cases.py). Tolerances are tests/test_parallel.py's
own (ldr 3e-5; reservoir weights within 1e-4 + 1e-4 relative on > 99% of
pixels; SSMM sum_w 1e-4), held against the port's single-device frame and
against the JAX package's.

- ReSTIR (48×64, 16-row slabs, spatial radius 4: a halo of 16 rows, 2
  frames), on the halo route and on the gather route (``force_gather``,
  the JAX package's ``FORCE_GATHER``): against the port's frame and the
  JAX package's jitted frame ldr is equal and the weights agree on
  every pixel (read, both routes); the two routes are equal.
- SSMM (48×32, 8-row slabs, 2 spp, 3 frames; the lane roll crosses the
  slab borders): against the port's frame ldr within 3.0e-7 (the
  exposure mean is an all-reduce) and sum_w equal. Its Metropolis decisions are an ulp's: the JAX package's jitted
  and op-by-op runs agree on 95.3% of ldr pixels within 1e-3 (hdr 94.4%,
  sum_w 91.0%), so against the JAX package the slabs are held as
  tests/test_torch_ssmm_slice.py holds the port: ldr and hdr against
  the jitted run, a share at least the JAX package's own spread less 2
  pixels and a mean |Δ| at most 1.25× its (read: ldr 95.2%, hdr 94.3%);
  sum_w, which the port follows the op-by-op run in, against that run:
  ≥ 99.5% of pixels within 1e-3 (read: 99.8%) and a mean |Δ| at most
  1.25× the spread's (read: 0.013 against 0.45).
"""
import numpy as np
import pytest
import torch

import torch_parallel_cases as C

torch.set_num_threads(min(2, torch.get_num_threads()))

NAMES = ("restir_halo", "restir_gather", "ssmm")


@pytest.fixture(scope="module")
def runs():
    return C.sharded_runs(NAMES)


def _weights_close(ours, ref, share=0.99):
    close = np.abs(ours - ref) <= 1e-4 + 1e-4 * np.abs(ref)
    assert close.mean() > share, close.mean()


def _restir_bound(parts, ref, W, H, share=0.99):
    np.testing.assert_allclose(C.stitch(parts, "ldr"), ref["ldr"], atol=3e-5)
    _weights_close(C.stitch(parts, "restir_w", W), C.flat_image(ref["restir_w"], W, H), share)


@pytest.fixture(scope="module")
def restir_refs():
    return C.port_single("restir_halo"), C.jax_single("restir_halo")


@pytest.mark.parametrize("route", ["halo", "gather"])
def test_restir_matches_single_device(runs, restir_refs, route):
    W, H = C.CASES["restir_halo"]["cfg"]["width"], C.CASES["restir_halo"]["cfg"]["height"]
    assert H // C.RANKS >= 16  # the halo route needs a slab as tall as the halo
    parts = runs[f"restir_{route}"]
    port, jx = restir_refs
    _restir_bound(parts, port, W, H)
    _restir_bound(parts, jx, W, H)
    assert int(C.stitch(parts, "restir_m", W).max()) > 1


def test_restir_halo_matches_gather(runs):
    W = C.CASES["restir_halo"]["cfg"]["width"]
    h, g = runs["restir_halo"], runs["restir_gather"]
    np.testing.assert_allclose(C.stitch(h, "ldr"), C.stitch(g, "ldr"), atol=3e-5)
    _weights_close(C.stitch(h, "restir_w", W), C.stitch(g, "restir_w", W))


def test_ssmm_matches_single_device(runs):
    W, H = C.CASES["ssmm"]["cfg"]["width"], C.CASES["ssmm"]["cfg"]["height"]
    parts = runs["ssmm"]
    port = C.port_single("ssmm")
    np.testing.assert_allclose(C.stitch(parts, "ldr"), port["ldr"], atol=3e-5)
    np.testing.assert_allclose(C.stitch(parts, "ssmm_sum_w", W),
                               C.flat_image(port["ssmm_sum_w"], W, H), atol=1e-4)
    jit, op = C.jax_single("ssmm"), C.jax_single("ssmm", jit=False)
    for key in ("ldr", "hdr"):
        share, mean = C.reading(jit[key], op[key])
        got = C.reading(C.stitch(parts, key), jit[key])
        assert got[0] >= share - 2 / (W * H) and got[1] <= 1.25 * mean, (key, got, share, mean)
    sum_w = C.stitch(parts, "ssmm_sum_w", W)
    share, mean = C.reading(C.flat_image(jit["ssmm_sum_w"], W, H),
                            C.flat_image(op["ssmm_sum_w"], W, H))
    got = C.reading(sum_w, C.flat_image(op["ssmm_sum_w"], W, H))
    assert got[0] >= 0.995 and got[1] <= 1.25 * mean, (got, share, mean)
    assert float(C.stitch(parts, "ssmm_sum_w", W).max()) > 0.0
