"""merian_quake_tpu_torch.interop carries the JAX package's objects into
the port's containers: same field names, same shapes, the same values,
and the port's types (u32 → int64, bfloat16 kept, ``frame``/``player``
as Python ints, ``iteration`` as an int32 0-d tensor, as the JAX
package's i32[])."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu.models.procedural import cornell_box as j_cornell_box
from merian_quake_tpu.models.types import RenderConfig as JConfig
from merian_quake_tpu.renderer import render_sequence as j_render_sequence
from merian_quake_tpu_torch import interop

# The suite runs several test processes side by side on a few cores;
# torch would start one thread per core in each and oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))

_TYPES = {"float32": torch.float32, "int32": torch.int32, "bool": torch.bool,
          "uint32": torch.int64, "bfloat16": torch.bfloat16}


def _same(ours, ref):
    ref = np.asarray(ref)
    assert isinstance(ours, torch.Tensor) and ours.device.type == "cpu"
    assert tuple(ours.shape) == ref.shape
    assert ours.dtype == _TYPES[ref.dtype.name], (ours.dtype, ref.dtype)
    if ref.dtype.name == "bfloat16":
        np.testing.assert_array_equal(ours.float().numpy(), ref.astype(np.float32))
    else:
        np.testing.assert_array_equal(ours.numpy(), ref.astype(ours.numpy().dtype))


def _same_fields(ours, ref):
    assert ours._fields == ref._fields or set(ours._fields) <= set(ref._fields)
    for f in ours._fields:
        _same(getattr(ours, f), getattr(ref, f))


@pytest.fixture(scope="module")
def jax_run():
    """A 16×8 ReSTIR frame of cornell_box: every container the port
    carries across, with u32, bfloat16 and int32 fields."""
    bundle = j_cornell_box()
    state, out = j_render_sequence(bundle, JConfig(width=16, height=8, integrator="restir"), frames=1)
    jax.block_until_ready(out["ldr"])
    return bundle, state, out


def test_scene_and_atlas_round_trip(jax_run):
    bundle, _, _ = jax_run
    _same_fields(interop.scene_from_numpy(bundle.scene, device="cpu"), bundle.scene)
    atlas = interop.atlas_from_numpy(bundle.atlas, device="cpu")
    for f in ("data", "table", "flat"):
        _same(getattr(atlas, f), getattr(bundle.atlas, f))
    assert len(atlas.mips) == len(bundle.atlas.mips)
    for ours, ref in zip(atlas.mips, bundle.atlas.mips):
        _same(ours, ref)


def test_uniforms_round_trip(jax_run):
    bundle, _, _ = jax_run
    ref = bundle.uniforms._replace(frame=jnp.uint32(2**32 - 3), player=jnp.uint32(5))
    ours = interop.uniforms_from_numpy(ref, device="cpu")
    assert ours.frame == 2**32 - 3 and ours.player == 5
    for f in ours._fields:
        if f not in ("frame", "player"):
            _same(getattr(ours, f), getattr(ref, f))


def test_gbuffer_round_trip(jax_run):
    _, _, out = jax_run
    ref = out["gbuffer"]
    ours = interop.gbuffer_from_numpy(ref, device="cpu")
    assert ours._fields == ref._fields
    for f in ref._fields:
        if f != "hits":
            _same(getattr(ours, f), getattr(ref, f))
    _same_fields(ours.hits, ref.hits)
    assert ours.hits.wi.dtype == torch.int64 and ours.hits.mv.dtype == torch.bfloat16


def test_frame_and_restir_state_round_trip(jax_run):
    _, state, _ = jax_run
    ours = interop.frame_state_from_numpy(state, device="cpu")
    assert ours.iteration == int(state.iteration) == 1
    assert ours.iteration.dtype == torch.int32 and ours.iteration.dim() == 0
    for f in ("accum_irradiance", "accum_direct", "accum_albedo"):
        _same(getattr(ours, f), getattr(state, f))
    _same_fields(ours.restir.reservoirs, state.restir.reservoirs)
    assert ours.restir.reservoirs.M.dtype == torch.int32
    assert ours.restir.reservoirs.y_flags.dtype == torch.int64
    assert int(ours.restir.reservoirs.M.max()) > 0
    _same(ours.restir.prev_normal, state.restir.prev_normal)
    _same(ours.restir.prev_linear_z, state.restir.prev_linear_z)
    direct = interop.restir_state_from_numpy(state.restir, device="cpu")
    for a, b in zip(direct.reservoirs, ours.restir.reservoirs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
