"""The comparison that decides ``correct``, driven through a whole run on
the CPU at a small size: a sound program passes, the control (the
reference in bfloat16) fails, and so does a program broken underneath in
each way a cell of this benchmark can break."""
import pytest
import torch

from quakebench import check, run

from .conftest import small


def _run(bench, cell, fault=None, control=False, seed=4000000007):
    return run.run_cell(bench, cell, seed, 0.2, False, device="cpu", overrides=small(cell),
                        fault=fault, control=control)


def test_sound_run_passes_and_control_fails(bench):
    out = _run(bench, "restir_di.still_city", control=True)
    assert out["correct"], out["check"]
    ctl = out["control"]
    assert any(v > check.LIMITS[k] for k, v in ctl.items()), ctl


def test_leaf_error_counts_elements_beyond_tolerance():
    r = torch.ones(100)
    p = r.clone()
    p[:3] += 0.5
    assert check.leaf_error(p, r) == pytest.approx(0.03)
    assert check.leaf_error(r * (1 + 1e-6), r) == 0.0
    assert check.leaf_error(torch.tensor([1, 2, 3]), torch.tensor([1, 2, 4])) == pytest.approx(1 / 3)
    assert check.leaf_error(torch.zeros(3), torch.zeros(4)) == 1.0
    # a counter: its relative difference
    assert check.leaf_error(torch.tensor(1001), torch.tensor(1000)) == pytest.approx(1e-3)
    n = torch.tensor([float("nan"), 1.0])
    assert check.leaf_error(n, n) == 0.0
    assert check.leaf_error(n, torch.tensor([0.0, 1.0])) == 0.5


def _state_unchanged(pc):
    """The step returns its state unchanged (the frame renders, the
    histories never advance)."""
    step = pc.cf._step
    pc.cf._step = lambda state, u: (state, step(state, u)[1])


def _half_the_image(pc):
    """Half of the pixels left out: the integrator's irradiance of the
    lower half of the rows is dropped."""
    import merian_quake_tpu_torch.render.restir as rs

    orig = rs.render_restir

    def half(*a, **kw):
        irr, state = orig(*a, **kw)
        h = irr.shape[0] // 2
        return torch.cat([irr[:h], torch.zeros_like(irr[h:])]), state
    pc._undo = (rs, "render_restir", orig)
    rs.render_restir = half


def _hits_altered(pc):
    """An answer altered where it is produced: every eighth ray's nearest
    hit dropped."""
    import merian_quake_tpu_torch.render.trace as tr

    orig = tr.trace_nearest

    def altered(*a, **kw):
        hr = orig(*a, **kw)
        drop = torch.arange(hr.tri.shape[0]) % 8 == 0
        return hr._replace(tri=torch.where(drop, -1, hr.tri))
    pc._undo = (tr, "trace_nearest", orig)
    tr.trace_nearest = altered


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_image, _hits_altered])
def test_broken_program_is_not_correct(bench, fault):
    undo = []

    def apply(pc):
        fault(pc)
        if hasattr(pc, "_undo"):
            undo.append(pc._undo)
    try:
        out = _run(bench, "restir_di.still_city", fault=apply)
    finally:
        for mod, name, fn in undo:
            setattr(mod, name, fn)
    assert not out["correct"], out["check"]


def test_live_cell_checks_its_tables(bench):
    out = _run(bench, "mcpg_default.live_dungeon", seed=4000000011)
    assert out["correct"], out["check"]
    assert out["check"]["tables"]["value"] == 0.0
