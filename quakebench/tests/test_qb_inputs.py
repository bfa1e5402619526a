"""What the reference takes from the program's side: the textures that the
scene maker packed (the reference packs its own atlas from them) and the
program's frame state, adopted by field name into the reference's
structure."""
from typing import NamedTuple

import pytest
import torch

from quakebench import check, scenes


class _RefState(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor
    inner: object = None


class _ProgState(NamedTuple):  # another class, another field order and dtype
    inner: object
    b: torch.Tensor
    a: torch.Tensor


def test_adopt_takes_fields_by_name_in_the_reference_dtype_and_layout():
    tmpl = _RefState(a=torch.zeros(2, 3), b=torch.zeros(4, dtype=torch.int64),
                     inner={"x": torch.zeros(2, 2)})
    prog = _ProgState(inner={"x": torch.arange(4.0)}, b=torch.arange(4, dtype=torch.int32),
                      a=torch.arange(6, dtype=torch.float64).reshape(3, 2))
    out = scenes.adopt(tmpl, prog)
    assert type(out) is _RefState
    assert out.a.dtype == torch.float32 and out.a.shape == (2, 3)
    assert out.a.flatten().tolist() == list(range(6))
    assert out.b.dtype == torch.int64 and out.b.tolist() == [0, 1, 2, 3]
    assert out.inner["x"].shape == (2, 2)
    # a copy: the program's buffers may be overwritten afterwards
    prog.b.fill_(7)
    assert out.b.tolist() == [0, 1, 2, 3]
    # a field that the program's state lacks
    no_inner = type("NoInner", (), {"a": torch.zeros(2, 3), "b": torch.zeros(4)})()
    with pytest.raises(AttributeError):
        scenes.adopt(tmpl, no_inner)


def test_comparison_reads_values_not_classes():
    ref = _RefState(a=torch.ones(2, 3), b=torch.arange(4), inner=None)
    prog = _ProgState(inner=None, b=torch.arange(4, dtype=torch.int32),
                      a=torch.ones(6, dtype=torch.float16))
    assert check.worst(prog, ref) == (0.0, "a")
    bad = prog._replace(a=torch.zeros(6))
    assert check.worst(bad, ref)[0] == 1.0


def test_reference_packs_its_own_atlas_from_the_same_textures():
    from merian_quake_tpu_torch.models import atlas as patlas
    from merian_quake_tpu_torch.models import procedural
    from quakebench.reference.models.atlas import pack_textures

    orig = patlas.pack_textures
    with scenes.packed_textures() as calls:
        bundle = procedural.city(n_buildings=4, seed=7, device="cpu")
    assert procedural.pack_textures is orig and patlas.pack_textures is orig
    images, args, kw = next(c[1:] for c in calls if c[0] is bundle.atlas)
    ref = pack_textures(images, *args, **kw, device="cpu")
    assert check.worst(bundle.atlas, ref)[0] == 0.0
    # a texel changed in the textures shows in the reference's atlas
    images[1] = images[1].copy()
    images[1][0, 0, :3] = 255 - images[1][0, 0, :3]
    assert check.worst(bundle.atlas, pack_textures(images, *args, **kw, device="cpu"))[0] > 0
