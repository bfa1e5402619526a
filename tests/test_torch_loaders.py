"""The port's .pak/.bsp loaders and BSP extraction (models/pak.py, bsp.py,
extract.py) against the JAX package's, on the same bytes: twins of
tests/test_loaders.py.

The files are built in memory: tests/test_loaders.py's one-face map and
chip_smoke's ``room_bsp`` (a closed room, four textures: plain, sky,
fullbright; a sun and a player start). Both packages parse them to the
same lumps, faces, textures, models and entities, the same sun, and
``scene_from_bsp`` gives the same triangles, attributes, atlas table and
uniforms. The atlas's linear texels are held within 2 ulps, as
tests/test_torch_scenes.py holds every atlas (the JAX package decodes
sRGB with XLA's ``pow``, the port with numpy's).
"""
import numpy as np
import pytest
import torch

from chip_smoke.fixtures import room_bsp
from merian_quake_tpu.models import bsp as j_bsp
from merian_quake_tpu.models import extract as j_extract
from merian_quake_tpu.models import pak as j_pak
from merian_quake_tpu_torch.models import bsp, extract, pak
from merian_quake_tpu_torch.models.types import Scene, Uniforms
from test_loaders import _build_bsp

torch.set_num_threads(min(2, torch.get_num_threads()))

MAPS = {"one_face": _build_bsp, "room": room_bsp}


def test_pak_both_ways(tmp_path):
    files = {"maps/room.bsp": room_bsp(), "gfx/palette.lmp": bytes(range(256)) * 3,
             "progs/Mixed.Case": b"x" * 77}
    for write, read in ((j_pak.write_pak, pak.PakFile), (pak.write_pak, j_pak.PakFile)):
        p = str(tmp_path / f"{write.__module__}.pak")
        write(p, files)
        got = read(p)
        assert got.names() == sorted(n.lower() for n in files)
        for n, data in files.items():
            assert n.upper() in got and got.read(n.upper()) == data
    with open(tmp_path / "pak0.pak", "wb") as f:
        f.write(open(tmp_path / f"{pak.write_pak.__module__}.pak", "rb").read())
    (tmp_path / "maps").mkdir()
    (tmp_path / "maps" / "room.bsp").write_bytes(b"loose")
    for search in (pak.FileSearchPath, j_pak.FileSearchPath):
        fs = search([str(tmp_path)])
        assert fs.read("maps/room.bsp") == b"loose"  # loose files win
        assert fs.read("gfx/palette.lmp") == files["gfx/palette.lmp"]
        with pytest.raises(FileNotFoundError):
            fs.read("maps/missing.bsp")


@pytest.mark.parametrize("name", list(MAPS))
def test_load_bsp_equal(name):
    data = MAPS[name]()
    got, want = bsp.load_bsp(data), j_bsp.load_bsp(data)
    for f in ("vertices", "planes", "texinfo", "texinfo_miptex"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert len(got.faces) == len(want.faces) and len(got.textures) == len(want.textures)
    for a, b in zip(got.faces, want.faces):
        assert (a.plane, a.side, a.texinfo) == (b.plane, b.side, b.texinfo)
        np.testing.assert_array_equal(a.vertices, b.vertices)
    for a, b in zip(got.textures, want.textures):
        assert (a.name, a.width, a.height) == (b.name, b.width, b.height)
        np.testing.assert_array_equal(a.pixels, b.pixels)
    for a, b in zip(got.models, want.models):
        assert (a.first_face, a.num_faces) == (b.first_face, b.num_faces)
        np.testing.assert_array_equal(a.mins, b.mins)
        np.testing.assert_array_equal(a.maxs, b.maxs)
    assert got.entities == want.entities
    for x, y in zip(bsp.parse_worldspawn_sun(got.entities),
                    j_bsp.parse_worldspawn_sun(want.entities)):
        np.testing.assert_array_equal(x, y)


def test_entities_flags_and_sun_equal():
    text = ('{ "classname" "worldspawn" "message" "Test Map" "_sunlight2" "400" '
            '"_sunlight2_color" "1 0.5 0.25" "_sun_mangle" "30 -60 0" }\n'
            '{ "classname" "light" "origin" "1 2 3" }')
    assert bsp.parse_entities(text) == j_bsp.parse_entities(text)
    for name in ("*lava1", "*slime0", "*teleport", "*water2", "sky4", "wall3", "{grate",
                 "+0light", "trigger", ""):
        assert bsp.texture_flags(name) == j_bsp.texture_flags(name), name
    for ents in (bsp.parse_entities(text),
                 [{"classname": "worldspawn", "sky": "stormydays_", "_sunlight": "100"}],
                 [{"classname": "worldspawn", "_sunlight": "400000",
                   "_sunlight_color": "1 0.5 0.25"}], []):
        for x, y in zip(bsp.parse_worldspawn_sun(ents), j_bsp.parse_worldspawn_sun(ents)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", list(MAPS))
def test_scene_from_bsp_equal(name):
    data = MAPS[name]()
    tb = extract.scene_from_bsp(bsp.load_bsp(data), device="cpu")
    jb = j_extract.scene_from_bsp(j_bsp.load_bsp(data))
    assert tb.scene.v0.device.type == "cpu"
    for f in Scene._fields:
        want, got = np.asarray(getattr(jb.scene, f)), getattr(tb.scene, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(tb.atlas.table.numpy(), np.asarray(jb.atlas.table))
    assert len(tb.atlas.mips) == len(jb.atlas.mips)
    texels = lambda a: [a.data, a.flat, *a.mips]
    for a, b in zip(texels(tb.atlas), texels(jb.atlas)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2.5e-7, atol=0)
    for f in Uniforms._fields:
        want, got = np.asarray(getattr(jb.uniforms, f)), getattr(tb.uniforms, f)
        got = np.asarray(got) if isinstance(got, int) else got.numpy()
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f)
    if name == "room":
        # the fullbright wall has an emission texture, the sky its texture
        assert int(tb.scene.fb_texnum.max()) > 0 and int(tb.uniforms.sky_classic[0]) > 0


def test_scene_from_bsp_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises((AssertionError, RuntimeError)):
        extract.scene_from_bsp(bsp.load_bsp(_build_bsp()))
