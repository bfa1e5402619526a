"""The port's demo reader (game/demo.py) against the JAX package's, on the
same bytes: tests/test_demo.py's synthetic protocol-15 stream, its twins
on the port alone, and the frames and camera path of both packages held
equal field for field."""
import dataclasses

import numpy as np

from merian_quake_tpu.game import demo as j_demo
from merian_quake_tpu_torch.game import demo
from test_demo import _build_demo


def test_parse_demo():
    info, frames = demo.parse_demo(_build_demo())
    assert info["map"] == "maps/test.bsp" and info["name"] == "Test Level"
    assert len(frames) == 4
    f0, f3 = frames[0], frames[3]
    assert abs(f0.time - 1.0) < 1e-6
    assert f0.health == 75 and f3.health == 78
    np.testing.assert_allclose(f3.entities[1].origin, (130.0, 200.0, 300.0))
    assert f3.entities[1].frame == 3
    np.testing.assert_allclose(f0.view_angles[1], 90.0)


def test_parse_demo_equals_reference():
    data = _build_demo()
    (info, frames), (j_info, j_frames) = demo.parse_demo(data), j_demo.parse_demo(data)
    assert info == j_info
    assert len(frames) == len(j_frames)
    for a, b in zip(frames, j_frames):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert len(demo.parse_demo(data, max_frames=2)[1]) == len(j_demo.parse_demo(data, 2)[1]) == 2


def test_demo_camera_path_equals_reference():
    _, frames = demo.parse_demo(_build_demo())
    _, j_frames = j_demo.parse_demo(_build_demo())
    path, j_path = demo.demo_camera_path(frames), j_demo.demo_camera_path(j_frames)
    for t in (0.0, 1.0, 1.05, 1.17, 1.3, 99.0):
        for a, b in zip(path(t), j_path(t)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    pos, fwd, _ = path(1.05)
    np.testing.assert_allclose(pos[0], 105.0, atol=1e-4)
    np.testing.assert_allclose(pos[2], 322.0, atol=1e-4)
    np.testing.assert_allclose(fwd[1], 1.0, atol=1e-5)
