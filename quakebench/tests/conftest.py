"""CPU tests of the benchmark harness (``python3 -m pytest quakebench/tests``).
Tests that need a CUDA card carry the ``cuda`` marker and skip, deciding
inside the test, where there is none."""
import pytest
import torch

torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device")


@pytest.fixture
def bench():
    from quakebench import spec

    return spec.load_benchmark()


# a cell shrunk to a size the CPU renders in seconds
SMALL_MCPG = {"mc_adaptive_size": 1 << 14, "mc_static_size": 1 << 12, "lc_size": 1 << 12,
              "update_cell_capacity": 1 << 12, "update_queue_capacity": 1 << 14,
              "zero_queue_capacity": 1 << 10, "lc_queue_capacity": 1 << 14}


# each mix's scene maker at a size the CPU builds in seconds
SMALL_SCENES = {"live_dungeon": {"grid": 3, "monsters": 4, "dynamic_capacity": 512},
                "still_city": {"n_buildings": 40}, "still_map": {"n_buildings": 40}}


def small(cell: str) -> dict:
    ov = {"config": {"render": {"width": 40, "height": 24}},
          "traffic": {"scene": {"args": SMALL_SCENES[cell.split(".", 1)[1]]},
                      "settle_frames": 1}}
    if cell.startswith("mcpg"):
        ov["config"]["integrator_config"] = {"fields": SMALL_MCPG}
    return ov
