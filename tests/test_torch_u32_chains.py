"""The u32 RNG and hash-grid chains (csrc/u32_chains.cu) on the CPU.

Four wrappers run the port's u32 integer chains: ``rng.seed_pixel`` (the
pixel seed), ``rng.uniforms`` (a run of k xorshift32 draws, under
``uniform`` … ``uniform4``), ``grids.cell`` (a cell of the adaptive, the
static or the light cache's grid, under ``adaptive_cell`` and
``static_cell``) and ``light_cache.lookup`` (the light cache's cell and
its row, under ``lc_get``). On CUDA tensors each is one launch of the
kernel, in native u32; on CPU tensors each runs its plain version, the
int64 torch path (``*_reference``). Here:

- on CPU tensors the wrappers equal their plain versions bit for bit on
  seeded inputs: a zero seed, the xorshift fixed point 0 and the top of
  the u32 range, negative cell indices, NaN and inf positions, dead lanes,
  and both slot layouts (grid_tile_bits 0 and 2);
- the kernel's integer arithmetic, written out in numpy uint32 as the
  source has it (pcg4d with only the lane the seed keeps, xorshift32, the
  two hashes, the plain and tiled slots), equals the int64 references;
- nothing on the CPU loads a kernel library or counts a launch;
- the wrappers raise on another dtype, shape, device or layout;
- every kernel source is listed in ``kernels.KERNELS``, so
  ``kernels.build_libraries`` builds each of them ahead of a run.

The kernel itself needs the card: the ``cuda`` test skips here and names
chip_smoke's phase 43, which holds every entry point bit for bit against
its int64 reference there (1080p populations on production_config()'s
tables in both layouts, a captured live dungeon MCPG frame against eager
frames on the int64 chains).
"""
import ctypes
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from merian_quake_tpu_torch import kernels
from merian_quake_tpu_torch.ops import hashgrid, rng
from merian_quake_tpu_torch.render.mcpg import grids, light_cache
from merian_quake_tpu_torch.render.mcpg.config import MCPGConfig

torch.set_num_threads(min(2, torch.get_num_threads()))

N = 4099
CFG = MCPGConfig(mc_adaptive_size=(1 << 14) + 3, mc_static_size=(1 << 10) + 7,
                 lc_size=(1 << 13) + 5)
LAYOUTS = (0, 2)


def _inputs(seed=7, n=N):
    """Seeded lanes: states with 0, 1, the top of the range and 2^31;
    positions 0.5-3000 units from the camera on both sides of the origin
    (negative cells), a few inf and NaN, read through a strided view; unit
    normals; a float level a lane (-3..40, a few NaN); a tenth dead."""
    g = torch.Generator().manual_seed(seed)
    cam = torch.tensor([120.5, -340.0, 64.75])
    d = torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    pos4 = torch.zeros(n, 4)
    pos4[:, :3] = cam + d * (0.5 + 3000.0 * torch.rand(n, 1, generator=g) ** 3)
    pos4[::997, :3] = float("inf")
    pos4[5::1009, 1] = float("nan")
    nrm = torch.randn(n, 3, generator=g)
    nrm = nrm / nrm.norm(dim=-1, keepdim=True)
    state = torch.randint(0, 1 << 32, (n,), generator=g, dtype=torch.int64)
    state[:4] = torch.tensor([0, 1, (1 << 32) - 1, 1 << 31])
    level = torch.randint(-3, 41, (n,), generator=g).float()
    level[7::503] = float("nan")
    lane = torch.arange(n)
    return {"rng": state, "pos": pos4[:, :3], "normal": nrm, "cam_x": cam, "level": level,
            "px": (lane % 61).int(), "py": (lane // 61).int(), "dead": torch.rand(n, generator=g) < 0.1,
            "queue": torch.randint(-(1 << 31), 1 << 31, (n, 16), generator=g).int()}


def _table(inp, cfg, seed=11):
    """A light-cache table (i32[lc_size, 5]) whose rows hold the hash each
    lane's cell expects for 70% of the lanes; a tenth of the irradiance
    not finite."""
    g = torch.Generator().manual_seed(seed)
    L = cfg.lc_size
    irr = torch.rand(L, 3, generator=g) * 4.0
    irr[torch.rand(L, generator=g) < 0.05, 1] = float("inf")
    irr[torch.rand(L, generator=g) < 0.05, 2] = float("nan")
    table = torch.cat([torch.randint(0, 1 << 16, (L, 1), generator=g).int(), irr.view(torch.int32),
                       torch.randint(0, 1 << 20, (L, 1), generator=g).int()], 1)
    for level in (inp["level"], light_cache._lc_level(inp["pos"], inp["cam_x"], cfg)):
        _, buf, h = grids.cell_reference(inp["rng"], inp["pos"], cfg, "light_cache",
                                         normal=inp["normal"], level=level)
        hit = torch.rand(buf.shape[0], generator=g) < 0.7
        table[buf[hit], 0] = h[hit].int()
    return table


def _calls(inp, cfg, table):
    """{case: fn(seed_pixel, uniforms, cell, lookup) → outputs}"""
    q = inp["queue"]
    return {
        "seed_pixel pixels": lambda s, u, c, l: s(inp["px"], inp["py"], 3, 1337),
        "seed_pixel zero seed": lambda s, u, c, l: s(inp["px"], inp["py"], 0, 0),
        "seed_pixel tensor seed": lambda s, u, c, l: s(inp["px"], inp["py"], torch.tensor(2 ** 31 + 5),
                                                       inp["rng"]),
        "seed_pixel queue column": lambda s, u, c, l: s(q[:, 15], 0, 4000000, inp["rng"][2]),
        **{f"uniforms k={k}": (lambda s, u, c, l, k=k: u(inp["rng"], k)) for k in (1, 2, 3, 4, 5)},
        "cell adaptive": lambda s, u, c, l: c(inp["rng"], inp["pos"], cfg, "adaptive",
                                              normal=inp["normal"], cam_x=inp["cam_x"]),
        "cell adaptive target given": lambda s, u, c, l: c(inp["rng"], inp["pos"], cfg, "adaptive",
                                                           normal=inp["normal"], level=inp["level"]),
        "cell static": lambda s, u, c, l: c(inp["rng"], inp["pos"], cfg, "static"),
        "cell light_cache": lambda s, u, c, l: c(inp["rng"], inp["pos"], cfg, "light_cache",
                                                 normal=inp["normal"], level=inp["level"]),
        "lookup": lambda s, u, c, l: l(inp["rng"], table, inp["pos"], inp["normal"], cfg,
                                       cam_x=inp["cam_x"]),
        "lookup dead": lambda s, u, c, l: l(inp["rng"], table, inp["pos"], inp["normal"], cfg,
                                            cam_x=inp["cam_x"], dead=inp["dead"]),
        "lookup level given": lambda s, u, c, l: l(inp["rng"], table, inp["pos"], inp["normal"], cfg,
                                                   level=inp["level"]),
    }


CASES = list(_calls(_inputs(n=8), CFG, None))
WRAPPERS = (rng.seed_pixel, rng.uniforms, grids.cell, light_cache.lookup)
PLAIN = (rng.seed_pixel_reference, rng.uniforms_reference, grids.cell_reference,
         light_cache.lookup_reference)


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("tile_bits", LAYOUTS)
@pytest.mark.parametrize("case", CASES)
def test_wrappers_equal_plain_versions(case, tile_bits):
    cfg = CFG._replace(grid_tile_bits=tile_bits)
    inp = _inputs()
    call = _calls(inp, cfg, _table(inp, cfg))[case]
    got, want = _flat(call(*WRAPPERS)), _flat(call(*PLAIN))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
    if case == "lookup":
        # the table meets matches, misses and non-finite rows
        n_found = int((want[2] > 0).sum())
        assert N // 4 < n_found < N


def test_uniform_wrappers_keep_their_shapes():
    s = _inputs()["rng"].reshape(1, N)
    for fn, k in ((rng.uniform, None), (rng.uniform2, 2), (rng.uniform3, 3), (rng.uniform4, 4)):
        state, u = fn(s)
        assert state.shape == (1, N) and u.shape == ((1, N) if k is None else (1, N, k))
    # the xorshift fixed point stays there and draws 0
    state, u = rng.uniform3(torch.zeros(5, dtype=torch.int64))
    assert not state.any() and not u.any()


# ---------------------------------------------------------------- the kernel's arithmetic

U32 = np.uint32


def _kernel_seed(px, py, frame, seed):
    """csrc/u32_chains.cu's seed_pixel in numpy uint32."""
    x, y, z, w = (np.asarray(v, np.int64).astype(U32) * U32(1664525) + U32(1013904223)
                  for v in (px, py, frame, seed))
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x ^= x >> U32(16)
    y ^= y >> U32(16)
    w ^= w >> U32(16)
    x = x + y * w
    return np.where(x == 0, U32(0x9E3779B9), x)


def _kernel_xorshift(s):
    s = s ^ (s << U32(13))
    s = s ^ (s >> U32(17))
    return s ^ (s << U32(5))


def _kernel_hash(v):
    """csrc/hash_grid.cuh's hash_coords over columns v."""
    h = np.full(v[0].shape, 0x9E3779B1, U32)
    for c in v:
        h ^= c * U32(0x85EBCA77)
        h = (h << U32(13)) | (h >> U32(19))
        h = h * U32(0xC2B2AE3D)
    h ^= h >> U32(16)
    h = h * U32(0x7FEB352D)
    return h ^ (h >> U32(15))


def _kernel_hash2(v):
    h = np.full(v[0].shape, 0x27220A95, U32)
    for c in v:
        h = (h + c * U32(0x165667B1)) * U32(0x01000193)
        h ^= h >> U32(17)
    return h & U32(0xFFFF)


def _kernel_slot(idx, extra, size, tile_bits):
    """csrc/hash_grid.cuh's slot_of: idx int32[n, 3], extra u32 columns."""
    if tile_bits == 0:
        return _kernel_hash([*(idx[:, j].astype(U32) for j in range(3)), *extra]) % U32(size)
    mask = (1 << tile_bits) - 1
    sub = ((idx[:, 0] & mask) | ((idx[:, 1] & mask) << tile_bits)
           | ((idx[:, 2] & mask) << (2 * tile_bits))).astype(np.uint64)
    h = _kernel_hash([*((idx[:, j] >> tile_bits).astype(U32) for j in range(3)), *extra])
    t = 1 << (3 * tile_bits)
    buckets = max(size // t, 1)
    return ((h.astype(np.uint64) % buckets) * t + sub).astype(U32)


def test_kernel_seed_and_draws_equal_the_int64_path():
    inp = _inputs()
    with np.errstate(over="ignore"):
        for frame, seed in ((0, 0), (7, 1337), (2 ** 31 + 5, 2 ** 32 - 3)):
            want = rng.seed_pixel_reference(inp["px"], inp["py"], frame, seed).numpy()
            assert np.array_equal(_kernel_seed(inp["px"], inp["py"], frame, seed), want)
        state = inp["rng"].numpy().astype(U32)
        ref_state, ref_u = rng.uniforms_reference(inp["rng"], 4)
        us = []
        for _ in range(4):
            state = _kernel_xorshift(state)
            us.append(state.astype(np.float32) * np.float32(2.0 ** -32))
    assert np.array_equal(state.astype(np.int64), ref_state.numpy())
    assert np.array_equal(np.stack(us, -1), ref_u.numpy())


@pytest.mark.parametrize("tile_bits", LAYOUTS)
def test_kernel_slots_and_hashes_equal_the_int64_path(tile_bits):
    g = np.random.default_rng(5)
    idx = g.integers(-(1 << 20), 1 << 20, (N, 3)).astype(np.int32)
    idx[:6] = [[-1, -1, -1], [0, 0, 0], [-(1 << 31), (1 << 31) - 1, 0], [3, -4, 5], [-8, 7, -9],
               [1 << 30, -(1 << 30), 2]]
    level = g.integers(-40, 40, N).astype(np.int32)
    nrm = g.normal(size=(N, 3)).astype(np.float32)
    qn = hashgrid.quantize_normal(torch.from_numpy(nrm))
    ti, tl = torch.from_numpy(idx), torch.from_numpy(level)
    with np.errstate(over="ignore"):
        slot = _kernel_slot(idx, [qn.numpy().astype(U32), level.astype(U32)], CFG.mc_adaptive_size,
                            tile_bits)
        plain = _kernel_slot(idx, [], CFG.mc_static_size, tile_bits)
        h2 = _kernel_hash2([*(idx[:, j].astype(U32) for j in range(3)), level.astype(U32)])
        h2_static = _kernel_hash2([idx[:, j].astype(U32) for j in range(3)])
    want = hashgrid.hash_grid_normal_level(ti, torch.from_numpy(nrm), tl, CFG.mc_adaptive_size,
                                           tile_bits=tile_bits)
    assert np.array_equal(slot.astype(np.int64), want.numpy())
    want = hashgrid.hash_grid(ti, CFG.mc_static_size, tile_bits=tile_bits)
    assert np.array_equal(plain.astype(np.int64), want.numpy())
    assert np.array_equal(h2.astype(np.int64), hashgrid.hash2_grid_level(ti, tl).numpy())
    assert np.array_equal(h2_static.astype(np.int64), hashgrid.hash2_grid(ti).numpy())


# ---------------------------------------------------------------- the CPU path and the seam


def test_cpu_path_loads_no_library_and_counts_no_launch(monkeypatch):
    def refuse(name):
        raise AssertionError(f"the CPU path loaded the {name} library")

    monkeypatch.setattr(kernels, "load_library", refuse)
    before = [w.launches for w in WRAPPERS]
    inp = _inputs()
    for call in _calls(inp, CFG, _table(inp, CFG)).values():
        call(*WRAPPERS)
    assert [w.launches for w in WRAPPERS] == before


def test_first_calls_import_no_module():
    """The wrappers' first calls, in a fresh process, import nothing: what
    they import lands in the first frame of every run's set-up
    (torch.broadcast_shapes, for one, imports sympy at its first call:
    3.7 s of the compiled frame's warm-up on the card)."""
    code = textwrap.dedent("""
        import sys
        import torch
        from merian_quake_tpu_torch.ops import rng
        from merian_quake_tpu_torch.render.mcpg import grids, light_cache
        from merian_quake_tpu_torch.render.mcpg.config import MCPGConfig
        cfg, n = MCPGConfig(), 64
        s, cam = torch.arange(1, n + 1), torch.zeros(3)
        p, nrm = torch.rand(n, 3), torch.rand(n, 3)
        table = torch.zeros((cfg.lc_size, 5), dtype=torch.int32)
        before = set(sys.modules)
        rng.seed_pixel(s.int(), 0, torch.tensor(3), 7)
        rng.uniform3(s)
        grids.adaptive_cell(s, p, nrm, cam, cfg)
        grids.static_cell(s, p, cfg)
        light_cache.lookup(s, table, p, nrm, cfg, cam_x=cam)
        print(sorted(set(sys.modules) - before))
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_every_kernel_source_is_built_by_the_seam():
    """kernels.build_libraries(*kernels.KERNELS) builds every csrc/*.cu
    ahead of a run: a source left out would be compiled at its first call,
    inside a frame's set-up."""
    sources = sorted(f[:-3] for f in os.listdir(kernels.CSRC_DIR) if f.endswith(".cu"))
    assert sorted(kernels.KERNELS) == sources


def _c_params(symbol: str) -> list:
    """The parameter types of the C entry point ``symbol`` in csrc/u32_chains.cu."""
    src = open(os.path.join(kernels.CSRC_DIR, "u32_chains.cu")).read()
    head = src[src.index(f'extern "C" int {symbol}('):]
    params = head[head.index("(") + 1:head.index(")")]
    return [" ".join(p.split()[:-1]) for p in params.split(",")]


@pytest.mark.parametrize("symbol,argtypes", [
    ("mq_seed_pixel", rng._SEED_ARGS), ("mq_uniforms", rng._UNIFORMS_ARGS),
    ("mq_grid_cell", grids._CELL_ARGS), ("mq_lc_lookup", light_cache._LOOKUP_ARGS)])
def test_argtypes_match_the_entry_points(symbol, argtypes):
    """ctypes passes an argument past ``argtypes`` with its default
    conversion (a pointer cut to an int): each wrapper's list names every
    parameter of its entry point, the stream last, by C type."""
    c_type = {kernels.P: ("void*",), kernels.I64: ("int64_t",), kernels.INT: ("int",),
              kernels.F: ("float",), ctypes.c_uint: ("unsigned",)}
    params = _c_params(symbol)
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        assert p.endswith("*") if t is kernels.P else p in c_type[t], (p, t)
    assert params[-1] == "void*"


def _bad(case):
    inp = _inputs(n=64)
    table = torch.zeros((CFG.lc_size, 5), dtype=torch.int32)
    r, pos, nrm, cam, lvl = inp["rng"], inp["pos"], inp["normal"], inp["cam_x"], inp["level"]
    cell = lambda **k: lambda: grids.cell(k.pop("rng", r), k.pop("pos", pos), k.pop("cfg", CFG),
                                          k.pop("grid", "adaptive"), **{"normal": nrm, "cam_x": cam,
                                                                        **k})
    look = lambda **k: lambda: light_cache.lookup(k.pop("rng", r), k.pop("table", table), pos, nrm,
                                                  k.pop("cfg", CFG), **{"cam_x": cam, **k})
    return {
        "seed_pixel float pixels": lambda: rng.seed_pixel(pos[:, 0], inp["py"], 0, 1),
        "seed_pixel seed of another length": lambda: rng.seed_pixel(inp["px"], inp["py"], 0, r[1:]),
        "seed_pixel seed not contiguous": lambda: rng.seed_pixel(
            inp["px"].reshape(8, 8), inp["py"].reshape(8, 8), 0, r.reshape(8, 8).t()),
        "seed_pixel seed on another device": lambda: rng.seed_pixel(inp["px"], inp["py"], 0,
                                                                    r.to("meta")),
        "uniforms int32 state": lambda: rng.uniforms(r.int(), 2),
        "uniforms strided state": lambda: rng.uniforms(torch.zeros(128, dtype=torch.int64)[::2], 2),
        "uniforms no draw": lambda: rng.uniforms(r, 0),
        "cell unknown grid": cell(grid="volume"),
        "cell rng int32": cell(rng=r.int()),
        "cell rng strided": cell(rng=torch.zeros(128, dtype=torch.int64)[::2]),
        "cell pos float64": cell(pos=pos.double()),
        "cell pos 4 columns": cell(pos=torch.zeros(64, 4)),
        "cell pos one lane short": cell(pos=pos[1:]),
        "cell no normal": cell(normal=None),
        "cell level float64": cell(level=lvl.double()),
        "cell level on another device": cell(level=lvl.to("meta")),
        "cell no camera": cell(cam_x=None),
        "cell light cache without a level": cell(grid="light_cache"),
        "lookup table 4 columns": look(table=torch.zeros((CFG.lc_size, 4), dtype=torch.int32)),
        "lookup table another size": look(table=torch.zeros((CFG.lc_size + 1, 5),
                                                            dtype=torch.int32)),
        "lookup table not contiguous": look(table=torch.zeros((CFG.lc_size, 10),
                                                              dtype=torch.int32)[:, :5]),
        "lookup table float32": look(table=table.view(torch.float32)),
        "lookup dead uint8": look(dead=inp["dead"].to(torch.uint8)),
        "lookup dead one lane short": look(dead=inp["dead"][1:]),
        "lookup tiles larger than the table": look(
            cfg=CFG._replace(lc_size=4000, grid_tile_bits=4),
            table=torch.zeros((4000, 5), dtype=torch.int32)),
    }[case]


BAD = [
    "seed_pixel float pixels", "seed_pixel seed of another length", "seed_pixel seed not contiguous",
    "seed_pixel seed on another device", "uniforms int32 state", "uniforms strided state",
    "uniforms no draw", "cell unknown grid", "cell rng int32", "cell rng strided",
    "cell pos float64", "cell pos 4 columns", "cell pos one lane short", "cell no normal",
    "cell level float64", "cell level on another device", "cell no camera",
    "cell light cache without a level", "lookup table 4 columns", "lookup table another size",
    "lookup table not contiguous", "lookup table float32", "lookup dead uint8",
    "lookup dead one lane short", "lookup tiles larger than the table"]


@pytest.mark.parametrize("case", BAD)
def test_wrappers_refuse(case):
    with pytest.raises(ValueError):
        _bad(case)()


@pytest.mark.cuda
def test_u32_chains_match_the_int64_path_on_card():
    """Every entry point against its int64 reference on the card, bit for
    bit on every output: 1080p × 2 spp, 1080p and 37x53 populations on
    production_config()'s grids and light cache, in both layouts (chip_smoke
    phase 43 makes these comparisons, and holds a captured live dungeon
    mcpg_default frame against eager frames on the int64 chains)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from chip_smoke.u32 import chains_random

    worst = chains_random(torch.device("cuda"), "")
    assert not {k: v for k, v in worst.items() if v[0]}
