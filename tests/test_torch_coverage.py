"""The port covers the JAX package: every module of ``merian_quake_tpu/``
has its counterpart (same name, same place) in ``merian_quake_tpu_torch/``
or is named in ROADMAP.md's "Not carried over" (read from the files,
without importing the JAX package); every package's ``__init__.py``
exports at least the public names of the JAX package's (read from the
files too: ``merian_quake_tpu/game/__init__.py`` imports JAX); and every
pass that renders a row slab takes the JAX function's slab arguments
(``y0``, ``rows``, ``mean_fn``, ``gather_fn``, ``shard_ctx``,
``n_shards``, ...)."""
import ast
import importlib
import inspect
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules(package):
    root = os.path.join(REPO, package)
    return sorted(
        os.path.relpath(os.path.join(d, f), root)
        for d, _, files in os.walk(root) if "__pycache__" not in d
        for f in files if f.endswith(".py")
    )


def _not_carried_over():
    text = open(os.path.join(REPO, "ROADMAP.md")).read()
    start = text.index("**Not carried over.**")
    end = text.index("\n### ", start)
    return text[start:end]


def test_every_module_has_a_counterpart():
    port = set(_modules("merian_quake_tpu_torch"))
    named = _not_carried_over()
    missing = [m for m in _modules("merian_quake_tpu")
               if m not in port and f"`{m}`" not in named]
    assert _modules("merian_quake_tpu"), "no module of the JAX package found"
    assert not missing, f"no counterpart in the port and not in ROADMAP's list: {missing}"


def test_not_carried_over_names_existing_modules():
    """A module the list names as replaced exists in the JAX package."""
    named = _not_carried_over()
    assert "`accel/pallas_intersect.py`" in named and "`accel/dense.py`" in named
    assert "accel/pallas_intersect.py" in _modules("merian_quake_tpu")
    assert "accel/dense.py" in _modules("merian_quake_tpu_torch")


def _exports(path):
    """The public names an ``__init__.py`` binds at its top level: what it
    imports from its modules and what it defines."""
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


INITS = [m for m in _modules("merian_quake_tpu") if os.path.basename(m) == "__init__.py"]


@pytest.mark.parametrize("init", INITS)
def test_package_exports(init):
    """Each package of the port exports what the JAX package's exports
    (``from merian_quake_tpu_torch.game import Entity, GameState``)."""
    want = _exports(os.path.join(REPO, "merian_quake_tpu", init))
    got = _exports(os.path.join(REPO, "merian_quake_tpu_torch", init))
    assert want <= got, f"{init}: the port does not export {sorted(want - got)}"


def test_game_exports_import():
    from merian_quake_tpu_torch.game import Entity, GameState
    from merian_quake_tpu_torch.game.state import Entity as E, GameState as G

    assert (Entity, GameState) == (E, G)


# (module, function) whose slab parameters the port's must take
SLAB_PASSES = [
    ("renderer", "frame_core"),
    ("render.layout", "gen_pixels"),
    ("render.gbuffer", "render_gbuffer"),
    ("render.pt", "render_pt"),
    ("render.mcpg.surface", "render_mcpg_surface"),
    ("render.mcpg.volume", "render_volume"),
    ("render.mcpg.volume", "compact_dist"),
    ("render.mcpg.updates", "compact_queues"),
    ("render.mcpg.updates", "queue_gidx"),
    ("render.restir.restir", "render_restir"),
    ("render.ssmm.ssmm", "render_ssmm"),
    ("post.accumulate", "accumulate_reprojected"),
    ("post.accumulate", "reproject"),
    ("post.sharded", "svgf_sharded"),
    ("post.sharded", "taa_sharded"),
    ("post.sharded", "fxaa_sharded"),
    ("parallel.render", "queue_gather_bytes"),
    ("parallel.render", "init_state_sharded"),
    ("parallel.render", "render_frame_sharded"),
]
SLAB_PARAMS = {"y0", "rows", "mean_fn", "gather_fn", "shard_ctx", "n_shards", "gather_img_fn",
               "ctx", "mesh", "n_devices"}


@pytest.mark.parametrize("mod,fn", SLAB_PASSES, ids=[f"{m}.{f}" for m, f in SLAB_PASSES])
def test_slab_arguments(mod, fn):
    ref = inspect.signature(getattr(importlib.import_module(f"merian_quake_tpu.{mod}"), fn))
    got = inspect.signature(getattr(importlib.import_module(f"merian_quake_tpu_torch.{mod}"), fn))
    want = SLAB_PARAMS & set(ref.parameters)
    assert want <= set(got.parameters), want - set(got.parameters)
    for name in want:  # the same defaults: a whole image on one device
        d_ref, d_got = ref.parameters[name].default, got.parameters[name].default
        if d_ref is None or isinstance(d_ref, int):
            assert d_got == d_ref, name
