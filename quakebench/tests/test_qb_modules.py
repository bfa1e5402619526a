"""Nothing a run loads is JAX or the JAX package, by whole top-level
module names; the reference imports nothing of the port."""
import ast
import os
import subprocess
import sys

from quakebench import run, spec


def test_top_level_names_compare_whole():
    assert run.forbidden_modules(["merian_quake_tpu_torch", "merian_quake_tpu_torch.accel",
                                  "jax_like", "numpy", "flaxen.x"]) == []
    assert run.forbidden_modules(["merian_quake_tpu.ops.rng", "jaxlib.xla_client", "jax",
                                  "flax.linen"]) == ["flax", "jax", "jaxlib", "merian_quake_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_sources_import_nothing_of_the_port():
    ref = os.path.join(spec.HERE, "reference")
    for dirpath, _, files in os.walk(ref):
        for f in files:
            if f.endswith(".py"):
                for name in _imports(os.path.join(dirpath, f)):
                    top = name.split(".", 1)[0]
                    assert top not in ("merian_quake_tpu_torch", "merian_quake_tpu", "jax",
                                       "jaxlib", "quakebench"), (f, name)


def test_reference_runs_with_the_port_and_jax_blocked():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('merian_quake_tpu_torch', 'merian_quake_tpu', 'jax'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import quakebench.reference.renderer, quakebench.reference.accel.intersect\n"
        "import quakebench.reference.render.mcpg.surface, quakebench.reference.render.mcpg.volume\n"
        "import quakebench.reference.render.restir.restir, quakebench.reference.post.svgf\n"
        "import quakebench.reference.post.taa, quakebench.reference.post.fxaa\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "quakebench.run", "--workload",
                          "restir_di.still_city", "--seed", "5000000000", "--seconds", "1",
                          "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
