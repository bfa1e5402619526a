"""The one generator of the benchmark's inputs: a configuration file
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``)
become the scene, the frame's settings and, frame by frame, the inputs
of the program under test (``merian_quake_tpu_torch``) and of the plain
reference (``quakebench/reference``).

A configuration is data:

- ``render``: the fields of ``RenderConfig`` (the seed and the scene's
  features are the run's);
- ``integrator_config``: ``{"type": "<module>.<Class>", "fields": {...}}``,
  made in each package from its own class of that name (``typed``);
- ``schedule`` (optional): the trace schedule, a typed spec as above,
  given to the program's compiled frame; the reference's trace ignores
  it (no schedule changes a hit).

A traffic mix is data:

- ``scene``: ``{"make": "<module>.<function>", "args": {...}}``, a scene
  maker of the program package, called with ``args`` and ``device=``;
- ``driver``: how the world moves from frame to frame, the name of a
  module of ``quakebench/drivers/`` (``still``: a still camera; ``live``:
  the scripted player of ``cli play``), with its own keys in the mix;
- ``features``: SceneFeatures forced on over the scene's own;
- ``fog``: ``{"mu_t", "mu_s_share"}`` set in every frame's uniforms, or
  null for the scene's own;
- ``settle_frames``: frames after the capture and before the window.

``--seed`` sets the render seed and whatever the mix's ``driver`` takes from it;
the scene itself is the mix's. What both sides share is the world the
frame is rendered from: the scene's triangles and the textures that the
maker packed (the reference packs its own atlas from them), the frame's
uniforms and, on a live mix, the game step's dynamic block. The
reference works out its own tables and atlas from them, and takes its
start from the program's frame state by field name (``adopt``).
"""
from __future__ import annotations

import contextlib
import copy
import importlib
import sys
import time

import numpy as np
import torch

PROGRAM = "merian_quake_tpu_torch"
REFERENCE = "quakebench.reference"


def merge(base: dict, over: dict | None) -> dict:
    """``base`` with ``over``'s keys put in, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def resolve(root: str, dotted: str):
    mod, _, name = dotted.rpartition(".")
    return getattr(importlib.import_module(f"{root}.{mod}"), name)


def typed(root: str, spec):
    """``{"type": "<module>.<Class>", "fields": {...}}`` as that class of
    package ``root`` (nested specs too; lists become tuples)."""
    if isinstance(spec, dict) and "type" in spec:
        return resolve(root, spec["type"])(**{k: typed(root, v)
                                               for k, v in spec["fields"].items()})
    if isinstance(spec, list):
        return tuple(typed(root, v) for v in spec)
    return spec


def render_seed(seed: int) -> int:
    return seed % (1 << 31)


def render_config(root: str, cfg: dict, seed: int, features):
    return resolve(root, "models.types.RenderConfig")(
        **cfg["render"], seed=render_seed(seed), features=features)


def with_fog(uniforms, fog):
    if not fog:
        return uniforms
    dev = uniforms.cam_x.device
    mu_t = float(fog["mu_t"])
    return uniforms._replace(
        mu_t=torch.tensor(mu_t, dtype=torch.float32, device=dev),
        mu_s=torch.full((3,), mu_t * float(fog["mu_s_share"]), dtype=torch.float32, device=dev))


class Spans:
    """Host-clock spans by name (seconds), recorded only when ``on``;
    with a profiler running, each is also a ``record_function`` range,
    so that the trace's idle gaps can be labelled by them."""

    def __init__(self, on: bool):
        self.on = on
        self.times: dict[str, list] = {}

    def __call__(self, name: str, fn, *args, sync=False, **kw):
        if not self.on:
            return fn(*args, **kw)
        with torch.profiler.record_function(f"qb.{name}"):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if sync and torch.cuda.is_available():
                torch.cuda.synchronize()
            self.times.setdefault(name, []).append(time.perf_counter() - t0)
        return out


@contextlib.contextmanager
def packed_textures():
    """Records every call of the program's ``pack_textures`` made inside
    (a list of (atlas, textures, args, keyword args but the device)), so
    that the reference can pack its own atlas from the same textures."""
    mod = importlib.import_module(f"{PROGRAM}.models.atlas")
    orig = mod.pack_textures
    calls = []

    def recording(textures, *args, **kw):
        atlas = orig(textures, *args, **kw)
        calls.append((atlas, [np.array(t, copy=True) for t in textures], args,
                      {k: v for k, v in kw.items() if k != "device"}))
        return atlas

    def swap(old, new):
        for m in list(sys.modules.values()):
            if getattr(m, "__name__", "").startswith(PROGRAM) \
                    and getattr(m, "pack_textures", None) is old:
                m.pack_textures = new

    swap(orig, recording)
    try:
        yield calls
    finally:
        # modules imported inside bound the recording function: undo those too
        swap(recording, orig)


class ProgramCell:
    """The program under test set up for one cell: ``frame(i)`` runs frame
    ``i`` through the path users run (``renderer.compile_frame``, on the
    card one CUDA graph a frame), after what the mix's driver runs before
    it. Set-up records ``accel_build`` (the scene and its tables) and
    ``capture`` (the first frame: warm-up and capture), and ``parts``,
    the host clock of each step of set-up."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, spans: Spans, fault=None):
        from quakebench import spec

        self.parts = {}
        t0 = time.perf_counter()
        from merian_quake_tpu_torch.accel.build import scene_features
        from merian_quake_tpu_torch.renderer import compile_frame, init_state

        cuda = torch.device(device).type == "cuda"
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        self.mix, self.seed, self.device, self.spans = mix, seed, device, spans
        driver = spec.driver(mix["driver"])
        maker = resolve(PROGRAM, mix["scene"]["make"])
        if cuda:
            torch.cuda.init()
            torch.empty(1, device=device)
        t1 = self._part("import", t0)
        with packed_textures() as packs:
            made = maker(**mix["scene"].get("args", {}), device=device)
            self.world = driver.Program(made, mix, seed, device, spans)
            del made
        sync()
        t2 = self._part("scene", t1)
        spans.times["accel_build"] = [t2 - t1]
        bundle = self.bundle = self.world.bundle
        self.textures = next(c[1:] for c in reversed(packs) if c[0] is bundle.atlas)
        del packs
        accel = self.world.accel
        # the scene's sizes, for the roofline's work model
        self.n_tris = int(accel.scene.num_tris)
        self.n_clusters = int(accel.cluster_lo.shape[0])
        self.features = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)._replace(
            **mix.get("features", {}))
        self.config = render_config(PROGRAM, cfg, seed, self.features)
        self.icfg = typed(PROGRAM, cfg.get("integrator_config"))
        self.state0 = init_state(self.config, self.icfg, device=device)
        sync()
        t3 = self._part("state", t2)
        self.cf = compile_frame(accel, bundle.atlas, self.config, self.state0, self.icfg,
                                typed(PROGRAM, cfg.get("schedule")))
        if fault is not None:
            fault(self)
        self.frame(0)
        self._part("capture", t3)
        spans.times["capture"] = [self.parts["capture"]]

    def _part(self, name: str, since: float) -> float:
        now = time.perf_counter()
        self.parts[name] = now - since
        return now

    def inputs(self, i: int):
        """Frame ``i``'s uniforms (after the mix's world step)."""
        u = self.world.inputs(i)
        return with_fog(u, self.mix.get("fog"))

    def frame(self, i: int):
        """Frame ``i``; returns the compiled frame's (state, outputs), the
        static buffers that the next frame overwrites."""
        u = self.inputs(i)
        self.world.before_replay(self.cf)
        return self.spans("replay", self.cf, u)

    def fresh_state(self):
        """The program's initial frame state for this cell's settings."""
        from merian_quake_tpu_torch.renderer import init_state

        return init_state(self.config, self.icfg, device=self.device)

    def release(self):
        """Free the program's device memory (the graph, its pool, the state
        and the tables)."""
        for k in ("cf", "state0"):
            self.__dict__.pop(k, None)
        self.world.release()


def clone(x):
    """``x`` (NamedTuples, dicts, tuples and lists of tensors) with every
    tensor copied."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: clone(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[clone(v) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(clone(v) for v in x)
    return x


def _get(value, key):
    return value[key] if isinstance(value, dict) else getattr(value, key)


def adopt(template, value):
    """The program's ``value`` (NamedTuples, dicts, tuples of tensors) in
    the reference's structure ``template``: fields and keys by name, each
    tensor copied as the template leaf's dtype and, where only the layout
    of its elements differs, shape. A field that the template has and the
    value lacks raises."""
    if isinstance(template, torch.Tensor):
        v = torch.as_tensor(value)
        if v.shape != template.shape and v.numel() == template.numel():
            v = v.reshape(template.shape)
        return v.to(dtype=template.dtype, copy=True)
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(**{f: adopt(getattr(template, f), _get(value, f))
                                 for f in template._fields})
    if isinstance(template, dict):
        return {k: adopt(t, _get(value, k)) for k, t in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(adopt(t, v) for t, v in zip(template, value, strict=True))
    return clone(value)


def adopt_fields(cls, value):
    """The program's NamedTuple ``value`` as the reference's class ``cls``,
    field by field by name (tensors shared)."""
    return cls(**{f: getattr(value, f) for f in cls._fields if hasattr(value, f)})


def host_scene(scene) -> list:
    return [t.detach().cpu().numpy() for t in scene]


class ReferenceCell:
    """The plain reference of one cell, from the same scene, textures,
    uniforms and world steps as the program: its own atlas, tables,
    settings and frame. ``precision`` "bf16": the control (hits rounded to
    bfloat16)."""

    def __init__(self, cfg: dict, mix: dict, seed: int, scene_host: list, textures,
                 uniforms, device, precision: str = "fp32"):
        from quakebench import spec
        from quakebench.reference.accel import build as rb
        from quakebench.reference.models.atlas import pack_textures
        from quakebench.reference.models.types import Scene, Uniforms

        self.device = device
        images, args, kw = textures
        self.atlas = pack_textures(images, *args, **kw, device=device)
        scene = Scene(*scene_host)
        self.world = spec.driver(mix["driver"]).Reference(scene, self.atlas, mix, device)
        self.accel = self.world.accel._replace(precision=precision)
        features = rb.scene_features(scene, adopt_fields(Uniforms, uniforms),
                                     self.atlas)._replace(**mix.get("features", {}))
        self.config = render_config(REFERENCE, cfg, seed, features)
        self.icfg = typed(REFERENCE, cfg.get("integrator_config"))

    def uniforms(self, u):
        from quakebench.reference.models.types import Uniforms

        return adopt_fields(Uniforms, u)

    def with_precision(self, precision: str) -> "ReferenceCell":
        """This reference on the same tables, its hits rounded as
        ``precision`` says."""
        other = copy.copy(self)
        other.accel = self.accel._replace(precision=precision)
        return other

    def init_state(self):
        from quakebench.reference.renderer import init_state

        return init_state(self.config, self.icfg, device=self.device)

    def frame(self, state, uniforms):
        """One frame from ``state`` (the reference's classes) on
        ``uniforms``: (new state, outputs)."""
        from quakebench.reference.renderer import frame_core

        return frame_core(self.accel, self.atlas, uniforms, self.config, state,
                          mcpg_config=self.icfg)
