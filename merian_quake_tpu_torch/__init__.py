"""merian_quake_tpu_torch — the PyTorch + CUDA port of merian_quake_tpu.

Same module names and contracts as the JAX package, which stays the
reference: every ported function takes the same inputs and gives the
same outputs within a stated tolerance (tests/test_torch_*.py).

- ``models``: scene containers, texture atlas, procedural scenes (host
  build in numpy, tensors placed on the requested ``device`` once)
- ``accel``: accel tables, the Möller–Trumbore oracle (CPU tensors) and
  the hand-written CUDA kernels (CUDA tensors): the Woop nearest-hit and
  any-hit kernels K1 and K2, the streamed-table kernel K3 for tables
  above 65,536 triangles, and the dense Möller–Trumbore sweep K8
- ``ops``: math/sampling library as plain torch functions
- ``render``: trace + shading, gbuffer, path tracer, ReSTIR DI, MCPG
  (surface and volume passes)
- ``post``: accumulation (plain and reprojected), tonemapping and the
  denoise chain
- ``renderer``: the frame loop
- ``game``: the live game loop (the native QuakeC host, entities, the
  live dungeon); ``accel.build.build_accel_live`` / ``refresh_dynamic``
  its per-frame accel refresh
- ``presets``, ``graph``, ``utils``: the tracked configs, the frame
  graph, certification
- ``cli``: ``python -m merian_quake_tpu_torch.cli render | preset | play |
  error | graph | certify``
- ``interop``: the JAX package's objects, as arrays, into these containers

Nothing here imports JAX. Every entry point takes ``device=`` and
runs on the card (``"cuda"``) unless the caller asks for the CPU; where
there is no CUDA device, a call that does not name ``device="cpu"``
raises. A CUDA tensor never falls back to a CPU path.
"""

__version__ = "0.1.0"
