"""Game layer of the port: the live game loop.

Copies of merian_quake_tpu/game/ (jax-free numpy host code): the native
QuakeC host (``host``, built from native/game/*.cc with g++ at first
use), the frame-indexed state and its entities (``state``), the live
game bridge (``live``), the packaged mod and its arena (``mod``), the
live dungeon (``bigmap``), particles, font, audio, the QuakeC assembler
(``qcasm``) and the HUD compositor (``hud``). Scenes and uniforms land
on the state's ``device``.
"""
from .state import Entity, GameState  # noqa: F401
