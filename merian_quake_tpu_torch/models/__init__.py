"""Scene sources: containers, texture atlas, procedural scenes."""
from .types import RenderConfig, Scene, Uniforms  # noqa: F401
