"""Renderers: trace + shading, gbuffer, path tracer, ReSTIR DI (``restir``)."""
from .hit import Hit, compress_hit, decompress_hit  # noqa: F401
from .trace import get_sky, trace_ray  # noqa: F401
from .gbuffer import GBufferOutput, render_gbuffer  # noqa: F401
