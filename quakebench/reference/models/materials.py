"""Material flag semantics.

Mirrors the reference's res/shader/config.h:23-41 — the flags drive
UV warping, emission, and alpha behavior in the trace core
(raytrace.glsl:198-310). Values are kept identical for config parity.
"""

MAT_FLAGS_NONE = 0
MAT_FLAGS_LAVA = 1
MAT_FLAGS_SLIME = 2
MAT_FLAGS_TELE = 3
MAT_FLAGS_WATER = 4
MAT_FLAGS_SKY = 5
MAT_FLAGS_WATERFALL = 6
MAT_FLAGS_SPRITE = 7
MAT_FLAGS_SOLID = 8  # solid color: n0 = albedo, n1 = emission

PLAYER_FLAGS_TORCH = 1
PLAYER_FLAGS_UNDERWATER = 2

# Ray-tracing limits (config.h:5-16)
MAX_GLTEXTURES = 4096
MAX_GEOMETRIES = 16
T_MAX = 10000.0
ALPHA_THRESHOLD = 0.666
MAX_INTERSECTIONS = 5
MAX_SUN_COLOR = 20.0

# Default surface roughness; water overrides (raytrace.glsl:167,203)
DEFAULT_ROUGHNESS = 0.6
WATER_ROUGHNESS = 0.4

# Flags that warp UVs (lava/slime/tele/water, raytrace.glsl:198-204)
WARP_FLAG_MIN = MAT_FLAGS_LAVA
WARP_FLAG_MAX = MAT_FLAGS_WATER
