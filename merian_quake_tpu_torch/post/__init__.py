"""Post-processing stages: accumulate and tonemap."""
from .accumulate import accumulate  # noqa: F401
from .tonemap import tonemap_reinhard_extended  # noqa: F401
