"""Ray–scene intersection: accel tables, the oracle and the K1 kernel."""
from .build import AccelScene, build_accel  # noqa: F401
from .intersect import HitRecord, intersect, trace_nearest  # noqa: F401
