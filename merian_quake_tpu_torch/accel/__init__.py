"""Ray–scene intersection: accel tables, the oracle and the K1, K2, K3 and K8 kernels."""
from .build import AccelScene, build_accel  # noqa: F401
from .intersect import HitRecord, intersect, trace_nearest, trace_visibility  # noqa: F401
