"""ReSTIR DI — reservoir-based direct lighting with temporal/spatial reuse.

Port of merian_quake_tpu/render/restir (weighted reservoir sampling per
Bitterli et al. 2020; the reference's 4 passes: generate → temporal →
spatial → shade). Reservoirs are SoA tensors over pixels; the 8×8
boiling filter is a tile mean reduction.
"""
from .restir import (  # noqa: F401
    ReSTIRConfig,
    ReSTIRState,
    init_restir_state,
    render_restir,
)
