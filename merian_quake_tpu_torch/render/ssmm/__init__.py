"""Screen-Space Mixture Models (SSMM) guided path tracing.

Port of merian_quake_tpu/render/ssmm (the reference's render_ssmm,
Dittebrandt et al. 2020 style): per-pixel vMF Markov chains live in
screen space; proposals are exchanged by a roll over the flat pixel
buffer and stochastic reads of the previous frame's state buffer,
combined with a stochastic-MIS (SMIS) estimator over the sample group's
lobes.
"""
from .ssmm import SSMMConfig, SSMMState, init_ssmm_state, render_ssmm  # noqa: F401
