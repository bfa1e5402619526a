"""Screen-Space Mixture Models (SSMM) guided path tracing: per-pixel vMF
Markov chains in screen space, exchanged by a roll over the flat pixel
buffer and stochastic reads of the previous frame's states, combined by a
stochastic-MIS estimator over the sample group's lobes."""
from .ssmm import SSMMConfig, SSMMState, init_ssmm_state, render_ssmm  # noqa: F401
