"""Post-processing stages: accumulate, exposure, tonemap (the denoiser,
TAA and FXAA are in post.svgf, post.taa and post.fxaa, as in the JAX
package)."""
from .accumulate import accumulate  # noqa: F401
from .exposure import auto_exposure  # noqa: F401
from .tonemap import tonemap_reinhard_extended  # noqa: F401
