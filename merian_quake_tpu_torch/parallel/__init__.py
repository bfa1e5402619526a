"""Multi-device rendering: image-row slabs over ``torch.distributed``.

The pixel grid is split into row slabs, one a rank; scene, atlas and
uniforms are replicated, and the cross-slab work (the exposure mean, the
guiding-update queues, the denoise halos) rides collectives
(parallel/render.py, post/sharded.py).
"""
from .render import (  # noqa: F401
    dryrun_multichip, init_state_sharded, make_mesh, render_frame_sharded, spawn_ranks,
)
