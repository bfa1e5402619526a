"""ReSTIR DI debug visualizations.

Port of merian_quake_tpu/render/restir/debug.py. The reference plumbs a
debug image + ``debug_output_selector`` spec constant through every
ReSTIR pass but ships no view implementations; this is a functional
selector over the finalized per-pixel reservoir state, the natural
inspection set for DI reuse:

  0  W            (finalized reservoir weight, grayscale)
  1  M            (confidence length / temporal clamp)
  2  y_radiance   (selected light sample radiance)
  3  p_target     (target pdf at the canonical sample)
  4  y_dir        (direction to the selected sample, (d+1)/2)
"""
from __future__ import annotations

import torch

from ...models.types import RenderConfig
from ...ops import linalg
from .. import layout
from ..gbuffer import GBufferOutput
from ..hit import decompress_hit
from .restir import ReSTIRState

DEBUG_VIEWS = {
    0: "reservoir W",
    1: "reservoir M",
    2: "sample radiance",
    3: "target pdf",
    4: "sample direction",
}


def render_restir_debug(
    selector: int,
    config: RenderConfig,
    state: ReSTIRState,
    gbuf: GBufferOutput,
    m_clamp: int = 640,
) -> torch.Tensor:
    W, H = config.width, config.height
    r = state.reservoirs
    if selector == 0:
        out = r.w[:, None].expand(r.w.shape[0], 3)
    elif selector == 1:
        v = r.M.to(torch.float32) / float(m_clamp)
        out = v[:, None].expand(v.shape[0], 3)
    elif selector == 2:
        out = r.y_radiance
    elif selector == 3:
        out = r.p_target[:, None].expand(r.p_target.shape[0], 3)
    elif selector == 4:
        first_hit = decompress_hit(gbuf.hits)
        d = linalg.normalize(r.y_pos - first_hit.pos)
        out = (d + 1.0) * 0.5
    else:
        raise ValueError(f"unknown debug selector {selector} "
                         f"(valid: {sorted(DEBUG_VIEWS)})")
    return layout.flat_to_image(out, W, H)
