"""Hit records, uncompressed and compressed.

Port of merian_quake_tpu/render/hit.py: ``CompressedHit`` is the
gbuffer → integrator handoff (octahedral-encoded directions as u32
values in int64 tensors, bfloat16 motion/albedo/roughness — the same
low-precision format as the JAX package).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import octahedral


class Hit(NamedTuple):
    pos: torch.Tensor  # f32[..., 3]
    prev_pos: torch.Tensor  # f32[..., 3]
    wi: torch.Tensor  # f32[..., 3] incoming ray direction (toward surface)
    normal: torch.Tensor  # f32[..., 3] shading normal
    geo_normal: torch.Tensor  # f32[..., 3] geometric normal
    albedo: torch.Tensor  # f32[..., 3]
    roughness: torch.Tensor  # f32[...]


class CompressedHit(NamedTuple):
    pos: torch.Tensor  # f32[..., 3]
    mv: torch.Tensor  # bf16[..., 3] pos - prev_pos
    wi: torch.Tensor  # u32 value (int64) octahedral
    normal: torch.Tensor
    geo_normal: torch.Tensor
    albedo: torch.Tensor  # bf16[..., 3]
    roughness: torch.Tensor  # bf16[...]


def compress_hit(h: Hit) -> CompressedHit:
    return CompressedHit(
        pos=h.pos,
        mv=(h.pos - h.prev_pos).to(torch.bfloat16),
        wi=octahedral.encode_normal(h.wi),
        normal=octahedral.encode_normal(h.normal),
        geo_normal=octahedral.encode_normal(h.geo_normal),
        albedo=h.albedo.to(torch.bfloat16),
        roughness=h.roughness.to(torch.bfloat16),
    )


def decompress_hit(c: CompressedHit) -> Hit:
    return Hit(
        pos=c.pos,
        prev_pos=c.pos - c.mv.float(),
        wi=octahedral.decode_normal(c.wi),
        normal=octahedral.decode_normal(c.normal),
        geo_normal=octahedral.decode_normal(c.geo_normal),
        albedo=c.albedo.float(),
        roughness=c.roughness.float(),
    )
