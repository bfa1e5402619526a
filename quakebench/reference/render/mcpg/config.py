"""MCPG configuration and persistent device state.

Port of merian_quake_tpu/render/mcpg/config.py: the same fields and
defaults, and the production-scale preset.

u32 values: chain ids and verification hashes ride in the int32 columns
of ``MCStates.i`` by their bits (ids ≥ 2^31 are negative there) and are
read back as u32 values in int64 tensors; the light cache's 16-bit
verification hash is held as int32; the two counters are int64.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class MCPGConfig(NamedTuple):
    """Static MCPG knobs (≈ the reference renderer's shader macros)."""

    # grid sizes
    mc_adaptive_size: int = 1 << 17
    mc_static_size: int = 1 << 14
    lc_size: int = 1 << 16
    # sampling
    mc_samples: int = 5
    mc_samples_adaptive_prob: float = 0.7
    surf_bsdf_p: float = 0.15
    # per-cell adaptive defensive probability: when > 0, the per-lane
    # BSDF probability is raised toward 1 for IMMATURE winner chains,
    # sbp_eff = 1 - (1 - surf_bsdf_p) · N/(N + trust_n). The MIS pdf uses
    # the same per-lane probability, so the estimator stays unbiased.
    # 0 = fixed surf_bsdf_p.
    surf_bsdf_trust_n: int = 16
    # luminance clamp on guiding-update weights: bounds the Metropolis
    # target so a single firefly cannot dominate a chain's sum_w for
    # hundreds of frames. 0 = off. Biases only the GUIDING DISTRIBUTION
    # (which may be anything), never the estimator.
    mc_update_clamp: float = 64.0
    dir_guide_prior: float = 0.2
    mc_fast_recovery: bool = True
    use_light_cache_tail: bool = False
    # adaptive grid (exponential type)
    mc_adaptive_tan_alpha_half: float = 0.003
    mc_adaptive_min_width: float = 0.01
    mc_adaptive_power: float = 4.0
    mc_adaptive_steps_per_unit: float = 6.0
    # static grid
    mc_static_width: float = 25.3
    # light cache grid (exponential)
    lc_tan_alpha_half: float = 0.002
    lc_min_width: float = 0.01
    lc_power: float = 2.0
    lc_steps_per_unit: float = 6.0
    # chain limits
    ml_max_n: int = 1024
    ml_min_alpha: float = 0.01
    # per-frame budget of distinct cells receiving MC updates; segments
    # past it drop, like full per-cell update queues.
    update_cell_capacity: int = 1 << 19
    # per-frame budget of live MC update SAMPLES: the raw queue is
    # pixels × spp × bounces rows of which a minority pass the Metropolis
    # accept gate, so one sort compacts the queue to this prefix and the
    # replay runs at capacity instead of queue size. Overflow rows drop.
    update_queue_capacity: int = 1 << 21
    # fast-recovery zero requests per frame (they ride the same
    # compaction sort as the update samples)
    zero_queue_capacity: int = 1 << 16
    # per-frame budget of live LIGHT-CACHE samples kept by the queue
    # compaction (compact_queues); 2^22 keeps everything at 1080p·2spp.
    lc_queue_capacity: int = 1 << 22
    lc_max_n: int = 128
    lc_min_alpha: float = 0.01
    # vMF sharpness cap: moderate caps reduce guided-MIS variance.
    kappa_max: float = 30.0
    # live-lane compaction budgets for the surface bounce segments
    # (fraction of the spp·pixels lane population per segment index,
    # last entry repeats; () = off). Segments with budget < 1 sort lanes
    # live-first and run the whole segment body on the static live prefix
    # only, falling back to full width when the prefix would overflow —
    # exact either way.
    surf_live_budget: tuple = ()
    # locality-preserving state-table layout: cells hashed per TILE of
    # 8^b cells, placed at consecutive rows within the tile's bucket.
    # Same load factor / collision rate as the scrambled layout. Applies
    # to both MC grids and the light cache. 0 = off.
    grid_tile_bits: int = 0
    # volume single scattering (None = surface only)
    volume: object = None

    @property
    def mc_total_size(self) -> int:
        return self.mc_adaptive_size + self.mc_static_size


def production_config():
    """Production-scale preset mirroring the reference's default MCPG
    node properties: 33.6M chain states + 4M light cache, 2 spp volume
    single scattering with distance guiding p=0.9 and 7 µm Draine
    particles, exponential adaptive grid with power √3 / 1 step per
    unit, BSDF prob 0.1."""
    from .volume import VolumeConfig

    return MCPGConfig(
        mc_adaptive_size=32_777_259,
        mc_static_size=800_009,
        lc_size=4_000_037,
        mc_samples=5,
        mc_samples_adaptive_prob=0.7,
        surf_bsdf_p=0.1,
        dir_guide_prior=0.3,
        mc_adaptive_tan_alpha_half=0.002,
        mc_adaptive_min_width=0.01,
        mc_adaptive_power=1.7320508,
        mc_adaptive_steps_per_unit=1.0,
        lc_tan_alpha_half=0.005,
        lc_min_width=0.01,
        lc_power=2.0,
        lc_steps_per_unit=6.0,
        mc_static_width=25.3,
        volume=VolumeConfig(
            volume_spp=2,
            volume_phase_p=0.1,
            dist_guide_p=0.9,
            distance_mc_samples=3,
            distance_grid_width=25,
            distance_state_count=10,
            volume_use_light_cache=True,
            particle_size_um=7.0,
            forward_project=True,
        ),
    )


class MCStates(NamedTuple):
    """MCState array over adaptive ++ static slots, as TWO packed
    matrices. Column layout: f = [w_tgt(3), sum_w, w_cos, mv(3), T];
    i = [id, N, hash]. Read sites use the accessor properties below."""

    f: torch.Tensor  # f32[S, 9]
    i: torch.Tensor  # i32[S, 3]

    @property
    def w_tgt(self):
        return self.f[:, 0:3]

    @property
    def sum_w(self):
        return self.f[:, 3]

    @property
    def w_cos(self):
        return self.f[:, 4]

    @property
    def mv(self):
        return self.f[:, 5:8]

    @property
    def T(self):
        return self.f[:, 8]

    @property
    def id(self):
        return self.i[:, 0].to(torch.int64) & 0xFFFFFFFF

    @property
    def N(self):
        return self.i[:, 1]

    @property
    def hash(self):
        return self.i[:, 2].to(torch.int64) & 0xFFFFFFFF


class LightCache(NamedTuple):
    """SoA light-cache vertex array. One EWA step per cell per frame,
    from the mean of the frame's samples for that cell."""

    hash: torch.Tensor  # i32[L] 16-bit verification hash
    irr: torch.Tensor  # f32[L, 3]
    N: torch.Tensor  # i32[L]


class MCPGState(NamedTuple):
    mc: MCStates
    lc: LightCache
    # observability: cells updated, and samples merged into one cell
    lc_updates_applied: torch.Tensor  # i64[]
    lc_updates_merged: torch.Tensor  # i64[]


def init_mcpg_state(config: MCPGConfig, device="cuda") -> MCPGState:
    s = config.mc_total_size
    l = config.lc_size
    return MCPGState(
        mc=MCStates(
            f=torch.zeros((s, 9), dtype=torch.float32, device=device),
            i=torch.zeros((s, 3), dtype=torch.int32, device=device),
        ),
        lc=LightCache(
            hash=torch.zeros((l,), dtype=torch.int32, device=device),
            irr=torch.zeros((l, 3), dtype=torch.float32, device=device),
            N=torch.zeros((l,), dtype=torch.int32, device=device),
        ),
        lc_updates_applied=torch.zeros((), dtype=torch.int64, device=device),
        lc_updates_merged=torch.zeros((), dtype=torch.int64, device=device),
    )
