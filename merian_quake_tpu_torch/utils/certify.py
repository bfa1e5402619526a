"""Automated relMSE certification for the tracked preset configs.

Port of merian_quake_tpu/utils/certify.py. The north-star quality target
(BASELINE.md) is relMSE at equal spp within 5% of the Vulkan reference
on its benchmark scenes. The Vulkan implementation cannot run here, so
the tracked certification is against a CONVERGED unguided ground truth
(the reference's own golden-image workflow: REFERENCE_MODE renders
averaged over independent runs, scripts/combine_images.py +
error_plot.py:27-60):

- ground truth: plain unidirectional transport accumulated for
  ``ref_frames`` frames, AVERAGED over ``ref_runs`` independent runs
  (disjoint RNG streams via frame-index offsets 1,000,000·(r + 1));
- fog-aware: presets with a volume term use the UNGUIDED mcpg
  integrator as truth (surf_bsdf_p = 1.0 is structurally identical to
  PT, and the volume pass with dist_guide_p = 0 / volume_phase_p = 1 is
  pure phase-sampled transmittance single scattering, unbiased), so the
  volume term IS certified instead of excluded;
- candidate: the preset's integrator accumulated for ``frames`` frames
  (equal sample budget as an unguided run with the same ``frames``);
- reported per preset: absolute relMSE, the equal-budget PT relMSE, and
  their ratio (guided integrators should be ≤ 1 in guiding-bound scenes
  — config6 is the tracked guiding-bound preset; a ratio creeping above
  ~1.05 on diffuse-dominated scenes is the regression signal the 5%
  target encodes).

Scenes are static (error measurement needs a fixed view), resolutions
scaled by ``scale``. Everything renders on ``device``; the images come
back to the host for the metrics.

``equal_time=True`` (the port's measurement of the guided image's noise
at equal cost) adds to each row the steady ms/frame of the candidate and
of its reference integrator (host clock, each frame ended by a device
sync) and the reference accumulated for as many frames as the
candidate's time buys, with its relMSE and the ratio at equal time.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from .metrics import relmse, relmse_trimmed


def _unguided_config(cfg, integ_config):
    """The REFERENCE_MODE equivalent: same transport, no guiding."""
    if integ_config is not None and getattr(integ_config, "volume", None) is not None:
        from ..render.mcpg import MCPGConfig

        vol = integ_config.volume._replace(
            dist_guide_p=0.0,
            volume_phase_p=1.0,
            volume_use_light_cache=False,
        )
        ref_integ = MCPGConfig(
            mc_adaptive_size=1 << 10,  # inert (never sampled at sbp=1)
            mc_static_size=1 << 8,
            lc_size=1 << 8,
            surf_bsdf_p=1.0,
            surf_bsdf_trust_n=0,
            use_light_cache_tail=False,
            volume=vol,
        )
        return cfg._replace(integrator="mcpg"), ref_integ
    return cfg._replace(integrator="pt"), None


def _run(bundle, config, integ_config, frames, frame_offset=0,
         snapshots=None, steady_skip=0, device="cuda", times=None):
    """Accumulated beauty INCLUDING the volume term (fog-aware truth:
    both sides estimate the same transport), as a host array.

    ``snapshots``: optional sorted list of frame counts at which to also
    record the accumulated image (the reference's power-of-2 ImageWrite
    trigger) — returns (final, {count: image}) instead of just final.

    ``steady_skip``: restart ACCUMULATION (not the integrator state) at
    this frame index — the steady-state window for temporal-reuse
    integrators: the reported image averages frames [steady_skip,
    frames) only, with reservoirs / chains already at steady state.

    ``times``: a list that gets each frame's host ms, the frame ended
    by a device sync (None: no sync, no timing)."""
    from ..accel.build import build_accel
    from ..renderer import init_state, render_frame

    sync = times is not None and torch.device(device).type == "cuda"
    accel = build_accel(bundle.scene, bundle.atlas, device=device)
    state = init_state(config, integ_config, device=device)
    uniforms = bundle.uniforms
    outputs = None
    snaps = {}
    for i in range(frames):
        if steady_skip and i == steady_skip:
            state = state._replace(
                accum_irradiance=torch.zeros_like(state.accum_irradiance),
                accum_direct=torch.zeros_like(state.accum_direct),
                accum_albedo=torch.zeros_like(state.accum_albedo),
                iteration=torch.zeros_like(state.iteration),
            )
        uniforms = uniforms._replace(frame=frame_offset + i)
        t0 = time.perf_counter()
        state, outputs = render_frame(
            accel, bundle.atlas, uniforms, config, state, integ_config
        )
        if times is not None:
            if sync:
                torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
        if snapshots and (i + 1) in snapshots:
            snaps[i + 1] = outputs["hdr"].cpu().numpy()
    final = outputs["hdr"].cpu().numpy()
    if snapshots:
        return final, snaps
    return final


def _steady_ms(times) -> float:
    """Mean frame ms after the cold frame."""
    return float(np.mean(times[1:] if len(times) > 1 else times))


def certify_presets(
    names=None,
    scale: float = 0.25,
    frames: int = 64,
    ref_frames: int = 256,
    ref_runs: int = 4,
    realtime_frames: int = 8,
    out_path: str | None = None,
    convergence_dir: str | None = None,
    steady_skip: int = 16,
    device="cuda",
    equal_time: bool = False,
) -> dict:
    """Returns {preset: {relmse, relmse_pt_equal_budget, ratio, ...}}.

    ``realtime_frames``: candidate budget for the REAL-TIME reuse
    estimators (ReSTIR/SSMM) when ``steady_skip`` is 0. Their
    temporal/spatial reuse trades a bias floor for massive low-sample
    variance reduction — evaluating them at a long-accumulation budget
    measures the bias floor, not the regime they exist for.

    ``steady_skip``: the preferred temporal regime — reuse integrators
    run the FULL ``frames`` budget but the accumulated measurement
    restarts at this frame (both for the candidate and its equal-budget
    PT baseline), so reservoir M-clamp bias, boiling filtering and SSMM
    chain maturity are measured at steady state rather than mixed with
    the cold-start transient. Unbiased integrators (PT, MCPG) certify at
    the full ``frames`` budget from frame 0 either way.

    ``equal_time``: see the module docstring (extra keys)."""
    from ..accel.build import scene_features
    from ..presets import PRESETS

    names = list(PRESETS) if names is None else list(names)
    results = {}
    for name in names:
        p = PRESETS[name]
        is_reuse = p.config.integrator in ("restir", "ssmm")
        p_frames = (
            frames
            if (steady_skip or not is_reuse)
            else realtime_frames
        )
        p_skip = steady_skip if is_reuse else 0
        W = max(int(p.config.width * scale) // 8 * 8, 16)
        H = max(int(p.config.height * scale) // 8 * 8, 16)
        bundle = p.make_bundle(device=device)
        cfg = p.config._replace(
            width=W,
            height=H,
            denoise=False,
            features=scene_features(
                bundle.scene, bundle.uniforms, bundle.atlas
            ),
        )
        ref_cfg, ref_integ = _unguided_config(cfg, p.integ_config)
        t_ref = [] if equal_time else None
        t_test = [] if equal_time else None
        # multi-run averaged ground truth (combine_images.py workflow):
        # disjoint RNG streams via frame offsets, averaged
        truth = np.zeros((H, W, 3), np.float32)
        for r in range(ref_runs):
            truth += _run(
                bundle, ref_cfg, ref_integ, ref_frames,
                frame_offset=1_000_000 * (r + 1), device=device,
                times=t_ref if r == 0 else None,
            ) / ref_runs
        if convergence_dir:
            # power-of-2 convergence series (error_plot.py:27-60
            # workflow): relMSE of the accumulated estimate vs truth
            snap_at = [f for f in (1, 2, 4, 8, 16, 32, 64, 128, 256)
                       if f <= p_frames]
            test, snaps = _run(
                bundle, cfg, p.integ_config, p_frames, snapshots=snap_at,
                steady_skip=p_skip, device=device, times=t_test,
            )
        else:
            test = _run(
                bundle, cfg, p.integ_config, p_frames, steady_skip=p_skip,
                device=device, times=t_test,
            )
        pt_eq = (
            test
            if cfg.integrator == "pt"
            else _run(
                bundle, ref_cfg, ref_integ, p_frames, steady_skip=p_skip,
                device=device,
            )
        )
        e_test = float(relmse(test, truth))
        e_pt = float(relmse(pt_eq, truth))
        t_test_r = float(relmse_trimmed(test, truth))
        t_pt = float(relmse_trimmed(pt_eq, truth))
        results[name] = {
            "integrator": cfg.integrator,
            "resolution": f"{W}x{H}",
            "spp": cfg.spp,
            "frames": p_frames,
            "steady_skip": p_skip,
            "ref_frames": ref_frames,
            "ref_runs": ref_runs,
            "volume_included": ref_integ is not None,
            "relmse": e_test,
            "relmse_pt_equal_budget": e_pt,
            "ratio_vs_pt": e_test / max(e_pt, 1e-12),
            # the plain mean is dominated by low-pdf fireflies at modest
            # budgets — the 0.1%-trimmed statistic tracks bulk convergence
            "relmse_trimmed": t_test_r,
            "relmse_trimmed_pt": t_pt,
            "ratio_trimmed_vs_pt": t_test_r / max(t_pt, 1e-12),
            "target": "within 5% of the Vulkan reference at equal spp "
                      "(BASELINE.md); tracked proxies: ratio_vs_pt, "
                      "ratio_trimmed_vs_pt",
        }
        if equal_time:
            ms_test, ms_ref = _steady_ms(t_test), _steady_ms(t_ref)
            window = p_frames - p_skip
            n_eq = max(int(round(window * ms_test / ms_ref)), 1)
            pt_time = (
                pt_eq
                if cfg.integrator == "pt"
                else _run(
                    bundle, ref_cfg, ref_integ, p_skip + n_eq,
                    steady_skip=p_skip, device=device,
                )
            )
            e_time = float(relmse(pt_time, truth))
            results[name].update({
                "ms_per_frame": ms_test,
                "ref_ms_per_frame": ms_ref,
                "pt_equal_time_frames": window if cfg.integrator == "pt" else n_eq,
                "relmse_pt_equal_time": e_time,
                "ratio_vs_pt_equal_time": e_test / max(e_time, 1e-12),
            })
        if convergence_dir:
            import os

            os.makedirs(convergence_dir, exist_ok=True)
            path = os.path.join(convergence_dir, f"{name}_convergence.csv")
            with open(path, "w") as f:
                f.write("frames,relmse,relmse_trimmed\n")
                for fr in sorted(snaps):
                    f.write(
                        f"{fr},{relmse(snaps[fr], truth):.6g},"
                        f"{relmse_trimmed(snaps[fr], truth):.6g}\n"
                    )
            results[name]["convergence_csv"] = path
    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)
    return results
