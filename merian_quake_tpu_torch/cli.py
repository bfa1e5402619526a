"""Command-line entry point of the PyTorch + CUDA port.

Headless equivalent of the reference's app shell
(src/merian-quake.cpp --headless), as merian_quake_tpu/cli.py: render a
scene, run a preset, play the live game, compare images, run a frame
graph, certify the presets.

    python -m merian_quake_tpu_torch.cli render --scene box --size 640x360 \
        --spp 1 --frames 8 --out /tmp/out.png
    python -m merian_quake_tpu_torch.cli play --map bigmap --size 1920x1080 \
        --spp 2 --integrator mcpg --frames 60

``--device`` (default ``cuda``) takes the JAX package's ``--platform``
place: every command runs on the card unless it names ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
import time


def _size(text: str) -> tuple[int, int]:
    w, h = (int(v) for v in text.split("x"))
    return w, h


def _cmd_render(args) -> int:
    from .models.procedural import get_scene
    from .models.types import RenderConfig
    from .renderer import render_sequence
    from .utils.image import save_pfm, save_png

    w, h = _size(args.size)
    config = RenderConfig(
        width=w,
        height=h,
        spp=args.spp,
        max_path_length=args.max_path_length,
        seed=args.seed,
        integrator=args.integrator,
        denoise=args.denoise,
    )
    bundle = get_scene(args.scene, device=args.device)
    t0 = time.time()
    state, outputs = render_sequence(bundle, config, frames=args.frames, device=args.device)
    ldr = outputs["ldr"].cpu()
    dt = time.time() - t0
    print(
        f"rendered {args.frames} frames {w}x{h} spp={args.spp} "
        f"in {dt:.2f}s ({dt / max(args.frames, 1) * 1000:.1f} ms/frame avg, "
        f"incl. the first frame)"
    )
    if args.out.endswith(".pfm"):
        save_pfm(args.out, outputs["hdr"])
    else:
        save_png(args.out, ldr)
    print(f"wrote {args.out}")
    if args.debug is not None:
        uniforms = bundle.uniforms._replace(frame=max(args.frames - 1, 0))
        if args.integrator == "mcpg":
            from .render.mcpg import MCPGConfig
            from .render.mcpg.debug import DEBUG_VIEWS, render_mcpg_debug

            img = render_mcpg_debug(
                args.debug, uniforms, config, MCPGConfig(), state.mcpg,
                outputs["gbuffer"], outputs["irradiance"],
            )
        elif args.integrator == "restir":
            from .render.restir.debug import DEBUG_VIEWS, render_restir_debug

            img = render_restir_debug(args.debug, config, state.restir, outputs["gbuffer"])
        else:
            print("--debug requires --integrator mcpg or restir")
            return 2
        dbg_path = args.out.replace(".png", f"_debug{args.debug}.png")
        save_png(dbg_path, img.clamp(0.0, 1.0))
        print(f"wrote {dbg_path} ({DEBUG_VIEWS[args.debug]})")
    return 0


def _cmd_preset(args) -> int:
    from .presets import PRESETS, run_preset

    if args.name == "list":
        for name, pr in PRESETS.items():
            print(f"{name}: {pr.description}")
        return 0
    state, outputs, spf = run_preset(args.name, frames=args.frames, out=args.out,
                                     device=args.device)
    print(f"{args.name}: {spf * 1000:.1f} ms/frame (steady state)")
    if args.out:
        print(f"wrote {args.out}")
    return 0


def live_features(static_bundle):
    """The live game's SceneFeatures: the static map's, with the paths
    the dynamic entities add (alias skins with fullbrights, sprites,
    particles) forced on, as bench.py:198-201 does."""
    from .accel.build import scene_features

    return scene_features(
        static_bundle.scene, static_bundle.uniforms, static_bundle.atlas
    )._replace(has_alpha_tris=True, has_fb=True, has_emissive_tex=True)


def boot_live(map_name: str, device):
    """The live game and its incremental accel: (LiveGame, LiveAccel)."""
    from .accel.build import build_accel_live

    if map_name == "bigmap":
        from .game.bigmap import make_bigmap

        live, _ = make_bigmap(dynamic_capacity=4096, device=device)
    else:
        from .game.mod import make_arena

        live = make_arena(dynamic_capacity=1024, device=device)
    # the reference's per-frame BLAS refit: static tables built once,
    # per-frame work O(dynamic)
    la = build_accel_live(live.gs.static_bundle, dyn_cap=live.gs.dynamic_capacity,
                          device=device)
    return live, la


def _cmd_play(args) -> int:
    """Live-simulated game: game host + renderer + HUD, headless.

    The frame loop is the reference's main loop (merian-quake.cpp:
    273-275) with PNG frames standing in for the swapchain. Each frame
    refreshes the live accel in place, then runs the compiled frame (on
    the card one CUDA graph's replay, after the refresh on the same
    stream); a props patch that changes the config or re-inits the state,
    and a changelevel reboot, make a new compiled frame."""
    import numpy as np

    from .accel.build import refresh_dynamic
    from .game.hud import apply_hud
    from .models.types import RenderConfig
    from .renderer import compile_frame, init_state
    from .utils.image import save_png

    w, h = _size(args.size)
    live, la = boot_live(args.map, args.device)
    if args.load:
        live.host.load(args.load)
        print(f"loaded savegame {args.load} (t={live.host.time:.2f}s)")
    cfg = RenderConfig(
        width=w, height=h, spp=args.spp,
        max_path_length=args.max_path_length,
        integrator=args.integrator, denoise=args.denoise,
        features=live_features(live.gs.static_bundle),
    )
    mcfg = None
    state = init_state(cfg, device=args.device)
    step = None  # the compiled frame, made on the first frame to render
    mixer = None
    if args.wav:
        from .game.audio import AudioMixer

        mixer = AudioMixer()
    console = None
    if args.props or args.console:
        from .utils.props import PropertyConsole

        console = PropertyConsole(args.props, use_stdin=args.console)
    dt = 1.0 / 30.0
    t0 = time.time()
    out = None
    for i in range(args.frames):
        if console is not None:
            patches = console.poll()
            if patches:
                from .utils.props import apply_patches

                cfg, mcfg, reinit, unknown = apply_patches(cfg, mcfg, patches)
                for k in unknown:
                    print(f"[props] unknown key: {k}")
                applied = {k: v for k, v in patches.items() if k not in unknown}
                if applied:
                    print(f"[props] applied {applied}" + (" (state re-init)" if reinit else ""))
                    step = None
                if mcfg is None and cfg.integrator != "pt":
                    if cfg.integrator == "mcpg":
                        from .render.mcpg import MCPGConfig as _C
                    elif cfg.integrator == "restir":
                        from .render.restir import ReSTIRConfig as _C
                    else:
                        from .render.ssmm import SSMMConfig as _C
                    mcfg = _C()
                    reinit = True
                if reinit:
                    state = init_state(cfg, mcfg, device=args.device)
                    step = None
        # scripted input: wander toward the room center, then orbit
        yaw = 20.0 + 1.2 * i
        dyn, uniforms = live.step_dynamic(dt=dt, forward=180.0, yaw=yaw)
        if live.host.changelevel_target:
            # the reference's don't-render path (clear.comp + the
            # gbuffer CLEAR variant): while the game is between maps the
            # renderer emits cleared frames instead of stale geometry;
            # accumulation and history restart on the new worldspawn
            # (render_mcpg.cpp:221-241 zero-fill on reconnect)
            target = live.host.changelevel_target
            print(f"[game] changelevel → {target}: clear frame, reload")
            if args.save_all:
                save_png(args.out.replace(".png", f"_{i:04d}.png"),
                         np.zeros((h, w, 3), np.float32))
            live, la = boot_live(args.map, args.device)
            state = init_state(cfg, mcfg, device=args.device)
            step = None
            continue
        if mixer is not None:
            from .game.live import angle_vectors

            ps = live.host.player_state()
            _, right, _ = angle_vectors(ps.view_angles)
            mixer.frame(live.host.time, live.host.frame_sound_events(),
                        ps.origin + ps.view_ofs, right)
        la = refresh_dynamic(la, dyn)
        if step is None:
            step = compile_frame(la.accel, live.gs.static_bundle.atlas, cfg, state, mcfg)
        state, out = step(uniforms)
        for msg in live.messages:
            print(f"[game] {msg}")
        if args.save_all:
            ldr = apply_hud(out["ldr"], out["gbuffer"].linear_z, live.hud_state())
            save_png(args.out.replace(".png", f"_{i:04d}.png"), live.draw_overlays(ldr))
    dtime = time.time() - t0
    ldr = apply_hud(out["ldr"], out["gbuffer"].linear_z, live.hud_state())
    save_png(args.out, live.draw_overlays(ldr))
    ps = live.host.player_state()
    print(
        f"played {args.frames} frames {w}x{h} in {dtime:.2f}s "
        f"({dtime / max(args.frames, 1) * 1000:.1f} ms/frame incl. the first frame); "
        f"game time {live.host.time:.2f}s, player at "
        f"({ps.origin[0]:.0f}, {ps.origin[1]:.0f}, {ps.origin[2]:.0f}), "
        f"health {ps.health:.0f}"
    )
    print(f"wrote {args.out}")
    if mixer is not None:
        from .game.live import angle_vectors

        _, right, _ = angle_vectors(ps.view_angles)
        mixer.set_ambients(live.host.ambient_sounds())
        ns = mixer.write_wav(args.wav, duration=live.host.time,
                             listener=ps.origin + ps.view_ofs, right=right)
        print(f"wrote {args.wav} ({ns} samples, {len(mixer._voices)} voices)")
    if args.save:
        live.host.save(args.save)
        print(f"saved game to {args.save} (t={live.host.time:.2f}s)")
    return 0


def _cmd_error(args) -> int:
    import numpy as np

    from .utils.image import load_pfm, load_png
    from .utils.metrics import mae, relmse, rmse

    load = lambda p: (
        load_pfm(p) if p.endswith(".pfm") else load_png(p).astype(np.float32) / 255
    )
    img, ref = load(args.image), load(args.reference)
    print(
        f"rmse={rmse(img, ref):.6f} mae={mae(img, ref):.6f} "
        f"relmse={relmse(img, ref):.6f}"
    )
    return 0


def _cmd_graph(args) -> int:
    import os

    from .accel.build import build_accel, scene_features
    from .graph import Graph
    from .graph.nodes import GraphContext
    from .models.procedural import get_scene
    from .models.types import RenderConfig
    from .utils.image import save_png

    w, h = _size(args.size)
    bundle = get_scene(args.scene, device=args.device)
    config = RenderConfig(
        width=w, height=h, spp=args.spp,
        features=scene_features(bundle.scene, bundle.uniforms, bundle.atlas),
    )
    accel = build_accel(bundle.scene, bundle.atlas)
    ctx = GraphContext(accel=accel, atlas=bundle.atlas, config=config, device=args.device)
    # env override, like the reference's MERIAN_QUAKE_CONFIG_PATH
    # (configuration.hpp:8-31)
    cfg_path = os.environ.get("MQ_GRAPH_CONFIG", args.config)
    g = Graph.from_config(cfg_path, ctx)
    state = g.init_state()
    uniforms = bundle.uniforms
    out = None
    for i in range(args.frames):
        state, out = g.run(state, {"uniforms": uniforms._replace(frame=i)})
    save_png(args.out, out[(args.output_node, "out")])
    print(f"ran graph {cfg_path} for {args.frames} frames -> {args.out}")
    return 0


def _cmd_certify(args) -> int:
    import json

    from .utils.certify import certify_presets

    results = certify_presets(
        names=args.presets or None,
        scale=args.scale,
        frames=args.frames,
        ref_frames=args.ref_frames,
        ref_runs=args.ref_runs,
        realtime_frames=args.realtime_frames,
        out_path=args.out,
        convergence_dir=args.convergence_dir,
        device=args.device,
        equal_time=args.equal_time,
    )
    print(json.dumps(results, indent=2))
    print(f"wrote {args.out}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="merian-quake-tpu-torch")
    p.add_argument("--device", default="cuda",
                   help="torch device every command runs on (cuda, cuda:N or cpu)")
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("render", help="render a scene to an image")
    pr.add_argument("--scene", default="box", help="box | court | alcove | furnace | city")
    pr.add_argument("--size", default="640x360")
    pr.add_argument("--spp", type=int, default=1)
    pr.add_argument("--frames", type=int, default=1)
    pr.add_argument("--max-path-length", type=int, default=3)
    pr.add_argument("--integrator", default="pt", choices=["pt", "mcpg", "restir", "ssmm"])
    pr.add_argument("--denoise", action="store_true", help="SVGF+TAA+FXAA")
    pr.add_argument("--seed", type=int, default=1337)
    pr.add_argument(
        "--debug", type=int, default=None, metavar="N",
        help="also write a debug view PNG: mcpg 0-8 (mcpg.comp:212-277), "
             "restir 0-4 (reservoir state)",
    )
    pr.add_argument("--out", default="/tmp/mq_torch_render.png")
    pr.set_defaults(fn=_cmd_render)
    pp = sub.add_parser("preset", help="run a tracked benchmark config")
    pp.add_argument("name", help="config1..config6 or 'list'")
    pp.add_argument("--frames", type=int, default=None)
    pp.add_argument("--out", default=None)
    pp.set_defaults(fn=_cmd_preset)

    pg = sub.add_parser("graph", help="run a JSON-configured frame graph")
    pg.add_argument("--config", default="res/default_graph.json",
                    help="res/default_graph.json (flagship MCPG+SVGF "
                         "pipeline) or res/pt_graph.json (plain PT)")
    pg.add_argument("--scene", default="box")
    pg.add_argument("--size", default="320x180")
    pg.add_argument("--spp", type=int, default=1)
    pg.add_argument("--frames", type=int, default=8)
    pg.add_argument("--output-node", default="hud")
    pg.add_argument("--out", default="/tmp/mq_torch_graph.png")
    pg.set_defaults(fn=_cmd_graph)

    pl = sub.add_parser("play", help="run the live-simulated game and render it")
    pl.add_argument("--size", default="320x180")
    pl.add_argument(
        "--map", default="arena", choices=["arena", "bigmap"],
        help="arena (cornell-box mod) or bigmap (AD-scale dungeon, "
             "~290k tris, wandering monsters)",
    )
    pl.add_argument("--spp", type=int, default=1)
    pl.add_argument("--frames", type=int, default=60)
    pl.add_argument("--max-path-length", type=int, default=3)
    pl.add_argument("--integrator", default="pt", choices=["pt", "mcpg", "restir", "ssmm"])
    pl.add_argument("--denoise", action="store_true")
    pl.add_argument("--save-all", action="store_true", help="write every frame's PNG")
    pl.add_argument("--save", default=None, metavar="FILE",
                    help="write a savegame after the run (Host_Savegame)")
    pl.add_argument("--load", default=None, metavar="FILE",
                    help="restore a savegame before the run (Host_Loadgame)")
    pl.add_argument("--wav", default=None, metavar="FILE",
                    help="mix the run's sound events into a stereo WAV "
                         "(the reference's SNDDMA audio seam, headless)")
    pl.add_argument("--props", default=None, metavar="FILE",
                    help="watch a JSON property-patch file and apply "
                         "changes between frames (live editing, "
                         "configuration.hpp:30-39 headlessly)")
    pl.add_argument("--console", action="store_true",
                    help="accept 'set <key> <json>' lines on stdin")
    pl.add_argument("--out", default="/tmp/mq_torch_play.png")
    pl.set_defaults(fn=_cmd_play)

    pe = sub.add_parser("error", help="compare an image against a reference")
    pe.add_argument("image")
    pe.add_argument("reference")
    pe.set_defaults(fn=_cmd_error)

    pc = sub.add_parser("certify",
                        help="relMSE certification of the tracked presets vs converged PT")
    pc.add_argument("--presets", nargs="*", default=None)
    pc.add_argument("--scale", type=float, default=0.25)
    pc.add_argument("--frames", type=int, default=64)
    pc.add_argument("--ref-frames", type=int, default=256)
    pc.add_argument("--ref-runs", type=int, default=4,
                    help="independent truth runs averaged (combine_images.py workflow)")
    pc.add_argument("--realtime-frames", type=int, default=8,
                    help="candidate budget for the real-time reuse estimators (ReSTIR/SSMM)")
    pc.add_argument("--equal-time", action="store_true",
                    help="add each integrator's ms/frame and the reference's relMSE at equal time")
    pc.add_argument("--out", default="CERT_relmse_torch.json")
    pc.add_argument("--convergence-dir", default=None,
                    help="also write per-preset power-of-2 relMSE "
                         "convergence CSVs (error_plot.py workflow)")
    pc.set_defaults(fn=_cmd_certify)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
