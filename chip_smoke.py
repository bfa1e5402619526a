#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Drives merian_quake_tpu_torch's paths at 1920×1080 — the guided
(MCPG) frame (2 spp, max path length 3, ``MCPGConfig()``; with the
volume pass, ``VolumeConfig()`` and ``production_config()``), the
path-traced frame (2 spp, max path length 3), the ReSTIR DI frame
(``ReSTIRConfig()``) and the SSMM frame (``SSMMConfig()``), each also
with ``denoise=True`` (SVGF, exposure, tonemap, TAA, FXAA; with the
volume pass a second SVGF on the volume's history), the presets, their
certification, the frame graph and the debug views — on the first CUDA
device, on the procedural
``city`` (16,640 triangles), on the map scene ``city(n_buildings=
28000, seed=11)`` (281,536 triangles), on ``outdoor_court`` (two
alpha-tested grates; fogged for the volume pass) and, under the trace
schedules (``woop.TraceSchedule``), on ``city(n_buildings=1600)``
(16,128 triangles in 252 clusters, so that the target key applies), after
building and checking their hand-written kernels: K1
(csrc/woop_nearest.cu, nearest hit), K2 (csrc/woop_any.cu, any hit), K3
(csrc/woop_stream.cu, both for tables above 65,536 triangles), K4 and K5
(csrc/woop_keys.cu, target keys, block union entries and the visit list
they make with its row sort), the list
walker K6/K7 (csrc/woop_list.cu, node walk and compacted visits) and K8
(csrc/mt_dense.cu, the dense Möller–Trumbore sweep of
``accel.dense.intersect_dense``). Phases, one line each or more:

1. device: the card's name and power limit (nvidia-smi), and the time to
   build the six kernel sources with nvcc for sm_90a (all started
   together), with each kernel's ptxas lines;
2. K1 against its plain PyTorch version on the card, bit for bit: a
   random soup with half misses, the same with one or two live rays a
   warp (every tile visit compacted) and a hand-laid table with exact
   ties between the triangles a compacted visit compares; 65,536-ray
   subsets of city's 1080p primary rays, of one bounce population as it
   lies (what a frame launches K1 on) and of the same sorted for
   coherence (t_min = 0 and 1e-3); then the whole 2,073,600-ray primary,
   sorted bounce (t_min = 0 and 1e-3) and unsorted bounce populations,
   with K1 timed by CUDA events at t_min = 0 (twice) beside the one
   run of the plain version that it is held against, K1's
   bound from its count of the pairs it tested, where its cycles go (the
   profile instance: list, the gates that look for the next tile, a
   tile's issue and second gate, tile waits, pair loops), its lane use
   and the CTAs that fit an SM, beside the first design's recorded
   readings;
3. the slice: 6 frames on the card, K1 launched exactly 5 times a frame,
   finite outputs, cold and steady ms/frame and Mrays/s;
4. the same frames at 64×36 on the CPU (Möller–Trumbore oracle) and on
   the card (K1): the LDR images agree within the slice test's tolerance;
5. K2 against its plain PyTorch version on the card, equal on every ray:
   a random soup with half misses and a per-ray t_max; a soup with a sky
   wall in front of an opaque one; a 65,536-ray subset and the whole
   2,073,600-ray population of city's 1080p shade-pass shadow rays
   (gbuffer points to frame-0 reservoir samples) on the proxy table, on
   the shadow table, and on the shadow table warm-started by the proxy
   pre-pass; K2 on the shadow table (as the frames launch it) and the
   plain version timed with CUDA events in turns, beside the first
   design's recorded reading, the bound from K2's own count of the pairs
   it tested, and its split by phase, lane use and CTAs an SM as in phase
   2; F4: one visibility trace without the proxy pre-pass and with it, in
   turns, equal on every ray; then ``trace_visibility`` on the card (K2 +
   the alpha table through K1) against the CPU oracle on a small
   alpha-grate soup;
6. the ReSTIR slice: 6 frames on the card, exactly 2 K1 and 1 K2
   launches a frame, finite outputs and reservoirs, the largest
   reservoir M above 1 by frame 6, cold and steady ms/frame; F4 on
   frames: 8 frames without the proxy pre-pass (the card's route) and 8
   with it (``with_prepass``), in turns, the same images;
7. 3 ReSTIR frames at 64×36 on the CPU (oracle) and on the card (K1 +
   K2), with defaults and with both bias corrections set to 2 (so that
   all three visibility call sites launch K2): the LDR images agree
   within the slice test's tolerance;
8. K3 against its plain versions on the card, bit for bit: a random soup
   (nearest and any-hit), also with sparse warps, and the tie table;
   65,536-ray subsets of the map's 1080p primary, bounce as it lies,
   sorted bounce (t_min 0 and 1e-3) and shade-pass shadow rays (with and
   without the proxy pre-pass's warm start); then K3 against K1/K2 called
   directly on the same table on the whole 2,073,600-ray populations;
   K2's proxy pre-pass on the map (4,096 triangles, as the map ReSTIR
   frame launches it) against its plain version on the subset and the
   whole population; F4 on the map: one visibility trace without the
   pre-pass (K3 any-hit) and with it (K2 proxy + K3), in turns, equal on
   every ray; K3, K1/K2 and the plain version timed with CUDA
   events in turns, the bound from K3's own count of the pairs it
   tested, and its split by phase, lane use and CTAs an SM as in phase 2;
   K3 any-hit on the whole table on a 65,536-ray map primary subset;
9. K8 against the oracle (``accel.intersect._intersect_oracle``) on CUDA
   tensors, bit for bit in (t, tri, u, v): the random soup and a
   65,536-ray map subset, driven through ``intersect_dense`` (the dense
   path); K8 against K3 there; K8 and K3 timed in turns, beside the first
   design's recorded reading, the bound of every pair's operations and
   the bound of the operations these inputs need (K8's counts of the
   pairs past each pre-test);
10. 6 PT and 6 ReSTIR frames of the map at 1080p: exactly 5 K3 launches
    and no K1 a PT frame, 2 K3 nearest + 1 K3 any-hit and no K1 or K2 a
    ReSTIR frame; finite outputs, cold and steady ms/frame; F4's ReSTIR
    frames without and with the pre-pass, in turns;
11. 2 PT and 2 ReSTIR frames of the map at 32×18 on the CPU (oracle) and
    on the card (K3 + K2; ``render_sequence`` called without ``device=``,
    whose default is the card): the LDR images agree within the slice test's
    tolerance (at 64×36 the CPU oracle took 61 s for the PT frames alone
    on the card's host, so the size is a quarter of phase 4's);
12. K4, K5 and the fused visit list against their plain versions on the
    card, bit for bit: the random soup, 65,536-ray subsets of
    city(1600)'s 1080p primary, bounce and target-sorted bounce rays, the
    whole 2,073,600-ray target-sorted bounce population, and edge-case
    boxes (empty, inverted, NaN and flat boxes at 3 to 1,024; +-0
    directions, NaN origins, infinite, zero, negative and NaN limits, a
    dead warp and a dead block); K4 and its counting instance, K5 on
    cluster boxes and on node boxes of 8 clusters in the JAX package's
    mode and in the walker's, the visit list (te_s and order) on both;
    times in turns with the plain versions (CUDA events), the list's
    against K5 + torch's row sort; bounds at 24 and 18 operations a slab,
    K4's also at the slabs its counting instance computed;
13. the walker (the walk's block-list instance) against its plain
    versions, bit for bit (nearest) and on every ray (any-hit): P = 1 (on
    target-sorted rays), 8 and 16 with compact 0 and 32, P = 32, (64, 32)
    and 128 (the sub-node level); any-hit P = 1, 8, 16, 32, 64 and 128 with
    and without the proxy pre-pass's warm start; the soup, the subsets and
    the whole populations; the 4,147,200 guided rays of an MCPG bounce
    segment on city(1600) under ``TraceSchedule(True, 8, 32)`` (against the
    plain version on a subset, K1 on all); its counts (pairs tested, tile
    visits, compacted visits, which must be > 0 where it compacts), its
    profile (cycle shares, lane use), CTAs an SM, and its time against
    K1/K2 on the same rays with the bound at its own and at the fewest
    pairs; F4 under ``TraceSchedule(node_clusters=8)``: one visibility
    trace without and with the pre-pass, in turns, equal on every ray;
14. 6 frames at 1080p on city(1600) for each schedule and for the
    default routes (the yardstick), with exact launch counts a frame: PT
    5 K1; ReSTIR 2 K1 + 1 K2; PT ``TraceSchedule(target_key=True)`` 1 K1,
    4 K4, 4 visit lists, 4 walks (P = 1); PT ``TraceSchedule(True, 8, 32)``
    4 K4, 5 visit lists, 5 walks at P = 8 with compaction, no K1; ReSTIR
    ``TraceSchedule(node_clusters=8)`` 3 visit lists, 2 nearest and 1 any-hit walks
    at P = 8, no K1 or K2; each schedule's LDR against the
    default routes' (bit-identical or not, and within the slice test's
    tolerance); cold and steady ms/frame; F4's frames of both ReSTIR runs
    without and with the pre-pass, in turns;
15. 2 PT and 2 ReSTIR frames of city(1600) at 32×18 on the CPU (oracle)
    and on the card under ``TraceSchedule(True, 8, 32)``: the LDR images
    agree within the slice test's tolerance;
16. city MCPG at 1080p: 16 frames from an empty state, exactly 3 K1
    launches a frame (1 primary of 2,073,600 rays, 2 bounce segments of
    4,147,200) and no other kernel; finite images, accumulators, chain
    states and light cache; the states with sum_w > 0 and
    ``lc_updates_applied`` rise from 0, printed per frame; cold ms and the
    mean of frames 12-15 with Mrays/s; one more frame under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host read in a steady
    frame); the bounce coherence sort A/B on 8 further frames; 6 frames
    each of city(1600) with the default routes and under
    ``TraceSchedule(True, 8, 32)`` (2 K4 + 3 visit lists + 3 compacting node walks);
17. map MCPG at 1080p: 9 frames, exactly 3 K3 launches a frame and no K1,
    the same checks, the mean of frames 6-8;
18. K1 (city) and K3 (map) on the 4,147,200 rays of one guided bounce
    segment of a warmed frame (vMF lobes aimed at lights): bit for bit
    against the plain version on a 65,536-ray subset and against the
    other route, forced, on the whole population; time in turns, pairs
    tested, bound, lane use;
19. MCPG at 64×36 on the CPU (oracle) and on the card: frame 0 within
    the slice test's tolerance; after 4 frames the LDR mean difference,
    the live chain states and the touched light-cache cells within
    pinned bounds; then 64 accumulated frames of ``mcpg`` and of ``pt``
    on the card agree in mean irradiance (guiding is unbiased);
20. the court at 1080p: 6 PT, 6 ReSTIR and 6 MCPG frames; every frame's
    K1 launches equal its ``intersect`` calls (each alpha re-trace round
    is one; K2 on ReSTIR's visibility), the alpha loops' rounds and host
    reads counted and timed (CUDA events and the host clock around each
    loop), one more frame's synchronizing calls counted
    (``set_sync_debug_mode("warn")``); 64×36 CPU against card;
21. the fogged court (``fog_mu_t`` 0.002), MCPG + ``VolumeConfig()``, at
    1080p: 9 frames as phase 20's, cold and frames 6-8 with Mrays/s
    counting the volume rays, the distance-MC states with sum_w > 0 per
    frame; K1 on the volume pass's 2,073,600 scatter rays as phase 18
    holds K1 on the guided rays; 4 frames at 64×36 on the CPU against the
    card within tests/test_torch_volume_slice.py's bounds;
22. ``production_config()`` on city at 1080p: two settle frames, then 9
    from an empty state with exactly 3 + volume_spp K1 launches a frame,
    the cold frame and frames 6-8 (bench.py's window), peak device
    memory, one ``pack_states_draw`` of the 33.6M-row table, and a
    steady frame under ``torch.cuda.set_sync_debug_mode("error")``;
23. the denoised main path: city MCPG at 1080p with ``denoise=True``, 16
    frames, exactly 3 K1 launches a frame, finite images and denoiser
    histories, frames 12-15 beside phase 16's undenoised frames, the
    denoise chain's device ms by stage (CUDA events: each SVGF instance,
    its temporal pass and its à-trous passes, exposure + tonemap, TAA,
    FXAA), one more frame under ``set_sync_debug_mode("error")``;
    config3's render setup (ReSTIR with 2 spatial iterations and basic
    temporal bias correction, 1 spp, denoise, cornell_box): 8 frames, 2
    K1 + 1 K2 a frame; the chain on identical seeded 256×144 inputs on
    the CPU and the card within tests/test_torch_post.py's tolerance; 3
    denoised PT frames of cornell_box at 64×36 on the CPU against the
    card (LDR within tests/test_torch_denoise_slice.py's bound, HDR
    printed: the two traces round the history's validity apart);
24. the second SVGF: the fogged court, MCPG + ``VolumeConfig(volume_spp=
    1)``, denoise, 1080p, 9 frames as phase 20's (config5's render setup,
    still camera), both SVGF instances timed; 3 frames at 64×36 on the
    CPU against the card (LDR and the volume image within
    tests/test_torch_denoise_volume.py's bounds);
25. SSMM: city at 1080p, 2 spp, 10 frames, exactly 1 + spp K1 launches a
    frame; the court at 1080p, 1 spp, denoise, 8 frames as phase 20's
    (config4's render setup, still camera); cornell_box at 64×36 and at
    256×8 (tiled buffer order, where SSMM's lane-shuffle roll differs
    from one over the image) on the CPU against the card (the raw
    irradiance within tests/test_torch_ssmm_slice.py's spread bound; the
    denoised frame's images printed), and 64 accumulated SSMM frames on
    the card within 15% of PT's mean irradiance (tests/test_ssmm.py's
    check);
26. presets and certification: ``run_preset`` for config1 and config6 at
    their 640x360 and config3 at 1080p, each for its preset's frames,
    with the launches those frames make (config1 and config6 3 K1 a
    frame, config3 2 K1 + 1 K2) and ms/frame; ``certify_presets`` of
    config1 and config6 at their named 640x360 with certify's default
    budgets (64 frames, 4 truth runs of 256), every frame's 3 K1 counted:
    config1's ratio exactly 1, config6's (the guiding-bound preset) below
    1, every relMSE finite, each convergence series lower at 64 frames than
    at 1;
27. the frame graph at 1080p: res/pt_graph.json on city against
    ``frame_core`` (6 frames, 5 K1 a frame, the tonemap output within
    tests/test_graph.py's 1e-5); ``flagship_graph_config()`` on the fogged
    court with config5's render setup (MCPG + ``VolumeConfig(volume_spp=
    1)``, 2 spp, denoise, still camera) against ``frame_core`` (9
    frames): the same K1 launches and the same synchronizing calls a frame
    (the alpha loop's reads), and in the default mode the HUD and add
    outputs and both SVGF histories bit for bit (the MCPG replay's scan
    repeats itself since F7's repair); the
    flagship on city (MCPG, denoise) with a steady frame under
    ``set_sync_debug_mode("error")``; each path's ms/frame beside
    ``frame_core``'s;
28. debug views: the 9 MCPG views on phase 16's 1080p city state and the 5
    ReSTIR views on phase 6's, finite, (1080, 1920, 3), with ms a view;
    64x36 states made on the CPU and moved to the card: view 3 and its
    cell keys bit for bit, the others within rtol 1e-5; a ``Profiler``
    device span around one 1080p MCPG frame;
29. F7: two ``frame_core`` runs of 6 city MCPG frames from one state are
    bit-equal in the default mode (the guiding table, the light cache,
    the images), beside two runs with the parent's ``torch.cumsum`` in
    the replay's segment sums; the parent's scan against the repair
    (``ops/segments.py::scan_rows``), frames in turns (parent, change,
    change, parent), on city MCPG and the fogged court with the volume
    pass: the repair's cost a frame;
30. the live dungeon at full width: the game host library built with g++
    from native/game (seconds), ``make_bigmap()`` at its defaults (grid
    8, 32 monsters, dynamic capacity 4,096) and ``build_accel_live``
    (static triangles, seconds), 10 frames of the slice's path
    (``step_dynamic``, ``refresh_dynamic``, ``render_frame`` MCPG at
    1080p, 2 spp, mpl 3, the entities' features forced on): frames 5-7's
    step, refresh and render ms, bench.py's live ms/frame of 3 timed
    frames, K3 launches and host reads a frame (only the alpha loop's),
    the bytes the refresh copies, peak bytes; finite outputs, entities
    drawn;
31. the refresh against fresh tables on the card, after those moving
    steps: K3 and its any-hit form on the dungeon's refreshed tables
    bit-equal to their plain versions on 65,536-ray subsets of the frame's
    primary and bounce rays and on rays aimed at the monsters; every
    table's packed rows, padded bounds and walk boxes equal to a fresh
    computation; the hits of a from-scratch ``build_accel`` of the same
    frame's full scene (hit/miss, t); the same on the live arena for K1
    and K2, after 6 live frames each of MCPG (K1) and ReSTIR (K1 + K2) at
    1080p; a refresh that leaves the packed rows as they were (the
    mutant) fails the K3 check;
32. the live dungeon at grid 3, 4 monsters, after 3 steps, on the CPU and
    on the card: PT (mpl 2) and MCPG frames at 64x40, LDR within the
    slice test's tolerance;
33. ``run_preset`` for the orbit presets config2, config4 and config5 at
    their named sizes and frames, with ms/frame and launches;
34. ``python -m merian_quake_tpu_torch.cli play --map bigmap --frames 3``
    at 1080p MCPG in a subprocess on the card: it writes its PNG.
35. the native accel builder (``utils/native.py``: g++ builds
    native/mq_native.cc in phase 1, seconds printed there; every
    ``build_accel`` of the run uses it): ``build_accel`` native against
    numpy on city and on the map (seconds, every table bit for bit, the
    Woop rows' largest difference); K1 (city) and K3 (map) on the
    native-built tables bit-equal to their plain versions on 65,536
    primary rays; city in Morton order (``cluster="morton"``) renders
    finite 1080p PT frames;
36. a room written as a .bsp (``room_bsp``, here: the port has no BSP
    writer) into a .pak, read back through ``PakFile``, ``load_bsp``,
    ``scene_from_bsp`` (on the card, its default) and ``build_accel``:
    1080p PT frames through K1; 64x40 frames on the CPU and on the card:
    the direct-light frames' LDR and HDR within the slice test's
    tolerance, the full frames' HDR within it where the first hit's
    albedo agrees, the rest (texel-border hits under nearest sampling)
    at most 1% of the pixels;
37. row slabs (parallel/render.py): ``dryrun_multichip(3)`` on the card,
    then the city frames of three gloo ranks sharing the one card, each a
    360-row slab (which tiles): MCPG 4 frames at ``MCPGConfig()`` and at
    queue capacities three times as large (each slab's share then equals
    the default whole), ReSTIR and denoised PT one frame each, with
    launches a rank a frame, ms/frame a rank (three ranks sharing one
    H100: not a multi-GPU time), the bytes gathered beside
    ``queue_gather_bytes`` and each slab's live queue rows beside its
    share of the capacities; the stitched images and the guiding state
    against the single-device ``frame_core`` on the card within
    tests/test_parallel.py's tolerances, the replicas bit-equal. A slab
    keeps capacity / 3 rows of each queue, as in the JAX package: where a
    slab's live rows pass that (the default capacities at 1080p), its
    guiding learns from other rows than one device's, and only frame 0,
    before any guided draw, is held; the wide capacities must not
    overflow and are held on every frame;
38. the frame captured in one CUDA graph (``renderer.compile_frame``;
    ``Graph.compile`` for the flagship graph): city MCPG at 1080p (the
    main path), the fogged court's MCPG + volume (the alpha loop's test on
    the device: all 5 rounds), city ReSTIR (K2), denoised city MCPG, map
    MCPG (K3), config1's PT box at 640x360 (a small, launch-bound frame)
    and the flagship graph on the fogged court, each from an empty state
    for 9 frames (frame 0's call warms up, captures and
    replays; then 8 replays), every frame's state and outputs bit for bit
    against eager ``frame_core`` (or ``Graph.run``) from the same state,
    with eager and captured ms/frame (host clock, synced a frame), the
    capture's seconds, the graph's pool bytes, the device's busy share
    of each (torch.profiler, over at least 250 ms of frames) and the K1/K2/K3 launches in
    the graph; then what one alpha round costs once every ray is dead.
    ``render_sequence`` runs the captured frame on the card too, so the
    launch counts around it (phases 7 and 19) are the capture's: its
    warm-up frames and the capture itself.

Each path (PT city, ReSTIR city, dense map, PT map, ReSTIR map, the five
city(1600) frame runs of phase 14, MCPG city, MCPG map, the two
city(1600) MCPG runs of phase 16, court PT, ReSTIR and MCPG, the fogged
court's MCPG + volume, production city, denoised city MCPG, config3's
denoised ReSTIR box, the denoised fogged court, SSMM city, the denoised
SSMM court, the three presets run, the two certifications, the three
graph runs, the live dungeon, the live arena's MCPG and ReSTIR frames and
the three orbit presets, the Morton city, the .bsp room, the sharded
MCPG, ReSTIR and denoised PT frames, counted in each rank, and the six
captured frames of phase 38, whose counts are the warm-up frames' and
the capture's: a replay launches the graph, not the wrappers) is driven
with every launch count set to 0 just before it and read just after. The whole run's
seconds are printed before the kernels' line. The line before the
last is the kernels' JSON record (with each kernel's launches by path
and its bound: the larger of the bytes it must
move over 3.35 TB/s and its FP32 operations over the card's issue rate
for them, from the H100 SXM's data-sheet rates); the last line is
{"ok": true, "device": {...}}.
Any failure raises before it. Without a CUDA device the script fails at
once and prints no result.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_SOURCE = "merian_quake_tpu_torch/csrc/woop_nearest.cu"
REPLACES = "merian_quake_tpu/accel/woop.py:289"
K2_SOURCE = "merian_quake_tpu_torch/csrc/woop_any.cu"
K2_REPLACES = "merian_quake_tpu/accel/woop.py:786"
K3_SOURCE = "merian_quake_tpu_torch/csrc/woop_stream.cu"
K3_REPLACES = "merian_quake_tpu/accel/woop.py:111"
K8_SOURCE = "merian_quake_tpu_torch/csrc/mt_dense.cu"
K8_REPLACES = "merian_quake_tpu/accel/pallas_intersect.py:32"
K45_SOURCE = "merian_quake_tpu_torch/csrc/woop_keys.cu"
K4_REPLACES = "merian_quake_tpu/accel/woop.py:877"
K5_REPLACES = "merian_quake_tpu/accel/woop.py:914"
K67_SOURCE = "merian_quake_tpu_torch/csrc/woop_list.cu"
K6_REPLACES = "merian_quake_tpu/accel/woop.py:488"
K7_REPLACES = "merian_quake_tpu/accel/woop.py:627"
# The first designs of K1 and K3 (one CTA of 128 rays walking the clusters
# behind CTA barriers), as read on an NVIDIA H100 80GB HBM3 at 700.00 W with
# scripts/split_trace_kernels.py on those kernels (PERF.md section 6 has the
# table): ms a 2,073,600-ray launch, CTAs an SM, and per population the
# shares of the cycles (list, gates and barriers of skipped entries, of
# visited entries, tile waits, pair loops) and the lane use. Printed beside
# this run's readings.
FIRST_DESIGN = {
    "K1": {"ms": {"primary": 3.018, "bounce": 3.239}, "ctas_per_sm": 12, "split": {
        "primary": (0.0, 0.4225, 0.0927, 0.0199, 0.4645, 0.9902),
        "bounce": (0.0, 0.5022, 0.1363, 0.0204, 0.3407, 0.6729)}},
    "K3": {"ms": {"primary": 6.247, "bounce": 8.932, "shadow": 5.951}, "ctas_per_sm": 4, "split": {
        "primary": (0.4107, 0.0024, 0.1092, 0.0209, 0.4511, 0.9552),
        "bounce": (0.2607, 0.0470, 0.3298, 0.0183, 0.3390, 0.5534),
        "shadow": (0.3770, 0.0010, 0.1780, 0.0459, 0.3832, 0.6300)}},
    # one CTA of 128 rays, a thread a ray, every cluster behind a CTA barrier
    # (PERF.md section 6): city's shade rays, proxy pre-pass + shadow sweep,
    # then (scripts/ab_trace_kernels.py, in turns with this design) the
    # shadow table, city's proxy table and the map's
    "K2": {"ms": {"shade": 3.742, "shadow": 3.077, "proxy": 0.597, "map proxy": 0.890}},
    # one ray a thread, no pre-test: 65,536 map rays x 281,536 triangles
    "K8": {"ms": {"map primary": 61.59}},
}
# city with 1,600 buildings: 16,128 triangles in 252 clusters, so the
# target key (at most 256 clusters) applies; default city() has 260
CITY1600 = {"n_buildings": 1600, "seed": 7}
W, H, SPP, MPL = 1920, 1080, 2, 3
SUBSET = 65536
K3_POPS = ("primary", "bounce", "bounce_unsorted", "shadow")
MAP = {"n_buildings": 28000, "seed": 11}  # bench.py's map row: 281,536 triangles
# the bound: H100 SXM data-sheet rates (FP32 outside the tensor cores, HBM3).
# 67 TFLOP/s counts an FMA as two operations; the kernels round every
# multiply and add on its own (no FMA), so each is one instruction in an
# FMA's issue slot, and they issue at most half that many a second.
FP32_RATE, HBM_RATE = 67e12, 3.35e12
FP32_ISSUE_RATE = FP32_RATE / 2
# FP32 multiplies and adds a (ray, triangle) pair: the Woop nearest test,
# the Woop any-hit test, Möller–Trumbore (with its reciprocal)
OPS_NEAREST, OPS_ANY, OPS_MT = 42, 46, 46
# FP32 operations of a (ray, box) slab (K4, K5): the JAX slab's 6 subtracts,
# 6 multiplies and 12 min/max; with each axis's planes ordered and chosen
# once a ray (csrc/woop_keys.cu), 6 min/max
OPS_SLAB, OPS_SLAB_CHOSEN = 24, 18
# K8 against the oracle (t, u, v) and against K3 (t): relative tolerance
T_RTOL = 1e-5
# CPU vs card LDR agreement (the slice test's tolerance)
PIX_TOL, PIX_SHARE, MEAN_TOL = 1e-3, 0.995, 1e-4
# trace_visibility on the card (Woop) vs the CPU oracle (Möller–Trumbore):
# the two tests round differently on edges and at t_max, so a grazing
# segment may split; at most 2 in 1,000
VIS_AGREE = 0.998


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_launches() -> None:
    from merian_quake_tpu_torch.accel import dense, woop

    woop.woop_nearest.launches = woop.woop_any.launches = 0
    woop.woop_stream.launches = woop.woop_stream.anyhit_launches = 0
    dense.mt_dense.launches = 0
    woop.target_keys.launches = woop.te_union.launches = woop.woop_list.launches = 0
    woop.visit_list.launches = 0
    woop.woop_list.node_launches = woop.woop_list.compact_launches = 0
    woop.woop_list.anyhit_launches = 0


def launches() -> dict:
    from merian_quake_tpu_torch.accel import dense, woop

    return {"woop_nearest": woop.woop_nearest.launches, "woop_any": woop.woop_any.launches,
            "woop_stream": woop.woop_stream.launches,
            "woop_stream_any": woop.woop_stream.anyhit_launches,
            "mt_dense": dense.mt_dense.launches, "target_keys": woop.target_keys.launches,
            "te_union": woop.te_union.launches, "visit_list": woop.visit_list.launches,
            "woop_list": woop.woop_list.launches,
            "woop_list_nodes": woop.woop_list.node_launches,
            "woop_list_compact": woop.woop_list.compact_launches,
            "woop_list_any": woop.woop_list.anyhit_launches}


def bound_ms(ops: float, nbytes: float):
    """(least ms the card could take, what bounds it)."""
    t_ops, t_bytes = ops / FP32_ISSUE_RATE, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def woop_work(kernel, args, any_ops=False, **kw):
    """Run a Woop kernel once with its per-CTA pair counts; returns (ops,
    bytes) of that launch: the pairs it tested times the FP32 operations
    a pair (any-hit's with ``any_ops``), and the rays in, results out,
    warm start, table rows (48 B a triangle) and bounds read once."""
    rays, w, lo = args[0], args[1], args[2]
    n = rays.shape[1]
    counts = torch.zeros(n // 128, dtype=torch.int64, device=rays.device)
    kernel(*args, counts=counts, **kw)
    out = n if any_ops else 8 * n
    warm = n if kw.get("occluded_in") is not None else 0
    nbytes = n * 32 + out + warm + (w.shape[0] // 3) * 48 + lo.shape[0] * 24
    return float(counts.sum()) * (OPS_ANY if any_ops else OPS_NEAREST), nbytes


def sparse_warps(t_max):
    """``t_max`` with all but one or two rays of each warp of 32 dead
    (t_max = -1): lane 5 stays, and lane 20 in every other warp. A tile
    visit then has 1-2 reaching lanes, so K1's and K3's compacted visit
    (triangle per lane) tests every tile."""
    lane = torch.arange(t_max.shape[0], device=t_max.device)
    keep = (lane % 32 == 5) | ((lane % 64) == 32 + 20)
    return torch.where(keep, t_max, torch.full_like(t_max, -1.0))


def tie_table(dev, seed=7, n_rays=2048):
    """A hand-laid Woop table (no median split, so the layout is as
    written) of 4 clusters with exact ties, and sparse rays aimed at it:
    (rays, w, lo, hi) as ``woop.k1_inputs`` gives them. Cluster 0 holds 32
    triangles twice (triangle l + 32 is triangle l: the two a lane tests in
    a compacted visit), cluster 1 each triangle twice in a row (2j + 1 is
    2j: ties across lanes), clusters 2-3 are plain. The rays go from
    random origins to the triangles' centroids, one or two live a warp
    (:func:`sparse_warps`). The lowest index must win every tie."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.accel.build import cluster_aabbs

    rng = np.random.default_rng(seed)
    c = rng.uniform(-30, 30, (256, 1, 3))
    tri = (c + rng.uniform(-12, 12, (256, 3, 3))).astype(np.float32)
    tri[32:64] = tri[0:32]
    tri[65:128:2] = tri[64:128:2]
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    w, cand = woop.build_woop(v0, v1, v2, np.ones(256, bool))
    lo, hi = cluster_aabbs(v0, v1, v2, cand)
    to = tri.mean(1)[rng.integers(0, 128, n_rays)]
    o = rng.uniform(-80, 80, (n_rays, 3)).astype(np.float32)
    d = to - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    t_max = sparse_warps(torch.full((n_rays,), 1e4, device=dev))
    rays = woop._pack_rays(t(o), t(d), torch.zeros(n_rays, device=dev), t_max, woop.RAY_BLOCK)
    return rays, woop.pack_table(t(w)), *woop.padded_bounds(t(lo), t(hi))


def trace_split(phase, name, kernel, args, smi, first_design=None, **kw):
    """Launch K1's or K3's profile instance once and print where its
    cycles go (shares of the cycles summed over all warps, woop.PROF_FIELDS),
    the pairs it tested, the warp-issued pairs and the lane use = pairs / 32
    / warp-issued pairs, beside the first design's recorded shares and lane
    use when given. Returns that record."""
    from merian_quake_tpu_torch.accel import woop

    n = args[0].shape[1]
    prof = torch.zeros((n // 128, len(woop.PROF_FIELDS)), dtype=torch.int64,
                       device=args[0].device)
    kernel(*args, counts=prof, **kw)
    torch.cuda.synchronize()
    rec = dict(zip(woop.PROF_FIELDS, (int(x) for x in prof.sum(0))))
    total = max(rec["total"], 1)
    rec["lane_use"] = rec["pairs"] / 32 / max(rec["warp_pairs"], 1)
    rec["shares"] = {k: rec[k] / total for k in woop.PROF_FIELDS[:5]}
    shares = ", ".join(f"{k} {v:.4f}" for k, v in rec["shares"].items())
    first = ""
    if first_design is not None:
        names = ("list", "gates + barriers of skipped entries", "of visited entries", "wait",
                 "pairs_cycles")
        first = ("; the first design: " + ", ".join(
            f"{k} {v:.4f}" for k, v in zip(names, first_design[:5]))
            + f", lane use {first_design[5]:.4f}")
    log(f"phase {phase} split {name} [{smi}]: cycles {rec['total']} over all warps ({shares} of "
        f"them); pairs tested {rec['pairs']}, warp-issued pairs {rec['warp_pairs']}, lane use "
        f"{rec['lane_use']:.4f}{first}")
    return rec


def first_design_ms(kernel, name) -> str:
    """The first design's recorded time on a population, where it has one."""
    ms = FIRST_DESIGN[kernel]["ms"].get(name)
    return "" if ms is None else f"; the first design's {kernel} {ms:.3f} ms"


def cuda_time(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed_call(fn):
    """(fn()'s output, the ms it took on the CUDA-event clock)."""
    out = []
    return out, cuda_time(lambda: out.append(fn()), 1)


def compare_k1(name, args, woop):
    """Run K1 and its plain version on the same inputs: bit for bit."""
    return check_exact(2, name, woop.woop_nearest(*args),
                       woop.intersect_woop_reference(args[0], args[1]))


def primary_rays(bundle, accel, dev):
    from merian_quake_tpu_torch.ops import camera
    from merian_quake_tpu_torch.render import layout

    u = bundle.uniforms
    px, py = layout.gen_pixels(W, H, device=dev)
    d = camera.ray_dir(px.float(), py.float(), W, H, u.cam_u, u.cam_w, u.fov_tan_half)
    return u.cam_x.expand_as(d).contiguous(), d


def bounce_rays(bundle, accel, config, dev):
    """First bounce of the path tracer at frame 0 (render/pt.py)."""
    from merian_quake_tpu_torch.ops import bsdf, linalg, rng
    from merian_quake_tpu_torch.render import layout
    from merian_quake_tpu_torch.render.gbuffer import render_gbuffer
    from merian_quake_tpu_torch.render.hit import decompress_hit

    gbuf = render_gbuffer(accel, bundle.atlas, bundle.uniforms, config)
    cur = decompress_hit(gbuf.hits)
    px, py = layout.gen_pixels(W, H, device=dev)
    state = rng.seed_pixel(px, py, 0, config.seed)
    _, u3 = rng.uniform3(state)
    alpha = bsdf.roughness_to_alpha(cur.roughness)
    wo = bsdf.sample(cur.wi, cur.normal, alpha, u3)
    below = (linalg.dot(wo, cur.normal) <= 1e-3) | (linalg.dot(wo, cur.geo_normal) <= 1e-3)
    live = (cur.albedo >= 1e-7).any(-1) & ~below
    t_max = torch.where(live, 1e4, -1.0)
    return (cur.pos - cur.wi * 1e-3).contiguous(), wo.contiguous(), t_max


def check_k2(name, kernel_out, plain_out, phase=5):
    """Hold an any-hit kernel's occlusion against another's: equal on every
    ray. Returns the largest |difference| over the 0/1 occlusion values."""
    torch.cuda.synchronize()
    diff = (kernel_out.float() - plain_out.float()).abs()
    differ = int((diff > 0).sum())
    log(f"phase {phase} {name}: rays={kernel_out.numel()} occluded={int(plain_out.sum())} "
        f"differ={differ}")
    if differ:
        raise AssertionError(f"{name}: the two sweeps differ on {differ} rays")
    return float(diff.max())


def check_exact(phase, name, kernel_out, other_out):
    """Hold a nearest-hit kernel's (t, tri) against another's: bit for bit
    on every ray. Returns the largest |t difference| (0)."""
    (t_k, tri_k), (t_r, tri_r) = kernel_out, other_out
    torch.cuda.synchronize()
    tri_differ = int((tri_k != tri_r).sum())
    t_differ = int((t_k != t_r).sum())
    log(f"phase {phase} {name}: rays={t_k.numel()} hits={int((tri_r >= 0).sum())} "
        f"tri differ={tri_differ} t differ={t_differ}")
    if tri_differ or t_differ:
        raise AssertionError(f"{name}: tri differs on {tri_differ} rays, t on {t_differ}")
    return float((t_k - t_r).abs().max())


def shade_rays(bundle, accel, config, dev):
    """The 1080p shade pass's shadow rays at frame 0: gbuffer points to
    the reservoir samples after spatial reuse (render/restir/restir.py;
    the shade pass discards, it never moves, y_pos), packed as
    ``trace_visibility`` packs them."""
    from merian_quake_tpu_torch.render.gbuffer import render_gbuffer
    from merian_quake_tpu_torch.render.hit import decompress_hit
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig, init_restir_state, render_restir

    rconfig = config._replace(integrator="restir")
    gbuf = render_gbuffer(accel, bundle.atlas, bundle.uniforms, rconfig)
    _, rstate = render_restir(accel, bundle.atlas, bundle.uniforms, rconfig, ReSTIRConfig(),
                              init_restir_state(W, H, device=dev), gbuf)
    frm = decompress_hit(gbuf.hits).pos
    wo = rstate.reservoirs.y_pos - frm
    dist = torch.linalg.vector_norm(wo, dim=-1)
    d = wo / torch.clamp_min(dist, 1e-20)[:, None]
    return frm.contiguous(), d.contiguous(), torch.clamp_min(dist - 2e-3, 1e-3).contiguous()


def grate_soup(dev):
    """A box room with two alpha-tested grates (texture alpha in stripes)
    across it and one opaque pillar: the scene has an alpha-only table."""
    from merian_quake_tpu_torch.models.atlas import pack_textures
    from merian_quake_tpu_torch.models.procedural import _const_tex, _SoupBuilder

    grate = _const_tex((120, 120, 120), size=16, alpha=0)
    grate[:, ::4, 3] = 255  # opaque bars every 4th texel column
    grate[::4, :, 3] = 255
    b = _SoupBuilder()
    X, Y, Z = 200.0, 100.0, 100.0
    for p, du, dv in (((0, 0, 0), (X, 0, 0), (0, Y, 0)), ((0, 0, Z), (0, Y, 0), (X, 0, 0)),
                      ((0, 0, 0), (0, Y, 0), (0, 0, Z)), ((X, 0, 0), (0, 0, Z), (0, Y, 0)),
                      ((0, 0, 0), (0, 0, Z), (X, 0, 0)), ((0, Y, 0), (X, 0, 0), (0, 0, Z))):
        b.quad(p, du, dv, texnum=1)
    for x in (60.0, 130.0):  # two-sided grates across the room
        b.quad((x, 0, 0), (0, Y, 0), (0, 0, Z), uv_scale=(6, 6), texnum=2)
        b.quad((x, 0, 0), (0, 0, Z), (0, Y, 0), uv_scale=(6, 6), texnum=2)
    b.quad((95, 40, 0), (0, 0, Z), (0, 20, 0), texnum=1)  # a pillar wall
    b.quad((95, 40, 0), (0, 20, 0), (0, 0, Z), texnum=1)
    atlas = pack_textures([_const_tex((255, 255, 255), 1), _const_tex((200, 200, 200)), grate],
                          device=dev)
    return b.build(dev), atlas


def phase5(dev, rng, acc_soup, bundle, accel, config, smi):
    """K2 against its plain version; returns its times and error."""
    from merian_quake_tpu_torch.accel import build_accel, woop
    from merian_quake_tpu_torch.accel.intersect import trace_visibility
    from merian_quake_tpu_torch.models.types import build_scene_from_soup

    full = lambda v, k: torch.full((k,), v, device=dev)
    errs = []

    def compare(name, rays, table, bounds, occ_in=None):
        plain = woop.intersect_woop_any_reference(rays, table, occ_in)
        errs.append(check_k2(name, woop.woop_any(rays, table, *bounds, occ_in), plain))
        return plain

    # random soup: half the rays aimed away, per-ray t_max in [1, 200]
    n = 512
    o = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[: n // 2] = 500.0
    d[: n // 2] = np.abs(d[: n // 2])
    t_max = rng.uniform(1.0, 200.0, n).astype(np.float32)
    t = lambda x: torch.from_numpy(x).to(dev)
    rays, _, (w, lo, hi) = woop.k2_inputs(acc_soup, t(o), t(d), full(1e-3, n), t(t_max))
    compare("random soup", rays, w, (lo, hi))

    # a sky wall (passes light) in front of an opaque wall, both two-sided
    quads, flags = [], []
    for x, flag in ((10.0, 1), (20.0, 0)):
        a, b_, c, e = ([x, -5, -5], [x, 5, -5], [x, 5, 5], [x, -5, 5])
        quads += [(a, e, b_), (c, b_, e), (a, b_, e), (c, e, b_)]
        flags += [flag * 5] * 4  # MAT_FLAGS_SKY = 5
    tri = np.asarray(quads, np.float32)
    sky = build_accel(build_scene_from_soup(tri[:, 0], tri[:, 1], tri[:, 2],
                                            flags=np.asarray(flags, np.int32), device=dev))
    k = 256
    so = np.zeros((k, 3), np.float32)
    so[:, 1:] = rng.uniform(-8, 8, (k, 2))
    sd = np.tile(np.asarray([[1.0, 0.0, 0.0]], np.float32), (k, 1))
    rays, _, (w, lo, hi) = woop.k2_inputs(sky, t(so), t(sd), full(1e-3, k),
                                          t(rng.uniform(5.0, 30.0, k).astype(np.float32)))
    if w is sky.woop_w:
        raise AssertionError("the sky soup's shadow table zeroes nothing")
    compare("sky wall soup", rays, w, (lo, hi))

    # city's 1080p shade-pass shadow rays: subset, then the whole population
    so, sd, st = shade_rays(bundle, accel, config, dev)
    n_full = so.shape[0]
    mid = slice(n_full // 2, n_full // 2 + SUBSET)
    rays, proxy, shadow = woop.k2_inputs(accel, so[mid].contiguous(), sd[mid].contiguous(),
                                         full(1e-3, SUBSET), st[mid].contiguous())
    pre = compare(f"city shade {SUBSET} proxy", rays, proxy[0], proxy[1:])
    compare(f"city shade {SUBSET} shadow", rays, shadow[0], shadow[1:])
    compare(f"city shade {SUBSET} shadow after proxy", rays, shadow[0], shadow[1:], pre)
    rays, proxy, shadow = woop.k2_inputs(accel, so, sd, full(1e-3, n_full), st)
    pre = compare(f"city shade {n_full} proxy", rays, proxy[0], proxy[1:])
    plain = compare(f"city shade {n_full} shadow", rays, shadow[0], shadow[1:])
    warm = woop.woop_any(rays, *shadow, woop.woop_any(rays, *proxy))
    errs.append(check_k2(f"city shade {n_full} shadow after proxy", warm, plain))
    if not (bool(plain.any()) and bool((~plain[:n_full]).any())):
        raise AssertionError("city shade rays: all occluded or none")

    # the shadow sweep as the frames launch it (no pre-pass) against the
    # plain version, in turns; the bound from K2's own count of the pairs
    ops_s, bytes_s = woop_work(woop.woop_any, (rays, *shadow), True)
    ops_p, bytes_p = woop_work(woop.woop_any, (rays, *proxy), True)
    ops_w, bytes_w = woop_work(woop.woop_any, (rays, *shadow), True, occluded_in=pre)
    bound, by = bound_ms(ops_s, bytes_s)
    kern = lambda: woop.woop_any(rays, *shadow)
    ref = lambda: woop.intersect_woop_any_reference(rays, shadow[0])
    k_1, r1 = cuda_time(kern, 10), cuda_time(ref, 1)
    r2, k_2 = cuda_time(ref, 1), cuda_time(kern, 10)
    # F4: one visibility trace without and with the proxy pre-pass (K2 on
    # the proxy table, then K2 on the shadow table warm-started by it)
    with_pre = lambda: woop.woop_any(rays, *shadow, woop.woop_any(rays, *proxy))
    a1, b1, b2, a2 = (cuda_time(kern, 10), cuda_time(with_pre, 10), cuda_time(with_pre, 10),
                      cuda_time(kern, 10))
    errs.append(check_k2(f"city shade {n_full} F4 without vs with the pre-pass", kern(),
                         with_pre()))
    prepass_bound = bound_ms(ops_p, bytes_p)[0] + bound_ms(ops_w, bytes_w)[0]
    log(f"phase 5 timing shade {n_full} rays [{smi}]: K2 shadow {k_1:.3f} / {k_2:.3f} ms, plain "
        f"{r1:.1f} / {r2:.1f} ms; bound {bound:.4f} ms ({by}; {ops_s / OPS_ANY:.4g} pairs tested); "
        f"occluded {float(plain[:n_full].float().mean()):.4f}, by the proxy "
        f"{float(pre[:n_full].float().mean()):.4f}; F4: without the pre-pass {a1:.3f} / {a2:.3f} "
        f"ms, with it (K2 proxy + K2 shadow warm-started) {b1:.3f} / {b2:.3f} ms, bound with it "
        f"{prepass_bound:.4f} ms ({(ops_p + ops_w) / OPS_ANY:.4g} pairs)"
        + first_design_ms("K2", "shade") + " (proxy + shadow)")
    split = {name: trace_split(5, f"city shade {n_full} K2 {name}", woop.woop_any, args, smi, **kw)
             for name, args, kw in (("shadow", (rays, *shadow), {}), ("proxy", (rays, *proxy), {}),
                                    ("shadow after proxy", (rays, *shadow), {"occluded_in": pre}))}
    ctas = woop.ctas_per_sm("woop_any", shadow[1].shape[0])
    pk = lambda: woop.woop_any(rays, *proxy)
    p1, p2 = cuda_time(pk, 10), cuda_time(pk, 10)
    log(f"phase 5 K2 on city's shadow table ({shadow[1].shape[0]} clusters): {ctas} CTAs of 128 "
        f"threads an SM" + first_design_ms("K2", "shadow") + f"; on the proxy table {p1:.3f} / "
        f"{p2:.3f} ms, bound {bound_ms(ops_p, bytes_p)[0]:.4f} ms" + first_design_ms("K2", "proxy"))

    # trace_visibility: the card (K2 + alpha table through K1) against the
    # CPU oracle, on an alpha-grate soup
    scene, atlas = grate_soup("cpu")
    acc_cpu = build_accel(scene, atlas)
    if acc_cpu.woop_w_alpha is None:
        raise AssertionError("the grate soup has no alpha-only table")
    acc_gpu = build_accel(scene, atlas, device=dev)
    m = 4096
    a = rng.uniform([2, 2, 2], [198, 98, 98], (m, 3)).astype(np.float32)
    bb = rng.uniform([2, 2, 2], [198, 98, 98], (m, 3)).astype(np.float32)
    cpu = trace_visibility(acc_cpu, atlas, torch.from_numpy(a), torch.from_numpy(bb))
    k1_before, k2_before = woop.woop_nearest.launches, woop.woop_any.launches
    gpu = trace_visibility(acc_gpu, atlas.to(dev), t(a), t(bb)).cpu()
    if woop.woop_any.launches == k2_before or woop.woop_nearest.launches == k1_before:
        raise AssertionError("trace_visibility on the card did not launch K2 and K1")
    agree = float((cpu == gpu).float().mean())
    log(f"phase 5 trace_visibility grate soup {m} segments: visible cpu {float(cpu.float().mean()):.4f} "
        f"card {float(gpu.float().mean()):.4f}, agree {agree:.5f}")
    if agree < VIS_AGREE or bool(cpu.all()) or not bool(cpu.any()):
        raise AssertionError("trace_visibility: the card and the CPU oracle disagree")
    return {"ms": (k_1 + k_2) / 2, "plain_ms": (r1 + r2) / 2, "max_abs_err": max(errs),
            "bound_ms": bound, "bound_by": by, "pairs": ops_s / OPS_ANY,
            "f4_city": {"without_ms": (a1 + a2) / 2, "with_ms": (b1 + b2) / 2},
            "lane_use": {k: v["lane_use"] for k, v in split.items()},
            "cycle_shares": {k: v["shares"] for k, v in split.items()}, "ctas_per_sm": ctas}


def with_prepass(accel, o, d, t_min, t_max, sort_rays=False, schedule=None):
    """``woop.intersect_woop_any`` as the JAX package runs it (F4's other
    way): K2 on the proxy table first, then the route's shadow sweep
    warm-started by it. The visibility calls of a frame take no sort."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.ops.linalg import as_f32

    if sort_rays:
        raise AssertionError("with_prepass: no sorted visibility trace")
    n = o.shape[0]
    t_min_b = as_f32(t_min, o).expand(n).contiguous()
    t_max_b = as_f32(t_max, o).expand(n).contiguous()
    rays, proxy, shadow = woop.k2_inputs(accel, o, d, t_min_b, t_max_b)
    pre = None if proxy is None else woop.woop_any(rays, *proxy)
    return woop.sweep_any(rays, *shadow, schedule, pre)[:n]


def restir_run(bundle, accel, cfg, dev, frames=6, schedule=None, prepass=False):
    """``frames`` ReSTIR frames from a fresh state, the visibility traces as
    the card's route runs them or, ``prepass``, with the proxy pre-pass
    (:func:`with_prepass`); returns (ms a frame, each frame's ldr)."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    rcfg = ReSTIRConfig()
    state = init_state(cfg, rcfg, device=dev)
    route = woop.intersect_woop_any
    woop.intersect_woop_any = with_prepass if prepass else route
    try:
        frame_ms, ldr = [], []
        for i in range(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, out = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=i), cfg,
                                      state, rcfg, schedule=schedule)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            ldr.append(out["ldr"])
    finally:
        woop.intersect_woop_any = route
    return frame_ms, ldr


def prepass_ab(phase, path, bundle, accel, cfg, dev, smi, schedule=None):
    """F4 on frames: 8 ReSTIR frames without the proxy pre-pass (the
    card's route) and with it, in turns (without, with, with, without,
    twice); every frame's LDR the same both ways (the pre-pass changes no
    ray). Returns {"without_ms", "with_ms"}: the means of frames 2-7."""
    steady, first = {False: [], True: []}, {}
    for prepass in (False, True, True, False) * 2:
        frame_ms, ldr = restir_run(bundle, accel, cfg, dev, frames=8, schedule=schedule,
                                   prepass=prepass)
        steady[prepass].append(float(np.mean(frame_ms[2:])))
        first.setdefault(prepass, ldr)
    same = all(torch.equal(a, b) for a, b in zip(first[False], first[True]))
    diff = (first[False][-1] - first[True][-1]).abs()
    share = float((diff.amax(-1) <= PIX_TOL).float().mean())
    log(f"phase {phase} F4 {path} {W}x{H} [{smi}]: steady ms/frame (frames 2-7) without the "
        f"proxy pre-pass {' / '.join(f'{x:.2f}' for x in steady[False])} (mean "
        f"{np.mean(steady[False]):.2f}), with it {' / '.join(f'{x:.2f}' for x in steady[True])} "
        f"(mean {np.mean(steady[True]):.2f}); ldr bit-identical on every frame {same}, frame 7 "
        f"pixels within {PIX_TOL} {share:.5f}")
    if share < PIX_SHARE:
        raise AssertionError(f"{path}: frames with and without the pre-pass differ")
    return {"without_ms": float(np.mean(steady[False])), "with_ms": float(np.mean(steady[True]))}


def phase6(dev, bundle, accel, feats, smi):
    """6 ReSTIR frames at 1080p; returns the launches of each kernel; then
    F4's frames with and without the proxy pre-pass."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    config = RenderConfig(width=W, height=H, integrator="restir", features=feats)
    rcfg = ReSTIRConfig()
    state = init_state(config, rcfg, device=dev)
    reset_launches()
    frame_ms = []
    for i in range(6):
        before = (woop.woop_nearest.launches, woop.woop_any.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=i), config,
                                  state, rcfg)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        got = (woop.woop_nearest.launches - before[0], woop.woop_any.launches - before[1])
        if got != (2, 1):
            raise AssertionError(f"ReSTIR frame {i}: (K1, K2) launched {got} times, expected (2, 1)")
    got = launches()
    if got["woop_stream"] or got["mt_dense"]:
        raise AssertionError(f"the city ReSTIR frames launched K3 or K8: {got}")
    res = state.restir.reservoirs
    for name, x in (("ldr", out["ldr"]), ("hdr", out["hdr"]), ("irradiance", out["irradiance"]),
                    ("accum_irradiance", state.accum_irradiance), ("reservoir w", res.w),
                    ("reservoir p_target", res.p_target), ("reservoir y_pos", res.y_pos),
                    ("reservoir y_radiance", res.y_radiance)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"ReSTIR {name} is not finite")
    m_max = int(res.M.max())
    if m_max <= 1:
        raise AssertionError(f"ReSTIR: largest reservoir M is {m_max} after 6 frames")
    if tuple(out["ldr"].shape) != (H, W, 3) or float(out["ldr"].std()) <= 0.0:
        raise AssertionError("ReSTIR ldr has the wrong shape or is constant")
    steady = float(np.mean(frame_ms[2:]))
    log(f"phase 6 restir city {W}x{H} [{smi}]: K1 launches {got['woop_nearest']}, "
        f"K2 launches {got['woop_any']}; cold {frame_ms[0]:.1f} ms, steady {steady:.1f} "
        f"ms/frame (frames {', '.join(f'{x:.1f}' for x in frame_ms)}); max M {m_max}; "
        f"valid reservoirs {float((res.y_flags & 1).float().mean()):.4f}; "
        f"ldr mean {float(out['ldr'].mean()):.4f}")
    return got, prepass_ab(6, "restir city", bundle, accel, config, dev, smi), (config, state, out)


def phase7(dev):
    """ReSTIR at 64×36, 3 frames: the CPU oracle against the card."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.capture import WARMUP_STEPS
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.renderer import render_sequence

    small = RenderConfig(width=64, height=36, integrator="restir")
    for name, rcfg in (("defaults", ReSTIRConfig()),
                       ("bias 2", ReSTIRConfig(temporal_bias_correction=2, spatial_bias_correction=2))):
        _, out_cpu = render_sequence(city(device="cpu"), small, frames=3, mcpg_config=rcfg,
                                     device="cpu")
        k2_before = woop.woop_any.launches
        _, out_gpu = render_sequence(city(device="cpu"), small, frames=3, mcpg_config=rcfg,
                                     device=dev)
        k2 = woop.woop_any.launches - k2_before
        # a captured sequence: the wrapper launches in the warm-up frames and
        # records into the graph once; the replays launch the graph
        expect = (WARMUP_STEPS + 1) * (3 if rcfg.temporal_bias_correction == 2 else 1)
        if k2 != expect:
            raise AssertionError(f"phase 7 {name}: K2 launched {k2} times, expected {expect}")
        diff = (out_cpu["ldr"] - out_gpu["ldr"].cpu()).abs()
        share = float((diff.amax(-1) <= PIX_TOL).float().mean())
        mean = float(diff.mean())
        log(f"phase 7 restir {name} cpu vs cuda 64x36 x3 frames (captured on the card): K2 "
            f"launches through the wrapper {k2} (the capture's warm-up and capture); pixels within "
            f"{PIX_TOL} {share:.5f}, mean |d| {mean:.3e}, max |d| {float(diff.max()):.3e}")
        if share < PIX_SHARE or mean >= MEAN_TOL:
            raise AssertionError(f"ReSTIR {name}: CPU and card LDR images disagree")


def map_scene(dev):
    """The map scene on the card: (bundle, accel, config at 1080p)."""
    from merian_quake_tpu_torch.accel import build_accel
    from merian_quake_tpu_torch.accel.build import scene_features
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig

    t0 = time.perf_counter()
    bundle = city(**MAP, device=dev)
    accel = build_accel(bundle.scene, bundle.atlas)
    feats = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    log(f"phase 8 map city({MAP['n_buildings']}, {MAP['seed']}): {bundle.scene.num_tris} "
        f"triangles, {accel.cluster_lo.shape[0]} clusters, scene + accel build "
        f"{time.perf_counter() - t0:.2f} s")
    return bundle, accel, RenderConfig(width=W, height=H, spp=SPP, max_path_length=MPL,
                                       features=feats)


def phase8(dev, soup, bundle, accel, config, smi):
    """K3 against its plain versions (subsets) and against K1/K2 on the
    same table (whole populations); K2's map proxy pre-pass against its
    plain version; times and bounds."""
    from merian_quake_tpu_torch.accel import woop

    full = lambda v, k: torch.full((k,), v, device=dev)
    errs = []
    acc_soup, o_t, d_t = soup
    n = o_t.shape[0]
    args = woop.k1_inputs(acc_soup, o_t, d_t, full(0.0, n), full(1e4, n))
    errs.append(check_exact(8, "random soup K3 vs plain", woop.woop_stream(*args),
                            woop.intersect_woop_reference(args[0], args[1])))
    rays, _, shadow = woop.k2_inputs(acc_soup, o_t, d_t, full(1e-3, n), full(60.0, n))
    errs.append(check_k2("random soup K3 any-hit vs plain",
                         woop.woop_stream(rays, *shadow, anyhit=True),
                         woop.intersect_woop_any_reference(rays, shadow[0]), phase=8))
    # the compacted visit, hard: one or two live rays a warp; exact ties
    for name, args in (
        ("random soup sparse warps", woop.k1_inputs(acc_soup, o_t, d_t, full(0.0, n),
                                                    sparse_warps(full(1e4, n)))),
        ("tie table sparse warps", tie_table(dev)),
    ):
        errs.append(check_exact(8, f"{name} K3 vs plain", woop.woop_stream(*args),
                                woop.intersect_woop_reference(args[0], args[1])))
        errs.append(check_k2(f"{name} K3 any-hit vs plain", woop.woop_stream(*args, anyhit=True),
                             woop.intersect_woop_any_reference(args[0], args[1]), phase=8))

    n_full = W * H
    po, pd = primary_rays(bundle, accel, dev)
    ubo, ubd, ubt = bounce_rays(bundle, accel, config, dev)  # as a frame traces them
    perm = woop.sort_perm(accel, ubo, ubd, ubt)
    bo, bd, bt = ubo[perm].contiguous(), ubd[perm].contiguous(), ubt[perm].contiguous()
    so, sd, st = shade_rays(bundle, accel, config, dev)
    mid = slice(n_full // 2, n_full // 2 + SUBSET)
    sub = lambda x: x[mid].contiguous()
    subsets = {
        "primary": woop.k1_inputs(accel, sub(po), sub(pd), full(0.0, SUBSET), full(1e4, SUBSET)),
        "bounce": woop.k1_inputs(accel, sub(bo), sub(bd), full(0.0, SUBSET), sub(bt)),
        "bounce_unsorted": woop.k1_inputs(accel, sub(ubo), sub(ubd), full(0.0, SUBSET), sub(ubt)),
    }
    for name, args in subsets.items():
        errs.append(check_exact(8, f"map {name} {SUBSET} t_min=0.0 K3 vs plain",
                                woop.woop_stream(*args),
                                woop.intersect_woop_reference(args[0], args[1])))
    args = woop.k1_inputs(accel, sub(bo), sub(bd), full(1e-3, SUBSET), sub(bt))
    errs.append(check_exact(8, f"map bounce {SUBSET} t_min=0.001 K3 vs plain",
                            woop.woop_stream(*args), woop.intersect_woop_reference(args[0], args[1])))
    rays, proxy, shadow = woop.k2_inputs(accel, sub(so), sub(sd), full(1e-3, SUBSET), sub(st))
    pre = woop.woop_any(rays, *proxy)
    errs.append(check_k2(f"map shade {SUBSET} K2 proxy vs plain", pre,
                         woop.intersect_woop_any_reference(rays, proxy[0]), phase=8))
    plain = woop.intersect_woop_any_reference(rays, shadow[0])
    errs.append(check_k2(f"map shade {SUBSET} K3 any-hit vs plain",
                         woop.woop_stream(rays, *shadow, anyhit=True), plain, phase=8))
    errs.append(check_k2(f"map shade {SUBSET} K3 any-hit after proxy vs plain",
                         woop.woop_stream(rays, *shadow, anyhit=True, occluded_in=pre), plain,
                         phase=8))
    subsets["shadow"] = (rays, shadow, pre)
    # any-hit on the whole table (no shadow table): the map's primary rays
    args = woop.k1_inputs(accel, sub(po), sub(pd), full(1e-3, SUBSET), full(1e4, SUBSET))
    errs.append(check_k2(f"map primary {SUBSET} t_min=0.001 K3 any-hit vs plain",
                         woop.woop_stream(*args, anyhit=True),
                         woop.intersect_woop_any_reference(args[0], args[1]), phase=8))

    # the whole populations: K3 against K1/K2 on the same table
    pops = {
        "primary": woop.k1_inputs(accel, po, pd, full(0.0, n_full), full(1e4, n_full)),
        "bounce": woop.k1_inputs(accel, bo, bd, full(0.0, n_full), bt),
        "bounce_unsorted": woop.k1_inputs(accel, ubo, ubd, full(0.0, n_full), ubt),
    }
    for name, args in pops.items():
        errs.append(check_exact(8, f"map {name} {n_full} t_min=0.0 K3 vs K1",
                                woop.woop_stream(*args), woop.woop_nearest(*args)))
    args = woop.k1_inputs(accel, bo, bd, full(1e-3, n_full), bt)
    errs.append(check_exact(8, f"map bounce {n_full} t_min=0.001 K3 vs K1",
                            woop.woop_stream(*args), woop.woop_nearest(*args)))
    rays_f, proxy_f, shadow_f = woop.k2_inputs(accel, so, sd, full(1e-3, n_full), st)
    pre_f = woop.woop_any(rays_f, *proxy_f)
    errs.append(check_k2(f"map shade {n_full} K2 proxy vs plain", pre_f,
                         woop.intersect_woop_any_reference(rays_f, proxy_f[0]), phase=8))
    occ = woop.woop_any(rays_f, *shadow_f)
    errs.append(check_k2(f"map shade {n_full} K3 any-hit vs K2",
                         woop.woop_stream(rays_f, *shadow_f, anyhit=True), occ, phase=8))
    errs.append(check_k2(f"map shade {n_full} K3 any-hit after proxy vs K2 after proxy",
                         woop.woop_stream(rays_f, *shadow_f, anyhit=True, occluded_in=pre_f),
                         woop.woop_any(rays_f, *shadow_f, pre_f), phase=8))
    if not (bool(occ.any()) and bool((~occ[:n_full]).any())):
        raise AssertionError("map shade rays: all occluded or none")
    log(f"phase 8 map shade {n_full}: occluded {float(occ[:n_full].float().mean()):.4f}, "
        f"by the proxy {float(pre_f[:n_full].float().mean()):.4f}")
    # F4 on the map: one visibility trace without the proxy pre-pass (K3
    # any-hit) and with it (K2 on the proxy table, then K3 warm-started)
    without = lambda: woop.woop_stream(rays_f, *shadow_f, anyhit=True)
    with_pre = lambda: woop.woop_stream(rays_f, *shadow_f, anyhit=True,
                                        occluded_in=woop.woop_any(rays_f, *proxy_f))
    errs.append(check_k2(f"map shade {n_full} F4 without vs with the pre-pass", without(),
                         with_pre(), phase=8))
    k2_pre = lambda: woop.woop_any(rays_f, *proxy_f)
    a1, b1, b2, a2 = (cuda_time(without, 5), cuda_time(with_pre, 5), cuda_time(with_pre, 5),
                      cuda_time(without, 5))
    p1, p2 = cuda_time(k2_pre, 5), cuda_time(k2_pre, 5)
    ops_p, bytes_p = woop_work(woop.woop_any, (rays_f, *proxy_f), True)
    f4_map = {"without_ms": (a1 + a2) / 2, "with_ms": (b1 + b2) / 2, "k2_proxy_ms": (p1 + p2) / 2,
              "k2_proxy_bound_ms": bound_ms(ops_p, bytes_p)[0]}
    log(f"phase 8 F4 map shade {n_full} rays [{smi}]: without the proxy pre-pass (K3 any-hit) "
        f"{a1:.3f} / {a2:.3f} ms, with it (K2 proxy + K3 warm-started) {b1:.3f} / {b2:.3f} ms; "
        f"K2 on the proxy table ({proxy_f[1].shape[0]} clusters) {p1:.3f} / {p2:.3f} ms, bound "
        f"{f4_map['k2_proxy_bound_ms']:.4f} ms ({ops_p / OPS_ANY:.4g} pairs tested)"
        + first_design_ms("K2", "map proxy"))

    # times: K3 and K1/K2 on the whole populations in turns (K3, K1, K1,
    # K3; 5 launches a reading), then K3 and the plain version on the
    # subsets (plain, K3, K3, plain); bounds from K3's counts
    kern = {
        "primary": (lambda: woop.woop_stream(*pops["primary"]),
                    lambda: woop.woop_nearest(*pops["primary"])),
        "bounce": (lambda: woop.woop_stream(*pops["bounce"]),
                   lambda: woop.woop_nearest(*pops["bounce"])),
        "bounce_unsorted": (lambda: woop.woop_stream(*pops["bounce_unsorted"]),
                            lambda: woop.woop_nearest(*pops["bounce_unsorted"])),
        "shadow": (lambda: woop.woop_stream(rays_f, *shadow_f, anyhit=True, occluded_in=pre_f),
                   lambda: woop.woop_any(rays_f, *shadow_f, pre_f)),
    }
    rays_s, shadow_s, pre_s = subsets["shadow"]
    plain = {
        "primary": (lambda: woop.intersect_woop_reference(*subsets["primary"][:2]),
                    lambda: woop.woop_stream(*subsets["primary"])),
        "bounce": (lambda: woop.intersect_woop_reference(*subsets["bounce"][:2]),
                   lambda: woop.woop_stream(*subsets["bounce"])),
        "bounce_unsorted": (lambda: woop.intersect_woop_reference(*subsets["bounce_unsorted"][:2]),
                            lambda: woop.woop_stream(*subsets["bounce_unsorted"])),
        "shadow": (lambda: woop.intersect_woop_any_reference(rays_s, shadow_s[0], pre_s),
                   lambda: woop.woop_stream(rays_s, *shadow_s, anyhit=True, occluded_in=pre_s)),
    }
    out = {}
    for name in ("primary", "bounce", "bounce_unsorted", "shadow"):
        k3, other = kern[name]
        a1, b1, b2, a2 = cuda_time(k3, 5), cuda_time(other, 5), cuda_time(other, 5), cuda_time(k3, 5)
        ref, k3s = plain[name]
        p1, s1, s2, p2 = cuda_time(ref, 1), cuda_time(k3s, 5), cuda_time(k3s, 5), cuda_time(ref, 1)
        if name == "shadow":
            ops, nbytes = woop_work(woop.woop_stream, (rays_f, *shadow_f), True, anyhit=True,
                                    occluded_in=pre_f)
        else:
            ops, nbytes = woop_work(woop.woop_stream, pops[name])
        bnd, by = bound_ms(ops, nbytes)
        if name == "shadow":
            split = trace_split(8, "map shadow K3 any-hit after proxy", woop.woop_stream,
                                (rays_f, *shadow_f), smi, FIRST_DESIGN["K3"]["split"][name],
                                anyhit=True, occluded_in=pre_f)
        else:
            split = trace_split(8, f"map {name} K3", woop.woop_stream, pops[name], smi,
                                FIRST_DESIGN["K3"]["split"].get(name))
        out[name] = {"ms": (a1 + a2) / 2, "other_ms": (b1 + b2) / 2, "plain_ms": (p1 + p2) / 2,
                     "subset_ms": (s1 + s2) / 2, "bound_ms": bnd, "bound_by": by,
                     "lane_use": split["lane_use"], "shares": split["shares"]}
        log(f"phase 8 timing map {name} [{smi}]: K3 {a1:.3f} / {a2:.3f} ms, "
            f"{'K2' if name == 'shadow' else 'K1'} {b1:.3f} / {b2:.3f} ms on {n_full} rays; "
            f"on {SUBSET} rays plain {p1:.1f} / {p2:.1f} ms, K3 {s1:.3f} / {s2:.3f} ms; "
            f"bound {bnd:.4f} ms ({by}; {ops / (OPS_ANY if name == 'shadow' else OPS_NEAREST):.4g} "
            f"pairs tested)" + first_design_ms("K3", name))
    out["max_abs_err"] = max(errs)
    out["f4_map"] = f4_map
    out["ctas_per_sm"] = woop.ctas_per_sm("woop_stream", accel.cluster_lo.shape[0])
    log(f"phase 8 K3 on the map ({accel.cluster_lo.shape[0]} clusters): {out['ctas_per_sm']} CTAs "
        f"of 128 threads an SM (the first design: {FIRST_DESIGN['K3']['ctas_per_sm']})")
    return out, (po, pd)


def check_k8(name, kernel_out, oracle_out):
    """K8's (t, tri, u, v) against the oracle's: bit for bit on every ray.
    Returns the largest |t difference| (0)."""
    torch.cuda.synchronize()
    bits = [int((a.view(torch.int32) != b.view(torch.int32)).sum())
            for a, b in zip(kernel_out, oracle_out)]
    log(f"phase 9 {name}: rays={kernel_out[0].numel()} hits={int((oracle_out[1] >= 0).sum())} "
        f"t, tri, u, v not bit-equal on {bits[0]}, {bits[1]}, {bits[2]}, {bits[3]} rays")
    if any(bits):
        raise AssertionError(f"{name}: K8 and the oracle differ")
    return float((kernel_out[0] - oracle_out[0]).abs().max())


def phase9(dev, soup, accel, po, pd, smi):
    """K8 against the oracle on CUDA tensors, bit for bit, and against K3;
    the dense path's launches, times in turns with K3, and the bounds."""
    from merian_quake_tpu_torch.accel import dense, woop
    from merian_quake_tpu_torch.accel.intersect import _intersect_oracle

    acc_soup, o_t, d_t = soup
    errs = [check_k8("random soup K8 vs oracle", dense.intersect_dense(acc_soup, o_t, d_t, 0.0, 1e4),
                     _intersect_oracle(acc_soup, o_t, d_t, 0.0, 1e4))]
    n_full = W * H
    mid = slice(n_full // 2, n_full // 2 + SUBSET)
    o, d = po[mid].contiguous(), pd[mid].contiguous()
    table = dense.scene_table(accel)  # once a scene, before the path
    reset_launches()
    hr = dense.intersect_dense(accel, o, d, 0.0, 1e4)  # the dense path
    got = launches()
    if got != {**{k: 0 for k in got}, "mt_dense": 1}:
        raise AssertionError(f"intersect_dense launched {got}, expected K8 once")
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ref = _intersect_oracle(accel, o, d, 0.0, 1e4)
    stop.record()
    torch.cuda.synchronize()
    p1 = start.elapsed_time(stop)
    errs.append(check_k8(f"map primary {SUBSET} K8 vs oracle", hr, ref))
    k3_args = woop.k1_inputs(accel, o, d, torch.zeros_like(o[:, 0]), torch.full_like(o[:, 0], 1e4))
    t3, tri3 = woop.woop_stream(*k3_args)
    t3, tri3 = t3[:SUBSET], tri3[:SUBSET]
    agree = (hr.t - t3).abs() <= T_RTOL * torch.clamp_min(t3.abs(), 1e-6)
    share = float(agree.float().mean())
    ties = int((agree & (hr.tri != tri3)).sum())
    log(f"phase 9 map primary {SUBSET} K8 vs K3: t within {T_RTOL} rel on {share:.6f} of rays "
        f"({int((~agree).sum())} split on an edge); tri differ at an equal t on {ties}")
    if share < 0.9999:
        raise AssertionError("K8 and K3 disagree on the map")
    rays = woop._pack_rays(o, d, torch.zeros_like(o[:, 0]), torch.full_like(o[:, 0], 1e4), 128)
    k8 = lambda: dense.mt_dense(rays, table)
    k3 = lambda: woop.woop_stream(*k3_args)
    k_1, c_1, c_2, k_2 = cuda_time(k8, 3), cuda_time(k3, 3), cuda_time(k3, 3), cuda_time(k8, 3)
    p2 = cuda_time(lambda: dense.intersect_dense_reference(rays, table), 1)
    T = table.shape[0]
    # the bounds: every pair's 46 operations (no cull), and the operations
    # these inputs need under the pre-tests (K8's counts: 14 a pair, 8 a
    # pair past level 1, 19 past level 2, 5 past level 3)
    counts = torch.zeros((SUBSET // 128, 3), dtype=torch.int64, device=dev)
    dense.mt_dense(rays, table, counts=counts)
    n1, n2, n3 = (int(x) for x in counts.sum(0))
    pairs = float(SUBSET) * T
    nbytes = SUBSET * (32 + 16) + T * 48
    every, by_every = bound_ms(pairs * OPS_MT, nbytes)
    need_ops = 14 * pairs + 8 * n1 + 19 * n2 + 5 * n3
    bnd, by = bound_ms(need_ops, nbytes)
    log(f"phase 9 timing map primary {SUBSET} rays x {T} triangles [{smi}]: K8 {k_1:.3f} / "
        f"{k_2:.3f} ms, K3 on the same rays {c_1:.3f} / {c_2:.3f} ms, plain {p1:.1f} / {p2:.1f} "
        f"ms; bound {every:.4f} ms ({by_every}, {OPS_MT} operations every pair), {bnd:.4f} ms "
        f"({by}) from the operations these inputs need ({need_ops / pairs:.3f} a pair: pairs "
        f"past pre-test level 1 {n1 / pairs:.4f}, level 2 {n2 / pairs:.4f}, level 3 "
        f"{n3 / pairs:.4f})" + first_design_ms("K8", "map primary"))
    return {"ms": (k_1 + k_2) / 2, "plain_ms": (p1 + p2) / 2, "bound_ms": bnd, "bound_by": by,
            "bound_every_pair_ms": every, "k3_ms": (c_1 + c_2) / 2,
            "passed": {"level1": n1, "level2": n2, "level3": n3, "pairs": pairs},
            "max_abs_err": max(errs), "launches": got}


def phase10(dev, bundle, accel, config, smi):
    """6 PT and 6 ReSTIR frames of the map at 1080p; returns each path's
    launches."""
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    per_path = {}
    for integrator, expect in (
        ("pt", {"woop_stream": 5}),
        ("restir", {"woop_stream": 3, "woop_stream_any": 1}),
    ):
        cfg = config._replace(integrator=integrator)
        rcfg = ReSTIRConfig() if integrator == "restir" else None
        state = init_state(cfg, rcfg, device=dev)
        reset_launches()
        frame_ms = []
        for i in range(6):
            before = launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, out = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=i), cfg,
                                      state, rcfg)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            got = {k: v - before[k] for k, v in launches().items()}
            if got != {**{k: 0 for k in got}, **expect}:
                raise AssertionError(f"map {integrator} frame {i}: launched {got}, expected {expect}")
        per_path[integrator] = launches()
        for name, x in (("ldr", out["ldr"]), ("hdr", out["hdr"]), ("irradiance", out["irradiance"]),
                        ("accum_irradiance", state.accum_irradiance)):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"map {integrator} {name} is not finite")
        if tuple(out["ldr"].shape) != (H, W, 3) or float(out["ldr"].std()) <= 0.0:
            raise AssertionError(f"map {integrator} ldr has the wrong shape or is constant")
        steady = float(np.mean(frame_ms[2:]))
        rate = ""
        if integrator == "pt":
            rate = f", {W * H * (1 + SPP * (MPL - 1)) / steady / 1e3:.2f} Mrays/s"
        log(f"phase 10 {integrator} map {W}x{H} [{smi}]: launches {per_path[integrator]}; cold "
            f"{frame_ms[0]:.1f} ms, steady {steady:.1f} ms/frame (frames "
            f"{', '.join(f'{x:.1f}' for x in frame_ms)}){rate}; ldr mean {float(out['ldr'].mean()):.4f}")
    f4 = prepass_ab(10, "restir map", bundle, accel, config._replace(integrator="restir"), dev, smi)
    return per_path, f4


def phase11(dev):
    """2 PT and 2 ReSTIR frames of the map at 32×18: CPU oracle against
    the card (K3 + K2)."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.renderer import render_sequence

    bundle = city(**MAP, device="cpu")
    for name, cfg, rcfg in (
        ("pt", RenderConfig(width=32, height=18, spp=SPP, max_path_length=MPL), None),
        ("restir", RenderConfig(width=32, height=18, integrator="restir"), ReSTIRConfig()),
    ):
        t0 = time.perf_counter()
        _, out_cpu = render_sequence(bundle, cfg, frames=2, mcpg_config=rcfg, device="cpu")
        cpu_s = time.perf_counter() - t0
        k1, k3 = woop.woop_nearest.launches, woop.woop_stream.launches
        # no device=: the entry point's default is the card
        _, out_gpu = render_sequence(bundle, cfg, frames=2, mcpg_config=rcfg)
        if out_gpu["ldr"].device != dev:
            raise AssertionError(f"render_sequence without device= ran on {out_gpu['ldr'].device}")
        if woop.woop_stream.launches == k3 or woop.woop_nearest.launches != k1:
            raise AssertionError(f"map {name} 32x18 on the card did not trace through K3 alone")
        diff = (out_cpu["ldr"] - out_gpu["ldr"].cpu()).abs()
        share = float((diff.amax(-1) <= PIX_TOL).float().mean())
        mean = float(diff.mean())
        log(f"phase 11 map {name} cpu vs cuda 32x18 x2 frames (cpu {cpu_s:.1f} s): pixels within "
            f"{PIX_TOL} {share:.5f}, mean |d| {mean:.3e}, max |d| {float(diff.max()):.3e}")
        if share < PIX_SHARE or mean >= MEAN_TOL:
            raise AssertionError(f"map {name}: CPU and card LDR images disagree")


def city1600(dev):
    """city(1600, 7) on the card: (bundle, accel, 1080p config) and its
    1080p ray populations: primary (pixel order), the first PT bounce in
    pixel order and sorted by the target key, and the shade-pass shadow
    rays."""
    from merian_quake_tpu_torch.accel import build_accel, woop
    from merian_quake_tpu_torch.accel.build import scene_features
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig

    bundle = city(**CITY1600, device=dev)
    accel = build_accel(bundle.scene, bundle.atlas)
    config = RenderConfig(width=W, height=H, spp=SPP, max_path_length=MPL,
                          features=scene_features(bundle.scene, bundle.uniforms, bundle.atlas))
    po, pd = primary_rays(bundle, accel, dev)
    bo, bd, bt = bounce_rays(bundle, accel, config, dev)
    perm = torch.sort(woop.target_sort_key(accel, bo, bd, bt), stable=True).indices
    pops = {"primary": (po, pd, torch.zeros_like(bt), torch.full_like(bt, 1e4)),
            "bounce": (bo, bd, torch.zeros_like(bt), bt),
            "bounce_target": (bo[perm].contiguous(), bd[perm].contiguous(),
                              torch.zeros_like(bt), bt[perm].contiguous()),
            "shade": shade_rays(bundle, accel, config, dev)}
    log(f"phase 12 city({CITY1600['n_buildings']}, {CITY1600['seed']}): {bundle.scene.num_tris} "
        f"triangles, {accel.cluster_lo.shape[0]} clusters; bounce rays live "
        f"{float((bt > 0).float().mean()):.4f}")
    return bundle, accel, config, pops


def _sub(pop):
    n_full = W * H
    mid = slice(n_full // 2, n_full // 2 + SUBSET)
    return tuple(x[mid].contiguous() for x in pop)


def timed_turns(plain, kernel, reps):
    """(kernel ms, plain ms): plain, kernel, kernel, plain; plain once a
    reading, the kernel ``reps`` times."""
    p1, k1, k2, p2 = (cuda_time(plain, 1), cuda_time(kernel, reps), cuda_time(kernel, reps),
                      cuda_time(plain, 1))
    return (k1 + k2) / 2, (p1 + p2) / 2


def edge_boxes(rng, m, few_empty=False, device="cpu"):
    """m boxes in [-50, 50]^3 with the cases K4 and K5 must keep exact
    (lo/hi f32[m, 3]): every 5th empty as the padding fills it (3e37 >
    -3e37), every 7th empty as the build fills it (1e30 > -1e30), every 3rd
    inverted on one axis, one with a NaN plane, one flat (lo = hi on an
    axis). The JAX slab enters an empty box at 0 from any finite origin,
    so K4's keys take the first three empty ids: ``few_empty`` leaves only
    two (at 30% and 60% of the ids), so that the third is a real box's."""
    lo = rng.uniform(-50, 45, (m, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0.5, 15, (m, 3))).astype(np.float32)
    for c in range(0, m, 3):
        k = c % 3
        lo[c, k], hi[c, k] = hi[c, k], lo[c, k]
    if few_empty:
        lo[3 * m // 10], hi[3 * m // 10] = 1e30, -1e30
        lo[6 * m // 10], hi[6 * m // 10] = 3e37, -3e37
    else:
        lo[4::5], hi[4::5] = 3e37, -3e37
        lo[6::7], hi[6::7] = 1e30, -1e30
    if m > 10:
        lo[10, 1] = np.nan
        hi[8, 2] = lo[8, 2]
    return torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device)


def edge_rays(rng, n=640, device="cpu"):
    """Packed rays f32[8, n] for K4 and K5 around :func:`edge_boxes`:
    origins in and around the boxes, directions with +0, -0 and
    sub-1e-20 components, NaN origins and a NaN direction, limits 1e4,
    +inf, 0, -0, negative, NaN; a warp whose limits are all negative and a
    128-ray block whose limits are all dead."""
    from merian_quake_tpu_torch.accel import woop

    o = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[::9] = rng.uniform(-50, 50, (len(o[::9]), 3))
    d[1::6, 0] = 0.0
    d[2::6, 1] = -0.0
    d[3::6, 2] = 1e-25
    d[4::6, :2] = 0.0
    d[4::6, 2] = -1.0
    o[5::50, 0] = np.nan
    d[7, 2] = np.nan
    t_max = np.full(n, 1e4, np.float32)
    t_max[1::10] = np.inf
    t_max[2::10] = 0.0
    t_max[3::10] = -0.0
    t_max[4::10] = -1.0
    t_max[5::10] = np.nan
    t_max[6::10] = 15.0
    t_max[64:96] = -1.0  # a dead warp
    t_max[256:384] = np.where(np.arange(128) % 2, -2.0, np.nan)  # a dead block
    t = lambda x: torch.from_numpy(x).to(device)
    return woop._pack_rays(t(o), t(d), torch.zeros(n, device=device), t(t_max), woop.RAY_BLOCK)


def phase12(dev, soup, c16, smi):
    """K4, K5 (both modes) and the fused visit list against their plain
    versions, bit for bit; times in turns, bounds at 24 and 18 operations
    a slab and, for K4, at the slabs its counting instance computed."""
    from merian_quake_tpu_torch.accel import woop

    acc_soup, o_t, d_t = soup
    _, accel, _, pops = c16

    errs = {"K4": [], "K5": [], "list": []}

    def same_bits(kernel, name, a, b):
        torch.cuda.synchronize()
        bad = a.view(torch.int32) != b.view(torch.int32)
        differ = int(bad.sum())
        # |kernel - plain| where the bits differ (inf where only one is inf)
        gap = torch.where(bad, (a.double() - b.double()).abs().nan_to_num(float("inf")), 0.0)
        errs[kernel].append(float(gap.max()))
        log(f"phase 12 {name}: {a.numel()} values, differ={differ}, max |kernel - plain| "
            f"{errs[kernel][-1]}")
        if differ:
            raise AssertionError(f"{name}: kernel and plain version differ on {differ} values")

    def same_list(name, rays, lo, hi):
        got, ref = woop.visit_list(rays, lo, hi), woop.visit_list_reference(rays, lo, hi)
        same_bits("list", f"{name} visit list te_s", got[0], ref[0])
        same_bits("list", f"{name} visit list order", got[1], ref[1])

    # (name, rays, K4's and the JAX mode's boxes, the walker's boxes)
    n = o_t.shape[0]
    full = lambda v, k: torch.full((k,), v, device=dev)
    inputs = []
    for name, acc, o, d, t_min, t_max in (
            [("random soup", acc_soup, o_t, d_t, full(0.0, n), full(60.0, n))]
            + [(f"city1600 {k} {SUBSET}", accel, *_sub(pops[k]))
               for k in ("primary", "bounce", "bounce_target")]
            + [(f"city1600 bounce_target {W * H}", accel, *pops["bounce_target"])]):
        rays, _, lo, hi = woop.k1_inputs(acc, o, d, t_min, t_max)
        inputs.append((name, rays, acc.cluster_lo, acc.cluster_hi, lo, hi))
    rng = np.random.default_rng(12)
    rays_e = edge_rays(rng, device=dev)
    for m in (3, 100, 1024):
        lo, hi = edge_boxes(rng, m, device=dev)
        inputs.append((f"edge boxes m={m}", rays_e, lo, hi, lo, hi))
    for m in (3, 100, 256):
        lo, hi = edge_boxes(rng, m, few_empty=True, device=dev)
        same_bits("K4", f"edge boxes m={m} (two empty) K4", woop.target_keys(rays_e, lo, hi),
                  woop.target_keys_reference(rays_e, lo, hi))
    for name, rays, clo, chi, wlo, whi in inputs:
        if clo.shape[0] <= woop.MAX_KEY_CLUSTERS:
            ref = woop.target_keys_reference(rays, clo, chi)
            same_bits("K4", f"{name} K4", woop.target_keys(rays, clo, chi), ref)
            counts = torch.zeros((rays.shape[1] // 128, 3), dtype=torch.int64, device=dev)
            same_bits("K4", f"{name} K4 counting instance",
                      woop.target_keys(rays, clo, chi, counts=counts), ref)
        boxes = {"clusters": (clo, chi, wlo, whi),
                 "nodes8": (*woop.node_bounds(clo, chi, 8), *woop.node_bounds(wlo, whi, 8))}
        for bname, (jlo, jhi, blo, bhi) in boxes.items():
            same_bits("K5", f"{name} K5 {bname} JAX mode", woop.te_union(rays, jlo, jhi),
                      woop.te_union_reference(rays, jlo, jhi))
            same_bits("K5", f"{name} K5 {bname} walker mode",
                      woop.te_union(rays, blo, bhi, slack=True),
                      woop.te_union_reference(rays, blo, bhi, slack=True))
            same_list(f"{name} {bname}", rays, blo, bhi)

    # times on the whole populations as the frames launch them: K4 on the
    # bounce rays in pixel order, K5 (walker mode) and the list on the
    # target-sorted ones
    nf = W * H
    rays_b = woop.k1_inputs(accel, *pops["bounce"])[0]
    rays_t, _, lo, hi = woop.k1_inputs(accel, *pops["bounce_target"])
    nc = accel.cluster_lo.shape[0]
    nlo, nhi = woop.node_bounds(lo, hi, 8)
    out = {"max_abs_err": {k: max(v) for k, v in errs.items()}}
    k4 = timed_turns(lambda: woop.target_keys_reference(rays_b, accel.cluster_lo, accel.cluster_hi),
                     lambda: woop.target_keys(rays_b, accel.cluster_lo, accel.cluster_hi), 10)
    counts = torch.zeros((nf // 128, 3), dtype=torch.int64, device=dev)
    woop.target_keys(rays_b, accel.cluster_lo, accel.cluster_hi, counts=counts)
    work = dict(zip(woop.KEY_COUNTS, (int(x) for x in counts.sum(0))))
    k4_bytes = nf * 32 + nf * 4 + nc * 24
    out["K4"] = {"ms": k4[0], "plain_ms": k4[1], "boxes": nc, "counts": work,
                 **slab_bounds(nf * nc, work["slabs"] + work["node_slabs"], k4_bytes)}
    # K5 needs the slabs of the live rays (limit >= 0) with every box
    live = int((woop.list_slack(rays_t[7]) >= 0.0).sum())
    for bname, (blo, bhi) in (("clusters", (lo, hi)), ("nodes8", (nlo, nhi))):
        m = blo.shape[0]
        k5 = timed_turns(lambda: woop.te_union_reference(rays_t, blo, bhi, slack=True),
                         lambda: woop.te_union(rays_t, blo, bhi, slack=True), 10)
        union_bytes = nf * 32 + (nf // 128) * m * 4 + m * 24
        out[f"K5 {bname}"] = {"ms": k5[0], "plain_ms": k5[1], "boxes": m, "live_rays": live,
                              **slab_bounds(nf * m, live * m, union_bytes)}
        # the list: the fused entry against K5 + torch's row sort (the route
        # before the fusion), in turns, and against its plain version
        fused = lambda: woop.visit_list(rays_t, blo, bhi)
        unfused = lambda: torch.sort(woop.te_union(rays_t, blo, bhi, slack=True), dim=1,
                                     stable=True)
        u1, f1, f2, u2 = (cuda_time(unfused, 10), cuda_time(fused, 10), cuda_time(fused, 10),
                          cuda_time(unfused, 10))
        plain = cuda_time(lambda: woop.visit_list_reference(rays_t, blo, bhi), 1)
        out[f"list {bname}"] = {"ms": (f1 + f2) / 2, "plain_ms": plain,
                                "unfused_ms": (u1 + u2) / 2, "boxes": m, "live_rays": live,
                                **slab_bounds(nf * m, live * m,
                                              union_bytes + (nf // 128) * m * 4)}
    for name, r in ((k, v) for k, v in out.items() if k != "max_abs_err"):
        if name == "K4":
            need = (f"the {r['need_slabs'] / (nf * nc):.4f} of rays x boxes its counting "
                    f"instance computed {r['counts']}")
        else:
            need = f"its {r['live_rays']} live rays x boxes"
        extra = f"; K5 + torch.sort {r['unfused_ms']:.3f} ms in turns" if "unfused_ms" in r else ""
        log(f"phase 12 timing {name} ({r['boxes']} boxes) on {nf} bounce rays [{smi}]: kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.1f} ms; bound {r['bound_ms']:.4f} ms at "
            f"{OPS_SLAB_CHOSEN} operations a slab of {need} ({r['bound_by']}, share "
            f"{r['bound_ms'] / r['ms']:.3f}); over every ray x box {r['bound_18_ms']:.4f} ms at "
            f"{OPS_SLAB_CHOSEN} (share {r['bound_18_ms'] / r['ms']:.3f}), {r['bound_24_ms']:.4f} "
            f"ms at the JAX slab's {OPS_SLAB} (share {r['bound_24_ms'] / r['ms']:.3f}){extra}")
    return out


def slab_bounds(slabs, need, nbytes):
    """The bounds of a kernel over ``slabs`` (ray, box) slabs moving
    ``nbytes``: bound_ms (bound_by) at 18 operations a slab (each axis's
    planes ordered and chosen once a ray) over the ``need`` slabs this
    run's data needs; beside it 18 and the JAX slab's 24 a slab over every
    slab (bound_18_ms, bound_24_ms)."""
    bnd, by = bound_ms(OPS_SLAB_CHOSEN * need, nbytes)
    return {"bound_ms": bnd, "bound_by": by, "need_slabs": need,
            "bound_18_ms": bound_ms(OPS_SLAB_CHOSEN * slabs, nbytes)[0],
            "bound_24_ms": bound_ms(OPS_SLAB * slabs, nbytes)[0]}


def guided_1600(dev, c16):
    """The 4,147,200 guided rays of the first MCPG bounce segment on
    city(1600) after 4 frames, sorted by the target key as
    ``TraceSchedule(True, 8, 32)`` sorts them: (o, d, t_min, t_max)."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    bundle, accel, config, _ = c16
    cfg, mcfg = mcpg_scene_config(config)
    state = init_state(cfg, mcfg, device=dev)
    for f in range(4):
        state, _ = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=f), cfg,
                                state, mcfg)
    o, d, t_max = guided_population(bundle, accel, cfg, mcfg, state, 4)[1][0]
    perm = torch.sort(woop.target_sort_key(accel, o, d, t_max), stable=True).indices
    return (o[perm].contiguous(), d[perm].contiguous(), torch.zeros_like(t_max),
            t_max[perm].contiguous())


def phase13(dev, soup, c16, smi):
    """The walker against its plain versions, bit for bit (nearest) and on
    every ray (any-hit), in every mode (P = 1, 8, 16, 32, 64, 128; compact 0
    and 32), and on the MCPG guided rays under (True, 8, 32); its counts,
    profile and times against the parent-less yardsticks K1/K2."""
    from merian_quake_tpu_torch.accel import woop

    acc_soup, o_t, d_t = soup
    _, accel, _, pops = c16
    S = woop.TraceSchedule
    modes = [S(), S(compact=32), S(node_clusters=8), S(node_clusters=8, compact=32),
             S(node_clusters=16), S(node_clusters=16, compact=32), S(node_clusters=32),
             S(node_clusters=64, compact=32), S(node_clusters=128)]
    tag = lambda s, nc=252: f"P={woop.schedule_nodes(s, nc)} compact={s.compact}"
    n = o_t.shape[0]
    full = lambda v, k: torch.full((k,), v, device=dev)
    errs = []
    nearest = [("random soup", acc_soup, (o_t, d_t, full(0.0, n), full(60.0, n)))]
    nearest += [(f"city1600 {k} {SUBSET}", accel, _sub(pops[k])) for k in ("primary", "bounce_target")]
    nearest += [(f"city1600 {k} {W * H}", accel, pops[k]) for k in ("primary", "bounce_target")]
    for name, acc, pop in nearest:
        args = woop.k1_inputs(acc, *pop)
        plain = woop.intersect_woop_reference(args[0], args[1])
        for s in modes:
            errs.append(check_exact(13, f"{name} walker {tag(s, acc.cluster_lo.shape[0])}",
                                    woop._walk(*args, s), plain))
    anyhit = [("random soup", acc_soup, (o_t, d_t, full(60.0, n))),
              (f"city1600 shade {SUBSET}", accel, _sub(pops["shade"])),
              (f"city1600 shade {W * H}", accel, pops["shade"])]
    for name, acc, (o, d, t_max) in anyhit:
        rays, proxy, shadow = woop.k2_inputs(acc, o, d, torch.full_like(t_max, 1e-3), t_max)
        plain = woop.intersect_woop_any_reference(rays, shadow[0])
        pre = None if proxy is None else woop.woop_any(rays, *proxy)
        for s in (S(), S(node_clusters=8), S(node_clusters=16), S(node_clusters=32),
                  S(node_clusters=64), S(node_clusters=128)):
            label = f"{name} walker any-hit {tag(s, acc.cluster_lo.shape[0])}"
            errs.append(check_k2(label, woop._walk(rays, *shadow, s, anyhit=True), plain,
                                 phase=13))
            if pre is not None:
                errs.append(check_k2(f"{label} after proxy",
                                     woop._walk(rays, *shadow, s, anyhit=True, occluded_in=pre),
                                     plain, phase=13))
    # the MCPG guided rays under (True, 8, 32): against the plain version on
    # a subset, against K1 on all 4,147,200
    guided = guided_1600(dev, c16)
    ng = guided[0].shape[0]
    mid = slice(ng // 2, ng // 2 + SUBSET)
    sub = woop.k1_inputs(accel, *(x[mid].contiguous() for x in guided))
    errs.append(check_exact(13, f"city1600 guided {SUBSET} walker (True, 8, 32) vs plain",
                            woop._walk(*sub, S(True, 8, 32)),
                            woop.intersect_woop_reference(sub[0], sub[1])))
    g_args = woop.k1_inputs(accel, *guided)
    errs.append(check_exact(13, f"city1600 guided {ng} walker (True, 8, 32) vs K1",
                            woop._walk(*g_args, S(True, 8, 32)), woop.woop_nearest(*g_args)))

    # counts, profile and times on the whole populations, against K1 / K2
    # on the same rays (the walk with its list: the visit list, the walker)
    out = {"ctas_per_sm": woop.ctas_per_sm("woop_list", accel.cluster_lo.shape[0])}
    for pname, s, anyhit in (("bounce_target", S(), False), ("bounce_target", S(node_clusters=8), False),
                             ("bounce_target", S(node_clusters=8, compact=32), False),
                             ("primary", S(node_clusters=8, compact=32), False),
                             ("shade", S(node_clusters=8), True),
                             ("guided", S(node_clusters=8, compact=32), False)):
        if pname == "shade":
            rays, _, (w, lo, hi) = woop.k2_inputs(accel, *pops["shade"][:2],
                                                  full(1e-3, W * H), pops["shade"][2])
            args = (rays, w, lo, hi)
        else:
            rays, w, lo, hi = args = g_args if pname == "guided" else woop.k1_inputs(
                accel, *pops[pname])
        nr = rays.shape[1]
        P = max(s.node_clusters, 1)
        blo, bhi = woop.node_bounds(lo, hi, P) if P > 1 else (lo, hi)
        lst = woop.visit_list(rays, blo, bhi)
        kw = dict(node_lo=blo, node_hi=bhi, nodes=P, compact=s.compact, anyhit=anyhit)
        if P == 1:
            kw = dict(compact=s.compact)
        counts = torch.zeros((nr // 128, 3), dtype=torch.int64, device=dev)
        woop.woop_list(rays, w, lo, hi, *lst, counts=counts, **kw)
        pairs, visits, cvisits = (int(x) for x in counts.sum(0))
        label = f"{pname} {tag(s)}" + (" any" if anyhit else "")
        if s.compact and not cvisits:
            raise AssertionError(f"{label}: no compacted visit")
        split = trace_split(13, f"city1600 {label} walker",
                            lambda *a, **k: woop.woop_list(*a, *lst, **kw, **k), args, smi)
        ref = woop.woop_any if anyhit else woop.woop_nearest
        ref_counts = torch.zeros(nr // 128, dtype=torch.int64, device=dev)
        ref(*args, counts=ref_counts)
        walk = lambda: woop.woop_list(rays, w, lo, hi, *lst, **kw)
        full_walk = lambda: woop._walk(*args, s, anyhit=anyhit)
        k1 = lambda: ref(*args)
        a1, b1, c1, c2, b2, a2 = (cuda_time(walk, 10), cuda_time(full_walk, 10), cuda_time(k1, 10),
                                  cuda_time(k1, 10), cuda_time(full_walk, 10), cuda_time(walk, 10))
        nb, m = nr // 128, blo.shape[0]
        per_pair = OPS_ANY if anyhit else OPS_NEAREST
        nbytes = nr * 32 + nr * (1 if anyhit else 8) + nb * m * 8 + (w.shape[0] // 3) * 48 + m * 24
        bnd, by = bound_ms(pairs * per_pair, nbytes)
        fewest = min(pairs, int(ref_counts.sum()))
        bnd_few, _ = bound_ms(fewest * per_pair, nbytes)
        out[label] = {"ms": (a1 + a2) / 2, "with_list_ms": (b1 + b2) / 2,
                      "k1_ms": (c1 + c2) / 2, "bound_ms": bnd, "bound_by": by,
                      "bound_fewest_ms": bnd_few, "pairs": pairs,
                      "ref_pairs": int(ref_counts.sum()), "visits": visits, "cvisits": cvisits,
                      "lane_use": split["lane_use"], "cycle_shares": split["shares"], "rays": nr}
        rname = "K2" if anyhit else "K1"
        log(f"phase 13 timing {label} {nr} rays [{smi}]: walker {a1:.3f} / {a2:.3f} ms, "
            f"with its list (visit list + walker) {b1:.3f} / {b2:.3f} ms, {rname} {c1:.3f} / "
            f"{c2:.3f} ms; pairs tested {pairs} ({rname} {int(ref_counts.sum())}), tile visits "
            f"{visits}, compacted {cvisits} ({cvisits / max(visits, 1):.4f}); bound {bnd:.4f} ms "
            f"({by}), {bnd_few:.4f} at the fewest pairs; lane use {split['lane_use']:.4f}")
    # F4 under the node schedule: without the proxy pre-pass and with it
    # (K2 on the proxy table, then the walker warm-started), in turns
    rays, proxy, shadow = woop.k2_inputs(accel, *pops["shade"][:2], full(1e-3, W * H),
                                         pops["shade"][2])
    s = S(node_clusters=8)
    walk = lambda: woop._walk(rays, *shadow, s, anyhit=True)
    with_pre = lambda: woop._walk(rays, *shadow, s, anyhit=True,
                                  occluded_in=woop.woop_any(rays, *proxy))
    errs.append(check_k2(f"city1600 shade {W * H} F4 walker P=8 without vs with the pre-pass",
                         walk(), with_pre(), phase=13))
    a1, b1, b2, a2 = (cuda_time(walk, 10), cuda_time(with_pre, 10), cuda_time(with_pre, 10),
                      cuda_time(walk, 10))
    out["f4"] = {"without_ms": (a1 + a2) / 2, "with_ms": (b1 + b2) / 2}
    log(f"phase 13 F4 shade {W * H} rays P=8 [{smi}]: with its list {a1:.3f} / {a2:.3f} ms; "
        f"with the proxy pre-pass (K2 proxy + walker warm-started) {b1:.3f} / {b2:.3f} ms")
    # the plain versions' time, on the subset
    args = woop.k1_inputs(accel, *_sub(pops["bounce_target"]))
    p1 = cuda_time(lambda: woop.intersect_woop_reference(args[0], args[1]), 1)
    out["plain_ms_subset"] = p1
    out["max_abs_err"] = max(errs)
    log(f"phase 13 plain version on {SUBSET} target-sorted bounce rays: {p1:.1f} ms; the "
        f"walker: {out['ctas_per_sm']} CTAs of 128 threads an SM")
    return out


def phase14(dev, c16, smi):
    """6 frames at 1080p on city(1600, 7) for each schedule and for the
    default routes, with exact launch counts a frame; the LDR images
    against the default routes'."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    bundle, accel, config, _ = c16
    S = woop.TraceSchedule
    runs = [
        ("pt_1600", "pt", None, {"woop_nearest": 5}),
        ("restir_1600", "restir", None, {"woop_nearest": 2, "woop_any": 1}),
        ("pt_1600_target", "pt", S(target_key=True),
         {"woop_nearest": 1, "target_keys": 4, "visit_list": 4, "woop_list": 4}),
        ("pt_1600_nodes_compact", "pt", S(True, 8, 32),
         {"target_keys": 4, "visit_list": 5, "woop_list": 5, "woop_list_nodes": 5,
          "woop_list_compact": 5}),
        ("restir_1600_nodes", "restir", S(node_clusters=8),
         {"visit_list": 3, "woop_list": 3, "woop_list_nodes": 3, "woop_list_any": 1}),
    ]
    per_path, ldr, timing = {}, {}, {}
    for path, integrator, sched, expect in runs:
        cfg = config._replace(integrator=integrator)
        rcfg = ReSTIRConfig() if integrator == "restir" else None
        state = init_state(cfg, rcfg, device=dev)
        reset_launches()
        frame_ms = []
        for i in range(6):
            before = launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, out = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=i), cfg,
                                      state, rcfg, schedule=sched)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            got = {k: v - before[k] for k, v in launches().items()}
            if got != {**{k: 0 for k in got}, **expect}:
                raise AssertionError(f"{path} frame {i}: launched {got}, expected {expect}")
        per_path[path] = launches()
        for name, x in (("ldr", out["ldr"]), ("hdr", out["hdr"]),
                        ("accum_irradiance", state.accum_irradiance)):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{path} {name} is not finite")
        if tuple(out["ldr"].shape) != (H, W, 3) or float(out["ldr"].std()) <= 0.0:
            raise AssertionError(f"{path} ldr has the wrong shape or is constant")
        ldr[path] = out["ldr"]
        steady = float(np.mean(frame_ms[2:]))
        timing[path] = (frame_ms[0], steady)
        same = ""
        if sched is not None:
            ref = ldr[f"{integrator}_1600"]
            diff = (out["ldr"] - ref).abs()
            share = float((diff.amax(-1) <= PIX_TOL).float().mean())
            mean = float(diff.mean())
            same = (f"; against schedule=None: bit-identical {bool(torch.equal(out['ldr'], ref))}, "
                    f"pixels within {PIX_TOL} {share:.5f}, mean |d| {mean:.3e}")
            if share < PIX_SHARE or mean >= MEAN_TOL:
                raise AssertionError(f"{path}: LDR differs from the default routes'")
        log(f"phase 14 {path} {W}x{H} schedule={tuple(sched) if sched else None} [{smi}]: "
            f"launches {per_path[path]}; cold {frame_ms[0]:.1f} ms, steady {steady:.1f} ms/frame "
            f"(frames {', '.join(f'{x:.1f}' for x in frame_ms)}){same}")
    f4 = {path: prepass_ab(14, path, bundle, accel, config._replace(integrator="restir"), dev, smi,
                           schedule=sched)
          for path, integrator, sched, _ in runs if integrator == "restir"}
    return per_path, timing, f4


def phase15(dev):
    """2 PT and 2 ReSTIR frames of city(1600, 7) at 32×18 under
    TraceSchedule(True, 8, 32): the CPU oracle against the card."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.renderer import render_sequence

    bundle = city(**CITY1600, device="cpu")
    sched = woop.TraceSchedule(True, 8, 32)
    for name, cfg, rcfg in (
        ("pt", RenderConfig(width=32, height=18, spp=SPP, max_path_length=MPL), None),
        ("restir", RenderConfig(width=32, height=18, integrator="restir"), ReSTIRConfig()),
    ):
        _, out_cpu = render_sequence(bundle, cfg, frames=2, mcpg_config=rcfg, device="cpu",
                                     schedule=sched)
        before = launches()
        _, out_gpu = render_sequence(bundle, cfg, frames=2, mcpg_config=rcfg, schedule=sched)
        got = {k: v - before[k] for k, v in launches().items()}
        if got["woop_nearest"] or not got["woop_list_nodes"] or (name == "pt") != bool(
                got["target_keys"]):
            raise AssertionError(f"city1600 {name} 32x18 under {sched} launched {got}")
        diff = (out_cpu["ldr"] - out_gpu["ldr"].cpu()).abs()
        share = float((diff.amax(-1) <= PIX_TOL).float().mean())
        mean = float(diff.mean())
        log(f"phase 15 city1600 {name} cpu vs cuda 32x18 x2 frames under {tuple(sched)}: "
            f"launches {got}; pixels within {PIX_TOL} {share:.5f}, mean |d| {mean:.3e}, "
            f"max |d| {float(diff.max()):.3e}")
        if share < PIX_SHARE or mean >= MEAN_TOL:
            raise AssertionError(f"city1600 {name}: CPU and card LDR images disagree")


def mcpg_scene_config(config):
    """A scene's 1080p config as the MCPG frame's, and ``MCPGConfig()``."""
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig

    return config._replace(integrator="mcpg"), MCPGConfig()


def check_mcpg_finite(path, state, out):
    for name, x in (("ldr", out["ldr"]), ("hdr", out["hdr"]), ("irradiance", out["irradiance"]),
                    ("accum_irradiance", state.accum_irradiance),
                    ("accum_direct", state.accum_direct), ("accum_albedo", state.accum_albedo),
                    ("mc.f", state.mcpg.mc.f), ("lc.irr", state.mcpg.lc.irr)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{path} {name} is not finite")
    if tuple(out["ldr"].shape) != (H, W, 3) or float(out["ldr"].std()) <= 0.0:
        raise AssertionError(f"{path} ldr has the wrong shape or is constant")


def frames_run(phase, path, dev, bundle, accel, config, icfg, frames, window, expect, smi, rays,
               schedule=None, per_frame=None):
    """``frames`` frames at 1080p from an empty state with the launch
    counts set to 0 just before and read just after, each frame's launches
    held to ``expect`` exactly; finite outputs; ``rays`` a frame for the
    rate. ``per_frame`` (label, fn of the state) is read after each frame,
    outside the timed region, and printed. Returns (state, out, the path's
    launches, frame ms, the per-frame readings)."""
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    state = init_state(config, icfg, device=dev)
    reset_launches()
    frame_ms, seen = [], []
    for i in range(frames):
        before = launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=i), config,
                                  state, icfg, schedule=schedule)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        got = {k: v - before[k] for k, v in launches().items()}
        if got != {**{k: 0 for k in got}, **expect}:
            raise AssertionError(f"{path} frame {i}: launched {got}, expected {expect}")
        if per_frame is not None:
            seen.append(per_frame[1](state))
    counts = launches()
    for name, x in (("ldr", out["ldr"]), ("hdr", out["hdr"]), ("irradiance", out["irradiance"])):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{path} {name} is not finite")
    if tuple(out["ldr"].shape) != (H, W, 3) or float(out["ldr"].std()) <= 0.0:
        raise AssertionError(f"{path} ldr has the wrong shape or is constant")
    lo, hi = window
    steady = float(np.mean(frame_ms[lo:hi]))
    log(f"phase {phase} {path} {W}x{H} spp {config.spp} mpl {config.max_path_length} "
        f"schedule={tuple(schedule) if schedule else None} [{smi}]: launches "
        f"{ {k: v for k, v in counts.items() if v} }; cold {frame_ms[0]:.1f} ms, mean of frames "
        f"{lo}-{hi - 1} {steady:.1f} ms/frame, {rays / steady / 1e3:.2f} Mrays/s (frames "
        f"{', '.join(f'{x:.1f}' for x in frame_ms)}); "
        + (f"per frame {per_frame[0]} {seen}; " if per_frame is not None else "")
        + f"ldr mean {float(out['ldr'].mean()):.4f}")
    return state, out, counts, frame_ms, seen


def mcpg_frames(phase, path, dev, bundle, accel, config, mcfg, frames, window, expect, smi,
                schedule=None, rays=W * H * (1 + SPP * (MPL - 1))):
    """``frames`` MCPG frames through :func:`frames_run`, printing per frame
    the count of chain states with sum_w > 0 and ``lc_updates_applied``;
    the guiding state finite. Returns (state, out, the path's launches,
    frame ms, (states per frame, lc_updates_applied per frame))."""
    learned = ("(states with sum_w > 0, lc_updates_applied)",
               lambda s: (int((s.mcpg.mc.sum_w > 0).sum()), int(s.mcpg.lc_updates_applied)))
    state, out, counts, frame_ms, seen = frames_run(
        phase, path, dev, bundle, accel, config, mcfg, frames, window, expect, smi, rays,
        schedule=schedule, per_frame=learned)
    check_mcpg_finite(path, state, out)
    return state, out, counts, frame_ms, tuple(list(x) for x in zip(*seen))


def guided_population(bundle, accel, config, mcfg, state, frame):
    """One more MCPG frame with the surface pass's traces recorded: returns
    (the new state, [(origin, direction, t_max) of each bounce segment])
    — the rays as the frame hands them to K1 or K3 (dead lanes t_max -1)."""
    from merian_quake_tpu_torch.render.mcpg import surface
    from merian_quake_tpu_torch.render.trace import T_MAX
    from merian_quake_tpu_torch.renderer import render_frame

    plain, seen = surface.trace_ray, []

    def record(acc, atlas, uniforms, pos, wi, *a, active=None, **k):
        seen.append((pos.contiguous(), wi.contiguous(),
                     torch.where(active, T_MAX, -1.0).contiguous()))
        return plain(acc, atlas, uniforms, pos, wi, *a, active=active, **k)

    surface.trace_ray = record
    try:
        state, _ = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=frame), config,
                                state, mcfg)
    finally:
        surface.trace_ray = plain
    if len(seen) != MPL - 1 or seen[0][0].shape[0] != SPP * W * H:
        raise AssertionError("the surface pass traced other populations than spp·W·H a segment")
    return state, seen


def phase16(dev, bundle, accel, config, c16, smi):
    """City MCPG at 1080p: 16 frames from an empty state, no host read in
    a steady frame, the sorted-bounce A/B, the guided ray population, and
    one reading under a trace schedule on city(1600)."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.render.mcpg import surface
    from merian_quake_tpu_torch.renderer import render_frame

    config, mcfg = mcpg_scene_config(config)
    state, out, counts, frame_ms, (live, applied) = mcpg_frames(
        16, "mcpg city", dev, bundle, accel, config, mcfg, 16, (12, 16), {"woop_nearest": 3}, smi)
    if counts != {**{k: 0 for k in counts}, "woop_nearest": 48}:
        raise AssertionError(f"the city MCPG frames launched {counts}, expected K1 alone, 48 times")
    if not (live[0] > 0 and live[-1] > live[0] and applied[0] > 0
            and all(b > a for a, b in zip(applied, applied[1:]))):
        raise AssertionError(f"guiding does not learn: states {live}, light cache {applied}")

    # a steady default frame reads no device value from the host: any
    # synchronizing call raises under this mode
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, out = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=16), config,
                                  state, mcfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("phase 16 mcpg city frame 16 under torch.cuda.set_sync_debug_mode('error'): no "
        "synchronizing call")

    state, pops = guided_population(bundle, accel, config, mcfg, state, 17)

    # the bounce coherence sort on the guided frame: as they lie, sorted,
    # sorted, as they lie; one frame a turn, 2 turns each
    plain = surface.trace_ray
    ab = {"none": [], "sort": []}
    try:
        for i, label in enumerate(("none", "sort", "sort", "none", "none", "sort", "sort", "none")):
            surface.trace_ray = plain if label == "none" else (
                lambda *a, **k: plain(*a, **{**k, "sort_rays": True}))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, out = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=18 + i),
                                      config, state, mcfg)
            torch.cuda.synchronize()
            ab[label].append((time.perf_counter() - t0) * 1e3)
    finally:
        surface.trace_ray = plain
    check_mcpg_finite("mcpg city after the A/B", state, out)
    last = (config, mcfg, bundle.uniforms._replace(frame=25), state, out)
    log(f"phase 16 mcpg city bounce sort A/B [{smi}]: as they lie "
        f"{' / '.join(f'{x:.1f}' for x in ab['none'])} ms/frame, sorted "
        f"{' / '.join(f'{x:.1f}' for x in ab['sort'])} ms/frame (frames 18-25, host clock)")

    # one reading under a trace schedule, on city(1600): default routes
    # against TraceSchedule(True, 8, 32) (the two bounce segments sorted by
    # the target key; the visit list and the compacting node walk for all three)
    b16, a16, c16cfg, _ = c16
    cfg16, _ = mcpg_scene_config(c16cfg)
    sched_paths = {}
    for path, sched, expect in (
        ("mcpg_1600", None, {"woop_nearest": 3}),
        ("mcpg_1600_nodes_compact", woop.TraceSchedule(True, 8, 32),
         {"target_keys": 2, "visit_list": 3, "woop_list": 3, "woop_list_nodes": 3,
          "woop_list_compact": 3}),
    ):
        _, _, sched_paths[path], _, _ = mcpg_frames(
            16, path, dev, b16, a16, cfg16, mcfg, 6, (2, 6), expect, smi, schedule=sched)
    return (counts, sched_paths, pops, {"ms": float(np.mean(frame_ms[12:16])), "cold": frame_ms[0]},
            last)


def phase17(dev, bundle, accel, config, smi):
    """Map MCPG at 1080p: 9 frames, exactly 3 K3 launches a frame and no
    K1; then the guided ray population of frame 9."""
    cfg, mcfg = mcpg_scene_config(config)
    state, _, counts, frame_ms, (live, applied) = mcpg_frames(
        17, "mcpg map", dev, bundle, accel, cfg, mcfg, 9, (6, 9), {"woop_stream": 3}, smi)
    if counts != {**{k: 0 for k in counts}, "woop_stream": 27}:
        raise AssertionError(f"the map MCPG frames launched {counts}, expected K3 alone, 27 times")
    if not (live[-1] > live[0] > 0 and applied[-1] > applied[0] > 0):
        raise AssertionError(f"guiding does not learn on the map: {live}, {applied}")
    _, pops = guided_population(bundle, accel, cfg, mcfg, state, 9)
    return counts, pops, {"ms": float(np.mean(frame_ms[6:9])), "cold": frame_ms[0]}


def phase18(dev, name, accel, pop, kernel, other, smi, what="mcpg bounce", phase=18):
    """K1 (city) or K3 (map) on one MCPG bounce segment's rays (or on
    another population ``what``): against its plain version on a
    65,536-ray subset and against the other route, forced, on the whole
    population, bit for bit; time in turns, pairs tested, bound and lane
    use."""
    from merian_quake_tpu_torch.accel import woop

    o, d, t_max = pop
    n = o.shape[0]
    kname = "K1" if kernel is woop.woop_nearest else "K3"
    oname = "K3" if kernel is woop.woop_nearest else "K1"
    mid = slice(n // 2, n // 2 + SUBSET)
    sub = woop.k1_inputs(accel, o[mid].contiguous(), d[mid].contiguous(),
                         torch.zeros(SUBSET, device=dev), t_max[mid].contiguous())
    errs = [check_exact(phase, f"{name} {what} {SUBSET} {kname} vs plain", kernel(*sub),
                        woop.intersect_woop_reference(sub[0], sub[1]))]
    args = woop.k1_inputs(accel, o, d, torch.zeros(n, device=dev), t_max)
    if args[0].shape[1] % 128:
        raise AssertionError("the packed ray count is not a multiple of 128")
    errs.append(check_exact(phase, f"{name} {what} {n} {kname} vs {oname} forced",
                            kernel(*args), other(*args)))
    k, f = (lambda: kernel(*args)), (lambda: other(*args))
    k_1, f_1, f_2, k_2 = cuda_time(k, 10), cuda_time(f, 10), cuda_time(f, 10), cuda_time(k, 10)
    p_1 = cuda_time(lambda: woop.intersect_woop_reference(sub[0], sub[1]), 1)
    s_1 = cuda_time(lambda: kernel(*sub), 10)
    ops, nbytes = woop_work(kernel, args)
    bnd, by = bound_ms(ops, nbytes)
    split = trace_split(phase, f"{name} {what} {kname}", kernel, args, smi)
    live = float((t_max > 0).float().mean())
    log(f"phase {phase} timing {name} {what} {n} rays (live {live:.4f}) [{smi}]: {kname} "
        f"{k_1:.3f} / {k_2:.3f} ms, {oname} forced {f_1:.3f} / {f_2:.3f} ms; on {SUBSET} rays "
        f"plain {p_1:.1f} ms, {kname} {s_1:.3f} ms; bound {bnd:.4f} ms ({by}; "
        f"{ops / OPS_NEAREST:.4g} pairs tested); lane use {split['lane_use']:.4f}")
    return {"ms": (k_1 + k_2) / 2, "other_ms": (f_1 + f_2) / 2, "plain_ms_subset": p_1,
            "ms_subset": s_1, "bound_ms": bnd, "bound_by": by, "lane_use": split["lane_use"],
            "rays": n, "live": live, "max_abs_err": max(errs)}


# phase 19's bounds, read on an NVIDIA H100 80GB HBM3 (700 W) against its
# host's CPU, the same in three runs: after 4 frames at 64x36 the LDR
# images' mean |d| read 1.037e-5, the states with sum_w > 0 16,643 (CPU)
# and 16,644 (card), the touched light-cache cells 11,736 on both. Pinned
# with at most twice that room (two of a count that read equal or one apart).
MCPG_LDR_MEAN_4 = 2e-5
MCPG_COUNT_ABS = 2
# 64 accumulated frames of mcpg and of pt, mean irradiance on the pixels
# the image uses: both estimate the same integral (read 0.0043 apart)
ESTIMATOR_REL = 0.01


def phase19(dev):
    """MCPG at 64×36 on city: the CPU oracle against the card (frame 0
    inside PT's tolerance; after 4 frames the LDR, the live chain states
    and the touched light-cache cells inside pinned bounds), and the
    estimator against PT's on the card after 64 accumulated frames."""
    from merian_quake_tpu_torch.capture import WARMUP_STEPS
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.renderer import render_sequence

    small = RenderConfig(width=64, height=36, spp=SPP, max_path_length=MPL, integrator="mcpg")
    mcfg = MCPGConfig()
    for frames in (1, 4):
        k1 = launches()["woop_nearest"]
        sc, oc = render_sequence(city(device="cpu"), small, frames=frames, mcpg_config=mcfg,
                                 device="cpu")
        if launches()["woop_nearest"] != k1:
            raise AssertionError("the CPU MCPG frames launched K1")
        sg, og = render_sequence(city(device="cpu"), small, frames=frames, mcpg_config=mcfg)
        # render_sequence runs a captured frame on the card: the wrappers
        # launch during its warm-up frames and record into the graph once
        if launches()["woop_nearest"] != k1 + 3 * (WARMUP_STEPS + 1) or og["ldr"].device != dev:
            raise AssertionError("the card's MCPG frames did not launch K1 3 times a frame "
                                 "through the wrapper in the capture's warm-up and capture")
        diff = (oc["ldr"] - og["ldr"].cpu()).abs()
        share = float((diff.amax(-1) <= PIX_TOL).float().mean())
        mean = float(diff.mean())
        counts = {
            "states": (int((sc.mcpg.mc.sum_w > 0).sum()), int((sg.mcpg.mc.sum_w > 0).sum())),
            "lc cells": (int((sc.mcpg.lc.N > 0).sum()), int((sg.mcpg.lc.N > 0).sum())),
        }
        same_i = float((sc.mcpg.mc.i == sg.mcpg.mc.i.cpu()).all(-1).float().mean())
        log(f"phase 19 mcpg cpu vs cuda 64x36 x{frames} frames: pixels within {PIX_TOL} "
            f"{share:.5f}, mean |d| {mean:.3e}, max |d| {float(diff.max()):.3e}; (cpu, card) "
            f"{counts}; mc.i rows equal {same_i:.6f}")
        if share < PIX_SHARE or mean >= (MEAN_TOL if frames == 1 else MCPG_LDR_MEAN_4):
            raise AssertionError(f"MCPG x{frames}: CPU and card LDR images disagree")
        for what, (a, b) in counts.items():
            if a <= 0 or abs(a - b) > MCPG_COUNT_ABS:
                raise AssertionError(f"MCPG x{frames}: {what} differ, cpu {a} card {b}")

    means = {}
    for integrator in ("mcpg", "pt"):
        cfg = small._replace(integrator=integrator)
        st, _ = render_sequence(city(device="cpu"), cfg, frames=64,
                                mcpg_config=mcfg if integrator == "mcpg" else None)
        used = st.accum_albedo[..., :3].amax(-1) > 0
        means[integrator] = float(st.accum_irradiance[..., :3][used].mean())
    rel = abs(means["mcpg"] - means["pt"]) / means["pt"]
    log(f"phase 19 estimator 64x36 x64 accumulated frames on the card: mean irradiance on the "
        f"pixels the image uses mcpg {means['mcpg']:.5f}, pt {means['pt']:.5f}, relative "
        f"difference {rel:.4f} (bound {ESTIMATOR_REL})")
    if rel > ESTIMATOR_REL:
        raise AssertionError("the guided estimator and the path tracer's disagree")


# the fogged court's extinction: optically thin over the court's depth
# (the camera sees 100-900 units of fog), so the medium scatters visibly
FOG_MU_T = 0.002
# the fogged court's CPU-vs-card bounds at 64x36 after 4 frames: those of
# tests/test_torch_volume_slice.py, read from the JAX package's own
# jitted-vs-op-by-op spread (the image border's history validity is an
# ulp's decision under a still camera)
VOLUME_LDR = (0.94, 2.55e-3)
VOLUME_IMAGE = (0.995, 1e-5)
# the court's CPU-vs-card LDR bound: tests/test_torch_scenes.py's against
# the JAX package's jitted run, read from its own jitted-vs-op-by-op
# spread (98.48%, 3.10e-4): the grates' alpha test and the water's
# warped texels turn on the hit's barycentrics, which the Woop test and
# the oracle's Möller-Trumbore round apart
COURT_LDR = (0.98, 3.9e-4)


class AlphaLoop:
    """Counts and times ``trace_nearest``'s alpha re-trace loop on the card:
    while installed, every ``intersect`` call (one K1 or K3 launch on the
    card) and every ``trace_nearest`` call given a texture atlas (the
    loop) is counted; each loop reads one device value a round on the
    host (``bool(active.any())``), so its host reads are its rounds plus
    one where it stopped early. CUDA events and the host clock around
    each loop give its device and host time."""

    def __init__(self):
        import importlib

        # the modules (accel/__init__ binds the name ``intersect`` to a function)
        imod = importlib.import_module("merian_quake_tpu_torch.accel.intersect")
        tmod = importlib.import_module("merian_quake_tpu_torch.render.trace")
        self.mods = (imod, tmod)
        self.plain_intersect, self.plain_nearest = imod.intersect, imod.trace_nearest
        self.reset()

    def reset(self):
        self.intersects = self.loops = self.rounds = self.reads = 0
        self.events, self.host_s = [], 0.0

    def _intersect(self, *a, **k):
        self.intersects += 1
        return self.plain_intersect(*a, **k)

    def _nearest(self, accel, tex, *a, **k):
        if tex is None:
            return self.plain_nearest(accel, tex, *a, **k)
        from merian_quake_tpu_torch.models import materials

        n0 = self.intersects
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        out = self.plain_nearest(accel, tex, *a, **k)
        e1.record()
        self.host_s += time.perf_counter() - t0
        self.events.append((e0, e1))
        rounds = self.intersects - n0
        self.loops += 1
        self.rounds += rounds
        self.reads += rounds + (rounds < materials.MAX_INTERSECTIONS)
        return out

    def __enter__(self):
        imod, tmod = self.mods
        imod.intersect, imod.trace_nearest, tmod.trace_nearest = (
            self._intersect, self._nearest, self._nearest)
        return self

    def __exit__(self, *exc):
        imod, tmod = self.mods
        imod.intersect, imod.trace_nearest, tmod.trace_nearest = (
            self.plain_intersect, self.plain_nearest, self.plain_nearest)

    def device_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def sync_sites(fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")`` and
    return (its result, the file:line of each synchronizing call)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in seen
                 if "synchroniz" in str(w.message)]


def court(dev, fog=0.0):
    """The outdoor court (two alpha-tested grates, sky, sun, water; fog
    ``fog``), its accel and its 1080p config."""
    from merian_quake_tpu_torch.accel import build_accel
    from merian_quake_tpu_torch.accel.build import scene_features
    from merian_quake_tpu_torch.models.procedural import outdoor_court
    from merian_quake_tpu_torch.models.types import RenderConfig

    bundle = outdoor_court(fog, device=dev)
    accel = build_accel(bundle.scene, bundle.atlas)
    feats = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    if not feats.has_alpha_tris or accel.woop_w_alpha is None:
        raise AssertionError("the court has no alpha-tested triangles")
    return bundle, accel, RenderConfig(width=W, height=H, spp=SPP, max_path_length=MPL,
                                       features=feats)


def court_frames(phase, path, dev, bundle, accel, config, mcfg, frames, window, rays, smi):
    """``frames`` frames of a court path at 1080p with the launch counts set
    to 0 just before and read just after; every frame's K1 launches equal
    its ``intersect`` calls (the alpha loop's rounds among them) and it
    launches nothing else but K2 on ReSTIR's visibility; then one more
    frame whose synchronizing calls are counted against the alpha loop's
    host reads. Returns (state, out, the path's launches, {"ms", "cold",
    the per-frame loop numbers})."""
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    state = init_state(config, mcfg, device=dev)
    probe = AlphaLoop()
    reset_launches()
    frame_ms, per = [], []
    with probe:
        for i in range(frames + 1):
            before = launches()
            probe.reset()
            step = lambda: render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=i),
                                        config, state, mcfg)
            if i == frames:  # the extra frame: its synchronizing calls
                (state, out), sites = sync_sites(step)
                syncs = len(sites)
                loop_dev = probe.device_ms()
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, out = step()
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t0) * 1e3)
            got = {k: v - before[k] for k, v in launches().items()}
            k2 = got.pop("woop_any")
            if (got["woop_nearest"] != probe.intersects or any(v for k, v in got.items()
                                                               if k != "woop_nearest")
                    or (k2 > 0) != (config.integrator == "restir") or probe.rounds <= probe.loops):
                raise AssertionError(f"{path} frame {i}: launched {got} and K2 {k2} for "
                                     f"{probe.intersects} intersect calls, {probe.loops} alpha "
                                     f"loops of {probe.rounds} rounds")
            if i < frames:
                per.append((got["woop_nearest"], k2, probe.loops, probe.rounds, probe.reads,
                            probe.host_s * 1e3, probe.device_ms()))
    counts = launches()
    for name, x in (("ldr", out["ldr"]), ("hdr", out["hdr"]),
                    ("accum_irradiance", state.accum_irradiance)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{path} {name} is not finite")
    if tuple(out["ldr"].shape) != (H, W, 3) or float(out["ldr"].std()) <= 0.0:
        raise AssertionError(f"{path} ldr has the wrong shape or is constant")
    if syncs < probe.reads:
        raise AssertionError(f"{path}: {syncs} synchronizing calls, fewer than the alpha "
                             f"loop's {probe.reads} host reads")
    lo, hi = window
    steady = float(np.mean(frame_ms[lo:hi]))
    k1, k2, loops, rounds, reads, host_ms, dev_ms = (float(np.mean(c)) for c in zip(*per[lo:hi]))
    log(f"phase {phase} {path} {W}x{H} spp {config.spp} mpl {config.max_path_length} [{smi}]: "
        f"launches { {k: v for k, v in counts.items() if v} }; cold {frame_ms[0]:.1f} ms, mean of "
        f"frames {lo}-{hi - 1} {steady:.1f} ms/frame, {rays / steady / 1e3:.2f} Mrays/s (frames "
        f"{', '.join(f'{x:.1f}' for x in frame_ms)}); a frame (mean of the same): K1 {k1:.1f}, "
        f"K2 {k2:.1f}, alpha loops {loops:.1f} of {rounds:.1f} rounds, {reads:.1f} host reads, "
        f"the loops {host_ms:.2f} ms on the host clock and {dev_ms:.2f} ms between their CUDA "
        f"events; frame {frames}: {syncs} synchronizing calls, the loops' reads {probe.reads} "
        f"(loops {loop_dev:.2f} ms on the device); ldr mean {float(out['ldr'].mean()):.4f}")
    return state, out, counts, {"ms": steady, "cold": frame_ms[0], "k1_per_frame": k1,
                                "alpha_loops": loops, "alpha_rounds": rounds,
                                "host_reads": reads, "loop_host_ms": host_ms,
                                "loop_device_ms": dev_ms, "syncs": syncs}


def cpu_vs_card(phase, name, bundle_fn, config, mcfg, frames, bounds, report=()):
    """``frames`` frames of a small ``config`` on the CPU (oracle) and on
    the card: each output of ``bounds`` ({key: (share within 1e-3, mean |d|)})
    within its bound; the outputs in ``report`` printed beside them."""
    from merian_quake_tpu_torch.renderer import render_sequence

    k1 = launches()["woop_nearest"]
    _, oc = render_sequence(bundle_fn(), config, frames=frames, mcpg_config=mcfg, device="cpu")
    _, og = render_sequence(bundle_fn(), config, frames=frames, mcpg_config=mcfg)
    if launches()["woop_nearest"] == k1 or og["ldr"].device.type != "cuda":
        raise AssertionError(f"{name}: the card's frames did not launch K1")
    for key, (share_min, mean_max) in bounds.items():
        diff = (oc[key] - og[key].cpu()).abs()
        share = float((diff.amax(-1) <= PIX_TOL).float().mean())
        mean = float(diff.mean())
        log(f"phase {phase} {name} cpu vs cuda {config.width}x{config.height} x{frames} frames "
            f"{key}: pixels within {PIX_TOL} {share:.5f} (bound {share_min}), mean |d| "
            f"{mean:.3e} (bound {mean_max}), max |d| {float(diff.max()):.3e}")
        if share < share_min or mean >= mean_max:
            raise AssertionError(f"{name} {key}: CPU and card images disagree")
    for key in report:
        diff = (oc[key] - og[key].cpu()).abs()
        share = float((diff.amax(-1) <= PIX_TOL).float().mean())
        log(f"phase {phase} {name} cpu vs cuda {config.width}x{config.height} x{frames} frames "
            f"{key} (not held): pixels within {PIX_TOL} {share:.5f}, mean |d| "
            f"{float(diff.mean()):.3e}, max |d| {float(diff.max()):.3e}")


def phase20(dev, smi):
    """The court at 1080p: PT, ReSTIR and MCPG frames with their alpha
    loops counted; CPU against card at 64x36."""
    from merian_quake_tpu_torch.models.procedural import outdoor_court
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig

    bundle, accel, config = court(dev)
    rays = W * H * (1 + SPP * (MPL - 1))
    paths, stats = {}, {}
    for integrator, mcfg in (("pt", None), ("restir", ReSTIRConfig()), ("mcpg", MCPGConfig())):
        _, _, paths[f"court_{integrator}"], stats[integrator] = court_frames(
            20, f"court {integrator}", dev, bundle, accel, config._replace(integrator=integrator),
            mcfg, 6, (2, 6), rays, smi)
    small = RenderConfig(width=64, height=36, spp=SPP, max_path_length=MPL)
    for integrator, mcfg in (("pt", None), ("restir", ReSTIRConfig()), ("mcpg", MCPGConfig())):
        # MCPG: frame 0 (unguided), as phase 19 holds city's
        cpu_vs_card(20, f"court {integrator}", lambda: outdoor_court(device="cpu"),
                    small._replace(integrator=integrator), mcfg,
                    1 if integrator == "mcpg" else 2, {"ldr": COURT_LDR})
    return paths, stats


def volume_population(bundle, accel, config, mcfg, state, frame):
    """One more volume frame with the volume pass's traces recorded:
    returns (the new state, [(origin, direction, t_max) of each volume
    sample]) as the pass hands them to ``trace_ray`` (every ray live)."""
    from merian_quake_tpu_torch.render.mcpg import volume
    from merian_quake_tpu_torch.render.trace import T_MAX
    from merian_quake_tpu_torch.renderer import render_frame

    plain, seen = volume.trace_ray, []

    def record(acc, atlas, uniforms, pos, wi, *a, **k):
        seen.append((pos.contiguous(), wi.contiguous(), torch.full_like(pos[:, 0], T_MAX)))
        return plain(acc, atlas, uniforms, pos, wi, *a, **k)

    volume.trace_ray = record
    try:
        state, _ = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=frame), config,
                                state, mcfg)
    finally:
        volume.trace_ray = plain
    if len(seen) != mcfg.volume.volume_spp or seen[0][0].shape[0] != W * H:
        raise AssertionError("the volume pass traced other populations than W·H a sample")
    return state, seen


def phase21(dev, smi):
    """The fogged court, MCPG + VolumeConfig(), at 1080p: 9 frames, the
    distance states learning; K1 on the volume pass's scatter rays; CPU
    against card at 64x36 over 4 frames."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.models.procedural import outdoor_court
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig

    bundle, accel, config = court(dev, FOG_MU_T)
    config = config._replace(integrator="mcpg")
    mcfg = MCPGConfig(volume=VolumeConfig())
    rays = W * H * (1 + SPP * (MPL - 1) + mcfg.volume.volume_spp)
    seen_live = []
    from merian_quake_tpu_torch import renderer

    plain_frame = renderer.render_frame

    def frame_and_states(*a, **k):
        out = plain_frame(*a, **k)
        seen_live.append(out[0].volume.dist_mc.sum_w)
        return out

    renderer.render_frame = frame_and_states
    try:
        state, out, counts, stats = court_frames(21, "court fog mcpg + volume", dev, bundle, accel,
                                                 config, mcfg, 9, (6, 9), rays, smi)
    finally:
        renderer.render_frame = plain_frame
    live = [int((x > 0).sum()) for x in seen_live]
    vol = out["volume"]
    if not (bool(torch.isfinite(state.accum_volume).all()) and float(vol[..., :3].mean()) > 0.0):
        raise AssertionError("the fogged court's volume image is not finite or is black")
    if not (live[0] > 0 and live[-1] > live[0]):
        raise AssertionError(f"the distance states do not learn: {live}")
    log(f"phase 21 court fog (mu_t {FOG_MU_T}) distance-MC states with sum_w > 0 per frame {live} "
        f"(of {state.volume.dist_mc.sum_w.numel()}); chain states with sum_w > 0 "
        f"{int((state.mcpg.mc.sum_w > 0).sum())}; volume image mean "
        f"{float(vol[..., :3].mean()):.5f}, accumulated {float(state.accum_volume[..., :3].mean()):.5f}")

    _, pops = volume_population(bundle, accel, config, mcfg, state, 10)
    g_vol = phase18(dev, "court fog", accel, pops[0], woop.woop_nearest, woop.woop_stream, smi,
                    what="volume scatter", phase=21)

    small = RenderConfig(width=64, height=36, spp=1, max_path_length=MPL, integrator="mcpg")
    cpu_vs_card(21, "court fog mcpg + volume", lambda: outdoor_court(FOG_MU_T, device="cpu"),
                small, mcfg, 4, {"ldr": VOLUME_LDR, "volume": VOLUME_IMAGE})
    return counts, stats, g_vol


def phase22(dev, bundle, accel, config, smi):
    """``production_config()`` on city at 1080p: two settle frames, then 9
    frames from an empty state (bench.py's window, frames 6-8), exactly 3
    + volume_spp K1 launches a frame; peak device memory; one
    ``pack_states_draw``; a steady frame with no synchronizing call."""
    from merian_quake_tpu_torch.render.mcpg import grids
    from merian_quake_tpu_torch.render.mcpg.config import production_config
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    cfg, _ = mcpg_scene_config(config)
    prod = production_config()
    state = init_state(cfg, prod, device=dev)
    for i in range(2):  # settle: the caching allocator's first frames
        state, _ = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=1000 + i), cfg,
                                state, prod)
    del state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    k1 = 3 + prod.volume.volume_spp
    rays = W * H * (1 + SPP * (MPL - 1) + prod.volume.volume_spp)
    state, out, counts, frame_ms, (live, applied) = mcpg_frames(
        22, "production city", dev, bundle, accel, cfg, prod, 9, (6, 9), {"woop_nearest": k1}, smi,
        rays=rays)
    peak = torch.cuda.max_memory_allocated()
    if counts != {**{k: 0 for k in counts}, "woop_nearest": 9 * k1}:
        raise AssertionError(f"the production frames launched {counts}, expected K1 alone")
    if not (live[-1] > live[0] > 0 and applied[-1] > applied[0] > 0):
        raise AssertionError(f"production guiding does not learn: {live}, {applied}")
    dist_live = int((state.volume.dist_mc.sum_w > 0).sum())
    pack = cuda_time(lambda: grids.pack_states_draw(state.mcpg.mc, bundle.uniforms.cl_time), 5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, out = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=9), cfg,
                                  state, prod)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check_mcpg_finite("production city", state, out)
    steady = float(np.mean(frame_ms[6:9]))
    log(f"phase 22 production city [{smi}]: {prod.mc_total_size} chain states, {prod.lc_size} "
        f"light-cache cells, volume spp {prod.volume.volume_spp}; cold {frame_ms[0]:.1f} ms, "
        f"frames 6-8 {steady:.1f} ms/frame = {rays / steady / 1e3:.2f} Mrays/s ({rays} rays a "
        f"frame); peak device memory {peak / 2**30:.3f} GiB; one pack_states_draw {pack:.3f} ms "
        f"(a {state.mcpg.mc.f.shape[0]} x 8 table); distance states with sum_w > 0 "
        f"{dist_live} (city has no fog: mu_t = 0, nothing scatters); frame 9 under torch.cuda.set_sync_debug_mode('error'): no synchronizing "
        f"call")
    return counts, {"ms": steady, "cold": frame_ms[0], "peak_bytes": peak, "pack_ms": pack}


def spread_bound(share, mean, margin=0.02):
    """A denoised frame's CPU-vs-card bound at 64x36 over 3 frames: the
    sequence bound of tests/test_torch_denoise_slice.py (cornell_box PT),
    test_torch_ssmm_slice.py (cornell_box SSMM) or
    test_torch_denoise_volume.py (the fogged court, ``margin`` 0.05), read
    from the JAX package's own jitted-vs-op-by-op spread
    (scripts/denoise_spread.py): its share within 1e-3 less ``margin``,
    1.25x its mean |d|."""
    return share - margin, 1.25 * mean


# The card's trace (Woop) and the CPU oracle (Moller-Trumbore) round hit
# distances and motion vectors apart, so under a still camera SVGF's history
# validity flips on the image border (1.6% of the box's pixels) and CUDA's
# exp and pow differ from the CPU's by an ulp: the denoised HDR image's
# CPU-vs-card spread on the box (56.8% within 1e-3, mean 7.85e-3; PR 11
# call 2) is wider than the JAX package's own (70.6%, 3.16e-3). So the LDR
# image is held to the test's bound, the HDR image is printed, and the chain
# itself is held on identical inputs (chain_cpu_vs_card).
DENOISE_PT = {"ldr": spread_bound(0.13845, 7.573e-3)}
DENOISE_VOLUME = {"ldr": spread_bound(0.44748, 2.149e-3, 0.05),
                  "volume": spread_bound(0.99826, 1.139e-4, 0.05)}
# SSMM's chains drift between the CPU and the card as between the JAX
# package's two runs, so its raw irradiance is held to that spread (the
# pass the denoiser does not feed back into); the denoiser spreads a moved
# chain's pixel, so the denoised SSMM images are printed (LDR 27.9% within
# 1e-3, mean 8.63e-3 on the box; PR 11 call 3)
SSMM_IRRADIANCE = {"irradiance": spread_bound(0.93620, 9.740e-2)}
# the chain on identical inputs, CPU against card: tests/test_torch_post.py's
# filter tolerance for SVGF and TAA; FXAA's edge decisions turn on an ulp of
# its input (96.9% of pixels within 1e-3, PR 11 call 2)
CHAIN_TOL = dict(rtol=1e-5, atol=1e-6)
FXAA_SHARE = 0.95
# tests/test_ssmm.py:55-57: accumulated SSMM within 15% of PT's mean
SSMM_ESTIMATOR_REL = 0.15


class DenoiseSplit:
    """CUDA events around the denoise chain's stages while installed: each
    ``svgf`` call (one an SVGF instance: the surface's, then the volume's),
    its ``temporal`` and ``svgf_filter`` (the à-trous passes), ``taa`` and
    ``fxaa``. A frame ends with its ``fxaa``. Exposure and tonemap (with
    the first-hit emission and the volume added) are the time between the
    last SVGF's end and TAA's start."""

    STAGES = ("svgf", "temporal", "svgf_filter", "taa", "fxaa")

    def __init__(self):
        import importlib

        mod = importlib.import_module
        self.owner = {"svgf": mod("merian_quake_tpu_torch.post.svgf"),
                      "temporal": mod("merian_quake_tpu_torch.post.svgf"),
                      "svgf_filter": mod("merian_quake_tpu_torch.post.svgf"),
                      "taa": mod("merian_quake_tpu_torch.post.taa"),
                      "fxaa": mod("merian_quake_tpu_torch.post.fxaa")}
        self.plain = {s: getattr(self.owner[s], s) for s in self.STAGES}
        self.frames, self.cur = [], []

    def _timed(self, stage):
        plain = self.plain[stage]

        def run(*a, **k):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = plain(*a, **k)
            e1.record()
            self.cur.append((stage, e0, e1))
            if stage == "fxaa":
                self.frames.append(self.cur)
                self.cur = []
            return out
        return run

    def __enter__(self):
        for s in self.STAGES:
            setattr(self.owner[s], s, self._timed(s))
        return self

    def __exit__(self, *exc):
        for s in self.STAGES:
            setattr(self.owner[s], s, self.plain[s])

    def frame(self, i) -> dict:
        """Frame ``i``'s device ms by stage."""
        torch.cuda.synchronize()
        rec = self.frames[i]
        ms = lambda a, b: a.elapsed_time(b)
        of = lambda s: [(e0, e1) for st, e0, e1 in rec if st == s]
        inst = of("svgf")
        (taa0, taa1), (fx0, fx1) = of("taa")[0], of("fxaa")[0]
        return {"svgf_instances": [ms(a, b) for a, b in inst],
                "temporal": sum(ms(a, b) for a, b in of("temporal")),
                "atrous": sum(ms(a, b) for a, b in of("svgf_filter")),
                "exposure_tonemap": ms(inst[-1][1], taa0), "taa": ms(taa0, taa1),
                "fxaa": ms(fx0, fx1), "chain": ms(inst[0][0], fx1)}

    def mean(self, lo, hi) -> dict:
        per = [self.frame(i) for i in range(lo, hi)]
        out = {k: float(np.mean([p[k] for p in per])) for k in per[0] if k != "svgf_instances"}
        out["svgf_instances"] = [float(x) for x in np.mean([p["svgf_instances"] for p in per], 0)]
        return out


def split_text(s: dict) -> str:
    inst = " + ".join(f"{x:.2f}" for x in s["svgf_instances"])
    return (f"denoise chain {s['chain']:.2f} ms on the device: SVGF {inst} ms (temporal "
            f"{s['temporal']:.2f}, a-trous {s['atrous']:.2f}), exposure + tonemap "
            f"{s['exposure_tonemap']:.2f}, TAA {s['taa']:.2f}, FXAA {s['fxaa']:.2f}")


def chain_cpu_vs_card(phase, smi):
    """The denoise chain on identical seeded inputs at 256x144 (two depth
    planes, a normal flip, a flat block, motion vectors), on the CPU and
    on the card: three SVGF frames (output and every state field), TAA,
    FXAA and the auto exposure."""
    from merian_quake_tpu_torch.post import exposure, fxaa, svgf, taa

    r = np.random.default_rng(3)
    h, w = 144, 256
    irr = r.gamma(1.0, 0.5, (h, w, 3)).astype(np.float32)
    irr[20:40, 20:40] = 0.5
    mom = (irr.mean(-1) ** 2 * 2.0).astype(np.float32)
    mv = r.normal(0, 1.5, (h, w, 2)).astype(np.float32)
    n = np.zeros((h, w, 3), np.float32)
    n[..., 2] = 1.0
    n[:, w // 2:] = [1.0, 0.0, 0.0]
    n += r.normal(0, 0.05, n.shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    z = (np.where(np.arange(w)[None] < w // 3, 50.0, 500.0) * np.ones((h, 1))
         + r.uniform(0, 1, (h, w))).astype(np.float32)
    zg = r.uniform(0, 2, (h, w, 2)).astype(np.float32)
    alb = r.uniform(0, 1, (h, w, 3)).astype(np.float32)
    res = {}
    for dev in ("cpu", "cuda"):
        a = [torch.from_numpy(x).to(dev) for x in (irr, mom, mv, n, z, zg, alb)]
        st = svgf.init_svgf_state(h, w, device=dev)
        for _ in range(3):
            st, out = svgf.svgf(st, *a)
        ldr = out / (1.0 + out)
        t = taa.taa(ldr * 0.9, ldr, a[2])
        res[dev] = (out, t, fxaa.fxaa(t), exposure.auto_exposure(out)[1], st)
    (o_c, t_c, f_c, e_c, s_c), (o_g, t_g, f_g, e_g, s_g) = res["cpu"], res["cuda"]
    close = lambda x, y: bool(torch.allclose(y.cpu(), x, **CHAIN_TOL))
    rel = lambda x, y: float(((y.cpu() - x).abs() / (x.abs() + 1e-6)).max())
    fx = float(((f_g.cpu() - f_c).abs().amax(-1) <= PIX_TOL).float().mean())
    log(f"phase {phase} denoise chain cpu vs cuda on identical 256x144 inputs: svgf max rel "
        f"{rel(o_c, o_g):.3e}, state max rel {max(rel(x, y) for x, y in zip(s_c, s_g)):.3e}, taa "
        f"{rel(t_c, t_g):.3e}, fxaa pixels within {PIX_TOL} {fx:.5f} (bound {FXAA_SHARE}), "
        f"exposure scale {float(e_c):.6f} / {float(e_g):.6f}")
    if not (close(o_c, o_g) and all(close(x, y) for x, y in zip(s_c, s_g)) and close(t_c, t_g)
            and close(e_c, e_g) and fx >= FXAA_SHARE):
        raise AssertionError("the denoise chain differs between the CPU and the card")


def scene_1080(bundle, **kw):
    """A bundle's accel and its 1080p config (``kw`` on top)."""
    from merian_quake_tpu_torch.accel import build_accel
    from merian_quake_tpu_torch.accel.build import scene_features
    from merian_quake_tpu_torch.models.types import RenderConfig

    accel = build_accel(bundle.scene, bundle.atlas)
    feats = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    return accel, RenderConfig(width=W, height=H, features=feats, **kw)


def phase23(dev, bundle, accel, config, undenoised, smi):
    """The denoised main path: city MCPG at 1080p with ``denoise=True``,
    16 frames (3 K1 a frame), the denoise chain's split, a steady frame
    with no synchronizing call; config3's render setup (ReSTIR, 1 spp,
    denoise, cornell_box, 8 frames); cornell_box PT denoised at 64x36 on
    the CPU against the card."""
    from merian_quake_tpu_torch.models.procedural import cornell_box
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.renderer import render_frame

    config, mcfg = mcpg_scene_config(config)
    config = config._replace(denoise=True)
    with DenoiseSplit() as split:
        state, out, counts, frame_ms, (live, applied) = mcpg_frames(
            23, "mcpg city denoise", dev, bundle, accel, config, mcfg, 16, (12, 16),
            {"woop_nearest": 3}, smi)
        s = split.mean(12, 16)
    if counts != {**{k: 0 for k in counts}, "woop_nearest": 48}:
        raise AssertionError(f"the denoised city MCPG frames launched {counts}, expected K1 alone")
    for name, x in (("svgf.irr", state.svgf.irr), ("svgf.moments", state.svgf.moments),
                    ("taa_prev", state.taa_prev)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"mcpg city denoise {name} is not finite")
    if float(state.svgf.history_len.max()) != 16.0 or bool(state.accum_irradiance.any()):
        raise AssertionError("the SVGF history does not grow, or the plain accumulators moved")
    steady = float(np.mean(frame_ms[12:16]))
    log(f"phase 23 mcpg city denoise [{smi}]: frames 12-15 {steady:.1f} ms/frame against "
        f"{undenoised['ms']:.1f} without denoise (phase 16, same run); {split_text(s)} "
        f"(mean of frames 12-15, CUDA events), {100 * s['chain'] / steady:.1f}% of the frame")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, out = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=16), config,
                                  state, mcfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("phase 23 mcpg city denoise frame 16 under torch.cuda.set_sync_debug_mode('error'): no "
        "synchronizing call")

    # config3's render setup (presets.py:98-108), still camera
    box = cornell_box(device=dev)
    b_accel, b_cfg = scene_1080(box, spp=1, integrator="restir", denoise=True)
    rcfg = ReSTIRConfig(spatial_reuse_iterations=2, temporal_bias_correction=1)
    with DenoiseSplit() as rsplit:
        _, _, restir_counts, r_ms, _ = frames_run(
            23, "restir box denoise (config3)", dev, box, b_accel, b_cfg, rcfg, 8, (4, 8),
            {"woop_nearest": 2, "woop_any": 1}, smi, W * H * 3)
        rs = rsplit.mean(4, 8)
    log(f"phase 23 restir box denoise (config3) [{smi}]: {split_text(rs)} (frames 4-7)")

    chain_cpu_vs_card(23, smi)
    small = RenderConfig(width=64, height=36, spp=SPP, max_path_length=MPL, denoise=True)
    cpu_vs_card(23, "box pt denoise", lambda: cornell_box(device="cpu"), small, None, 3, DENOISE_PT,
                report=("hdr",))
    return counts, restir_counts, {"ms": steady, "cold": frame_ms[0], "split": s,
                                   "undenoised_ms": undenoised["ms"],
                                   "restir_box_ms": float(np.mean(r_ms[4:8])), "restir_split": rs}


def phase24(dev, smi):
    """The second SVGF: the fogged court, MCPG + VolumeConfig(volume_spp=1),
    denoise, 1080p, 2 spp, 9 frames (config5's render setup, still
    camera), both SVGF instances timed; 64x36 CPU against card."""
    from merian_quake_tpu_torch.models.procedural import outdoor_court
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig

    bundle, accel, config = court(dev, FOG_MU_T)
    config = config._replace(integrator="mcpg", denoise=True)
    mcfg = MCPGConfig(volume=VolumeConfig(volume_spp=1))
    rays = W * H * (1 + SPP * (MPL - 1) + 1)
    with DenoiseSplit() as split:
        state, out, counts, stats = court_frames(24, "court fog mcpg + volume denoise", dev, bundle,
                                                 accel, config, mcfg, 9, (6, 9), rays, smi)
        s = split.mean(6, 9)
    if len(s["svgf_instances"]) != 2 or state.volume_svgf is None:
        raise AssertionError("the volume's SVGF did not run")
    for name, x in (("volume_svgf.irr", state.volume_svgf.irr), ("svgf.irr", state.svgf.irr)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"court fog denoise {name} is not finite")
    log(f"phase 24 court fog mcpg + volume denoise [{smi}]: {split_text(s)} (frames 6-8; the "
        f"second SVGF instance is the volume's), {100 * s['chain'] / stats['ms']:.1f}% of the frame")
    small = RenderConfig(width=64, height=36, spp=1, max_path_length=MPL, integrator="mcpg",
                         denoise=True)
    cpu_vs_card(24, "court fog mcpg + volume denoise", lambda: outdoor_court(FOG_MU_T, device="cpu"),
                small, MCPGConfig(volume=VolumeConfig()), 3, DENOISE_VOLUME, report=("hdr",))
    return counts, {**stats, "split": s}


def phase25(dev, bundle, accel, config, smi):
    """SSMM: city at 1080p, 2 spp, 10 frames (1 + spp K1 a frame); the court
    at 1080p, 1 spp, denoise, 8 frames (config4's render setup, still
    camera); cornell_box at 64x36 and 256x8 (tiled buffer order) on the CPU
    against the card; 64 accumulated frames against PT's mean."""
    from merian_quake_tpu_torch.models.procedural import cornell_box
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render import layout
    from merian_quake_tpu_torch.render.ssmm import SSMMConfig
    from merian_quake_tpu_torch.renderer import render_sequence

    scfg = SSMMConfig()
    cfg = config._replace(integrator="ssmm")
    state, out, city_counts, frame_ms, _ = frames_run(
        25, "ssmm city", dev, bundle, accel, cfg, scfg, 10, (4, 10), {"woop_nearest": 1 + SPP}, smi,
        W * H * (1 + SPP))
    live = float((state.ssmm.sum_w > 0).float().mean())
    if not (live > 0.1 and bool(torch.isfinite(state.ssmm.sum_tgt).all())):
        raise AssertionError(f"the SSMM chains did not learn: {live} of the pixels")
    ssmm_ms = float(np.mean(frame_ms[4:10]))

    c_bundle, c_accel, c_cfg = court(dev)
    c_cfg = c_cfg._replace(spp=1, integrator="ssmm", denoise=True)
    with DenoiseSplit() as split:
        _, _, court_counts, stats = court_frames(25, "court ssmm denoise", dev, c_bundle, c_accel,
                                                 c_cfg, scfg, 8, (4, 8), W * H * 2, smi)
        s = split.mean(4, 8)
    log(f"phase 25 ssmm city: chains with sum_w > 0 {live:.4f} of the pixels, frames 4-9 "
        f"{ssmm_ms:.1f} ms/frame; court ssmm denoise [{smi}]: {split_text(s)} (frames 4-7)")

    for w, h in ((64, 36), (256, 8)):
        small = RenderConfig(width=w, height=h, spp=SPP, integrator="ssmm")
        if layout.is_tiled(w, h) != (w == 256):
            raise AssertionError("256x8 is not in tiled buffer order")
        cpu_vs_card(25, "box ssmm", lambda: cornell_box(device="cpu"), small, scfg, 3,
                    SSMM_IRRADIANCE)
    small = RenderConfig(width=64, height=36, spp=SPP, integrator="ssmm", denoise=True)
    cpu_vs_card(25, "box ssmm denoise", lambda: cornell_box(device="cpu"), small, scfg, 3,
                SSMM_IRRADIANCE, report=("ldr", "hdr"))

    # the estimator: 64 accumulated frames of ssmm (2 spp) and of pt (4
    # spp, max path length 2: the one bounce SSMM guides) on the card
    means = {}
    for name, kw in (("ssmm", dict(spp=SPP, integrator="ssmm")), ("pt", dict(spp=4, max_path_length=2))):
        st, _ = render_sequence(cornell_box(device="cpu"), RenderConfig(width=64, height=36, **kw),
                                frames=64, mcpg_config=scfg if name == "ssmm" else None)
        means[name] = float(st.accum_irradiance[..., :3].mean())
    rel = abs(means["ssmm"] - means["pt"]) / means["pt"]
    log(f"phase 25 estimator box 64x36 x64 accumulated frames on the card: mean irradiance ssmm "
        f"{means['ssmm']:.5f}, pt {means['pt']:.5f}, relative difference {rel:.4f} (bound "
        f"{SSMM_ESTIMATOR_REL})")
    if rel > SSMM_ESTIMATOR_REL:
        raise AssertionError("SSMM's estimate and the path tracer's disagree")
    return city_counts, court_counts, {"ms": ssmm_ms, "cold": frame_ms[0], "court": {**stats, "split": s},
                                       "estimator_rel": rel}


# certify_presets on the card at the presets' named 640x360 with certify's
# default budgets (64 frames, 4 truth runs of 256): tests/test_certify.py's
# criteria, config1's PT against itself (ratio 1 exactly) and the
# guiding-bound config6 below 1
CERTIFY = ("config1", "config6")
# each preset frame's launches (cornell_box and the alcove have no
# alpha-tested triangles): PT and MCPG 1 primary + 2 bounce traces at 1
# spp, config3's ReSTIR 2 traces + 1 visibility sweep
PRESET_FRAME = {"config1": {"woop_nearest": 3}, "config6": {"woop_nearest": 3},
                "config3": {"woop_nearest": 2, "woop_any": 1}}
# tests/test_graph.py's tolerance for the PT graph (its accumulators
# reproject with zero motion, frame_core's average plainly)
GRAPH_PT_ATOL = 1e-5
# the debug views, CPU against card on the same state: view 3's colour is
# rounded once from f64 (render/mcpg/debug.py), the others are f32 chains
VIEW_TOL = dict(rtol=1e-5, atol=1e-6)


def phase26(dev, smi):
    """Presets and certification: ``run_preset`` for config1 and config6
    (640x360) and config3 (1080p) at their frame counts, the launches
    those frames make; ``certify_presets`` of config1 and config6 at their
    named 640x360 with certify's default budgets, each truth, candidate
    and equal-budget frame counted (the orbit presets: phase 33)."""
    import csv
    import tempfile

    from merian_quake_tpu_torch.presets import PRESETS, run_preset
    from merian_quake_tpu_torch.utils.certify import certify_presets

    paths, stats = {}, {"preset_ms": {}, "certify": {}}
    for name, per_frame in PRESET_FRAME.items():
        p = PRESETS[name]
        reset_launches()
        _, out, spf = run_preset(name, device=dev)
        got = launches()
        want = {**{k: 0 for k in got}, **{k: v * p.frames for k, v in per_frame.items()}}
        if got != want:
            raise AssertionError(f"run_preset({name!r}) launched {got}, expected {want}")
        for key in ("ldr", "hdr"):
            if not bool(torch.isfinite(out[key]).all()):
                raise AssertionError(f"run_preset({name!r}) {key} is not finite")
        if tuple(out["ldr"].shape) != (p.config.height, p.config.width, 3):
            raise AssertionError(f"run_preset({name!r}) ldr has the shape {tuple(out['ldr'].shape)}")
        paths[f"preset_{name}"] = got
        stats["preset_ms"][name] = spf * 1e3
        log(f"phase 26 run_preset {name} {p.config.width}x{p.config.height} {p.config.integrator} "
            f"denoise={p.config.denoise} x{p.frames} frames [{smi}]: {spf * 1e3:.2f} ms/frame (frames "
            f"1-{p.frames - 1}); launches { {k: v for k, v in got.items() if v} }; ldr mean "
            f"{float(out['ldr'].mean()):.4f}")

    with tempfile.TemporaryDirectory() as tmp:
        for name in CERTIFY:
            reset_launches()
            t0 = time.perf_counter()
            r = certify_presets([name], scale=1.0, convergence_dir=tmp, device=dev)[name]
            secs = time.perf_counter() - t0
            got = launches()
            frames = r["ref_frames"] * r["ref_runs"] + r["frames"] * (1 if r["integrator"] == "pt" else 2)
            want = {**{k: 0 for k in got}, "woop_nearest": 3 * frames}
            if got != want:
                raise AssertionError(f"certify {name} launched {got}, expected {want}")
            with open(r["convergence_csv"]) as f:
                series = [(int(row["frames"]), float(row["relmse"]), float(row["relmse_trimmed"]))
                          for row in csv.DictReader(f)]
            values = [r[k] for k in ("relmse", "relmse_pt_equal_budget", "relmse_trimmed",
                                     "relmse_trimmed_pt")] + [x for s in series for x in s[1:]]
            log(f"phase 26 certify {name} {r['resolution']} {r['integrator']} frames {r['frames']}, "
                f"truth {r['ref_runs']} x {r['ref_frames']} [{smi}]: relmse {r['relmse']:.6g}, equal-"
                f"budget reference {r['relmse_pt_equal_budget']:.6g}, ratio_vs_pt "
                f"{r['ratio_vs_pt']:.6g}, trimmed ratio {r['ratio_trimmed_vs_pt']:.6g}; convergence "
                f"(frames, relmse, trimmed) {series}; {frames} frames in {secs:.1f} s; launches "
                f"{ {k: v for k, v in got.items() if v} }")
            if not all(np.isfinite(v) for v in values):
                raise AssertionError(f"certify {name}: a relMSE is not finite")
            if series[0][0] != 1 or series[-1][0] != 64 or not series[-1][1] < series[0][1]:
                raise AssertionError(f"certify {name}: the convergence series does not fall: {series}")
            if name == "config1" and r["ratio_vs_pt"] != 1.0:
                raise AssertionError(f"certify config1: PT against itself gave {r['ratio_vs_pt']}")
            if name == "config6" and not r["ratio_vs_pt"] < 1.0:
                raise AssertionError(f"certify config6: guiding does not beat PT: {r['ratio_vs_pt']}")
            paths[f"certify_{name}"] = got
            stats["certify"][name] = {**{k: r[k] for k in (
                "resolution", "relmse", "relmse_pt_equal_budget", "ratio_vs_pt",
                "ratio_trimmed_vs_pt")}, "convergence": series, "seconds": secs}

    return paths, stats


def graph_or_core(step, frames, uniforms):
    """``frames`` frames of ``step(state, uniforms) -> (state, out)`` from
    ``step(None, None)``'s initial state; returns (state, out, host ms a
    frame with each frame synced, K1 launches a frame)."""
    state = step(None, None)
    ms, k1, out = [], [], None
    for i in range(frames):
        before = launches()["woop_nearest"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = step(state, uniforms._replace(frame=i))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        k1.append(launches()["woop_nearest"] - before)
    return state, out, ms, k1


def graph_step(graph):
    return lambda st, u: graph.init_state() if st is None else graph.run(st, {"uniforms": u})


def core_step(accel, atlas, config, icfg, dev):
    from merian_quake_tpu_torch.renderer import frame_core, init_state

    return lambda st, u: (init_state(config, icfg, device=dev) if st is None
                          else frame_core(accel, atlas, u, config, st, mcpg_config=icfg))


def image_reading(a, b):
    """(share of pixels within PIX_TOL, mean |d|) of two images or
    per-pixel state fields."""
    d = (a - b).abs().reshape(a.shape[0], a.shape[1], -1)
    return float((d.amax(-1) <= PIX_TOL).float().mean()), float(d.mean())


def flagship_pairs(gst, gout, fst, fout):
    """The flagship graph's outputs and SVGF histories beside frame_core's."""
    pairs = {"hud/ldr": (gout[("hud", "out")], fout["ldr"]),
             "add/hdr": (gout[("add", "out")], fout["hdr"])}
    for node, field in (("denoiser", "svgf"), ("volume_denoiser", "volume_svgf")):
        for k in gst["nodes"][node]._fields:
            pairs[f"{field}.{k}"] = (getattr(gst["nodes"][node], k), getattr(getattr(fst, field), k))
    return pairs


def phase27(dev, bundle, accel, config, smi):
    """The frame graph at 1080p: res/pt_graph.json on city against
    frame_core (6 frames, 5 K1 a frame); flagship_graph_config() on the
    fogged court with config5's render setup against frame_core (9
    frames): the same K1 launches and synchronizing calls a frame, and
    in the default mode the HUD and add outputs and both SVGF histories
    equal; the flagship on city (MCPG, denoise, no
    volume) with one steady frame under set_sync_debug_mode("error")."""
    import os

    from merian_quake_tpu_torch.graph import Graph
    from merian_quake_tpu_torch.graph.nodes import GraphContext, flagship_graph_config
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig

    paths, stats = {}, {}
    res = os.path.join(os.path.dirname(os.path.abspath(__file__)), "res")
    g = Graph.from_config(os.path.join(res, "pt_graph.json"),
                          GraphContext(accel, bundle.atlas, config, device=dev))
    reset_launches()
    _, gout, g_ms, g_k1 = graph_or_core(graph_step(g), 6, bundle.uniforms)
    paths["graph_pt_city"] = launches()
    _, fout, f_ms, f_k1 = graph_or_core(core_step(accel, bundle.atlas, config, None, dev), 6,
                                        bundle.uniforms)
    d = float((gout[("tonemap", "out")] - fout["ldr"]).abs().max())
    want = [1 + SPP * (MPL - 1)] * 6
    log(f"phase 27 graph res/pt_graph.json city {W}x{H} [{smi}]: frames 2-5 "
        f"{np.mean(g_ms[2:]):.2f} ms/frame against frame_core's {np.mean(f_ms[2:]):.2f}; K1 a frame "
        f"{g_k1} (frame_core {f_k1}); tonemap against frame_core's ldr max |d| {d:.3e} (bound "
        f"{GRAPH_PT_ATOL}); launches { {k: v for k, v in paths['graph_pt_city'].items() if v} }")
    if g_k1 != want or f_k1 != want or d > GRAPH_PT_ATOL:
        raise AssertionError("the PT graph differs from frame_core")
    stats["pt_city"] = {"ms": float(np.mean(g_ms[2:])), "frame_core_ms": float(np.mean(f_ms[2:])),
                        "max_abs_ldr": d}

    # the flagship graph on the fogged court, config5's render setup, in
    # the default mode: the same launches and host reads a frame, and the
    # HUD, add and both SVGF histories equal frame_core's bit for bit (the
    # replay's scan repeats itself since F7's repair, ops/segments.py::
    # scan_rows)
    c_bundle, c_accel, c_cfg = court(dev, FOG_MU_T)
    c_cfg = c_cfg._replace(integrator="mcpg", denoise=True)
    mcfg = MCPGConfig(volume=VolumeConfig(volume_spp=1))
    g = Graph.from_config(flagship_graph_config(), GraphContext(
        c_accel, c_bundle.atlas, c_cfg, mcpg_config=mcfg, device=dev))
    reset_launches()
    gst, gout, g_ms, g_k1 = graph_or_core(graph_step(g), 9, c_bundle.uniforms)
    paths["graph_flagship_court"] = launches()
    core = core_step(c_accel, c_bundle.atlas, c_cfg, mcfg, dev)
    fst, fout, f_ms, f_k1 = graph_or_core(core, 9, c_bundle.uniforms)
    pairs = flagship_pairs(gst, gout, fst, fout)
    spread = {k: image_reading(x, y) for k, (x, y) in pairs.items()}
    unequal = [k for k, (x, y) in pairs.items() if not torch.equal(x, y)]
    # frame 9's synchronizing calls; the process's first call in the
    # "warn" mode adds one of torch's own, so frame_core goes first and
    # again after the graph
    u9 = c_bundle.uniforms._replace(frame=9)
    sync_sites(lambda: core(fst, u9))
    _, g_sync = sync_sites(lambda: g.run(gst, {"uniforms": u9}))
    _, f_sync = sync_sites(lambda: core(fst, u9))
    if g_k1 != f_k1 or sorted(set(g_sync)) != sorted(set(f_sync)) or len(g_sync) != len(f_sync):
        raise AssertionError(f"the flagship graph's launches or host reads differ from frame_core's: "
                             f"K1 {g_k1} against {f_k1}, synchronizing calls at {g_sync} against "
                             f"{f_sync}")
    log(f"phase 27 graph flagship court fog mcpg + volume denoise {W}x{H} spp {c_cfg.spp} [{smi}]: "
        f"frames 6-8 {np.mean(g_ms[6:]):.1f} ms/frame against frame_core's {np.mean(f_ms[6:]):.1f}; "
        f"K1 a frame {g_k1} (frame_core {f_k1}); synchronizing calls in frame 9: graph "
        f"{len(g_sync)}, frame_core {len(f_sync)}; in the default mode the HUD, add and both SVGF "
        f"histories ({len(pairs)} tensors) bit-identical: {not unequal} (within {PIX_TOL}, "
        f"mean |d|: " + ", ".join(f"{k} {a:.5f} {m:.3e}" for k, (a, m) in spread.items()) + ")")
    if unequal:
        raise AssertionError(f"the flagship graph differs from frame_core in {unequal}")
    stats["flagship_court"] = {"ms": float(np.mean(g_ms[6:])), "frame_core_ms": float(np.mean(f_ms[6:])),
                               "k1_per_frame": g_k1[-1], "syncs": len(g_sync)}

    # the flagship on city (no alpha test, so no host read of the alpha
    # loop): a steady frame makes no synchronizing call, as frame_core's
    # denoised frame makes none (phase 23)
    m_cfg = config._replace(integrator="mcpg", denoise=True)
    g = Graph.from_config(flagship_graph_config(), GraphContext(
        accel, bundle.atlas, m_cfg, mcpg_config=MCPGConfig(), device=dev))
    reset_launches()
    gst, _, g_ms, g_k1 = graph_or_core(graph_step(g), 3, bundle.uniforms)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gst, gout = g.run(gst, {"uniforms": bundle.uniforms._replace(frame=3)})
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    paths["graph_flagship_city"] = launches()
    if g_k1 != [3] * 3 or not bool(torch.isfinite(gout[("hud", "out")]).all()):
        raise AssertionError(f"the flagship graph on city: K1 a frame {g_k1}, or a non-finite image")
    log(f"phase 27 graph flagship city mcpg denoise {W}x{H} [{smi}]: frames 1-2 "
        f"{np.mean(g_ms[1:]):.1f} ms/frame, K1 a frame {g_k1}; frame 3 under "
        f"torch.cuda.set_sync_debug_mode('error'): no synchronizing call")
    stats["flagship_city_ms"] = float(np.mean(g_ms[1:]))
    return paths, stats


def to_device(x, dev):
    """Tensors in NamedTuples, tuples, lists and dicts, on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[to_device(v, dev) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, dev) for v in x)
    return x


def phase28(dev, bundle, accel, mcpg_city, restir_city, smi):
    """Debug views: all 9 MCPG views on phase 16's city state and every
    ReSTIR view on phase 6's at 1080p, finite and of the image's shape; at
    64x36 states made on the CPU, moved to the card: each view the same on
    both (view 3 and its cell keys bit for bit); a Profiler device span
    around one frame."""
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.hit import decompress_hit
    from merian_quake_tpu_torch.render.mcpg.debug import (
        DEBUG_VIEWS, grid_cell_seed, render_mcpg_debug,
    )
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.render.restir.debug import DEBUG_VIEWS as RESTIR_VIEWS
    from merian_quake_tpu_torch.render.restir.debug import render_restir_debug
    from merian_quake_tpu_torch.renderer import render_frame, render_sequence
    from merian_quake_tpu_torch.utils.profiler import Profiler

    m_cfg, mcfg, m_uni, m_state, m_out = mcpg_city
    r_cfg, r_state, r_out = restir_city
    mcpg_view = lambda s, u, c, st, o: render_mcpg_debug(s, u, c, mcfg, st.mcpg, o["gbuffer"],
                                                         o["irradiance"])
    restir_view = lambda s, c, st, o: render_restir_debug(s, c, st.restir, o["gbuffer"])
    ms = {}
    for kind, views, run in (("mcpg", DEBUG_VIEWS, lambda s: mcpg_view(s, m_uni, m_cfg, m_state, m_out)),
                             ("restir", RESTIR_VIEWS, lambda s: restir_view(s, r_cfg, r_state, r_out))):
        for s in views:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = run(s)
            torch.cuda.synchronize()
            ms[f"{kind} {s}"] = (time.perf_counter() - t0) * 1e3
            if tuple(img.shape) != (H, W, 3) or not bool(torch.isfinite(img).all()):
                raise AssertionError(f"{kind} debug view {s} ({views[s]}): shape "
                                     f"{tuple(img.shape)} or not finite")
    log(f"phase 28 debug views {W}x{H} on phases 16 and 6's states [{smi}]: every view finite, "
        f"ms a view " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()))

    small = RenderConfig(width=64, height=36, spp=SPP, max_path_length=MPL)
    readings = []
    for kind, icfg, views in (("mcpg", mcfg, DEBUG_VIEWS), ("restir", ReSTIRConfig(), RESTIR_VIEWS)):
        cfg = small._replace(integrator=kind)
        st, out = render_sequence(city(device="cpu"), cfg, frames=3, mcpg_config=icfg, device="cpu")
        uni = city(device="cpu").uniforms._replace(frame=2)
        st_d, out_d, uni_d = to_device(st, dev), to_device(out, dev), to_device(uni, dev)
        for s in views:
            if kind == "mcpg":
                a, b = mcpg_view(s, uni, cfg, st, out), mcpg_view(s, uni_d, cfg, st_d, out_d)
            else:
                a, b = restir_view(s, cfg, st, out), restir_view(s, cfg, st_d, out_d)
            b = b.cpu()
            same = torch.equal(a, b) if (kind, s) == ("mcpg", 3) else torch.allclose(b, a, **VIEW_TOL)
            readings.append(f"{kind} {s} max |d| {float((a - b).abs().max()):.3e} on "
                            f"{int((a != b).any(-1).sum())} pixels")
            if not same:
                raise AssertionError(f"{kind} debug view {s} differs between the CPU and the card: "
                                     f"{readings[-1]}")
        if kind == "mcpg":
            hit = decompress_hit(out["gbuffer"].hits)
            keys = grid_cell_seed(hit.pos, uni.cam_x, mcfg)
            keys_d = grid_cell_seed(hit.pos.to(dev), uni_d.cam_x, mcfg).cpu()
            if not torch.equal(keys, keys_d):
                raise AssertionError("view 3's cell keys differ between the CPU and the card")
    log(f"phase 28 debug views 64x36, a CPU state on the CPU and on the card: view 3 and its "
        f"cell keys bit for bit, the others within {VIEW_TOL}; " + "; ".join(readings))

    prof = Profiler(report_every=1)
    with prof.device("mcpg city frame") as held:
        _, out = render_frame(accel, bundle.atlas, m_uni._replace(frame=m_uni.frame + 1), m_cfg,
                              m_state, mcfg)
        held.append(out["ldr"])
    report = prof.frame_done()
    span_ms = prof._acc["mcpg city frame"] * 1e3
    log(f"phase 28 Profiler device span around one 1080p city MCPG frame: {span_ms:.2f} ms; "
        f"report: {report!r}")
    if not (report and span_ms > 0.0):
        raise AssertionError("the Profiler's device span reported no time")
    return {"view_ms": ms, "profiler_span_ms": span_ms}


# ---------------------------------------------------------------- F7, the live loop, the CLI

# frames of each F7 A/B run (the last 4 timed) and the turns of the A/B
F7_FRAMES, F7_TURNS = 6, ("parent", "change", "change", "parent")
# the live dungeon at full width (make_bigmap's defaults) and its frames,
# as bench.py's live_scale row: 7 settle frames (5-7 steady), 3 timed
LIVE_SETTLE, LIVE_TIMED = 7, 3
# rays aimed at the live entities start this far from a triangle's centroid
AIM_DIST = 48.0
# the incremental accel against a full build of the same frame:
# tests/test_live.py's tolerance on t (hits and misses equal)
LIVE_T_RTOL, LIVE_T_ATOL = 1e-5, 1e-3
# the CPU-vs-card live dungeon: grid 3, 4 monsters, dynamic capacity 512,
# 3 steps, 64x40
SMALL_DUNGEON, SMALL_W, SMALL_H = {"grid": 3, "monsters": 4, "dynamic_capacity": 512}, 64, 40


def f7_runs(accel, atlas, uniforms, config, mcfg, dev, frames=F7_FRAMES):
    """``frames`` frame_core frames from an empty state: (state, out, host
    ms of each frame, synced)."""
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    state = init_state(config, mcfg, device=dev)
    ms = []
    for i in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = render_frame(accel, atlas, uniforms._replace(frame=i), config, state, mcfg)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, out, ms


def f7_tensors(state, out):
    return {"mc.f": state.mcpg.mc.f, "mc.i": state.mcpg.mc.i, "lc.irr": state.mcpg.lc.irr,
            "accum_irradiance": state.accum_irradiance, "ldr": out["ldr"]}


def phase29(dev, bundle, accel, config, smi):
    """F7: two frame_core runs from one state are bit-equal in the default
    mode (city MCPG); the parent's scan (``torch.cumsum``) against the
    repair (``segments.scan_rows``), frames in turns, on city MCPG and the
    fogged court with the volume pass."""
    from merian_quake_tpu_torch.ops import segments
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig

    repaired = segments.scan_rows
    parent = lambda x: torch.cumsum(x, dim=1)  # what compact_sums ran before the repair
    cfg, mcfg = mcpg_scene_config(config)
    runs = {}
    for name, scan in (("change", repaired), ("parent", parent)):
        segments.scan_rows = scan
        try:
            a, b = (f7_tensors(*f7_runs(accel, bundle.atlas, bundle.uniforms, cfg, mcfg, dev)[:2])
                    for _ in range(2))
        finally:
            segments.scan_rows = repaired
        runs[name] = [k for k in a if not torch.equal(a[k], b[k])]
    log(f"phase 29 F7 city mcpg {W}x{H}, two runs of {F7_FRAMES} frames from one state [{smi}]: "
        f"tensors that differ, the repair {runs['change'] or 'none'}; the parent's cumsum "
        f"{runs['parent'] or 'none'}")
    if runs["change"]:
        raise AssertionError(f"frame_core does not repeat itself: {runs['change']} differ")
    c_bundle, c_accel, c_cfg = court(dev, FOG_MU_T)
    c_cfg, c_mcfg = c_cfg._replace(integrator="mcpg"), MCPGConfig(volume=VolumeConfig())
    ab = {}
    for scene, args in (("city", (accel, bundle.atlas, bundle.uniforms, cfg, mcfg)),
                        ("court_volume", (c_accel, c_bundle.atlas, c_bundle.uniforms, c_cfg,
                                          c_mcfg))):
        turns = []
        for turn in F7_TURNS:
            segments.scan_rows = parent if turn == "parent" else repaired
            try:
                turns.append(float(np.mean(f7_runs(*args, dev)[2][2:])))
            finally:
                segments.scan_rows = repaired
        p_ms = (turns[0] + turns[3]) / 2
        c_ms = (turns[1] + turns[2]) / 2
        ab[scene] = {"turns_ms": turns, "parent_ms": p_ms, "change_ms": c_ms,
                     "cost": c_ms / p_ms - 1.0}
        log(f"phase 29 F7 A/B {scene} mcpg {W}x{H} [{smi}]: frames 2-{F7_FRAMES - 1} in turns "
            f"{', '.join(f'{t} {x:.2f}' for t, x in zip(F7_TURNS, turns))} ms/frame; the repair "
            f"costs {100 * ab[scene]['cost']:+.2f}% of the frame")
    return {"repeats": not runs["change"], "parent_differs": runs["parent"], **ab}


class LiveRun:
    """The live dungeon (or arena) and its live accel on the card, with the
    frame config the slice renders it at."""

    def __init__(self, dev, live, la, config, mcfg):
        self.dev, self.live, self.la, self.config, self.mcfg = dev, live, la, config, mcfg
        self.state = None
        self.i = 0

    def step(self, render=True, sync=True):
        """One frame of the slice's path: (step s, refresh s, render s, out);
        with ``sync`` the frame ends in a synchronize."""
        from merian_quake_tpu_torch.accel.build import refresh_dynamic
        from merian_quake_tpu_torch.renderer import init_state, render_frame

        if self.state is None:
            self.state = init_state(self.config, self.mcfg, device=self.dev)
        t0 = time.perf_counter()
        self.dyn, self.uniforms = self.live.step_dynamic(dt=1.0 / 30.0, forward=120.0,
                                                         yaw=25.0 + 2.0 * self.i)
        t1 = time.perf_counter()
        self.la = refresh_dynamic(self.la, self.dyn)
        t2 = time.perf_counter()
        out = None
        if render:
            self.state, out = render_frame(self.la.accel, self.live.gs.static_bundle.atlas,
                                           self.uniforms, self.config, self.state, self.mcfg)
        if sync:
            torch.cuda.synchronize()
        self.i += 1
        return t1 - t0, t2 - t1, time.perf_counter() - t2, out


def live_config(live, integrator="mcpg", width=W, height=H, mpl=MPL, spp=SPP):
    from merian_quake_tpu_torch.cli import live_features
    from merian_quake_tpu_torch.models.types import RenderConfig

    return RenderConfig(width=width, height=height, spp=spp, max_path_length=mpl,
                        integrator=integrator, features=live_features(live.gs.static_bundle))


def phase30(dev, smi):
    """The live dungeon at full width: the host library's build, the map
    and its live accel, 10 frames of the slice's path (bench.py's
    live_scale frames), K3 launches and host reads a frame, peak bytes."""
    from merian_quake_tpu_torch.accel.build import build_accel_live, refresh_dynamic
    from merian_quake_tpu_torch.game import host
    from merian_quake_tpu_torch.game.bigmap import make_bigmap
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.renderer import render_frame

    marks = [time.perf_counter()]
    lib = host.build_library()
    marks.append(time.perf_counter())
    live, _ = make_bigmap(device=dev)
    marks.append(time.perf_counter())
    la = build_accel_live(live.gs.static_bundle, dyn_cap=live.gs.dynamic_capacity, device=dev)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    host_s, map_s, accel_s = np.diff(marks)
    log(f"phase 30 live dungeon: game host built with g++ in {host_s:.2f} s "
        f"({lib.rsplit('/', 1)[-1]}); make_bigmap() {map_s:.2f} s, {la.n_static} static "
        f"triangles, dynamic capacity {la.dyn_cap}; build_accel_live {accel_s:.2f} s")
    run = LiveRun(dev, live, la, live_config(live), MCPGConfig())
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    per_frame, times = [], []
    for i in range(LIVE_SETTLE):
        before = launches()["woop_stream"]
        step_s, refresh_s, render_s, out = run.step()
        per_frame.append(launches()["woop_stream"] - before)
        times.append((step_s, refresh_s, render_s))
    t0 = time.perf_counter()
    for i in range(LIVE_TIMED):
        before = launches()["woop_stream"]
        run.dyn, run.uniforms = live.step_dynamic(dt=1.0 / 30.0, forward=120.0, yaw=40.0 + 2.0 * i)
        run.la = refresh_dynamic(run.la, run.dyn)
        run.state, out = render_frame(run.la.accel, live.gs.static_bundle.atlas, run.uniforms,
                                      run.config, run.state, run.mcfg)
        per_frame.append(launches()["woop_stream"] - before)
    torch.cuda.synchronize()
    live_ms = (time.perf_counter() - t0) / LIVE_TIMED * 1e3
    path = launches()
    peak = torch.cuda.max_memory_allocated()
    others = {k: v for k, v in path.items() if v and k not in ("woop_stream",)}
    if others or min(per_frame) < 3:
        raise AssertionError(f"the live dungeon launched {path} (K3 a frame {per_frame})")
    check_mcpg_finite("live dungeon", run.state, out)
    valid = int(run.dyn["valid"].sum())
    if valid <= 0:
        raise AssertionError("the live dungeon draws no entity")
    # two more frames' host reads (the alpha loop's, one a round, are the
    # only ones a live frame may have); the first frame read takes the
    # synchronizing call torch adds to a process's first call in the
    # "warn" mode (phase 27), the second is held
    sync_sites(lambda: run.step(sync=False))
    _, sites = sync_sites(lambda: run.step(sync=False))
    if not sites or any(not s.startswith("intersect.py:") for s in sites):
        raise AssertionError(f"a live frame synchronizes outside the alpha loop: {sites}")
    steady = np.mean(np.asarray(times[4:7]), axis=0) * 1e3
    stats = {"static_triangles": la.n_static, "dynamic_triangles": valid,
             "host_build_s": float(host_s), "make_bigmap_s": float(map_s),
             "build_accel_live_s": float(accel_s),
             "step_ms": float(steady[0]), "refresh_ms": float(steady[1]),
             "render_ms": float(steady[2]), "live_ms_per_frame": live_ms,
             "k3_per_frame": per_frame, "host_reads_per_frame": len(sites),
             "h2d_bytes_per_frame": refresh_dynamic.h2d_bytes, "peak_device_bytes": peak}
    log(f"phase 30 live dungeon mcpg {W}x{H} spp {SPP} mpl {MPL} [{smi}]: frames 5-7 step "
        f"{steady[0]:.2f} ms, refresh {steady[1]:.2f} ms, render {steady[2]:.1f} ms (synced); "
        f"{LIVE_TIMED} timed frames {live_ms:.1f} ms/frame (bench.py's timing); K3 a frame "
        f"{per_frame}; host reads a frame {len(sites)} ({sorted(set(sites))}); refresh copies "
        f"{refresh_dynamic.h2d_bytes} bytes to the card a frame; {valid} dynamic triangles; "
        f"peak {peak} bytes; ldr mean {float(out['ldr'].mean()):.4f}")
    return run, {"live_dungeon": path}, stats


def aimed_rays(acc, n_static, n, seed):
    """``n`` rays aimed at the live entities: each starts AIM_DIST from a
    valid dynamic triangle's centroid and points at it."""
    s = acc.scene
    tris = s.valid[n_static:].nonzero()[:, 0] + n_static
    g = torch.Generator(device=tris.device).manual_seed(seed)
    pick = tris[torch.randint(0, tris.shape[0], (n,), device=tris.device, generator=g)]
    c = (s.v0[pick] + s.v1[pick] + s.v2[pick]) / 3.0
    u = torch.nn.functional.normalize(torch.randn((n, 3), device=c.device, generator=g), dim=-1)
    o = (c + AIM_DIST * u).contiguous()
    d = torch.nn.functional.normalize(c - o, dim=-1).contiguous()
    return o, d


def table_invariants(acc, node_sizes):
    """The refreshed tables against fresh computations: packed rows,
    padded bounds (as the traces cached them) and the walk's boxes."""
    from merian_quake_tpu_torch.accel import woop

    bad = []
    for w_name, lo_name, hi_name in (("woop_w", "cluster_lo", "cluster_hi"),
                                     ("woop_w_shadow", "cluster_lo", "cluster_hi"),
                                     ("woop_w_alpha", "cluster_lo_alpha", "cluster_hi_alpha")):
        w, lo, hi = getattr(acc, w_name), getattr(acc, lo_name), getattr(acc, hi_name)
        plo, phi = woop.padded_bounds(lo, hi)
        flo, fhi = (x.contiguous() for x in woop._pad_bounds(lo.clone(), hi.clone()))
        pairs = {"rows4": (woop.packed_rows(w), w[:, :4]), "padded_lo": (plo, flo),
                 "padded_hi": (phi, fhi),
                 "walk_boxes": (woop.walk_boxes(plo, phi, *node_sizes),
                                woop.walk_boxes(flo.clone(), fhi.clone(), *node_sizes))}
        bad += [f"{w_name}.{k}" for k, (a, b) in pairs.items() if not torch.equal(a, b)]
    return bad


def live_checks(phase, name, run, populations, kernel, smi):
    """A refreshed live accel on the card: ``kernel`` (K1 or K3) and, on
    the shadow table, its any-hit form, bit-equal to the plain versions on
    each population; the table invariants; the hits of a from-scratch
    build_accel of the same frame's full scene (hit/miss equal, t within
    tests/test_live.py's tolerance). Returns the largest |t difference|
    against the plain versions and the readings."""
    from merian_quake_tpu_torch.accel import build_accel, woop

    la, acc = run.la, run.la.accel
    any_kernel = woop.woop_stream if kernel is woop.woop_stream else woop.woop_any
    max_abs, readings = [], {}
    bad = table_invariants(acc, woop.node_sizes(kernel.__name__))
    if bad:
        raise AssertionError(f"{name}: refreshed tables differ from fresh ones: {bad}")
    scene, _ = run.live.gs.extract()
    # numpy, as the refresh builds the dynamic rows (the static rows are the
    # native builder's; phase 35 holds the two builders' tables)
    full = build_accel(scene, run.live.gs.static_bundle.atlas, native=False)
    for pop, (o, d, t_max) in populations.items():
        n = o.shape[0]
        t_min = torch.zeros(n, device=o.device)
        args = woop.k1_inputs(acc, o, d, t_min, t_max)
        ref = woop.intersect_woop_reference(args[0], args[1])
        max_abs.append(check_exact(phase, f"{name} {pop} {n} {kernel.__name__}", kernel(*args), ref))
        rays, _, shadow = woop.k2_inputs(acc, o, d, t_min, t_max)
        occ = (any_kernel(rays, *shadow, anyhit=True) if any_kernel is woop.woop_stream
               else any_kernel(rays, *shadow))
        max_abs.append(check_k2(f"{name} {pop} {n} {any_kernel.__name__} shadow", occ,
                                woop.intersect_woop_any_reference(rays, shadow[0]), phase))
        a = woop.intersect_woop(acc, o, d, 0.0, t_max)
        b = woop.intersect_woop(full, o, d, 0.0, t_max)
        hit_differ = int((a.hit != b.hit).sum())
        t_ok = torch.isclose(a.t[b.hit], b.t[b.hit], rtol=LIVE_T_RTOL, atol=LIVE_T_ATOL)
        on_dyn = int((a.tri >= la.n_static).sum())
        readings[pop] = {"rays": n, "hits": int(b.hit.sum()), "dynamic_hits": on_dyn,
                         "hit_differ": hit_differ, "t_differ": int((~t_ok).sum())}
        log(f"phase {phase} {name} {pop}: against a full build_accel of the frame's scene: hits "
            f"{int(b.hit.sum())} of {n}, on the dynamic suffix {on_dyn}, hit/miss differ "
            f"{hit_differ}, t outside rtol {LIVE_T_RTOL} / atol {LIVE_T_ATOL}: "
            f"{int((~t_ok).sum())}")
        if hit_differ or not bool(t_ok.all()):
            raise AssertionError(f"{name} {pop}: the live accel does not hit as a full build does")
    return max(max_abs), readings


def dungeon_populations(run, dev):
    """65,536-ray subsets of the frame's primary and bounce rays, and rays
    aimed at the monsters."""
    import types

    from merian_quake_tpu_torch.accel import woop

    bundle = types.SimpleNamespace(uniforms=run.uniforms, atlas=run.live.gs.static_bundle.atlas)
    po, pd = primary_rays(bundle, run.la.accel, dev)
    bo, bd, bt = bounce_rays(bundle, run.la.accel, run.config._replace(integrator="pt"), dev)
    mid = slice(W * H // 2, W * H // 2 + SUBSET)
    ao, ad = aimed_rays(run.la.accel, run.la.n_static, SUBSET, 13)
    full = lambda v: torch.full((SUBSET,), v, device=dev)
    return {"primary": (po[mid].contiguous(), pd[mid].contiguous(), full(1e4)),
            "bounce": (bo[mid].contiguous(), bd[mid].contiguous(), bt[mid].contiguous()),
            "aimed at the monsters": (ao, ad, full(1e4))}


def phase31(dev, dungeon, smi):
    """The refresh against fresh tables on the card, after the moving
    steps of phase 30 (the dungeon, K3) and of the live arena (K1, K2);
    the arena's live frames (MCPG: K1; ReSTIR: K1 + K2) at 1080p; the
    rows4 mutant must fail the dungeon's check."""
    from merian_quake_tpu_torch.accel import build, woop
    from merian_quake_tpu_torch.accel.build import build_accel_live
    from merian_quake_tpu_torch.game.mod import make_arena
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig

    if not woop.streamed(dungeon.la.accel.woop_w):
        raise AssertionError("the live dungeon's table is not streamed (K3)")
    k3_err, k3_read = live_checks(31, "live dungeon", dungeon, dungeon_populations(dungeon, dev),
                                  woop.woop_stream, smi)

    paths, arena_stats = {}, {}
    for integ, icfg, expect in (("mcpg", MCPGConfig(), ("woop_nearest",)),
                                ("restir", ReSTIRConfig(), ("woop_nearest", "woop_any"))):
        live = make_arena(dynamic_capacity=1024, device=dev)
        la = build_accel_live(live.gs.static_bundle, dyn_cap=live.gs.dynamic_capacity, device=dev)
        run = LiveRun(dev, live, la, live_config(live, integ), icfg)
        reset_launches()
        ms = [run.step()[2] * 1e3 for _ in range(6)]
        got = launches()
        if any(got[k] == 0 for k in expect) or any(v for k, v in got.items() if k not in expect):
            raise AssertionError(f"the live arena ({integ}) launched {got}")
        paths[f"live_arena_{integ}"] = got
        arena_stats[f"{integ}_render_ms"] = float(np.mean(ms[2:]))
        log(f"phase 31 live arena {integ} {W}x{H} [{smi}]: 6 frames, render frames 2-5 "
            f"{np.mean(ms[2:]):.1f} ms/frame; launches { {k: v for k, v in got.items() if v} }")
    if woop.streamed(run.la.accel.woop_w):
        raise AssertionError("the live arena's table is streamed: K1/K2 expected")
    o, d = aimed_rays(run.la.accel, run.la.n_static, SUBSET, 17)
    pops = {"aimed at the entities": (o, d, torch.full((SUBSET,), 1e4, device=dev))}
    k12_err, k12_read = live_checks(31, "live arena", run, pops, woop.woop_nearest, smi)

    # the mutant: the refresh leaves the packed rows as they were
    write_table = build._write_table
    build._write_table = build._write
    try:
        dungeon.step(render=False)
        o, d, t_max = dungeon_populations(dungeon, dev)["aimed at the monsters"]
        args = woop.k1_inputs(dungeon.la.accel, o, d, torch.zeros_like(t_max), t_max)
        try:
            check_exact(31, "live dungeon rows4 mutant (must differ)", woop.woop_stream(*args),
                        woop.intersect_woop_reference(args[0], args[1]))
        except AssertionError:
            caught = True
        else:
            caught = False
    finally:
        build._write_table = write_table
    dungeon.step(render=False)  # the tables whole again
    log(f"phase 31 the rows4 mutant (a refresh that does not rewrite the packed rows) fails the "
        f"K3 check: {caught}")
    if not caught:
        raise AssertionError("the rows4 mutant passed the refreshed-table check")
    return paths, {"k3": k3_read, "k1_k2_arena": k12_read, **arena_stats,
                   "max_abs_err": max(k3_err, k12_err)}


def phase32(dev, smi):
    """CPU against card: the live dungeon (grid 3, 4 monsters) after 3
    steps, a PT (mpl 2) and an MCPG frame at 64x40."""
    from merian_quake_tpu_torch.accel.build import build_accel_live, refresh_dynamic
    from merian_quake_tpu_torch.game.bigmap import make_bigmap
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    outs = {}
    for device in ("cpu", dev):
        live, _ = make_bigmap(**SMALL_DUNGEON, device=device)
        la = build_accel_live(live.gs.static_bundle, dyn_cap=live.gs.dynamic_capacity,
                              device=device)
        for i in range(3):
            dyn, u = live.step_dynamic(dt=1 / 30, forward=100.0, yaw=15.0 + i)
            la = refresh_dynamic(la, dyn)
        for integ, mpl, mcfg in (("pt", 2, None), ("mcpg", 3, MCPGConfig())):
            cfg = live_config(live, integ, SMALL_W, SMALL_H, mpl, 1)
            _, out = render_frame(la.accel, live.gs.static_bundle.atlas, u, cfg,
                                  init_state(cfg, mcfg, device=device), mcfg)
            outs[(str(device), integ)] = out["ldr"].cpu()
    stats = {}
    for integ in ("pt", "mcpg"):
        diff = (outs[("cpu", integ)] - outs[(str(dev), integ)]).abs()
        share = float((diff.amax(-1) <= PIX_TOL).float().mean())
        mean = float(diff.mean())
        stats[integ] = {"share": share, "mean": mean}
        log(f"phase 32 live dungeon grid 3 cpu vs cuda {SMALL_W}x{SMALL_H} {integ} after 3 steps: "
            f"pixels within {PIX_TOL} {share:.5f}, mean |d| {mean:.3e}")
        if share < PIX_SHARE or mean >= MEAN_TOL:
            raise AssertionError(f"the live dungeon's {integ} frame: CPU and card disagree")
    return stats


# the orbit presets' frames through run_preset: only K1 (small scenes)
ORBIT_PRESETS = ("config2", "config4", "config5")


def phase33(dev, smi):
    """run_preset for the orbit presets at their named sizes and frames."""
    from merian_quake_tpu_torch.presets import PRESETS, run_preset

    paths, stats = {}, {}
    for name in ORBIT_PRESETS:
        p = PRESETS[name]
        reset_launches()
        state, out, spf = run_preset(name, device=dev)
        got = launches()
        if not got["woop_nearest"] or any(v for k, v in got.items()
                                           if k not in ("woop_nearest", "woop_any")):
            raise AssertionError(f"run_preset({name!r}) launched {got}")
        for key in ("ldr", "hdr"):
            if not bool(torch.isfinite(out[key]).all()):
                raise AssertionError(f"run_preset({name!r}) {key} is not finite")
        if tuple(out["ldr"].shape) != (p.config.height, p.config.width, 3):
            raise AssertionError(f"run_preset({name!r}) ldr has the shape {tuple(out['ldr'].shape)}")
        paths[f"preset_{name}"] = got
        stats[name] = spf * 1e3
        log(f"phase 33 run_preset {name} {p.config.width}x{p.config.height} {p.config.integrator} "
            f"denoise={p.config.denoise} x{p.frames} frames, orbit camera [{smi}]: "
            f"{spf * 1e3:.2f} ms/frame (frames 1-{p.frames - 1}, the accel rebuilt each frame "
            f"outside the timing); launches { {k: v for k, v in got.items() if v} }")
    return paths, stats


def phase34(dev, smi):
    """``python -m merian_quake_tpu_torch.cli play --map bigmap`` at 1080p
    MCPG, 3 frames, in a subprocess on the card: it writes its PNG."""
    import os
    import tempfile

    from merian_quake_tpu_torch.utils.image import load_png

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "play.png")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "merian_quake_tpu_torch.cli", "--device", str(dev), "play",
             "--map", "bigmap", "--frames", "3", "--size", f"{W}x{H}", "--spp", str(SPP),
             "--integrator", "mcpg", "--out", png],
            cwd=root, capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"cli play failed ({proc.returncode}): {proc.stderr[-3000:]}")
        img = load_png(png)
    if img.shape != (H, W, 3) or img.std() <= 0:
        raise AssertionError(f"cli play wrote an image of shape {img.shape}, std {img.std()}")
    lines = [x for x in proc.stdout.splitlines() if x.startswith(("played", "wrote"))]
    log(f"phase 34 cli play --map bigmap --frames 3 {W}x{H} mcpg in a subprocess [{smi}]: "
        f"{secs:.1f} s; {' | '.join(lines)}")
    return {"seconds": secs}


# ---- phases 35-37: the native builder, .bsp/.pak loading, row slabs ----

def room_bsp() -> bytes:
    """A BSP29 file of a closed 512x512x256 room, built here (the port has
    no BSP writer): floor and three walls of plain textures, one wall of
    fullbright texels (the room's light), a sky ceiling, a
    worldspawn with a sun and an info_player_start. Every face is a quad
    whose plane normal points into the room."""
    import struct

    S, Z = 512.0, 256.0
    # (corners, inward normal, texture index, s axis, t axis)
    quads = [
        ([(0, 0, 0), (S, 0, 0), (S, S, 0), (0, S, 0)], (0, 0, 1), 0, (1, 0, 0), (0, 1, 0)),
        ([(0, 0, Z), (0, S, Z), (S, S, Z), (S, 0, Z)], (0, 0, -1), 2, (1, 0, 0), (0, 1, 0)),
        ([(0, 0, 0), (0, 0, Z), (S, 0, Z), (S, 0, 0)], (0, 1, 0), 1, (1, 0, 0), (0, 0, 1)),
        ([(0, S, 0), (S, S, 0), (S, S, Z), (0, S, Z)], (0, -1, 0), 1, (1, 0, 0), (0, 0, 1)),
        ([(0, 0, 0), (0, S, 0), (0, S, Z), (0, 0, Z)], (1, 0, 0), 3, (0, 1, 0), (0, 0, 1)),
        ([(S, 0, 0), (S, 0, Z), (S, S, Z), (S, S, 0)], (-1, 0, 0), 1, (0, 1, 0), (0, 0, 1)),
    ]
    pix = np.arange(256, dtype=np.uint8).reshape(16, 16)
    textures = [("floor1", (pix % 96).astype(np.uint8)), ("wall3", (pix // 2 + 16).astype(np.uint8)),
                ("sky4", (pix % 64 + 32).astype(np.uint8)),
                ("+0light", (224 + pix % 31).astype(np.uint8))]
    miptex = b""
    offsets = []
    for name, p in textures:
        offsets.append(4 + 4 * len(textures) + len(miptex))
        w, h = p.shape[1], p.shape[0]
        m0 = 40
        mips = (m0, m0 + w * h, m0 + w * h + w * h // 4, m0 + w * h + w * h // 4 + w * h // 16)
        miptex += name.encode().ljust(16, b"\0") + struct.pack("<ii", w, h) + struct.pack("<4i", *mips)
        miptex += p.tobytes() + bytes(w * h // 4 + w * h // 16 + w * h // 64)
    tex_lump = struct.pack(f"<i{len(textures)}i", len(textures), *offsets) + miptex
    planes, texinfo, verts, faces = b"", b"", [], b""
    edges, surfedges = [(0, 0)], []
    for q, (corners, normal, tex, s_ax, t_ax) in enumerate(quads):
        n = np.asarray(normal, np.float32)
        planes += struct.pack("<4fi", *n, float(np.dot(n, corners[0])), int(np.argmax(np.abs(n))))
        texinfo += struct.pack("<8f2i", *(np.asarray(s_ax) / 4.0), 0.0, *(np.asarray(t_ax) / 4.0),
                               0.0, tex, 0)
        first = len(surfedges)
        base = len(verts)
        verts += corners
        for k in range(4):
            surfedges.append(len(edges))
            edges.append((base + k, base + (k + 1) % 4))
        faces += struct.pack("<HHiHH4Bi", q, 0, first, 4, q, 0, 0, 0, 0, -1)
    entities = (b'{ "classname" "worldspawn" "_sunlight" "150" }\n'
                b'{ "classname" "info_player_start" "origin" "64 256 40" "angle" "0" }')
    lumps = {
        0: entities + b"\0", 1: planes, 2: tex_lump,
        3: np.asarray(verts, "<f4").tobytes(), 6: texinfo, 7: faces,
        12: np.asarray(edges, "<u2").tobytes(), 13: np.asarray(surfedges, "<i4").tobytes(),
        14: struct.pack("<9f7i", 0, 0, 0, S, S, Z, 0, 0, 0, 0, 0, 0, 0, 0, 0, len(quads)),
    }
    body, table, pos = b"", b"", 4 + 15 * 8
    for i in range(15):
        data = lumps.get(i, b"")
        table += struct.pack("<ii", pos, len(data))
        body += data
        pos += len(data)
    return struct.pack("<i", 29) + table + body


def table_diff(a, b) -> dict:
    """Two accels' tables, field by field: equal in value, and equal bit
    for bit (the sign of a zero counts); the Woop rows' largest
    difference."""
    fields = ("woop_w", "woop_w_shadow", "woop_w_alpha", "woop_w_proxy", "cluster_lo",
              "cluster_hi", "cluster_lo_proxy", "cluster_hi_proxy", "tri_attr", "candidate")
    bits = lambda x: x if x.dtype == torch.bool else x.view(torch.uint8)
    value, bit = {}, {}
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        both = x is not None and y is not None
        value[f] = (x is None and y is None) or (both and torch.equal(x, y))
        bit[f] = (x is None and y is None) or (both and torch.equal(bits(x), bits(y)))
    return {"value_equal": value, "bit_equal": bit,
            "woop_max_abs": float((a.woop_w - b.woop_w).abs().max())}


def phase35(dev, native_build_s, smi):
    """The native accel builder: native against numpy on city and on the
    map (seconds, tables bit for bit, the Woop rows' largest difference);
    K1 and K3 on native-built tables against their plain versions on
    65,536 primary rays; a cluster="morton" city renders a finite 1080p PT
    frame (K1)."""
    from merian_quake_tpu_torch.accel import build_accel, woop
    from merian_quake_tpu_torch.accel.build import scene_features
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.utils import native

    stats, max_abs = {"g++_s": native_build_s, "flags": " ".join(native.CXXFLAGS)}, []
    accels = {}
    for name, kw in (("city", {}), ("map", MAP)):
        bundle = city(**kw, device=dev)
        secs = {}
        for route in ("native", "numpy"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            acc = build_accel(bundle.scene, bundle.atlas, native=route == "native")
            torch.cuda.synchronize()
            secs[route] = time.perf_counter() - t0
            accels[(name, route)] = acc
        d = table_diff(accels[(name, "native")], accels[(name, "numpy")])
        stats[name] = {"tris": bundle.scene.num_tris, "native_s": secs["native"],
                       "numpy_s": secs["numpy"], **d}
        log(f"phase 35 build_accel {name} ({bundle.scene.num_tris} triangles) [{smi}]: native "
            f"{secs['native']:.3f} s, numpy {secs['numpy']:.3f} s; Woop rows' largest "
            f"difference {d['woop_max_abs']:.3e}; equal in value {d['value_equal']}; bit for bit "
            f"{d['bit_equal']}")
        # tests/test_torch_native.py's bounds: Woop rows within 1e-6 relative,
        # the rest equal
        na, nu = accels[(name, "native")], accels[(name, "numpy")]
        woop_ok = all(torch.allclose(getattr(na, f), getattr(nu, f), rtol=1e-6, atol=0)
                      for f in ("woop_w", "woop_w_shadow") if getattr(na, f) is not None)
        if not woop_ok or not all(v for f, v in d["value_equal"].items()
                                  if not f.startswith("woop_w")):
            raise AssertionError(f"{name}: the native and numpy tables differ")
        acc = accels[(name, "native")]
        po, pd = primary_rays(bundle, acc, dev)
        mid = slice(W * H // 2, W * H // 2 + SUBSET)
        full = lambda v: torch.full((SUBSET,), v, device=dev)
        args = woop.k1_inputs(acc, po[mid].contiguous(), pd[mid].contiguous(), full(0.0),
                              full(1e4))
        kernel = woop.woop_stream if woop.streamed(acc.woop_w) else woop.woop_nearest
        ref = woop.intersect_woop_reference(args[0], args[1])
        max_abs.append(check_exact(35, f"{name} native-built primary {SUBSET} "
                                       f"{kernel.__name__}", kernel(*args), ref))
    # the Morton order: a whole PT frame
    bundle = city(device=dev)
    t0 = time.perf_counter()
    acc = build_accel(bundle.scene, bundle.atlas, cluster="morton")
    morton_s = time.perf_counter() - t0
    config = RenderConfig(width=W, height=H, spp=SPP, max_path_length=MPL,
                          features=scene_features(bundle.scene, bundle.uniforms, bundle.atlas))
    _, out, counts, ms, _ = frames_run(35, "pt_morton", dev, bundle, acc, config, None, 3, (1, 3),
                                       {"woop_nearest": 1 + SPP * (MPL - 1)}, smi,
                                       W * H * (1 + SPP * (MPL - 1)))
    stats["morton"] = {"build_s": morton_s, "ms": float(np.mean(ms[1:]))}
    stats["max_abs_err"] = max(max_abs)
    log(f"phase 35 cluster=morton city: build {morton_s:.3f} s (native), 1080p PT frames "
        f"{np.mean(ms[1:]):.1f} ms/frame, finite")
    return {"pt_morton": counts}, stats


def phase36(dev, smi):
    """.bsp/.pak loading: room_bsp() written into a .pak, read back through
    PakFile → load_bsp → scene_from_bsp(device=card) → build_accel, a 1080p
    PT frame through K1; 64x40 PT frames on the CPU and on the card."""
    import os
    import tempfile

    from merian_quake_tpu_torch.accel import build_accel
    from merian_quake_tpu_torch.accel.build import scene_features
    from merian_quake_tpu_torch.models.bsp import load_bsp
    from merian_quake_tpu_torch.models.extract import scene_from_bsp
    from merian_quake_tpu_torch.models.pak import PakFile, write_pak
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.renderer import render_sequence

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pak0.pak")
        write_pak(path, {"maps/room.bsp": room_bsp()})
        t0 = time.perf_counter()
        data = PakFile(path).read("maps/room.bsp")
    bsp = load_bsp(data)
    bundle = scene_from_bsp(bsp)  # the card: the default device
    if bundle.scene.v0.device.type != "cuda" or bundle.atlas.data.device.type != "cuda":
        raise AssertionError("scene_from_bsp did not place its bundle on the card")
    acc = build_accel(bundle.scene, bundle.atlas)
    load_s = time.perf_counter() - t0
    feats = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    config = RenderConfig(width=W, height=H, spp=SPP, max_path_length=MPL, features=feats)
    _, out, counts, ms, _ = frames_run(36, "pt_bsp", dev, bundle, acc, config, None, 3, (1, 3),
                                       {"woop_nearest": 1 + SPP * (MPL - 1)}, smi,
                                       W * H * (1 + SPP * (MPL - 1)))
    # CPU against card at 64x40. The floor's texels are 4 world units wide
    # and the eye sits at a whole unit, so on one image row the primary hits
    # land on texel borders, where nearest sampling takes either texel by
    # an ulp of the hit (Moller-Trumbore on the CPU, Woop on the card); a
    # bounce from there, or from an edge of the room, can take another path,
    # and one firefly moves the whole image's exposure. So: the direct-light
    # frames (max path length 1) in full, LDR and HDR; the full frames' HDR
    # on the pixels whose first-hit albedo agrees, with the rest counted
    small = RenderConfig(width=64, height=40, spp=SPP, features=feats)
    runs = {}
    for device in ("cpu", dev):
        b = scene_from_bsp(load_bsp(data), device=device)
        for mpl in (1, MPL):
            state, o = render_sequence(b, small._replace(max_path_length=mpl), frames=2,
                                       device=device)
            runs[(str(device), mpl)] = {"ldr": o["ldr"].cpu(), "hdr": o["hdr"].cpu(),
                                        "albedo": state.accum_albedo[..., :3].cpu()}
    reading = lambda x, y, m: (float(((x - y).abs().amax(-1) <= PIX_TOL)[m].float().mean()),
                               float((x - y).abs()[m].mean()))
    every = torch.ones((40, 64), dtype=torch.bool)
    cpu1, card1 = runs[("cpu", 1)], runs[(str(dev), 1)]
    cpu3, card3 = runs[("cpu", MPL)], runs[(str(dev), MPL)]
    same_hit = (cpu3["albedo"] - card3["albedo"]).abs().amax(-1) <= PIX_TOL
    read = {"direct_ldr": reading(cpu1["ldr"], card1["ldr"], every),
            "direct_hdr": reading(cpu1["hdr"], card1["hdr"], every),
            "full_hdr_same_first_hit": reading(cpu3["hdr"], card3["hdr"], same_hit),
            "full_ldr": reading(cpu3["ldr"], card3["ldr"], every),
            "first_hit_albedo_differs": int((~same_hit).sum())}
    log(f"phase 36 room.bsp from a .pak: {int(bundle.scene.valid.sum())} triangles, "
        f"{len(bsp.textures)} textures, sun {bsp.entities[0].get('_sunlight')}; load + extract + "
        f"build {load_s:.3f} s; 1080p PT {np.mean(ms[1:]):.1f} ms/frame; cpu vs cuda 64x40 x2 "
        f"frames (pixels within {PIX_TOL}, mean |d|): {read}")
    held = [read[k] for k in ("direct_ldr", "direct_hdr", "full_hdr_same_first_hit")]
    if any(share < PIX_SHARE or mean >= MEAN_TOL for share, mean in held) \
            or read["first_hit_albedo_differs"] > 0.01 * 64 * 40:
        raise AssertionError("the .bsp frame: CPU and card disagree")
    return {"pt_bsp": counts}, {"load_s": load_s, "ms": float(np.mean(ms[1:])), **read}


# the sharded frames (phase 37): three gloo ranks share the one card; each
# renders a 360-row slab of the 1080p frame, which tiles
# (scripts/multichip_torch.py runs the phase with one card a rank)
RANKS, SHARD_FRAMES = 3, 4


def _shard_rank(mesh, kind, frames):
    """One rank of phase 37: ``frames`` frames of this rank's slab of the
    city at 1080p (``kind``: "mcpg", "restir" or "pt_denoise"), the launch
    counts set to 0 just before and read just after each frame, the bytes
    it received from all_gather. Returns what the parent holds."""
    from merian_quake_tpu_torch.accel import build_accel
    from merian_quake_tpu_torch.accel.build import scene_features
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.parallel import render as par
    from merian_quake_tpu_torch.post import sharded
    from merian_quake_tpu_torch.render.mcpg import updates

    bundle = city(device=mesh.device)
    acc = build_accel(bundle.scene, bundle.atlas)
    config, icfg = shard_config(kind, scene_features(bundle.scene, bundle.uniforms, bundle.atlas),
                                mesh.size)
    state = par.init_state_sharded(mesh, config, icfg)
    got = [0]
    gather = sharded.ShardCtx.all_gather

    def counted(self, x):
        got[0] += x.numel() * x.element_size() * self.n
        return gather(self, x)

    sharded.ShardCtx.all_gather = counted
    # the live rows each slab's queues hold before their compaction to
    # capacity / n (kept as tensors: no host read inside a frame)
    compact = updates.compact_queues
    live = []

    def counting(result, mcfg, *a, **kw):
        S = mcfg.mc_total_size
        lmask = result.lc_samples.mask & torch.isfinite(result.lc_samples.irr).all(-1)
        live.append(torch.stack([(result.updates.data[:, 14] < S).sum(), lmask.sum(),
                                 result.zeros.mask.sum()]))
        return compact(result, mcfg, *a, **kw)

    updates.compact_queues = counting
    per_frame, ms, bytes_, ldr0 = [], [], [], None
    try:
        for i in range(frames):
            reset_launches()
            got[0] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, ldr, hdr = par.render_frame_sharded(
                mesh, acc, bundle.atlas, bundle.uniforms._replace(frame=i), config, state, icfg)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            per_frame.append(launches())
            bytes_.append(got[0])
            ldr0 = ldr.cpu() if ldr0 is None else ldr0
    finally:
        sharded.ShardCtx.all_gather = gather
        updates.compact_queues = compact
    out = {"ldr": ldr.cpu(), "hdr": hdr.cpu(), "ldr0": ldr0, "ms": ms, "launches": per_frame,
           "gather_bytes": bytes_, "live_rows": [x.tolist() for x in live]}
    if state.mcpg is not None:
        out.update(mc_f=state.mcpg.mc.f.cpu(), mc_i=state.mcpg.mc.i.cpu(),
                   lc_irr=state.mcpg.lc.irr.cpu(), lc_hash=state.mcpg.lc.hash.cpu(),
                   lc_n=state.mcpg.lc.N.cpu())
    if state.svgf is not None:
        out["svgf_irr"] = state.svgf.irr.cpu()
    return out


def shard_config(kind, feats, ranks):
    """(RenderConfig, integrator config) of a phase 37 run on ``ranks``
    slabs."""
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig

    kw = dict(width=W, height=H, spp=SPP, max_path_length=MPL, features=feats)
    if kind == "mcpg":
        return RenderConfig(**kw, integrator="mcpg"), MCPGConfig()
    if kind == "mcpg_wide":
        # each slab's share of the queue capacities = MCPGConfig()'s whole
        c = MCPGConfig()
        return RenderConfig(**kw, integrator="mcpg"), c._replace(
            update_queue_capacity=ranks * c.update_queue_capacity,
            lc_queue_capacity=ranks * c.lc_queue_capacity,
            zero_queue_capacity=ranks * c.zero_queue_capacity)
    if kind == "restir":
        return RenderConfig(**kw, integrator="restir"), ReSTIRConfig()
    return RenderConfig(**kw, denoise=True), None


def phase37(dev, smi, n=RANKS, backend="gloo", frames=None):
    """Row slabs: dryrun_multichip(n) on the card, then the sharded city
    frames of n ranks (MCPG 4 frames at two queue capacities, ReSTIR and
    denoised PT 1 frame each; ``frames`` of each when given), against the
    single-device frames on ``dev``. Rank r runs on card r mod the cards
    there are: with one card (gloo), all n share it."""
    from merian_quake_tpu_torch.accel import build_accel
    from merian_quake_tpu_torch.accel.build import scene_features
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.parallel.render import (
        dryrun_multichip, queue_gather_bytes, spawn_ranks,
    )
    from merian_quake_tpu_torch.render import layout
    from merian_quake_tpu_torch.renderer import frame_core, init_state

    cards = torch.cuda.device_count()
    how = (f"{n} {backend} ranks sharing one card, not a multi-GPU time" if cards == 1
           else f"{n} {backend} ranks on {min(n, cards)} cards")
    # none of these frames reads the slabs' flat buffers end to end (SSMM
    # does), so slabs that do not tile as the image does are allowed
    tiles = layout.is_tiled(W, H // n)
    t0 = time.perf_counter()
    dry = dryrun_multichip(n, device=dev, backend=backend)
    log(f"phase 37 dryrun_multichip({n}, cuda) [{smi}; {how}]: "
        f"{time.perf_counter() - t0:.1f} s, ldr {tuple(dry['ldr'].shape)} finite, replicas "
        f"bit-equal, {dry['live_states']} live states; {H // n}-row slabs "
        f"{'tile' if tiles else 'do not tile'}")

    bundle = city(device=dev)
    acc = build_accel(bundle.scene, bundle.atlas)
    feats = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    paths, stats = {}, {}
    runs = (("mcpg", SHARD_FRAMES, {"woop_nearest": 3}),
            ("mcpg_wide", SHARD_FRAMES, {"woop_nearest": 3}),
            ("restir", 1, {"woop_nearest": 2, "woop_any": 1}),
            ("pt_denoise", 1, {"woop_nearest": 1 + SPP * (MPL - 1)}))
    for kind, k_frames, expect in runs:
        count = k_frames if frames is None else frames
        t0 = time.perf_counter()
        ranks = spawn_ranks(n, _shard_rank, kind, count, backend=backend, device=dev,
                            timeout_s=900)
        secs = time.perf_counter() - t0
        for r, o in enumerate(ranks):
            for i, got in enumerate(o["launches"]):
                if got != {**{k: 0 for k in got}, **expect}:
                    raise AssertionError(f"{kind} rank {r} frame {i}: launched {got}, expected "
                                         f"{expect}")
        paths[f"{kind}_{n}ranks"] = {k: sum(f[k] for o in ranks for f in o["launches"])
                                   for k in ranks[0]["launches"][0]}
        ldr = torch.cat([o["ldr"] for o in ranks])
        hdr = torch.cat([o["hdr"] for o in ranks])
        if tuple(ldr.shape) != (H, W, 3) or not bool(torch.isfinite(ldr).all()) \
                or not bool(torch.isfinite(hdr).all()):
            raise AssertionError(f"the sharded {kind} frame is not a finite 1080p image")
        # the single-device frames on the card, from the same empty state
        config, icfg = shard_config(kind, feats, n)
        state = init_state(config, icfg, device=dev)
        single_ms = []
        for i in range(count):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, out = frame_core(acc, bundle.atlas, bundle.uniforms._replace(frame=i), config,
                                    state, mcpg_config=icfg)
            torch.cuda.synchronize()
            single_ms.append((time.perf_counter() - t1) * 1e3)
            if i == 0:
                ldr0 = out["ldr"].cpu()
        read = {"single_device_ms": single_ms, "ldr_max": float((ldr - out["ldr"].cpu()).abs().max()),
                "hdr_max": float((hdr - out["hdr"].cpu()).abs().max()),
                "frame0_ldr_max": float((torch.cat([o["ldr0"] for o in ranks]) - ldr0)
                                        .abs().max())}
        if kind.startswith("mcpg"):
            for key in ("mc_f", "mc_i", "lc_irr", "lc_hash", "lc_n"):
                if any(not torch.equal(o[key], ranks[0][key]) for o in ranks[1:]):
                    raise AssertionError(f"the sharded MCPG frame: replica {key} differs")
            read["sum_w_max"] = float((ranks[0]["mc_f"][:, 3] - state.mcpg.mc.f[:, 3].cpu())
                                      .abs().max())
            read["lc_irr_max"] = float((ranks[0]["lc_irr"] - state.mcpg.lc.irr.cpu()).abs().max())
            read["live_states"] = int((ranks[0]["mc_f"][:, 3] > 0).sum())
            read["gather_bytes"] = [o["gather_bytes"] for o in ranks]
            read["queue_gather_bytes"] = queue_gather_bytes(config, icfg, n)
            # a slab keeps capacity / n rows of each queue: where a slab's
            # live rows pass that, it drops other rows than the single
            # device, which keeps the first rows of the whole image
            caps = (icfg.update_queue_capacity // n, icfg.lc_queue_capacity // n,
                    icfg.zero_queue_capacity // n)
            read["live_rows_by_rank"] = [o["live_rows"][-1] for o in ranks]
            read["slab_capacities"] = caps
            overflow = any(n > c for o in ranks for f in o["live_rows"] for n, c in zip(f, caps))
            read["a_slab_overflows"] = overflow
            held = read["frame0_ldr_max"] <= 3e-5
            if not overflow:
                held = held and read["ldr_max"] <= 3e-5 and read["sum_w_max"] <= 1e-5 \
                    and read["lc_irr_max"] <= 1e-5
            # the main path's capacities may overflow a slab (then frame 0,
            # before any guiding, is what must agree); the wide capacities
            # must not
            ok = held and not (kind == "mcpg_wide" and overflow)
        elif kind == "restir":
            ok = read["ldr_max"] <= 3e-5
        else:
            d = (ldr - out["ldr"].cpu()).abs()
            read["svgf_irr_max"] = float((torch.cat([o["svgf_irr"] for o in ranks])
                                          - state.svgf.irr.cpu()).abs().max())
            read["ldr_share_over_1e-3"] = float((d > 1e-3).float().mean())
            ok = read["hdr_max"] <= 1e-4 and read["svgf_irr_max"] <= 1e-5 \
                and read["ldr_share_over_1e-3"] < 0.02 and read["ldr_max"] < 0.1
        ms = [o["ms"] for o in ranks]
        steady = [float(np.mean(m[1:])) if len(m) > 1 else m[0] for m in ms]
        stats[kind] = {"rank_ms": ms, "steady_ms": steady, "spawn_to_end_s": secs, **read}
        log(f"phase 37 sharded {kind} city {W}x{H} spp {SPP} mpl {MPL} x{count} frames "
            f"[{smi}; {how}]: ms/frame by rank "
            f"{[[round(x, 1) for x in m] for m in ms]}; launches a rank a frame {expect}; "
            f"against the single-device frame on the card {read}; {secs:.1f} s")
        if not ok:
            raise AssertionError(f"the sharded {kind} frame disagrees with the single-device "
                                 f"frame: {read}")
    return paths, stats


# phase 38: frames captured in a CUDA graph (renderer.compile_frame,
# Graph.compile): frame 0 (the warm-up, the capture and the first replay)
# and 8 replays, each held bit for bit against eager frame_core / run
CAPTURE_FRAMES = 9
# the least span, ms, of the profiled eager frames and of the replays
PROFILE_MS = 250.0
# the trace kernels a captured frame launches
GRAPH_KERNELS = ("woop_nearest", "woop_any", "woop_stream", "woop_stream_any")


def differing_leaves(a, b) -> list:
    """Indices of the tensors of ``a`` and ``b`` (same structure) that are
    not equal bit for bit; ["structure"] if the structures differ."""
    from merian_quake_tpu_torch.capture import skeleton, tree_leaves

    if skeleton(a) != skeleton(b):
        return ["structure"]
    return [i for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b)))
            if not torch.equal(x, y)]


def profiled(fn, n):
    """(device ms a call, wall ms a call, device busy share) of ``n`` calls of
    ``fn`` under torch.profiler, device activity only: the device time is
    the sum of the kernels' and copies' own time, the wall the host clock
    around the calls and a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)
    total = sum(dev_us(e) for e in prof.key_averages() if e.device_type.name != "CPU") / 1e3
    return total / n, wall / n, total / wall


def captured_run(path, smi, captured, eager, state0, uniforms, captured_step, strip=lambda o: o,
                 want=None):
    """A captured path against its eager frames. ``captured(state, u)`` and
    ``eager(state, u)`` render one frame; ``captured_step()`` is the
    capture.CapturedStep after the first call; ``strip`` drops from the
    outputs what the two forms hold in other types (a graph's ``$frame``
    inputs). Frame 0's captured call warms up, captures and replays, with
    the launch counts set to 0 just before and read just after (the warm-up
    frames and the capture: WARMUP_STEPS + 1 frames' launches); then frames
    0-8, each captured state and output against eager frame_core (or run)
    from the same state, bit for bit. ``want``: the trace kernels a
    captured frame must launch. Returns (the path's launches, its stats)."""
    from merian_quake_tpu_torch.capture import WARMUP_STEPS, tree_map

    clone = lambda x: tree_map(torch.clone, x)
    path_t0 = time.perf_counter()
    reset_launches()
    ref_in = clone(state0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, out = captured(state0, uniforms._replace(frame=0))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = launches()
    cap = captured_step()
    in_graph = {k: v // (WARMUP_STEPS + 1) for k, v in counts.items() if k in GRAPH_KERNELS and v}
    if any(v % (WARMUP_STEPS + 1) for v in counts.values()) or (want and in_graph != want):
        raise AssertionError(f"phase 38 {path}: launches {counts} over the warm-up and the capture "
                             f"are not {WARMUP_STEPS + 1} frames' {want}")
    eager_ms, cap_ms, eager_launches = [], [], []
    for i in range(CAPTURE_FRAMES):
        u = uniforms._replace(frame=i)
        if i:
            ref_in = clone(st)
        torch.cuda.synchronize()
        before = launches()
        t0 = time.perf_counter()
        ref_st, ref_out = eager(ref_in, u)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        eager_launches.append({k: v - before[k] for k, v in launches().items()
                               if k in GRAPH_KERNELS and v - before[k]})
        if i:
            t0 = time.perf_counter()
            st, out = captured(st, u)
            torch.cuda.synchronize()
            cap_ms.append((time.perf_counter() - t0) * 1e3)
        bad_state, bad_out = differing_leaves(st, ref_st), differing_leaves(strip(out), strip(ref_out))
        if bad_state or bad_out:
            raise AssertionError(f"phase 38 {path} frame {i}: the captured frame differs from the "
                                 f"eager one in state leaves {bad_state}, output leaves {bad_out}")
        del ref_in, ref_st, ref_out
    if not bool(torch.isfinite(out["ldr"] if "ldr" in out else out[("hud", "out")]).all()):
        raise AssertionError(f"phase 38 {path}: the image is not finite")
    # the device's busy share on the profiler: eager frames and replays over
    # at least PROFILE_MS each (one 1080p frame; its processing of a frame's
    # kernels takes seconds), so that a short frame's window is not the
    # profiler's own start and flush
    fixed = clone(st)
    u = uniforms._replace(frame=CAPTURE_FRAMES)
    t0 = time.perf_counter()
    frames_for = lambda ms: max(1, math.ceil(PROFILE_MS / np.mean(ms[1:])))
    e_dev, e_wall, e_busy = profiled(lambda: eager(fixed, u), frames_for(eager_ms))
    c_dev, c_wall, c_busy = profiled(lambda: captured(st, u), frames_for(cap_ms))
    profile_s = time.perf_counter() - t0
    stats = {"eager_ms": float(np.mean(eager_ms[2:])), "captured_ms": float(np.mean(cap_ms[1:])),
             "first_call_s": first_s, "capture_s": cap.capture_seconds,
             "graph_pool_bytes": cap.pool_bytes, "replays": len(cap_ms) + 1,
             "eager_busy": e_busy, "captured_busy": c_busy, "eager_device_ms": e_dev,
             "captured_device_ms": c_dev, "launches_in_graph": in_graph,
             "eager_launches_per_frame": eager_launches[-1]}
    log(f"phase 38 {path} [{smi}]: eager {stats['eager_ms']:.2f} ms/frame (frames 2-8, busy "
        f"{e_busy:.3f}, device {e_dev:.2f} ms), captured {stats['captured_ms']:.2f} ms/frame "
        f"(replays 2-8, busy {c_busy:.3f}, device {c_dev:.2f} ms); capture {cap.capture_seconds:.3f} s "
        f"(first call with the {WARMUP_STEPS} warm-up frames {first_s:.2f} s); graph pool "
        f"{cap.pool_bytes} bytes; launches in the graph {in_graph} (eager frame "
        f"{eager_launches[-1]}); {CAPTURE_FRAMES} frames bit-identical to eager "
        f"({time.perf_counter() - path_t0:.1f} s, the profiler {profile_s:.1f} s of it)")
    return counts, stats


def dead_round(dev, bundle, accel, smi):
    """What a round of the alpha loop costs once every ray is dead (the
    captured loop runs all MAX_INTERSECTIONS rounds): the fogged court's
    2,073,600 primary rays, a dead round (K1 on empty intervals plus the
    round's glue) beside a live first round and K1 alone on the dead rays,
    CUDA events."""
    import importlib

    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.models import materials

    imod = importlib.import_module("merian_quake_tpu_torch.accel.intersect")
    o, d = primary_rays(bundle, accel, dev)
    n = o.shape[0]
    full = lambda v, dt=torch.float32: torch.full((n,), v, dtype=dt, device=dev)
    t_min, t_max = full(0.0), full(materials.T_MAX)
    result = imod.HitRecord(full(3e38), full(-1, torch.int32), full(0.0), full(0.0))
    rnd = lambda active: imod._alpha_round(accel, bundle.atlas, o, d, active, t_min, t_max, result)
    dead_mask, live_mask = full(False, torch.bool), full(True, torch.bool)
    rnd(dead_mask), rnd(live_mask)
    dead_ms, live_ms = cuda_time(lambda: rnd(dead_mask), 10), cuda_time(lambda: rnd(live_mask), 10)
    args = woop.k1_inputs(accel, o, d, t_min, full(imod._DEAD_T_MAX))
    k1_ms = cuda_time(lambda: woop.woop_nearest(*args), 10)
    log(f"phase 38 court alpha loop, one round on {n} rays [{smi}]: every ray dead "
        f"{dead_ms:.3f} ms (K1 on the empty intervals alone {k1_ms:.3f}), every ray live "
        f"{live_ms:.3f} ms")
    return {"dead_round_ms": dead_ms, "dead_round_k1_ms": k1_ms, "live_round_ms": live_ms}


def phase38(dev, bundle, accel, config, m_bundle, m_accel, m_config, smi):
    """Captured frames (renderer.compile_frame; Graph.compile for the
    flagship graph): city MCPG (the main path), city ReSTIR (K2), denoised
    city MCPG, map MCPG (K3), config1's small PT frame, the fogged court's
    MCPG + volume (the alpha loop on the device) and the flagship graph on
    the fogged court, each bit for bit against eager for 9 frames; then a
    dead alpha round's cost."""
    from merian_quake_tpu_torch.graph import Graph
    from merian_quake_tpu_torch.graph.nodes import GraphContext, flagship_graph_config
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.renderer import compile_frame, frame_core, init_state

    def frame_path(path, b, acc, cfg, icfg, want):
        state0 = init_state(cfg, icfg, device=dev)
        cf = compile_frame(acc, b.atlas, cfg, state0, icfg)
        return captured_run(
            path, smi, lambda st, u: cf(u),
            lambda st, u: frame_core(acc, b.atlas, u, cfg, st, mcpg_config=icfg),
            state0, b.uniforms, lambda: cf.captured, want=want)

    paths, stats = {}, {}
    k1 = {"woop_nearest": 3}
    for path, b, acc, cfg, icfg, want in (
            ("mcpg", bundle, accel, config._replace(integrator="mcpg"), MCPGConfig(), k1),
            ("restir", bundle, accel, config._replace(integrator="restir"), ReSTIRConfig(),
             {"woop_nearest": 2, "woop_any": 1}),
            ("mcpg_denoise", bundle, accel, config._replace(integrator="mcpg", denoise=True),
             MCPGConfig(), k1),
            ("mcpg_map", m_bundle, m_accel, m_config._replace(integrator="mcpg"), MCPGConfig(),
             {"woop_stream": 3})):
        paths[f"{path}_captured"], stats[path] = frame_path(path, b, acc, cfg, icfg, want)
    # a small frame (config1's: the box, PT, 1 spp, 640x360), launch-bound
    # when eager (PR 12)
    from merian_quake_tpu_torch.models.procedural import cornell_box

    box = cornell_box(device=dev)
    b_accel, b_cfg = scene_1080(box, spp=1, max_path_length=MPL)
    paths["pt_box_640x360_captured"], stats["pt_box_640x360"] = frame_path(
        "pt_box_640x360", box, b_accel, b_cfg._replace(width=640, height=360), None,
        {"woop_nearest": 1 + (MPL - 1)})
    c_bundle, c_accel, c_cfg = court(dev, FOG_MU_T)
    mcfg = MCPGConfig(volume=VolumeConfig())
    paths["mcpg_court_volume_captured"], stats["mcpg_court_volume"] = frame_path(
        "mcpg_court_volume", c_bundle, c_accel, c_cfg._replace(integrator="mcpg"), mcfg, None)

    g = Graph.from_config(flagship_graph_config(), GraphContext(
        c_accel, c_bundle.atlas, c_cfg._replace(integrator="mcpg", denoise=True),
        mcpg_config=MCPGConfig(volume=VolumeConfig(volume_spp=1)), device=dev))
    step = g.compile()
    frame_in = lambda u: {"uniforms": u}
    no_inputs = lambda o: {k: v for k, v in o.items() if k[0] != "$frame"}
    paths["graph_flagship_court_captured"], stats["graph_flagship_court"] = captured_run(
        "graph_flagship_court", smi, lambda st, u: step(st, frame_in(u)),
        lambda st, u: g.run(st, frame_in(u)), g.init_state(), c_bundle.uniforms,
        lambda: step.captured, strip=no_inputs)
    stats["court_dead_round"] = dead_round(dev, c_bundle, c_accel, smi)
    return paths, stats


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    run_t0 = time.perf_counter()
    from merian_quake_tpu_torch import kernels
    from merian_quake_tpu_torch.accel import build_accel, woop
    from merian_quake_tpu_torch.accel.build import scene_features
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig, build_scene_from_soup
    from merian_quake_tpu_torch.renderer import init_state, render_frame, render_sequence

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # ---- phase 1: device + build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    kernels.build_libraries(*kernels.KERNELS)
    build_s = time.perf_counter() - t0
    ptxas, spills = {}, {}
    for name in kernels.KERNELS:
        kernels.load_library(name)
        with open(kernels.library_path(name) + ".log") as f:
            lines = [line.strip() for line in f if "Used" in line or "spill" in line]
        ptxas[name] = " | ".join(lines)
        spills[name] = sum(int(x) for line in lines
                           for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", line))
    if spills["mt_dense"]:
        raise AssertionError(f"K8 spills registers: {ptxas['mt_dense']}")
    # the native accel builder (g++), which every build_accel below uses
    from merian_quake_tpu_torch.utils import native

    t0 = time.perf_counter()
    native.build_library()
    native_build_s = time.perf_counter() - t0
    log(f"phase 1 device: {kind} x{count} [{smi}] torch {torch.__version__} "
        f"cuda {torch.version.cuda}; the native accel builder (g++ {' '.join(native.CXXFLAGS)}) "
        f"{native_build_s:.2f} s; K1, K2, K3, K4 + K5, K6 + K7, K8 build {build_s:.2f} s; "
        f"spill bytes {spills}; " + "; ".join(f"{k} ({ptxas[k]})" for k in kernels.KERNELS))

    # seconds each phase took, printed with the whole run's
    marks = [(1, time.perf_counter())]
    mark = lambda phase: marks.append((phase, time.perf_counter()))

    # ---- phase 2: K1 vs plain version ----
    rng = np.random.default_rng(1337)
    n_tri = 256
    c = rng.uniform(-40, 40, (n_tri, 1, 3))
    tri = c + rng.uniform(-8, 8, (n_tri, 3, 3))
    soup = build_scene_from_soup(
        tri[:, 0].astype(np.float32), tri[:, 1].astype(np.float32),
        tri[:, 2].astype(np.float32), device=dev,
    )
    acc_soup = build_accel(soup)
    n = 512
    o = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[: n // 2] = 500.0
    d[: n // 2] = np.abs(d[: n // 2])
    o_t, d_t = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    full = lambda v, k: torch.full((k,), v, device=dev)
    max_abs = [compare_k1(
        "random soup", woop.k1_inputs(acc_soup, o_t, d_t, full(0.0, n), full(1e4, n)), woop
    )]
    # the compacted visit, hard: one or two live rays a warp; exact ties
    max_abs.append(compare_k1("random soup sparse warps", woop.k1_inputs(
        acc_soup, o_t, d_t, full(0.0, n), sparse_warps(full(1e4, n))), woop))
    ties = tie_table(dev)
    max_abs.append(compare_k1("tie table sparse warps", ties, woop))
    tie_hits = woop.woop_nearest(*ties)[1]
    if not bool(((tie_hits >= 0) & (tie_hits < 128)).any()):
        raise AssertionError("the tie table: no nearest hit lies on a duplicated triangle")

    bundle = city(device=dev)
    accel = build_accel(bundle.scene, bundle.atlas)
    feats = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    config = RenderConfig(width=W, height=H, spp=SPP, max_path_length=MPL, features=feats)
    n_full = W * H
    po, pd = primary_rays(bundle, accel, dev)
    ubo, ubd, ubt = bounce_rays(bundle, accel, config, dev)  # as a frame traces them
    perm = woop.sort_perm(accel, ubo, ubd, ubt)
    bo, bd, bt = ubo[perm].contiguous(), ubd[perm].contiguous(), ubt[perm].contiguous()
    mid = slice(n_full // 2, n_full // 2 + SUBSET)
    max_abs.append(compare_k1("city primary 65536", woop.k1_inputs(
        accel, po[mid].contiguous(), pd[mid].contiguous(), full(0.0, SUBSET), full(1e4, SUBSET)
    ), woop))
    for t_min in (0.0, 1e-3):
        max_abs.append(compare_k1(f"city bounce 65536 t_min={t_min}", woop.k1_inputs(
            accel, bo[mid].contiguous(), bd[mid].contiguous(), full(t_min, SUBSET),
            bt[mid].contiguous(),
        ), woop))
    max_abs.append(compare_k1("city bounce unsorted 65536 t_min=0.0", woop.k1_inputs(
        accel, ubo[mid].contiguous(), ubd[mid].contiguous(), full(0.0, SUBSET),
        ubt[mid].contiguous(),
    ), woop))

    # full 1080p populations: K1 timed twice, the plain version once, and
    # their outputs held against each other
    timings, k1_split = {}, {}
    for name, args in (
        ("primary", woop.k1_inputs(accel, po, pd, full(0.0, n_full), full(1e4, n_full))),
        ("bounce", woop.k1_inputs(accel, bo, bd, full(0.0, n_full), bt)),
        ("bounce_unsorted", woop.k1_inputs(accel, ubo, ubd, full(0.0, n_full), ubt)),
    ):
        # the plain version's one run (6 s on a whole population) is both
        # the comparison and its time
        ref, r1 = timed_call(lambda: woop.intersect_woop_reference(args[0], args[1]))
        k1 = lambda: woop.woop_nearest(*args)
        max_abs.append(check_exact(2, f"city {name} {n_full} t_min=0.0", k1(), ref[0]))
        k_1 = cuda_time(k1, 10)
        k_2 = cuda_time(k1, 10)
        ops, nbytes = woop_work(woop.woop_nearest, args)
        timings[name] = ((k_1 + k_2) / 2, r1, *bound_ms(ops, nbytes))
        # K3 on the same table: the other side of the routing threshold,
        # timed in turns with K1
        k3 = lambda: woop.woop_stream(*args)
        check_exact(2, f"city {name} {n_full} K3 vs K1", k3(), k1())
        s_1, c_1, c_2, s_2 = cuda_time(k3, 10), cuda_time(k1, 10), cuda_time(k1, 10), cuda_time(k3, 10)
        log(f"phase 2 timing {name} {n_full} rays [{smi}]: K1 {k_1:.3f} / {k_2:.3f} ms, "
            f"plain {r1:.1f} ms; bound {timings[name][2]:.4f} ms "
            f"({timings[name][3]}; {ops / OPS_NEAREST:.4g} pairs tested); K3 forced "
            f"{s_1:.3f} / {s_2:.3f} ms against K1 {c_1:.3f} / {c_2:.3f} ms"
            + first_design_ms("K1", name))
        k1_split[name] = trace_split(2, f"city {name} K1", woop.woop_nearest, args, smi,
                                     FIRST_DESIGN["K1"]["split"].get(name))
    k1_ctas = woop.ctas_per_sm("woop_nearest", accel.cluster_lo.shape[0])
    log(f"phase 2 K1 on city ({accel.cluster_lo.shape[0]} clusters): {k1_ctas} CTAs of 128 "
        f"threads an SM (the first design: {FIRST_DESIGN['K1']['ctas_per_sm']})")
    max_abs.append(compare_k1(f"city bounce {n_full} t_min=0.001", woop.k1_inputs(
        accel, bo, bd, full(1e-3, n_full), bt), woop))

    mark(2)
    # ---- phase 3: the slice on the card ----
    state = init_state(config, device=dev)
    reset_launches()
    uniforms = bundle.uniforms
    frame_ms = []
    for i in range(6):
        before = woop.woop_nearest.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = render_frame(accel, bundle.atlas, uniforms._replace(frame=i), config, state)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        launched = woop.woop_nearest.launches - before
        if launched != 1 + SPP * (MPL - 1):
            raise AssertionError(f"frame {i}: K1 launched {launched} times, expected 5")
    pt_city = launches()
    if pt_city != {**{k: 0 for k in pt_city}, "woop_nearest": 6 * (1 + SPP * (MPL - 1))}:
        raise AssertionError(f"the path-traced city frames launched {pt_city}, expected K1 alone")
    for name, x in (("ldr", out["ldr"]), ("hdr", out["hdr"]),
                    ("accum_irradiance", state.accum_irradiance),
                    ("accum_direct", state.accum_direct),
                    ("accum_albedo", state.accum_albedo)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name} is not finite")
    if tuple(out["ldr"].shape) != (H, W, 3) or float(out["ldr"].std()) <= 0.0:
        raise AssertionError("ldr has the wrong shape or is constant")
    steady = float(np.mean(frame_ms[2:]))
    rays = W * H * (1 + SPP * (MPL - 1))
    log(f"phase 3 slice city {W}x{H} spp {SPP} mpl {MPL} [{smi}]: launches {pt_city}; "
        f"cold {frame_ms[0]:.1f} ms, steady {steady:.1f} ms/frame "
        f"(frames {', '.join(f'{x:.1f}' for x in frame_ms)}), "
        f"{rays / steady / 1e3:.2f} Mrays/s; ldr mean {float(out['ldr'].mean()):.4f}")

    mark(3)
    # ---- phase 4: CPU oracle vs card K1 ----
    small = RenderConfig(width=64, height=36, spp=SPP, max_path_length=MPL)
    _, out_cpu = render_sequence(city(device="cpu"), small, frames=3, device="cpu")
    _, out_gpu = render_sequence(city(device="cpu"), small, frames=3, device=dev)
    diff = (out_cpu["ldr"] - out_gpu["ldr"].cpu()).abs()
    share = float((diff.amax(-1) <= PIX_TOL).float().mean())
    mean = float(diff.mean())
    log(f"phase 4 cpu vs cuda 64x36 x3 frames: pixels within {PIX_TOL} {share:.5f}, "
        f"mean |d| {mean:.3e}, max |d| {float(diff.max()):.3e}")
    if share < PIX_SHARE or mean >= MEAN_TOL:
        raise AssertionError("CPU and card LDR images disagree")

    mark(4)
    # ---- phase 5: K2 vs plain version ----
    k2 = phase5(dev, rng, acc_soup, bundle, accel, config, smi)
    mark(5)

    # ---- phase 6: the ReSTIR slice on the card ----
    restir_city, f4_city_frames, restir_last = phase6(dev, bundle, accel, feats, smi)
    mark(6)

    # ---- phase 7: CPU oracle vs card K1 + K2, ReSTIR ----
    phase7(dev)
    mark(7)

    # ---- phases 8-11: the map scene, K3 and K8 ----
    soup = (acc_soup, o_t, d_t)
    m_bundle, m_accel, m_config = map_scene(dev)
    k3, (mpo, mpd) = phase8(dev, soup, m_bundle, m_accel, m_config, smi)
    mark(8)
    k8 = phase9(dev, soup, m_accel, mpo, mpd, smi)
    mark(9)
    map_paths, f4_map_frames = phase10(dev, m_bundle, m_accel, m_config, smi)
    mark(10)
    phase11(dev)
    mark(11)

    # ---- phases 12-15: city(1600, 7), the trace schedules ----
    c16 = city1600(dev)
    k45 = phase12(dev, soup, c16, smi)
    mark(12)
    walk = phase13(dev, soup, c16, smi)
    mark(13)
    sched_paths, _, f4_sched_frames = phase14(dev, c16, smi)
    mark(14)
    phase15(dev)
    mark(15)

    # ---- phases 16-19: the MCPG surface frame ----
    mcpg_city, mcpg_sched, city_pops, mcpg_city_t, mcpg_last = phase16(dev, bundle, accel, config,
                                                                       c16, smi)
    mark(16)
    mcpg_map, map_pops, mcpg_map_t = phase17(dev, m_bundle, m_accel, m_config, smi)
    mark(17)
    g1 = phase18(dev, "city", accel, city_pops[0], woop.woop_nearest, woop.woop_stream, smi)
    g3 = phase18(dev, "map", m_accel, map_pops[0], woop.woop_stream, woop.woop_nearest, smi)
    mark(18)
    phase19(dev)
    mark(19)

    # ---- phases 20-22: the court, the volume pass, the production config ----
    court_paths, court_stats = phase20(dev, smi)
    mark(20)
    volume_path, volume_stats, g_vol = phase21(dev, smi)
    mark(21)
    prod_path, prod_stats = phase22(dev, bundle, accel, config, smi)
    mark(22)

    # ---- phases 23-25: the denoise chain, the volume's SVGF, SSMM ----
    denoise_path, restir_dn_path, denoise_stats = phase23(dev, bundle, accel, config, mcpg_city_t,
                                                          smi)
    mark(23)
    court_dn_path, court_dn_stats = phase24(dev, smi)
    mark(24)
    ssmm_path, ssmm_court_path, ssmm_stats = phase25(dev, bundle, accel, config, smi)
    mark(25)

    # ---- phases 26-28: presets and certification, the frame graph, debug views ----
    preset_paths, preset_stats = phase26(dev, smi)
    mark(26)
    graph_paths, graph_stats = phase27(dev, bundle, accel, config, smi)
    mark(27)
    debug_stats = phase28(dev, bundle, accel, mcpg_last, restir_last, smi)
    mark(28)

    # ---- phases 29-34: F7, the live game loop, the orbit presets, the CLI ----
    f7_stats = phase29(dev, bundle, accel, config, smi)
    mark(29)
    dungeon, live_paths, live_stats = phase30(dev, smi)
    mark(30)
    arena_paths, refresh_stats = phase31(dev, dungeon, smi)
    del dungeon
    mark(31)
    live_cpu_stats = phase32(dev, smi)
    mark(32)
    orbit_paths, orbit_stats = phase33(dev, smi)
    mark(33)
    cli_stats = phase34(dev, smi)
    mark(34)

    # ---- phases 35-37: the native builder, .bsp/.pak loading, row slabs ----
    native_paths, native_stats = phase35(dev, native_build_s, smi)
    mark(35)
    bsp_paths, bsp_stats = phase36(dev, smi)
    mark(36)
    shard_paths, shard_stats = phase37(dev, smi)
    mark(37)

    # ---- phase 38: the frame captured in one CUDA graph ----
    capture_paths, capture_stats = phase38(dev, bundle, accel, config, m_bundle, m_accel, m_config,
                                           smi)
    mark(38)
    log(f"chip_smoke: every phase passed in {time.perf_counter() - run_t0:.1f} s (phase 1 "
        f"{marks[0][1] - run_t0:.1f} s, " + ", ".join(
            f"{b[0]} {b[1] - a[1]:.1f}" for a, b in zip(marks, marks[1:])) + ")")

    paths = {"pt": pt_city, "restir": restir_city, "dense_map": k8["launches"],
             "pt_map": map_paths["pt"], "restir_map": map_paths["restir"], **sched_paths,
             "mcpg": mcpg_city, "mcpg_map": mcpg_map, **mcpg_sched, **court_paths,
             "mcpg_court_volume": volume_path, "mcpg_production": prod_path,
             "mcpg_denoise": denoise_path, "restir_box_denoise": restir_dn_path,
             "mcpg_court_volume_denoise": court_dn_path, "ssmm": ssmm_path,
             "ssmm_court_denoise": ssmm_court_path, **preset_paths, **graph_paths,
             **live_paths, **arena_paths, **orbit_paths, **native_paths, **bsp_paths,
             **shard_paths, **capture_paths}
    by_path = lambda k: {p: v[k] for p, v in paths.items()}
    total = lambda k: sum(by_path(k).values())
    # a PT frame's 1 primary + 4 bounce traces, the bounce rays as they lie
    mix = lambda x, key: (x["primary"][key] + 4 * x["bounce_unsorted"][key]) / 5
    city_t = {k: dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"), v)) for k, v in timings.items()}
    print(json.dumps({"kernels": [{
        "name": "woop_nearest", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": total("woop_nearest"),
        "launches_by_path": by_path("woop_nearest"),
        "max_abs_err": max(max_abs + [g1["max_abs_err"], native_stats["max_abs_err"]]),
        "ms": mix(city_t, "ms"),
        "plain_ms": mix(city_t, "plain_ms"),
        "bound_ms": mix(city_t, "bound_ms"), "bound_by": city_t["bounce_unsorted"]["bound_by"],
        "library_ms": None, "rays": n_full, "scene": "city",
        "ctas_per_sm": k1_ctas, "lane_use": {k: v["lane_use"] for k, v in k1_split.items()},
        "cycle_shares": {k: v["shares"] for k, v in k1_split.items()},
        "sorted_bounce_ms": city_t["bounce"]["ms"],
        "sorted_bounce_bound_ms": city_t["bounce"]["bound_ms"],
        "mcpg_bounce": g1, "mcpg_frame_ms": mcpg_city_t["ms"], "mcpg_frame_cold_ms": mcpg_city_t["cold"],
        "volume_scatter": g_vol, "court_alpha_loop": {**court_stats, "mcpg_volume": volume_stats},
        "production_frame": prod_stats, "denoise_frame": denoise_stats,
        "court_volume_denoise_frame": court_dn_stats, "ssmm_frame": ssmm_stats,
        "presets": preset_stats, "graph": graph_stats, "debug_views": debug_stats,
        "f7_replay_scan": f7_stats, "live_arena": {
            k: v for k, v in refresh_stats.items() if k != "k3"},
        "orbit_presets_ms": orbit_stats, "live_cpu_vs_card": live_cpu_stats,
        "cli_play_bigmap": cli_stats, "native_builder": native_stats, "bsp_frame": bsp_stats,
        "sharded_3_gloo_ranks_one_card": shard_stats, "captured_frames": capture_stats,
    }, {
        "name": "woop_any", "route": "cuda", "source": K2_SOURCE,
        "replaces": K2_REPLACES, "launches": total("woop_any"),
        "launches_by_path": by_path("woop_any"),
        "max_abs_err": k2["max_abs_err"], "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"], "library_ms": None,
        "rays": n_full, "scene": "city", "table": "shadow", "pairs": k2["pairs"],
        "ctas_per_sm": k2["ctas_per_sm"], "lane_use": k2["lane_use"],
        "cycle_shares": k2["cycle_shares"],
        "proxy_prepass": {"city_trace": k2["f4_city"], "map_trace": k3["f4_map"],
                          "nodes_trace": walk["f4"],
                          "city_restir_frame": f4_city_frames, "map_restir_frame": f4_map_frames,
                          **{f"{p}_frame": v for p, v in f4_sched_frames.items()}},
    }, {
        "name": "woop_stream", "route": "cuda", "source": K3_SOURCE,
        "replaces": K3_REPLACES, "launches": total("woop_stream"),
        "launches_by_path": by_path("woop_stream"),
        "anyhit_launches_by_path": by_path("woop_stream_any"),
        "max_abs_err": max(k3["max_abs_err"], g3["max_abs_err"], refresh_stats["max_abs_err"]),
        "ms": mix(k3, "ms"),
        "plain_ms": mix(k3, "plain_ms"),
        "bound_ms": mix(k3, "bound_ms"), "bound_by": k3["bounce_unsorted"]["bound_by"], "library_ms": None,
        "rays": n_full, "plain_rays": SUBSET, "ms_plain_rays": mix(k3, "subset_ms"),
        "scene": "map", "shadow_ms": k3["shadow"]["ms"],
        "shadow_bound_ms": k3["shadow"]["bound_ms"], "ctas_per_sm": k3["ctas_per_sm"],
        "lane_use": {k: k3[k]["lane_use"] for k in K3_POPS},
        "cycle_shares": {k: k3[k]["shares"] for k in K3_POPS},
        "sorted_bounce_ms": k3["bounce"]["ms"], "sorted_bounce_bound_ms": k3["bounce"]["bound_ms"],
        "mcpg_bounce": g3, "mcpg_frame_ms": mcpg_map_t["ms"], "mcpg_frame_cold_ms": mcpg_map_t["cold"],
        "live_dungeon": {**live_stats, "refreshed_tables": refresh_stats["k3"]},
    }, {
        "name": "mt_dense", "route": "cuda", "source": K8_SOURCE,
        "replaces": K8_REPLACES, "launches": total("mt_dense"),
        "launches_by_path": by_path("mt_dense"),
        "max_abs_err": k8["max_abs_err"], "ms": k8["ms"], "plain_ms": k8["plain_ms"],
        "bound_ms": k8["bound_ms"], "bound_by": k8["bound_by"], "library_ms": None,
        "rays": SUBSET, "scene": "map", "bound_every_pair_ms": k8["bound_every_pair_ms"],
        "k3_ms": k8["k3_ms"], "passed_pretests": k8["passed"],
    }, {
        "name": "target_keys", "route": "cuda", "source": K45_SOURCE,
        "replaces": K4_REPLACES, "launches": total("target_keys"),
        "launches_by_path": by_path("target_keys"), "max_abs_err": k45["max_abs_err"]["K4"],
        **k45["K4"], "library_ms": None,
        "rays": n_full, "scene": "city1600",
    }, {
        # K5's two-mode entry (mq_te_union) runs on no frame's path: the
        # frames launch K5 through the fused list, the visit_list row
        "name": "te_union", "route": "cuda", "source": K45_SOURCE,
        "replaces": K5_REPLACES, "launches": total("te_union"),
        "launches_by_path": by_path("te_union"),
        "max_abs_err": k45["max_abs_err"]["K5"], **k45["K5 clusters"],
        "library_ms": None, "rays": n_full, "scene": "city1600",
        **{f"nodes8_{k}": v for k, v in k45["K5 nodes8"].items()},
    }, {
        "name": "visit_list", "route": "cuda", "source": K45_SOURCE,
        "replaces": K5_REPLACES, "also_replaces": "the row sort (XLA) at "
        "merian_quake_tpu/accel/woop.py:1251",
        "launches": total("visit_list"), "launches_by_path": by_path("visit_list"),
        "max_abs_err": k45["max_abs_err"]["list"], **k45["list clusters"],
        "library_ms": None, "rays": n_full, "scene": "city1600",
        **{f"nodes8_{k}": v for k, v in k45["list nodes8"].items()},
    }] + [{
        "name": f"woop_list ({kind_})", "route": "cuda", "source": K67_SOURCE,
        "replaces": replaces, "launches": total(counter),
        "launches_by_path": by_path(counter),
        "max_abs_err": walk["max_abs_err"], "ms": walk[key]["ms"],
        "plain_ms": walk["plain_ms_subset"], "plain_rays": SUBSET,
        "bound_ms": walk[key]["bound_ms"], "bound_by": walk[key]["bound_by"],
        "library_ms": None, "bound_fewest_pairs_ms": walk[key]["bound_fewest_ms"],
        "k1_ms": walk[key]["k1_ms"], "with_list_ms": walk[key]["with_list_ms"],
        "ctas_per_sm": walk["ctas_per_sm"], "spill_bytes": spills["woop_list"],
        "lane_use": {k: v["lane_use"] for k, v in walk.items() if isinstance(v, dict)
                     and "lane_use" in v},
        "cycle_shares": {k: v["cycle_shares"] for k, v in walk.items() if isinstance(v, dict)
                         and "cycle_shares" in v},
        "rays": n_full, "scene": "city1600", **extra,
    } for kind_, replaces, counter, key, extra in (
        ("nodes", K6_REPLACES, "woop_list_nodes", "bounce_target P=8 compact=0", {
            "list_walk_launches_by_path": {p: v["woop_list"] - v["woop_list_nodes"]
                                           for p, v in paths.items()},
            "list_walk_ms": walk["bounce_target P=1 compact=0"]["ms"],
            "list_walk_bound_ms": walk["bounce_target P=1 compact=0"]["bound_ms"],
            "anyhit_ms": walk["shade P=8 compact=0 any"]["ms"],
            "anyhit_with_list_ms": walk["shade P=8 compact=0 any"]["with_list_ms"],
            "anyhit_k2_ms": walk["shade P=8 compact=0 any"]["k1_ms"]}),
        ("compact", K7_REPLACES, "woop_list_compact", "bounce_target P=8 compact=32", {
            "compacted_visit_share": walk["bounce_target P=8 compact=32"]["cvisits"]
            / max(walk["bounce_target P=8 compact=32"]["visits"], 1),
            "primary_ms": walk["primary P=8 compact=32"]["ms"],
            "guided_ms": walk["guided P=8 compact=32"]["ms"],
            "guided_k1_ms": walk["guided P=8 compact=32"]["k1_ms"],
            "guided_rays": walk["guided P=8 compact=32"]["rays"]}),
    )]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
