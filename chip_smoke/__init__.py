"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 -m chip_smoke                   # phases 1-43
    python3 -m chip_smoke --phase 23 39 42  # phase 1, then those alone

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
walker K6/K7 (csrc/woop_list.cu, node walk and compacted visits), K8
(csrc/mt_dense.cu, the dense Möller–Trumbore sweep of
``accel.dense.intersect_dense``), the alpha walk (csrc/woop_alpha.cu,
trace_nearest's whole alpha loop on K1's or K3's walk), the SVGF's
temporal and à-trous kernels (csrc/svgf.cu), MCPG's guide-state draws
(csrc/mcpg_draw.cu) and the u32 RNG and hash-grid chains
(csrc/u32_chains.cu). Phases, one line each or more, in the order of
``registry.PHASES`` (39 runs after 31, on its live dungeon). ``--phase``
runs phase 1 and then the phases named, each with the fixtures it reads
(``fixtures.py``), among them what an earlier phase makes: phase 23 runs
16 first, 39 runs 30. The modules hold the phases by what they check:
``trace`` (2, 5, 8-15, 39), ``frames`` (3-4, 6-7, 16-25), ``presets``
(26-28), ``live`` (29-34, 41), ``native`` (35-37), ``capture`` (38),
``svgf`` (40), ``draw`` (42), ``u32`` (43); ``common`` the helpers they share,
``summary`` the kernels' record:

1. device: the card's name and power limit (nvidia-smi), and the time to
   build the ten kernel sources with nvcc for sm_90a (all started
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
   and the CTAs that fit an SM;
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
   plain version timed with CUDA events in turns, the bound from K2's own
   count of the pairs it tested, and its split by phase, lane use and
   CTAs an SM as in phase 2; F4: one visibility trace without the proxy pre-pass and with it, in
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
   path); K8 against K3 there; K8 and K3 timed in turns, the bound of
   every pair's operations and
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
20. the court at 1080p: 6 PT, 6 ReSTIR and 6 MCPG frames; every frame
    launches one alpha walk a ``trace_nearest`` call (its alpha loop), K1
    for each other ``intersect`` call (none) and K2 on ReSTIR's
    visibility, the loops timed (CUDA events and the host clock around
    each); one more frame's synchronizing calls read
    (``set_sync_debug_mode("warn")``): none in the alpha loop; 64×36 CPU
    against card;
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
26. presets and certification, every frame through
    ``renderer.compile_frame`` (one CUDA graph a run): ``run_preset`` for
    config1 and config6 at their 640x360 and config3 at 1080p, each for
    its preset's frames, captured and then eager (``frame_core`` a frame),
    every frame's ldr and hdr bit for bit, each compiled frame captured and
    ``frame_core`` run only in its warm-up and capture; the launches in
    the graph (config1 and config6 3 K1 a frame, config3 2 K1 + 1 K2;
    those of WARMUP_STEPS + 1 frames: a replay counts none) and the eager
    run's; ms/frame and the device's busy share of each;
    ``certify_presets`` of config1 and config6 at their named 640x360
    with certify's default budgets (64 frames, 4 truth runs of 256) and
    the equal-time columns, captured: config1's ratio exactly 1,
    config6's (the guiding-bound preset) below 1, every relMSE finite,
    each convergence series lower at 64 frames than at 1; then config1,
    config6 and config3 (its steady skip restarting the graph's static
    accumulators in place) at small budgets captured against eager, each
    relMSE equal to the bit, with each side's ms/frame;
27. the frame graph at 1080p: res/pt_graph.json on city against
    ``frame_core`` (6 frames, 5 K1 a frame, the tonemap output within
    tests/test_graph.py's 1e-5); ``flagship_graph_config()`` on the fogged
    court with config5's render setup (MCPG + ``VolumeConfig(volume_spp=
    1)``, 2 spp, denoise, still camera) against ``frame_core`` (9
    frames): the same launches (4 alpha walks) and the same synchronizing
    calls a frame (none in the alpha loop), and in the default mode the
    HUD and add
    outputs and both SVGF histories bit for bit (the MCPG replay's scan
    repeats itself since F7's repair); the
    flagship on city (MCPG, denoise) with a steady frame under
    ``set_sync_debug_mode("error")``; each path's ms/frame beside
    ``frame_core``'s;
28. debug views: the 9 MCPG views on phase 16's 1080p city state and the 5
    ReSTIR views on phase 6's, finite, (1080, 1920, 3), with ms a view;
    64x36 states made on the CPU and moved to the card: view 3 and its
    cell keys bit for bit, the others within rtol 1e-5; the tracer on a
    captured 1080p MCPG frame: bit-equal recorded and not, every stage
    recorded, the lead and the top-level stages tiling the replay;
29. F7: two ``frame_core`` runs of 6 city MCPG frames from one state are
    bit-equal in the default mode (the guiding table, the light cache,
    the images), beside two runs with the parent's ``torch.cumsum`` in
    the replay's segment sums; the parent's scan against the repair
    (``ops/segments.py::scan_rows``), frames in turns (parent, change,
    change, parent), on city MCPG and the fogged court with the volume
    pass: the repair's cost a frame;
30. the live dungeon at full width: the game host library built with g++
    from native/game (seconds), ``make_bigmap()`` at its defaults (grid
    8, 32 monsters, dynamic capacity 4,096), then the live loop
    captured against eager (``live_pair``): 14 moving frames
    (``step_dynamic``) recorded once and fed to two ``build_accel_live``
    copies, one refreshed and rendered eagerly (``render_frame`` MCPG at
    1080p, 2 spp, mpl 3, the entities' features forced on), one
    refreshed and rendered through ``compile_frame``: 10 frames' state and
    outputs bit for bit, every refresh of the captured copy with no host
    read and every derived table (padded bounds, walk boxes) kept in its
    storage and equal to a fresh one; then 4 frames whose refresh leaves
    the derived tables as they were (the stale-cache mutant), which must
    differ from eager; step, refresh and render ms (eager and captured),
    busy shares, the capture, the alpha walks (K3's, one a trace: 3) in
    the graph and in an eager frame, an eager frame with no host read, the
    bytes the
    refresh copies and its split (numpy rows, the whole refresh, the
    in-place rewrite of the derived tables), peak bytes; finite outputs,
    entities drawn;
31. the refresh against fresh tables on the card, after those moving
    steps: K3 and its any-hit form on the dungeon's refreshed tables
    bit-equal to their plain versions on 65,536-ray subsets of the frame's
    primary and bounce rays and on rays aimed at the monsters; every
    table's packed rows, padded bounds and walk boxes equal to a fresh
    computation; the hits of a from-scratch ``build_accel`` of the same
    frame's full scene (hit/miss, t); the same on the live arena for K1
    and K2, after its live loop captured against eager (``live_pair``, 10
    moving frames bit for bit) with MCPG (alpha walks, K1's) and ReSTIR
    (alpha walks and K2) at 1080p; a refresh that leaves the packed rows as they were (the
    mutant) fails the K3 check;
32. the live dungeon at grid 3, 4 monsters, after 3 steps, on the CPU and
    on the card: PT (mpl 2) and MCPG frames at 64x40, LDR within the
    slice test's tolerance;
33. ``run_preset`` for the orbit presets config2, config4 and config5 at
    their named sizes and frames, captured (each frame's accel written
    into the tables the frame was compiled on) against eager (the accel
    built for the frame), every frame's ldr and hdr bit for bit, with
    ms/frame, busy shares and launches as in phase 26;
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
    main path), the fogged court's MCPG + volume (4 alpha walks, one a
    trace), city ReSTIR (K2), denoised city MCPG, map
    MCPG (K3), config1's PT box at 640x360 (a small, launch-bound frame)
    and the flagship graph on the fogged court, each from an empty state
    for 9 frames (frame 0's call warms up, captures and
    replays; then 8 replays), every frame's state and outputs bit for bit
    against eager ``frame_core`` (or ``Graph.run``) from the same state,
    with eager and captured ms/frame (host clock, synced a frame), the
    capture's seconds, the graph's pool bytes, the device's busy share
    of each (torch.profiler, over at least 250 ms of frames) and the K1/K2/K3 launches in
    the graph; then what one round of the round loop (the list walker's
    route) costs once every ray is dead, beside the alpha walk on the same
    rays. ``render_sequence`` runs the captured frame on the card too, so
    the launch counts around it (phases 7 and 19) are the capture's: its
    warm-up frames and the capture itself;
39. the alpha walk (run after phase 31, on its live dungeon): both
    instances (K1's walk, K3's walk) bit for bit in (t, tri, u, v) against
    ``woop.woop_alpha_reference`` (on 65,536-ray slices) and against
    trace_nearest's round loop run eagerly over K1 or K3 (on every ray):
    the grate soup with a dead warp and padding; seven planes that reject
    every hit (every ray unhit, every warp walking 5 rounds); the court's
    1080p primary rays and one bounce population; the live dungeon's
    refreshed tables (its frame's primary and bounce rays and rays aimed at
    the monsters); each instance timed on the court and the dungeon in
    turns against the round loop, eager and on the device (all rounds),
    by CUDA events, with its bound (the pairs its lanes tested over all
    rounds, 42 operations each, or the bytes) and the rounds its warps
    walked;
40. the SVGF kernels (csrc/svgf.cu, ``post.svgf.svgf_temporal`` and
    ``svgf_atrous``) bit for bit against svgf's torch path on the card
    (``temporal_reference``, ``atrous_iteration_reference``): 5 frames of
    seeded 1080p inputs (the first with every history invalid, motion
    vectors off-screen, NaN and inf, normal and depth edges; each state
    leaf, the temporal records and each pass's), the same at 37x53 (step
    16 past both borders), halo-padded row slabs as ``svgf_sharded``
    passes them, and a captured city ReSTIR frame with denoise (6 launches
    recorded into the graph; 6 replays, every state leaf and output
    against eager ``frame_core`` with the torch SVGF); then each kernel
    timed alone by CUDA events against its bound (bytes / 3.35 TB/s) and
    the torch path, and the whole SVGF;
41. SSMM on the live dungeon at 1080p with config4's settings (1 spp,
    ``SSMMConfig()``, the denoise chain):
    its live loop captured against eager over 10 moving frames, bit for
    bit, with one K3 alpha walk for the gbuffer and one for the bounce in
    the graph; the port's tracer on the captured frame: recorded frames
    bit-equal to unrecorded ones, the lead and top-level stages tiling the
    replay and SSMM's five stage spans tiling ``ssmm`` within 1%, the
    counters of a frame equal to an eager ``render_ssmm``'s on the same
    inputs;
42. MCPG's draw kernel (csrc/mcpg_draw.cu, ``render.mcpg.draw.draw_states``)
    bit for bit against the torch loop on the card
    (``draw_states_reference``): the 1080p × 2 spp surface population and
    the 1080p volume population on the production-size table (the rows
    laid out to meet hash matches and misses, tombstones, dead lanes and
    the hemisphere test; lanes at inf and NaN), 37x53 inputs under the
    production settings, with no mixed slot and with grid_tile_bits 2;
    the benchmark's captured mcpg_default live dungeon frame against 6
    eager frames on the torch loop, every state leaf and output, and the
    4 launches its graph records; then the kernel alone by CUDA events
    against its bytes floor and the torch loop. The torch loop's u32
    chains run on their int64 references here (``u32.int64_chains``);
43. the u32 chains (csrc/u32_chains.cu: ``ops.rng.seed_pixel``,
    ``ops.rng.uniforms``, ``render.mcpg.grids.cell``,
    ``render.mcpg.light_cache.lookup``) bit for bit against their int64
    references (``*_reference``) on the card: every entry point and form
    (per-lane, strided-column, device-scalar and host-scalar seed
    operands; 1-5 draws; the adaptive cell with its target level computed
    or given, the static cell, the light cache's cell; the lookup with
    and without dead lanes or a given level) on the 1080p × 2 spp and
    1080p populations and 37x53 inputs, production_config()'s grids and a
    light-cache table of its size whose rows meet 70% of the lanes, both
    slot layouts (grid_tile_bits 0 and 2), lanes at inf and NaN; the
    benchmark's captured mcpg_default live dungeon frame against 6 eager
    frames with every chain on its int64 reference, every state leaf and
    output, and each chain's launches its graph records; then each entry
    point alone on 4,147,200 lanes by CUDA events against its bytes floor
    and its reference.

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
with every launch count set to 0 just before it and read just after. The
run's seconds, each phase's among them, are printed before the kernels'
line. After a whole run the line before the last is the kernels' JSON
record (``summary.py``: each kernel's launches by path and its bound,
the larger of the bytes it must move over 3.35 TB/s and its FP32
operations over the card's issue rate for them, from the H100 SXM's
data-sheet rates); the last line is {"ok": true, "device": {...}}.
Any failure raises before it. Without a CUDA device the run fails at
once and prints no result.
"""
