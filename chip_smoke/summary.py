"""The kernels' JSON record of a whole run: each hand-written kernel with
its source, the TPU code it replaces, its launches by path, its largest
difference from its plain version, its times and bound, from the phases'
results."""
from __future__ import annotations

import json

from .common import H, SPP, SUBSET, W
from .draw import DRAW_REPLACES, DRAW_SOURCE
from .svgf import SVGF_REPLACES, SVGF_SOURCE
from .trace import ALPHA_WALKS

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
K3_POPS = ("primary", "bounce", "bounce_unsorted", "shadow")

ALPHA_SOURCE = "merian_quake_tpu_torch/csrc/woop_alpha.cu"
ALPHA_REPLACES = "merian_quake_tpu/accel/intersect.py:180-241"


def kernels_line(results: dict) -> str:
    """The record, from ``results``: each phase's return by its number."""
    spills = results[1]["spills"]
    k1 = results[2]
    max_abs, timings, k1_split, k1_ctas = (k1["max_abs"], k1["timings"], k1["split"],
                                           k1["ctas_per_sm"])
    n_full = W * H
    pt_city, k2, (restir_city, f4_city_frames), k3, k8 = (results[n] for n in (3, 5, 6, 8, 9))
    (map_paths, f4_map_frames), k45, walk = results[10], results[12], results[13]
    sched_paths, _, f4_sched_frames = results[14]
    (mcpg_city, mcpg_sched, mcpg_city_t), (mcpg_map, mcpg_map_t) = results[16], results[17]
    g1, g3 = results[18]
    (court_paths, court_stats), (volume_path, volume_stats, g_vol) = results[20], results[21]
    prod_path, prod_stats = results[22]
    denoise_path, restir_dn_path, denoise_stats = results[23]
    (court_dn_path, court_dn_stats), (ssmm_path, ssmm_court_path, ssmm_stats) = (results[24],
                                                                                 results[25])
    (preset_paths, preset_stats), (graph_paths, graph_stats) = results[26], results[27]
    debug_stats, f7_stats = results[28], results[29]
    (live_paths, live_stats), (arena_paths, refresh_stats) = results[30], results[31]
    alpha, live_cpu_stats, (orbit_paths, orbit_stats) = results[39], results[32], results[33]
    cli_stats, (native_paths, native_stats), (bsp_paths, bsp_stats) = (results[34], results[35],
                                                                       results[36])
    (shard_paths, shard_stats), (capture_paths, capture_stats) = results[37], results[38]
    svgf_stats, draw_stats = results[40], results[42]
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
    return json.dumps({"kernels": [{
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
        "orbit_presets": orbit_stats, "live_cpu_vs_card": live_cpu_stats,
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
    )] + [{
        # the alpha walk's two instances: K1's walk on the court (every trace
        # of its frames), K3's on the live dungeon's refreshed tables
        "name": name, "route": "cuda", "source": ALPHA_SOURCE, "replaces": ALPHA_REPLACES,
        "launches": total(name), "launches_by_path": by_path(name),
        "max_abs_err": alpha["max_abs_err"], **alpha[name], "library_ms": None,
        "spill_bytes": spills["woop_alpha"],
    } for name in ALPHA_WALKS] + [{
        "name": "svgf (temporal + 5 a-trous passes)", "route": "cuda", "source": SVGF_SOURCE,
        "replaces": SVGF_REPLACES, "launches_in_graph": svgf_stats["launches_in_graph"],
        "max_abs_err": svgf_stats["max_abs_err"], "ms": svgf_stats["ms"],
        "plain_ms": svgf_stats["plain_ms"], "bound_ms": svgf_stats["bound_ms"],
        "bound_by": svgf_stats["bound_by"], "library_ms": None, "pixels": W * H,
        "by_kernel": svgf_stats["by_kernel"], "leaves_compared": svgf_stats["leaves_compared"]}, {
        "name": "mcpg_draw", "route": "cuda", "source": DRAW_SOURCE, "replaces": DRAW_REPLACES,
        "launches_in_graph": draw_stats["launches_in_graph"],
        "max_abs_err": draw_stats["max_abs_err"], "ms": draw_stats["by_population"]["surface"]["ms"],
        "plain_ms": draw_stats["by_population"]["surface"]["plain_ms"],
        "bound_ms": draw_stats["by_population"]["surface"]["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "lanes": W * H * SPP, "by_population": draw_stats["by_population"],
        "leaves_compared": draw_stats["leaves_compared"]}]})
