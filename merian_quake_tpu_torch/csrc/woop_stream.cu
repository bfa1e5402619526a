// K3 on Hopper: the nearest front-facing hit (K1's result) or the
// any-hit occlusion (K2's result) of each ray against a Woop table of any
// size, each warp of rays walking its own near-to-far node list.
//
// Replaces the TPU kernel merian_quake_tpu/accel/woop.py::_kernel_stream
// (launched at :1359 for tables above RESIDENT_MAX_TRIS), which leaves the
// table in HBM, visits clusters in each block's near-to-far order, stops
// at the block's horizon and stages tiles through an 8-slot DMA ring. It
// keeps that kernel's contract and K1's and K2's exactly, not its TPU
// schedule:
//   in:  rays f32[8, n_pad] rows (o.xyz, d.xyz, t_min, t_max);
//        the table's rows packed, f32[3T, 4] (columns 0-3 of woop_w; K1's
//        layout, csrc/woop_nearest.cu);
//        boxes f32[nn + ns + nc, 8]: the boxes of nodes of kNode consecutive
//        clusters, of sub-nodes of kSub, then the padded cluster AABBs
//        (csrc/woop_walk.cuh), nc <= 16,384;
//        any-hit only: occ_in u8[n_pad] or null, rays already occluded.
//   out: nearest: t f32[n_pad] (3e38 on a miss), tri i32[n_pad] (-1);
//        any-hit: occluded u8[n_pad].
// The pair tests are K1's and K2's operation for operation: the
// division-free Woop test, every multiply and add rounded on its own
// (__fmul_rn/__fadd_rn, in the plain version's order), the lowest-index
// tie rule t < best || (t == best && tri < best_tri), and K2's any-hit
// conjunction of >= 0 compares (a NaN term rejects its pair). The
// nearest hit under that rule and the OR of the any-hit tests do not
// depend on the order of visits, so K3 is bit-equal to its plain versions
// (intersect_woop_reference, intersect_woop_any_reference) and to K1/K2.
//
// What bounds it on this card: FP32 arithmetic of the pairs tested (42
// rounded multiplies and adds a pair for the nearest hit, 46 for any-hit,
// at most 67 TFLOP/s and, without FMA, half that in issue rate) against
// the bytes (rays, results, and the packed table once: 48 B a triangle,
// 13.5 MB at 281,536 triangles, which stays in the 50 MB L2). The first
// design (one CTA of 128 rays: a 32-cluster node cull that every CTA
// rebuilt from the cluster boxes, a per-cluster union loop of 128 serial
// gates, a bitonic sort over a key array sized by the table, a 4-slot
// cp.async ring of half-used sectors, and a gate with a CTA barrier an
// entry plus two more a tested tile) ran its pair loops near that bound
// but spent 26-43% of its cycles on the list and up to 33% on the gates
// and barriers of visited entries, fitted 4 CTAs an SM on the map (49 KB
// of shared memory), and on sorted bounce rays had 55% of the lanes of a
// pair loop at work (measured on an H100, the map at 1080p).
//
// What this design (csrc/woop_walk.cuh, the body it shares with K1) does
// about it:
//   - the list is at node level and per warp: one slab a (ray, node) with
//     the ray per lane against boxes computed once per table, one warp
//     reduction a node for its least entry; no per-cluster union, no sort:
//     the walk takes the least key left (a scan of the few reached nodes).
//     Shared memory is the rings and 4 bytes a node and warp;
//   - the horizon exit compares a node's rounded-down entry with the warp's
//     largest current limit, refreshed once a node;
//   - inside a node the walk is K1's: sub-node and member gates, a warp
//     vote each, tiles by bulk copy one ahead through the warp's own 2-slot ring, a tile few
//     lanes reach tested triangle per lane. No CTA barrier is left. Before:
//     1 CTA barrier a skipped entry, 3 a tested tile. Now: one warp vote a
//     skipped node or cluster; two votes, one __syncwarp() and one mbarrier
//     wait a tested tile; one warp reduction a node for the horizon;
//   - any-hit: occluded rays stop testing (a lane leaves a tile at its
//     first hit) and stop raising the horizon; once every ray of the warp is
//     occluded the horizon is -inf and the walk stops.
// Measured and not adopted (PERF.md has the readings): a cull of groups of
// 8 nodes in front of the list, 6 CTAs of 80 registers an SM, an unroll
// of 8 in the pair loop, sub-nodes of 16. Later work: the gates that look
// for the next tile are a latency chain (loads, slab, vote) that takes a
// quarter of a warp's cycles while the pair loops run at the arithmetic
// bound; overlapping them with the pending tile's pair tests, or persistent
// CTAs that hand rays to idle warps, would go at that.

#include "woop_walk.cuh"

using mq::kNode;
using mq::kSub;

// Plain C entry points (bound with ctypes). Each launches on `stream`, does
// not synchronise, allocates nothing, and returns cudaGetLastError()
// (0 = launched). `block` must be 128, `boxes` packed for the node sizes
// below and nc at most 16,384; `rows4` must be 16-byte aligned. `prof`
// (u64[10 * n_pad / 128], zeroed by the caller, or null) gets the profile of
// csrc/woop_walk.cuh; null launches the kernel without it.
extern "C" int mq_woop_stream(const float* rays, int64_t n_pad, const float* rows4,
                              const float* boxes, int nc, int block, float* out_t, int* out_tri,
                              unsigned long long* prof, void* stream) {
  return mq::launch_walk<kNode, kSub, mq::kNodeList, false>(
      rays, n_pad, rows4, boxes, nc, block, nullptr, out_t, out_tri, nullptr, prof, stream);
}

// `occ_in` may be null (no warm start).
extern "C" int mq_woop_stream_any(const float* rays, int64_t n_pad, const float* rows4,
                                  const float* boxes, int nc, int block, const uint8_t* occ_in,
                                  uint8_t* out, unsigned long long* prof, void* stream) {
  return mq::launch_walk<kNode, kSub, mq::kNodeList, true>(
      rays, n_pad, rows4, boxes, nc, block, occ_in, nullptr, nullptr, out, prof, stream);
}

// clusters a node and clusters a sub-node that `boxes` must be packed for
extern "C" int mq_woop_stream_node() { return kNode; }
extern "C" int mq_woop_stream_sub() { return kSub; }

// CTAs of the frame instance (nearest hit) that fit one SM
extern "C" int mq_woop_stream_ctas_per_sm(int nc) {
  return mq::walk_ctas_per_sm<kNode, kSub, mq::kNodeList, false>(nc);
}
