// K6 and K7 on Hopper: the list walker. Each warp of 32 rays walks the
// near-to-far visit list of its 128-ray block (from K5, csrc/woop_keys.cu)
// with an exact horizon exit of its own, over clusters (P = 1) or over nodes
// of P consecutive clusters (P > 1), and tests a tile that few of its lanes
// reach on those lanes alone (K7). It is the block-list instance
// (kBlockList) of the walk of csrc/woop_walk.cuh, the body of K1, K2 and K3.
//
// Replaces, in merian_quake_tpu/accel/woop.py:
//   - P = 1: the resident kernel _kernel_resident (:289) walking the list of
//     the target-key schedule (intersect_woop_packed with target_cull,
//     :1234-1257) -- K1's result fed by K5;
//   - P > 1: _kernel_resident_nodes (:488), K1's (or K2's) result through
//     one level of nodes: the list is at node level, a node gate runs once a
//     node, then the per-ray gate per member cluster (K6);
//   - compact > 0: _intersect_tile_compact (:627), the visit of a tile that
//     only a few rays reach, testing only those (K7), nearest hit only.
// It keeps their contract, not their TPU schedule:
//   in:  rays f32[8, n_pad] (o.xyz, d.xyz, t_min, t_max); rows4 f32[3T, 4],
//        the table's packed rows (woop.pack_table; K1's layout,
//        csrc/woop_nearest.cu); boxes f32[nn + ns + nc, 8],
//        woop.walk_boxes of the padded cluster bounds for P and
//        mq_woop_list_sub(P): its node level is woop.node_bounds of those
//        bounds, the boxes K5's list was built on; the list te_s f32[nb, m]
//        (ascending, +inf where no ray of the block reaches the box) and
//        order i32[nb, m] (box ids) of each block, nb = n_pad / 128,
//        m = ceil(nc / P); any-hit: occ_in u8[n_pad] or null.
//   out: nearest: t f32[n_pad] (3e38 on a miss), tri i32[n_pad] (-1);
//        any-hit: occluded u8[n_pad].
// The pair tests are K1's and K2's operation for operation
// (woop_common.cuh), with K1's lowest-index tie rule, so the walker's
// nearest hit is bit-equal to intersect_woop_reference and its occlusion
// equal on every ray to intersect_woop_any_reference, in any mode.
//
// The walk of a warp (woop_walk.cuh has the steps it shares with K1-K3):
// lane l loads entry j0 + l of its block's list, 32 at a time; kBatch
// entries a step, the warp reads its horizon (one reduction of the lanes'
// limits), keeps the entries within it (a ballot: the list ascends), gates
// the kept ones' boxes with one reading of the limits and votes. A reached
// entry at P = 1 is a cluster, fetched at once; at P > 1 a node, whose
// members (P <= 32) or sub-nodes of 8 (P = 64, 128) are gated next, in
// batches of kBatch, a vote each. Tiles come by bulk copy through the warp's
// 2-slot ring, one tile ahead.
//
// The exit is exact, lane by lane. Take a lane and a box its gate passes at
// some point of the walk. The gate is K5's slab (woop_common.cuh, every
// operation rounded explicitly, NaN kept) at the lane's current limit,
// list_slack(min(best, t_max)) (nearest; any-hit list_slack(t_max), -inf
// once occluded), which is never above list_slack(t_max), the limit K5's
// list was built with. The slab's entry tn does not depend on the limit and
// its exit side only grows with it, so the lane passes K5's slab of that box
// too, and the box's listed entry, the least over the block's 128 rays, is
// at most tn <= the lane's limit <= the warp's horizon. So no entry beyond
// the horizon, nor any later one, holds a box a lane of the warp could pass.
// A node box is the min/max of its padded members (no rounding): a lane
// whose gate passes a member passes its node too. The gate reads the node
// level of woop.walk_boxes, woop.node_bounds of the same padded bounds, so
// list and gate see the same boxes (tests/test_torch_schedule.py holds the
// two equal for every P that divides 128). Empty boxes (flag 1, lo > hi) are
// never listed and never gated in. Limits lag by one tile (the ring): the
// horizon is larger, never smaller, than the true one.
//
// K7: a tile that 1..c lanes of the warp reach is tested triangle per lane
// (woop_walk.cuh step 4: two warp reductions a reaching ray give its (t,
// index) winner, no barrier). The JAX package counts the reaching rays of a
// 128-ray block, a warp has 32 lanes, so `compact` becomes c = ceil(compact
// / kCompactShare) lanes, at most 32: the same share of the rays (compact
// 32 -> 8 lanes). compact = 0 (K6 alone) compacts no visit. The mapping
// changes no result.
//
// Instances: P, its sub-node size and c are run-time values, so the library
// holds four instances (nearest and any-hit, each with and without the
// profile) instead of 8 node sizes x 3 modes x 2. P enters only the index
// arithmetic of the node and sub-node gates, never a pair loop, and one
// instance of the walk takes ptxas a few seconds: 48 would multiply the
// build that chip_smoke.py pays at first use for no gain in the loops.
//
// What bounds it on this card: FP32 arithmetic of the pairs tested (42
// rounded multiplies and adds a nearest pair, 46 an any-hit pair; the
// packed table, 48 B a triangle, stays in L2), as for K1. The first design
// walked the list with the whole CTA of 128 rays in lockstep: a CTA barrier
// before every cluster gate and after every fetch, three more in a
// compacted visit, one after every horizon update; tiles copied by all 128
// threads from every other float4 of the f32[3T, 8] rows, nothing
// overlapped; gates one box at a time; a per-thread visit (64 iterations)
// whenever more than `compact` of the 128 rays reached the tile; a horizon
// taken over 128 rays. This design: no CTA barrier (a warp vote a skipped
// entry, two votes, a __syncwarp() and an mbarrier wait a visited tile), one
// bulk copy of 3,072 contiguous bytes a tile, overlapped with the next
// gates and the previous tile's tests, gates in batches of kBatch, the
// compacted visit within a warp, and a horizon over the warp's own 32 rays.

#include "woop_walk.cuh"

namespace {

using namespace mq;

// clusters a sub-node of a node of P clusters: no sub-node level up to 32
// (a node's member votes fill a word), sub-nodes of kListSub above
constexpr int kListSub = 8;
// rays of a 128-ray block that one lane of a 32-lane warp stands for (the
// JAX package's `compact` counts a block's rays): kBlock / 32
constexpr int kCompactShare = 4;
static_assert(kCompactShare * 32 == kBlock, "a lane stands for its share of the block");

int list_sub(int P) { return P <= 32 ? P : kListSub; }

// the reaching lanes up to which a warp compacts a visit, for `compact`
// reaching rays of a block
int compact_lanes(int compact) {
  const int lanes = (compact + kCompactShare - 1) / kCompactShare;
  return compact <= 0 ? 0 : (lanes < 32 ? lanes : 32);
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError() (0 =
// launched). `anyhit` 1 fills `out_occ` (warm-started by `occ_in`, which
// may be null), 0 fills `out_t` and `out_tri`; `compact` > 0 (nearest only)
// compacts the visits of tiles that compact_lanes(compact) lanes or fewer
// reach; P = 1 walks clusters, P > 1 nodes of P clusters (P <= 32, or a
// multiple of 8 up to 256). `boxes` must be packed for P and
// mq_woop_list_sub(P), `rows4` 16-byte aligned. `prof` (u64[10 * n_pad /
// 128], zeroed by the caller, or null) gets the profile of csrc/woop_walk.cuh;
// null launches the instance without it.
extern "C" int mq_woop_list(const float* rays, int64_t n_pad, const float* rows4,
                            const float* boxes, int nc, const float* te_s, const int* order, int m,
                            int P, int compact, int anyhit, const uint8_t* occ_in, float* out_t,
                            int* out_tri, uint8_t* out_occ, unsigned long long* prof,
                            void* stream) {
  if (n_pad <= 0 || n_pad % kBlock != 0 || nc <= 0 || P < 1 || P % list_sub(P) != 0 ||
      P / list_sub(P) > 32 || m != (nc + P - 1) / P || compact < 0 || (anyhit && compact > 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const BlockList bl{te_s, order, m, P, list_sub(P), compact_lanes(compact)};
  if (anyhit) {
    return launch_walk<1, 1, kBlockList, true>(rays, n_pad, rows4, boxes, nc, kBlock, occ_in,
                                               nullptr, nullptr, out_occ, prof, stream, bl);
  }
  return launch_walk<1, 1, kBlockList, false>(rays, n_pad, rows4, boxes, nc, kBlock, nullptr,
                                              out_t, out_tri, nullptr, prof, stream, bl);
}

// clusters a sub-node that `boxes` must be packed for at nodes of P clusters
// (P when there is no sub-node level)
extern "C" int mq_woop_list_sub(int P) { return P >= 1 ? list_sub(P) : 0; }

// the reaching lanes up to which a warp compacts a visit under `compact`
extern "C" int mq_woop_list_compact_lanes(int compact) { return compact_lanes(compact); }

// CTAs of the frame instance (nearest hit) that fit one SM
extern "C" int mq_woop_list_ctas_per_sm(int nc) {
  return walk_ctas_per_sm<1, 1, kBlockList, false>(nc);
}
