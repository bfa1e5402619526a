// K1 on Hopper: nearest front-facing hit of each ray against a Woop
// unit-triangle table of up to 65,536 triangles (the routing threshold; the
// kernel itself takes any size), clusters visited in index order.
//
// Replaces the TPU kernel merian_quake_tpu/accel/woop.py::_kernel_resident
// (with its nearest-hit epilogue _intersect_tile, general form). It keeps
// the kernel's contract, not its TPU schedule:
//   in:  rays f32[8, n_pad] rows (o.xyz, d.xyz, t_min, t_max);
//        the table's rows packed, f32[3T, 4] (columns 0-3 of woop_w f32[3T,
//        8], whose columns 4-7 are zero): per 64-triangle cluster c the rows
//        [c*192, c*192+192) = 64 "row 0" maps, 64 "row 1", 64 "row 2", each
//        [A | b];
//        boxes f32[nn + ns + nc, 8]: the boxes of nodes of kNode consecutive
//        clusters, of sub-nodes of kSub, then the padded cluster AABBs
//        (csrc/woop_walk.cuh).
//   out: best t f32[n_pad] (3e38 on a miss), tri i32[n_pad] (-1 on a miss).
// A triangle is hit when, with (u0,v0,z0) = M·o + b and (du,dv,dz) = M·d,
// dz > 0 (front-facing), U = u0·dz - z0·du >= 0, V = v0·dz - z0·dv >= 0,
// U + V <= dz and t_min·dz < -z0 <= t_max·dz; then t = -z0 / dz. The
// test is division-free and runs in full FP32 on the CUDA cores, not on
// tensor cores: TF32 would bring back the reduced-precision error the TPU
// reference had to pad around. Every multiply and add is rounded on its
// own (__fmul_rn/__fadd_rn: no FMA contraction), in the order of the
// plain PyTorch version, so the two agree bit for bit. The Woop test is
// not watertight across a shared edge, and with FMA contraction the
// kernel and the plain version disagreed on whether a ray grazing an edge
// hits: measured on an H100 at 1080p on city, 2 of 2,073,600 primary rays
// split, one of them a crack (t 476.9 vs 577.1). Exact ties are broken
// toward the lowest triangle index, so `tri` is deterministic and equal
// to the dense sweep's choice.
//
// What bounds it on this card: arithmetic. Each (ray, triangle) pair
// costs 42 FP32 multiplies and adds (each its own instruction) plus
// compares; the packed table (48 B a triangle, 0.8 MB at 16,640 triangles)
// lives in L2. The first design (one CTA of 128 rays walking all nc
// clusters: a gate and a CTA barrier a cluster, a second barrier and a
// plain staged copy a visited one) ran its pair loops at that bound but
// spent 52-64% of its cycles on the 260 gates and barriers a block, and on
// sorted bounce rays only 67% of the lanes in a pair loop had a ray that
// reached the tile (measured on an H100, city at 1080p).
//
// What this design (csrc/woop_walk.cuh, the body it shares with K3) does
// about it:
//   - two node levels: a ray gates ceil(nc / 64) node boxes, the 8
//     sub-node boxes of a node its warp reaches and the 8 members of a
//     reached sub-node (city: 5 + 8 a reached node + 8 a reached sub-node,
//     not 260), in fixed index order (no list, no sort: near-to-far order
//     barely changes the pairs tested on a table this small);
//   - the warp, not the CTA, walks: each warp of 32 rays has its own
//     2-slot tile ring, so no CTA barrier is left. Before: 1 CTA barrier a
//     skipped cluster, 2 a visited one. Now: none; a skipped node or
//     cluster costs one warp vote, a visited tile two votes, one
//     __syncwarp() and one mbarrier wait;
//   - a tile few lanes reach (1..24) is tested triangle per lane on those
//     rays alone: 2 warp iterations a ray instead of 64 a visit;
//   - a tile arrives by one bulk copy (cp.async.bulk, 3,072 contiguous
//     bytes of the packed table) issued one tile ahead, completion on an
//     mbarrier, overlapping the gates and the previous tile's pair tests.
// The gate uses a small relative + absolute slack on the limit (and the
// wrapper pads the AABBs) so that rounding in the slab test can only
// visit more, never skip a cluster holding the nearest hit.

#include "woop_walk.cuh"

using mq::kNode;
using mq::kSub;

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() (0 = launched).
// `block` must be 128, `boxes` packed for the node sizes below, `rows4`
// 16-byte aligned. `prof` (u64[10 * n_pad / 128], zeroed by the caller, or
// null) gets the profile of csrc/woop_walk.cuh; null launches the kernel
// without it.
extern "C" int mq_woop_nearest(const float* rays, int64_t n_pad, const float* rows4,
                               const float* boxes, int nc, int block, float* out_t, int* out_tri,
                               unsigned long long* prof, void* stream) {
  return mq::launch_walk<kNode, kSub, mq::kIndexOrder, false>(
      rays, n_pad, rows4, boxes, nc, block, nullptr, out_t, out_tri, nullptr, prof, stream);
}

// clusters a node and clusters a sub-node that `boxes` must be packed for
extern "C" int mq_woop_nearest_node() { return kNode; }
extern "C" int mq_woop_nearest_sub() { return kSub; }

// CTAs of the frame instance that fit one SM
extern "C" int mq_woop_nearest_ctas_per_sm(int nc) {
  return mq::walk_ctas_per_sm<kNode, kSub, mq::kIndexOrder, false>(nc);
}
