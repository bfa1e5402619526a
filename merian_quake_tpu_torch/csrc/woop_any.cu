// K2 on Hopper: is each ray occluded? Any front-facing hit with t in
// [t_min, t_max] against a Woop unit-triangle table of up to 65,536
// triangles (the routing threshold; the kernel itself takes any size),
// with an optional warm start.
//
// Replaces the TPU kernel merian_quake_tpu/accel/woop.py::_kernel_resident
// with its any-hit epilogue (_intersect_tile, anyhit=True, :786-807),
// which intersect_woop_any (:1783) launches on the proxy table and then
// on the shadow table. It keeps the kernel's contract, not its TPU
// schedule:
//   in:  rays f32[8, n_pad] rows (o.xyz, d.xyz, t_min, t_max);
//        the table's rows packed, f32[3T, 4] (columns 0-3 of woop_w; K1's
//        layout, csrc/woop_nearest.cu);
//        boxes f32[nn + ns + nc, 8]: the boxes of nodes of kNode consecutive
//        clusters, of sub-nodes of kSub, then the padded cluster AABBs
//        (csrc/woop_walk.cuh);
//        occ_in u8[n_pad] or null: rays already known to be occluded.
//   out: occluded u8[n_pad] (0 or 1).
// With (u0,v0,z0) = M·o + b, (du,dv,dz) = M·d and z0n = -z0, a pair hits
// when every term is >= 0:
//   U = u0·dz - z0·du,  V = v0·dz - z0·dv,  (dz - U) - V,  dz - 1e-12,
//   z0n - t_min·dz,  t_max·dz - z0n.
// This is the TPU epilogue term by term (mq::any_pair, woop_common.cuh;
// not K1's test: K1 has U + V <= dz, dz > 1e-12 and z0n > t_min·dz). The
// TPU writes it as a min-tree and a >= 0 on the result; here it is a
// conjunction of >= compares, so a NaN term rejects its pair as the
// min-tree does. Every multiply and add is rounded on its own, in the
// order of the plain PyTorch version, intersect_woop_any_reference. The
// result is an OR over pairs, so it does not depend on the order of
// visits: K2 equals the plain version on every ray.
//
// What bounds it on this card: FP32 arithmetic of the pairs tested (46
// rounded multiplies and adds a pair, each its own instruction; the
// packed table lives in L2). The first design (one CTA of 128 rays, one
// thread a ray, walking all nc clusters in index order: a gate and a
// CTA-wide barrier a cluster, a second barrier and a plain staged copy a
// visited one; a CTA left the loop once all its rays were occluded) took
// 3.742 ms for city's shade rays (proxy pre-pass + shadow sweep) against a
// bound of 1.199 (NVIDIA H100 80GB HBM3, 700 W): its 260 gates and up to
// 520 CTA barriers a block held it back, since the walk below tests the
// same 8.7e8 pairs on those rays in 2.28 ms.
//
// What this design does about it: it is the any-hit instance of the walk
// of csrc/woop_walk.cuh, the body of K1 and K3 too (see that header):
//   - a warp of 32 rays walks alone, through ceil(nc / 64) node boxes, the
//     8 sub-node boxes of a node it reaches and the 8 member clusters of a
//     reached sub-node, in index order (kIndexOrder, K1's order); no CTA
//     barrier is left: a skipped box costs one warp vote;
//   - tiles arrive by one bulk copy (cp.async.bulk, 3,072 contiguous bytes
//     of the packed rows) into the warp's 2-slot ring, one tile ahead,
//     completion on an mbarrier;
//   - a tile that 1..kCompactMax lanes reach is tested triangle per lane on
//     those rays alone, a vote a ray; a denser one ray per lane, each lane
//     leaving the tile at its first hit;
//   - an occluded lane's limit is -inf: it reaches no box, takes no part
//     in any vote, and once all 32 lanes are occluded every gate fails,
//     so the warp ends its walk; a warp whose rays are all occluded on
//     entry (the warm start) or dead walks nothing.
// The order was chosen by measurement (NVIDIA H100 80GB HBM3, 700 W,
// scripts/ab_trace_kernels.py, in turns): node order against the
// near-to-far node list with the horizon exit (kNodeList, K3's any-hit
// form) on city's 2,073,600 shade rays took 1.720 against 1.727 ms on the
// shadow table, 0.539 against 0.543 on the proxy table, and 0.201 against
// 0.207 on the court's (PERF.md, section 6): the list buys nothing on a table
// of 5 nodes. On city's shadow sweep the walk takes 1.72 ms where the
// first design took 3.08 (bound 0.90, lane use 0.98); on the court's
// one-cluster table it is slower, 0.20 against 0.17 ms (three levels of
// gates for one tile, where the first design gated one cluster).

#include "woop_walk.cuh"

using mq::kNode;
using mq::kSub;

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() (0 = launched).
// `block` must be 128, `boxes` packed for the node sizes below, `rows4`
// 16-byte aligned; `occ_in` may be null (no warm start). `prof`
// (u64[10 * n_pad / 128], zeroed by the caller, or null) gets the profile of
// csrc/woop_walk.cuh; null launches the kernel without it.
extern "C" int mq_woop_any(const float* rays, int64_t n_pad, const float* rows4,
                           const float* boxes, int nc, int block, const uint8_t* occ_in,
                           uint8_t* out, unsigned long long* prof, void* stream) {
  return mq::launch_walk<kNode, kSub, mq::kIndexOrder, true>(
      rays, n_pad, rows4, boxes, nc, block, occ_in, nullptr, nullptr, out, prof, stream);
}

// clusters a node and clusters a sub-node that `boxes` must be packed for
extern "C" int mq_woop_any_node() { return kNode; }
extern "C" int mq_woop_any_sub() { return kSub; }

// CTAs of the frame instance that fit one SM
extern "C" int mq_woop_any_ctas_per_sm(int nc) {
  return mq::walk_ctas_per_sm<kNode, kSub, mq::kIndexOrder, true>(nc);
}
