// K1 on Hopper: nearest front-facing hit of each ray against the Woop
// unit-triangle table, with a per-ray cluster AABB gate.
//
// Replaces the TPU kernel merian_quake_tpu/accel/woop.py::_kernel_resident
// (with its nearest-hit epilogue _intersect_tile, general form). It keeps
// the kernel's contract, not its TPU schedule:
//   in:  rays f32[8, n_pad] rows (o.xyz, d.xyz, t_min, t_max);
//        woop_w f32[3T, 8], per 64-triangle cluster c the rows
//        [c*192, c*192+192) = 64 "row 0" maps, 64 "row 1", 64 "row 2",
//        each [A | b] in columns 0-3 (columns 4-7 are zero);
//        cluster AABBs lo/hi f32[nc, 3].
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
// compares; the table (96 B/triangle, 1.6 MB at 16,640 triangles) lives
// in L2, so memory traffic is small next to the
// pairs tested. The design therefore spends its effort on testing fewer
// pairs, simply:
//   - one CTA per block of consecutive rays, one thread per ray (bounce
//     rays arrive sorted by direction and origin, so a block's rays are
//     a tight bundle);
//   - the block walks all clusters; before each, a per-ray slab gate
//     against the cluster AABB with limit min(best_t, t_max); the CTA
//     skips the cluster when no ray reaches it;
//   - a visited cluster's 64 x 3 rows (3 KB) are staged in shared
//     memory once and read by every thread as broadcasts.
// The gate uses a small relative + absolute slack on the limit (and the
// wrapper pads the AABBs) so that rounding in the slab test can only
// visit more, never skip a cluster holding the nearest hit. A per-block
// near-to-far cluster order with a horizon stop (the TPU kernel's cull,
// computed in torch) made this kernel 1.6x faster but cost as much in
// torch as it saved, and the frame was faster without it (measured on an
// H100 at 1080p on city). Warp-level traversal, a deeper hierarchy and
// persistent CTAs are left for later work.

#include "woop_common.cuh"

namespace {

constexpr int kMaxBlock = 256;

// the gate, its slack, the pair test and the safe inverse (woop_common.cuh)
using mq::gate;
using mq::kBig;
using mq::kCluster;
using mq::load_box;
using mq::nearest_pair;
using mq::safe_inv;
using mq::with_slack;

// kCount: add up the (ray, triangle) pairs tested into counts[CTA]; the
// frame path launches the kCount = false instance, which has no counter.
template <bool kCount>
__global__ void __launch_bounds__(kMaxBlock)
woop_nearest_kernel(const float* __restrict__ rays, int64_t n_pad,
                    const float4* __restrict__ w4,
                    const float* __restrict__ lo,
                    const float* __restrict__ hi, int nc,
                    float* __restrict__ out_t, int* __restrict__ out_tri,
                    unsigned long long* __restrict__ counts) {
  __shared__ float4 tile[3 * kCluster];
  unsigned long long pairs = 0;  // kCount only

  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float4 o = make_float4(rays[i], rays[n_pad + i], rays[2 * n_pad + i], 0.0f);
  const float dx = rays[3 * n_pad + i], dy = rays[4 * n_pad + i],
              dz = rays[5 * n_pad + i];
  const float t_min = rays[6 * n_pad + i], t_max = rays[7 * n_pad + i];
  const float4 inv = make_float4(safe_inv(dx), safe_inv(dy), safe_inv(dz), 0.0f);

  float best = kBig;
  int best_tri = -1;
  for (int c = 0; c < nc; ++c) {
    float tn;
    const bool reach = gate(load_box(lo, hi, c), o, inv, with_slack(fminf(best, t_max)), &tn);
    // this barrier also keeps the previous tile alive until all are done
    if (!__syncthreads_or(reach)) continue;

    for (int k = threadIdx.x; k < 3 * kCluster; k += blockDim.x) {
      tile[k] = w4[((int64_t)c * 3 * kCluster + k) * 2];
    }
    __syncthreads();

    if (reach) {
      if (kCount) pairs += kCluster;
#pragma unroll 4
      for (int k = 0; k < kCluster; ++k) {
        float t;
        if (nearest_pair(tile[k], tile[kCluster + k], tile[2 * kCluster + k], o.x, o.y, o.z,
                         dx, dy, dz, t_min, t_max, &t)) {
          const int tri = c * kCluster + k;
          if (t < best || (t == best && tri < best_tri)) {
            best = t;
            best_tri = tri;
          }
        }
      }
    }
  }
  out_t[i] = best;
  out_tri[i] = best_tri;
  if (kCount && pairs) atomicAdd(counts + blockIdx.x, pairs);
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() (0 = launched).
// `counts` (u64[n_pad / block], zeroed by the caller, or null) gets per
// CTA the (ray, triangle) pairs tested; null launches the kernel without
// the counter.
extern "C" int mq_woop_nearest(const float* rays, int64_t n_pad,
                               const float* woop_w, const float* lo,
                               const float* hi, int nc, int block,
                               float* out_t, int* out_tri,
                               unsigned long long* counts, void* stream) {
  if (block <= 0 || block > kMaxBlock || block % 32 != 0 ||
      n_pad % block != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t nb = n_pad / block;
  if (nb > 0) {
    const float4* w4 = reinterpret_cast<const float4*>(woop_w);
    if (counts != nullptr) {
      woop_nearest_kernel<true><<<(unsigned)nb, block, 0, (cudaStream_t)stream>>>(
          rays, n_pad, w4, lo, hi, nc, out_t, out_tri, counts);
    } else {
      woop_nearest_kernel<false><<<(unsigned)nb, block, 0, (cudaStream_t)stream>>>(
          rays, n_pad, w4, lo, hi, nc, out_t, out_tri, nullptr);
    }
  }
  return (int)cudaGetLastError();
}
