// K2 on Hopper: is each ray occluded? Any front-facing hit with t in
// [t_min, t_max] against a Woop unit-triangle table, with a per-ray
// cluster AABB gate and an optional warm start.
//
// Replaces the TPU kernel merian_quake_tpu/accel/woop.py::_kernel_resident
// with its any-hit epilogue (_intersect_tile, anyhit=True, :786-807),
// which intersect_woop_any (:1783) launches on the proxy table and then
// on the shadow table. It keeps the kernel's contract, not its TPU
// schedule:
//   in:  rays f32[8, n_pad] rows (o.xyz, d.xyz, t_min, t_max);
//        w f32[3T, 8] laid out as K1's table (csrc/woop_nearest.cu): per
//        64-triangle cluster c the rows [c*192, c*192+192) = 64 "row 0"
//        maps, 64 "row 1", 64 "row 2", each [A | b] in columns 0-3;
//        cluster AABBs lo/hi f32[nc, 3];
//        occ_in u8[n_pad] or null: rays already known to be occluded.
//   out: occluded u8[n_pad] (0 or 1).
// With (u0,v0,z0) = M·o + b, (du,dv,dz) = M·d and z0n = -z0, a pair hits
// when every term is >= 0:
//   U = u0·dz - z0·du,  V = v0·dz - z0·dv,  (dz - U) - V,  dz - 1e-12,
//   z0n - t_min·dz,  t_max·dz - z0n.
// This is the TPU epilogue term by term (not K1's test: K1 has U + V <=
// dz, dz > 1e-12 and z0n > t_min·dz). The TPU writes it as a min-tree
// and a >= 0 on the result; here it is a conjunction of >= compares, so
// a NaN term rejects its pair as the min-tree does (fminf would drop the
// NaN and could accept it). Every multiply and add is rounded on its own
// (__fmul_rn/__fsub_rn/__fadd_rn, no FMA contraction) in the order of
// the plain PyTorch version, intersect_woop_any_reference. The result is
// an OR over pairs, so it does not depend on the order of visits: K2
// equals the plain version on every ray.
//
// What bounds it on this card: arithmetic, as for K1 (46 FP32 multiplies
// and adds per pair, each its own instruction; the table lives in L2).
// Shadow rays stop at their first hit, so the design spends its effort on
// testing fewer pairs:
//   - one CTA per block of consecutive rays, one thread per ray;
//   - the block walks all clusters; a per-ray slab gate against the
//     cluster AABB with limit t_max (plus K1's slack; the wrapper pads
//     the AABBs) decides which rays test it; occluded rays stop testing;
//     the CTA skips a cluster when no live ray reaches it, and leaves
//     the loop once every ray in it is occluded;
//   - a visited cluster's 64 x 3 rows (3 KB) are staged in shared memory
//     once and read by every thread as broadcasts.
// Warp-level early exit and a tighter hierarchy are left for later work.

#include "woop_common.cuh"

namespace {

constexpr int kMaxBlock = 256;

// the gate, its slack, the pair test and the safe inverse (woop_common.cuh)
using mq::any_pair;
using mq::gate;
using mq::kCluster;
using mq::load_box;
using mq::safe_inv;
using mq::with_slack;

// kCount: add up the (ray, triangle) pairs tested into counts[CTA]; the
// frame path launches the kCount = false instance, which has no counter.
template <bool kCount>
__global__ void __launch_bounds__(kMaxBlock)
woop_any_kernel(const float* __restrict__ rays, int64_t n_pad,
                const float4* __restrict__ w4, const float* __restrict__ lo,
                const float* __restrict__ hi, int nc,
                const uint8_t* __restrict__ occ_in,
                uint8_t* __restrict__ out,
                unsigned long long* __restrict__ counts) {
  __shared__ float4 tile[3 * kCluster];
  __shared__ int live;  // rays of this CTA not yet occluded
  unsigned long long pairs = 0;  // kCount only

  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float4 o = make_float4(rays[i], rays[n_pad + i], rays[2 * n_pad + i], 0.0f);
  const float dx = rays[3 * n_pad + i], dy = rays[4 * n_pad + i],
              dz = rays[5 * n_pad + i];
  const float t_min = rays[6 * n_pad + i], t_max = rays[7 * n_pad + i];
  const float4 inv = make_float4(safe_inv(dx), safe_inv(dy), safe_inv(dz), 0.0f);
  const float lim = with_slack(t_max);

  bool occ = occ_in != nullptr && occ_in[i] != 0;
  if (threadIdx.x == 0) live = 0;
  __syncthreads();
  if (!occ) atomicAdd(&live, 1);

  for (int c = 0; c < nc; ++c) {
    float tn;
    const bool reach = !occ && gate(load_box(lo, hi, c), o, inv, lim, &tn);
    // This barrier publishes `live` (changed only after the staging
    // barrier below) and keeps the previous tile alive until all are done.
    const int any = __syncthreads_or(reach);
    if (live == 0) break;
    if (!any) continue;

    for (int k = threadIdx.x; k < 3 * kCluster; k += blockDim.x) {
      tile[k] = w4[((int64_t)c * 3 * kCluster + k) * 2];
    }
    __syncthreads();

    if (reach) {
      for (int k = 0; k < kCluster; ++k) {
        if (kCount) ++pairs;
        if (any_pair(tile[k], tile[kCluster + k], tile[2 * kCluster + k], o.x, o.y, o.z, dx,
                     dy, dz, t_min, t_max)) {
          occ = true;
          atomicSub(&live, 1);
          break;
        }
      }
    }
  }
  out[i] = occ ? 1 : 0;
  if (kCount && pairs) atomicAdd(counts + blockIdx.x, pairs);
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() (0 = launched).
// `occ_in` may be null (no warm start). `counts` (u64[n_pad / block],
// zeroed by the caller, or null) gets per CTA the (ray, triangle) pairs
// tested; null launches the kernel without the counter.
extern "C" int mq_woop_any(const float* rays, int64_t n_pad, const float* w,
                           const float* lo, const float* hi, int nc, int block,
                           const uint8_t* occ_in, uint8_t* out,
                           unsigned long long* counts, void* stream) {
  if (block <= 0 || block > kMaxBlock || block % 32 != 0 ||
      n_pad % block != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t nb = n_pad / block;
  if (nb > 0) {
    const float4* w4 = reinterpret_cast<const float4*>(w);
    if (counts != nullptr) {
      woop_any_kernel<true><<<(unsigned)nb, block, 0, (cudaStream_t)stream>>>(
          rays, n_pad, w4, lo, hi, nc, occ_in, out, counts);
    } else {
      woop_any_kernel<false><<<(unsigned)nb, block, 0, (cudaStream_t)stream>>>(
          rays, n_pad, w4, lo, hi, nc, occ_in, out, nullptr);
    }
  }
  return (int)cudaGetLastError();
}
