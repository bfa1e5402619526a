// K8 on Hopper: dense Möller–Trumbore sweep, the nearest front-facing
// candidate hit of each ray over every triangle, with its barycentrics.
//
// Replaces the TPU kernel merian_quake_tpu/accel/pallas_intersect.py::
// _kernel (launched at :115 by intersect_packed; intersect_pallas at :150
// is its drop-in for accel.intersect), which folds a running nearest hit
// over a grid of (ray block x 64-triangle chunk). It keeps that kernel's
// contract, not its TPU schedule:
//   in:  rays f32[8, n_pad] rows (o.xyz, d.xyz, t_min, t_max);
//        table f32[T, 12] (accel/dense.py::mt_table, made once a scene):
//        per triangle (v0.xyz, flag), (e1.xyz, 0), (e2.xyz, 0) with
//        e1 = v1 - v0, e2 = v2 - v0 each rounded (__fsub_rn equals torch's
//        sub) and flag 1.0 / 0.0 the candidate flag; 64 triangles are one
//        tile of 3,072 contiguous bytes (T a multiple of 64).
//   out: t f32[n_pad] (3e38 on a miss), tri i32[n_pad] (-1 on a miss),
//        u, v f32[n_pad] (0 on a miss); keys u64[n_pad] is scratch.
// It computes what the port's CPU oracle computes
// (accel/dense.py::mt_nearest), in its order, every multiply, add and
// the reciprocal rounded on its own (__fmul_rn/__fadd_rn/__fsub_rn/
// __frcp_rn, no FMA contraction):
//   p = d x e2, det = (e1.x p.x + e1.y p.y) + e1.z p.z, front = det < -1e-9,
//   inv_det = 1 / det, s = o - v0, u = (s . p) inv_det, q = s x e1,
//   v = (d . q) inv_det, t = (e2 . q) inv_det; a hit when front, the flag
//   > 0.5, u >= 0, v >= 0, u + v <= 1 and t_min < t <= t_max, and t < 3e38
//   (the oracle's miss value never loses to a hit at or above it).
// The nearest hit is the least t, exact ties to the lowest index (the
// oracle's argmin, then its strict < across chunks), so K8 equals the
// oracle bit for bit in (t, tri, u, v).
//
// What bounds it on this card: FP32 arithmetic. No pair is skipped by a
// cull, and a pair costs 45 rounded multiplies and adds and one reciprocal
// (46 operations, each its own instruction); the bytes (32 B a ray in,
// 16 B out, 48 B a triangle) are small next to that. The first design
// (one ray a thread in CTAs of 128, every CTA recomputing e1 and e2 for
// every triangle, tiles staged by plain loads between two __syncthreads, 10
// shared-memory floats read a pair, the IEEE reciprocal __frcp_rn on every
// pair, a data-dependent branch for the best hit) took 61.59 ms on 65,536
// map rays x 281,536 triangles against a bound of 25.34 (NVIDIA H100 80GB
// HBM3, 700 W).
//
// What this design does about it:
//   - (v0, e1, e2, flag) are computed once a scene (mt_table), in the
//     layout the kernel reads as it is: three float4 a triangle;
//   - tiles come by one bulk copy (cp.async.bulk, 3,072 bytes) into a ring
//     of kStages slots, completion on each slot's mbarrier, issued
//     kStages - 1 tiles ahead, so the next tiles land while this one is
//     tested; one __syncthreads a tile frees the slot just left;
//   - a thread holds kRays rays, so the three shared-memory reads of a
//     triangle (broadcasts) serve kRays pairs;
//   - division-free pre-tests reject a pair before the reciprocal, in
//     three levels of rising cost, each skipped by the whole warp when no
//     pair of its 32 x kRays passes the one before:
//       1. p, det (14 operations): front and the flag, exactly;
//       2. s, s . p (8): u >= 0 needs s . p < 2^-20 (or det = -inf);
//       3. q, d . q, e2 . q (19): v >= 0 needs d . q < 2^-20 (or det =
//          -inf), t > t_min needs e2 . q < 0 when t_min >= 0;
//     then the reciprocal and the exact test (5) on the pairs that pass.
//     The argument that a pre-test rejects only pairs the exact test
//     rejects: front means det < -1e-9, so inv_det = rn(1 / det) is
//     negative or -0 (det = -inf). (a) x = s . p or d . q with x >= 2^-20
//     and det finite: |inv_det| > 2^-130 (1 / |det| > 1 / FLT_MAX > 2^-129,
//     rounded to the denormal grid of 2^-149), so |x inv_det| > 2^-150 and
//     rn(x inv_det) is a negative number, not -0: u (or v) < 0 and the
//     pair fails. A positive x below 2^-20 may round to -0, which passes
//     x >= 0, so the pre-test lets it through; x = +inf gives -inf or NaN,
//     which fails; a NaN x fails both. (b) t_min >= 0 and e2 . q >= 0 (+0
//     and -0 included): t = rn(e2 . q inv_det) is <= -0 or NaN, so t >
//     t_min fails; with t_min < 0 or NaN nothing is pre-rejected.
//     tests/test_torch_map.py holds a torch model of this schedule to the
//     oracle bit for bit, and a mutant whose pre-test rejects x = -0
//     results must fail it;
//   - the triangles are split into parts across a second grid dimension,
//     enough CTAs for about four waves on the card's SMs; each CTA keeps
//     its rays' best (t, tri) in registers (triangles in index order, a
//     strict <) and merges it with a 64-bit atomicMin of
//     (order-preserving key of t, tri) into keys, which keeps the least t
//     and then the lowest index; a second kernel then recomputes t, u, v
//     of each ray's winning triangle with the same operations.
// Read on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6): the first
// design issued 86 instructions a pair in its loop (cuobjdump -sass:
// 46 multiplies and adds, 10 shared loads, 8 compares, 4 selects, the
// reciprocal's MUFU, FFMAs and slow-path call, branches), which is why it
// reached 41% of a bound that counts 46. This design: 26.7 ms on 65,536
// map rays (the first 61.8 in the same call), 4 rays a thread 3% faster
// than 2; 60% of the pairs pass level 1, 32% level 2, 18% level 3, so
// these inputs need 25.8 operations a pair: a bound of 14.2 ms.

#include <algorithm>

#include "woop_common.cuh"

namespace {

using mq::kFull;

constexpr int kThreads = 128;
constexpr int kRays = 4;                   // rays a thread
constexpr int kCtaRays = kThreads * kRays;
constexpr int kTris = 64;                  // triangles a tile
constexpr int kTileRows = 3 * kTris;       // float4 rows a tile
constexpr int kTileBytes = kTileRows * 16;
constexpr int kStages = 3;                 // tile slots a CTA
constexpr int kMinCtas = 4;                // CTAs an SM the register budget allows
constexpr int kWaves = 4;                  // CTAs the grid aims at, in waves of the card
constexpr float kBig = 3e38f;
constexpr float kDetEps = 1e-9f;
constexpr float kTiny = 0x1p-20f;          // pre-test threshold of s . p and d . q

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

// a.y b.z - a.z b.y (one component of a x b), each product rounded
__device__ __forceinline__ float cross1(float ay, float az, float by, float bz) {
  return __fsub_rn(__fmul_rn(ay, bz), __fmul_rn(az, by));
}

// kCount: add up per 128-ray block the pairs that pass pre-test level 1
// (front and flag), level 2 and level 3 (every pre-test) into counts[3 *
// block + 0..2]; the frame-free dense path launches the instance without.
template <bool kCount>
__global__ void __launch_bounds__(kThreads, kMinCtas)
mt_sweep_kernel(const float* __restrict__ rays, int64_t n_pad, const float4* __restrict__ table,
                int ntiles, int tiles_per_part, unsigned long long* __restrict__ keys,
                unsigned long long* __restrict__ counts) {
  __shared__ __align__(128) float4 ring[kStages][kTileRows];
  __shared__ __align__(8) unsigned long long full[kStages];
  const int tid = threadIdx.x;
  const int first = blockIdx.y * tiles_per_part;
  const int end = min(ntiles, first + tiles_per_part);
  if (first >= end) return;  // the whole CTA

  // this thread's rays: i = CTA base + r * 128 + tid; past n_pad a ray has
  // d = 0, so det = 0 (or NaN) and no pair of it is front-facing
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays], t0[kRays], t1[kRays];
  float best[kRays];
  int best_tri[kRays];
  unsigned c1[kRays], c2[kRays], c3[kRays];  // kCount only
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int64_t i = (int64_t)blockIdx.x * kCtaRays + r * kThreads + tid;
    const bool live = i < n_pad;
    ox[r] = live ? rays[i] : 0.0f;
    oy[r] = live ? rays[n_pad + i] : 0.0f;
    oz[r] = live ? rays[2 * n_pad + i] : 0.0f;
    dx[r] = live ? rays[3 * n_pad + i] : 0.0f;
    dy[r] = live ? rays[4 * n_pad + i] : 0.0f;
    dz[r] = live ? rays[5 * n_pad + i] : 0.0f;
    t0[r] = live ? rays[6 * n_pad + i] : 0.0f;
    t1[r] = live ? rays[7 * n_pad + i] : -1.0f;
    best[r] = kBig;
    best_tri[r] = -1;
    c1[r] = c2[r] = c3[r] = 0u;
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mq::mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int s = 0; s < kStages - 1 && first + s < end; ++s) {
      mq::mbar_expect(full + s, kTileBytes);
      mq::bulk_copy(ring[s], table + (int64_t)(first + s) * kTileRows, kTileBytes, full + s);
    }
  }

  for (int j = 0; first + j < end; ++j) {
    // every thread has left tile j - 1: its slot takes tile j + kStages - 1
    __syncthreads();
    const int next = first + j + kStages - 1;
    if (tid == 0 && next < end) {
      const int s = (j + kStages - 1) % kStages;
      mq::mbar_expect(full + s, kTileBytes);
      mq::bulk_copy(ring[s], table + (int64_t)next * kTileRows, kTileBytes, full + s);
    }
    const int s = j % kStages;
    mq::mbar_wait(full + s, (unsigned)((j / kStages) & 1));
    const float4* tile = ring[s];
    const int base = (first + j) * kTris;

#pragma unroll 2
    for (int k = 0; k < kTris; ++k) {
      const float4 a = tile[3 * k], e1 = tile[3 * k + 1], e2 = tile[3 * k + 2];
      // level 1: p = d x e2, det = e1 . p; front and the flag
      float px[kRays], py[kRays], pz[kRays], det[kRays];
      bool f[kRays];
      bool any = false;
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        px[r] = cross1(dy[r], dz[r], e2.y, e2.z);
        py[r] = cross1(dz[r], dx[r], e2.z, e2.x);
        pz[r] = cross1(dx[r], dy[r], e2.x, e2.y);
        det[r] = dot3(e1.x, e1.y, e1.z, px[r], py[r], pz[r]);
        f[r] = (det[r] < -kDetEps) & (a.w > 0.5f);
        if (kCount) c1[r] += f[r];
        any |= f[r];
      }
      if (!__any_sync(kFull, any)) continue;
      // level 2: s = o - v0, s . p; u >= 0 needs s . p < 2^-20 (or det = -inf)
      float sx[kRays], sy[kRays], sz[kRays], un[kRays];
      any = false;
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        sx[r] = __fsub_rn(ox[r], a.x);
        sy[r] = __fsub_rn(oy[r], a.y);
        sz[r] = __fsub_rn(oz[r], a.z);
        un[r] = dot3(sx[r], sy[r], sz[r], px[r], py[r], pz[r]);
        f[r] &= (un[r] < kTiny) | (det[r] == -INFINITY);
        if (kCount) c2[r] += f[r];
        any |= f[r];
      }
      if (!__any_sync(kFull, any)) continue;
      // level 3: q = s x e1, d . q, e2 . q; v >= 0 needs d . q < 2^-20 (or
      // det = -inf), t > t_min >= 0 needs e2 . q < 0
      float vn[kRays], tn[kRays];
      any = false;
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        const float qx = cross1(sy[r], sz[r], e1.y, e1.z);
        const float qy = cross1(sz[r], sx[r], e1.z, e1.x);
        const float qz = cross1(sx[r], sy[r], e1.x, e1.y);
        vn[r] = dot3(dx[r], dy[r], dz[r], qx, qy, qz);
        tn[r] = dot3(e2.x, e2.y, e2.z, qx, qy, qz);
        f[r] &= ((vn[r] < kTiny) | (det[r] == -INFINITY)) & ((tn[r] < 0.0f) | !(t0[r] >= 0.0f));
        if (kCount) c3[r] += f[r];
        any |= f[r];
      }
      if (!__any_sync(kFull, any)) continue;
      // the exact test on the pairs that passed
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        const float inv = __frcp_rn(f[r] ? det[r] : -1.0f);
        const float u = __fmul_rn(un[r], inv);
        const float v = __fmul_rn(vn[r], inv);
        const float t = __fmul_rn(tn[r], inv);
        const bool ok = f[r] & (u >= 0.0f) & (v >= 0.0f) & (__fadd_rn(u, v) <= 1.0f) &
                        (t > t0[r]) & (t <= t1[r]) & (t < best[r]);
        best[r] = ok ? t : best[r];
        best_tri[r] = ok ? base + k : best_tri[r];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int64_t i = (int64_t)blockIdx.x * kCtaRays + r * kThreads + tid;
    if (best_tri[r] >= 0) {
      atomicMin(keys + i, ((unsigned long long)mq::float_key(best[r]) << 32) |
                              (unsigned long long)(unsigned)best_tri[r]);
    }
    if (kCount) {
      const unsigned n1 = __reduce_add_sync(kFull, c1[r]);
      const unsigned n2 = __reduce_add_sync(kFull, c2[r]);
      const unsigned n3 = __reduce_add_sync(kFull, c3[r]);
      const int64_t row = (int64_t)blockIdx.x * kRays + r;
      if ((tid & 31) == 0 && row * kThreads < n_pad) {
        atomicAdd(counts + 3 * row + 0, (unsigned long long)n1);
        atomicAdd(counts + 3 * row + 1, (unsigned long long)n2);
        atomicAdd(counts + 3 * row + 2, (unsigned long long)n3);
      }
    }
  }
}

// each ray's winner from its key: t, u, v recomputed with the sweep's
// operations (so the same bits), or the miss values
__global__ void __launch_bounds__(kThreads)
mt_resolve_kernel(const float* __restrict__ rays, int64_t n_pad, const float4* __restrict__ table,
                  const unsigned long long* __restrict__ keys, float* __restrict__ out_t,
                  int* __restrict__ out_tri, float* __restrict__ out_u, float* __restrict__ out_v) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_pad) return;
  const unsigned long long key = keys[i];
  if (key == ~0ull) {
    out_t[i] = kBig;
    out_tri[i] = -1;
    out_u[i] = 0.0f;
    out_v[i] = 0.0f;
    return;
  }
  const int tri = (int)(unsigned)(key & 0xffffffffull);
  const float4 a = table[3 * (int64_t)tri], e1 = table[3 * (int64_t)tri + 1],
               e2 = table[3 * (int64_t)tri + 2];
  const float ox = rays[i], oy = rays[n_pad + i], oz = rays[2 * n_pad + i];
  const float dx = rays[3 * n_pad + i], dy = rays[4 * n_pad + i], dz = rays[5 * n_pad + i];
  const float px = cross1(dy, dz, e2.y, e2.z);
  const float py = cross1(dz, dx, e2.z, e2.x);
  const float pz = cross1(dx, dy, e2.x, e2.y);
  const float inv = __frcp_rn(dot3(e1.x, e1.y, e1.z, px, py, pz));
  const float sx = __fsub_rn(ox, a.x), sy = __fsub_rn(oy, a.y), sz = __fsub_rn(oz, a.z);
  const float qx = cross1(sy, sz, e1.y, e1.z);
  const float qy = cross1(sz, sx, e1.z, e1.x);
  const float qz = cross1(sx, sy, e1.x, e1.y);
  out_t[i] = __fmul_rn(dot3(e2.x, e2.y, e2.z, qx, qy, qz), inv);
  out_tri[i] = tri;
  out_u[i] = __fmul_rn(dot3(sx, sy, sz, px, py, pz), inv);
  out_v[i] = __fmul_rn(dot3(dx, dy, dz, qx, qy, qz), inv);
}

template <bool kCount>
int launch_sweep(const float* rays, int64_t n_pad, const float4* table, int ntiles,
                 unsigned long long* keys, unsigned long long* counts, cudaStream_t stream) {
  int dev = 0, sms = 0, occ = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, mt_sweep_kernel<kCount>, kThreads, 0);
  const int64_t ray_ctas = (n_pad + kCtaRays - 1) / kCtaRays;
  const int64_t ctas = (int64_t)kWaves * std::max(sms, 1) * std::max(occ, 1);
  const int64_t want = std::max<int64_t>((ctas + ray_ctas - 1) / ray_ctas, 1);
  const int parts0 = (int)std::min<int64_t>(std::min<int64_t>(want, ntiles), 65535);
  const int per = (ntiles + parts0 - 1) / parts0;
  const int parts = (ntiles + per - 1) / per;
  mt_sweep_kernel<kCount><<<dim3((unsigned)ray_ctas, (unsigned)parts), kThreads, 0, stream>>>(
      rays, n_pad, table, ntiles, per, keys, counts);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` (a memset
// of `keys`, the sweep, the resolve), does not synchronise, allocates
// nothing; returns cudaGetLastError() (0 = launched). `block` must be 128,
// n_pad a multiple of it, T a positive multiple of 64, `table` 16-byte
// aligned; `keys` u64[n_pad] is scratch. `counts` (u64[3 * n_pad / 128],
// zeroed by the caller, or null) gets per 128-ray block the pairs that
// passed pre-test levels 1, 2 and 3; null launches the sweep without the
// counter.
extern "C" int mq_mt_dense(const float* rays, int64_t n_pad, const float* table, int64_t T,
                           int block, unsigned long long* keys, float* out_t, int* out_tri,
                           float* out_u, float* out_v, unsigned long long* counts, void* stream) {
  if (block != kThreads || n_pad < 0 || n_pad % kThreads != 0 || T <= 0 || T % kTris != 0 ||
      T / kTris > (1 << 24)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_pad == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const float4* t4 = reinterpret_cast<const float4*>(table);
  const int ntiles = (int)(T / kTris);
  cudaError_t err = cudaMemsetAsync(keys, 0xff, (size_t)n_pad * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  const int rc = counts != nullptr ? launch_sweep<true>(rays, n_pad, t4, ntiles, keys, counts, st)
                                   : launch_sweep<false>(rays, n_pad, t4, ntiles, keys, nullptr, st);
  if (rc != 0) return rc;
  mt_resolve_kernel<<<(unsigned)(n_pad / kThreads), kThreads, 0, st>>>(rays, n_pad, t4, keys, out_t,
                                                                      out_tri, out_u, out_v);
  return (int)cudaGetLastError();
}
