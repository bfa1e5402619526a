// K8 on Hopper: dense Möller–Trumbore sweep, the nearest front-facing
// candidate hit of each ray over every triangle, with its barycentrics.
//
// Replaces the TPU kernel merian_quake_tpu/accel/pallas_intersect.py::
// _kernel (launched at :115 by intersect_packed; intersect_pallas at :150
// is its drop-in for accel.intersect), which folds a running nearest hit
// over a grid of (ray block x 64-triangle chunk). It keeps that kernel's
// contract, not its TPU schedule:
//   in:  rays f32[8, n_pad] rows (o.xyz, d.xyz, t_min, t_max);
//        tris f32[16, T] rows v0.xyz, v1.xyz, v2.xyz, candidate flag,
//        zeros (T a multiple of 64).
//   out: t f32[n_pad] (3e38 on a miss), tri i32[n_pad] (-1 on a miss),
//        u, v f32[n_pad] (0 on a miss).
// It computes what the port's CPU oracle computes
// (accel/dense.py::mt_nearest), in its order, every multiply, add and
// the reciprocal rounded on its own (__fmul_rn/__fadd_rn/__fsub_rn/
// __frcp_rn, no FMA contraction):
//   e1 = v1 - v0, e2 = v2 - v0, p = d x e2, det = (e1.x p.x + e1.y p.y)
//   + e1.z p.z, front = det < -1e-9, inv_det = 1 / (front ? det : -1),
//   s = o - v0, u = (s . p) inv_det, q = s x e1, v = (d . q) inv_det,
//   t = (e2 . q) inv_det; a hit when front, the candidate flag > 0.5,
//   u >= 0, v >= 0, u + v <= 1 and t_min < t <= t_max.
// Triangles are visited in index order and a hit replaces the best only
// when its t is smaller, so exact ties go to the lowest index, as the
// oracle's argmin does. K8 therefore equals the oracle bit for bit.
//
// What bounds it on this card: FP32 arithmetic. Every (ray, triangle)
// pair costs 45 rounded multiplies and adds and one reciprocal, and no
// pair is skipped; the bytes (32 B a ray in, 16 B out, 40 B a triangle)
// are small next to that. The design keeps the arithmetic in registers:
// one CTA per 128 rays, one thread per ray, each 64-triangle chunk's
// v0, e1, e2 and flag (10 floats a triangle, 2.5 KB) staged in shared
// memory once and read by every thread as broadcasts; the running hit
// lives in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kChunk = 64;
constexpr float kBig = 3e38f;
constexpr float kDetEps = 1e-9f;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

// a.y b.z - a.z b.y (one component of a x b), each product rounded
__device__ __forceinline__ float cross1(float ay, float az, float by, float bz) {
  return __fsub_rn(__fmul_rn(ay, bz), __fmul_rn(az, by));
}

__global__ void __launch_bounds__(kBlock)
mt_dense_kernel(const float* __restrict__ rays, int64_t n_pad,
                const float* __restrict__ tris, int64_t T, float* __restrict__ out_t,
                int* __restrict__ out_tri, float* __restrict__ out_u,
                float* __restrict__ out_v) {
  __shared__ float s[10][kChunk];  // v0.xyz, e1.xyz, e2.xyz, flag

  const int tid = threadIdx.x;
  const int64_t i = (int64_t)blockIdx.x * kBlock + tid;
  const float ox = rays[i], oy = rays[n_pad + i], oz = rays[2 * n_pad + i];
  const float dx = rays[3 * n_pad + i], dy = rays[4 * n_pad + i], dz = rays[5 * n_pad + i];
  const float t_min = rays[6 * n_pad + i], t_max = rays[7 * n_pad + i];

  float best = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1;
  for (int64_t c0 = 0; c0 < T; c0 += kChunk) {
    __syncthreads();  // the previous chunk is no longer read
    for (int k = tid; k < kChunk; k += kBlock) {
      const int64_t j = c0 + k;
      const float v0x = tris[j], v0y = tris[T + j], v0z = tris[2 * T + j];
      s[0][k] = v0x;
      s[1][k] = v0y;
      s[2][k] = v0z;
      s[3][k] = __fsub_rn(tris[3 * T + j], v0x);
      s[4][k] = __fsub_rn(tris[4 * T + j], v0y);
      s[5][k] = __fsub_rn(tris[5 * T + j], v0z);
      s[6][k] = __fsub_rn(tris[6 * T + j], v0x);
      s[7][k] = __fsub_rn(tris[7 * T + j], v0y);
      s[8][k] = __fsub_rn(tris[8 * T + j], v0z);
      s[9][k] = tris[9 * T + j];
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < kChunk; ++k) {
      const float e1x = s[3][k], e1y = s[4][k], e1z = s[5][k];
      const float e2x = s[6][k], e2y = s[7][k], e2z = s[8][k];
      const float px = cross1(dy, dz, e2y, e2z);
      const float py = cross1(dz, dx, e2z, e2x);
      const float pz = cross1(dx, dy, e2x, e2y);
      const float det = dot3(e1x, e1y, e1z, px, py, pz);
      const bool front = det < -kDetEps;
      const float inv_det = __frcp_rn(front ? det : -1.0f);
      const float sx = __fsub_rn(ox, s[0][k]);
      const float sy = __fsub_rn(oy, s[1][k]);
      const float sz = __fsub_rn(oz, s[2][k]);
      const float u = __fmul_rn(dot3(sx, sy, sz, px, py, pz), inv_det);
      const float qx = cross1(sy, sz, e1y, e1z);
      const float qy = cross1(sz, sx, e1z, e1x);
      const float qz = cross1(sx, sy, e1x, e1y);
      const float v = __fmul_rn(dot3(dx, dy, dz, qx, qy, qz), inv_det);
      const float t = __fmul_rn(dot3(e2x, e2y, e2z, qx, qy, qz), inv_det);
      const bool ok = front & (s[9][k] > 0.5f) & (u >= 0.0f) & (v >= 0.0f) &
                      (__fadd_rn(u, v) <= 1.0f) & (t > t_min) & (t <= t_max);
      if (ok && t < best) {
        best = t;
        best_u = u;
        best_v = v;
        best_tri = (int)(c0 + k);
      }
    }
  }
  out_t[i] = best;
  out_tri[i] = best_tri;
  out_u[i] = best_u;
  out_v[i] = best_v;
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() (0 = launched).
extern "C" int mq_mt_dense(const float* rays, int64_t n_pad, const float* tris, int64_t T,
                           int block, float* out_t, int* out_tri, float* out_u,
                           float* out_v, void* stream) {
  if (block != kBlock || n_pad % kBlock != 0 || T % kChunk != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t nb = n_pad / kBlock;
  if (nb > 0) {
    mt_dense_kernel<<<(unsigned)nb, kBlock, 0, (cudaStream_t)stream>>>(
        rays, n_pad, tris, T, out_t, out_tri, out_u, out_v);
  }
  return (int)cudaGetLastError();
}
