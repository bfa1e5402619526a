// K4 and K5 on Hopper: the per-ray target key and the per-block union
// entry, two entry points over one slab function (woop_common.cuh).
//
// K4 replaces merian_quake_tpu/accel/woop.py::_kernel_target_keys (:877,
// driven by _target_keys :936):
//   in:  rays f32[8, n_pad] (o.xyz, d.xyz, t_min, t_max), n_pad a multiple
//        of 128; box bounds lo/hi f32[nc, 3], nc <= 256 (the accel's
//        cluster AABBs as they are, unpadded, as woop.py:1677-1680 passes
//        them).
//   out: key i32[n_pad] = c1 << 22 | c2 << 14 | c3 << 6: the ids of the
//        ray's three nearest boxes by slab entry (limit = the ray's t_max),
//        0xFF where it reaches fewer. Boxes are taken in ascending id with a
//        strict < insertion, so equal entries (an origin inside several
//        boxes: entry 0 for each) keep the lowest ids; box 255 equals the
//        sentinel, as in the JAX package.
// K5 replaces woop.py::_kernel_te_union (:914, driven by _te_union :966):
//   in:  rays as K4's; m boxes lo/hi f32[m, 3] (clusters or node boxes);
//        `slack` 0 or 1.
//   out: te f32[n_pad / 128, m]: per block of 128 rays and per box the least
//        slab entry over the block's rays, +inf where none reaches it.
//        slack = 0 is the JAX function (limit = the ray's t_max, boxes as
//        given); slack = 1 is the list of the walker (csrc/woop_list.cu):
//        limit = list_slack(t_max) over padded boxes, and empty boxes
//        (lo > hi: no candidate triangle) are never listed.
// The slab is the JAX one operation for operation (each subtract and
// multiply rounded, min/max propagating NaN as jnp.minimum/maximum do), so
// both kernels are bit-equal to their plain versions
// (woop.target_keys_reference, woop.te_union_reference) and to the JAX
// kernels in interpret mode.
//
// What bounds them on this card: FP32 operations, 24 a (ray, box) slab
// (12 subtracts and multiplies, 12 min/max) over rays x boxes; the bytes
// (32 B a ray in, 4 B a ray or 4 B a (block, box) out) are small beside
// it. The designs are the simple ones: K4 one thread per ray walking every
// box from shared memory (broadcast reads); K5 one CTA per block of 128
// rays with the rays (origin, inverse direction, limit) in shared memory,
// one thread per box looping over them. K5 leaves threads idle when a
// block has fewer than 128 boxes (node lists): splitting the rays over
// thread groups is later work.

#include "woop_common.cuh"

namespace {

using namespace mq;

constexpr int kMaxKeyBoxes = 256;

__global__ void __launch_bounds__(kBlock)
target_keys_kernel(const float* __restrict__ rays, int64_t n_pad, const float* __restrict__ lo,
                   const float* __restrict__ hi, int nc, int* __restrict__ out) {
  __shared__ Box boxes[kMaxKeyBoxes];
  for (int c = threadIdx.x; c < nc; c += kBlock) boxes[c] = load_box(lo, hi, c);
  __syncthreads();

  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  const Ray r = Ray{rays[i], rays[n_pad + i], rays[2 * n_pad + i], safe_inv(rays[3 * n_pad + i]),
                 safe_inv(rays[4 * n_pad + i]), safe_inv(rays[5 * n_pad + i])};
  const float lim = rays[7 * n_pad + i];
  float t1 = INFINITY, t2 = INFINITY, t3 = INFINITY;
  int c1 = 0xFF, c2 = 0xFF, c3 = 0xFF;
  for (int c = 0; c < nc; ++c) {
    float te;
    slab(boxes[c], r, lim, &te);
    const bool b1 = te < t1, b2 = te < t2, b3 = te < t3;
    const float t3n = b3 ? (b2 ? t2 : te) : t3;
    const int c3n = b3 ? (b2 ? c2 : c) : c3;
    const float t2n = b2 ? (b1 ? t1 : te) : t2;
    const int c2n = b2 ? (b1 ? c1 : c) : c2;
    t1 = b1 ? te : t1;
    c1 = b1 ? c : c1;
    t2 = t2n;
    t3 = t3n;
    c2 = c2n;
    c3 = c3n;
  }
  out[i] = (c1 << 22) | (c2 << 14) | (c3 << 6);
}

__global__ void __launch_bounds__(kBlock)
te_union_kernel(const float* __restrict__ rays, int64_t n_pad, const float* __restrict__ lo,
                const float* __restrict__ hi, int m, int slack, float* __restrict__ out) {
  __shared__ Ray ray[kBlock];
  __shared__ float lim[kBlock];
  const int tid = threadIdx.x;
  const int64_t i = (int64_t)blockIdx.x * kBlock + tid;
  ray[tid] = Ray{rays[i], rays[n_pad + i], rays[2 * n_pad + i], safe_inv(rays[3 * n_pad + i]),
              safe_inv(rays[4 * n_pad + i]), safe_inv(rays[5 * n_pad + i])};
  const float t_max = rays[7 * n_pad + i];
  lim[tid] = slack ? list_slack(t_max) : t_max;
  __syncthreads();

  for (int b = tid; b < m; b += kBlock) {
    const Box box = load_box(lo, hi, b);
    float acc = INFINITY;
    if (!(slack && empty_box(box))) {
      for (int k = 0; k < kBlock; ++k) {
        float te;
        slab(box, ray[k], lim[k], &te);
        acc = fminf(acc, te);  // te is never NaN
      }
    }
    out[(int64_t)blockIdx.x * m + b] = acc;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`, does
// not synchronise, allocates nothing, and returns cudaGetLastError()
// (0 = launched).
extern "C" int mq_target_keys(const float* rays, int64_t n_pad, const float* lo, const float* hi,
                              int nc, int* out, void* stream) {
  if (n_pad <= 0 || n_pad % kBlock != 0 || nc < 0 || nc > kMaxKeyBoxes) {
    return (int)cudaErrorInvalidValue;
  }
  target_keys_kernel<<<(unsigned)(n_pad / kBlock), kBlock, 0, (cudaStream_t)stream>>>(
      rays, n_pad, lo, hi, nc, out);
  return (int)cudaGetLastError();
}

extern "C" int mq_te_union(const float* rays, int64_t n_pad, const float* lo, const float* hi,
                           int m, int slack, float* out, void* stream) {
  if (n_pad <= 0 || n_pad % kBlock != 0 || m <= 0) return (int)cudaErrorInvalidValue;
  te_union_kernel<<<(unsigned)(n_pad / kBlock), kBlock, 0, (cudaStream_t)stream>>>(
      rays, n_pad, lo, hi, m, slack, out);
  return (int)cudaGetLastError();
}
