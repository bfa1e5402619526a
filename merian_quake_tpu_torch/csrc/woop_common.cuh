// Device helpers shared by the Woop kernels: K1-K3 (their gate, its slack
// and the pair tests), K4 and K5 (csrc/woop_keys.cu) and the list walker
// K6/K7 (csrc/woop_list.cu); the mbarrier and bulk-copy helpers and the
// ordered float key also serve K8 (csrc/mt_dense.cu). Every pair test of every kernel is one of the
// two functions below, so the bit-exact contract with the plain versions
// lives in one place. The walk's per-ray gate calls the slab function
// here; the union that builds its list (csrc/woop_keys.cu) computes the same
// entry bit for bit with each ray's planes chosen once, so a box the gate
// could pass is always listed. kernels.py hashes this header into the
// name of every library, so an edit rebuilds them all.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mq {

constexpr int kCluster = 64;
constexpr int kTile = 3 * kCluster;  // float4 rows of one cluster
constexpr int kBlock = 128;          // rays per CTA, one thread each
constexpr int kWarps = kBlock / 32;
constexpr float kBig = 3e38f;

// jnp.minimum / jnp.maximum: a NaN operand gives NaN (fminf and fmaxf
// would drop it; only a ray with a NaN origin or direction tells them apart)
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float safe_inv(float d) {
  const float tiny = d >= 0.0f ? 1e-20f : -1e-20f;
  return 1.0f / (fabsf(d) < 1e-20f ? tiny : d);
}

// K1-K3's slack on a gate's limit (every gate in those kernels uses it)
__device__ __forceinline__ float with_slack(float lim) {
  return fmaf(fabsf(lim), 1e-4f, lim) + 1e-3f;
}

// The walk's slack on a limit: (lim + |lim|·1e-4) + 1e-3, each step rounded
// on its own (no FMA, unlike K1's with_slack), so the plain PyTorch version
// (woop.list_slack) computes it bit for bit. Monotone in lim.
__device__ __forceinline__ float list_slack(float lim) {
  return __fadd_rn(__fadd_rn(lim, __fmul_rn(fabsf(lim), 1e-4f)), 1e-3f);
}

struct Ray {
  float ox, oy, oz, ix, iy, iz;  // origin, 1 / direction (safe_inv)
};

struct Box {
  float lx, ly, lz, hx, hy, hz;
};

// The slab of the JAX package's _slab_te_lanes (woop.py:852-874): from
// tn = 0, tf = lim, per axis t1 = (lo - o)·inv, t2 = (hi - o)·inv (each
// rounded), tn = max(tn, min(t1, t2)), tf = min(tf, max(t1, t2)), NaN
// propagating. Returns whether tn <= tf; *te gets tn + 0 (a zero entry is
// +0, whatever the sign the min/max tree left on it) or +inf.
// 12 FP32 subtracts and multiplies and 12 min/max: 24 FP32 operations.
__device__ __forceinline__ bool slab(const Box& b, const Ray& r, float lim, float* te) {
  float tn = 0.0f, tf = lim;
  {
    const float t1 = __fmul_rn(__fsub_rn(b.lx, r.ox), r.ix);
    const float t2 = __fmul_rn(__fsub_rn(b.hx, r.ox), r.ix);
    tn = nan_max(tn, nan_min(t1, t2));
    tf = nan_min(tf, nan_max(t1, t2));
  }
  {
    const float t1 = __fmul_rn(__fsub_rn(b.ly, r.oy), r.iy);
    const float t2 = __fmul_rn(__fsub_rn(b.hy, r.oy), r.iy);
    tn = nan_max(tn, nan_min(t1, t2));
    tf = nan_min(tf, nan_max(t1, t2));
  }
  {
    const float t1 = __fmul_rn(__fsub_rn(b.lz, r.oz), r.iz);
    const float t2 = __fmul_rn(__fsub_rn(b.hz, r.oz), r.iz);
    tn = nan_max(tn, nan_min(t1, t2));
    tf = nan_min(tf, nan_max(t1, t2));
  }
  const bool reach = tn <= tf;
  *te = reach ? __fadd_rn(tn, 0.0f) : INFINITY;
  return reach;
}

// K1-K3's per-ray gate: does the ray (origin o, inverse direction i) reach
// box b within [0, lim]? *tn gets its entry parameter. It is slab's
// arithmetic with fminf/fmaxf, which drop a NaN where slab propagates it: a
// ray with a NaN origin or direction passes this gate, and then its pair
// tests reject every triangle (a NaN compares false), so the rule changes
// which clusters are visited, never a result. K3 builds its visit list with
// this gate too, so its list and its walk agree as the walker's do on slab.
__device__ __forceinline__ bool gate(const Box& b, float4 o, float4 i, float lim, float* tn) {
  float n = 0.0f, f = lim;
  {
    const float t1 = __fmul_rn(__fsub_rn(b.lx, o.x), i.x);
    const float t2 = __fmul_rn(__fsub_rn(b.hx, o.x), i.x);
    n = fmaxf(n, fminf(t1, t2));
    f = fminf(f, fmaxf(t1, t2));
  }
  {
    const float t1 = __fmul_rn(__fsub_rn(b.ly, o.y), i.y);
    const float t2 = __fmul_rn(__fsub_rn(b.hy, o.y), i.y);
    n = fmaxf(n, fminf(t1, t2));
    f = fminf(f, fmaxf(t1, t2));
  }
  {
    const float t1 = __fmul_rn(__fsub_rn(b.lz, o.z), i.z);
    const float t2 = __fmul_rn(__fsub_rn(b.hz, o.z), i.z);
    n = fmaxf(n, fminf(t1, t2));
    f = fminf(f, fmaxf(t1, t2));
  }
  *tn = n;
  return n <= f;
}

// ((x·r.x + y·r.y) + z·r.z) + r.w, each step rounded (plain-version order)
__device__ __forceinline__ float affine(float4 r, float x, float y, float z) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(x, r.x), __fmul_rn(y, r.y)), __fmul_rn(z, r.z)),
      r.w);
}

__device__ __forceinline__ float linear(float4 r, float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, r.x), __fmul_rn(y, r.y)), __fmul_rn(z, r.z));
}

// The nearest-hit test of one (ray, triangle) pair, which K1, K3 and the
// walker call (csrc/woop_nearest.cu states it); *t gets -z0 / dz when it
// hits.
__device__ __forceinline__ bool nearest_pair(float4 r0, float4 r1, float4 r2, float ox, float oy,
                                             float oz, float dx, float dy, float dz, float t_min,
                                             float t_max, float* t) {
  const float u0 = affine(r0, ox, oy, oz);
  const float v0 = affine(r1, ox, oy, oz);
  const float z0 = affine(r2, ox, oy, oz);
  const float du = linear(r0, dx, dy, dz);
  const float dv = linear(r1, dx, dy, dz);
  const float dzz = linear(r2, dx, dy, dz);
  const float z0n = -z0;
  const float U = __fsub_rn(__fmul_rn(u0, dzz), __fmul_rn(z0, du));
  const float V = __fsub_rn(__fmul_rn(v0, dzz), __fmul_rn(z0, dv));
  const bool ok = (dzz > 1e-12f) & (U >= 0.0f) & (V >= 0.0f) & (__fadd_rn(U, V) <= dzz) &
                  (z0n > __fmul_rn(t_min, dzz)) & (z0n <= __fmul_rn(t_max, dzz));
  if (ok) *t = __fdiv_rn(z0n, dzz);
  return ok;
}

// The any-hit test of one pair, which K2, K3 and the walker call
// (csrc/woop_any.cu states it): every term >= 0, so a NaN term rejects its
// pair.
__device__ __forceinline__ bool any_pair(float4 r0, float4 r1, float4 r2, float ox, float oy,
                                         float oz, float dx, float dy, float dz, float t_min,
                                         float t_max) {
  const float u0 = affine(r0, ox, oy, oz);
  const float v0 = affine(r1, ox, oy, oz);
  const float z0 = affine(r2, ox, oy, oz);
  const float du = linear(r0, dx, dy, dz);
  const float dv = linear(r1, dx, dy, dz);
  const float dzz = linear(r2, dx, dy, dz);
  const float z0n = -z0;
  const float U = __fsub_rn(__fmul_rn(u0, dzz), __fmul_rn(z0, du));
  const float V = __fsub_rn(__fmul_rn(v0, dzz), __fmul_rn(z0, dv));
  return (U >= 0.0f) & (V >= 0.0f) & (__fsub_rn(__fsub_rn(dzz, U), V) >= 0.0f) &
         (__fsub_rn(dzz, 1e-12f) >= 0.0f) & (__fsub_rn(z0n, __fmul_rn(t_min, dzz)) >= 0.0f) &
         (__fsub_rn(__fmul_rn(t_max, dzz), z0n) >= 0.0f);
}

// ---- the alpha test of a committed hit (the alpha walk, csrc/woop_alpha.cu) ----

// The tables the alpha test reads, as the scene holds them (the live loop
// rewrites them in place, so they are read from their own storage): attr
// f32[T, attr_stride] (columns 0-8: v0, v1, v2), st f32[T, 3, 2], texnum
// i32[T], needs u8[T] (bool), rect i32[ntex, 4] (x, y, w, h), texels
// f32[H, width, 4]; n the rays that are not padding, rounds the alpha
// loop's cap; out_u, out_v f32[n_pad] get the accepted hit's barycentrics.
struct AlphaTables {
  const float* attr;
  const float* st;
  const int* texnum;
  const uint8_t* needs;
  const int* rect;
  const float* texels;
  float* out_u;
  float* out_v;
  int64_t n;
  int attr_stride, ntex, width, rounds;
};

constexpr float kAlphaThreshold = 0.666f;  // materials.ALPHA_THRESHOLD
constexpr float kAdvance = 1e-3f;          // re-trace offset past a rejected surface

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// Triangle tri's hit by the ray (o, d): the exact (t, u, v) of
// woop._recompute_tuv, then the texel alpha at the interpolated UV
// (intersect._hit_uv, atlas.sample_nearest); returns whether the alpha
// test rejects it (needs_alpha and alpha below the threshold). Every
// operation in the plain version's order, each rounded on its own, so the
// two agree bit for bit.
__device__ __forceinline__ bool alpha_rejects(const AlphaTables& al, int tri, float ox, float oy,
                                              float oz, float dx, float dy, float dz, float* t,
                                              float* u, float* v) {
  const float* a = al.attr + (int64_t)tri * al.attr_stride;
  const float v0x = __ldg(a + 0), v0y = __ldg(a + 1), v0z = __ldg(a + 2);
  const float e1x = __fsub_rn(__ldg(a + 3), v0x), e1y = __fsub_rn(__ldg(a + 4), v0y),
              e1z = __fsub_rn(__ldg(a + 5), v0z);
  const float e2x = __fsub_rn(__ldg(a + 6), v0x), e2y = __fsub_rn(__ldg(a + 7), v0y),
              e2z = __fsub_rn(__ldg(a + 8), v0z);
  const float nx = cross_term(e1y, e2z, e1z, e2y), ny = cross_term(e1z, e2x, e1x, e2z),
              nz = cross_term(e1x, e2y, e1y, e2x);
  const float dn = dot3(dx, dy, dz, nx, ny, nz);
  const float th = __fdiv_rn(dot3(__fsub_rn(v0x, ox), __fsub_rn(v0y, oy), __fsub_rn(v0z, oz), nx,
                                  ny, nz),
                             fabsf(dn) > 1e-20f ? dn : 1.0f);
  const float qx = __fsub_rn(__fadd_rn(ox, __fmul_rn(th, dx)), v0x);
  const float qy = __fsub_rn(__fadd_rn(oy, __fmul_rn(th, dy)), v0y);
  const float qz = __fsub_rn(__fadd_rn(oz, __fmul_rn(th, dz)), v0z);
  const float d00 = dot3(e1x, e1y, e1z, e1x, e1y, e1z);
  const float d01 = dot3(e1x, e1y, e1z, e2x, e2y, e2z);
  const float d11 = dot3(e2x, e2y, e2z, e2x, e2y, e2z);
  const float d20 = dot3(qx, qy, qz, e1x, e1y, e1z);
  const float d21 = dot3(qx, qy, qz, e2x, e2y, e2z);
  const float denom = cross_term(d00, d11, d01, d01);
  const float inv = __fdiv_rn(1.0f, fabsf(denom) > 1e-18f ? denom : 1.0f);
  const float hu = __fmul_rn(cross_term(d11, d20, d01, d21), inv);
  const float hv = __fmul_rn(cross_term(d00, d21, d01, d20), inv);
  *t = th;
  *u = hu;
  *v = hv;
  if (__ldg(al.needs + tri) == 0) return false;
  // the UV: st[0]·(1 − u − v) + st[1]·u + st[2]·v
  const float* s = al.st + (int64_t)tri * 6;
  const float w0 = __fsub_rn(__fsub_rn(1.0f, hu), hv);
  const float su = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(s + 0), w0), __fmul_rn(__ldg(s + 2), hu)),
                             __fmul_rn(__ldg(s + 4), hv));
  const float sv = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(s + 1), w0), __fmul_rn(__ldg(s + 3), hu)),
                             __fmul_rn(__ldg(s + 5), hv));
  // the texel: GL_REPEAT wrap in the texture's rect, texnum clamped to the
  // table; (u·w) truncated toward zero (a NaN gives 0, as torch's cast)
  const int id = min(max(__ldg(al.texnum + tri), 0), al.ntex - 1);
  const int* r = al.rect + 4 * id;
  const int w = max(__ldg(r + 2), 1), h = max(__ldg(r + 3), 1);
  const float fu = __fsub_rn(su, floorf(su)), fv = __fsub_rn(sv, floorf(sv));
  const int cx = __float2int_rz(__fmul_rn(fu, __int2float_rn(w)));
  const int cy = __float2int_rz(__fmul_rn(fv, __int2float_rn(h)));
  const int tx = __ldg(r + 0) + min(max(cx, 0), w - 1), ty = __ldg(r + 1) + min(max(cy, 0), h - 1);
  const float alpha = __ldg(al.texels + ((int64_t)ty * al.width + tx) * 4 + 3);
  return alpha < kAlphaThreshold;
}

// ---- asynchronous copies (the walk's tile ring, K8's) and ordered keys ----

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}

// one arrival that also announces `bytes` of copies to come
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from 16-byte-aligned global memory to shared
// memory, completion counted on `bar`
__device__ __forceinline__ void bulk_copy(void* smem_dst, const void* gmem_src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(smem_dst)),
      "l"(gmem_src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// order-preserving unsigned image of a float (a < b <=> key(a) < key(b));
// -0 and +0 share one
__device__ __forceinline__ unsigned float_key(float t) {
  const unsigned u = __float_as_uint(__fadd_rn(t, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

}  // namespace mq
