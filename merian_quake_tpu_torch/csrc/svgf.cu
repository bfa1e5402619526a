// The surface SVGF on Hopper: the temporal step in one kernel, each
// edge-aware à-trous pass in one kernel.
//
// Replaces no TPU kernel: the JAX package's SVGF (merian_quake_tpu/post/
// svgf.py) is jnp code that XLA fuses. The port's torch version
// (merian_quake_tpu_torch/post/svgf.py: temporal_reference and
// atrous_iteration_reference, its plain version and CPU path) runs as
// about 4,000 gathers and elementwise launches a 1080p frame, each
// streaming a whole image through device memory to do a few operations.
// Contract (post/svgf.py: svgf_temporal, svgf_atrous):
//   svgf_temporal in: this frame's irradiance (rgb), second moment, motion
//     vectors, normals, linear depth and depth gradients; the history
//     (irr, moments, history_len, normal, linear_z), each an image whose
//     pixels lie a fixed number of floats apart (a contiguous image or a
//     channel slice of one). out: the new irr f32[H, W, 3], moments
//     f32[H, W, 2] and history_len f32[H, W]; the filter's records
//     rec f32[H, W, 4] (integrated irradiance, variance) and geo f32[H, W,
//     4] (normal, linear depth).
//   svgf_atrous<step> in: rec, geo, the depth gradients; out: the next
//     pass's rec, or on the last pass rgb f32[H, W, 3] = filtered
//     irradiance × max(albedo, 0).
// Exactness: each kernel computes what the torch path computes on the
// card, in its order: every add, multiply and division rounded on its own
// (__fadd_rn / __fmul_rn / __fdiv_rn, as each torch elementwise kernel
// rounds one operation), expf, powf and sqrtf as torch's exp, pow and sqrt
// call them, each Python scalar rounded to float as torch rounds it, NaN
// through clamp_min and maximum as torch passes it. Two rules of torch on
// the card, which its CPU kernels do not share, are followed: a division
// by a Python scalar is a multiply by the scalar's float reciprocal
// (l2 / 9.0), and the sum over a 3-channel last dimension adds channels 0
// and 2 first (two threads a row in torch's reduction), then channel 1.
//
// What bounds it on this card: operations. A pass reads two float4 a tap,
// served by the cache, and writes 16 B a pixel (about 108 MB a 1080p pass
// with its inputs, 0.03 ms at 3.35 TB/s); each of its 25 taps a pixel
// costs a powf, two expf and two IEEE divisions, about 150 instructions:
// some 8e9 instructions a 1080p pass.
//
// What the design does about it:
//   - one thread a pixel, and every image of the step read once into
//     registers: a tap is two 16-byte loads of the records instead of a
//     9-channel gather through device memory, and no intermediate image is
//     written;
//   - the luminance of a tap is recomputed from its rgb (5 operations)
//     rather than stored, and the 3×3 luminance moments of the temporal
//     step read a shared-memory tile with a 1-pixel halo;
//   - steps 1 and 2 read their taps from a shared-memory tile with a
//     2·step halo (blocks of 32×8), larger steps through the read-only
//     cache (blocks of 64×4, along rows). In a sweep on the card the
//     tile was 3% faster than any block through the cache at steps 1-2,
//     and three block shapes through the cache were within 1% of each
//     other at steps 4-16 (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp_min and torch.maximum: a NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

// ops/color.py::yuv_luminance, its scalars rounded to float
__device__ __forceinline__ float luminance(float r, float g, float b) {
  return add(add(mul(r, (float)0.2126), mul(g, (float)0.7152)), mul(b, (float)0.0722));
}

// (a * b).sum(-1) over 3 channels, in the order of torch's reduction on the card
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1, float b2) {
  return add(add(mul(a0, b0), mul(a2, b2)), mul(a1, b1));
}

// an image whose pixel (y, x) starts at p[(y * W + x) * ps]
struct Img {
  const float* p;
  int ps;
  __device__ __forceinline__ float at(int64_t pix, int c = 0) const {
    return __ldg(p + pix * ps + c);
  }
};

constexpr int kTX = 32, kTY = 8;  // the temporal step's block

__global__ void __launch_bounds__(kTX * kTY) svgf_temporal(
    Img irr, Img mom_in, Img mv, Img normal, Img lz, Img zg, Img h_irr, Img h_mom, Img h_len,
    Img h_n, Img h_z, int H, int W, float alpha_irr, float alpha_mom, float n_cos,
    float z_reject, float* __restrict__ out_irr, float* __restrict__ out_mom,
    float* __restrict__ out_len, float4* __restrict__ rec, float4* __restrict__ geo) {
  // this block's luminance with a 1-pixel halo, edge-clamped (_shift)
  __shared__ float tile[kTY + 2][kTX + 2];
  const int bx = blockIdx.x * kTX, by = blockIdx.y * kTY;
  for (int i = threadIdx.y * kTX + threadIdx.x; i < (kTY + 2) * (kTX + 2); i += kTX * kTY) {
    const int ty = i / (kTX + 2), tx = i % (kTX + 2);
    const int64_t q = (int64_t)clampi(by - 1 + ty, H - 1) * W + clampi(bx - 1 + tx, W - 1);
    tile[ty][tx] = luminance(irr.at(q, 0), irr.at(q, 1), irr.at(q, 2));
  }
  __syncthreads();
  const int x = bx + threadIdx.x, y = by + threadIdx.y;
  if (x >= W || y >= H) return;
  const int64_t p = (int64_t)y * W + x;
  const float c[3] = {irr.at(p, 0), irr.at(p, 1), irr.at(p, 2)};
  const float lum = tile[threadIdx.y + 1][threadIdx.x + 1];
  const float m_in = mom_in.at(p);
  const float n0 = normal.at(p, 0), n1 = normal.at(p, 1), n2 = normal.at(p, 2);
  const float z = lz.at(p);
  const float z_scale = add(add(fabsf(zg.at(p, 0)), fabsf(zg.at(p, 1))), (float)1e-2);

  // post/accumulate.py::reproject: the history bilinearly at pixel + mv
  const float sx = add((float)x, mv.at(p, 0)), sy = add((float)y, mv.at(p, 1));
  bool valid = sx >= 0.0f && sx <= (float)(W - 1) && sy >= 0.0f && sy <= (float)(H - 1);
  float p_irr[3], p_mom[2], p_len = 0.0f;
  if (valid) {
    const int cx = (int)floorf(sx), cy = (int)floorf(sy);
    const int cx1 = min(cx + 1, W - 1), cy1 = min(cy + 1, H - 1);
    const float ax = sub(sx, (float)cx), ay = sub(sy, (float)cy);
    const float bx1 = sub(1.0f, ax), by1 = sub(1.0f, ay);
    const int64_t q00 = (int64_t)cy * W + cx, q01 = (int64_t)cy * W + cx1;
    const int64_t q10 = (int64_t)cy1 * W + cx, q11 = (int64_t)cy1 * W + cx1;
    auto lerp = [&](const Img& h, int ch) {
      const float top = add(mul(h.at(q00, ch), bx1), mul(h.at(q01, ch), ax));
      const float bot = add(mul(h.at(q10, ch), bx1), mul(h.at(q11, ch), ax));
      return add(mul(top, by1), mul(bot, ay));
    };
    // the validity gates (merian-shaders/reprojection.glsl)
    const bool n_ok = dot3(lerp(h_n, 0), lerp(h_n, 1), lerp(h_n, 2), n0, n1, n2) > n_cos;
    const float z_den = add(add(z_scale, mul(fabsf(z), (float)1e-2)), (float)1e-4);
    const bool z_ok = div(fabsf(sub(lerp(h_z, 0), z)), z_den) < z_reject;
    valid = n_ok && z_ok;
    if (valid) {
      for (int ch = 0; ch < 3; ++ch) p_irr[ch] = lerp(h_irr, ch);
      for (int ch = 0; ch < 2; ++ch) p_mom[ch] = lerp(h_mom, ch);
      p_len = lerp(h_len, 0);
    }
  }

  const float hist = valid ? add(p_len, 1.0f) : 1.0f;
  const float inv = div(1.0f, hist);  // 1.0 / hist: torch's reciprocal
  const float a_i = clamp_min(inv, alpha_irr), a_m = clamp_min(inv, alpha_mom);
  float o[3];
  for (int ch = 0; ch < 3; ++ch) {
    o[ch] = valid ? add(p_irr[ch], mul(sub(c[ch], p_irr[ch]), a_i)) : c[ch];
    out_irr[p * 3 + ch] = o[ch];
  }
  const float m0 = valid ? add(p_mom[0], mul(sub(lum, p_mom[0]), a_m)) : lum;
  const float m1 = valid ? add(p_mom[1], mul(sub(m_in, p_mom[1]), a_m)) : m_in;
  out_mom[p * 2] = m0;
  out_mom[p * 2 + 1] = m1;
  out_len[p] = hist;

  const float var_t = clamp_min(sub(m1, mul(m0, m0)), 0.0f);
  // the spatial variance of short histories: 3×3 luminance moments
  float l1 = 0.0f, l2 = 0.0f;
  for (int dy = 0; dy < 3; ++dy) {
    for (int dx = 0; dx < 3; ++dx) {
      const float s = tile[threadIdx.y + dy][threadIdx.x + dx];
      l1 = add(l1, s);
      l2 = add(l2, mul(s, s));
    }
  }
  const float ninth = 1.0f / 9.0f;  // torch on the card: x / 9.0 is x * float(1 / 9)
  const float mean = mul(l1, ninth);
  const float var_s = clamp_min(sub(mul(l2, ninth), mul(mean, mean)), 0.0f);
  const float variance = hist < 4.0f ? maximum(var_t, var_s) : var_t;
  rec[p] = make_float4(o[0], o[1], o[2], variance);
  geo[p] = make_float4(n0, n1, n2, z);
}

// the à-trous kernel's 1-D taps: 1/16, 1/4, 3/8, 1/4, 1/16
__device__ __forceinline__ float h1(int i) {
  return i == 2 ? 0.375f : ((i & 1) ? 0.25f : 0.0625f);
}

// one à-trous pass. TS: 0 reads every tap through the read-only cache; 1
// or 2 (= step) first stages the block's records with a 2·step halo in
// shared memory
template <int BX, int BY, int TS>
__global__ void __launch_bounds__(BX * BY) svgf_atrous(
    const float4* __restrict__ rec, const float4* __restrict__ geo, Img zg, int H, int W,
    int step, float sigma_z, float sigma_n, float sigma_l, float4* __restrict__ out,
    float* __restrict__ rgb, Img albedo) {
  constexpr int TW = TS ? BX + 4 * TS : 1, TH = TS ? BY + 4 * TS : 1;
  __shared__ float4 s_rec[TH * TW], s_geo[TH * TW];
  const int bx = blockIdx.x * BX, by = blockIdx.y * BY;
  const int x = bx + threadIdx.x, y = by + threadIdx.y;
  if (TS) {
    for (int i = threadIdx.y * BX + threadIdx.x; i < TH * TW; i += BX * BY) {
      const int64_t q = (int64_t)clampi(by - 2 * TS + i / TW, H - 1) * W
                        + clampi(bx - 2 * TS + i % TW, W - 1);
      s_rec[i] = __ldg(rec + q);
      s_geo[i] = __ldg(geo + q);
    }
    __syncthreads();
  }
  if (x >= W || y >= H) return;
  // the record at offset (dy, dx), edge-clamped (_shift)
  const auto rec_at = [&](int dy, int dx) {
    if (TS) return s_rec[(threadIdx.y + 2 * TS + dy) * TW + threadIdx.x + 2 * TS + dx];
    return __ldg(rec + (int64_t)clampi(y + dy, H - 1) * W + clampi(x + dx, W - 1));
  };
  const auto geo_at = [&](int dy, int dx) {
    if (TS) return s_geo[(threadIdx.y + 2 * TS + dy) * TW + threadIdx.x + 2 * TS + dx];
    return __ldg(geo + (int64_t)clampi(y + dy, H - 1) * W + clampi(x + dx, W - 1));
  };
  const int64_t p = (int64_t)y * W + x;
  const float4 c = rec_at(0, 0), g = geo_at(0, 0);
  const float lum = luminance(c.x, c.y, c.z);
  // the gaussian-prefiltered variance; its weights sum to 1, and x / 1.0
  // is x * 1.0f on the card
  float gv = 0.0f;
  for (int dy = -1; dy <= 1; ++dy) {
    for (int dx = -1; dx <= 1; ++dx) {
      const float w = (dy == 0 ? 0.25f : 0.125f) * (dx == 0 ? 0.25f : 0.125f) * 4.0f;
      gv = add(gv, mul(rec_at(dy, dx).w, w));
    }
  }
  const float sl = add(mul(sqrtf(clamp_min(mul(gv, 1.0f), 0.0f)), sigma_l), (float)1e-8);
  const float z_scale = add(mul(add(fabsf(zg.at(p, 0)), fabsf(zg.at(p, 1))), (float)step),
                            (float)1e-2);
  const float zsz = mul(z_scale, sigma_z);
  float ar = 0.0f, ag = 0.0f, ab = 0.0f, av = 0.0f, aw = 0.0f;
#pragma unroll 1
  for (int iy = 0; iy < 5; ++iy) {
#pragma unroll
    for (int ix = 0; ix < 5; ++ix) {
      const int dy = iy - 2, dx = ix - 2, d = abs(dy) + abs(dx);
      const float4 q = rec_at(dy * step, dx * step), gq = geo_at(dy * step, dx * step);
      const float w_n = powf(clamp_min(dot3(g.x, g.y, g.z, gq.x, gq.y, gq.z), 0.0f), sigma_n);
      // abs(dy) + abs(dx) + 1e-8 as a float: 1e-8, then the integer itself
      const float zd = add(mul(zsz, d == 0 ? (float)1e-8 : (float)d), (float)1e-8);
      const float w_z = expf(div(-fabsf(sub(g.w, gq.w)), zd));
      const float w_l = expf(div(-fabsf(sub(lum, luminance(q.x, q.y, q.z))), sl));
      const float w = mul(mul(mul(w_n, mul(h1(iy), h1(ix))), w_z), w_l);
      ar = add(ar, mul(q.x, w));
      ag = add(ag, mul(q.y, w));
      ab = add(ab, mul(q.z, w));
      av = add(av, mul(mul(q.w, w), w));
      aw = add(aw, w);
    }
  }
  const float cw = clamp_min(aw, (float)1e-8);
  const float o[3] = {div(ar, cw), div(ag, cw), div(ab, cw)};
  if (rgb) {
    for (int ch = 0; ch < 3; ++ch) rgb[p * 3 + ch] = mul(o[ch], clamp_min(albedo.at(p, ch), 0.0f));
  } else {
    out[p] = make_float4(o[0], o[1], o[2], div(av, clamp_min(mul(aw, aw), (float)1e-8)));
  }
}

template <int BX, int BY, int TS>
int launch_atrous(const float* rec, const float* geo, Img zg, int H, int W, int step, float sz,
                  float sn, float sl, float* out, float* rgb, Img albedo, cudaStream_t stream) {
  const dim3 block(BX, BY), grid((W + BX - 1) / BX, (H + BY - 1) / BY);
  svgf_atrous<BX, BY, TS><<<grid, block, 0, stream>>>(
      reinterpret_cast<const float4*>(rec), reinterpret_cast<const float4*>(geo), zg, H, W, step,
      sz, sn, sl, reinterpret_cast<float4*>(out), rgb, albedo);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`, does
// not synchronise, allocates nothing, and returns cudaGetLastError() (0 =
// launched). Each image is (pointer, pixel stride in floats); rec, geo and
// out are 16-byte aligned f32[H, W, 4].
extern "C" int mq_svgf_temporal(
    const float* irr, int irr_ps, const float* mom_in, int mom_ps, const float* mv, int mv_ps,
    const float* normal, int n_ps, const float* lz, int lz_ps, const float* zg, int zg_ps,
    const float* h_irr, int h_irr_ps, const float* h_mom, int h_mom_ps, const float* h_len,
    int h_len_ps, const float* h_n, int h_n_ps, const float* h_z, int h_z_ps, int H, int W,
    float alpha_irr, float alpha_mom, float n_cos, float z_reject, float* out_irr, float* out_mom,
    float* out_len, float* rec, float* geo, void* stream) {
  const dim3 block(kTX, kTY), grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY);
  svgf_temporal<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      Img{irr, irr_ps}, Img{mom_in, mom_ps}, Img{mv, mv_ps}, Img{normal, n_ps}, Img{lz, lz_ps},
      Img{zg, zg_ps}, Img{h_irr, h_irr_ps}, Img{h_mom, h_mom_ps}, Img{h_len, h_len_ps},
      Img{h_n, h_n_ps}, Img{h_z, h_z_ps}, H, W, alpha_irr, alpha_mom, n_cos, z_reject, out_irr,
      out_mom, out_len, reinterpret_cast<float4*>(rec), reinterpret_cast<float4*>(geo));
  return (int)cudaGetLastError();
}

// One à-trous pass of `step` (at least 1). `rgb` null writes the next
// records to `out`; otherwise the pass is the last and writes rgb =
// filtered × max(albedo, 0).
extern "C" int mq_svgf_atrous(const float* rec, const float* geo, const float* zg, int zg_ps,
                              int H, int W, int step, float sigma_z, float sigma_n,
                              float sigma_l, float* out, float* rgb, const float* albedo,
                              int albedo_ps, void* stream) {
  const Img g{zg, zg_ps}, a{albedo, albedo_ps};
  const auto s = static_cast<cudaStream_t>(stream);
  if (step == 1)
    return launch_atrous<32, 8, 1>(rec, geo, g, H, W, 1, sigma_z, sigma_n, sigma_l, out, rgb, a, s);
  if (step == 2)
    return launch_atrous<32, 8, 2>(rec, geo, g, H, W, 2, sigma_z, sigma_n, sigma_l, out, rgb, a, s);
  return launch_atrous<64, 4, 0>(rec, geo, g, H, W, step, sigma_z, sigma_n, sigma_l, out, rgb, a,
                                 s);
}
