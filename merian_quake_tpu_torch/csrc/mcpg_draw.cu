// MCPG's guide-state draws on Hopper: the K-draw reservoir loop of a
// surface bounce segment or a volume sample in one kernel.
//
// Replaces no TPU kernel: the JAX package's draw loop (merian_quake_tpu/
// render/mcpg/surface.py and volume.py) is jnp code that XLA fuses. The
// port's torch version (merian_quake_tpu_torch/render/mcpg/draw.py:
// draw_states_reference, its plain version and CPU path) runs as about
// 2,100-2,200 gathers, int64 u32 emulations and elementwise launches a
// call, each streaming every lane through device memory to do one
// operation.
// Contract (render/mcpg/draw.py: draw_states): per lane, in the torch
// path's order,
//   - a fresh chain (one draw: its id) as the reservoir's first winner;
//   - the adaptive grid's target level at the lookup position;
//   - for each of K draws, the stratified slot mode (the first
//     n_adaptive adaptive, those from n_mixed_end on static, between them
//     one slot that draws both cells and picks the adaptive one when a
//     uniform is below frac): the adaptive cell (level offset -log2(1-u),
//     trilinear jitter, hashes with the quantized normal and the level)
//     and/or the static cell, the 32-byte row of the packed draw table
//     (row 0 on a dead lane), its finalize (tombstone and hash test, the
//     hemisphere test on static draws where asked, the zero reprojection),
//     the reservoir's draw and select, and the draw's vMF lobe.
//   in: the RNG state (u32 values in int64), lookup position, position and
//     normal (f32[n, 3], contiguous), an optional dead mask
//     (bool), the camera position and the game time (device f32), the
//     table (i32[S, 8]: w_tgt(3), sum_w, w_cos as float bits, id, N, hash).
//   out: the RNG state; the winner's id, w_tgt, sum_w, w_cos, N and hash;
//     its row (-1 where the fresh chain stayed), the score sum; each
//     draw's mu f32[K, n, 3], kappa, sum_w f32[K, n] and N i32[K, n].
// Exactness: bit for bit the torch path on the card, by the rules of
// csrc/hash_grid.cuh, which holds the RNG, the hashes and the cell
// selection this kernel shares with csrc/u32_chains.cu. Besides: a Python
// scalar divided by a tensor is torch's reciprocal times the scalar, on
// both devices.
//
// What bounds it on this card: the row gathers and the integer work. A
// lane reads 45 bytes of its own and K random 32-byte rows of a table of
// up to 1.07 GB, and writes 60 + 24·K bytes; the hashes and the xorshift
// draws are some 300 integer operations a draw.
//
// What the design does about it:
//   - one thread a lane, the RNG and hash state as native uint32_t in
//     registers (the torch path emulates u32 in int64 with masks and split
//     multiplies, a pass over every lane each step);
//   - no RNG draw depends on a gathered row, so the draws go in chunks of
//     kChunk: first every slot's cell, row and uniforms, then the chunk's
//     rows loaded back to back (two 16-byte loads each, all in flight),
//     then the finalize, the reservoir and the lobes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_grid.cuh"

namespace {

using namespace mq;

constexpr int kChunk = 8;       // draws whose rows are in flight together
constexpr int kMaxDraws = 16;   // the most draws a call takes
constexpr int kBlock = 128;

struct Params {
  int n, K, n_adaptive, n_mixed_end, hemisphere, tile_bits;
  float frac;         // f32(K·p - int(K·p))
  Level level;        // the adaptive grid's level scale
  float inv_static_w; // 1 / f32(mc_static_width), in f32
  float prior;        // f32(dir_guide_prior)
  float kappa_max;    // f32(kappa_max)
  uint32_t adaptive_size, static_size;
};

// lane i's row of an f32[n, 3] input
__device__ __forceinline__ void row3(const float* p, int i, float* out) {
  const float* q = p + (int64_t)i * 3;
  out[0] = __ldg(q);
  out[1] = __ldg(q + 1);
  out[2] = __ldg(q + 2);
}

// grids.py::state_pos then state_dir: the unit direction from pos to the
// state's (normalized) target
__device__ __forceinline__ void state_dir(const float* w, float sum_w, const float* pos,
                                          float* dir, float* sp) {
  const float den = sum_w == 0.0f ? 1.0f : sum_w;
  float v[3];
  for (int j = 0; j < 3; ++j) {
    sp[j] = sum_w > 0.0f ? div(w[j], den) : w[j];
    v[j] = sub(sp[j], pos[j]);
  }
  const float nrm = clamp_min(__fsqrt_rn(clamp_min(sum3(mul(v[0], v[0]), mul(v[1], v[1]),
                                                        mul(v[2], v[2])), 0.0f)), 1e-20f);
  for (int j = 0; j < 3; ++j) dir[j] = div(v[j], nrm);
}

__global__ void __launch_bounds__(kBlock) mcpg_draw(
    Params P, const int64_t* __restrict__ rng_in, const float* __restrict__ lookup,
    const float* __restrict__ pos_in, const float* __restrict__ normal_in,
    const uint8_t* __restrict__ dead, const float* __restrict__ cam_x,
    const float* __restrict__ cl_time, const int4* __restrict__ table,
    int64_t* __restrict__ rng_out, int64_t* __restrict__ win_id, float* __restrict__ win_w,
    float* __restrict__ win_sum_w, float* __restrict__ win_w_cos, int32_t* __restrict__ win_n,
    int64_t* __restrict__ win_hash, int64_t* __restrict__ win_buf,
    float* __restrict__ score_out, float* __restrict__ d_mu, float* __restrict__ d_kappa,
    float* __restrict__ d_sum_w, int32_t* __restrict__ d_n) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= P.n) return;
  uint32_t s = (uint32_t)rng_in[i];
  float lp[3], pos[3], nrm[3];
  row3(lookup, i, lp);
  row3(pos_in, i, pos);
  row3(normal_in, i, nrm);
  const bool is_dead = dead != nullptr && dead[i] != 0;
  const float cl = __ldg(cl_time);

  // grids.py::adaptive_target_level at the lookup position
  const float cam[3] = {__ldg(cam_x), __ldg(cam_x + 1), __ldg(cam_x + 2)};
  const float target = target_level(P.level, cam, lp);
  const uint32_t qn = quantize_normal(nrm);

  // grids.py::new_state: the fresh chain the reservoir starts from
  uint32_t w_id;
  {
    const long long v = (long long)mul(uniform(s), 4294967296.0f);
    w_id = (uint32_t)(v > 0xFFFFFFFFll ? 0xFFFFFFFFll : v);
  }
  float w_w[3] = {0.0f, 0.0f, 0.0f}, w_sum = 0.0f, w_cos = 0.0f;
  int32_t w_n = 0;
  uint32_t w_hash = 0;
  int64_t w_buf = -1;
  float score = 0.0f;

#pragma unroll 1
  for (int k0 = 0; k0 < P.K; k0 += kChunk) {
    uint32_t row[kChunk], expect[kChunk];
    float u_res[kChunk];
    unsigned adaptive = 0;  // bit j: draw k0 + j took the adaptive cell
    // the chunk's cells and uniforms (no draw depends on a row)
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int k = k0 + j;
      if (k >= P.K) break;
      const bool a_mode = k < P.n_adaptive, s_mode = k >= P.n_mixed_end;
      uint32_t a_buf = 0, a_hash = 0, s_buf = 0, s_hash = 0;
      if (!s_mode) {
        adaptive_cell(s, P.level, target, lp, qn, P.adaptive_size, P.tile_bits, a_buf, a_hash);
      }
      if (!a_mode) {
        static_cell(s, P.inv_static_w, lp, P.static_size, P.adaptive_size, P.tile_bits, s_buf,
                    s_hash);
      }
      bool ad = a_mode;
      if (!a_mode && !s_mode) ad = uniform(s) < P.frac;
      row[j] = ad ? a_buf : s_buf;
      expect[j] = ad ? a_hash : s_hash;
      adaptive |= (ad ? 1u : 0u) << j;
      u_res[j] = uniform(s);
    }
    // the chunk's rows, all in flight
    int4 lo[kChunk], hi[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (k0 + j >= P.K) break;
      const int64_t r = is_dead ? 0 : (int64_t)row[j];
      lo[j] = __ldg(table + 2 * r);
      hi[j] = __ldg(table + 2 * r + 1);
    }
    // finalize, reservoir, lobes
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int k = k0 + j;
      if (k >= P.K) break;
      const float w[3] = {__int_as_float(lo[j].x), __int_as_float(lo[j].y),
                          __int_as_float(lo[j].z)};
      const float sw = __int_as_float(lo[j].w);
      const float wc = __int_as_float(hi[j].x);
      const int32_t n_k = hi[j].z;
      const uint32_t h_k = (uint32_t)hi[j].w;
      // grids.py::finalize_load
      bool invalid = sw < 0.0f || h_k != expect[j];
      float dir[3], sp[3];
      if (P.hemisphere && !((adaptive >> j) & 1u)) {
        state_dir(w, sw, pos, dir, sp);
        invalid = invalid || sum3(mul(nrm[0], dir[0]), mul(nrm[1], dir[1]),
                                  mul(nrm[2], dir[2])) <= 0.0f;
      }
      const float sum_w = invalid ? 0.0f : sw;
      // w_tgt + (sum_w · (cl_time - T)) · mv with T and mv zero
      const float shift = mul(mul(sum_w, sub(cl, 0.0f)), 0.0f);
      const float wt[3] = {add(w[0], shift), add(w[1], shift), add(w[2], shift)};
      // the reservoir
      score = add(score, sum_w);
      if (u_res[j] < div(sum_w, score)) {
        w_id = (uint32_t)hi[j].y;
        for (int j3 = 0; j3 < 3; ++j3) w_w[j3] = wt[j3];
        w_sum = sum_w;
        w_cos = wc;
        w_n = n_k;
        w_hash = h_k;
        w_buf = (int64_t)row[j];
      }
      // grids.py::state_vmf
      state_dir(wt, sum_w, pos, dir, sp);
      const float e0 = sub(pos[0], sp[0]), e1 = sub(pos[1], sp[1]), e2 = sub(pos[2], sp[2]);
      const float d2 = sum3(mul(e0, e0), mul(e1, e1), mul(e2, e2));
      const float prior = clamp_min(mul(div(1.0f, clamp_min(d2, 1e-12f)), P.prior), 1e-4f);
      // (N * N) in int32 as torch multiplies it (wrapping), then as a float
      const float n2 = (float)(int32_t)((uint32_t)n_k * (uint32_t)n_k);
      const float r = clamp(div(wc, sum_w == 0.0f ? 1.0f : sum_w), 0.0f, 0.9999999f);
      const float mc = clamp(div(mul(n2, r), add(n2, prior)), 0.0f, 0.9999999f);
      const float kappa = clamp_max(div(sub(mul(mc, 3.0f), mul(mul(mc, mc), mc)),
                                        sub(1.0f, mul(mc, mc))), P.kappa_max);
      const int64_t o = (int64_t)k * P.n + i;
      for (int j3 = 0; j3 < 3; ++j3) d_mu[o * 3 + j3] = dir[j3];
      d_kappa[o] = kappa;
      d_sum_w[o] = sum_w;
      d_n[o] = n_k;
    }
  }
  rng_out[i] = (int64_t)s;
  win_id[i] = (int64_t)w_id;
  for (int j3 = 0; j3 < 3; ++j3) win_w[(int64_t)i * 3 + j3] = w_w[j3];
  win_sum_w[i] = w_sum;
  win_w_cos[i] = w_cos;
  win_n[i] = w_n;
  win_hash[i] = (int64_t)w_hash;
  win_buf[i] = w_buf;
  score_out[i] = score;
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue where K is not in 1..16.
extern "C" int mq_mcpg_draw(
    const int64_t* rng_in, const float* lookup, const float* pos, const float* normal,
    const uint8_t* dead, const float* cam_x,
    const float* cl_time, const int32_t* table, int n, int K, int n_adaptive, int n_mixed_end,
    float frac, int hemisphere, float tan2, float min_w, float inv_min_w, float steps,
    float inv_steps, float inv_log_p, float power, float inv_static_w, unsigned adaptive_size,
    unsigned static_size, int tile_bits, float prior, float kappa_max, int64_t* rng_out,
    int64_t* win_id, float* win_w, float* win_sum_w, float* win_w_cos, int32_t* win_n,
    int64_t* win_hash, int64_t* win_buf, float* score, float* d_mu, float* d_kappa,
    float* d_sum_w, int32_t* d_n, void* stream) {
  if (K < 1 || K > kMaxDraws || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Params P;
  P.n = n;
  P.K = K;
  P.n_adaptive = n_adaptive;
  P.n_mixed_end = n_mixed_end;
  P.hemisphere = hemisphere;
  P.tile_bits = tile_bits;
  P.frac = frac;
  P.level = {tan2, min_w, inv_min_w, steps, inv_steps, inv_log_p, power};
  P.inv_static_w = inv_static_w;
  P.prior = prior;
  P.kappa_max = kappa_max;
  P.adaptive_size = adaptive_size;
  P.static_size = static_size;
  mcpg_draw<<<(n + kBlock - 1) / kBlock, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      P, rng_in, lookup, pos, normal, dead, cam_x, cl_time,
      reinterpret_cast<const int4*>(table), rng_out, win_id, win_w, win_sum_w, win_w_cos, win_n,
      win_hash, win_buf, score, d_mu, d_kappa, d_sum_w, d_n);
  return (int)cudaGetLastError();
}
