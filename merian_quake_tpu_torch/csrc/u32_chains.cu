// The u32 RNG and hash-grid chains on Hopper, each in one launch: the
// pixel seed, a run of k xorshift32 draws, a hash-grid cell selection and
// the light-cache lookup.
//
// Replaces no TPU kernel: the JAX package computes these chains in jnp
// uint32 arithmetic that XLA fuses (merian_quake_tpu/ops/rng.py,
// ops/hashgrid.py). torch has no u32 shifts or adds on every device, so
// the port's torch versions (the plain versions and CPU path:
// ops/rng.py::seed_pixel_reference and uniforms_reference,
// render/mcpg/grids.py::adaptive_cell_reference, static_cell_reference and
// light_cache_cell_reference, render/mcpg/light_cache.py::lookup_reference)
// hold each u32 value in int64 and mask it back to 32 bits after every
// multiply, add and shift: about 6 launches a multiply, 9 an xorshift step,
// ~85 a pixel seed and ~160-260 a cell, each streaming every lane through
// device memory for one operation.
// Contract, per lane, in the torch path's order:
//   - mq_seed_pixel (ops/rng.py::seed_pixel): pcg4d over (px, py, frame,
//     seed), each a u32 a lane (int32 or int64 values by their low 32
//     bits, at a stride) or one value for all lanes; lane 0 of the hash,
//     0 replaced by 0x9E3779B9. out: int64[n].
//   - mq_uniforms (ops/rng.py::uniforms): k xorshift32 steps, each giving
//     the float state · 2^-32. out: the state int64[n], u f32[n, k].
//   - mq_grid_cell (render/mcpg/grids.py::cell): the cell of position p on
//     one grid with its draws: adaptive (the level offset, trilinear
//     jitter, the slot with the normal's bucket and the level, the 16-bit
//     hash with the level; the target level given or from the camera),
//     static (jitter at a fixed width, the slot past the adaptive grid's)
//     or the light cache (jitter at a given float level). out: the state,
//     the slot and the hash, int64[n] each.
//   - mq_lc_lookup (render/mcpg/light_cache.py::lookup): the light cache's
//     cell at the level from the camera (or a given one), then its row of
//     the packed table (i32[L, 5]: hash, irradiance as float bits, N; row
//     0 on a dead lane), kept where the stored hash matches and the
//     irradiance is finite, else zero. out: the state int64[n], irradiance
//     f32[n, 3], N i32[n].
//   u32 values are written as int64 in [0, 2^32), as the torch path holds
//   them. f32[n, 3] inputs are read at their row and column strides.
// Exactness: bit for bit the torch path on the card, by the rules of
// csrc/hash_grid.cuh (the arithmetic it shares with csrc/mcpg_draw.cu).
//
// What bounds it on this card: bytes. A lane moves 8-72 bytes (the light
// cache's lookup a random 20-byte row besides), against a few dozen to a
// few hundred integer operations: at 4 M lanes every launch is a few tens
// of microseconds of memory traffic.
//
// What the design does about it: one thread a lane with the state in
// registers as native uint32_t, every input read once and every output
// written once; no shared memory, no synchronization, nothing allocated.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_grid.cuh"

namespace {

using namespace mq;

constexpr int kBlock = 256;

enum Grid { kAdaptive = 0, kStatic = 1, kLightCache = 2 };

// one operand of the pixel seed: a u32 a lane, taken by the low 32 bits of
// an int32 (wide 0) or int64 (wide 1) at a stride, or (p null) one value
struct Operand {
  const void* p;
  int64_t stride;
  uint32_t value;
  int wide;
};

__device__ __forceinline__ uint32_t operand(const Operand& o, int64_t i) {
  if (o.p == nullptr) return o.value;
  const int64_t j = i * o.stride;
  return o.wide ? (uint32_t)__ldg(static_cast<const long long*>(o.p) + j)
                : (uint32_t)__ldg(static_cast<const int*>(o.p) + j);
}

// lane i's row of an f32[n, 3] input at strides (s0, s1)
__device__ __forceinline__ void row3(const float* p, int64_t i, int64_t s0, int64_t s1,
                                     float* out) {
  const float* q = p + i * s0;
  for (int j = 0; j < 3; ++j) out[j] = __ldg(q + j * s1);
}

__device__ __forceinline__ int64_t lane() {
  return (int64_t)blockIdx.x * kBlock + threadIdx.x;
}

__global__ void __launch_bounds__(kBlock) seed_pixel(Operand px, Operand py, Operand fr,
                                                     Operand sd, int64_t n, int64_t* out) {
  const int64_t i = lane();
  if (i >= n) return;
  // ops/rng.py::pcg4d: the LCG step, a mix, the xor-shift, a mix (of
  // whose lanes seed_pixel keeps x)
  uint32_t x = operand(px, i) * 1664525u + 1013904223u;
  uint32_t y = operand(py, i) * 1664525u + 1013904223u;
  uint32_t z = operand(fr, i) * 1664525u + 1013904223u;
  uint32_t w = operand(sd, i) * 1664525u + 1013904223u;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  w ^= w >> 16;
  x += y * w;
  // the xorshift32 fixed point at 0 is avoided
  out[i] = x == 0u ? (int64_t)0x9E3779B9u : (int64_t)x;
}

__global__ void __launch_bounds__(kBlock) uniforms(const int64_t* __restrict__ state, int64_t n,
                                                   int k, int64_t* __restrict__ state_out,
                                                   float* __restrict__ u) {
  const int64_t i = lane();
  if (i >= n) return;
  uint32_t s = (uint32_t)__ldg(reinterpret_cast<const long long*>(state) + i);
  float* o = u + i * k;
  for (int j = 0; j < k; ++j) o[j] = uniform(s);
  state_out[i] = (int64_t)s;
}

struct Cell {
  int64_t n;
  int grid;
  Level level;      // the adaptive grid's or the light cache's level scale
  float inv_width;  // the static grid: 1 / f32(mc_static_width), in f32
  uint32_t size, offset;
  int tile_bits;
  int64_t pos_s0, pos_s1, nrm_s0, nrm_s1;
};

// lane i's cell on P's grid: its slot and hash, the state advanced past
// the cell's draws
__device__ __forceinline__ void select_cell(const Cell& P, int64_t i, uint32_t& s,
                                            const float* pos, const float* normal,
                                            const float* cam_x, const float* level,
                                            uint32_t& buf, uint32_t& hash) {
  float p[3];
  row3(pos, i, P.pos_s0, P.pos_s1, p);
  if (P.grid == kStatic) {
    static_cell(s, P.inv_width, p, P.size, P.offset, P.tile_bits, buf, hash);
    return;
  }
  float nrm[3];
  row3(normal, i, P.nrm_s0, P.nrm_s1, nrm);
  const uint32_t qn = quantize_normal(nrm);
  float lv;
  if (level != nullptr) {
    lv = __ldg(level + i);
  } else {
    const float cam[3] = {__ldg(cam_x), __ldg(cam_x + 1), __ldg(cam_x + 2)};
    lv = target_level(P.level, cam, p);
  }
  if (P.grid == kAdaptive) {
    adaptive_cell(s, P.level, lv, p, qn, P.size, P.tile_bits, buf, hash);
  } else {
    light_cache_cell(s, P.level, lv, p, qn, P.size, P.tile_bits, buf, hash);
  }
}

__global__ void __launch_bounds__(kBlock) grid_cell(
    Cell P, const int64_t* __restrict__ rng, const float* __restrict__ pos,
    const float* __restrict__ normal, const float* __restrict__ cam_x,
    const float* __restrict__ level, int64_t* __restrict__ rng_out,
    int64_t* __restrict__ buf_out, int64_t* __restrict__ hash_out) {
  const int64_t i = lane();
  if (i >= P.n) return;
  uint32_t s = (uint32_t)__ldg(reinterpret_cast<const long long*>(rng) + i);
  uint32_t buf, hash;
  select_cell(P, i, s, pos, normal, cam_x, level, buf, hash);
  rng_out[i] = (int64_t)s;
  buf_out[i] = (int64_t)buf;
  hash_out[i] = (int64_t)hash;
}

__global__ void __launch_bounds__(kBlock) lc_lookup(
    Cell P, const int64_t* __restrict__ rng, const float* __restrict__ pos,
    const float* __restrict__ normal, const float* __restrict__ cam_x,
    const float* __restrict__ level, const uint8_t* __restrict__ dead,
    const int* __restrict__ table, int64_t* __restrict__ rng_out, float* __restrict__ irr_out,
    int32_t* __restrict__ n_out) {
  const int64_t i = lane();
  if (i >= P.n) return;
  uint32_t s = (uint32_t)__ldg(reinterpret_cast<const long long*>(rng) + i);
  uint32_t buf, hash;
  select_cell(P, i, s, pos, normal, cam_x, level, buf, hash);
  const int64_t r = (dead != nullptr && dead[i] != 0) ? 0 : (int64_t)buf;
  const int* row = table + r * 5;
  const float irr[3] = {__int_as_float(__ldg(row + 1)), __int_as_float(__ldg(row + 2)),
                        __int_as_float(__ldg(row + 3))};
  const bool ok = (uint32_t)__ldg(row) == hash && isfinite(irr[0]) && isfinite(irr[1])
                  && isfinite(irr[2]);
  for (int j = 0; j < 3; ++j) irr_out[i * 3 + j] = ok ? irr[j] : 0.0f;
  n_out[i] = ok ? __ldg(row + 4) : 0;
  rng_out[i] = (int64_t)s;
}

int blocks(int64_t n) { return (int)((n + kBlock - 1) / kBlock); }

Cell cell_params(int64_t n, int grid, float tan2, float min_w, float inv_min_w, float steps,
                 float inv_steps, float inv_log_p, float power, float inv_width, unsigned size,
                 unsigned offset, int tile_bits, int64_t pos_s0, int64_t pos_s1, int64_t nrm_s0,
                 int64_t nrm_s1) {
  Cell P;
  P.n = n;
  P.grid = grid;
  P.level = {tan2, min_w, inv_min_w, steps, inv_steps, inv_log_p, power};
  P.inv_width = inv_width;
  P.size = size;
  P.offset = offset;
  P.tile_bits = tile_bits;
  P.pos_s0 = pos_s0;
  P.pos_s1 = pos_s1;
  P.nrm_s0 = nrm_s0;
  P.nrm_s1 = nrm_s1;
  return P;
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// (0 = launched), or cudaErrorInvalidValue for arguments it cannot take.

extern "C" int mq_seed_pixel(const void* px, int64_t px_stride, unsigned px_value, int px_wide,
                             const void* py, int64_t py_stride, unsigned py_value, int py_wide,
                             const void* frame, int64_t frame_stride, unsigned frame_value,
                             int frame_wide, const void* seed, int64_t seed_stride,
                             unsigned seed_value, int seed_wide, int64_t n, int64_t* out,
                             void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  seed_pixel<<<blocks(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      {px, px_stride, px_value, px_wide}, {py, py_stride, py_value, py_wide},
      {frame, frame_stride, frame_value, frame_wide}, {seed, seed_stride, seed_value, seed_wide},
      n, out);
  return (int)cudaGetLastError();
}

extern "C" int mq_uniforms(const int64_t* state, int64_t n, int k, int64_t* state_out, float* u,
                           void* stream) {
  if (n < 0 || k < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  uniforms<<<blocks(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(state, n, k, state_out,
                                                                        u);
  return (int)cudaGetLastError();
}

extern "C" int mq_grid_cell(const int64_t* rng, const float* pos, int64_t pos_s0, int64_t pos_s1,
                            const float* normal, int64_t nrm_s0, int64_t nrm_s1,
                            const float* cam_x, const float* level, int64_t n, int grid,
                            float tan2, float min_w, float inv_min_w, float steps,
                            float inv_steps, float inv_log_p, float power, float inv_width,
                            unsigned size, unsigned offset, int tile_bits, int64_t* rng_out,
                            int64_t* buf_out, int64_t* hash_out, void* stream) {
  if (n < 0 || grid < kAdaptive || grid > kLightCache || size == 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  grid_cell<<<blocks(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      cell_params(n, grid, tan2, min_w, inv_min_w, steps, inv_steps, inv_log_p, power, inv_width,
                  size, offset, tile_bits, pos_s0, pos_s1, nrm_s0, nrm_s1),
      rng, pos, normal, cam_x, level, rng_out, buf_out, hash_out);
  return (int)cudaGetLastError();
}

extern "C" int mq_lc_lookup(const int64_t* rng, const float* pos, int64_t pos_s0, int64_t pos_s1,
                            const float* normal, int64_t nrm_s0, int64_t nrm_s1,
                            const float* cam_x, const float* level, const uint8_t* dead,
                            const int32_t* table, int64_t n, float tan2, float min_w,
                            float inv_min_w, float steps, float inv_steps, float inv_log_p,
                            float power, unsigned size, int tile_bits, int64_t* rng_out,
                            float* irr, int32_t* n_out, void* stream) {
  if (n < 0 || size == 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  lc_lookup<<<blocks(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      cell_params(n, kLightCache, tan2, min_w, inv_min_w, steps, inv_steps, inv_log_p, power,
                  0.0f, size, 0u, tile_bits, pos_s0, pos_s1, nrm_s0, nrm_s1),
      rng, pos, normal, cam_x, level, dead, table, rng_out, irr, n_out);
  return (int)cudaGetLastError();
}
