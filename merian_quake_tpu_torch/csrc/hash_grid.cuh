// The u32 chains of the guiding caches in native uint32_t: ops/rng.py's
// xorshift32 draws, ops/hashgrid.py's hashes and slots, and the cell
// selection of render/mcpg/grids.py (the adaptive and the static grid)
// and render/mcpg/light_cache.py. Shared by csrc/mcpg_draw.cu and
// csrc/u32_chains.cu.
//
// Exactness: bit for bit the torch path on the card. Its int64 emulation
// masks every u32 multiply, add and left shift back to 32 bits, which is
// what uint32_t arithmetic does; a signed cell index enters a hash by its
// two's-complement bits. Every float add, multiply and division is rounded
// on its own (__fadd_rn / __fmul_rn / __fdiv_rn, never contracted), sqrt is
// IEEE's, logf, log2f and powf are the functions torch's log, log2 and pow
// call, round is half to even, and a Python scalar is the float torch
// rounds it to. Rules of torch on the card that its CPU kernels do not
// share: a division by a Python scalar is a multiply by the scalar's float
// reciprocal (the wrappers pass those reciprocals), and the sum over a
// 3-element last dimension adds elements 0 and 2 first, then 1. NaN passes
// clamp_min, clamp_max and clamp as it passes torch's; a float becomes an
// int32 as torch's conversion does (truncation, saturating, NaN to 0).

#pragma once

#include <stdint.h>

namespace mq {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp_min / clamp_max / clamp with scalars: a NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// (a * b).sum(-1) over 3 elements, in the order of torch's reduction on the card
__device__ __forceinline__ float sum3(float a0, float a1, float a2) {
  return add(add(a0, a2), a1);
}

// ops/rng.py: one xorshift32 step, and the uniform it gives
__device__ __forceinline__ uint32_t xorshift(uint32_t s) {
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  return s;
}
__device__ __forceinline__ float uniform(uint32_t& s) {
  s = xorshift(s);
  return mul(__uint2float_rn(s), 2.3283064365386963e-10f);
}

// ops/hashgrid.py::_hash_coords over n coordinates
__device__ __forceinline__ uint32_t hash_coords(const uint32_t* v, int n) {
  uint32_t h = 0x9E3779B1u;
  for (int j = 0; j < n; ++j) {
    h ^= v[j] * 0x85EBCA77u;
    h = (h << 13) | (h >> 19);
    h *= 0xC2B2AE3Du;
  }
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  return h;
}

// ops/hashgrid.py::_hash2_coords, masked to its 16 bits
__device__ __forceinline__ uint32_t hash2_coords(const uint32_t* v, int n) {
  uint32_t h = 0x27220A95u;
  for (int j = 0; j < n; ++j) {
    h = (h + v[j] * 0x165667B1u) * 0x01000193u;
    h ^= h >> 17;
  }
  return h & 0xFFFFu;
}

// ops/hashgrid.py::hash_grid / hash_grid_normal_level: the slot of cell
// idx (with `extra` coordinates after it), plain or tiled
__device__ __forceinline__ uint32_t slot_of(const int* idx, const uint32_t* extra, int n_extra,
                                            uint32_t size, int tile_bits) {
  uint32_t v[5];
  if (tile_bits == 0) {
    for (int j = 0; j < 3; ++j) v[j] = (uint32_t)idx[j];
    for (int j = 0; j < n_extra; ++j) v[3 + j] = extra[j];
    return hash_coords(v, 3 + n_extra) % size;
  }
  // _tiled_slot: hash the tile, place the cell at bucket·T + its sub-coordinate
  const int mask = (1 << tile_bits) - 1;
  const uint32_t sub_lin = (uint32_t)((idx[0] & mask) | ((idx[1] & mask) << tile_bits)
                                      | ((idx[2] & mask) << (2 * tile_bits)));
  for (int j = 0; j < 3; ++j) v[j] = (uint32_t)(idx[j] >> tile_bits);
  for (int j = 0; j < n_extra; ++j) v[3 + j] = extra[j];
  const uint64_t t = 1ull << (3 * tile_bits);
  uint64_t buckets = size / t;
  if (buckets < 1) buckets = 1;
  return (uint32_t)((hash_coords(v, 3 + n_extra) % buckets) * t + sub_lin);
}

// ops/hashgrid.py::quantize_normal: the dominant axis' bucket 0..5
__device__ __forceinline__ uint32_t quantize_normal(const float* nrm) {
  const float ax = fabsf(nrm[0]), ay = fabsf(nrm[1]), az = fabsf(nrm[2]);
  const bool is_x = ax >= ay && ax >= az;
  const bool is_y = !is_x && ay >= az;
  const uint32_t axis = is_x ? 0u : (is_y ? 1u : 2u);
  const float val = is_x ? nrm[0] : (is_y ? nrm[1] : nrm[2]);
  return axis * 2u + (val < 0.0f ? 1u : 0u);
}

// The level scale of a camera-distance grid: the adaptive grid's
// (grids.py::adaptive_target_level, _adaptive_width_for_level) or the
// light cache's (grids.py::lc_level, _lc_width_for_level)
struct Level {
  float tan2;       // f32(2 · tan_alpha_half)
  float min_w;      // f32(min_width)
  float inv_min_w;  // 1 / f32(min_width), in f32
  float steps;      // f32(steps_per_unit)
  float inv_steps;  // 1 / f32(steps_per_unit), in f32
  float inv_log_p;  // 1 / f32(log of f32(power)), in f32
  float power;      // f32(power)
};

// the grid level of position p seen from cam: round(steps · log(max(tan2 ·
// |cam - p|, min_w) / min_w) / log(power))
__device__ __forceinline__ float target_level(const Level& L, const float* cam, const float* p) {
  const float d0 = sub(cam[0], p[0]), d1 = sub(cam[1], p[1]), d2 = sub(cam[2], p[2]);
  const float dist = __fsqrt_rn(clamp_min(sum3(mul(d0, d0), mul(d1, d1), mul(d2, d2)), 0.0f));
  const float width = clamp_min(mul(L.tan2, dist), L.min_w);
  return rintf(mul(mul(L.steps, logf(mul(width, L.inv_min_w))), L.inv_log_p));
}

// ops/hashgrid.py::grid_idx_interpolate at a level's width min_w ·
// power^(level / steps): floor(p / width - 0.5 + u) on three draws
__device__ __forceinline__ void jittered_cell(uint32_t& s, const Level& L, float level,
                                              const float* p, int* idx) {
  const float width = mul(L.min_w, powf(L.power, mul(level, L.inv_steps)));
  for (int j = 0; j < 3; ++j) idx[j] = (int)floorf(add(sub(div(p[j], width), 0.5f), uniform(s)));
}

// the primary slot and the 16-bit hash of cell idx at an integer level,
// with the normal's bucket qn (hash_grid_normal_level, hash2_grid_level)
__device__ __forceinline__ void level_slot(const int* idx, int level, uint32_t qn, uint32_t size,
                                           int tile_bits, uint32_t& buf, uint32_t& hash) {
  const uint32_t extra[2] = {qn, (uint32_t)level};
  buf = slot_of(idx, extra, 2, size, tile_bits);
  const uint32_t hv[4] = {(uint32_t)idx[0], (uint32_t)idx[1], (uint32_t)idx[2], (uint32_t)level};
  hash = hash2_coords(hv, 4);
}

// grids.py::adaptive_cell_reference from its target level: the level
// offset -log2(1 - u), the jittered cell, its slot and 16-bit hash
__device__ __forceinline__ void adaptive_cell(uint32_t& s, const Level& L, float target,
                                              const float* p, uint32_t qn, uint32_t size,
                                              int tile_bits, uint32_t& buf, uint32_t& hash) {
  const float u_level = uniform(s);
  const float off = floorf(-log2f(clamp_min(sub(1.0f, u_level), 1e-7f)));
  const int level = (int)add(target, off);
  int idx[3];
  jittered_cell(s, L, (float)level, p, idx);
  level_slot(idx, level, qn, size, tile_bits, buf, hash);
}

// grids.py::static_cell_reference: the jittered cell of the fixed width
// (its reciprocal inv_w), its slot past `offset` and 16-bit hash
__device__ __forceinline__ void static_cell(uint32_t& s, float inv_w, const float* p,
                                            uint32_t size, uint32_t offset, int tile_bits,
                                            uint32_t& buf, uint32_t& hash) {
  int idx[3];
  for (int j = 0; j < 3; ++j) idx[j] = (int)floorf(add(sub(mul(p[j], inv_w), 0.5f), uniform(s)));
  buf = slot_of(idx, nullptr, 0, size, tile_bits) + offset;
  const uint32_t hv[3] = {(uint32_t)idx[0], (uint32_t)idx[1], (uint32_t)idx[2]};
  hash = hash2_coords(hv, 3);
}

// grids.py::light_cache_cell_reference: the jittered cell at a (float)
// level, its slot and 16-bit hash at the level as an int32
__device__ __forceinline__ void light_cache_cell(uint32_t& s, const Level& L, float level,
                                                 const float* p, uint32_t qn, uint32_t size,
                                                 int tile_bits, uint32_t& buf, uint32_t& hash) {
  int idx[3];
  jittered_cell(s, L, level, p, idx);
  level_slot(idx, (int)level, qn, size, tile_bits, buf, hash);
}

}  // namespace mq
