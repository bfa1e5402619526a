// K6 and K7 on Hopper: the list walker. Each block of 128 rays walks its
// own near-to-far visit list (from K5, csrc/woop_keys.cu) with an exact
// horizon exit, over clusters (P = 1) or over nodes of P consecutive
// clusters (P > 1), and tests a visited cluster either per thread or, when
// few rays reach it, compacted.
//
// Replaces, in merian_quake_tpu/accel/woop.py:
//   - P = 1: the resident kernel _kernel_resident (:289) walking the list of
//     the target-key schedule (intersect_woop_packed with target_cull,
//     :1234-1257) -- K1's result fed by K5;
//   - P > 1: _kernel_resident_nodes (:488), K1's (or K2's) result through
//     one level of nodes: the list is at node level, a node gate runs once a
//     node, then K1's per-ray gate per member cluster (K6);
//   - kCompact: _intersect_tile_compact (:627), the visit of a tile that
//     only 1..`compact` rays reach, testing only those (K7), nearest hit
//     only, in the flat walk and per member of a node.
// It keeps their contract, not their TPU schedule:
//   in:  rays f32[8, n_pad] (o.xyz, d.xyz, t_min, t_max); w f32[3T, 8] in
//        K1's layout (csrc/woop_nearest.cu); padded cluster AABBs lo/hi
//        f32[nc, 3]; the list te_s f32[nb, m] (ascending) and order
//        i32[nb, m] (box ids) of each block, nb = n_pad / 128; with P > 1
//        the node boxes node_lo/hi f32[m, 3] (m = ceil(nc / P)), each the
//        min/max of its padded members; any-hit: occ_in u8[n_pad] or null.
//   out: nearest: t f32[n_pad] (3e38 on a miss), tri i32[n_pad] (-1);
//        any-hit: occluded u8[n_pad].
// The pair tests are K1's and K2's operation for operation
// (woop_common.cuh), with K1's lowest-index tie rule, so the walker's
// nearest hit is bit-equal to intersect_woop_reference and its occlusion
// equal on every ray to intersect_woop_any_reference, in any mode.
//
// The exit. Before entry j, if te_s[j] exceeds the horizon (the largest
// gate limit over the block's rays), no ray can reach that box or any later
// one, and the walk stops. That is exact because the list holds every box a
// gate could pass: K5 (slack mode) and the gates call the same slab with
// explicitly rounded operations (woop_common.cuh); the list's limit
// list_slack(t_max) is never below a gate's, list_slack(min(best, t_max))
// (nearest) or list_slack(t_max) and -inf once occluded (any-hit); a node
// box is the min/max of its padded members (no rounding), so a ray whose
// gate passes a member passes its node with an entry no later; empty boxes
// are never listed and never gated in.
//
// K7, the compacted visit. __syncthreads_count of the reaching rays decides
// it: 0 skips the cluster, more than `compact` takes K1's per-thread visit,
// otherwise the reaching rays are compacted into shared slots (warp ballot
// and popc prefix, in thread order) and all 128 threads test the count x 64
// pairs. Each pair that hits does a shared-memory atomicMin on its slot's
// 64-bit key, the order-preserving bits of t (+0 for a zero) << 32 | the
// triangle's index in the cluster: the least t, then the least index, as
// K1's rule. The slot's own thread then recomputes the winning pair (exact
// t, sign of zero included) and commits it by K1's rule against its best.
//
// What bounds it on this card: FP32 arithmetic of the pairs tested (42
// rounded multiplies and adds a nearest pair, 46 an any-hit pair; the table,
// 48 B of rows a triangle, stays in L2), as for K1. The design spends its
// effort on testing fewer pairs: K5's exact per-block list, near to far,
// the horizon exit, a node gate before P cluster gates, and K7, which tests
// count x 64 pairs instead of K1's per-thread visit of every reaching ray
// (the same pairs, but without the idle lanes of the 128-thread CTA).

#include "woop_common.cuh"

namespace {

using namespace mq;

// the largest x over the CTA, the same value in every thread (fmaxf drops a
// NaN limit: such a ray reaches nothing)
__device__ __forceinline__ float block_max(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float m = red[0];
  for (int k = 1; k < kWarps; ++k) m = fmaxf(m, red[k]);
  return m;
}

// order-preserving unsigned image of a float (a < b <=> key(a) < key(b))
__device__ __forceinline__ unsigned order_key(float t) {
  const unsigned u = __float_as_uint(__fadd_rn(t, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// kAny: occlusion (K2's test) instead of the nearest hit; kCompact: K7's
// visit for tiles that 1..compact rays reach (nearest only); kCount: add up
// per CTA the pairs tested, the tile visits and the compacted visits into
// counts[3 * CTA + 0..2] (the frame path launches instances without it).
template <bool kAny, bool kCompact, bool kCount>
__global__ void __launch_bounds__(kBlock)
woop_list_kernel(const float* __restrict__ rays, int64_t n_pad, const float4* __restrict__ w4,
                 const float* __restrict__ lo, const float* __restrict__ hi, int nc,
                 const float* __restrict__ te_s, const int* __restrict__ order, int m,
                 const float* __restrict__ node_lo, const float* __restrict__ node_hi, int P,
                 int compact, const uint8_t* __restrict__ occ_in, float* __restrict__ out_t,
                 int* __restrict__ out_tri, uint8_t* __restrict__ out_occ,
                 unsigned long long* __restrict__ counts) {
  __shared__ float4 tile[kTile];
  __shared__ float red[kWarps];
  // K7: the compacted rays (o, t_min) and (d, t_max), their winner keys, and
  // each warp's count of reaching rays
  __shared__ float4 c_o[kCompact ? kBlock : 1];
  __shared__ float4 c_d[kCompact ? kBlock : 1];
  __shared__ unsigned long long c_key[kCompact ? kBlock : 1];
  __shared__ int warp_n[kWarps];

  const int tid = threadIdx.x;
  const int64_t i = (int64_t)blockIdx.x * kBlock + tid;
  const float ox = rays[i], oy = rays[n_pad + i], oz = rays[2 * n_pad + i];
  const float dx = rays[3 * n_pad + i], dy = rays[4 * n_pad + i], dz = rays[5 * n_pad + i];
  const float t_min = rays[6 * n_pad + i], t_max = rays[7 * n_pad + i];
  const Ray r = Ray{ox, oy, oz, safe_inv(dx), safe_inv(dy), safe_inv(dz)};

  bool occ = kAny && occ_in != nullptr && occ_in[i] != 0;
  float best = kBig;
  int best_tri = -1;
  unsigned long long pairs = 0, visits = 0, cvisits = 0;  // kCount only

  // the gate's limit: nearest list_slack(min(best, t_max)); any-hit
  // list_slack(t_max) until occluded, then -inf (it reaches nothing)
  auto limit = [&]() -> float {
    if (kAny) return occ ? -INFINITY : list_slack(t_max);
    return list_slack(nan_min(best, t_max));
  };
  auto reaches = [&](const Box& b) -> bool {
    float te;
    return !empty_box(b) && slab(b, r, limit(), &te);
  };
  auto commit = [&](float t, int tri) {
    if (t < best || (t == best && tri < best_tri)) {
      best = t;
      best_tri = tri;
    }
  };

  // one cluster's visit; returns whether its tile was tested
  auto visit = [&](int c) -> bool {
    const bool reach = reaches(load_box(lo, hi, c));
    // this barrier also keeps the previous tile (and K7's slots) alive
    // until every thread is done with them
    const int cnt = __syncthreads_count(reach);
    if (cnt == 0) return false;
    for (int k = tid; k < kTile; k += kBlock) tile[k] = w4[((int64_t)c * kTile + k) * 2];
    if (kCount && tid == 0) ++visits;
    if (!kCompact || cnt > compact) {
      __syncthreads();
      if (!reach) return true;
      if (kAny) {
        for (int k = 0; k < kCluster; ++k) {
          if (kCount) ++pairs;
          if (any_pair(tile[k], tile[kCluster + k], tile[2 * kCluster + k], ox, oy, oz, dx, dy,
                       dz, t_min, t_max)) {
            occ = true;
            break;
          }
        }
      } else {
        if (kCount) pairs += kCluster;
#pragma unroll 4
        for (int k = 0; k < kCluster; ++k) {
          float t;
          if (nearest_pair(tile[k], tile[kCluster + k], tile[2 * kCluster + k], ox, oy, oz, dx,
                           dy, dz, t_min, t_max, &t)) {
            commit(t, c * kCluster + k);
          }
        }
      }
      return true;
    }
    if constexpr (kCompact && !kAny) {
      // K7: compact the reaching rays into slots, in thread order
      const unsigned ballot = __ballot_sync(0xffffffffu, reach);
      const int lane = tid & 31, warp = tid >> 5;
      if (lane == 0) warp_n[warp] = __popc(ballot);
      __syncthreads();  // the counts are in, and so is the tile
      int slot = __popc(ballot & ((1u << lane) - 1u));
      for (int k = 0; k < warp; ++k) slot += warp_n[k];
      if (reach) {
        c_o[slot] = make_float4(ox, oy, oz, t_min);
        c_d[slot] = make_float4(dx, dy, dz, t_max);
        c_key[slot] = ~0ull;
      }
      __syncthreads();
      for (int p = tid; p < cnt * kCluster; p += kBlock) {
        const int s = p / kCluster, k = p % kCluster;
        const float4 a = c_o[s], b = c_d[s];
        float t;
        if (nearest_pair(tile[k], tile[kCluster + k], tile[2 * kCluster + k], a.x, a.y, a.z, b.x,
                         b.y, b.z, a.w, b.w, &t)) {
          atomicMin(&c_key[s], ((unsigned long long)order_key(t) << 32) | (unsigned)k);
        }
      }
      __syncthreads();
      if (reach) {
        const unsigned long long key = c_key[slot];
        if (key != ~0ull) {
          const int k = (int)(key & 0xFFFFFFFFull);
          float t;
          nearest_pair(tile[k], tile[kCluster + k], tile[2 * kCluster + k], ox, oy, oz, dx, dy,
                       dz, t_min, t_max, &t);
          commit(t, c * kCluster + k);
        }
      }
      if (kCount && tid == 0) {
        pairs += (unsigned long long)cnt * kCluster;
        ++cvisits;
      }
    }
    return true;
  };

  const float* te_row = te_s + (int64_t)blockIdx.x * m;
  const int* id_row = order + (int64_t)blockIdx.x * m;
  float horizon = block_max(limit(), red);
  for (int j = 0; j < m; ++j) {
    // uniform: every thread reads the same entry and holds the same horizon
    if (!(te_row[j] <= horizon)) break;
    const int id = id_row[j];
    bool tested = false;
    if (P > 1) {
      if (!__syncthreads_or(reaches(load_box(node_lo, node_hi, id)))) continue;
      const int c_end = min(nc, (id + 1) * P);
      for (int c = id * P; c < c_end; ++c) tested |= visit(c);
    } else {
      tested = visit(id);
    }
    // limits only fall, so a horizon kept from before untested entries is
    // larger, never smaller: the exit stays exact
    if (tested) horizon = block_max(limit(), red);
  }

  if (kAny) {
    out_occ[i] = occ ? 1 : 0;
  } else {
    out_t[i] = best;
    out_tri[i] = best_tri;
  }
  if (kCount) {
    if (pairs) atomicAdd(counts + 3 * blockIdx.x, pairs);
    if (visits) atomicAdd(counts + 3 * blockIdx.x + 1, visits);
    if (cvisits) atomicAdd(counts + 3 * blockIdx.x + 2, cvisits);
  }
}

template <bool kAny, bool kCompact, bool kCount>
int launch_as(const float* rays, int64_t n_pad, const float* w, const float* lo, const float* hi,
              int nc, const float* te_s, const int* order, int m, const float* node_lo,
              const float* node_hi, int P, int compact, const uint8_t* occ_in, float* out_t,
              int* out_tri, uint8_t* out_occ, unsigned long long* counts, void* stream) {
  woop_list_kernel<kAny, kCompact, kCount>
      <<<(unsigned)(n_pad / kBlock), kBlock, 0, (cudaStream_t)stream>>>(
          rays, n_pad, reinterpret_cast<const float4*>(w), lo, hi, nc, te_s, order, m, node_lo,
          node_hi, P, compact, occ_in, out_t, out_tri, out_occ, counts);
  return (int)cudaGetLastError();
}

template <bool kAny, bool kCompact>
int launch(const float* rays, int64_t n_pad, const float* w, const float* lo, const float* hi,
           int nc, const float* te_s, const int* order, int m, const float* node_lo,
           const float* node_hi, int P, int compact, const uint8_t* occ_in, float* out_t,
           int* out_tri, uint8_t* out_occ, unsigned long long* counts, void* stream) {
  if (counts != nullptr) {
    return launch_as<kAny, kCompact, true>(rays, n_pad, w, lo, hi, nc, te_s, order, m, node_lo,
                                           node_hi, P, compact, occ_in, out_t, out_tri, out_occ,
                                           counts, stream);
  }
  return launch_as<kAny, kCompact, false>(rays, n_pad, w, lo, hi, nc, te_s, order, m, node_lo,
                                          node_hi, P, compact, occ_in, out_t, out_tri, out_occ,
                                          nullptr, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError() (0 =
// launched). `anyhit` 1 fills `out_occ` (warm-started by `occ_in`, which
// may be null), 0 fills `out_t` and `out_tri`; `compact` > 0 (nearest only)
// launches the K7 instance; P = 1 walks clusters (node bounds unused), P > 1
// nodes of P clusters. `counts` (u64[3 * n_pad / 128], zeroed by the caller,
// or null) gets per CTA the pairs tested, the tile visits and the compacted
// visits; null launches the instance without the counter.
extern "C" int mq_woop_list(const float* rays, int64_t n_pad, const float* w, const float* lo,
                            const float* hi, int nc, const float* te_s, const int* order, int m,
                            const float* node_lo, const float* node_hi, int P, int compact,
                            int anyhit, const uint8_t* occ_in, float* out_t, int* out_tri,
                            uint8_t* out_occ, unsigned long long* counts, void* stream) {
  const int want = P > 1 ? (nc + P - 1) / P : nc;
  if (n_pad <= 0 || n_pad % kBlock != 0 || nc <= 0 || P < 1 || m != want || compact < 0 ||
      (anyhit && compact > 0) || (P > 1 && (node_lo == nullptr || node_hi == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (anyhit) {
    return launch<true, false>(rays, n_pad, w, lo, hi, nc, te_s, order, m, node_lo, node_hi, P,
                               0, occ_in, nullptr, nullptr, out_occ, counts, stream);
  }
  if (compact > 0) {
    return launch<false, true>(rays, n_pad, w, lo, hi, nc, te_s, order, m, node_lo, node_hi, P,
                               compact, nullptr, out_t, out_tri, nullptr, counts, stream);
  }
  return launch<false, false>(rays, n_pad, w, lo, hi, nc, te_s, order, m, node_lo, node_hi, P, 0,
                              nullptr, out_t, out_tri, nullptr, counts, stream);
}
