// K3 on Hopper: the nearest front-facing hit (K1's result) or the
// any-hit occlusion (K2's result) of each ray against a Woop table of any
// size, each block of rays walking its own near-to-far cluster list.
//
// Replaces the TPU kernel merian_quake_tpu/accel/woop.py::_kernel_stream
// (launched at :1359 for tables above RESIDENT_MAX_TRIS), which leaves the
// table in HBM, visits clusters in each block's near-to-far order, stops
// at the block's horizon and stages tiles through an 8-slot DMA ring. It
// keeps that kernel's contract and K1's and K2's exactly, not its TPU
// schedule:
//   in:  rays f32[8, n_pad] rows (o.xyz, d.xyz, t_min, t_max);
//        w f32[3T, 8], per 64-triangle cluster c the rows
//        [c*192, c*192+192) = 64 "row 0" maps, 64 "row 1", 64 "row 2",
//        each [A | b] in columns 0-3 (K1's layout, csrc/woop_nearest.cu);
//        padded cluster AABBs lo/hi f32[nc, 3], nc <= kMaxClusters;
//        any-hit only: occ_in u8[n_pad] or null, rays already occluded.
//   out: nearest: t f32[n_pad] (3e38 on a miss), tri i32[n_pad] (-1);
//        any-hit: occluded u8[n_pad].
// The pair tests are K1's and K2's operation for operation: the
// division-free Woop test, every multiply and add rounded on its own
// (__fmul_rn/__fadd_rn, in the plain version's order), the lowest-index
// tie rule t < best || (t == best && tri < best_tri), and K2's any-hit
// conjunction of >= 0 compares (a NaN term rejects its pair). The
// nearest hit under that rule and the OR of the any-hit tests do not
// depend on the order of visits, so K3 is bit-equal to its plain versions
// (intersect_woop_reference, intersect_woop_any_reference) and to K1/K2.
//
// The schedule, one CTA per 128 consecutive rays, one thread per ray:
//  1. Visit list. For each cluster, the union entry te = the least slab
//     entry over the block's rays that reach its padded AABB within
//     with_slack(t_max) (occluded rays take no part). A node level of 32
//     clusters culls first: a node's box contains its clusters' boxes and
//     the slab test is monotone under rounding, so a ray that reaches no
//     node reaches none of its clusters, and the list is the exact union.
//     Clusters with an empty box (lo > hi) have zero rows and are never
//     listed. The reached clusters are compacted with a shared counter
//     and sorted near to far by a bitonic sort in shared memory on the
//     key (te's float bits >> 13) << 14 | cluster id: te rounded down to
//     10 mantissa bits, ties broken by id, so the order does not depend
//     on the compaction's order.
//  2. Walk. Before entry j, if its (rounded-down) te exceeds the horizon
//     (the largest gate limit over the block's rays), no ray can reach it
//     or any later entry: the walk stops, exactly. Otherwise every thread
//     runs K1's per-ray gate with its current limit (nearest:
//     with_slack(min(best, t_max)); any-hit: with_slack(t_max), none once
//     occluded), and the CTA skips the entry when no ray reaches it.
//  3. Ring. A passing cluster's 64 x 3 rows (columns 0-3, 3 KB) are
//     copied into one of kSlots shared slots with cp.async (16-byte
//     copies, one commit group per tile), issued ahead of the tiles being
//     tested: a tile is tested only when the ring is full or the walk has
//     ended. So the horizon and the limits a gate sees lag by up to
//     kSlots tiles; a lagging limit is larger, never smaller, so the list
//     gate and the exit stay exact, and at test time each thread gates
//     again with its current limit. A slot is refilled only after the
//     barrier that ends the test of the tile it held; every issued tile
//     is waited for before the CTA ends, so no copy leaks.
//  4. Any-hit: occluded rays stop testing (a thread leaves a tile at its
//     first hit) and stop raising the horizon; once every ray of the CTA
//     is occluded the horizon is -inf and the walk stops, uniformly.
// The union and the gate call the same function (mq::gate) with explicitly
// rounded operations, so a cluster the gate could pass is always listed.
//
// What bounds it on this card: FP32 arithmetic of the pairs tested (42
// rounded multiplies and adds a pair for the nearest hit, 46 for any-hit,
// at most 67 TFLOP/s and, without FMA, half that in issue rate) against
// the bytes (rays, results, and the table once: 48 B of rows a triangle,
// 13.5 MB at 281,536 triangles, which stays in the 50 MB L2 across CTAs).
// The design spends its effort on testing fewer pairs (near-to-far order,
// horizon exit, per-ray gate) and on hiding the latency of each tile's
// copy (the ring). The visit list costs one slab test per (ray, cluster)
// of each reached node and a sort per CTA. Warp-level traversal, TMA and
// persistent CTAs are later work.

#include "woop_common.cuh"

namespace {

constexpr int kSlots = 4;            // ring slots of 3 KB
constexpr int kNode = 32;            // clusters per node of the cull
constexpr int kIdBits = 14;
constexpr int kMaxClusters = 1 << kIdBits;  // 16,384 (1,048,576 triangles)
static_assert(kSlots == 4, "wait_pending handles up to 3 groups in flight");

// the gate, its slack, the pair tests, boxes and the safe inverse
// (woop_common.cuh); K3's list and walk both test boxes with K1's gate
using mq::any_pair;
using mq::Box;
using mq::empty_box;
using mq::gate;
using mq::kBig;
using mq::kBlock;
using mq::kCluster;
using mq::kTile;
using mq::kWarps;
using mq::load_box;
using mq::nearest_pair;
using mq::safe_inv;
using mq::with_slack;

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's commit groups are still in flight
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// the largest x over the CTA, the same value in every thread
__device__ __forceinline__ float block_max(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float m = red[0];
  for (int k = 1; k < kWarps; ++k) m = fmaxf(m, red[k]);
  return m;
}

// kCount: add up the (ray, triangle) pairs tested into counts[CTA]; the
// frame path launches the kCount = false instances, which have no counter.
template <bool kAny, bool kCount>
__global__ void __launch_bounds__(kBlock)
woop_stream_kernel(const float* __restrict__ rays, int64_t n_pad,
                   const float4* __restrict__ w4, const float* __restrict__ lo,
                   const float* __restrict__ hi, int nc,
                   const uint8_t* __restrict__ occ_in, float* __restrict__ out_t,
                   int* __restrict__ out_tri, uint8_t* __restrict__ out_occ,
                   unsigned long long* __restrict__ counts) {
  // dynamic shared memory: ring | rays (o, lim) | rays (1/d) | reached
  // nodes | visit-list keys (a power of two >= nc)
  extern __shared__ __align__(16) unsigned char smem[];
  float4* ring = reinterpret_cast<float4*>(smem);
  float4* ray_o = ring + kSlots * kTile;
  float4* ray_i = ray_o + kBlock;
  int* node_list = reinterpret_cast<int*>(ray_i + kBlock);
  const int nn = (nc + kNode - 1) / kNode;
  uint32_t* keys = reinterpret_cast<uint32_t*>(node_list + nn);
  __shared__ int n_nodes, n_list;
  __shared__ int slot_cid[kSlots];
  __shared__ float red[kWarps];

  const int tid = threadIdx.x;
  const int64_t i = (int64_t)blockIdx.x * kBlock + tid;
  const float4 o = make_float4(rays[i], rays[n_pad + i], rays[2 * n_pad + i], 0.0f);
  const float dx = rays[3 * n_pad + i], dy = rays[4 * n_pad + i], dz = rays[5 * n_pad + i];
  const float t_min = rays[6 * n_pad + i], t_max = rays[7 * n_pad + i];
  const float4 inv = make_float4(safe_inv(dx), safe_inv(dy), safe_inv(dz), 0.0f);

  bool occ = kAny && occ_in != nullptr && occ_in[i] != 0;
  float best = kBig;
  int best_tri = -1;
  unsigned long long pairs = 0;  // kCount only
  int issued = 0, computed = 0, len = 0;

  // the gate's limit: K1's for the nearest hit; for any-hit t_max's while
  // the ray is not occluded, then -inf (it reaches nothing)
  auto limit = [&]() -> float {
    if (kAny) return occ ? -INFINITY : with_slack(t_max);
    return with_slack(fminf(best, t_max));
  };

  float horizon = block_max(limit(), red);
  // horizon < 0: every ray is dead (t_max < 0) or occluded; te >= 0
  if (horizon >= 0.0f) {
    // ---- 1. the visit list ----
    ray_o[tid] = make_float4(o.x, o.y, o.z, limit());
    ray_i[tid] = inv;
    if (tid == 0) n_nodes = n_list = 0;
    __syncthreads();
    for (int nd = tid; nd < nn; nd += kBlock) {
      Box b = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
      const int c_end = min(nc, (nd + 1) * kNode);
      for (int c = nd * kNode; c < c_end; ++c) {
        const Box cb = load_box(lo, hi, c);
        if (empty_box(cb)) continue;
        b.lx = fminf(b.lx, cb.lx); b.ly = fminf(b.ly, cb.ly); b.lz = fminf(b.lz, cb.lz);
        b.hx = fmaxf(b.hx, cb.hx); b.hy = fmaxf(b.hy, cb.hy); b.hz = fmaxf(b.hz, cb.hz);
      }
      bool reached = false;
      if (!empty_box(b)) {
        for (int r = 0; r < kBlock && !reached; ++r) {
          const float4 ro = ray_o[r];
          float tn;
          reached = gate(b, ro, ray_i[r], ro.w, &tn);
        }
      }
      if (reached) node_list[atomicAdd(&n_nodes, 1)] = nd;
    }
    __syncthreads();
    const int work = n_nodes * kNode;
    for (int wi = tid; wi < work; wi += kBlock) {
      const int c = node_list[wi / kNode] * kNode + wi % kNode;
      if (c >= nc) continue;
      const Box cb = load_box(lo, hi, c);
      if (empty_box(cb)) continue;
      float te = INFINITY;
      bool reached = false;
      for (int r = 0; r < kBlock; ++r) {
        const float4 ro = ray_o[r];
        float tn;
        if (gate(cb, ro, ray_i[r], ro.w, &tn)) {
          reached = true;
          te = fminf(te, tn);
        }
      }
      if (reached) {
        keys[atomicAdd(&n_list, 1)] = ((__float_as_uint(te) >> 13) << kIdBits) | (uint32_t)c;
      }
    }
    __syncthreads();
    len = n_list;
    int p2 = 1;
    while (p2 < len) p2 <<= 1;
    for (int k = len + tid; k < p2; k += kBlock) keys[k] = 0xFFFFFFFFu;
    __syncthreads();
    for (int k = 2; k <= p2; k <<= 1) {  // bitonic sort, ascending
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int q = tid; q < (p2 >> 1); q += kBlock) {
          const int a = ((q & ~(j - 1)) << 1) | (q & (j - 1));
          const uint32_t ka = keys[a], kb = keys[a + j];
          if ((ka > kb) == ((a & k) == 0)) {
            keys[a] = kb;
            keys[a + j] = ka;
          }
        }
        __syncthreads();
      }
    }

    // ---- 2-3. the walk, tiles through the ring ----
    auto issue = [&](int c) {
      const int s = issued % kSlots;
      const float4* src = w4 + (int64_t)c * kTile * 2;  // columns 0-3 of each row
      float4* dst = ring + s * kTile;
      for (int k = tid; k < kTile; k += kBlock) cp_async16(dst + k, src + 2 * k);
      cp_async_commit();
      if (tid == 0) slot_cid[s] = c;
      ++issued;
    };
    auto compute = [&]() {
      wait_pending(issued - computed - 1);
      __syncthreads();  // every thread's copies of this tile have landed
      const int s = computed % kSlots;
      const int c = slot_cid[s];
      const float4* tile = ring + s * kTile;
      float tn;
      if (gate(load_box(lo, hi, c), o, inv, limit(), &tn)) {
        if (kAny) {
          for (int k = 0; k < kCluster; ++k) {
            if (kCount) ++pairs;
            if (any_pair(tile[k], tile[kCluster + k], tile[2 * kCluster + k], o.x, o.y, o.z, dx,
                         dy, dz, t_min, t_max)) {
              occ = true;
              break;
            }
          }
        } else {
          if (kCount) pairs += kCluster;
#pragma unroll 4
          for (int k = 0; k < kCluster; ++k) {
            float t;
            if (nearest_pair(tile[k], tile[kCluster + k], tile[2 * kCluster + k], o.x, o.y, o.z,
                             dx, dy, dz, t_min, t_max, &t)) {
              const int tri = c * kCluster + k;
              if (t < best || (t == best && tri < best_tri)) {
                best = t;
                best_tri = tri;
              }
            }
          }
        }
      }
      ++computed;
      // its barrier also ends every thread's reads of slot s
      horizon = block_max(limit(), red);
    };

    for (int j = 0; j < len; ++j) {
      const uint32_t key = keys[j];
      if (__uint_as_float((key >> kIdBits) << 13) > horizon) break;
      const int c = (int)(key & (kMaxClusters - 1));
      float tn;
      const bool reach = gate(load_box(lo, hi, c), o, inv, limit(), &tn);
      if (!__syncthreads_or(reach)) continue;
      if (issued - computed == kSlots) compute();
      issue(c);
    }
    while (computed < issued) compute();
  }

  if (kAny) {
    out_occ[i] = occ ? 1 : 0;
  } else {
    out_t[i] = best;
    out_tri[i] = best_tri;
  }
  if (kCount && pairs) atomicAdd(counts + blockIdx.x, pairs);
}

size_t smem_bytes(int nc) {
  const int nn = (nc + kNode - 1) / kNode;
  size_t p2 = 1;
  while (p2 < (size_t)nc) p2 <<= 1;
  return (size_t)kSlots * kTile * sizeof(float4) + 2 * kBlock * sizeof(float4) +
         nn * sizeof(int) + p2 * sizeof(uint32_t);
}

template <bool kAny, bool kCount>
int launch_as(const float* rays, int64_t n_pad, const float* w, const float* lo,
           const float* hi, int nc, int block, const uint8_t* occ_in, float* out_t,
           int* out_tri, uint8_t* out_occ, unsigned long long* counts, void* stream) {
  if (block != kBlock || n_pad % kBlock != 0 || nc < 0 || nc > kMaxClusters) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = smem_bytes(nc);
  cudaError_t err = cudaFuncSetAttribute(woop_stream_kernel<kAny, kCount>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t nb = n_pad / kBlock;
  if (nb > 0) {
    woop_stream_kernel<kAny, kCount><<<(unsigned)nb, kBlock, bytes, (cudaStream_t)stream>>>(
        rays, n_pad, reinterpret_cast<const float4*>(w), lo, hi, nc, occ_in, out_t,
        out_tri, out_occ, counts);
  }
  return (int)cudaGetLastError();
}

template <bool kAny>
int launch(const float* rays, int64_t n_pad, const float* w, const float* lo,
           const float* hi, int nc, int block, const uint8_t* occ_in, float* out_t,
           int* out_tri, uint8_t* out_occ, unsigned long long* counts, void* stream) {
  if (counts != nullptr) {
    return launch_as<kAny, true>(rays, n_pad, w, lo, hi, nc, block, occ_in, out_t, out_tri,
                                 out_occ, counts, stream);
  }
  return launch_as<kAny, false>(rays, n_pad, w, lo, hi, nc, block, occ_in, out_t, out_tri,
                                out_occ, nullptr, stream);
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`, does
// not synchronise, allocates nothing, and returns cudaGetLastError()
// (0 = launched). `block` must be 128 and nc at most 16,384; `w` must be
// 16-byte aligned. `counts` (u64[n_pad / 128], zeroed by the caller, or
// null) gets per CTA the (ray, triangle) pairs tested; null launches the
// kernel without the counter.
extern "C" int mq_woop_stream(const float* rays, int64_t n_pad, const float* w,
                              const float* lo, const float* hi, int nc, int block,
                              float* out_t, int* out_tri, unsigned long long* counts,
                              void* stream) {
  return launch<false>(rays, n_pad, w, lo, hi, nc, block, nullptr, out_t, out_tri,
                       nullptr, counts, stream);
}

// `occ_in` may be null (no warm start).
extern "C" int mq_woop_stream_any(const float* rays, int64_t n_pad, const float* w,
                                  const float* lo, const float* hi, int nc, int block,
                                  const uint8_t* occ_in, uint8_t* out,
                                  unsigned long long* counts, void* stream) {
  return launch<true>(rays, n_pad, w, lo, hi, nc, block, occ_in, nullptr, nullptr, out,
                      counts, stream);
}
