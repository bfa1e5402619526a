// K4 and K5 on Hopper: the per-ray target key, the per-block union entry,
// and the union fused with its row sort into a block's visit list.
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
//        sentinel, as in the JAX package. counts (optional, int64[n_pad /
//        128, 3]): per CTA the (ray, box) slabs of member boxes and of node
//        boxes it computed (32 a warp's slab) and the warps' insertions.
// K5 replaces woop.py::_kernel_te_union (:914, driven by _te_union :966):
//   in:  rays as K4's; m boxes lo/hi f32[m, 3] (clusters or node boxes);
//        `slack` 0 or 1.
//   out: te f32[n_pad / 128, m]: per block of 128 rays and per box the least
//        slab entry over the block's rays, +inf where none reaches it.
//        slack = 0 is the JAX function (limit = the ray's t_max, boxes as
//        given); slack = 1 is the list of the walker (csrc/woop_list.cu):
//        limit = list_slack(t_max) over padded boxes, and empty boxes
//        (lo > hi: no candidate triangle) are never listed.
// mq_visit_list is K5 at slack = 1 with the row sort that follows it in the
// JAX package (woop.py:1251-1257, in XLA there): per block the m <= 1024
// (te, id) pairs sorted by te, equal entries by id, as te_s f32[nb, m] and
// order i32[nb, m]: torch.sort(te, stable=True) bit for bit.
//
// Both are bit-equal to their plain versions (woop.target_keys_reference,
// woop.te_union_reference) and so to the JAX kernels in interpret mode: the
// slab is the JAX one (_slab_te_lanes, woop.py:852-874) with each subtract
// and multiply rounded and min/max propagating NaN as jnp.minimum/maximum
// do, computed with its planes chosen once a ray (K4's entry() below) or
// once an octant of rays (K5).
//
// What bounds them on this card: FP32 operations over (ray, box) slabs,
// rays x boxes of them; the bytes (32 B a ray in, 4 B a ray or a (block,
// box) out) are small beside it. The JAX slab is 24 operations (12
// subtracts and multiplies, 12 min/max), and the first designs issued about
// twice that a slab: half of the min/max only found which plane of an axis
// is near, K4 ran its 3-deep insertion on every pair, K5 ran one thread a
// box (96 of 128 idle on 32 node boxes). The design:
// - Planes chosen once a ray: each box's planes are ordered per axis (min,
//   max). The per-axis slab is symmetric in its planes and rounding is
//   monotone, so the near plane is the min where the ray's inverse
//   direction is >= 0, else the max, and the entry's bits are the JAX
//   slab's (tests/test_torch_keys.py holds it on inverted and empty boxes,
//   +-0 directions, NaN origins, infinite limits): 18 operations a slab (6
//   subtracts, 6 multiplies, 6 min/max). K4 keeps the boxes in shared
//   memory and a lane reads its planes at offsets chosen once.
// - K4: the insertion is a warp-uniform branch taken only when some lane's
//   entry beats its third; nodes of kKeyNode consecutive boxes let a whole
//   warp skip the members when the node's entry is >= every lane's third
//   (or the node is unreached): each reached member's entry is then >= the
//   node's, so a strict < insertion takes none of them. A node's box is the
//   min/max of its members' ordered planes, NaN planes left out, so it
//   contains each member's ordered box and the skip is exact for every
//   node, empty (lo > hi) and NaN members included: with the ordered planes
//   an empty member's entry is the JAX slab's, and a member with a NaN
//   plane is never reached. (A node box of the raw bounds, woop.node_bounds,
//   need not contain an empty member's ordered box: tests/test_torch_keys.py
//   holds both.) A warp whose limits are all negative or NaN writes
//   sentinels at once.
// - K5: a warp takes a block of 128 rays (no CTA barrier). It gathers the
//   block's live rays (limit >= 0; the others reach nothing) into shared
//   memory by octant, the signs of their inverse directions, so that one
//   octant's rays share each box's near and far planes. Each lane holds two
//   boxes in registers, chooses their planes once an octant and reads the
//   rays by broadcast, one ray's two 16-byte loads serving both boxes: the
//   least reached entry of a box needs no reduction across lanes. A block's
//   boxes pass through the warp 64 at a time; 32 or fewer (node boxes)
//   take 16 lanes, and the warp's two halves take alternate rays and merge
//   by a shuffle, so every lane works. Two first designs read slower on an
//   H100: one thread a ray with a warp reduction a box (1.42 x the first K5
//   on 252 cluster boxes: each slab paid the lane's plane offsets in
//   address arithmetic), and a CTA a block with its threads split over the
//   rays for few boxes (1.21 x the first K5 on 32 node boxes: a thread's
//   share of the rays was too short for its octant loop).
// - The visit list sorts the block's u64 keys bits(te) << 32 | id in shared
//   memory by a bitonic network in the same warp: keys are unique, so the
//   result is the stable sort, and no second launch reads the union back.

#include "woop_common.cuh"

namespace {

using namespace mq;

constexpr int kMaxKeyBoxes = 256;
constexpr int kKeyNode = 8;  // boxes a node of K4's skip level
constexpr int kKeyNodes = kMaxKeyBoxes / kKeyNode;
constexpr int kKeyCounts = 3;       // K4's counts: member slabs, node slabs, insertions
constexpr int kUnionBoxes = 2;      // boxes a lane of K5 holds in registers
constexpr int kMaxListBoxes = 1024;  // woop.RESIDENT_MAX_TRIS / 64 clusters
constexpr int kSentinelKey = (0xFF << 22) | (0xFF << 14) | (0xFF << 6);

// A box's planes with each axis ordered: p[k] = min(lo_k, hi_k), p[3 + k] =
// max(lo_k, hi_k), NaN propagating (a NaN plane leaves every ray unreached,
// as in the JAX slab).
__device__ __forceinline__ void store_planes(float* p, const float* lo, const float* hi, int c) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float l = lo[3 * c + k], h = hi[3 * c + k];
    p[k] = nan_min(l, h);
    p[3 + k] = nan_max(l, h);
  }
}

// A ray with its planes chosen: origin, inverse direction (safe_inv), and
// per axis the offsets (0..5) of the near and far plane in a box's ordered
// planes.
struct Chosen {
  float o[3], inv[3];
  int near[3], far[3];
};

__device__ __forceinline__ Chosen choose(const float* rays, int64_t n_pad, int64_t i) {
  Chosen r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.o[k] = rays[k * n_pad + i];
    r.inv[k] = safe_inv(rays[(3 + k) * n_pad + i]);
    const bool pos = r.inv[k] >= 0.0f;  // +-0 and positive; a NaN takes the max as near
    r.near[k] = pos ? k : 3 + k;
    r.far[k] = pos ? 3 + k : k;
  }
  return r;
}

// The JAX slab of box p (ordered planes) for ray r within [0, lim]: whether
// it is reached, and *tn its entry (tn >= 0, or NaN where unreached). 6
// subtracts, 6 multiplies, 6 min/max.
__device__ __forceinline__ bool entry(const float* p, const Chosen& r, float lim, float* tn) {
  float n = 0.0f, f = lim;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    n = nan_max(n, __fmul_rn(__fsub_rn(p[r.near[k]], r.o[k]), r.inv[k]));
    f = nan_min(f, __fmul_rn(__fsub_rn(p[r.far[k]], r.o[k]), r.inv[k]));
  }
  *tn = n;
  return n <= f;
}

// keys of a block's visit list: m padded to a power of two for the sort
__host__ __device__ __forceinline__ int list_len(int m) {
  int len = 1;
  while (len < m) len <<= 1;
  return len;
}

template <bool kCount>
__global__ void __launch_bounds__(kBlock)
target_keys_kernel(const float* __restrict__ rays, int64_t n_pad, const float* __restrict__ lo,
                   const float* __restrict__ hi, int nc, int* __restrict__ out,
                   long long* __restrict__ counts) {
  __shared__ float planes[kMaxKeyBoxes * 6];
  __shared__ float node_planes[kKeyNodes * 6];
  const int tid = threadIdx.x;
  for (int c = tid; c < nc; c += kBlock) store_planes(planes + 6 * c, lo, hi, c);
  __syncthreads();
  // node boxes: the min/max of the members' ordered planes (exact; fminf and
  // fmaxf leave a NaN plane out)
  const int nn = (nc + kKeyNode - 1) / kKeyNode;
  if (tid < nn) {
    const int c0 = tid * kKeyNode, c1 = min(c0 + kKeyNode, nc);
    float q[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) q[k] = planes[6 * c0 + k];
    for (int c = c0; c < c1; ++c) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        q[k] = fminf(q[k], planes[6 * c + k]);
        q[3 + k] = fmaxf(q[3 + k], planes[6 * c + 3 + k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) node_planes[6 * tid + k] = q[k];
  }
  __syncthreads();

  const int64_t i = (int64_t)blockIdx.x * kBlock + tid;
  const float lim = rays[7 * n_pad + i];
  if (!__any_sync(kFull, lim >= 0.0f)) {  // every limit negative or NaN: nothing is reached
    out[i] = kSentinelKey;
    return;
  }
  const Chosen r = choose(rays, n_pad, i);
  float t1 = INFINITY, t2 = INFINITY, t3 = INFINITY;
  int c1 = 0xFF, c2 = 0xFF, c3 = 0xFF;
  int member_slabs = 0, node_slabs = 0, inserts = 0;  // a warp's (kCount)
  for (int n = 0; n < nn; ++n) {
    float tn;
    const bool reach = entry(node_planes + 6 * n, r, lim, &tn);
    if (kCount) ++node_slabs;
    if (!__any_sync(kFull, reach && tn < t3)) continue;
#pragma unroll
    for (int j = 0; j < kKeyNode; ++j) {
      const int c = n * kKeyNode + j;
      if (c >= nc) break;
      float te;
      const bool reach = entry(planes + 6 * c, r, lim, &te);
      if (kCount) ++member_slabs;
      const bool b3 = reach && te < t3;
      if (__any_sync(kFull, b3)) {
        if (kCount) ++inserts;
        const bool b1 = b3 && te < t1, b2 = b3 && te < t2;
        t3 = b3 ? (b2 ? t2 : te) : t3;
        c3 = b3 ? (b2 ? c2 : c) : c3;
        t2 = b2 ? (b1 ? t1 : te) : t2;
        c2 = b2 ? (b1 ? c1 : c) : c2;
        t1 = b1 ? te : t1;
        c1 = b1 ? c : c1;
      }
    }
  }
  out[i] = (c1 << 22) | (c2 << 14) | (c3 << 6);
  if (kCount && (tid & 31) == 0) {
    long long* row = counts + (int64_t)blockIdx.x * kKeyCounts;
    atomicAdd(reinterpret_cast<unsigned long long*>(row), 32ull * member_slabs);
    atomicAdd(reinterpret_cast<unsigned long long*>(row + 1), 32ull * node_slabs);
    atomicAdd(reinterpret_cast<unsigned long long*>(row + 2), (unsigned long long)inserts);
  }
}

// K5 (kList false: te f32[nb, m]) and the visit list (kList true: te_s
// f32[nb, m], order i32[nb, m], m <= kMaxListBoxes; dynamic shared memory:
// kWarps x list_len(m) keys). A warp takes a block of 128 rays (a CTA kWarps
// blocks) and needs no barrier but its own: it gathers the block's live
// rays (limit >= 0) into shared memory by octant (the signs of their
// inverse directions), then each lane holds kUnionBoxes boxes in registers,
// chooses their near and far planes once an octant, and reads the
// octant's rays by broadcast.
template <bool kList, int kSplit>
__global__ void __launch_bounds__(kBlock)
union_kernel(const float* __restrict__ rays, int64_t n_pad, const float* __restrict__ lo,
             const float* __restrict__ hi, int m, int slack, float* __restrict__ out_te,
             int* __restrict__ out_order) {
  __shared__ float4 ray_o[kWarps][kBlock];    // origin, limit
  __shared__ float4 ray_inv[kWarps][kBlock];  // inverse direction
  __shared__ int oct_count[kWarps][9];        // rays of each octant (8: dead), then starts
  extern __shared__ unsigned long long list_keys[];  // kList: kWarps x list_len(m)

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t blk = (int64_t)blockIdx.x * kWarps + warp;
  if (blk >= n_pad / kBlock) return;
  float4* const so = ray_o[warp];
  float4* const si = ray_inv[warp];
  int* const start = oct_count[warp];

  // gather: lane takes rays lane + 32 k; its place within its octant is the
  // octant's count before it (a match a round gives the lanes that share it)
  constexpr int kRounds = kBlock / 32;
  if (lane < 9) start[lane] = 0;
  __syncwarp();
  float4 o_k[kRounds], inv_k[kRounds];
  int oct_k[kRounds], at_k[kRounds];
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int64_t i = blk * kBlock + lane + 32 * k;
    const Chosen r = choose(rays, n_pad, i);
    const float t_max = rays[7 * n_pad + i];
    const float lim = slack ? list_slack(t_max) : t_max;
    // a negative or NaN limit reaches nothing: octant 8, never gathered
    const int oct = !(lim >= 0.0f) ? 8
                    : (r.near[0] != 0) | (r.near[1] != 1) << 1 | (r.near[2] != 2) << 2;
    const unsigned same = __match_any_sync(kFull, oct);
    const int rank = __popc(same & ((1u << lane) - 1u));
    const int before = start[oct];
    __syncwarp();
    if (rank == 0) start[oct] = before + __popc(same);
    __syncwarp();
    o_k[k] = make_float4(r.o[0], r.o[1], r.o[2], lim);
    inv_k[k] = make_float4(r.inv[0], r.inv[1], r.inv[2], 0.0f);
    oct_k[k] = oct;
    at_k[k] = before + rank;
  }
  {  // counts → starts (exclusive scan over the 8 octants)
    const int count = lane < 8 ? start[lane] : 0;
    int scan = count;
#pragma unroll
    for (int d = 1; d < 8; d <<= 1) {
      const int x = __shfl_up_sync(kFull, scan, d);
      if (lane >= d) scan += x;
    }
    __syncwarp();
    if (lane < 8) start[lane] = scan - count;
    if (lane == 7) start[8] = scan;
    __syncwarp();
  }
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    if (oct_k[k] < 8) {
      const int at = start[oct_k[k]] + at_k[k];
      so[at] = o_k[k];
      si[at] = inv_k[k];
    }
  }
  __syncwarp();

  // a pass's boxes: kUnionBoxes a lane over kWidth lanes; the warp's kSplit
  // parts of kWidth lanes each take every kSplit-th ray of an octant
  constexpr int kWidth = 32 / kSplit;
  const int part = lane / kWidth, col = lane % kWidth;
  const int len = list_len(m);
  unsigned long long* const keys = list_keys + warp * len;
  for (int base = 0; base < m; base += kWidth * kUnionBoxes) {
    float p[kUnionBoxes][6];  // ordered planes; NaN for no box (never reached)
    float acc[kUnionBoxes];
#pragma unroll
    for (int j = 0; j < kUnionBoxes; ++j) {
      const int c = base + col + kWidth * j;
      bool listed = c < m;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float l = listed ? lo[3 * c + k] : 0.0f, h = listed ? hi[3 * c + k] : 0.0f;
        p[j][k] = nan_min(l, h);
        p[j][3 + k] = nan_max(l, h);
        if (slack && l > h) listed = false;  // an empty box is never listed
      }
      if (!listed) {
#pragma unroll
        for (int k = 0; k < 6; ++k) p[j][k] = __int_as_float(0x7fffffff);
      }
      acc[j] = INFINITY;
    }
    for (int q = 0; q < 8; ++q) {
      const int s = start[q], e = start[q + 1];
      if (s == e) continue;
      float near[kUnionBoxes][3], far[kUnionBoxes][3];
#pragma unroll
      for (int j = 0; j < kUnionBoxes; ++j) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const bool neg = (q >> k) & 1;
          near[j][k] = neg ? p[j][3 + k] : p[j][k];
          far[j][k] = neg ? p[j][k] : p[j][3 + k];
        }
      }
#pragma unroll 2
      for (int at = s + part; at < e; at += kSplit) {
        const float4 o = so[at], inv = si[at];
#pragma unroll
        for (int j = 0; j < kUnionBoxes; ++j) {
          float n = 0.0f, f = o.w;
          n = nan_max(n, __fmul_rn(__fsub_rn(near[j][0], o.x), inv.x));
          f = nan_min(f, __fmul_rn(__fsub_rn(far[j][0], o.x), inv.x));
          n = nan_max(n, __fmul_rn(__fsub_rn(near[j][1], o.y), inv.y));
          f = nan_min(f, __fmul_rn(__fsub_rn(far[j][1], o.y), inv.y));
          n = nan_max(n, __fmul_rn(__fsub_rn(near[j][2], o.z), inv.z));
          f = nan_min(f, __fmul_rn(__fsub_rn(far[j][2], o.z), inv.z));
          if (n <= f) acc[j] = fminf(acc[j], n);  // n is never NaN here
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kUnionBoxes; ++j) {
#pragma unroll
      for (int d = kWidth; d < 32; d <<= 1) {
        acc[j] = fminf(acc[j], __shfl_xor_sync(kFull, acc[j], d));
      }
      const int c = base + col + kWidth * j;
      if (part != 0 || c >= m) continue;
      const float te = __fadd_rn(acc[j], 0.0f);  // a zero entry is +0
      if (kList) {
        keys[c] = ((unsigned long long)__float_as_uint(te) << 32) | (unsigned)c;
      } else {
        out_te[blk * m + c] = te;
      }
    }
  }
  if (!kList) return;

  for (int b = m + lane; b < len; b += 32) keys[b] = ~0ull;
  __syncwarp();
  if (start[8] > 0) {  // else every entry is +inf and the keys are in id order already
    for (int k = 2; k <= len; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int q = lane; q < len / 2; q += 32) {
          const int a = 2 * q - (q & (j - 1));  // bit j of a clear; its partner a + j
          const unsigned long long x = keys[a], y = keys[a + j];
          if ((x > y) == ((a & k) == 0)) {
            keys[a] = y;
            keys[a + j] = x;
          }
        }
        __syncwarp();
      }
    }
  }
  for (int b = lane; b < m; b += 32) {
    out_te[blk * m + b] = __uint_as_float((unsigned)(keys[b] >> 32));
    out_order[blk * m + b] = (int)(keys[b] & 0xffffffffu);
  }
}

template <bool kList, int kSplit>
int launch_union(const float* rays, int64_t n_pad, const float* lo, const float* hi, int m,
                 int slack, float* te, int* order, cudaStream_t stream) {
  const size_t smem = kList ? sizeof(unsigned long long) * kWarps * list_len(m) : 0;
  if (smem >= 32 * 1024) {  // with the 16 KB of rays, past the 48 KB a launch gets unasked
    const cudaError_t err = cudaFuncSetAttribute(
        union_kernel<kList, kSplit>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t nb = n_pad / kBlock;
  union_kernel<kList, kSplit><<<(unsigned)((nb + kWarps - 1) / kWarps), kBlock, smem, stream>>>(
      rays, n_pad, lo, hi, m, slack, te, order);
  return (int)cudaGetLastError();
}

// a warp's two halves on the two halves of the rays where 16 lanes hold all
// the boxes
template <bool kList>
int union_for(const float* rays, int64_t n_pad, const float* lo, const float* hi, int m,
                 int slack, float* te, int* order, void* stream) {
  return m <= 16 * kUnionBoxes ? launch_union<kList, 2>(rays, n_pad, lo, hi, m, slack, te, order,
                                          (cudaStream_t)stream)
                 : launch_union<kList, 1>(rays, n_pad, lo, hi, m, slack, te, order,
                                          (cudaStream_t)stream);
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`, does
// not synchronise, allocates nothing, and returns cudaGetLastError()
// (0 = launched). A null `counts` launches the instance without counters
// (the one the frames take).
extern "C" int mq_target_keys(const float* rays, int64_t n_pad, const float* lo, const float* hi,
                              int nc, int* out, long long* counts, void* stream) {
  if (n_pad <= 0 || n_pad % kBlock != 0 || nc < 0 || nc > kMaxKeyBoxes) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned grid = (unsigned)(n_pad / kBlock);
  if (counts) {
    target_keys_kernel<true><<<grid, kBlock, 0, (cudaStream_t)stream>>>(rays, n_pad, lo, hi, nc,
                                                                         out, counts);
  } else {
    target_keys_kernel<false><<<grid, kBlock, 0, (cudaStream_t)stream>>>(rays, n_pad, lo, hi, nc,
                                                                          out, nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int mq_te_union(const float* rays, int64_t n_pad, const float* lo, const float* hi,
                           int m, int slack, float* out, void* stream) {
  if (n_pad <= 0 || n_pad % kBlock != 0 || m <= 0) return (int)cudaErrorInvalidValue;
  return union_for<false>(rays, n_pad, lo, hi, m, slack, out, nullptr, stream);
}

extern "C" int mq_visit_list(const float* rays, int64_t n_pad, const float* lo, const float* hi,
                             int m, float* te_s, int* order, void* stream) {
  if (n_pad <= 0 || n_pad % kBlock != 0 || m <= 0 || m > kMaxListBoxes) {
    return (int)cudaErrorInvalidValue;
  }
  return union_for<true>(rays, n_pad, lo, hi, m, 1, te_s, order, stream);
}
