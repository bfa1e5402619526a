// The walk that K1 (csrc/woop_nearest.cu), K2 (csrc/woop_any.cu), K3
// (csrc/woop_stream.cu) and the list walker K6/K7 (csrc/woop_list.cu) share
// on Hopper: each warp of 32 consecutive rays walks the table alone, through
// nodes of P consecutive clusters and sub-nodes of S, and tests the tiles its
// own lanes reach, which arrive by bulk copies into a ring of its own.
//
//   in:  rays f32[8, n_pad] rows (o.xyz, d.xyz, t_min, t_max);
//        rows4 f32[3T, 4], the table's rows packed (columns 0-3 of woop_w):
//        cluster c's tile is the 3,072 contiguous bytes at row c * 192, 64
//        "row 0" maps, 64 "row 1", 64 "row 2", each [A | b];
//        boxes f32[nn + ns + nc, 8], nn = ceil(nc / P), ns = ceil(nc / S)
//        (0 when S = P: no such level): the node boxes, the sub-node boxes,
//        then the padded cluster boxes, each (lo.xyz, empty flag, hi.xyz, 0);
//        a node's or sub-node's box is the min/max of its members' (no
//        rounding), so it holds them;
//        any-hit only: occ_in u8[n_pad] or null, rays already occluded;
//        kBlockList only: each 128-ray block's visit list (BlockList).
//   out: nearest: t f32[n_pad] (3e38 on a miss), tri i32[n_pad] (-1);
//        any-hit: occluded u8[n_pad].
// Every pair test is mq::nearest_pair or mq::any_pair (woop_common.cuh), and
// the nearest hit is kept by K1's rule t < best || (t == best && tri <
// best_tri). That result does not depend on which tiles are visited or in
// what order, as long as every tile holding a ray's nearest hit (or an
// occluder) within its limit is visited, so the walk is bit-equal to
// intersect_woop_reference / equal on every ray to
// intersect_woop_any_reference.
//
// The walk of one warp:
//  1. Nodes, from one of three sources (Walk):
//     kIndexOrder (K1, K2): the nodes in index order.
//     kNodeList (K3): each lane tests every node box once with its starting
//     limit with_slack(t_max) (-inf when occluded on entry); the least entry
//     over the lanes (one warp reduction) makes the key (entry bits >> 13)
//     << 14 | node, the entry rounded down; the reached nodes' keys go to
//     shared memory and the walk takes the least key left each time (near to
//     far), and stops at the first whose entry exceeds the warp's horizon,
//     the largest current limit over its lanes. That exit is exact: a node
//     box holds its members' boxes and the rounded slab is monotone under
//     containment, so a member that any later gate passes (its limit is
//     never above the starting one) has its node listed with an entry no
//     later, and an entry beyond every lane's limit fails every gate.
//     kBlockList (K6, K7): the list of the warp's 128-ray block, built
//     before the launch by K5 (csrc/woop_keys.cu) and sorted near to far;
//     the warp stops at the first entry beyond its own horizon. P and S are
//     run-time values there (BlockList), and the gates are K5's slab
//     (csrc/woop_list.cu states the exit and why it is exact).
//  2. Gates. A lane gates a box with its current limit (nearest:
//     with_slack(min(best, t_max)), or list_slack(min(best, t_max)) with the
//     block list; any-hit: the same slack of t_max, -inf once occluded, so a
//     warp whose live lanes are all occluded reaches no box and issues no
//     tile: its walk ends); a vote says whether any lane reaches it. K1
//     gates its nodes 32 at a time, K3 the listed node again (the list saw
//     the starting limits), the block list its entries kBatch at a time; a
//     reached node's P / S sub-nodes are gated, then a reached sub-node's S
//     clusters (with P = 1 the listed entry is the cluster). Gates go in
//     batches of kBatch that share one reading of the limits, so their loads
//     and arithmetic overlap.
//  3. Ring. A cluster some lane reaches is fetched at once: lane 0 issues
//     one bulk copy (cp.async.bulk, 3,072 bytes) into the next of the warp's
//     kRing slots, completion on that slot's mbarrier. The tile fetched
//     before it is tested only now, so a copy overlaps the gates that find
//     the next tile and the previous tile's pair tests. Limits seen by a gate
//     therefore lag by one tile (and by the tiles of its batch): larger,
//     never smaller. A slot is refilled
//     only after __syncwarp() behind the test of the tile it held; the last
//     tile is tested after the walk, so every copy is waited for.
//  4. Test. Each lane gates the tile again with its current limit; k lanes
//     reach it. k = 0: nothing. k > the compaction limit (kCompactMax; the
//     block list's run-time value, 0 for K6 alone): ray per lane, 64 pair
//     tests each reaching lane. Otherwise triangle per lane: lane l holds
//     triangles l and l + 32; for each reaching ray in lane order (its
//     fields by shuffles) every lane tests its two; nearest: the least
//     order-preserving image of t + 0 over the lanes, then the least
//     triangle index among those equal to it (two warp reductions: the
//     64-bit key (t, index)), the exact t from the winner's lane, committed
//     by the ray's lane with K1's rule; any-hit: a vote. 2k warp iterations
//     instead of 64.
// Barriers: none across the CTA. A visited tile costs two votes, one
// __syncwarp() and one mbarrier wait; a skipped cluster, sub-node or node
// one vote.
//
// The alpha instance (kAlpha, csrc/woop_alpha.cu) repeats the walk in rounds
// of the alpha loop, each lane's limits its ray's current interval, and runs
// the alpha test of each committed hit between them (see there).
//
// The profile instance (kProf) adds clock64 readings at the phase
// boundaries and counters, per CTA into prof[kProfFields * CTA + 0..9]
// summed over its warps: 0 cycles in the list (build, selection, horizon),
// 1 the gates that look for the next tile (nodes, sub-nodes, clusters;
// passed or not), 2 issues and the gate again at test time, 3 tile waits, 4
// pair loops, 5 the whole kernel, 6 (ray, triangle) pairs tested, 7
// warp-issued pairs (warp iterations of a pair loop: 64 a ray-per-lane
// visit, 2k a compacted one), 8 tile visits (tests that some lane reached),
// 9 compacted visits; the alpha instance's instead per warp into
// prof[2 * warp + 0..1]: the rounds it walked and the pairs its lanes tested.
// The frame path launches the instance without it.
#pragma once

#include "woop_common.cuh"

namespace mq {

// clusters a node and clusters a sub-node of K1's, K2's and K3's instances
// (equal: no level of sub-nodes), chosen by measurement on an H100; the wrappers read
// them through each library's mq_*_node / mq_*_sub and pack `boxes` for them
constexpr int kNode = 64;
constexpr int kSub = 8;
constexpr int kRing = 2;           // tile slots a warp
constexpr int kTileBytes = kTile * 16;
constexpr int kCompactMax = 24;    // reaching lanes up to which a visit is compacted
constexpr int kIdBits = 14;
constexpr int kMaxClusters = 1 << kIdBits;  // 16,384 (1,048,576 triangles)
constexpr int kMinCtas = 8;        // CTAs an SM the register budget allows
constexpr int kProfFields = 10;    // the profile's counters a CTA
static_assert((kRing & (kRing - 1)) == 0, "slots are picked by a mask");

constexpr int kBatch = 4;  // boxes gated together before their votes

// where a warp's nodes come from (step 1 above)
enum Walk : int { kIndexOrder, kNodeList, kBlockList };

// kBlockList's inputs: each block's list te_s f32[nb, m] (ascending
// entries, +inf where no ray of the block reaches the box) and order
// i32[nb, m] (box ids: clusters when node = 1, else nodes); the node and
// sub-node sizes (sub = node: no sub-node level); the reaching lanes up to
// which a visit is compacted (0: none)
struct BlockList {
  const float* te_s;
  const int* order;
  int m, node, sub, compact;
};

constexpr size_t walk_smem_bytes(int nc, int P, bool list) {
  return (size_t)kWarps * kRing * kTileBytes +
         (list ? (size_t)kWarps * ((nc + P - 1) / P) * sizeof(unsigned) : 0);
}

// P, S: the node and sub-node sizes (compile-time; with kBlockList they
// come from `bl` at run time and P, S are unused)
template <int P, int S, int kSrc, bool kAny, bool kProf, bool kAlpha>
__global__ void __launch_bounds__(kBlock, kMinCtas)
woop_walk_kernel(const float* __restrict__ rays, int64_t n_pad, const float4* __restrict__ rows4,
                 const float4* __restrict__ boxes, int nc, const uint8_t* __restrict__ occ_in,
                 float* __restrict__ out_t, int* __restrict__ out_tri,
                 uint8_t* __restrict__ out_occ, BlockList bl,
                 unsigned long long* __restrict__ prof, AlphaTables al) {
  constexpr bool kList = kSrc == kNodeList, kBlk = kSrc == kBlockList;
  static_assert(P % S == 0 && S <= 32 && P / S <= 32, "sub-nodes tile a node; votes fill a word");
  static_assert(!(kAlpha && (kAny || kSrc == kBlockList)), "the alpha walk: K1's or K3's nodes");
  // dynamic shared memory: each warp's ring | each warp's node keys (kList)
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bars_all[kWarps * kRing];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // node and sub-node sizes and the compaction limit: compile-time, or the
  // block list's
  const int np = kBlk ? bl.node : P, sp = kBlk ? bl.sub : S;
  const int cmax = kBlk ? bl.compact : kCompactMax;
  // boxes: nn nodes of np clusters | ns sub-nodes of sp (when sp < np) | nc clusters
  const int nn = (nc + np - 1) / np;
  const int ns = sp < np ? (nc + sp - 1) / sp : 0;
  const int sub0 = nn, cl0 = nn + ns;
  float4* ring = reinterpret_cast<float4*>(smem) + warp * kRing * kTile;
  unsigned long long* bars = bars_all + warp * kRing;
  unsigned* keys = reinterpret_cast<unsigned*>(smem + kWarps * kRing * kTileBytes) + warp * nn;

  const int64_t i = (int64_t)blockIdx.x * kBlock + tid;
  const float4 o = make_float4(rays[i], rays[n_pad + i], rays[2 * n_pad + i], 0.0f);
  const float dx = rays[3 * n_pad + i], dy = rays[4 * n_pad + i], dz = rays[5 * n_pad + i];
  // the interval a walk tests: the ray's, or (kAlpha) its round's
  float t_min = rays[6 * n_pad + i], t_max = rays[7 * n_pad + i];
  const float4 inv = make_float4(safe_inv(dx), safe_inv(dy), safe_inv(dz), 0.0f);

  bool occ = kAny && occ_in != nullptr && occ_in[i] != 0;
  float best = kBig;
  int best_tri = -1;
  int issued = 0, pending = -1;
  bool ready = false;  // the ring's barriers initialised

  // kProf only
  unsigned long long pairs = 0, wpairs = 0, visits = 0, cvisits = 0;
  long long t_list = 0, t_skip = 0, t_gate = 0, t_wait = 0, t_pair = 0, c0 = 0, t_begin = 0;
  if (kProf) t_begin = c0 = clock64();
  auto lap = [&](long long& acc) {
    if (kProf) {
      const long long c1 = clock64();
      acc += c1 - c0;
      c0 = c1;
    }
  };

  // the gate's limit: K1's for the nearest hit; for any-hit t_max's while
  // the ray is not occluded, then -inf (it reaches nothing); the block
  // list's gates take K5's slack, list_slack, with NaN kept
  auto limit = [&]() -> float {
    if (kBlk) {
      if (kAny) return occ ? -INFINITY : list_slack(t_max);
      return list_slack(nan_min(best, t_max));
    }
    if (kAny) return occ ? -INFINITY : with_slack(t_max);
    return with_slack(fminf(best, t_max));
  };
  // does this lane's ray reach box b (a node, sub0 + a sub-node or cl0 + a
  // cluster) within lim? K1's gate, or with the block list K5's slab, the
  // function its list was built with
  auto reaches = [&](int b, float lim, float* tn) -> bool {
    const float4 l = __ldg(boxes + 2 * b), h = __ldg(boxes + 2 * b + 1);
    const Box box{l.x, l.y, l.z, h.x, h.y, h.z};
    const bool in = kBlk ? slab(box, Ray{o.x, o.y, o.z, inv.x, inv.y, inv.z}, lim, tn)
                         : gate(box, o, inv, lim, tn);
    return in & (l.w == 0.0f);
  };
  auto commit = [&](float t, int tri) {
    if (t < best || (t == best && tri < best_tri)) {
      best = t;
      best_tri = tri;
    }
  };

  // fetch cluster c's tile into the next slot
  auto issue = [&](int c) {
    __syncwarp();  // every lane has left the tile this slot held
    if (lane == 0) {
      const int s = issued & (kRing - 1);
      mbar_expect(bars + s, kTileBytes);
      bulk_copy(ring + s * kTile, rows4 + (int64_t)c * kTile, kTileBytes, bars + s);
    }
    ++issued;
  };

  // test cluster c, the n-th tile issued
  auto test = [&](int c, int n) {
    const int s = n & (kRing - 1);
    float tn;
    const bool reach = reaches(cl0 + c, limit(), &tn);
    const unsigned mask = __ballot_sync(kFull, reach);
    const int k = __popc(mask);
    lap(t_gate);
    mbar_wait(bars + s, (n / kRing) & 1);
    lap(t_wait);
    if (k == 0) return;
    const float4* tile = ring + s * kTile;
    if (kProf) {
      ++visits;
      cvisits += k <= cmax;
    }
    if (k <= cmax) {
      // triangle per lane: this lane's two triangles against each reaching ray
      const float4 a0 = tile[lane], a1 = tile[kCluster + lane], a2 = tile[2 * kCluster + lane];
      const float4 b0 = tile[32 + lane], b1 = tile[kCluster + 32 + lane],
                   b2 = tile[2 * kCluster + 32 + lane];
      for (unsigned m = mask; m; m &= m - 1) {
        const int src = __ffs(m) - 1;
        const float rox = __shfl_sync(kFull, o.x, src), roy = __shfl_sync(kFull, o.y, src),
                    roz = __shfl_sync(kFull, o.z, src), rdx = __shfl_sync(kFull, dx, src),
                    rdy = __shfl_sync(kFull, dy, src), rdz = __shfl_sync(kFull, dz, src),
                    rt0 = __shfl_sync(kFull, t_min, src), rt1 = __shfl_sync(kFull, t_max, src);
        if (kAny) {
          const bool hit = any_pair(a0, a1, a2, rox, roy, roz, rdx, rdy, rdz, rt0, rt1) |
                           any_pair(b0, b1, b2, rox, roy, roz, rdx, rdy, rdz, rt0, rt1);
          if (__any_sync(kFull, hit) && lane == src) occ = true;
        } else {
          float ta = 0.0f, tb = 0.0f;
          const bool ha = nearest_pair(a0, a1, a2, rox, roy, roz, rdx, rdy, rdz, rt0, rt1, &ta);
          const bool hb = nearest_pair(b0, b1, b2, rox, roy, roz, rdx, rdy, rdz, rt0, rt1, &tb);
          // a NaN t is never committed by K1's rule: it takes no part
          const unsigned ka = (ha && ta == ta) ? float_key(ta) : ~0u;
          const unsigned kb = (hb && tb == tb) ? float_key(tb) : ~0u;
          const unsigned kmin = __reduce_min_sync(kFull, min(ka, kb));
          if (kmin != ~0u) {
            // the least triangle index among the pairs with the least t
            const unsigned mine = ka == kmin ? (unsigned)lane
                                             : (kb == kmin ? (unsigned)lane + 32u : ~0u);
            const unsigned win = __reduce_min_sync(kFull, mine);
            const float tw = __shfl_sync(kFull, win < 32u ? ta : tb, (int)(win & 31u));
            if (lane == src) commit(tw, c * kCluster + (int)win);
          }
        }
      }
      if (kProf) {
        if (reach) pairs += kCluster;
        wpairs += 2 * k;
      }
    } else {
      const unsigned long long pairs0 = pairs;
      if (reach) {
        if (kAny) {
          for (int j = 0; j < kCluster; ++j) {
            if (kProf) ++pairs;
            if (any_pair(tile[j], tile[kCluster + j], tile[2 * kCluster + j], o.x, o.y, o.z, dx,
                         dy, dz, t_min, t_max)) {
              occ = true;
              break;
            }
          }
        } else {
          if (kProf) pairs += kCluster;
#pragma unroll 4
          for (int j = 0; j < kCluster; ++j) {
            float t;
            if (nearest_pair(tile[j], tile[kCluster + j], tile[2 * kCluster + j], o.x, o.y, o.z,
                             dx, dy, dz, t_min, t_max, &t)) {
              commit(t, c * kCluster + j);
            }
          }
        }
      }
      if (kProf) {
        __syncwarp();
        wpairs += kAny ? __reduce_max_sync(kFull, (unsigned)(pairs - pairs0)) : kCluster;
      }
    }
    lap(t_pair);
  };

  // Which of the boxes first + 0 .. first + count - 1 (count <= 32, box ids
  // below `end`) does some lane reach? A bit each. The gates of a batch run
  // before its votes, so their loads and arithmetic overlap; they share one
  // reading of the limits, which the tiles tested meanwhile can only lower.
  auto reached = [&](int first, int count, int end) -> unsigned {
    const float lim = limit();
    unsigned bits = 0;
    for (int q0 = 0; q0 < count; q0 += kBatch) {
      bool r[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        float tn;
        r[q] = q0 + q < count && first + q0 + q < end && reaches(first + q0 + q, lim, &tn);
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) bits |= (__any_sync(kFull, r[q]) ? 1u : 0u) << (q0 + q);
    }
    return bits;
  };

  // cluster c, which some lane reaches: fetch it, and test the tile fetched
  // before it. Any-hit: false, and nothing fetched, once every live lane is
  // occluded (the gates saw older limits).
  auto fetch = [&](int c) -> bool {
    if (kAny && !__any_sync(kFull, limit() >= 0.0f)) return false;
    issue(c);
    lap(t_gate);
    if (pending >= 0) test(pending, issued - 2);
    pending = c;
    return true;
  };

  // the sp clusters of sub-node sb: each one some lane reaches is fetched
  auto visit_members = [&](int sb) {
    unsigned bits = reached(cl0 + sb * sp, sp, cl0 + nc);
    lap(t_skip);
    for (; bits; bits &= bits - 1) {
      if (!fetch(sb * sp + __ffs(bits) - 1)) break;
    }
  };

  // node nd, which some lane reaches: its sub-nodes' gates when it has a
  // level of them, then the members of the reached ones
  auto visit_node = [&](int nd) {
    if (sp < np) {
      unsigned bits = reached(sub0 + nd * (np / sp), np / sp, sub0 + ns);
      lap(t_skip);
      for (; bits; bits &= bits - 1) visit_members(nd * (np / sp) + __ffs(bits) - 1);
    } else {
      visit_members(nd);
    }
  };

  // the walk of the warp for its lanes' current limits; a warp whose rays
  // are all dead (t_max < 0) or occluded walks nothing. The ring's barriers
  // are initialised once: their phases, and `issued`, carry over from one
  // walk to the next (every copy is waited for before a walk ends)
  auto walk = [&]() {
    if (__any_sync(kFull, limit() >= 0.0f)) {
      if (!ready) {
        if (lane == 0) {
          for (int s = 0; s < kRing; ++s) mbar_init(bars + s, 1);
          asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
        ready = true;
      }
      __syncwarp();
      if (kList) {
        // ---- the node list: reached nodes' keys, entry rounded down | node ----
        const float lim0 = limit();
        int len = 0;
#pragma unroll 4
        for (int nd = 0; nd < nn; ++nd) {
          float tn;
          const bool r = reaches(nd, lim0, &tn);
          const unsigned m =
              __reduce_min_sync(kFull, r ? __float_as_uint(__fadd_rn(tn, 0.0f)) : ~0u);
          if (m != ~0u) {
            if (lane == 0) keys[len] = ((m >> 13) << kIdBits) | (unsigned)nd;
            ++len;
          }
        }
        __syncwarp();
        unsigned horizon = __reduce_max_sync(kFull, float_key(limit()));
        for (;;) {
          // the least key left
          unsigned kmin = ~0u;
          int pos = 0;
          for (int q = lane; q < len; q += 32) {
            const unsigned key = keys[q];
            if (key < kmin) {
              kmin = key;
              pos = q;
            }
          }
          const unsigned m = __reduce_min_sync(kFull, kmin);
          if (m == ~0u) break;
          // no lane can reach a node entered beyond the horizon, nor a later one
          if (float_key(__uint_as_float((m >> kIdBits) << 13)) > horizon) break;
          if (kmin == m) keys[pos] = ~0u;
          __syncwarp();
          lap(t_list);
          // the list's gate saw the starting limits: gate again with today's
          const int nd = (int)(m & (unsigned)(kMaxClusters - 1));
          float tn;
          if (__any_sync(kFull, reaches(nd, limit(), &tn))) visit_node(nd);
          lap(t_skip);
          // limits only fall, and the tile still pending can only lower them
          // further: this horizon is larger, never smaller, than the true one
          horizon = __reduce_max_sync(kFull, float_key(limit()));
        }
        lap(t_list);
      } else if (kBlk) {
        // ---- the block's list, near to far, kBatch entries a step ----
        const float* te_row = bl.te_s + (int64_t)blockIdx.x * bl.m;
        const int* id_row = bl.order + (int64_t)blockIdx.x * bl.m;
        for (int j0 = 0; j0 < bl.m; j0 += 32) {
          // lane l holds entry j0 + l: the order-preserving key of its entry
          // and its box
          const int j = j0 + lane;
          const unsigned key = j < bl.m ? float_key(__ldg(te_row + j)) : ~0u;
          const int id = j < bl.m ? __ldg(id_row + j) : 0;
          int n = 32;  // entries of this chunk within the horizon: a prefix
          for (int q0 = 0;; q0 += kBatch) {
            // the warp's horizon, the largest current limit over its lanes:
            // no lane reaches an entry beyond it, nor a later one
            const float lim = limit();
            const unsigned horizon = __reduce_max_sync(kFull, float_key(lim));
            n = min(n, __popc(__ballot_sync(kFull, key <= horizon)));
            lap(t_list);
            if (q0 >= n) break;
            // the gates of entries q0 .. q0 + kBatch - 1, then their votes
            bool r[kBatch];
#pragma unroll
            for (int q = 0; q < kBatch; ++q) {
              const int b = __shfl_sync(kFull, id, (q0 + q) & 31);
              float tn;
              r[q] = q0 + q < n && reaches(b, lim, &tn);
            }
            unsigned bits = 0;
#pragma unroll
            for (int q = 0; q < kBatch; ++q) bits |= (__any_sync(kFull, r[q]) ? 1u : 0u) << q;
            lap(t_skip);
            for (; bits; bits &= bits - 1) {
              const int b = __shfl_sync(kFull, id, q0 + __ffs(bits) - 1);
              if (np > 1) {
                visit_node(b);
              } else if (!fetch(b)) {
                break;
              }
            }
          }
          if (n < 32) break;
        }
      } else {
        for (int g = 0; g < nn; g += 32) {
          unsigned bits = reached(g, min(32, nn - g), nn);
          lap(t_skip);
          for (; bits; bits &= bits - 1) visit_node(g + __ffs(bits) - 1);
        }
      }
      if (pending >= 0) test(pending, issued - 1);
    }
  };

  if (kAlpha) {
    // the alpha loop: while some lane of the warp is live, a round walks
    // the live lanes' [t_min, t_max] (a dead lane's limit is -1: it gates
    // nothing), then each live lane tests its hit's texel alpha; a rejected
    // hit moves the lane's t_min past it and keeps it live, any other
    // result (a miss included) is written and ends it. A lane live after
    // the last round keeps the miss.
    const float t_max0 = t_max;
    bool live = i < al.n;
    unsigned rounds = 0;
    for (int r = 0; r < al.rounds && __any_sync(kFull, live); ++r) {
      ++rounds;
      t_max = live ? t_max0 : -1.0f;
      best = kBig;
      best_tri = -1;
      pending = -1;
      walk();
      if (live) {
        float t = best, u = 0.0f, v = 0.0f;
        if (best_tri >= 0 && alpha_rejects(al, best_tri, o.x, o.y, o.z, dx, dy, dz, &t, &u, &v)) {
          t_min = __fadd_rn(t, kAdvance);
        } else {
          out_t[i] = t;
          out_tri[i] = best_tri;
          al.out_u[i] = u;
          al.out_v[i] = v;
          live = false;
        }
      }
    }
    if (live) {
      out_t[i] = kBig;
      out_tri[i] = -1;
      al.out_u[i] = 0.0f;
      al.out_v[i] = 0.0f;
    }
    if (kProf) {
      unsigned long long* p = prof + 2 * (i >> 5);
      if (lane == 0) p[0] = rounds;
      if (pairs) atomicAdd(p + 1, pairs);
    }
    return;
  }
  walk();

  if (kAny) {
    out_occ[i] = occ ? 1 : 0;
  } else {
    out_t[i] = best;
    out_tri[i] = best_tri;
  }
  if (kProf) {
    unsigned long long* p = prof + kProfFields * blockIdx.x;
    if (lane == 0) {
      atomicAdd(p + 0, (unsigned long long)t_list);
      atomicAdd(p + 1, (unsigned long long)t_skip);
      atomicAdd(p + 2, (unsigned long long)t_gate);
      atomicAdd(p + 3, (unsigned long long)t_wait);
      atomicAdd(p + 4, (unsigned long long)t_pair);
      atomicAdd(p + 5, (unsigned long long)(clock64() - t_begin));
      atomicAdd(p + 7, wpairs);
      atomicAdd(p + 8, visits);
      atomicAdd(p + 9, cvisits);
    }
    if (pairs) atomicAdd(p + 6, pairs);
  }
}

// Host side: launch the walk on `stream` (no synchronisation, no
// allocation); returns cudaGetLastError() (0 = launched). `prof` null
// launches the instance without the profile. `boxes` must be packed for the
// instance's P and S (kBlockList: for bl.node and bl.sub, which the caller
// checks). No rays (n_pad = 0): nothing is launched.
template <int P, int S, int kSrc, bool kAny, bool kAlpha = false>
int launch_walk(const float* rays, int64_t n_pad, const float* rows4, const float* boxes, int nc,
                int block, const uint8_t* occ_in, float* out_t, int* out_tri, uint8_t* out_occ,
                unsigned long long* prof, void* stream, BlockList bl = {}, AlphaTables al = {}) {
  if (block != kBlock || n_pad < 0 || n_pad % kBlock != 0 || nc < 0 ||
      (kSrc == kNodeList && nc > kMaxClusters)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = walk_smem_bytes(nc, P, kSrc == kNodeList);
  const unsigned nb = (unsigned)(n_pad / kBlock);
  if (nb == 0) return (int)cudaGetLastError();
  const float4* r4 = reinterpret_cast<const float4*>(rows4);
  const float4* b4 = reinterpret_cast<const float4*>(boxes);
  if (prof != nullptr) {
    woop_walk_kernel<P, S, kSrc, kAny, true, kAlpha><<<nb, kBlock, bytes, (cudaStream_t)stream>>>(
        rays, n_pad, r4, b4, nc, occ_in, out_t, out_tri, out_occ, bl, prof, al);
  } else {
    woop_walk_kernel<P, S, kSrc, kAny, false, kAlpha><<<nb, kBlock, bytes, (cudaStream_t)stream>>>(
        rays, n_pad, r4, b4, nc, occ_in, out_t, out_tri, out_occ, bl, nullptr, al);
  }
  return (int)cudaGetLastError();
}

// CTAs of the frame instance that fit one SM for a table of nc clusters
template <int P, int S, int kSrc, bool kAny, bool kAlpha = false>
int walk_ctas_per_sm(int nc) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, woop_walk_kernel<P, S, kSrc, kAny, false, kAlpha>, kBlock,
      walk_smem_bytes(nc, P, kSrc == kNodeList));
  return n;
}

}  // namespace mq
