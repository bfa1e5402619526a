// The alpha walk on Hopper: the nearest *accepted* hit of each ray, the whole
// alpha re-trace loop of trace_nearest in one launch. Two instances of the
// walk (csrc/woop_walk.cuh): K1's, clusters in index order, for tables of up
// to 65,536 triangles, and K3's, each warp along its own node list, for
// larger ones.
//
// Replaces the TPU package's alpha loop merian_quake_tpu/accel/intersect.py
// :180-241, a lax.while_loop whose body traces every ray (K1's or K3's TPU
// kernel, then XLA's glue) and whose condition, i < max_intersections &
// any(active), is tested on the device. It keeps that loop's function:
//   in:  rays f32[8, n_pad] rows (o.xyz, d.xyz, t_min, t_max), the first n
//        real, the rest padding; the table's packed rows and boxes, as K1's
//        and K3's (csrc/woop_nearest.cu, csrc/woop_stream.cu); the tables
//        of the alpha test (mq::AlphaTables, csrc/woop_common.cuh): the
//        vertices (tri_attr columns 0-8), st, texnum, needs_alpha and the
//        texture atlas's rect table and texels; the loop's cap `rounds`
//        (materials.MAX_INTERSECTIONS).
//   out: t f32, tri i32, u f32, v f32, each [n_pad]: the accepted hit
//        (3e38, -1, 0, 0 on a miss, and for a ray still rejecting after
//        the last round: the reference's cap).
// Per warp, round after round while some lane is live (a warp vote, the
// per-warp form of the reference's any(active)) and fewer than `rounds`
// have run: the walk with each live lane's [t_min, t_max] and each dead
// lane's limit at -1 (it gates nothing), K1's or K3's exactly; then each live
// lane with a hit recomputes its exact (t, u, v) from the triangle's
// vertices (woop._recompute_tuv), interpolates the UV (intersect._hit_uv) and
// reads the texel's alpha (atlas.sample_nearest: GL_REPEAT wrap, texnum
// clamped to the table). A hit on a needs_alpha triangle whose alpha is below
// 0.666 is rejected: the lane's t_min moves to t + 1e-3 and it stays live.
// Any other result, a miss included, is written and ends the lane. So a dead
// ray costs nothing, a warp with no live ray stops, and the loop reads
// nothing from the host. That is _alpha_round's function round for round
// (merian_quake_tpu_torch/accel/intersect.py), whose plain version here is
// woop.woop_alpha_reference; every multiply, add and divide of the epilogue
// is rounded on its own in that version's order, so the kernel equals it bit
// for bit.
//
// The ring's barriers carry their phases from one round to the next (every
// copy is waited for before a round's epilogue), and K3's node list is built
// again each round from the lanes' current limits, so its exit stays exact.
// What bounds it on this card is what bounds K1 and K3: the pairs tested over
// all rounds, 42 FP32 operations each; the epilogue is a few gathers a ray
// and round.

#include "woop_walk.cuh"

using mq::kNode;
using mq::kSub;

namespace {

template <int kSrc>
int launch_alpha(const float* rays, int64_t n_pad, const float* rows4, const float* boxes, int nc,
                 int block, float* out_t, int* out_tri, float* out_u, float* out_v,
                 const float* attr, int attr_stride, const float* st, const int* texnum,
                 const uint8_t* needs, const int* rect, int ntex, const float* texels, int width,
                 int64_t n, int rounds, unsigned long long* prof, void* stream) {
  if (n < 0 || n > n_pad || rounds < 0 || ntex <= 0 || attr_stride < 9) {
    return (int)cudaErrorInvalidValue;
  }
  const mq::AlphaTables al{attr, st, texnum, needs, rect, texels, out_u, out_v,
                           n, attr_stride, ntex, width, rounds};
  return mq::launch_walk<kNode, kSub, kSrc, false, true>(rays, n_pad, rows4, boxes, nc, block,
                                                         nullptr, out_t, out_tri, nullptr, prof,
                                                         stream, {}, al);
}

}  // namespace

// Plain C entry points (bound with ctypes): K1's walk (clusters in index
// order) and K3's (node lists, nc at most 16,384). Each launches on
// `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched). `block` must be 128, `boxes` packed for
// the node sizes below, `rows4` 16-byte aligned. `prof` (u64[2 * n_pad / 32],
// zeroed by the caller, or null) gets per warp the rounds it walked and the
// pairs its lanes tested; null launches the instance without it.
extern "C" int mq_woop_nearest_alpha(const float* rays, int64_t n_pad, const float* rows4,
                                     const float* boxes, int nc, int block, float* out_t,
                                     int* out_tri, float* out_u, float* out_v, const float* attr,
                                     int attr_stride, const float* st, const int* texnum,
                                     const uint8_t* needs, const int* rect, int ntex,
                                     const float* texels, int width, int64_t n, int rounds,
                                     unsigned long long* prof, void* stream) {
  return launch_alpha<mq::kIndexOrder>(rays, n_pad, rows4, boxes, nc, block, out_t, out_tri, out_u,
                                       out_v, attr, attr_stride, st, texnum, needs, rect, ntex,
                                       texels, width, n, rounds, prof, stream);
}

extern "C" int mq_woop_stream_alpha(const float* rays, int64_t n_pad, const float* rows4,
                                    const float* boxes, int nc, int block, float* out_t,
                                    int* out_tri, float* out_u, float* out_v, const float* attr,
                                    int attr_stride, const float* st, const int* texnum,
                                    const uint8_t* needs, const int* rect, int ntex,
                                    const float* texels, int width, int64_t n, int rounds,
                                    unsigned long long* prof, void* stream) {
  return launch_alpha<mq::kNodeList>(rays, n_pad, rows4, boxes, nc, block, out_t, out_tri, out_u,
                                     out_v, attr, attr_stride, st, texnum, needs, rect, ntex,
                                     texels, width, n, rounds, prof, stream);
}

// clusters a node and clusters a sub-node that `boxes` must be packed for
extern "C" int mq_woop_alpha_node() { return kNode; }
extern "C" int mq_woop_alpha_sub() { return kSub; }

// CTAs of each frame instance that fit one SM
extern "C" int mq_woop_nearest_alpha_ctas_per_sm(int nc) {
  return mq::walk_ctas_per_sm<kNode, kSub, mq::kIndexOrder, false, true>(nc);
}
extern "C" int mq_woop_stream_alpha_ctas_per_sm(int nc) {
  return mq::walk_ctas_per_sm<kNode, kSub, mq::kNodeList, false, true>(nc);
}
