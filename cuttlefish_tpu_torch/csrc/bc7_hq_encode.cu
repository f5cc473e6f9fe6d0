// BC7 block encoder, quality 3-4, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel cuttlefish_tpu/kernels/bc7_pallas.py:_kernel_hq
// (launched by encode_bc7_pallas at bc7_pallas.py:1220).  It computes what
// that kernel computes (its _HQ_PLAN): mode 6; modes 5 and 4 (both index
// modes) at rotation 0, or at quality 4 at the per-block winner of a
// rotation screen; modes 1, 3 and 7 over their top-k 2-subset partitions
// and modes 0 and 2 over their top-k 3-subset partitions, each ranked by
// one unrefined fit and then fitted in full.  The lowest error wins.  The
// plain PyTorch version of the same algorithm is
// cuttlefish_tpu_torch/kernels/bc7.py (_encode_hq); the two are compared on
// the card.
//
// Design: a warp per group of G = 32 blocks, 4 warps per CTA, grid =
// ceil(N / 128).  The TPU kernel put 512 blocks on vector lanes and ran its
// partition screens as MXU matmuls against 0/1 membership matrices.  Here
// a warp first stages its blocks' texels in shared memory with one
// coalesced 16-byte copy, clamped and scaled there, a block's [channel]
// [texel] rows padded to 65 floats so that 32 lanes on 32 blocks hit 32
// banks; no texel array lives in a thread's local frame.  The block then
// goes through phases, each a loop of lane tasks in which the 32 lanes run
// the same code on different blocks (task index block-minor), with what a
// later phase needs in the warp's shared memory (14 KB, 56 KB a CTA):
//   1. the partition screens, a lane per block: each of the 64
//      partitions' member sums made once for every list that ranks it
//      (modes 1 and 3 share one list, mode 7 weighs alpha in, modes 0 and 2
//      share the 3-subset scores), in a 2-subset and a 3-subset pass;
//      each list is a top-k kept by an insertion that breaks ties to the
//      lowest partition, as the TPU kernel's _topk_parts does; and, at
//      quality 4, the 4 rotation screens, a lane per (block, rotation);
//   2. the unrefined rank fits, a lane per (block, mode, candidate,
//      subset), and at quality 4 the two rotated mode-5 estimates, a lane
//      per (block, rotation);
//   3. the full fits, a lane per block: each mode's partition from the
//      rank fits (first of least summed error), then modes 6, 5, 4, 1, 3,
//      7, 0 and 2 in that order, the first of least error kept.
// Each task is its own non-inlined function whose fits are inlined, so
// that masks, indices and quantiser states stay in registers.
//
// What bounds it: arithmetic.  A block reads 256 bytes and writes 16 but
// runs many fits (up to 18 at quality 4, and some 30 unrefined ones).  The
// tasks want up to 221 registers and the kernel takes 255, so an SM holds 8
// warps; a register cap spills and runs slower.
//
// Numerics: the rules of bc7_common.cuh (texel-order sums, rintf, no FMA
// contraction, IEEE division, first minimum on ties).  The device functions
// are plain C++; the __global__ kernel and the launchers sit under
// __CUDACC__, and a CPU build runs a group's phases with its 32 lanes one
// after another (bc7_hq_cpu).

#include <type_traits>

#include "bc7_common.cuh"

namespace bc7 {

// Bit t of c_part3[p][s]: texel t lies in subset s of 3-subset partition p.
__constant__ uint16_t c_part3[64][3];
// Anchors of subsets 1 and 2 of each 3-subset partition.
__constant__ int c_anchor3[64][2];

constexpr int kMaxTopk = 4;
constexpr int kHqWarps = 4;  // warps a CTA

// The plan of a quality (bc7_pallas.py:_HQ_PLAN): refinement rounds and
// the top-k of each partitioned mode (0: the mode is not tried).  A list of
// k > 1 candidates is ranked by one unrefined fit per subset of each.
template <int Q>
struct HqPlan {
  static constexpr int iters = Q == 3 ? 3 : 4;
  static constexpr int k13 = Q == 3 ? 2 : 4;  // modes 1 and 3
  static constexpr int k7 = Q == 3 ? 0 : 2;
  static constexpr int k0 = Q == 3 ? 1 : 2;
  static constexpr int k2 = Q == 3 ? 0 : 2;
  // Rank fits of a block per mode, and where each mode's start in the
  // warp's rank table.
  static constexpr int n1 = k13 > 1 ? 2 * k13 : 0;
  static constexpr int n7 = k7 > 1 ? 2 * k7 : 0;
  static constexpr int n0 = k0 > 1 ? 3 * k0 : 0;
  static constexpr int n2 = k2 > 1 ? 3 * k2 : 0;
  static constexpr int o1 = 0, o3 = n1, o7 = 2 * n1, o0 = o7 + n7, o2 = o0 + n0;
  static constexpr int nrank = o2 + n2;
};
static_assert(HqPlan<4>::nrank <= 32 && HqPlan<3>::nrank <= 32, "the warp's rank table holds 32");

// Slots of a block's top-k lists in the warp's shared memory.
enum TopSlot { kTop13 = 0, kTop7 = 4, kTop0 = 6, kTop2 = 8, kTopSlots = 10 };

// A warp's shared memory: [slot][block] arrays, so that a lane per block
// touches its own bank.
struct HqWarp {
  float px[kGroup * kStride];  // block b, channel c, texel t at b * kStride + c * 16 + t
  float rank[32 * kGroup];     // unrefined-fit errors [rank fit][block]
  float rsc[4 * kGroup];       // rotation screens [rotation][block]
  float rest[2 * kGroup];      // rotated mode-5 estimates [r1, r2][block]
  float axis[3 * kGroup];      // the principal axis [channel][block]
  uint8_t top[kTopSlots * kGroup];
  uint8_t rot[2 * kGroup];     // the two best rotations by the screen
};

// A CTA's dynamic shared memory: above the 48 KB a launch gets without
// raising its limit.
constexpr int kHqSmem = kHqWarps * (int)sizeof(HqWarp);

// Channel order of rotation r: channel r-1 swaps with alpha.
__device__ __forceinline__ int rot_src(int c, int r) {
  if (r == 0) return c;
  if (c == r - 1) return 3;
  if (c == 3) return r - 1;
  return c;
}

// px and chw in the channel order of rotation r (bc7_pallas.py:_apply_rot).
__device__ __forceinline__ void rotate(const float (*px)[16], const float* chw,
                                       int r, float (&pr)[4][16],
                                       float (&cwr)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int s = rot_src(c, r);
#pragma unroll
    for (int t = 0; t < 16; ++t) pr[c][t] = px[s][t];
    cwr[c] = chw[s];
  }
}

// Keeps the k lowest scores seen so far, ties to the earlier partition.
struct TopK {
  float score[kMaxTopk];
  int part[kMaxTopk];
  int k;

  __device__ __forceinline__ void init(int kk) {
    k = kk;
    for (int i = 0; i < kMaxTopk; ++i) {
      score[i] = INFINITY;
      part[i] = 0;
    }
  }
  __device__ __forceinline__ void offer(float s, int p) {
    if (!(s < score[k - 1])) return;
    int j = k - 1;
    while (j > 0 && s < score[j - 1]) {
      score[j] = score[j - 1];
      part[j] = part[j - 1];
      --j;
    }
    score[j] = s;
    part[j] = p;
  }
};

// Member sums of one subset mask, in texel order.
template <int CHN>
__device__ __forceinline__ void member_sums(const float (*px)[16], uint32_t m,
                                            const float (&w2)[16],
                                            const float (&proj)[16],
                                            const float (&proj2)[16],
                                            float (&s1)[CHN], float& tot,
                                            float& pss, float& ps2) {
#pragma unroll
  for (int c = 0; c < CHN; ++c) s1[c] = 0.0f;
  tot = pss = ps2 = 0.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    if ((m >> t) & 1u) {
#pragma unroll
      for (int c = 0; c < CHN; ++c) s1[c] += px[c][t];
      tot += w2[t];
      pss += proj[t];
      ps2 += proj2[t];
    }
  }
}

__device__ __forceinline__ void mask_of(uint32_t m, float (&mk)[16]) {
#pragma unroll
  for (int t = 0; t < 16; ++t) mk[t] = ((m >> t) & 1u) ? 1.0f : 0.0f;
}

// Index of the anchor texel of a subset, or 0 when it is not a member (the
// masked sum of bc7_pallas.py:_anchor_fix).
__device__ __forceinline__ int anchor_value(const int (&idx)[16], uint32_t m,
                                            int anchor) {
  int v = 0;
#pragma unroll
  for (int t = 0; t < 16; ++t)
    if (t == anchor && ((m >> t) & 1u)) v = idx[t];
  return v;
}

// Clears the anchor's index MSB by inverting the subset's indices.
template <int L>
__device__ __forceinline__ bool anchor_fix(int (&idx)[16], uint32_t m,
                                           int anchor) {
  const bool swap = anchor_value(idx, m, anchor) >= L / 2;
#pragma unroll
  for (int t = 0; t < 16; ++t)
    if (swap && ((m >> t) & 1u)) idx[t] = (L - 1) - idx[t];
  return swap;
}

// A block's principal axis, passed by value.
struct Axis {
  float v[3];
};

// ---------------------------------------------------------------------------
// Phase 1: the screens
// ---------------------------------------------------------------------------

// The partition screens of one block (bc7_pallas.py:_screen_2subset and
// _mode_3subset's screen), in two passes that each make the block's
// principal axis and texel moments: the 2-subset lists of modes 1/3 (RGB)
// and 7 (RGBA, quality 4), whose RGB member sums are a prefix of the RGBA
// ones, then the 3-subset lists of modes 0 (the first 16 partitions) and 2
// (all 64, quality 4), which share their scores.  Every list sums the same
// moments in texel order as the mode's own screen would; the lists and the
// axis go to the warp's slots of block b.
template <int Q>
__device__ __noinline__ void screen_2subset(const float (*px)[16], Chw chw, HqWarp& W, int b) {
  using P = HqPlan<Q>;
  constexpr int CHN = Q == 4 ? 4 : 3;
  const float cw3[4] = {chw.w[0], chw.w[1], chw.w[2], 0.0f};
  const float cw4[4] = {chw.w[0], chw.w[1], chw.w[2], chw.w[3]};
  float ones[16];
  fill_ones(ones);
  float hi[3], lo[3], axis[3], mean[3];
  pca_seed<3>(px, ones, hi, lo, axis, mean);
  float proj[16], proj2[16], w2[16], w24[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    float s = (px[0][t] - mean[0]) * axis[0];
    s += (px[1][t] - mean[1]) * axis[1];
    s += (px[2][t] - mean[2]) * axis[2];
    proj[t] = s;
    proj2[t] = s * s;
    float q = cw3[0] * px[0][t] * px[0][t];
    q += cw3[1] * px[1][t] * px[1][t];
    q += cw3[2] * px[2][t] * px[2][t];
    w2[t] = q;
    if (Q == 4) w24[t] = q + cw4[3] * px[3][t] * px[3][t];
  }
  const float tot_all = rt(w2), ps_all = rt(proj), ps2_all = rt(proj2);
  const float tot_all4 = Q == 4 ? rt(w24) : 0.0f;
  float s1_all[CHN];
#pragma unroll
  for (int c = 0; c < CHN; ++c) s1_all[c] = rt(px[c]);
  TopK t13, t7;
  t13.init(P::k13);
  t7.init(Q == 4 ? P::k7 : 1);
#pragma unroll 1
  for (int p = 0; p < 64; ++p) {
    const uint32_t m = c_part2[p];
    float s1[CHN], tot, pss, ps2, tot4 = 0.0f;
#pragma unroll
    for (int c = 0; c < CHN; ++c) s1[c] = 0.0f;
    tot = pss = ps2 = 0.0f;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      if ((m >> t) & 1u) {
#pragma unroll
        for (int c = 0; c < CHN; ++c) s1[c] += px[c][t];
        tot += w2[t];
        if (Q == 4) tot4 += w24[t];
        pss += proj[t];
        ps2 += proj2[t];
      }
    }
    const float ns = (float)__popc(m);
    float a3[3], r3[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a3[c] = s1[c];
      r3[c] = s1_all[c] - s1[c];
    }
    t13.offer(sub_err<3>(tot, a3, pss, ps2, ns + 1e-6f, cw3) +
                  sub_err<3>(tot_all - tot, r3, ps_all - pss, ps2_all - ps2,
                             (16.0f - ns) + 1e-6f, cw3),
              p);
    if constexpr (Q == 4) {
      float a4[4], r4[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        a4[c] = s1[c];
        r4[c] = s1_all[c] - s1[c];
      }
      t7.offer(sub_err<4>(tot4, a4, pss, ps2, ns + 1e-6f, cw4) +
                   sub_err<4>(tot_all4 - tot4, r4, ps_all - pss, ps2_all - ps2,
                              (16.0f - ns) + 1e-6f, cw4),
               p);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) W.axis[c * kGroup + b] = axis[c];
  for (int i = 0; i < P::k13; ++i) W.top[(kTop13 + i) * kGroup + b] = (uint8_t)t13.part[i];
  for (int i = 0; i < P::k7; ++i) W.top[(kTop7 + i) * kGroup + b] = (uint8_t)t7.part[i];
}

template <int Q>
__device__ __noinline__ void screen_3subset(const float (*px)[16], Chw chw, HqWarp& W, int b) {
  using P = HqPlan<Q>;
  constexpr int LIMIT3 = Q == 4 ? 64 : 16;
  const float cw3[4] = {chw.w[0], chw.w[1], chw.w[2], 0.0f};
  float ones[16];
  fill_ones(ones);
  float hi[3], lo[3], axis[3], mean[3];
  pca_seed<3>(px, ones, hi, lo, axis, mean);
  float proj[16], proj2[16], w2[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    float s = (px[0][t] - mean[0]) * axis[0];
    s += (px[1][t] - mean[1]) * axis[1];
    s += (px[2][t] - mean[2]) * axis[2];
    proj[t] = s;
    proj2[t] = s * s;
    float q = cw3[0] * px[0][t] * px[0][t];
    q += cw3[1] * px[1][t] * px[1][t];
    q += cw3[2] * px[2][t] * px[2][t];
    w2[t] = q;
  }
  TopK t0, t2;
  t0.init(P::k0);
  t2.init(Q == 4 ? P::k2 : 1);
#pragma unroll 1
  for (int p = 0; p < LIMIT3; ++p) {
    float score = 0.0f;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const uint32_t ms = c_part3[p][s];
      float m1[3], mt, mp, mp2;
      member_sums<3>(px, ms, w2, proj, proj2, m1, mt, mp, mp2);
      const float sc = sub_err<3>(mt, m1, mp, mp2, (float)__popc(ms) + 1e-6f, cw3);
      score = s == 0 ? sc : score + sc;
    }
    if (p < 16) t0.offer(score, p);
    if (Q == 4) t2.offer(score, p);
  }
  for (int i = 0; i < P::k0; ++i) W.top[(kTop0 + i) * kGroup + b] = (uint8_t)t0.part[i];
  for (int i = 0; i < P::k2; ++i) W.top[(kTop2 + i) * kGroup + b] = (uint8_t)t2.part[i];
}

// Two passes with fewer live moments run faster than one that feeds all
// four lists at once.
template <int Q>
__device__ __noinline__ void screen_block(const float (*px)[16], Chw chw,
                                          HqWarp& W, int b) {
  screen_2subset<Q>(px, chw, W, b);
  screen_3subset<Q>(px, chw, W, b);
}

// Rotation screen score (bc7_pallas.py:_screen_rot): weighted rank-1
// residual of the colour triple plus a lightly weighted SSE of the
// rotated-out channel.
__device__ __noinline__ float screen_rot(const float (*px)[16], Chw chw,
                                         int r) {
  float pr[4][16], cwr[4];
  rotate(px, chw.w, r, pr, cwr);
  float ones[16];
  fill_ones(ones);
  float hi[3], lo[3], axis[3], mean[3];
  pca_seed<3>(pr, ones, hi, lo, axis, mean);
  float cent[3][16], proj[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
#pragma unroll
    for (int c = 0; c < 3; ++c) cent[c][t] = pr[c][t] - mean[c];
    float s = cent[0][t] * axis[0];
    s += cent[1][t] * axis[1];
    s += cent[2][t] * axis[2];
    proj[t] = s;
  }
  float resid = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float r2 = 0.0f;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const float d = cent[c][t] - proj[t] * axis[c];
      r2 = t == 0 ? d * d : r2 + d * d;
    }
    const float term = cwr[c] * r2;
    resid = c == 0 ? term : resid + term;
  }
  const float amean = rt(pr[3]) / 16.0f;
  float asse = 0.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const float d = pr[3][t] - amean;
    asse = t == 0 ? d * d : asse + d * d;
  }
  // 0.03 * weight is a double product rounded once to float32, as the
  // reference computes it from its Python float weights.
  const float aw = (float)(0.03 * (double)cwr[3]);
  return resid + aw * asse;
}

// ---------------------------------------------------------------------------
// Modes 1/3/7 (2 subsets) and 0/2 (3 subsets): rank fits and full fits
// ---------------------------------------------------------------------------

// Modes 1/3/7 over the top-k 2-subset partitions (bc7_pallas.py:
// _mode_2subset).  Mode 1: RGB 6.6 shared p-bit, 3-bit indices; mode 3:
// RGB 7.7 p-bit each, 2-bit; mode 7: RGBA 5.5 p-bit each, 2-bit.
template <int MODE>
struct TwoSubset {
  static constexpr int CHN = MODE == 7 ? 4 : 3;
  static constexpr int L = MODE == 1 ? 8 : 4;
  static constexpr int BITS = MODE == 1 ? 6 : MODE == 3 ? 7 : 5;
  using Q = typename std::conditional<MODE == 1, QMode1,
                                      QPbitEach<BITS, CHN>>::type;
};

// Modes 0/2 over the top-k 3-subset partitions (bc7_pallas.py:
// _mode_3subset).  Mode 0: the first 16 partitions, RGB 4.4 p-bit each,
// 3-bit indices; mode 2: all 64, RGB 5.5 without p-bits, 2-bit indices.
template <int MODE>
struct ThreeSubset {
  static constexpr int CHN = 3;
  static constexpr int L = MODE == 0 ? 8 : 4;
  static constexpr int BITS = MODE == 0 ? 4 : 5;
  using Q = typename std::conditional<MODE == 0, QPbitEach<4, 3>,
                                      QPlain<5>>::type;
};

template <int MODE>
using Subsets = typename std::conditional<MODE == 0 || MODE == 2, ThreeSubset<MODE>,
                                          TwoSubset<MODE>>::type;

// The mode's channel weights: alpha only for mode 7.
template <int MODE>
__device__ __forceinline__ void mode_weights(const Chw& chw, float (&cw)[4]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) cw[c] = chw.w[c];
  cw[3] = MODE == 7 ? chw.w[3] : 0.0f;
}

// Subset mask s of partition `part`: 2 subsets (0: the complement of the
// table's subset 1), or 3 from the 3-subset table.
template <int MODE>
__device__ __forceinline__ uint32_t subset_mask(int part, int s) {
  if (MODE == 0 || MODE == 2) return c_part3[part][s];
  const uint32_t m1 = c_part2[part];
  return s ? m1 : ~m1 & 0xFFFFu;
}

// One subset's fit from the principal-axis seed: unrefined (iters 0) for
// the ranking, or in full.
template <int MODE>
__device__ __forceinline__ float fit_subset(const float (*px)[16],
                                            const float (&cw)[4],
                                            const float (&axis)[3],
                                            uint32_t m, int iters,
                                            typename Subsets<MODE>::Q& q,
                                            int (&idx)[16]) {
  constexpr int CHN = Subsets<MODE>::CHN;
  float mk[16];
  mask_of(m, mk);
  float hi[CHN], lo[CHN];
  seed_of<CHN>(px, mk, axis, hi, lo);
  return fit<CHN, Subsets<MODE>::L>(px, mk, cw, iters, hi, lo, q, idx);
}

// The unrefined fit of subset s of partition `part` (a rank fit).
template <int MODE>
__device__ __noinline__ float rank_fit(const float (*px)[16], Chw chw, Axis ax,
                                       int part, int s) {
  const float axis[3] = {ax.v[0], ax.v[1], ax.v[2]};
  float cw[4];
  mode_weights<MODE>(chw, cw);
  typename Subsets<MODE>::Q q;
  int idx[16];
  return fit_subset<MODE>(px, cw, axis, subset_mask<MODE>(part, s), 0, q, idx);
}

// Modes 1/3/7 fitted in full on partition `part`, packed.
template <int MODE>
__device__ __noinline__ Res full_2subset(const float (*px)[16], Chw chw, Axis ax,
                                         int part, int iters) {
  using S = TwoSubset<MODE>;
  const float axis[3] = {ax.v[0], ax.v[1], ax.v[2]};
  constexpr int CHN = S::CHN;
  constexpr int L = S::L;
  float cw[4];
  mode_weights<MODE>(chw, cw);
  const uint32_t m1 = c_part2[part];
  const uint32_t m0 = ~m1 & 0xFFFFu;
  const int anchor1 = c_anchor2[part];
  typename S::Q q0, q1;
  int idx0[16], idx1[16];
  const float err0 = fit_subset<MODE>(px, cw, axis, m0, iters, q0, idx0);
  const float err1 = fit_subset<MODE>(px, cw, axis, m1, iters, q1, idx1);
  Res res;
  res.err = err0 + err1;
  if (MODE != 7) res.err = res.err + alpha_penalty(px, chw.w);

  int idx[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) idx[t] = ((m1 >> t) & 1u) ? idx1[t] : idx0[t];
  const bool swap0 = anchor_fix<L>(idx, m0, 0);
  const bool swap1 = anchor_fix<L>(idx, m1, anchor1);

  Bits& out = res.bits;
  out.clear();
  if (MODE == 1) out.put(2, 2);
  if (MODE == 3) out.put(8, 4);
  if (MODE == 7) out.put(128, 8);
  out.put(part, 6);
#pragma unroll
  for (int c = 0; c < CHN; ++c) {
    out.put(swap0 ? q0.v1[c] : q0.v0[c], S::BITS);
    out.put(swap0 ? q0.v0[c] : q0.v1[c], S::BITS);
    out.put(swap1 ? q1.v1[c] : q1.v0[c], S::BITS);
    out.put(swap1 ? q1.v0[c] : q1.v1[c], S::BITS);
  }
  if constexpr (MODE == 1) {
    out.put(q0.p, 1);
    out.put(q1.p, 1);
  } else {
    out.put(swap0 ? q0.p1 : q0.p0, 1);
    out.put(swap0 ? q0.p0 : q0.p1, 1);
    out.put(swap1 ? q1.p1 : q1.p0, 1);
    out.put(swap1 ? q1.p0 : q1.p1, 1);
  }
  constexpr int NB = MODE == 1 ? 3 : 2;
#pragma unroll
  for (int t = 0; t < 16; ++t)
    out.put(idx[t], NB - (t == 0 ? 1 : 0) - (t == anchor1 ? 1 : 0));
  return res;
}

// Modes 0/2 fitted in full on partition `part`, packed.
template <int MODE>
__device__ __noinline__ Res full_3subset(const float (*px)[16], Chw chw, Axis ax,
                                         int part, int iters) {
  using S = ThreeSubset<MODE>;
  const float axis[3] = {ax.v[0], ax.v[1], ax.v[2]};
  constexpr int L = S::L;
  float cw[4];
  mode_weights<MODE>(chw, cw);
  const int anchors[3] = {0, c_anchor3[part][0], c_anchor3[part][1]};
  typename S::Q q[3];
  int idx[16];
  Res res;
  res.err = alpha_penalty(px, chw.w);
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const uint32_t m = c_part3[part][s];
    int si[16];
    res.err = res.err + fit_subset<MODE>(px, cw, axis, m, iters, q[s], si);
#pragma unroll
    for (int t = 0; t < 16; ++t)
      if (s == 0 || ((m >> t) & 1u)) idx[t] = si[t];
  }
  bool swap[3];
#pragma unroll
  for (int s = 0; s < 3; ++s)
    swap[s] = anchor_fix<L>(idx, c_part3[part][s], anchors[s]);

  Bits& out = res.bits;
  out.clear();
  if (MODE == 0) {
    out.put(1, 1);
    out.put(part, 4);
  } else {
    out.put(4, 3);
    out.put(part, 6);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      out.put(swap[s] ? q[s].v1[c] : q[s].v0[c], S::BITS);
      out.put(swap[s] ? q[s].v0[c] : q[s].v1[c], S::BITS);
    }
  }
  if constexpr (MODE == 0) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      out.put(swap[s] ? q[s].p1 : q[s].p0, 1);
      out.put(swap[s] ? q[s].p0 : q[s].p1, 1);
    }
  }
  constexpr int NB = MODE == 0 ? 3 : 2;
#pragma unroll
  for (int t = 0; t < 16; ++t)
    out.put(idx[t], NB - (t == 0 ? 1 : 0) - (t == anchors[1] ? 1 : 0) -
                        (t == anchors[2] ? 1 : 0));
  return res;
}

// ---------------------------------------------------------------------------
// Modes 6, 5 and 4
// ---------------------------------------------------------------------------

__device__ __noinline__ Res full_mode6(const float (*px)[16], Chw chw, int iters) {
  Res res;
  res.err = mode6(px, iters, chw.w, res.bits);
  return res;
}

// Mode 5 at rotation r; with iters 0 the estimate that ranks two
// rotations (bc7_pallas.py:1129-1133).
__device__ __noinline__ Res rotated_mode5(const float (*px)[16], Chw chw, int r,
                                         int iters) {
  float pr[4][16], cwr[4];
  rotate(px, chw.w, r, pr, cwr);
  Res res;
  res.err = mode5(pr, iters, cwr, r, res.bits);
  return res;
}

// Mode 4 at rotation r with both index modes, the lower error kept (first
// on ties).
__device__ __noinline__ Res rotated_mode4(const float (*px)[16], Chw chw, int r,
                                         int iters) {
  float pr[4][16], cwr[4];
  rotate(px, chw.w, r, pr, cwr);
  Res res;
  res.err = mode4<0>(pr, iters, cwr, r, res.bits);
  Bits cand;
  const float e = mode4<1>(pr, iters, cwr, r, cand);
  if (e < res.err) {
    res.err = e;
    res.bits = cand;
  }
  return res;
}

// ---------------------------------------------------------------------------
// A group of blocks
// ---------------------------------------------------------------------------

__device__ __forceinline__ const float (*texels(const HqWarp& W, int b))[16] {
  return block_texels(W.px, b);
}

__device__ __forceinline__ Axis axis_of(const HqWarp& W, int b) {
  Axis a;
#pragma unroll
  for (int c = 0; c < 3; ++c) a.v[c] = W.axis[c * kGroup + b];
  return a;
}

// The rank fits of one mode: a lane per (block, candidate, subset), task
// index block-minor, so that the warp's lanes run one candidate and subset
// on different blocks.
template <int MODE, int K, int OFF>
__device__ __forceinline__ void rank_mode(HqWarp& W, int ng, Chw chw, int slot) {
  constexpr int NS = MODE == 0 || MODE == 2 ? 3 : 2;
  if constexpr (K > 1) {
    FOR_LANES(lane) {
      for (int task = lane; task < ng * K * NS; task += 32) {
        const int j = task / ng, b = task - j * ng;
        const int part = W.top[(slot + j / NS) * kGroup + b];
        W.rank[(OFF + j) * kGroup + b] = rank_fit<MODE>(texels(W, b), chw, axis_of(W, b), part, j % NS);
      }
    }
  }
}

// The partition a mode fits in full: the first of least summed rank error
// over its K candidates (subsets summed in order), or its screen's best.
template <int K, int NS, int OFF>
__device__ __forceinline__ int chosen_part(const HqWarp& W, int b, int slot) {
  int part = W.top[slot * kGroup + b];
  if (K > 1) {
    float best = 0.0f;
    for (int i = 0; i < K; ++i) {
      float e = 0.0f;
      for (int s = 0; s < NS; ++s) {
        const float se = W.rank[(OFF + i * NS + s) * kGroup + b];
        e = s ? e + se : se;
      }
      if (i == 0 || e < best) {
        best = e;
        part = W.top[(slot + i) * kGroup + b];
      }
    }
  }
  return part;
}

__device__ __forceinline__ void offer(Res& best, const Res& r) {
  if (r.err < best.err) best = r;
}

// Phase 3 for block b: its full fits offered in the reference's order
// (strict <: the first of least error wins), its words to o.
template <int Q>
__device__ __noinline__ void full_fits(const HqWarp& W, int b, Chw chw, uint32_t* o) {
  using P = HqPlan<Q>;
  constexpr int iters = P::iters;
  const float (*px)[16] = texels(W, b);
  const Axis axis = axis_of(W, b);
  Res best = full_mode6(px, chw, iters);
  int rbest = 0;
  if (Q == 4) {
    const float e1 = W.rest[b], e2 = W.rest[kGroup + b];
    rbest = e2 < e1 ? W.rot[kGroup + b] : W.rot[b];
  }
  offer(best, rotated_mode5(px, chw, rbest, iters));
  offer(best, rotated_mode4(px, chw, rbest, iters));
  offer(best, full_2subset<1>(px, chw, axis, chosen_part<P::k13, 2, P::o1>(W, b, kTop13), iters));
  offer(best, full_2subset<3>(px, chw, axis, chosen_part<P::k13, 2, P::o3>(W, b, kTop13), iters));
  if (Q == 4)
    offer(best, full_2subset<7>(px, chw, axis, chosen_part<P::k7, 2, P::o7>(W, b, kTop7), iters));
  offer(best, full_3subset<0>(px, chw, axis, chosen_part<P::k0, 3, P::o0>(W, b, kTop0), iters));
  if (Q == 4)
    offer(best, full_3subset<2>(px, chw, axis, chosen_part<P::k2, 3, P::o2>(W, b, kTop2), iters));
  o[0] = (uint32_t)best.bits.lo;
  o[1] = (uint32_t)(best.bits.lo >> 32);
  o[2] = (uint32_t)best.bits.hi;
  o[3] = (uint32_t)(best.bits.hi >> 32);
}

// Phase 1: the partition screens a lane per block; at quality 4 the
// rotation screens a lane per (block, rotation), then a lane per block
// takes its two best rotations (first on ties).
template <int Q>
__device__ __noinline__ void screens(HqWarp& W, int ng, Chw chw) {
  FOR_LANES(lane) {
    for (int b = lane; b < ng; b += 32) screen_block<Q>(texels(W, b), chw, W, b);
  }
  if (Q == 4) {
    FOR_LANES(lane) {
      for (int task = lane; task < 4 * ng; task += 32) {
        const int r = task / ng, b = task - r * ng;
        W.rsc[r * kGroup + b] = screen_rot(texels(W, b), chw, r);
      }
    }
    WARP_SYNC();
    FOR_LANES(lane) {
      for (int b = lane; b < ng; b += 32) {
        float sc[4];
        for (int r = 0; r < 4; ++r) sc[r] = W.rsc[r * kGroup + b];
        int r1 = 0;
        float s1 = sc[0];
        for (int r = 1; r < 4; ++r) {
          if (sc[r] < s1) r1 = r;
          s1 = fminf(sc[r], s1);
        }
        int r2 = 0;
        float s2 = r1 == 0 ? 3e38f : sc[0];
        for (int r = 1; r < 4; ++r) {
          const float sr = r1 == r ? 3e38f : sc[r];
          if (sr < s2) r2 = r;
          s2 = fminf(sr, s2);
        }
        W.rot[b] = (uint8_t)r1;
        W.rot[kGroup + b] = (uint8_t)r2;
      }
    }
  }
}

// Phase 2: the unrefined fits.  At quality 4 mode 5 at the two rotations,
// a lane per (block, rotation); then the rank fits of each mode.
template <int Q>
__device__ __noinline__ void unrefined_fits(HqWarp& W, int ng, Chw chw) {
  using P = HqPlan<Q>;
  if (Q == 4) {
    FOR_LANES(lane) {
      for (int task = lane; task < 2 * ng; task += 32) {
        const int i = task / ng, b = task - i * ng;
        W.rest[i * kGroup + b] = rotated_mode5(texels(W, b), chw, W.rot[i * kGroup + b], 0).err;
      }
    }
  }
  rank_mode<1, P::k13, P::o1>(W, ng, chw, kTop13);
  rank_mode<3, P::k13, P::o3>(W, ng, chw, kTop13);
  rank_mode<7, P::k7, P::o7>(W, ng, chw, kTop7);
  rank_mode<0, P::k0, P::o0>(W, ng, chw, kTop0);
  rank_mode<2, P::k2, P::o2>(W, ng, chw, kTop2);
}

// Quality 3: iters 3, rotation 0, top-2 for modes 1 and 3, top-1 for mode
// 0.  Quality 4: iters 4, the rotation screen, top-4 for modes 1 and 3,
// top-2 for modes 7, 0 and 2 (bc7_pallas.py:_HQ_PLAN).  Blocks i0 .. i0 +
// ng - 1 of blocks [n,16,4] by one warp; W: its shared memory.  Each phase
// is its own function, so that the warp holds no state in registers
// between them.
template <int Q>
__device__ void encode_group_hq(const float* blocks, long long i0, int ng, Chw chw, HqWarp& W,
                                uint32_t* out) {
  stage_texels(blocks, i0, ng, W.px);
  WARP_SYNC();
  screens<Q>(W, ng, chw);
  WARP_SYNC();
  unrefined_fits<Q>(W, ng, chw);
  WARP_SYNC();
  FOR_LANES(lane) {
    for (int b = lane; b < ng; b += 32) full_fits<Q>(W, b, chw, out + (i0 + b) * 4);
  }
}

#ifndef __CUDACC__

// n blocks [n,16,4] at quality 3 or 4 -> words [n,4] on the CPU: groups of
// kGroup blocks, as the card's warps take them, each group's lanes one
// after another.
inline void bc7_hq_cpu(const float* blocks, uint32_t* out, int n, int quality, const float* chw) {
  static HqWarp W;
  const Chw w = {{chw[0], chw[1], chw[2], chw[3]}};
  for (long long i0 = 0; i0 < n; i0 += kGroup) {
    const int ng = n - i0 < kGroup ? (int)(n - i0) : kGroup;
    if (quality == 3)
      encode_group_hq<3>(blocks, i0, ng, w, W, out);
    else
      encode_group_hq<4>(blocks, i0, ng, w, W, out);
  }
}

#endif  // !__CUDACC__

#ifdef __CUDACC__

template <int Q>
__global__ void __launch_bounds__(kHqWarps * 32)
    bc7_hq_kernel(const float* __restrict__ blocks, uint32_t* __restrict__ out,
                  int n, Chw chw) {
  extern __shared__ HqWarp s_warp[];
  const int warp = threadIdx.x >> 5;
  const long long i0 = ((long long)blockIdx.x * kHqWarps + warp) * kGroup;
  if (i0 >= n) return;
  const int ng = n - i0 < kGroup ? (int)(n - i0) : kGroup;
  encode_group_hq<Q>(blocks, i0, ng, chw, s_warp[warp], out);
}

#endif  // __CUDACC__

}  // namespace bc7

#ifdef __CUDACC__

// Copies the 2-subset masks and anchors (64 each) and the 3-subset masks
// ([64][3]) and anchors ([64][2]), host arrays, into constant memory of the
// current device.  Returns a cudaError_t.
extern "C" int bc7_hq_set_tables(const uint16_t* masks2, const int* anchors2,
                                 const uint16_t* masks3, const int* anchors3) {
  cudaError_t e = cudaMemcpyToSymbol(bc7::c_part2, masks2, 64 * sizeof(uint16_t));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(bc7::c_anchor2, anchors2, 64 * sizeof(int));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(bc7::c_part3, masks3, 64 * 3 * sizeof(uint16_t));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(bc7::c_anchor3, anchors3, 64 * 2 * sizeof(int));
  return (int)e;
}

// Dynamic shared memory a CTA of the kernel takes.
extern "C" int bc7_hq_shared_bytes() { return bc7::kHqSmem; }

// blocks: [n,16,4] float32 device pointer, 16-byte aligned; out: [n,4]
// uint32.  Launches on `stream` and returns cudaGetLastError() (the launch
// is not synchronised).
extern "C" int bc7_hq_encode_launch(const void* blocks, void* out, int n,
                                    int quality, float w0, float w1, float w2,
                                    float w3, void* stream) {
  if (n <= 0) return 0;
  const bc7::Chw chw = {{w0, w1, w2, w3}};
  constexpr int per_cta = bc7::kHqWarps * bc7::kGroup;
  const dim3 grid((n + per_cta - 1) / per_cta);
  cudaStream_t s = (cudaStream_t)stream;
  const float* in = (const float*)blocks;
  uint32_t* o = (uint32_t*)out;
  const int sm = bc7::kHqSmem;
  cudaError_t e = cudaSuccess;
  switch (quality) {
    case 3:
      e = cudaFuncSetAttribute(bc7::bc7_hq_kernel<3>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm);
      if (e == cudaSuccess) bc7::bc7_hq_kernel<3><<<grid, bc7::kHqWarps * 32, sm, s>>>(in, o, n, chw);
      break;
    case 4:
      e = cudaFuncSetAttribute(bc7::bc7_hq_kernel<4>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm);
      if (e == cudaSuccess) bc7::bc7_hq_kernel<4><<<grid, bc7::kHqWarps * 32, sm, s>>>(in, o, n, chw);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
