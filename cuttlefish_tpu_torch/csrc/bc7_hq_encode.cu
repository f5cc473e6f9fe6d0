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
// Design: one thread per 4x4 block, 128 threads per CTA, grid =
// ceil(N / 128), as the quality 0-2 kernel (bc7_encode.cu).  The TPU kernel
// put 512 blocks on vector lanes and ran its partition screens as MXU
// matmuls against 0/1 membership matrices; here each screen is a loop over
// uint16 membership masks in __constant__ memory that sums the same moments
// in texel order, and the top-k partitions are kept by an insertion that
// breaks ties to the lowest index, as the TPU kernel's _topk_parts does.
//
// What bounds it: arithmetic, as at quality 0-2, and more so: a block reads
// 256 bytes and writes 16 but runs many fits (up to 18 at quality 4).  Its
// per-block state overflows the 255-register limit, so each mode is its own
// non-inlined function: only the texels, the best bits and the best error
// live across modes, each mode's state lives in that mode's frame (local
// memory, cached in L1 where it spills), and each mode compiles once for
// both qualities.  Registers and spills per entry are in the build log.
//
// Numerics: the rules of bc7_common.cuh (texel-order sums, rintf, no FMA
// contraction, IEEE division, first minimum on ties).  The device functions
// are plain C++; the __global__ kernel and the launchers sit under
// __CUDACC__.

#include <type_traits>

#include "bc7_common.cuh"

namespace bc7 {

// Bit t of c_part3[p][s]: texel t lies in subset s of 3-subset partition p.
__constant__ uint16_t c_part3[64][3];
// Anchors of subsets 1 and 2 of each 3-subset partition.
__constant__ int c_anchor3[64][2];

constexpr int kMaxTopk = 4;

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
    for (int t = 0; t < 16; ++t)
      pr[c][t] = s == 0 ? px[0][t] : s == 1 ? px[1][t] : s == 2 ? px[2][t] : px[3][t];
    cwr[c] = s == 0 ? chw[0] : s == 1 ? chw[1] : s == 2 ? chw[2] : chw[3];
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

// The block's principal axis and, per texel, the projection on it, its
// square and the weighted squared norm over CHN channels.
template <int CHN>
__device__ __forceinline__ void screen_moments(const float (*px)[16],
                                               const float* cw,
                                               float (&axis)[3],
                                               float (&proj)[16],
                                               float (&proj2)[16],
                                               float (&w2)[16]) {
  float ones[16];
  fill_ones(ones);
  float hi[3], lo[3], mean[3];
  pca_seed<3>(px, ones, hi, lo, axis, mean);
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    float s = (px[0][t] - mean[0]) * axis[0];
    s += (px[1][t] - mean[1]) * axis[1];
    s += (px[2][t] - mean[2]) * axis[2];
    proj[t] = s;
    proj2[t] = s * s;
    float q = cw[0] * px[0][t] * px[0][t];
#pragma unroll
    for (int c = 1; c < CHN; ++c) q += cw[c] * px[c][t] * px[c][t];
    w2[t] = q;
  }
}

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

// ---------------------------------------------------------------------------
// Modes, each its own frame
// ---------------------------------------------------------------------------

__device__ __noinline__ float hq_mode6(const float (*px)[16], int iters,
                                       const float* chw, Bits& out) {
  return mode6(px, iters, chw, out);
}

__device__ __noinline__ float hq_mode5(const float (*px)[16], int iters,
                                       const float* chw, int rot, Bits& out) {
  return mode5(px, iters, chw, rot, out);
}

// Mode 4 with both index modes, the lower error kept (first on ties).
__device__ __noinline__ float hq_mode4(const float (*px)[16], int iters,
                                       const float* chw, int rot, Bits& out) {
  float err = mode4<0>(px, iters, chw, rot, out);
  Bits cand;
  const float e = mode4<1>(px, iters, chw, rot, cand);
  if (e < err) {
    err = e;
    out = cand;
  }
  return err;
}

// Rotation screen score (bc7_pallas.py:_screen_rot): weighted rank-1
// residual of the colour triple plus a lightly weighted SSE of the
// rotated-out channel.
__device__ __noinline__ float screen_rot(const float (*px)[16],
                                         const float* chw, int r) {
  float pr[4][16], cwr[4];
  rotate(px, chw, r, pr, cwr);
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

// Modes 5 and 4 at rotation r (per block); with iters 0, mode 5 is the
// estimate that ranks two rotations (bc7_pallas.py:1129-1133).
__device__ __noinline__ float rotated_mode5(const float (*px)[16], int iters,
                                            const float* chw, int r,
                                            Bits& out) {
  float pr[4][16], cwr[4];
  rotate(px, chw, r, pr, cwr);
  return hq_mode5(pr, iters, cwr, r, out);
}

__device__ __noinline__ float rotated_mode4(const float (*px)[16], int iters,
                                            const float* chw, int r,
                                            Bits& out) {
  float pr[4][16], cwr[4];
  rotate(px, chw, r, pr, cwr);
  return hq_mode4(pr, iters, cwr, r, out);
}

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

template <int MODE>
__device__ __noinline__ float fit_subset2(const float (*px)[16],
                                          const float* cw,
                                          const float (&axis)[3],
                                          const float (&mk)[16], int iters,
                                          typename TwoSubset<MODE>::Q& q,
                                          int (&idx)[16]) {
  constexpr int CHN = TwoSubset<MODE>::CHN;
  float hi[CHN], lo[CHN];
  seed_of<CHN>(px, mk, axis, hi, lo);
  return fit<CHN, TwoSubset<MODE>::L>(px, mk, cw, iters, hi, lo, q, idx);
}

template <int MODE>
__device__ __noinline__ float mode_2subset(const float (*px)[16],
                                           const float* chw, int iters,
                                           int topk, Bits& out) {
  using S = TwoSubset<MODE>;
  constexpr int CHN = S::CHN;
  constexpr int L = S::L;
  const float cw[4] = {chw[0], chw[1], chw[2], MODE == 7 ? chw[3] : 0.0f};

  float axis[3], proj[16], proj2[16], w2[16];
  screen_moments<CHN>(px, cw, axis, proj, proj2, w2);
  const float tot_all = rt(w2), ps_all = rt(proj), ps2_all = rt(proj2);
  float s1_all[CHN];
#pragma unroll
  for (int c = 0; c < CHN; ++c) s1_all[c] = rt(px[c]);
  TopK top;
  top.init(topk);
#pragma unroll 1
  for (int p = 0; p < 64; ++p) {
    const uint32_t m = c_part2[p];
    float s1[CHN], r1[CHN], tot, pss, ps2;
    member_sums<CHN>(px, m, w2, proj, proj2, s1, tot, pss, ps2);
#pragma unroll
    for (int c = 0; c < CHN; ++c) r1[c] = s1_all[c] - s1[c];
    const float ns = (float)__popc(m);
    const float score =
        sub_err<CHN>(tot, s1, pss, ps2, ns + 1e-6f, cw) +
        sub_err<CHN>(tot_all - tot, r1, ps_all - pss, ps2_all - ps2,
                     (16.0f - ns) + 1e-6f, cw);
    top.offer(score, p);
  }

  // Estimate-then-refine: one unrefined fit per candidate ranks them.
  int part = top.part[0];
  if (topk > 1) {
    float best = 0.0f;
#pragma unroll 1
    for (int i = 0; i < topk; ++i) {
      const uint32_t m1 = c_part2[top.part[i]];
      float e = 0.0f;
#pragma unroll 1
      for (int s = 0; s < 2; ++s) {
        float mk[16];
        mask_of(s ? m1 : ~m1 & 0xFFFFu, mk);
        typename S::Q q;
        int idx[16];
        const float se = fit_subset2<MODE>(px, cw, axis, mk, 0, q, idx);
        e = s ? e + se : se;
      }
      if (i == 0 || e < best) {
        best = e;
        part = top.part[i];
      }
    }
  }

  const uint32_t m1 = c_part2[part];
  const uint32_t m0 = ~m1 & 0xFFFFu;
  const int anchor1 = c_anchor2[part];
  float mk0[16], mk1[16];
  mask_of(m0, mk0);
  mask_of(m1, mk1);
  typename S::Q q0, q1;
  int idx0[16], idx1[16];
  const float err0 = fit_subset2<MODE>(px, cw, axis, mk0, iters, q0, idx0);
  const float err1 = fit_subset2<MODE>(px, cw, axis, mk1, iters, q1, idx1);
  float err = err0 + err1;
  if (MODE != 7) err = err + alpha_penalty(px, chw);

  int idx[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) idx[t] = ((m1 >> t) & 1u) ? idx1[t] : idx0[t];
  const bool swap0 = anchor_fix<L>(idx, m0, 0);
  const bool swap1 = anchor_fix<L>(idx, m1, anchor1);

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
  return err;
}

// Modes 0/2 over the top-k 3-subset partitions (bc7_pallas.py:
// _mode_3subset).  Mode 0: the first 16 partitions, RGB 4.4 p-bit each,
// 3-bit indices; mode 2: all 64, RGB 5.5 without p-bits, 2-bit indices.
template <int MODE>
struct ThreeSubset {
  static constexpr int LIMIT = MODE == 0 ? 16 : 64;
  static constexpr int L = MODE == 0 ? 8 : 4;
  static constexpr int BITS = MODE == 0 ? 4 : 5;
  using Q = typename std::conditional<MODE == 0, QPbitEach<4, 3>,
                                      QPlain<5>>::type;
};

template <int MODE>
__device__ __noinline__ float fit_subset3(const float (*px)[16],
                                          const float* cw,
                                          const float (&axis)[3],
                                          const float (&mk)[16], int iters,
                                          typename ThreeSubset<MODE>::Q& q,
                                          int (&idx)[16]) {
  float hi[3], lo[3];
  seed_of<3>(px, mk, axis, hi, lo);
  return fit<3, ThreeSubset<MODE>::L>(px, mk, cw, iters, hi, lo, q, idx);
}

template <int MODE>
__device__ __noinline__ float mode_3subset(const float (*px)[16],
                                           const float* chw, int iters,
                                           int topk, Bits& out) {
  using S = ThreeSubset<MODE>;
  constexpr int L = S::L;
  const float cw[4] = {chw[0], chw[1], chw[2], 0.0f};

  float axis[3], proj[16], proj2[16], w2[16];
  screen_moments<3>(px, cw, axis, proj, proj2, w2);
  TopK top;
  top.init(topk);
#pragma unroll 1
  for (int p = 0; p < S::LIMIT; ++p) {
    float score = 0.0f;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const uint32_t m = c_part3[p][s];
      float s1[3], tot, pss, ps2;
      member_sums<3>(px, m, w2, proj, proj2, s1, tot, pss, ps2);
      const float sc =
          sub_err<3>(tot, s1, pss, ps2, (float)__popc(m) + 1e-6f, cw);
      score = s == 0 ? sc : score + sc;
    }
    top.offer(score, p);
  }

  int part = top.part[0];
  if (topk > 1) {
    float best = 0.0f;
#pragma unroll 1
    for (int i = 0; i < topk; ++i) {
      float e = 0.0f;
#pragma unroll 1
      for (int s = 0; s < 3; ++s) {
        float mk[16];
        mask_of(c_part3[top.part[i]][s], mk);
        typename S::Q q;
        int idx[16];
        const float se = fit_subset3<MODE>(px, cw, axis, mk, 0, q, idx);
        e = s ? e + se : se;
      }
      if (i == 0 || e < best) {
        best = e;
        part = top.part[i];
      }
    }
  }

  const int anchors[3] = {0, c_anchor3[part][0], c_anchor3[part][1]};
  typename S::Q q[3];
  int idx[16];
  float err = alpha_penalty(px, chw);
#pragma unroll 1
  for (int s = 0; s < 3; ++s) {
    const uint32_t m = c_part3[part][s];
    float mk[16];
    mask_of(m, mk);
    int si[16];
    err = err + fit_subset3<MODE>(px, cw, axis, mk, iters, q[s], si);
#pragma unroll
    for (int t = 0; t < 16; ++t)
      if (s == 0 || ((m >> t) & 1u)) idx[t] = si[t];
  }
  bool swap[3];
#pragma unroll
  for (int s = 0; s < 3; ++s)
    swap[s] = anchor_fix<L>(idx, c_part3[part][s], anchors[s]);

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
  return err;
}

// ---------------------------------------------------------------------------
// One block
// ---------------------------------------------------------------------------

struct Best {
  Bits bits;
  float err;
  __device__ __forceinline__ void offer(float e, const Bits& cand) {
    if (e < err) {
      err = e;
      bits = cand;
    }
  }
};

// Quality 3: iters 3, rotation 0, top-2 for modes 1 and 3, top-1 for mode
// 0.  Quality 4: iters 4, the rotation screen, top-4 for modes 1 and 3,
// top-2 for modes 7, 0 and 2 (bc7_pallas.py:_HQ_PLAN).
template <int Q>
__device__ __forceinline__ void encode_block_hq(const float (*px)[16],
                                                const float* chw,
                                                uint32_t (&words)[4]) {
  constexpr int iters = Q == 3 ? 3 : 4;
  Best best;
  Bits cand;
  best.err = hq_mode6(px, iters, chw, best.bits);
  if (Q == 3) {
    best.offer(hq_mode5(px, iters, chw, 0, cand), cand);
    best.offer(hq_mode4(px, iters, chw, 0, cand), cand);
  } else {
    // The two best rotations by the screen (first on ties), then the
    // better of them by one unrefined mode-5 fit.
    float sc[4];
#pragma unroll 1
    for (int r = 0; r < 4; ++r) sc[r] = screen_rot(px, chw, r);
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
    const float e1 = rotated_mode5(px, 0, chw, r1, cand);
    const float e2 = rotated_mode5(px, 0, chw, r2, cand);
    const int rbest = e2 < e1 ? r2 : r1;
    best.offer(rotated_mode5(px, iters, chw, rbest, cand), cand);
    best.offer(rotated_mode4(px, iters, chw, rbest, cand), cand);
  }
  best.offer(mode_2subset<1>(px, chw, iters, Q == 3 ? 2 : 4, cand), cand);
  best.offer(mode_2subset<3>(px, chw, iters, Q == 3 ? 2 : 4, cand), cand);
  if (Q == 4) best.offer(mode_2subset<7>(px, chw, iters, 2, cand), cand);
  best.offer(mode_3subset<0>(px, chw, iters, Q == 3 ? 1 : 2, cand), cand);
  if (Q == 4) best.offer(mode_3subset<2>(px, chw, iters, 2, cand), cand);
  words[0] = (uint32_t)best.bits.lo;
  words[1] = (uint32_t)(best.bits.lo >> 32);
  words[2] = (uint32_t)best.bits.hi;
  words[3] = (uint32_t)(best.bits.hi >> 32);
}

#ifdef __CUDACC__

struct Chw {
  float w[4];
};

template <int Q>
__global__ void __launch_bounds__(kThreads)
    bc7_hq_kernel(const float4* __restrict__ blocks, uint4* __restrict__ out,
                  int n, Chw chw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float px[4][16];
  const float4* src = blocks + (size_t)i * 16;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const float4 q = src[t];
    px[0][t] = clampf(q.x, 0.0f, 1.0f) * 255.0f;
    px[1][t] = clampf(q.y, 0.0f, 1.0f) * 255.0f;
    px[2][t] = clampf(q.z, 0.0f, 1.0f) * 255.0f;
    px[3][t] = clampf(q.w, 0.0f, 1.0f) * 255.0f;
  }
  uint32_t words[4];
  encode_block_hq<Q>(px, chw.w, words);
  out[i] = make_uint4(words[0], words[1], words[2], words[3]);
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

// blocks: [n,16,4] float32 device pointer; out: [n,4] uint32.  Launches on
// `stream` and returns cudaGetLastError() (the launch is not synchronised).
extern "C" int bc7_hq_encode_launch(const void* blocks, void* out, int n,
                                    int quality, float w0, float w1, float w2,
                                    float w3, void* stream) {
  if (n <= 0) return 0;
  const bc7::Chw chw = {{w0, w1, w2, w3}};
  const dim3 grid((n + bc7::kThreads - 1) / bc7::kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const float4* in = (const float4*)blocks;
  uint4* o = (uint4*)out;
  switch (quality) {
    case 3: bc7::bc7_hq_kernel<3><<<grid, bc7::kThreads, 0, s>>>(in, o, n, chw); break;
    case 4: bc7::bc7_hq_kernel<4><<<grid, bc7::kThreads, 0, s>>>(in, o, n, chw); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
