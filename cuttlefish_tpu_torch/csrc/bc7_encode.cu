// BC7 block encoder, quality 0-2, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel cuttlefish_tpu/kernels/bc7_pallas.py:_kernel
// (launched by encode_bc7_pallas at bc7_pallas.py:1197).  It computes what
// that kernel computes: modes 6 -> 1 -> 5 -> 4 (mode 1 from quality 1, modes
// 5 and 4 from quality 2), each a PCA seed, least-squares refinement and
// the exact integer-decode error, keeping the lowest error per block.  The
// plain PyTorch version of the same algorithm is
// cuttlefish_tpu_torch/kernels/bc7.py; the two are compared on the card.
//
// Design: one thread per 4x4 block, its 16x4 texels in registers, 128
// threads per CTA, grid = ceil(N / 128).  The TPU kernel put 512 blocks on
// vector lanes and ran mode 1's 64-partition screen as MXU matmuls; here the
// screen is a loop over 64 uint16 membership masks in __constant__ memory
// that sums the same moments (w2, s1, proj, proj^2) exactly.
//
// What bounds it: arithmetic.  A block reads 256 bytes and writes 16, but
// runs thousands of dependent float operations, and its per-block state
// (texels, centred copies, index sets) presses on the 255-register limit,
// so occupancy is low and some state spills to local memory.  Coalesced
// loads, shared-memory staging and a texel-per-lane layout are later work.
//
// Numerics, so that the kernel agrees with the plain version bit for bit:
// every sum over texels runs in texel order; rounding is rintf (half to
// even, as torch.round and jnp.round); every constant is the float32 value
// that JAX and PyTorch use; the build passes --fmad=false so that no a*b+c
// is contracted to one rounding; division and sqrtf stay IEEE (no
// fast-math).  Ties keep the first minimum everywhere (strict <, ascending).
//
// The device functions are plain C++: the __global__ kernel and the
// launchers need nvcc and sit under __CUDACC__.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <math.h>
#include <stdint.h>

namespace bc7 {

constexpr int kThreads = 128;

// Bit t of c_part2[p]: texel t lies in subset 1 of 2-subset partition p.
__constant__ uint16_t c_part2[64];
__constant__ int c_anchor2[64];

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ int qround(float x, int maxv) {
  return (int)clampf(rintf(x), 0.0f, (float)maxv);
}

__device__ __forceinline__ int replicate(int v, int bits) {
  return bits == 8 ? v : (v << (8 - bits)) | (v >> (2 * bits - 8));
}

// BC7 weight round(k*64/(L-1)) as the float32 floor of an odd quotient.
template <int L>
__device__ __forceinline__ int w64(int k) {
  const float inv = (float)(1.0 / (2 * (L - 1)));
  return (int)floorf((float)(k * 128 + (L - 1)) * inv);
}

__device__ __forceinline__ float rt(const float (&x)[16]) {
  float s = x[0];
#pragma unroll
  for (int t = 1; t < 16; ++t) s += x[t];
  return s;
}

__device__ __forceinline__ float rt_mul(const float (&a)[16],
                                        const float (&b)[16]) {
  float s = a[0] * b[0];
#pragma unroll
  for (int t = 1; t < 16; ++t) s += a[t] * b[t];
  return s;
}

// 128-bit little-endian block, filled from bit 0 upwards.
struct Bits {
  uint64_t lo, hi;
  int pos;

  __device__ __forceinline__ void clear() {
    lo = 0;
    hi = 0;
    pos = 0;
  }
  __device__ __forceinline__ void put(int value, int n) {
    const uint64_t v = (uint32_t)value & ((1u << n) - 1u);
    if (pos < 64) {
      lo |= v << pos;
      if (pos + n > 64) hi |= v >> (64 - pos);
    } else {
      hi |= v << (pos - 64);
    }
    pos += n;
  }
};

// Principal-axis extremes of the masked texel set (bc7_pallas.py:_pca_seed).
template <int CHN>
__device__ __forceinline__ void pca_seed(const float (*px)[16],
                                         const float (&mask)[16],
                                         float (&hi)[CHN], float (&lo)[CHN],
                                         float (&v)[CHN], float (&mean)[CHN]) {
  const float cnt = rt(mask) + 1e-6f;
  float cent[CHN][16];
#pragma unroll
  for (int c = 0; c < CHN; ++c) {
    mean[c] = rt_mul(px[c], mask) / cnt;
#pragma unroll
    for (int t = 0; t < 16; ++t) cent[c][t] = (px[c][t] - mean[c]) * mask[t];
  }
  float cov[CHN][CHN];
#pragma unroll
  for (int c = 0; c < CHN; ++c)
#pragma unroll
    for (int d = 0; d < CHN; ++d) cov[c][d] = rt_mul(cent[c], cent[d]);

  // Start from the first texel at the largest norm.
  float nrm[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    float s = cent[0][t] * cent[0][t];
#pragma unroll
    for (int c = 1; c < CHN; ++c) s += cent[c][t] * cent[c][t];
    nrm[t] = s;
  }
  float mx = nrm[0];
#pragma unroll
  for (int t = 1; t < 16; ++t) mx = fmaxf(mx, nrm[t]);
  float start[CHN];
  bool found = false;
#pragma unroll
  for (int c = 0; c < CHN; ++c) start[c] = 0.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    if (!found && nrm[t] == mx) {
      found = true;
#pragma unroll
      for (int c = 0; c < CHN; ++c) start[c] = cent[c][t];
    }
  }
  float n0 = start[0] * start[0];
#pragma unroll
  for (int c = 1; c < CHN; ++c) n0 += start[c] * start[c];
  n0 = sqrtf(n0);
#pragma unroll
  for (int c = 0; c < CHN; ++c)
    v[c] = n0 > 1e-10f ? start[c] / (n0 + 1e-20f) : 1.0f;

  // Power iteration on the covariance.
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    float nv[CHN];
#pragma unroll
    for (int c = 0; c < CHN; ++c) {
      float s = cov[c][0] * v[0];
#pragma unroll
      for (int d = 1; d < CHN; ++d) s += cov[c][d] * v[d];
      nv[c] = s;
    }
    float nn = nv[0] * nv[0];
#pragma unroll
    for (int c = 1; c < CHN; ++c) nn += nv[c] * nv[c];
    nn = sqrtf(nn);
    if (nn > 1e-10f) {
#pragma unroll
      for (int c = 0; c < CHN; ++c) v[c] = nv[c] / (nn + 1e-20f);
    }
  }

  float tmax = -1e30f, tmin = 1e30f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    float s = cent[0][t] * v[0];
#pragma unroll
    for (int c = 1; c < CHN; ++c) s += cent[c][t] * v[c];
    if (mask[t] > 0.0f) {
      tmax = fmaxf(tmax, s);
      tmin = fminf(tmin, s);
    }
  }
#pragma unroll
  for (int c = 0; c < CHN; ++c) {
    hi[c] = mean[c] + v[c] * tmax;
    lo[c] = mean[c] + v[c] * tmin;
  }
}

// ---------------------------------------------------------------------------
// Endpoint quantisers
// ---------------------------------------------------------------------------

// Per-endpoint p-bit (bc7_pallas.py:_quant_pbit_each).
template <int BITS, int CHN>
__device__ __forceinline__ void quant_pbit_each(const float (&e)[CHN],
                                                const float* chw,
                                                int (&v)[CHN], int& p,
                                                int (&dec)[CHN]) {
  constexpr int maxv = (1 << BITS) - 1;
  constexpr int full = (1 << (BITS + 1)) - 1;
  const float scale = (float)(full / 255.0);
  float best = 0.0f;
#pragma unroll
  for (int pp = 0; pp < 2; ++pp) {
    int vv[CHN], dd[CHN];
    float err = 0.0f;
#pragma unroll
    for (int c = 0; c < CHN; ++c) {
      vv[c] = qround((e[c] * scale - (float)pp) * 0.5f, maxv);
      dd[c] = replicate((vv[c] << 1) | pp, BITS + 1);
      const float d = e[c] - (float)dd[c];
      const float term = chw[c] * (d * d);
      err = c == 0 ? term : err + term;
    }
    if (pp == 0 || err < best) {
      best = err;
      p = pp;
#pragma unroll
      for (int c = 0; c < CHN; ++c) {
        v[c] = vv[c];
        dec[c] = dd[c];
      }
    }
  }
}

// One p-bit shared by both endpoints (bc7_pallas.py:_quant_pbit_shared).
template <int BITS>
__device__ __forceinline__ void quant_pbit_shared(
    const float (&e0)[3], const float (&e1)[3], const float* chw,
    int (&v0)[3], int (&v1)[3], int& p, int (&d0)[3], int (&d1)[3]) {
  constexpr int maxv = (1 << BITS) - 1;
  constexpr int full = (1 << (BITS + 1)) - 1;
  const float scale = (float)(full / 255.0);
  float best = 0.0f;
#pragma unroll
  for (int pp = 0; pp < 2; ++pp) {
    int a0[3], a1[3], b0[3], b1[3];
    float err = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a0[c] = qround((e0[c] * scale - (float)pp) * 0.5f, maxv);
      a1[c] = qround((e1[c] * scale - (float)pp) * 0.5f, maxv);
      b0[c] = replicate((a0[c] << 1) | pp, BITS + 1);
      b1[c] = replicate((a1[c] << 1) | pp, BITS + 1);
      const float x0 = e0[c] - (float)b0[c];
      const float x1 = e1[c] - (float)b1[c];
      const float term = chw[c] * (x0 * x0 + x1 * x1);
      err = c == 0 ? term : err + term;
    }
    if (pp == 0 || err < best) {
      best = err;
      p = pp;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        v0[c] = a0[c];
        v1[c] = a1[c];
        d0[c] = b0[c];
        d1[c] = b1[c];
      }
    }
  }
}

template <int BITS>
__device__ __forceinline__ void quant_plain(const float (&e)[3], int (&v)[3],
                                            int (&d)[3]) {
  constexpr int maxv = (1 << BITS) - 1;
  const float scale = (float)(maxv / 255.0);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    v[c] = qround(e[c] * scale, maxv);
    d[c] = replicate(v[c], BITS);
  }
}

// Quantiser states for fit(): each ends in the decoded endpoints d0/d1.
struct QMode6 {
  int v0[4], v1[4], p0, p1, d0[4], d1[4];
  __device__ __forceinline__ void quant(const float (&e0)[4],
                                        const float (&e1)[4],
                                        const float* chw) {
    quant_pbit_each<7, 4>(e0, chw, v0, p0, d0);
    quant_pbit_each<7, 4>(e1, chw, v1, p1, d1);
  }
};

struct QMode1 {
  int v0[3], v1[3], p, d0[3], d1[3];
  __device__ __forceinline__ void quant(const float (&e0)[3],
                                        const float (&e1)[3],
                                        const float* chw) {
    quant_pbit_shared<6>(e0, e1, chw, v0, v1, p, d0, d1);
  }
};

template <int BITS>
struct QPlain {
  int v0[3], v1[3], d0[3], d1[3];
  __device__ __forceinline__ void quant(const float (&e0)[3],
                                        const float (&e1)[3],
                                        const float*) {
    quant_plain<BITS>(e0, v0, d0);
    quant_plain<BITS>(e1, v1, d1);
  }
};

// ---------------------------------------------------------------------------
// Index assignment, least squares, fit loop
// ---------------------------------------------------------------------------

// Nearest palette index by line projection plus a 3-candidate exact check
// (bc7_pallas.py:_assign).  Returns the masked block error.
template <int CHN, int L>
__device__ __forceinline__ float assign(const float (*px)[16],
                                        const int (&d0)[CHN],
                                        const int (&d1)[CHN],
                                        const float (&mask)[16],
                                        const float* chw, int (&idx)[16]) {
  float df[CHN];
#pragma unroll
  for (int c = 0; c < CHN; ++c) df[c] = (float)(d1[c] - d0[c]);
  float cw = chw[0] * df[0] * df[0];
#pragma unroll
  for (int c = 1; c < CHN; ++c) cw += chw[c] * df[c] * df[c];
  const float den = cw + 1e-10f;
  float err = 0.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    float b = chw[0] * (px[0][t] - (float)d0[0]) * df[0];
#pragma unroll
    for (int c = 1; c < CHN; ++c) b += chw[c] * (px[c][t] - (float)d0[c]) * df[c];
    const int k = qround(b / den * (float)(L - 1), L - 1);
    int best_k = 0;
    float best_e = 0.0f;
#pragma unroll
    for (int dk = -1; dk <= 1; ++dk) {
      const int kk = min(max(k + dk, 0), L - 1);
      const int w = w64<L>(kk);
      float e = 0.0f;
#pragma unroll
      for (int c = 0; c < CHN; ++c) {
        const int pal = (d0[c] * (64 - w) + d1[c] * w + 32) >> 6;
        const float d = px[c][t] - (float)pal;
        const float term = chw[c] * (d * d);
        e = c == 0 ? term : e + term;
      }
      if (dk == -1 || e < best_e) {
        best_k = kk;
        best_e = e;
      }
    }
    idx[t] = best_k;
    const float me = best_e * mask[t];
    err = t == 0 ? me : err + me;
  }
  return err;
}

// Least-squares endpoints for fixed weights (bc7_pallas.py:_ls).
template <int CHN>
__device__ __forceinline__ void ls(const float (*px)[16],
                                   const float (&w)[16],
                                   const float (&mask)[16], float (&ew1)[CHN],
                                   float (&ew0)[CHN]) {
  float wv[16], uv[16], om[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    om[t] = 1.0f - w[t];
    wv[t] = w[t] * mask[t];
    uv[t] = om[t] * mask[t];
  }
  const float a11 = rt_mul(wv, w);
  const float a12 = rt_mul(wv, om);
  const float a22 = rt_mul(uv, om);
  const float det = a11 * a22 - a12 * a12;
  const bool ok = fabsf(det) > 1e-8f;
  const float safe = ok ? det : 1.0f;
  const float cnt = rt(mask) + 1e-12f;
#pragma unroll
  for (int c = 0; c < CHN; ++c) {
    const float b0 = rt_mul(wv, px[c]);
    const float b1 = rt_mul(uv, px[c]);
    const float mean = rt_mul(px[c], mask) / cnt;
    ew1[c] = ok ? (a22 * b0 - a12 * b1) / safe : mean;
    ew0[c] = ok ? (a11 * b1 - a12 * b0) / safe : mean;
  }
}

// Seed -> quantise -> assign -> LS refine (bc7_pallas.py:_fit).
template <int CHN, int L, class Q>
__device__ __forceinline__ float fit(const float (*px)[16],
                                     const float (&mask)[16],
                                     const float* chw, int iters,
                                     const float (&hi)[CHN],
                                     const float (&lo)[CHN], Q& best,
                                     int (&best_idx)[16]) {
  best.quant(hi, lo, chw);
  float best_err = assign<CHN, L>(px, best.d0, best.d1, mask, chw, best_idx);
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    float w[16];
#pragma unroll
    for (int t = 0; t < 16; ++t)
      w[t] = (float)w64<L>(best_idx[t]) * (1.0f / 64.0f);
    float ew1[CHN], ew0[CHN];
    ls<CHN>(px, w, mask, ew1, ew0);
    Q st;
    st.quant(ew0, ew1, chw);
    int idx[16];
    const float err = assign<CHN, L>(px, st.d0, st.d1, mask, chw, idx);
    if (err < best_err) {
      best = st;
      best_err = err;
#pragma unroll
      for (int t = 0; t < 16; ++t) best_idx[t] = idx[t];
    }
  }
  return best_err;
}

// Scalar alpha fit (bc7_pallas.py:_fit_alpha); returns the error.
template <int L, int QBITS>
__device__ __forceinline__ float alpha_cand(const float (&a)[16], float e0,
                                            float e1, int& q0, int& q1,
                                            int (&idx)[16]) {
  constexpr int maxq = (1 << QBITS) - 1;
  const float scale = (float)(maxq / 255.0);
  q0 = qround(e0 * scale, maxq);
  q1 = qround(e1 * scale, maxq);
  const int d0 = replicate(q0, QBITS);
  const int d1 = replicate(q1, QBITS);
  float err = 0.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    float best_e = 0.0f;
    int best_k = 0;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int w = w64<L>(k);
      const int pal = (d0 * (64 - w) + d1 * w + 32) >> 6;
      const float d = a[t] - (float)pal;
      const float e = d * d;
      if (k == 0 || e < best_e) {
        best_e = e;
        best_k = k;
      }
    }
    idx[t] = best_k;
    err = t == 0 ? best_e : err + best_e;
  }
  return err;
}

template <int L, int QBITS>
__device__ __forceinline__ float fit_alpha(const float (&a)[16], int iters,
                                           int& q0, int& q1, int (&idx)[16]) {
  float amax = a[0], amin = a[0];
#pragma unroll
  for (int t = 1; t < 16; ++t) {
    amax = fmaxf(amax, a[t]);
    amin = fminf(amin, a[t]);
  }
  float best = alpha_cand<L, QBITS>(a, amax, amin, q0, q1, idx);
  float ones[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) ones[t] = 1.0f;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    float w[16];
#pragma unroll
    for (int t = 0; t < 16; ++t)
      w[t] = (float)w64<L>(idx[t]) * (1.0f / 64.0f);
    float ew1[1], ew0[1];
    ls<1>(&a, w, ones, ew1, ew0);
    int c0, c1, cidx[16];
    const float err = alpha_cand<L, QBITS>(a, ew0[0], ew1[0], c0, c1, cidx);
    if (err < best) {
      best = err;
      q0 = c0;
      q1 = c1;
#pragma unroll
      for (int t = 0; t < 16; ++t) idx[t] = cidx[t];
    }
  }
  if (idx[0] >= L / 2) {
    const int tmp = q0;
    q0 = q1;
    q1 = tmp;
#pragma unroll
    for (int t = 0; t < 16; ++t) idx[t] = (L - 1) - idx[t];
  }
  return best;
}

// ---------------------------------------------------------------------------
// Modes
// ---------------------------------------------------------------------------

__device__ __forceinline__ float mode6(const float (&px)[4][16], int iters,
                                       const float* chw, Bits& out) {
  float ones[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) ones[t] = 1.0f;
  float hi[4], lo[4], axis[4], mean[4];
  pca_seed<4>(px, ones, hi, lo, axis, mean);
  QMode6 q;
  int idx[16];
  const float err = fit<4, 16>(px, ones, chw, iters, hi, lo, q, idx);
  const bool swap = idx[0] >= 8;
  out.clear();
  out.put(64, 7);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    out.put(swap ? q.v1[c] : q.v0[c], 7);
    out.put(swap ? q.v0[c] : q.v1[c], 7);
  }
  out.put(swap ? q.p1 : q.p0, 1);
  out.put(swap ? q.p0 : q.p1, 1);
#pragma unroll
  for (int t = 0; t < 16; ++t) out.put(swap ? 15 - idx[t] : idx[t], t ? 4 : 3);
  return err;
}

__device__ __forceinline__ float sub_err(float tot, const float (&s1)[3],
                                         float pss, float ps2, float ns,
                                         const float* cw) {
  float mt = cw[0] * s1[0] * s1[0];
  mt += cw[1] * s1[1] * s1[1];
  mt += cw[2] * s1[2] * s1[2];
  mt = mt / ns;
  const float along = ps2 - pss * pss / ns;
  return tot - mt - fmaxf(along, 0.0f);
}

__device__ __forceinline__ void seed_of(const float (&px)[4][16],
                                        const float (&m)[16],
                                        const float (&axis)[3],
                                        float (&hi)[3], float (&lo)[3]) {
  const float cnt = rt(m) + 1e-6f;
  float ms[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) ms[c] = rt_mul(px[c], m) / cnt;
  float tmax = -1e30f, tmin = 1e30f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    float s = (px[0][t] - ms[0]) * axis[0];
    s += (px[1][t] - ms[1]) * axis[1];
    s += (px[2][t] - ms[2]) * axis[2];
    if (m[t] > 0.0f) {
      tmax = fmaxf(tmax, s);
      tmin = fminf(tmin, s);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    hi[c] = ms[c] + axis[c] * tmax;
    lo[c] = ms[c] + axis[c] * tmin;
  }
}

// Mode 1: 64-partition screen, then the best partition's two fits.
__device__ __forceinline__ float mode1(const float (&px)[4][16], int iters,
                                       const float* chw, Bits& out) {
  const float cw[3] = {chw[0], chw[1], chw[2]};
  float ones[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) ones[t] = 1.0f;
  float hi3[3], lo3[3], axis[3], mean[3];
  pca_seed<3>(px, ones, hi3, lo3, axis, mean);

  float proj[16], proj2[16], w2[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    float s = (px[0][t] - mean[0]) * axis[0];
    s += (px[1][t] - mean[1]) * axis[1];
    s += (px[2][t] - mean[2]) * axis[2];
    proj[t] = s;
    proj2[t] = s * s;
    float q = cw[0] * px[0][t] * px[0][t];
    q += cw[1] * px[1][t] * px[1][t];
    q += cw[2] * px[2][t] * px[2][t];
    w2[t] = q;
  }
  const float tot_all = rt(w2), ps_all = rt(proj), ps2_all = rt(proj2);
  float s1_all[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) s1_all[c] = rt(px[c]);

  float best_score = 0.0f;
  int part = 0;
#pragma unroll 1
  for (int p = 0; p < 64; ++p) {
    const uint32_t m = c_part2[p];
    float s1[3] = {0.0f, 0.0f, 0.0f};
    float tot = 0.0f, pss = 0.0f, ps2 = 0.0f;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      if ((m >> t) & 1u) {
        s1[0] += px[0][t];
        s1[1] += px[1][t];
        s1[2] += px[2][t];
        tot += w2[t];
        pss += proj[t];
        ps2 += proj2[t];
      }
    }
    const float ns = (float)__popc(m);
    const float r1[3] = {s1_all[0] - s1[0], s1_all[1] - s1[1],
                         s1_all[2] - s1[2]};
    const float score =
        sub_err(tot, s1, pss, ps2, ns + 1e-6f, cw) +
        sub_err(tot_all - tot, r1, ps_all - pss, ps2_all - ps2,
                (16.0f - ns) + 1e-6f, cw);
    if (p == 0 || score < best_score) {
      best_score = score;
      part = p;
    }
  }
  const uint32_t m1 = c_part2[part];
  const int anchor1 = c_anchor2[part];

  float mk0[16], mk1[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    mk1[t] = ((m1 >> t) & 1u) ? 1.0f : 0.0f;
    mk0[t] = 1.0f - mk1[t];
  }
  float hi0[3], lo0[3], hi1[3], lo1[3];
  seed_of(px, mk0, axis, hi0, lo0);
  seed_of(px, mk1, axis, hi1, lo1);
  QMode1 q0, q1;
  int idx0[16], idx1[16];
  const float err0 = fit<3, 8>(px, mk0, cw, iters, hi0, lo0, q0, idx0);
  const float err1 = fit<3, 8>(px, mk1, cw, iters, hi1, lo1, q1, idx1);
  float apen = 0.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const float d = px[3][t] - 255.0f;
    const float term = chw[3] * (d * d);
    apen = t == 0 ? term : apen + term;
  }
  const float err = err0 + err1 + apen;

  int idx[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) idx[t] = ((m1 >> t) & 1u) ? idx1[t] : idx0[t];
  // Texel 0 anchors subset 0; anchor1 anchors subset 1.  A set index MSB
  // at an anchor is cleared by inverting that subset's indices.
  const bool swap0 = idx[0] >= 4;
  int a1val = 0;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    if (swap0 && !((m1 >> t) & 1u)) idx[t] = 7 - idx[t];
    if (t == anchor1) a1val = idx[t];
  }
  const bool swap1 = a1val >= 4;
#pragma unroll
  for (int t = 0; t < 16; ++t)
    if (swap1 && ((m1 >> t) & 1u)) idx[t] = 7 - idx[t];

  out.clear();
  out.put(2, 2);
  out.put(part, 6);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out.put(swap0 ? q0.v1[c] : q0.v0[c], 6);
    out.put(swap0 ? q0.v0[c] : q0.v1[c], 6);
    out.put(swap1 ? q1.v1[c] : q1.v0[c], 6);
    out.put(swap1 ? q1.v0[c] : q1.v1[c], 6);
  }
  out.put(q0.p, 1);
  out.put(q1.p, 1);
  // Index bits: 3 each, minus 1 at texel 0 and at the subset-1 anchor.
#pragma unroll
  for (int t = 0; t < 16; ++t)
    out.put(idx[t], 3 - (t == 0 ? 1 : 0) - (t == anchor1 ? 1 : 0));
  return err;
}

// Mode 5: rotation 0, 7-bit colour with 2-bit indices, 8-bit alpha.
__device__ __forceinline__ float mode5(const float (&px)[4][16], int iters,
                                       const float* chw, Bits& out) {
  float ones[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) ones[t] = 1.0f;
  float hi[3], lo[3], axis[3], mean[3];
  pca_seed<3>(px, ones, hi, lo, axis, mean);
  QPlain<7> q;
  int cidx[16];
  const float cerr = fit<3, 4>(px, ones, chw, iters, hi, lo, q, cidx);
  const bool cswap = cidx[0] >= 2;
  int a0, a1, aidx[16];
  const float aerr = fit_alpha<4, 8>(px[3], iters, a0, a1, aidx);
  const float err = cerr + chw[3] * aerr;

  out.clear();
  out.put(32, 6);
  out.put(0, 2);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out.put(cswap ? q.v1[c] : q.v0[c], 7);
    out.put(cswap ? q.v0[c] : q.v1[c], 7);
  }
  out.put(a0, 8);
  out.put(a1, 8);
#pragma unroll
  for (int t = 0; t < 16; ++t) out.put(cswap ? 3 - cidx[t] : cidx[t], t ? 2 : 1);
#pragma unroll
  for (int t = 0; t < 16; ++t) out.put(aidx[t], t ? 2 : 1);
  return err;
}

// Mode 4: rotation 0, index mode 0 (2-bit colour, 3-bit alpha indices).
__device__ __forceinline__ float mode4(const float (&px)[4][16], int iters,
                                       const float* chw, Bits& out) {
  float ones[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) ones[t] = 1.0f;
  float hi[3], lo[3], axis[3], mean[3];
  pca_seed<3>(px, ones, hi, lo, axis, mean);
  QPlain<5> q;
  int cidx[16];
  const float cerr = fit<3, 4>(px, ones, chw, iters, hi, lo, q, cidx);
  const bool cswap = cidx[0] >= 2;
  int a0, a1, aidx[16];
  const float aerr = fit_alpha<8, 6>(px[3], iters, a0, a1, aidx);
  const float err = cerr + chw[3] * aerr;

  out.clear();
  out.put(16, 5);
  out.put(0, 2);
  out.put(0, 1);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out.put(cswap ? q.v1[c] : q.v0[c], 5);
    out.put(cswap ? q.v0[c] : q.v1[c], 5);
  }
  out.put(a0, 6);
  out.put(a1, 6);
#pragma unroll
  for (int t = 0; t < 16; ++t) out.put(cswap ? 3 - cidx[t] : cidx[t], t ? 2 : 1);
#pragma unroll
  for (int t = 0; t < 16; ++t) out.put(aidx[t], t ? 3 : 2);
  return err;
}

// One block: px holds clip(x,0,1)*255 per channel and texel.
template <int Q>
__device__ __forceinline__ void encode_block(const float (&px)[4][16],
                                             const float* chw,
                                             uint32_t (&words)[4]) {
  const int iters = Q == 0 ? 1 : 2;
  Bits best, cand;
  float err = mode6(px, iters, chw, best);
  if (Q >= 1) {
    const float e = mode1(px, iters, chw, cand);
    if (e < err) {
      best = cand;
      err = e;
    }
  }
  if (Q >= 2) {
    float e = mode5(px, iters, chw, cand);
    if (e < err) {
      best = cand;
      err = e;
    }
    e = mode4(px, iters, chw, cand);
    if (e < err) {
      best = cand;
      err = e;
    }
  }
  words[0] = (uint32_t)best.lo;
  words[1] = (uint32_t)(best.lo >> 32);
  words[2] = (uint32_t)best.hi;
  words[3] = (uint32_t)(best.hi >> 32);
}

#ifdef __CUDACC__

struct Chw {
  float w[4];
};

template <int Q>
__global__ void __launch_bounds__(kThreads)
    bc7_kernel(const float4* __restrict__ blocks, uint4* __restrict__ out,
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
  encode_block<Q>(px, chw.w, words);
  out[i] = make_uint4(words[0], words[1], words[2], words[3]);
}

#endif  // __CUDACC__

}  // namespace bc7

#ifdef __CUDACC__

// Copies the 64 partition masks and subset-1 anchors (host arrays) into
// constant memory of the current device.  Returns a cudaError_t.
extern "C" int bc7_set_tables(const uint16_t* masks, const int* anchors) {
  cudaError_t e = cudaMemcpyToSymbol(bc7::c_part2, masks, 64 * sizeof(uint16_t));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(bc7::c_anchor2, anchors, 64 * sizeof(int));
  return (int)e;
}

// blocks: [n,16,4] float32 device pointer; out: [n,4] uint32.  Launches on
// `stream` and returns cudaGetLastError() (the launch is not synchronised).
extern "C" int bc7_encode_launch(const void* blocks, void* out, int n,
                                 int quality, float w0, float w1, float w2,
                                 float w3, void* stream) {
  if (n <= 0) return 0;
  const bc7::Chw chw = {{w0, w1, w2, w3}};
  const dim3 grid((n + bc7::kThreads - 1) / bc7::kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const float4* in = (const float4*)blocks;
  uint4* o = (uint4*)out;
  switch (quality) {
    case 0: bc7::bc7_kernel<0><<<grid, bc7::kThreads, 0, s>>>(in, o, n, chw); break;
    case 1: bc7::bc7_kernel<1><<<grid, bc7::kThreads, 0, s>>>(in, o, n, chw); break;
    case 2: bc7::bc7_kernel<2><<<grid, bc7::kThreads, 0, s>>>(in, o, n, chw); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
