// Device code shared by the BC7 kernels (csrc/bc7_encode.cu for quality
// 0-2, csrc/bc7_hq_encode.cu for 3-4): the per-block primitives of
// cuttlefish_tpu/kernels/bc7_pallas.py (PCA seed, endpoint quantisers,
// index assignment, least squares, the fit loop, the alpha fit) and the
// single-subset modes 6, 5 and 4.  One lane encodes one 4x4 block; its
// texels px[c][t] hold clip(x,0,1)*255 for channel c and texel t.  Both
// kernels run a warp per group of 32 blocks whose texels are staged in
// shared memory (stage_texels), their phases as loops of lane tasks
// (FOR_LANES).
//
// Numerics, so that the kernels agree with the plain PyTorch version
// (cuttlefish_tpu_torch/kernels/bc7.py) bit for bit: every sum over texels
// runs in texel order; rounding is rintf (half to even, as torch.round and
// jnp.round); every constant is the float32 value that JAX and PyTorch use;
// the build passes --fmad=false so that no a*b+c is contracted to one
// rounding; division and sqrtf stay IEEE (no fast-math).  Ties keep the
// first minimum everywhere (strict <, ascending).
//
// Plain C++ apart from the CUDA qualifiers, so that a host compiler can
// run it against the plain version with the qualifiers defined empty.

#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <math.h>
#include <stdint.h>

namespace bc7 {

constexpr int kGroup = 32;   // blocks a warp
constexpr int kStride = 65;  // floats of a block's texels in shared memory

// The lanes of a warp.  On the card each lane runs the body once, and
// WARP_SYNC orders the warp's shared memory between phases; in a CPU build
// the 32 lanes run one after another.
#ifdef __CUDACC__
#define FOR_LANES(lane) for (int lane = (int)(threadIdx.x & 31u), lane##_once = 1; lane##_once; lane##_once = 0)
#define WARP_SYNC() __syncwarp()
#else
#define FOR_LANES(lane) for (int lane = 0; lane < 32; ++lane)
#define WARP_SYNC()
#endif

struct Chw {
  float w[4];
};

// Channel weights as the fits take them: an array (const float*), or Unit
// for unit weights, whose products are skipped (w * x == x for w = 1, so
// both give the same floats).
struct Unit {};
__device__ __forceinline__ float wmul(const float* w, int c, float x) { return w[c] * x; }
__device__ __forceinline__ float wmul(Unit, int, float x) { return x; }

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

// A fit's result: its packed block and its error.
struct Res {
  Bits bits;
  float err;
};

// The texels of blocks i0 .. i0 + ng - 1 of blocks [n,16,4] into a warp's
// px (block b, channel c, texel t at b * kStride + c * 16 + t: 32 lanes on
// 32 blocks read 32 banks): one coalesced copy, clamped and scaled as the
// reference does.
static __device__ __noinline__ void stage_texels(const float* blocks, long long i0, int ng, float* px) {
  FOR_LANES(lane) {
    for (int x = lane; x < ng * 16; x += 32) {
      const int b = x >> 4, t = x & 15;
#ifdef __CUDACC__
      const float4 v = reinterpret_cast<const float4*>(blocks)[i0 * 16 + x];
      const float q[4] = {v.x, v.y, v.z, v.w};
#else
      const float* q = blocks + (i0 * 16 + x) * 4;
#endif
#pragma unroll
      for (int c = 0; c < 4; ++c) px[b * kStride + c * 16 + t] = clampf(q[c], 0.0f, 1.0f) * 255.0f;
    }
  }
}

// Block b's texels in a warp's staged px.
__device__ __forceinline__ const float (*block_texels(const float* px, int b))[16] {
  return (const float (*)[16])(px + b * kStride);
}

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
template <int BITS, int CHN, class CW>
__device__ __forceinline__ void quant_pbit_each(const float (&e)[CHN],
                                                CW chw,
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
      const float term = wmul(chw, c, d * d);
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
template <int BITS, class CW>
__device__ __forceinline__ void quant_pbit_shared(
    const float (&e0)[3], const float (&e1)[3], CW chw,
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
      const float term = wmul(chw, c, x0 * x0 + x1 * x1);
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
// A p-bit per endpoint (modes 6, 3, 7 and 0).
template <int BITS, int CHN>
struct QPbitEach {
  int v0[CHN], v1[CHN], p0, p1, d0[CHN], d1[CHN];
  template <class CW>
  __device__ __forceinline__ void quant(const float (&e0)[CHN],
                                        const float (&e1)[CHN], CW chw) {
    quant_pbit_each<BITS, CHN>(e0, chw, v0, p0, d0);
    quant_pbit_each<BITS, CHN>(e1, chw, v1, p1, d1);
  }
};

struct QMode1 {
  int v0[3], v1[3], p, d0[3], d1[3];
  template <class CW>
  __device__ __forceinline__ void quant(const float (&e0)[3],
                                        const float (&e1)[3], CW chw) {
    quant_pbit_shared<6>(e0, e1, chw, v0, v1, p, d0, d1);
  }
};

template <int BITS>
struct QPlain {
  int v0[3], v1[3], d0[3], d1[3];
  template <class CW>
  __device__ __forceinline__ void quant(const float (&e0)[3],
                                        const float (&e1)[3], CW) {
    quant_plain<BITS>(e0, v0, d0);
    quant_plain<BITS>(e1, v1, d1);
  }
};

// ---------------------------------------------------------------------------
// Index assignment, least squares, fit loop
// ---------------------------------------------------------------------------

// Nearest palette index by line projection plus a 3-candidate exact check
// (bc7_pallas.py:_assign).  Returns the masked block error.
template <int CHN, int L, class CW>
__device__ __forceinline__ float assign(const float (*px)[16],
                                        const int (&d0)[CHN],
                                        const int (&d1)[CHN],
                                        const float (&mask)[16],
                                        CW chw, int (&idx)[16]) {
  float df[CHN];
#pragma unroll
  for (int c = 0; c < CHN; ++c) df[c] = (float)(d1[c] - d0[c]);
  float cw = wmul(chw, 0, df[0]) * df[0];
#pragma unroll
  for (int c = 1; c < CHN; ++c) cw += wmul(chw, c, df[c]) * df[c];
  const float den = cw + 1e-10f;
  float err = 0.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    float b = wmul(chw, 0, px[0][t] - (float)d0[0]) * df[0];
#pragma unroll
    for (int c = 1; c < CHN; ++c) b += wmul(chw, c, px[c][t] - (float)d0[c]) * df[c];
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
        const float term = wmul(chw, c, d * d);
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
template <int CHN, int L, class Q, class CW>
__device__ __forceinline__ float fit(const float (*px)[16],
                                     const float (&mask)[16],
                                     CW chw, int iters,
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
// Shared pieces of the modes
// ---------------------------------------------------------------------------

__device__ __forceinline__ void fill_ones(float (&m)[16]) {
#pragma unroll
  for (int t = 0; t < 16; ++t) m[t] = 1.0f;
}

// Error of decoding alpha as 255, for the modes without alpha.
template <class CW>
__device__ __forceinline__ float alpha_penalty(const float (*px)[16], CW chw) {
  float apen = 0.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const float d = px[3][t] - 255.0f;
    const float term = wmul(chw, 3, d * d);
    apen = t == 0 ? term : apen + term;
  }
  return apen;
}

// Within-subset residual of one subset of a partition screen, from its
// moments (bc7_pallas.py:_screen_2subset / _mode_3subset).
template <int CHN, class CW>
__device__ __forceinline__ float sub_err(float tot, const float (&s1)[CHN],
                                         float pss, float ps2, float ns,
                                         CW cw) {
  float mt = wmul(cw, 0, s1[0]) * s1[0];
#pragma unroll
  for (int c = 1; c < CHN; ++c) mt += wmul(cw, c, s1[c]) * s1[c];
  mt = mt / ns;
  const float along = ps2 - pss * pss / ns;
  return tot - mt - fmaxf(along, 0.0f);
}

// Extremes of the masked texels along the block's principal axis; a fourth
// channel (mode 7's alpha) sits at its subset mean.
template <int CHN>
__device__ __forceinline__ void seed_of(const float (*px)[16],
                                        const float (&m)[16],
                                        const float (&axis)[3],
                                        float (&hi)[CHN], float (&lo)[CHN]) {
  const float cnt = rt(m) + 1e-6f;
  float ms[CHN];
#pragma unroll
  for (int c = 0; c < CHN; ++c) ms[c] = rt_mul(px[c], m) / cnt;
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
  for (int c = 0; c < CHN; ++c) {
    const float a = c < 3 ? axis[c] : 0.0f;
    hi[c] = ms[c] + a * tmax;
    lo[c] = ms[c] + a * tmin;
  }
}

// ---------------------------------------------------------------------------
// Single-subset modes
// ---------------------------------------------------------------------------

template <class CW>
__device__ __forceinline__ float mode6(const float (*px)[16], int iters, CW chw, Bits& out) {
  float ones[16];
  fill_ones(ones);
  float hi[4], lo[4], axis[4], mean[4];
  pca_seed<4>(px, ones, hi, lo, axis, mean);
  QPbitEach<7, 4> q;
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

// Mode 5: 7-bit colour with 2-bit indices, 8-bit alpha.  px and chw are
// already in the channel order of rotation rot, which is only packed here.
template <class CW>
__device__ __forceinline__ float mode5(const float (*px)[16], int iters, CW chw, int rot,
                                       Bits& out) {
  float ones[16];
  fill_ones(ones);
  float hi[3], lo[3], axis[3], mean[3];
  pca_seed<3>(px, ones, hi, lo, axis, mean);
  QPlain<7> q;
  int cidx[16];
  const float cerr = fit<3, 4>(px, ones, chw, iters, hi, lo, q, cidx);
  const bool cswap = cidx[0] >= 2;
  int a0, a1, aidx[16];
  const float aerr = fit_alpha<4, 8>(px[3], iters, a0, a1, aidx);
  const float err = cerr + wmul(chw, 3, aerr);

  out.clear();
  out.put(32, 6);
  out.put(rot, 2);
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

// Mode 4: 5-bit colour, 6-bit alpha.  Index mode IDX 0 gives colour the
// 2-bit and alpha the 3-bit indices, IDX 1 the reverse.  px and chw are
// already in the channel order of rotation rot.
template <int IDX, class CW>
__device__ __forceinline__ float mode4(const float (*px)[16], int iters, CW chw, int rot,
                                       Bits& out) {
  constexpr int CL = IDX == 0 ? 4 : 8;
  constexpr int AL = IDX == 0 ? 8 : 4;
  float ones[16];
  fill_ones(ones);
  float hi[3], lo[3], axis[3], mean[3];
  pca_seed<3>(px, ones, hi, lo, axis, mean);
  QPlain<5> q;
  int cidx[16];
  const float cerr = fit<3, CL>(px, ones, chw, iters, hi, lo, q, cidx);
  const bool cswap = cidx[0] >= CL / 2;
  int a0, a1, aidx[16];
  const float aerr = fit_alpha<AL, 6>(px[3], iters, a0, a1, aidx);
  const float err = cerr + wmul(chw, 3, aerr);

  out.clear();
  out.put(16, 5);
  out.put(rot, 2);
  out.put(IDX, 1);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out.put(cswap ? q.v1[c] : q.v0[c], 5);
    out.put(cswap ? q.v0[c] : q.v1[c], 5);
  }
  out.put(a0, 6);
  out.put(a1, 6);
  if (IDX == 0) {
#pragma unroll
    for (int t = 0; t < 16; ++t) out.put(cswap ? 3 - cidx[t] : cidx[t], t ? 2 : 1);
#pragma unroll
    for (int t = 0; t < 16; ++t) out.put(aidx[t], t ? 3 : 2);
  } else {
#pragma unroll
    for (int t = 0; t < 16; ++t) out.put(aidx[t], t ? 2 : 1);
#pragma unroll
    for (int t = 0; t < 16; ++t) out.put(cswap ? 7 - cidx[t] : cidx[t], t ? 3 : 2);
  }
  return err;
}

}  // namespace bc7
