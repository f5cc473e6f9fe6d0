// BC1-BC5 block encoders, written by hand for Hopper (sm_90a).
//
// Replaces the five TPU kernels of cuttlefish_tpu/kernels/bc_pallas.py:
// encode_bc1_pallas, encode_bc2_pallas, encode_bc3_pallas, encode_bc4_pallas
// and encode_bc5_pallas (all launched through pl.pallas_call at :431).  They
// are two algorithms: bc1_tile (the Pallas _bc1_tile: PCA seed, least-squares
// refinement, the 565 lattice sweep from quality 2, the 3-colour mode with
// black or punch-through alpha) and bc4_tile (the Pallas _bc4_tile: 8-value
// mode, and from quality 2 the 6-value mode with the fixed extremes).  The
// five entries compose them as the Pallas entries do: BC2 = explicit 4-bit
// alpha + bc1_tile without black, BC3 = bc4_tile on alpha + bc1_tile without
// black, BC5 = bc4_tile on red and on green.  The plain PyTorch version of the
// same algorithms is cuttlefish_tpu_torch/kernels/bc.py; the two are compared
// on the card.
//
// Design: one thread per 4x4 block, 128 blocks per CTA, grid = ceil(N /
// 128); BC5 a thread per (block, channel), 256 threads per CTA, so that its
// two independent BC4 bodies run side by side.  The TPU kernels put 1024
// blocks on vector lanes and unrolled every candidate sweep over [16, TN]
// tiles; here each thread runs its block's candidate sweep alone, with the
// indices packed into one word (2 bits a texel for BC1, 3 for BC4).  Every
// entry first stages its CTA's texels in shared memory with one coalesced
// copy (16-byte loads, [channel][texel][block] rows padded to 129 floats,
// so that a warp reads 32 banks): no texel array lives in a thread's frame.
// Quality, punch-through, black, signedness and unit channel weights are
// template parameters, so each instantiation has no dead branches.
//
// What bounds it: arithmetic.  A block reads 256 bytes (64 for BC4) and
// writes 8 or 16, but a BC1 block at quality 2 tries some 56 palettes of 16
// texels x 4 entries, 48 of them in the 565 sweep, and a BC4 block about 9
// palettes of 8 entries.  The BC1 body does only the work its function
// needs: the unit-weight instance (every timed case) skips the products by
// 1; each texel's distance to black is made once a block; and a sweep
// candidate changes one channel of the pass's base pair, so a texel's terms
// in the two other channels are made once for the channel's 8 candidates
// and only channel ch's are made per candidate (the texel loop outside,
// the candidates inside).  The BC4 body's least squares skip the products
// by 1 and the terms of weight 0, and from quality 3 a mode's rounds end
// at the first candidate not taken, since every later round would make it
// again.  Its cost is the 8-entry compare chain of each candidate's texels.
//
// Numerics, so that the kernel agrees with the plain version bit for bit:
// every sum over texels runs in texel order and every sum over channels in
// channel order; rounding is rintf (half to even, as torch.round and
// jnp.round); every constant is the float32 value that JAX and PyTorch use;
// the build passes --fmad=false so that no a*b+c is contracted to one
// rounding; division and sqrtf stay IEEE (no fast-math).  Palette searches
// keep the first minimum (strict <, in table order; black last, the BC4
// extremes after the interpolated entries).
//
// The device functions are plain C++: the __global__ kernels and the
// launchers need nvcc and sit under __CUDACC__.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <math.h>
#include <stdint.h>

namespace bcx {

constexpr int kThreads = 128;

// Least-squares rounds per quality (bc_pallas.py:_LS_ITERS).
template <int Q>
struct Iters {
  static constexpr int value = Q <= 0 ? 1 : Q == 1 ? 2 : Q == 2 ? 3 : Q == 3 ? 6 : 10;
};

constexpr float kInv255 = (float)(1.0 / 255.0);
constexpr float kInv127 = (float)(1.0 / 127.0);

// Palette weights w (entry = w*e0 + (1-w)*e1) and their complements, each
// the float32 rounding of the double that the Python source computes.  They
// are selects over compile-time constants (as bc_pallas.py:_wtable), not
// arrays, so that a lookup by a texel's index stays in registers.
#define CF_F32(x) ((float)(x))
#define CF_TABLE(Name, A0, A1, A2, A3, A4, A5, A6, A7)                                  \
  struct Name {                                                                          \
    static __device__ __forceinline__ float w(int k) {                                   \
      return k == 0 ? CF_F32(A0) : k == 1 ? CF_F32(A1) : k == 2 ? CF_F32(A2)             \
           : k == 3 ? CF_F32(A3) : k == 4 ? CF_F32(A4) : k == 5 ? CF_F32(A5)             \
           : k == 6 ? CF_F32(A6) : CF_F32(A7);                                           \
    }                                                                                    \
    static __device__ __forceinline__ float ow(int k) {                                  \
      return k == 0 ? CF_F32(1.0 - (A0)) : k == 1 ? CF_F32(1.0 - (A1))                   \
           : k == 2 ? CF_F32(1.0 - (A2)) : k == 3 ? CF_F32(1.0 - (A3))                   \
           : k == 4 ? CF_F32(1.0 - (A4)) : k == 5 ? CF_F32(1.0 - (A5))                   \
           : k == 6 ? CF_F32(1.0 - (A6)) : CF_F32(1.0 - (A7));                           \
    }                                                                                    \
  };
// BC1 4-colour (_BC1_4C_W) and 3-colour (_BC1_3C_W, index 3 = black or
// transparent, weight 0 in the least squares).
CF_TABLE(W4, 1.0, 0.0, 2.0 / 3.0, 1.0 / 3.0, 0.0, 0.0, 0.0, 0.0)
CF_TABLE(W3, 1.0, 0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0)
// BC4 8-value (_BC4_8V_W) and 6-value (_BC4_6V_W; 6, 7 = the extremes).
CF_TABLE(W8, 1.0, 0.0, 6.0 / 7, 5.0 / 7, 4.0 / 7, 3.0 / 7, 2.0 / 7, 1.0 / 7)
CF_TABLE(W6, 1.0, 0.0, 4.0 / 5, 3.0 / 5, 2.0 / 5, 1.0 / 5, 0.0, 0.0)
#undef CF_TABLE

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float sq(float x) { return x * x; }

// A compiler barrier: texels read from shared memory before it are read
// again after it, not held in registers across it.
#ifdef __CUDACC__
#define RELOAD_TEXELS() asm volatile("" ::: "memory")
#else
#define RELOAD_TEXELS()
#endif

// ---------------------------------------------------------------------------
// A CTA's texels in shared memory (BC1-BC3)
// ---------------------------------------------------------------------------

#ifndef __CUDACC__
struct float4 {
  float x, y, z, w;
};
#endif

// A shared-memory row holds one texel value of each of a CTA's blocks,
// padded by one so that a staging warp's two blocks fall on other banks.
constexpr int kStride = kThreads + 1;

// A CTA's texels, [channel][texel][block]: RGB, then alpha (BC1 with
// black: each texel's error against black).
__shared__ float s_px[64 * kStride];

// Texel (c, t) of thread `tid`'s block.
struct Px {
  int tid;
  __device__ __forceinline__ float operator()(int c, int t) const {
    return s_px[(16 * c + t) * kStride + tid];
  }
  __device__ __forceinline__ void set(int c, int t, float v) const {
    s_px[(16 * c + t) * kStride + tid] = v;
  }
};

// One channel of a thread's block in shared memory (BC3's alpha, BC4, a
// BC5 channel): texel t at p[t * kStride].
struct Row {
  const float* p;
  __device__ __forceinline__ float operator()(int t) const { return p[t * kStride]; }
};

// Thread tid's share of staging blocks [first, first + nb) of blocks
// [n,16,4] into s_px, NC channels (RGB, or RGBA): neighbouring threads read
// neighbouring texels as float4 (the wrapper hands over 16-byte aligned
// storage, bc_cuda.launch).
template <int NC>
__device__ __forceinline__ void stage(const float* blocks, int first, int nb, int tid) {
  const float4* src = (const float4*)blocks + (size_t)first * 16;
  for (int f = tid; f < nb * 16; f += kThreads) {
    const float4 q = src[f];
    float* d = s_px + (f & 15) * kStride + (f >> 4);
    d[0] = q.x;
    d[16 * kStride] = q.y;
    d[32 * kStride] = q.z;
    if (NC == 4) d[48 * kStride] = q.w;
  }
}

// Thread tid's share (of nth) of staging values [first, first + nb) of
// vals [n,16] into s, a row of kStride floats per texel: neighbouring
// threads read neighbouring float4s (four texels of a block).
__device__ __forceinline__ void stage_bc4(float* s, const float* vals, int first, int nb, int tid,
                                          int nth) {
  const float4* src = (const float4*)vals + (size_t)first * 4;
  for (int f = tid; f < nb * 4; f += nth) {
    const float4 q = src[f];
    float* d = s + (4 * (f & 3)) * kStride + (f >> 2);
    d[0] = q.x;
    d[kStride] = q.y;
    d[2 * kStride] = q.z;
    d[3 * kStride] = q.w;
  }
}

// The same for red and green of blocks [n,16,nch] (BC5): rows [channel]
// [texel], a float4 a texel where nch is 4, else one float a thread.
__device__ __forceinline__ void stage_bc5(float* s, const float* blocks, int first, int nb, int nch,
                                          int tid, int nth) {
  if (nch == 4) {
    const float4* src = (const float4*)blocks + (size_t)first * 16;
    for (int f = tid; f < nb * 16; f += nth) {
      const float4 q = src[f];
      float* d = s + (f & 15) * kStride + (f >> 4);
      d[0] = q.x;
      d[16 * kStride] = q.y;
    }
    return;
  }
  const float* src = blocks + (size_t)first * 16 * nch;
  for (int x = tid; x < nb * 16 * nch; x += nth) {
    const int f = x / nch, c = x - f * nch;
    if (c < 2) s[(16 * c + (f & 15)) * kStride + (f >> 4)] = src[x];
  }
}

// ---------------------------------------------------------------------------
// Least squares (bc_pallas.py:_ls1 / _ls3)
// ---------------------------------------------------------------------------

// Sums of the 2x2 normal equations over the texels, in texel order.
struct LsSums {
  float a11, a12, a22;
};

__device__ __forceinline__ void ls_accumulate(LsSums& s, float w, float p,
                                              float& wv, float& uv) {
  wv = w * p;
  uv = (1.0f - w) * p;
  s.a11 = s.a11 + wv * w;
  s.a12 = s.a12 + wv * (1.0f - w);
  s.a22 = s.a22 + uv * (1.0f - w);
}

// One channel: returns the endpoints (e0 at w = 1, e1 at w = 0).  The
// texels of mask m (bit t) take part with weight 1, the others with weight
// 0: the floats of the weighted form with those weights, without its
// products by 1 and its sums of exact zeros (a term of weight 0 adds +0 or
// -0 to a sum that is never -0).
template <class V>
__device__ __forceinline__ void ls1(const V& v, const float (&w)[16], uint32_t m, float& e0,
                                    float& e1) {
  LsSums s = {0.0f, 0.0f, 0.0f};
  float b0 = 0.0f, b1 = 0.0f, msum = 0.0f, psum = 0.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    if ((m >> t) & 1u) {
      const float u = 1.0f - w[t];
      s.a11 = s.a11 + w[t] * w[t];
      s.a12 = s.a12 + w[t] * u;
      s.a22 = s.a22 + u * u;
      b0 = b0 + w[t] * v(t);
      b1 = b1 + u * v(t);
      msum = msum + v(t);
      psum = psum + 1.0f;
    }
  }
  const float det = s.a11 * s.a22 - s.a12 * s.a12;
  const bool ok = fabsf(det) > 1e-8f;
  const float safe = ok ? det : 1.0f;
  const float mean = msum / (psum + 1e-12f);
  e0 = ok ? (s.a22 * b0 - s.a12 * b1) / safe : mean;
  e1 = ok ? (s.a11 * b1 - s.a12 * b0) / safe : mean;
}

// Three channels sharing the weights.
__device__ __forceinline__ void ls3(Px px, const float (&w)[16], const float (&p)[16],
                                    float (&e0)[3], float (&e1)[3]) {
  LsSums s = {0.0f, 0.0f, 0.0f};
  float b0[3] = {0.0f, 0.0f, 0.0f}, b1[3] = {0.0f, 0.0f, 0.0f};
  float msum[3] = {0.0f, 0.0f, 0.0f}, psum = 0.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    float wv, uv;
    ls_accumulate(s, w[t], p[t], wv, uv);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = px(c, t);
      b0[c] = b0[c] + wv * v;
      b1[c] = b1[c] + uv * v;
      msum[c] = msum[c] + v * p[t];
    }
    psum = psum + p[t];
  }
  const float det = s.a11 * s.a22 - s.a12 * s.a12;
  const bool ok = fabsf(det) > 1e-8f;
  const float safe = ok ? det : 1.0f;
  const float cnt = psum + 1e-12f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float mean = msum[c] / cnt;
    e0[c] = ok ? (s.a22 * b0[c] - s.a12 * b1[c]) / safe : mean;
    e1[c] = ok ? (s.a11 * b1[c] - s.a12 * b0[c]) / safe : mean;
  }
}

// ---------------------------------------------------------------------------
// BC1 tile (bc_pallas.py:_bc1_tile)
// ---------------------------------------------------------------------------

// Principal-axis extremes over all 16 texels (bc_pallas.py:_pca_seed3 with
// an all-ones mask): 6 power iterations from the first texel of largest norm.
__device__ __forceinline__ void pca_seed3(Px px, float (&hi)[3], float (&lo)[3]) {
  const float cnt = 16.0f + 1e-12f;
  float mean[3], cent[3][16];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float s = 0.0f;
#pragma unroll
    for (int t = 0; t < 16; ++t) s = s + px(c, t);
    mean[c] = s / cnt;
#pragma unroll
    for (int t = 0; t < 16; ++t) cent[c][t] = px(c, t) - mean[c];
  }
  float cov[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float s = 0.0f;
#pragma unroll
      for (int t = 0; t < 16; ++t) s = s + cent[c][t] * cent[d][t];
      cov[c][d] = s;
    }
  }
  float best = 0.0f;
  int fidx = 0;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const float nrm = (cent[0][t] * cent[0][t] + cent[1][t] * cent[1][t]) + cent[2][t] * cent[2][t];
    if (t == 0 || nrm > best) {
      best = nrm;
      fidx = t;
    }
  }
  float st[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float s = 0.0f;
#pragma unroll
    for (int t = 0; t < 16; ++t) s = t == fidx ? cent[c][t] : s;
    st[c] = s;
  }
  const float n0 = sqrtf((st[0] * st[0] + st[1] * st[1]) + st[2] * st[2]);
  float v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = n0 > 1e-10f ? st[c] / (n0 + 1e-20f) : 1.0f;
#pragma unroll 1
  for (int it = 0; it < 6; ++it) {
    float nv[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) nv[c] = (cov[c][0] * v[0] + cov[c][1] * v[1]) + cov[c][2] * v[2];
    const float nn = sqrtf((nv[0] * nv[0] + nv[1] * nv[1]) + nv[2] * nv[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = nn > 1e-10f ? nv[c] / (nn + 1e-20f) : v[c];
  }
  float tmax = 0.0f, tmin = 0.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const float tt = (cent[0][t] * v[0] + cent[1][t] * v[1]) + cent[2][t] * v[2];
    tmax = t == 0 ? tt : fmaxf(tmax, tt);
    tmin = t == 0 ? tt : fminf(tmin, tt);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    hi[c] = mean[c] + v[c] * tmax;
    lo[c] = mean[c] + v[c] * tmin;
  }
}

// A 5- or 6-bit field of channel CH, expanded to 8 bits and scaled to 0..1.
template <int CH>
__device__ __forceinline__ float expand565(int v) {
  return (float)(CH == 1 ? (v << 2) | (v >> 4) : (v << 3) | (v >> 2)) * kInv255;
}

__device__ __forceinline__ void dq565(int c16, float (&d)[3]) {
  d[0] = expand565<0>((c16 >> 11) & 31);
  d[1] = expand565<1>((c16 >> 5) & 63);
  d[2] = expand565<2>(c16 & 31);
}

__device__ __forceinline__ int quant565(const float (&e)[3]) {
  const int r = (int)rintf(clampf(e[0], 0.0f, 1.0f) * 31.0f);
  const int g = (int)rintf(clampf(e[1], 0.0f, 1.0f) * 63.0f);
  const int b = (int)rintf(clampf(e[2], 0.0f, 1.0f) * 31.0f);
  return (r << 11) | (g << 5) | b;
}

// Channel c's share of a texel's error for a difference x: w_c * x^2, or
// x^2 with unit weights (UW), which is the same float.
template <bool UW>
__device__ __forceinline__ float term(const float* chw, int c, float x) {
  return UW ? sq(x) : chw[c] * sq(x);
}

// A texel's error against black, (w_c * p) * p summed in channel order.
template <bool UW>
__device__ __forceinline__ float black_err(Px px, const float* chw, int t) {
  float e = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float p = px(c, t);
    const float x = UW ? p * p : chw[c] * p * p;
    e = c == 0 ? x : e + x;
  }
  return e;
}

struct Bc1Cand {
  int c0, c1;
  uint32_t idx;  // 2 bits a texel, texel t at bits 2t
  float err;
};

// Nearest of NW palette entries (+ black, its error per texel in the
// block's fourth row, when BLACK) per texel, first minimum in table order;
// the block error is the texel errors (times the opaque mask when PV)
// summed in texel order (bc_pallas.py:_bc1_assign).
template <class T, int NW, bool BLACK, bool PV, bool UW>
__device__ __forceinline__ float bc1_assign(Px px, uint32_t opaque, const float (&d0)[3],
                                            const float (&d1)[3], const float* chw,
                                            uint32_t& idx) {
  float pal[NW][3];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
#pragma unroll
    for (int c = 0; c < 3; ++c) pal[k][c] = T::w(k) * d0[c] + T::ow(k) * d1[c];
  }
  float err = 0.0f;
  uint32_t out = 0;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    float best = 0.0f;
    uint32_t bi = 0;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const float e = (term<UW>(chw, 0, px(0, t) - pal[k][0]) +
                       term<UW>(chw, 1, px(1, t) - pal[k][1])) +
                      term<UW>(chw, 2, px(2, t) - pal[k][2]);
      if (k == 0 || e < best) {
        best = e;
        bi = (uint32_t)k;
      }
    }
    if (BLACK) {
      const float e = px(3, t);
      if (e < best) {
        best = e;
        bi = (uint32_t)NW;
      }
    }
    if (PV) best = best * (((opaque >> t) & 1u) ? 1.0f : 0.0f);
    err = err + best;
    out |= bi << (2 * t);
  }
  idx = out;
  return err;
}

__device__ __forceinline__ void take_if_better(Bc1Cand& best, const Bc1Cand& cand) {
  if (cand.err < best.err) best = cand;
}

// 4-colour candidate from float endpoints.
template <bool UW>
__device__ __forceinline__ Bc1Cand cand4(Px px, const float (&e0)[3], const float (&e1)[3],
                                         const float* chw) {
  Bc1Cand r;
  r.c0 = quant565(e0);
  r.c1 = quant565(e1);
  float d0[3], d1[3];
  dq565(r.c0, d0);
  dq565(r.c1, d1);
  r.err = bc1_assign<W4, 4, false, false, UW>(px, 0u, d0, d1, chw, r.idx);
  return r;
}

// 3-colour candidate: with black as entry 3, or (PUNCH) with the
// transparent texels forced to index 3 and left out of the error.
template <bool PUNCH, bool UW>
__device__ __forceinline__ Bc1Cand cand3(Px px, uint32_t opaque, const float (&e0)[3],
                                         const float (&e1)[3], const float* chw) {
  Bc1Cand r;
  r.c0 = quant565(e0);
  r.c1 = quant565(e1);
  float d0[3], d1[3];
  dq565(r.c0, d0);
  dq565(r.c1, d1);
  if (!PUNCH) {
    r.err = bc1_assign<W3, 3, true, false, UW>(px, opaque, d0, d1, chw, r.idx);
  } else {
    r.err = bc1_assign<W3, 3, false, true, UW>(px, opaque, d0, d1, chw, r.idx);
#pragma unroll
    for (int t = 0; t < 16; ++t)
      if (!((opaque >> t) & 1u)) r.idx |= 3u << (2 * t);
  }
  return r;
}

// The 8 candidates of channel CH in one 565 sweep pass around (base0,
// base1), offered to best in candidate order.  Candidate i moves channel
// CH's field of the two endpoints by (j0 - 1, j1 - 1), (j0, j1) the i-th
// pair of {0,1,2}^2 without (1,1); the other channels keep the base pair's
// palette (bpal), so a texel's terms there are made once for all 8, and
// each entry's error is its three channel terms summed in channel order, as
// bc1_assign sums them.  Entries 0 and 1 are the endpoints themselves (w = 1
// and 0: 1 * d0 + 0 * d1 == d0 for d in 0..1), so their terms take 3 values
// each.
template <int CH, bool UW>
__device__ __forceinline__ void sweep_channel(Px px, const float* chw, int base0, int base1,
                                              const float (&bpal)[4][3], Bc1Cand& best) {
  constexpr int shift = CH == 0 ? 11 : CH == 1 ? 5 : 0;
  constexpr int maxv = CH == 1 ? 63 : 31;
  constexpr int ca = CH == 0 ? 1 : 0, cb = CH == 2 ? 1 : 2;  // the other channels
  int f0[3], f1[3];
  float v0[3], v1[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    f0[j] = min(max(((base0 >> shift) & maxv) + j - 1, 0), maxv);
    f1[j] = min(max(((base1 >> shift) & maxv) + j - 1, 0), maxv);
    v0[j] = expand565<CH>(f0[j]);
    v1[j] = expand565<CH>(f1[j]);
  }
  float p2[8], p3[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int nb = i < 4 ? i : i + 1, j0 = nb / 3, j1 = nb % 3;
    p2[i] = W4::w(2) * v0[j0] + W4::ow(2) * v1[j1];
    p3[i] = W4::w(3) * v0[j0] + W4::ow(3) * v1[j1];
  }
  float err[8];
  uint32_t idx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    err[i] = 0.0f;
    idx[i] = 0u;
  }
#pragma unroll 1
  for (int t = 0; t < 16; ++t) {
    const float pc = px(CH, t), pa = px(ca, t), pb = px(cb, t);
    // The other channels' terms, and for CH = 2 their sum, per entry.
    float ta[4], tb[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ta[k] = term<UW>(chw, ca, pa - bpal[k][ca]);
      tb[k] = term<UW>(chw, cb, pb - bpal[k][cb]);
      if (CH == 2) ta[k] = ta[k] + tb[k];
    }
    float u0[3], u1[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      u0[j] = term<UW>(chw, CH, pc - v0[j]);
      u1[j] = term<UW>(chw, CH, pc - v1[j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int nb = i < 4 ? i : i + 1, j0 = nb / 3, j1 = nb % 3;
      const float tc[4] = {u0[j0], u1[j1], term<UW>(chw, CH, pc - p2[i]),
                           term<UW>(chw, CH, pc - p3[i])};
      float best_e = 0.0f;
      uint32_t bi = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float e = CH == 0 ? (tc[k] + ta[k]) + tb[k]
                      : CH == 1 ? (ta[k] + tc[k]) + tb[k]
                                : ta[k] + tc[k];
        if (k == 0 || e < best_e) {
          best_e = e;
          bi = (uint32_t)k;
        }
      }
      err[i] = err[i] + best_e;
      idx[i] |= bi << (2 * t);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int nb = i < 4 ? i : i + 1, j0 = nb / 3, j1 = nb % 3;
    Bc1Cand c;
    c.c0 = (base0 & ~(maxv << shift)) | (f0[j0] << shift);
    c.c1 = (base1 & ~(maxv << shift)) | (f1[j1] << shift);
    c.idx = idx[i];
    c.err = err[i];
    take_if_better(best, c);
  }
}

// Returns (c0, c1, packed 2-bit indices) of the chosen mode.  `opaque` has
// bit t set when texel t has alpha >= 0.5 (all set unless PUNCH).
template <int Q, bool PUNCH, bool BLACK, bool UW>
__device__ __forceinline__ void bc1_tile(Px px, uint32_t opaque, const float* chw, int& c0o,
                                         int& c1o, uint32_t& idxo) {
  constexpr int iters = Iters<Q>::value;
  float hi[3], lo[3];
  pca_seed3(px, hi, lo);
  float ones[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) ones[t] = 1.0f;

  Bc1Cand best4 = cand4<UW>(px, hi, lo, chw);
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    float w[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) w[t] = W4::w((int)((best4.idx >> (2 * t)) & 3u));
    float e0[3], e1[3];
    ls3(px, w, ones, e0, e1);
    take_if_better(best4, cand4<UW>(px, e0, e1, chw));
  }
  if (Q >= 2) {
    // Per-channel +-1 sweep of both 565 endpoints around the pass's
    // starting pair: 2 passes x 3 channels x 8 neighbour pairs.
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      const int base0 = best4.c0, base1 = best4.c1;
      float d0[3], d1[3], bpal[4][3];
      dq565(base0, d0);
      dq565(base1, d1);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int c = 0; c < 3; ++c) bpal[k][c] = W4::w(k) * d0[c] + W4::ow(k) * d1[c];
      }
      sweep_channel<0, UW>(px, chw, base0, base1, bpal, best4);
      sweep_channel<1, UW>(px, chw, base0, base1, bpal, best4);
      sweep_channel<2, UW>(px, chw, base0, base1, bpal, best4);
    }
  }
  // 4-colour mode needs c0 > c1: swapping flips each index's low bit; equal
  // endpoints take index 0 everywhere.
  const bool swap = best4.c0 < best4.c1;
  const int c0_4 = swap ? best4.c1 : best4.c0;
  const int c1_4 = swap ? best4.c0 : best4.c1;
  uint32_t idx_4 = swap ? best4.idx ^ 0x55555555u : best4.idx;
  if (c0_4 == c1_4) idx_4 = 0u;

  constexpr bool use3 = PUNCH || (BLACK && Q >= 2);
  if (!use3) {
    c0o = c0_4;
    c1o = c1_4;
    idxo = idx_4;
    return;
  }
  // The 3-colour half reads its texels afresh: held from the rounds through
  // the sweep they took the black instance from 128 registers to 214.
  RELOAD_TEXELS();
  // Each texel's error against black, made once for every 3-colour
  // candidate, in the block's fourth row (with black, alpha is not staged).
  if (!PUNCH) {
#pragma unroll
    for (int t = 0; t < 16; ++t) px.set(3, t, black_err<UW>(px, chw, t));
  }
  Bc1Cand best3 = cand3<PUNCH, UW>(px, opaque, hi, lo, chw);
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    float w[16], pv[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const uint32_t k = (best3.idx >> (2 * t)) & 3u;
      w[t] = W3::w((int)k);
      pv[t] = (((opaque >> t) & 1u) ? 1.0f : 0.0f) * (k != 3u ? 1.0f : 0.0f);
    }
    float e0[3], e1[3];
    ls3(px, w, pv, e0, e1);
    take_if_better(best3, cand3<PUNCH, UW>(px, opaque, e0, e1, chw));
  }
  // 3-colour mode needs c0 <= c1: swapping exchanges entries 0 and 1 only.
  const bool swap3 = best3.c0 > best3.c1;
  const int c0_3 = swap3 ? best3.c1 : best3.c0;
  const int c1_3 = swap3 ? best3.c0 : best3.c1;
  uint32_t idx_3 = best3.idx;
  if (swap3) idx_3 ^= ~(idx_3 >> 1) & 0x55555555u;
  bool pick3 = best3.err < best4.err;
  if (PUNCH && opaque != 0xFFFFu) pick3 = true;
  c0o = pick3 ? c0_3 : c0_4;
  c1o = pick3 ? c1_3 : c1_4;
  idxo = pick3 ? idx_3 : idx_4;
}

// ---------------------------------------------------------------------------
// BC4 tile (bc_pallas.py:_bc4_tile)
// ---------------------------------------------------------------------------

struct Bc4Cand {
  int q0, q1;     // stored bytes
  float d0, d1;   // decoded endpoints
  uint64_t idx;   // 3 bits a texel, texel t at bits 3t
  float err;
};

template <bool SIGNED>
__device__ __forceinline__ void quant_bc4(float e, int& q, float& d) {
  if (SIGNED) {
    const int qi = (int)rintf(clampf(e, -1.0f, 1.0f) * 127.0f);
    q = qi & 0xFF;
    d = (float)qi * kInv127;
  } else {
    q = (int)rintf(clampf(e, 0.0f, 1.0f) * 255.0f);
    d = (float)q * kInv255;
  }
}

// Nearest of NW interpolated entries, then (EXT) the two fixed extremes
// with a 1e-12 tie-break towards them; error = clamped minima summed in
// texel order (bc_pallas.py:_bc4_assign).  RELOAD: the texels are read
// afresh from shared memory for each candidate, not held in registers.
template <class T, int NW, bool EXT, bool SIGNED, bool RELOAD, class V>
__device__ __forceinline__ float bc4_assign(const V& v, float d0, float d1, uint64_t& idx) {
  if (RELOAD) RELOAD_TEXELS();
  constexpr float lo_ext = SIGNED ? -1.0f : 0.0f;
  constexpr float hi_ext = 1.0f;
  float pal[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) pal[k] = T::w(k) * d0 + T::ow(k) * d1;
  float err = 0.0f;
  uint64_t out = 0;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    float best = 0.0f;
    uint32_t bi = 0;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const float e = sq(v(t) - pal[k]);
      if (k == 0 || e < best) {
        best = e;
        bi = (uint32_t)k;
      }
    }
    if (EXT) {
      float e = sq(v(t) - lo_ext) - 1e-12f;
      if (e < best) {
        best = e;
        bi = (uint32_t)NW;
      }
      e = sq(v(t) - hi_ext) - 1e-12f;
      if (e < best) {
        best = e;
        bi = (uint32_t)NW + 1u;
      }
    }
    err = err + fmaxf(best, 0.0f);
    out |= (uint64_t)bi << (3 * t);
  }
  idx = out;
  return err;
}

template <class T, int NW, bool EXT, bool SIGNED, bool RELOAD, class V>
__device__ __forceinline__ Bc4Cand bc4_cand(const V& v, float e0, float e1) {
  Bc4Cand r;
  quant_bc4<SIGNED>(e0, r.q0, r.d0);
  quant_bc4<SIGNED>(e1, r.q1, r.d1);
  r.err = bc4_assign<T, NW, EXT, SIGNED, RELOAD>(v, r.d0, r.d1, r.idx);
  return r;
}

// A mode's rounds end at the first candidate not taken from this quality
// on (see bc4_tile).  The counting build of chip_smoke.py sets it at run
// time, to 0 for the rounds the function needs at every quality.
#ifndef BC4_EXIT_FROM
#define BC4_EXIT_FROM 3
#endif

// Returns (q0, q1, packed 3-bit indices) of the chosen mode; v(t) is
// texel t's value (RELOAD: as bc4_assign).
template <int Q, bool SIGNED, bool RELOAD, class V>
__device__ __forceinline__ void bc4_tile(const V& v, int& q0o, int& q1o, uint64_t& idxo) {
  constexpr int iters = Iters<Q>::value;
  constexpr double lo_ext_d = SIGNED ? -1.0 : 0.0;
  constexpr double hi_ext_d = 1.0;
  float hi = v(0), lo = v(0);
#pragma unroll
  for (int t = 1; t < 16; ++t) {
    hi = fmaxf(hi, v(t));
    lo = fminf(lo, v(t));
  }

  Bc4Cand best8 = bc4_cand<W8, 8, false, SIGNED, RELOAD>(v, hi, lo);
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    float w[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) w[t] = W8::w((int)((best8.idx >> (3 * t)) & 7u));
    float e0, e1;
    ls1(v, w, 0xFFFFu, e0, e1);
    const Bc4Cand c = bc4_cand<W8, 8, false, SIGNED, RELOAD>(v, e0, e1);
    // A candidate not taken leaves best8, whose indices give the next
    // round's weights: every later round would make it again.  From q3 on
    // (6 and 10 rounds) the loop ends there; at q0-q2 (1-3 rounds) a warp's
    // 32 blocks seldom all stop early, and the exit cost more than it saved.
    if (c.err < best8.err)
      best8 = c;
    else if (Q >= BC4_EXIT_FROM)
      break;
  }
  // 8-value mode needs e0 > e1: swapping maps 0 <-> 1 and k -> 9 - k.
  const bool swap = best8.d0 < best8.d1;
  const int q0_8 = swap ? best8.q1 : best8.q0;
  const int q1_8 = swap ? best8.q0 : best8.q1;
  uint64_t idx_8 = 0;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    uint32_t k = (uint32_t)(best8.idx >> (3 * t)) & 7u;
    if (swap) k = k < 2u ? k ^ 1u : 9u - k;
    idx_8 |= (uint64_t)k << (3 * t);
  }
  if (q0_8 == q1_8) idx_8 = 0;
  if (Q < 2) {
    q0o = q0_8;
    q1o = q1_8;
    idxo = idx_8;
    return;
  }
  // 6-value mode, seeded from the interior range: values at the fixed
  // extremes are served by entries 6 and 7.
  const float lo_tol = (float)(lo_ext_d + 1.0 / 255.0);
  const float hi_tol = (float)(hi_ext_d - 1.0 / 255.0);
  float hi_i = -1e30f, lo_i = 1e30f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const bool interior = v(t) > lo_tol && v(t) < hi_tol;
    hi_i = fmaxf(hi_i, interior ? v(t) : -1e30f);
    lo_i = fminf(lo_i, interior ? v(t) : 1e30f);
  }
  const float hi_s = hi_i > -1e29f ? hi_i : hi;
  const float lo_s = lo_i < 1e29f ? lo_i : lo;
  Bc4Cand best6 = bc4_cand<W6, 6, true, SIGNED, RELOAD>(v, hi_s, lo_s);
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    float w[16];
    uint32_t m = 0u;  // the interpolated entries' texels (the extremes take weight 0)
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int k = (int)((best6.idx >> (3 * t)) & 7u);
      w[t] = W6::w(k);
      m |= (k < 6 ? 1u : 0u) << t;
    }
    float e0, e1;
    ls1(v, w, m, e0, e1);
    const Bc4Cand c = bc4_cand<W6, 6, true, SIGNED, RELOAD>(v, e0, e1);
    if (c.err < best6.err)  // as in the 8-value mode
      best6 = c;
    else if (Q >= BC4_EXIT_FROM)
      break;
  }
  // 6-value mode needs e0 <= e1: swapping maps 0 <-> 1 and k -> 7 - k
  // for the interpolated entries; the extremes keep their indices.
  const bool swap6 = best6.d0 > best6.d1;
  const int q0_6 = swap6 ? best6.q1 : best6.q0;
  const int q1_6 = swap6 ? best6.q0 : best6.q1;
  uint64_t idx_6 = 0;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    uint32_t k = (uint32_t)(best6.idx >> (3 * t)) & 7u;
    if (swap6 && k < 6u) k = k < 2u ? k ^ 1u : 7u - k;
    idx_6 |= (uint64_t)k << (3 * t);
  }
  const bool pick6 = best6.err < best8.err;
  q0o = pick6 ? q0_6 : q0_8;
  q1o = pick6 ? q1_6 : q1_8;
  idxo = pick6 ? idx_6 : idx_8;
}

// ---------------------------------------------------------------------------
// Words (bc_pallas.py:_bc1_words / _bc4_words) and whole blocks
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bc4_words(int q0, int q1, uint64_t idx, uint32_t& lo,
                                          uint32_t& hi) {
  // Texel 5's index straddles the two words (bits 31 of lo, 0-1 of hi).
  lo = ((uint32_t)q0 & 0xFFu) | (((uint32_t)q1 & 0xFFu) << 8) | ((uint32_t)(idx & 0xFFFFu) << 16);
  hi = (uint32_t)(idx >> 16);
}

// Thread px.tid's BC1 block after staging: its two words.  With PUNCH, bit
// t of the opaque mask is set when texel t has alpha >= 0.5.
template <int Q, bool PUNCH, bool BLACK, bool UW>
__device__ __forceinline__ void bc1_block(Px px, const float* chw, uint32_t (&w)[2]) {
  uint32_t opaque = 0xFFFFu;
  if (PUNCH) {
    opaque = 0u;
#pragma unroll
    for (int t = 0; t < 16; ++t) opaque |= (px(3, t) >= 0.5f ? 1u : 0u) << t;
  }
  int c0, c1;
  uint32_t idx;
  bc1_tile<Q, PUNCH, BLACK, UW>(px, opaque, chw, c0, c1, idx);
  w[0] = (uint32_t)c0 | ((uint32_t)c1 << 16);
  w[1] = idx;
}

__device__ __forceinline__ void bc2_alpha(const Row& a, uint32_t (&w)[2]) {
  w[0] = 0u;
  w[1] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[0] |= (uint32_t)rintf(clampf(a(i), 0.0f, 1.0f) * 15.0f) << (4 * i);
    w[1] |= (uint32_t)rintf(clampf(a(i + 8), 0.0f, 1.0f) * 15.0f) << (4 * i);
  }
}

template <int Q, bool SIGNED, bool RELOAD = false, class V>
__device__ __forceinline__ void bc4_block(const V& v, uint32_t (&w)[2]) {
  int q0, q1;
  uint64_t idx;
  bc4_tile<Q, SIGNED, RELOAD>(v, q0, q1, idx);
  bc4_words(q0, q1, idx, w[0], w[1]);
}

// Thread px.tid's BC2 (KIND 2: explicit 4-bit alpha) or BC3 (KIND 3: BC4
// alpha) block after staging: two alpha words, then two colour words.
template <int KIND, int Q, bool UW>
__device__ __forceinline__ void bc23_block(Px px, const float* chw, uint32_t (&w)[4]) {
  const Row a{s_px + 48 * kStride + px.tid};
  uint32_t aw[2], cw[2];
  if constexpr (KIND == 2)
    bc2_alpha(a, aw);
  else
    bc4_block<Q, false>(a, aw);
  bc1_block<Q, false, false, UW>(px, chw, cw);
  w[0] = aw[0];
  w[1] = aw[1];
  w[2] = cw[0];
  w[3] = cw[1];
}

#ifndef __CUDACC__

// BC1 (KIND 1), BC2 or BC3 words of blocks [n,16,4] on the CPU, as the card
// computes them: each CTA's staging, then its threads one after another.
// out: [n, 2] (BC1) or [n, 4] words.
template <int KIND, int Q, bool PUNCH, bool BLACK, bool UW>
inline void bc_cpu(const float* blocks, uint32_t* out, int n, const float* chw) {
  for (int first = 0; first < n; first += kThreads) {
    const int nb = n - first < kThreads ? n - first : kThreads;
    for (int tid = 0; tid < kThreads; ++tid) stage<KIND == 1 && !PUNCH ? 3 : 4>(blocks, first, nb, tid);
    for (int tid = 0; tid < nb; ++tid) {
      if (KIND == 1) {
        uint32_t w[2];
        bc1_block<Q, PUNCH, BLACK, UW>(Px{tid}, chw, w);
        out[2 * (first + tid)] = w[0];
        out[2 * (first + tid) + 1] = w[1];
      } else {
        uint32_t w[4];
        bc23_block<KIND, Q, UW>(Px{tid}, chw, w);
        for (int j = 0; j < 4; ++j) out[4 * (first + tid) + j] = w[j];
      }
    }
  }
}

// BC4 words of values [n,16] on the CPU, as the card computes them: each
// CTA's staging, then its threads one after another.  out: [n, 2].
template <int Q, bool SIGNED>
inline void bc4_cpu(const float* vals, uint32_t* out, int n) {
  for (int first = 0; first < n; first += kThreads) {
    const int nb = n - first < kThreads ? n - first : kThreads;
    for (int tid = 0; tid < kThreads; ++tid) stage_bc4(s_px, vals, first, nb, tid, kThreads);
    for (int tid = 0; tid < nb; ++tid)
      bc4_block<Q, SIGNED, true>(Row{s_px + tid}, *(uint32_t(*)[2])(out + 2 * (first + tid)));
  }
}

// BC5 words of blocks [n,16,nch] (red, green) on the CPU, likewise, a
// thread per (block, channel).  out: [n, 4].
template <int Q, bool SIGNED>
inline void bc5_cpu(const float* blocks, uint32_t* out, int n, int nch) {
  for (int first = 0; first < n; first += kThreads) {
    const int nb = n - first < kThreads ? n - first : kThreads;
    for (int tid = 0; tid < 2 * kThreads; ++tid)
      stage_bc5(s_px, blocks, first, nb, nch, tid, 2 * kThreads);
    for (int ch = 0; ch < 2; ++ch)
      for (int b = 0; b < nb; ++b)
        bc4_block<Q, SIGNED>(Row{s_px + 16 * ch * kStride + b},
                             *(uint32_t(*)[2])(out + 4 * (first + b) + 2 * ch));
  }
}

#endif  // !__CUDACC__

#ifdef __CUDACC__

struct Chw {
  float w[3];
};

template <int Q, bool PUNCH, bool BLACK, bool UW>
__global__ void __launch_bounds__(kThreads)
    bc1_kernel(const float* __restrict__ blocks, uint2* __restrict__ out, int n, Chw chw) {
  const int first = blockIdx.x * kThreads, nb = min(kThreads, n - first);
  stage<PUNCH ? 4 : 3>(blocks, first, nb, threadIdx.x);
  __syncthreads();
  if ((int)threadIdx.x >= nb) return;
  uint32_t w[2];
  bc1_block<Q, PUNCH, BLACK, UW>(Px{(int)threadIdx.x}, chw.w, w);
  out[first + threadIdx.x] = make_uint2(w[0], w[1]);
}

// KIND 2: BC2, KIND 3: BC3.
template <int KIND, int Q, bool UW>
__global__ void __launch_bounds__(kThreads)
    bc23_kernel(const float* __restrict__ blocks, uint4* __restrict__ out, int n, Chw chw) {
  const int first = blockIdx.x * kThreads, nb = min(kThreads, n - first);
  stage<4>(blocks, first, nb, threadIdx.x);
  __syncthreads();
  if ((int)threadIdx.x >= nb) return;
  uint32_t w[4];
  bc23_block<KIND, Q, UW>(Px{(int)threadIdx.x}, chw.w, w);
  out[first + threadIdx.x] = make_uint4(w[0], w[1], w[2], w[3]);
}

// A thread per block, the CTA's values staged in shared memory and read
// afresh for each candidate (63 registers, not 96: 8 CTAs an SM).
template <int Q, bool SIGNED>
__global__ void __launch_bounds__(kThreads)
    bc4_kernel(const float* __restrict__ vals, uint2* __restrict__ out, int n) {
  __shared__ float s[16 * kStride];
  const int first = blockIdx.x * kThreads, nb = min(kThreads, n - first);
  stage_bc4(s, vals, first, nb, threadIdx.x, kThreads);
  __syncthreads();
  if ((int)threadIdx.x >= nb) return;
  uint32_t w[2];
  bc4_block<Q, SIGNED, true>(Row{s + threadIdx.x}, w);
  out[first + threadIdx.x] = make_uint2(w[0], w[1]);
}

// blocks: [n,16,C] float32 with C >= 2; red and green are channels 0, 1.
// kThreads blocks a CTA, staged in shared memory, and a thread per (block,
// channel): warps 0-3 on red, 4-7 on green (1.2x a thread per block
// doing both from shared memory).
template <int Q, bool SIGNED>
__global__ void __launch_bounds__(2 * kThreads)
    bc5_kernel(const float* __restrict__ blocks, uint2* __restrict__ out, int n, int nch) {
  __shared__ float s[32 * kStride];
  const int first = blockIdx.x * kThreads, nb = min(kThreads, n - first);
  stage_bc5(s, blocks, first, nb, nch, threadIdx.x, 2 * kThreads);
  __syncthreads();
  const int ch = threadIdx.x / kThreads, b = threadIdx.x % kThreads;
  if (b >= nb) return;
  uint32_t w[2];
  bc4_block<Q, SIGNED>(Row{s + 16 * ch * kStride + b}, w);
  out[2 * (first + b) + ch] = make_uint2(w[0], w[1]);
}

inline dim3 grid_for(int n) { return dim3((n + kThreads - 1) / kThreads); }

#endif  // __CUDACC__

}  // namespace bcx

#ifdef __CUDACC__

// Each launcher launches on `stream` and returns cudaGetLastError() (the
// launch is not synchronised); quality is 0-4.

// blocks: [n,16,4] float32; out: [n,2] uint32.  Unit channel weights take
// the instance without the weight products.
extern "C" int bc1_encode_launch(const void* blocks, void* out, int n, int quality,
                                 int punch_through, int allow_black, float w0, float w1,
                                 float w2, void* stream) {
  if (n <= 0) return 0;
  const bcx::Chw chw = {{w0, w1, w2}};
  cudaStream_t s = (cudaStream_t)stream;
  const float* in = (const float*)blocks;
  uint2* o = (uint2*)out;
  const dim3 g = bcx::grid_for(n);
  const int variant = punch_through ? 2 : allow_black ? 1 : 0;
  const bool unit = w0 == 1.0f && w1 == 1.0f && w2 == 1.0f;
#define CF_BC1V(Q, UW)                                                                  \
  if (variant == 2)                                                                     \
    bcx::bc1_kernel<Q, true, false, UW><<<g, bcx::kThreads, 0, s>>>(in, o, n, chw);     \
  else if (variant == 1)                                                                \
    bcx::bc1_kernel<Q, false, true, UW><<<g, bcx::kThreads, 0, s>>>(in, o, n, chw);     \
  else                                                                                  \
    bcx::bc1_kernel<Q, false, false, UW><<<g, bcx::kThreads, 0, s>>>(in, o, n, chw);
#define CF_BC1(Q)      \
  case Q:              \
    if (unit) {        \
      CF_BC1V(Q, true) \
    } else {           \
      CF_BC1V(Q, false) \
    }                  \
    break;
  switch (quality) {
    CF_BC1(0) CF_BC1(1) CF_BC1(2) CF_BC1(3) CF_BC1(4)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CF_BC1
#undef CF_BC1V
  return (int)cudaGetLastError();
}

// BC2 (kind 2) or BC3 (kind 3): blocks [n,16,4] float32; out: [n,4] uint32
// (2 alpha words, 2 colour words).
static int bc23_launch(int kind, const void* blocks, void* out, int n, int quality, float w0,
                       float w1, float w2, void* stream) {
  if (n <= 0) return 0;
  const bcx::Chw chw = {{w0, w1, w2}};
  cudaStream_t s = (cudaStream_t)stream;
  const float* in = (const float*)blocks;
  uint4* o = (uint4*)out;
  const dim3 g = bcx::grid_for(n);
  const bool unit = w0 == 1.0f && w1 == 1.0f && w2 == 1.0f;
#define CF_BC23V(Q, UW)                                                              \
  if (kind == 2)                                                                     \
    bcx::bc23_kernel<2, Q, UW><<<g, bcx::kThreads, 0, s>>>(in, o, n, chw);           \
  else                                                                               \
    bcx::bc23_kernel<3, Q, UW><<<g, bcx::kThreads, 0, s>>>(in, o, n, chw);
#define CF_BC23(Q)       \
  case Q:                \
    if (unit) {          \
      CF_BC23V(Q, true)  \
    } else {             \
      CF_BC23V(Q, false) \
    }                    \
    break;
  switch (quality) {
    CF_BC23(0) CF_BC23(1) CF_BC23(2) CF_BC23(3) CF_BC23(4)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CF_BC23
#undef CF_BC23V
  return (int)cudaGetLastError();
}

extern "C" int bc2_encode_launch(const void* blocks, void* out, int n, int quality, float w0,
                                 float w1, float w2, void* stream) {
  return bc23_launch(2, blocks, out, n, quality, w0, w1, w2, stream);
}

extern "C" int bc3_encode_launch(const void* blocks, void* out, int n, int quality, float w0,
                                 float w1, float w2, void* stream) {
  return bc23_launch(3, blocks, out, n, quality, w0, w1, w2, stream);
}

// vals: [n,16] float32; out: [n,2] uint32.
extern "C" int bc4_encode_launch(const void* vals, void* out, int n, int quality,
                                 int is_signed, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* in = (const float*)vals;
  uint2* o = (uint2*)out;
  const dim3 g = bcx::grid_for(n);
#define CF_BC4(Q)                                                                         \
  case Q:                                                                                 \
    if (is_signed)                                                                        \
      bcx::bc4_kernel<Q, true><<<g, bcx::kThreads, 0, s>>>(in, o, n);                     \
    else                                                                                  \
      bcx::bc4_kernel<Q, false><<<g, bcx::kThreads, 0, s>>>(in, o, n);                    \
    break;
  switch (quality) {
    CF_BC4(0) CF_BC4(1) CF_BC4(2) CF_BC4(3) CF_BC4(4)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CF_BC4
  return (int)cudaGetLastError();
}

// blocks: [n,16,nch] float32, nch >= 2; out: [n,4] uint32 (red words, green words).
extern "C" int bc5_encode_launch(const void* blocks, void* out, int n, int nch, int quality,
                                 int is_signed, void* stream) {
  if (n <= 0) return 0;
  if (nch < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* in = (const float*)blocks;
  uint2* o = (uint2*)out;
  const dim3 g = bcx::grid_for(n);
  const int nth = 2 * bcx::kThreads;
#define CF_BC5(Q)                                                                         \
  case Q:                                                                                 \
    if (is_signed)                                                                        \
      bcx::bc5_kernel<Q, true><<<g, nth, 0, s>>>(in, o, n, nch);                          \
    else                                                                                  \
      bcx::bc5_kernel<Q, false><<<g, nth, 0, s>>>(in, o, n, nch);                         \
    break;
  switch (quality) {
    CF_BC5(0) CF_BC5(1) CF_BC5(2) CF_BC5(3) CF_BC5(4)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CF_BC5
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
