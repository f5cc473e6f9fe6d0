// BC6H block encoder (HDR RGB, unsigned and signed half floats), written
// by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel cuttlefish_tpu/kernels/bc6h_pallas.py:_kernel
// (launched by encode_bc6h_pallas at bc6h_pallas.py:704).  It computes what
// that kernel computes: mode 11 and, from quality 2, mode 12, each a PCA
// seed and least-squares refinement; from quality 2 the two-region modes
// of the quality's plan on the partition a 32-partition cluster screen
// ranks first, at quality 3-4 also on the winner of a shallow float fit
// over the top 2 or 6 partitions.  Fitting runs on the half-bit "proxy"
// of each texel; the palette model is the spec decoder's integer
// unquantise -> interpolate -> finalise; candidates are kept by their exact
// error in the linear value domain, or in the proxy domain (code metric).
// The plain PyTorch version of the same algorithm is
// cuttlefish_tpu_torch/kernels/bc6h.py; the two are compared on the card.
//
// Design: a warp per group of 32 blocks, 4 warps per CTA, grid =
// ceil(N / 128).  The warp stages its group's texels in shared memory by
// one coalesced copy of the [32,16,3] floats, turning each into its
// half-bit proxy on the way (to_proxy: round to half, nearest even, clamp
// to the largest finite half, the sign rule; the plain version's _to_proxy
// as torch ops), a block's [channel][texel] rows at a 49-float stride, so
// that 32 lanes on 32 blocks read 32 banks; no texel array lives in a
// thread's local frame.  A texel's selection-domain value and
// linearisation scale are made from its proxy where they are read
// (proxy_to_value, proxy_scale).  Each phase of encode_block is a loop of
// lane tasks, block-minor; with 32 blocks a warp, lane b takes every task
// of block b (modes 11 and 12, the screen over the 32 partitions with its
// top-k, the shallow fits of the screened partitions, fit_regions of the
// winner and the first, the two-region modes of the plan) and keeps the
// running best in registers, so the phases need no shared memory beyond
// the texels; each phase is a non-inlined function.  Its sums over texels
// are each folded in one pass with the others, masks are bit sets, indices
// packed 4 bits a texel, and a texel's chosen palette entry is decoded
// once.  The texel loops of the float fits (pca_seed, ls, texel_line) stay
// rolled: unrolled, they held the block's texels in registers across
// their passes, 217 registers a thread and 8 warps an SM; rolled, 96 and
// 20 (5 CTAs of 12,544 B).  The TPU kernel screened the partitions as MXU
// matmuls; here the screen loops over 32 uint16 membership masks in
// __constant__ memory and sums the same moments in texel order, keeping the
// top k with ties to the lowest partition.  The ten two-region modes'
// scrambled bit layouts are one flat __constant__ table filled by the host
// from the Python table (kernels/bc6h_tables.py), read by one packing loop.
//
// What bounds it: arithmetic.  A block reads 192 bytes and writes 16, but
// runs up to 13 endpoint fits and 13 mode quantisations at quality 4, each
// a 3-candidate index search per texel.
//
// Numerics, so that the kernel agrees with the plain version bit for bit:
// every sum over texels runs in texel order; rounding is rintf (half to
// even), the float-to-half conversion integer arithmetic; 2^(e-25) is
// written into the float32 exponent field (__int_as_float), not computed by
// exp2f; unquantisation and finalisation are integer shifts on int; the
// build passes --fmad=false; division and sqrtf stay IEEE.  Ties keep the first minimum (strict <, ascending).
//
// The device functions are plain C++: the __global__ kernel and the
// launchers need nvcc and sit under __CUDACC__, and a CPU build runs a
// group's lanes one after another (bc6h_cpu).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace bc6h {

constexpr int kMaxSeeds = 6;
constexpr int kGroup = 32;    // blocks a warp: one a lane
constexpr int kWarps = 4;      // warps a CTA
constexpr int kStride = 49;   // floats of a block's proxies in shared memory (48, odd)

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

// Bit t of c_part32[p]: texel t lies in region 1 of BPTC partition p.
__constant__ uint16_t c_part32[32];
__constant__ int c_anchor32[32];
// Per two-region mode id m (row m-1): mode bits, endpoint bits, delta bits
// r/g/b, direct (no deltas).
__constant__ int c_modes[10][6];
// Per mode: block_bit | field << 8 | field_bit << 12 | channel << 16 for
// every endpoint bit (field 0..3 = rw, rx, ry, rz), -1 after the last.
__constant__ int c_layout[10][76];

// Per quality (cuttlefish_tpu/kernels/bc6h.py:444-462): LS iterations,
// partitions ranked by the shallow float fit, two-region mode ids.
__constant__ int c_iters[5] = {1, 2, 3, 5, 8};
__constant__ int c_seeds[5] = {1, 1, 1, 2, 6};
__constant__ int c_plan_len[5] = {0, 0, 3, 4, 10};
__constant__ int c_plan[5][10] = {{0}, {0}, {1, 2, 10}, {1, 2, 6, 10},
                                  {1, 2, 3, 4, 5, 6, 7, 8, 9, 10}};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// Interpolation weight round(k*64/(L-1)) as the float32 floor of an odd
// quotient (the BC6H weight tables equal this formula).
template <int L>
__device__ __forceinline__ int w64(int k) {
  const float inv = (float)(1.0 / (2 * (L - 1)));
  return (int)floorf((float)(k * 128 + (L - 1)) * inv);
}

__device__ __forceinline__ float rt(const float (&x)[16]) {
  float s = x[0];
  for (int t = 1; t < 16; ++t) s += x[t];
  return s;
}

// 128-bit little-endian block.
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
  __device__ __forceinline__ void set_bit(int bit, uint32_t b) {
    if (bit < 64)
      lo |= (uint64_t)b << bit;
    else
      hi |= (uint64_t)b << (bit - 64);
  }
};

// ---------------------------------------------------------------------------
// Decode model
// ---------------------------------------------------------------------------

template <bool S>
__device__ __forceinline__ int unquant(int q, int bits) {
  if (S) {
    const int aq = abs(q);
    const int maxa = (1 << (bits - 1)) - 1;
    const int u = aq == 0 ? 0 : aq >= maxa ? 0x7FFF : (aq * 32768 + 0x4000) >> (bits - 1);
    return q < 0 ? -u : u;
  }
  const int maxq = (1 << bits) - 1;
  return q == 0 ? 0 : q == maxq ? 0xFFFF : (q * 65536 + 0x8000) >> bits;
}

template <bool S>
__device__ __forceinline__ int finalize(int v) {
  if (S) {
    const int sgn = v < 0 ? -1 : v > 0 ? 1 : 0;
    return sgn * ((abs(v) * 31) >> 5);
  }
  return (v * 31) >> 6;
}

template <bool S>
__device__ __forceinline__ float decoded(int u0, int u1, int w) {
  return (float)finalize<S>((u0 * (64 - w) + u1 * w + 32) >> 6);
}

// 2^(e-25) for the exponent segment e of |proxy| a, through the float32
// exponent field.
__device__ __forceinline__ float pow2_segment(float a, float& e) {
  e = fminf(floorf(a * (1.0f / 1024.0f)), 120.0f);
  return __int_as_float(((int)e + 102) << 23);
}

__device__ __forceinline__ float proxy_to_value(float b) {
  const float a = fabsf(b);
  float e;
  const float p2 = pow2_segment(a, e);
  const float m = a - e * 1024.0f;
  const float val = a < 1024.0f ? a * 5.9604644775390625e-08f : p2 * (1024.0f + m);
  return b < 0.0f ? -val : val;
}

__device__ __forceinline__ float proxy_scale(float b) {
  const float a = fabsf(b);
  float e;
  const float p2 = pow2_segment(a, e);
  return a < 1024.0f ? 5.9604644775390625e-08f : p2;
}

// The IEEE binary16 bits of a float32, rounded to nearest even (subnormal
// halves included, 65520 and above to infinity, NaN to 0x7E00), sign kept:
// what torch's .to(torch.float16) gives, in integer arithmetic.
__device__ __forceinline__ uint32_t half_bits(float f) {
  uint32_t x;
#ifdef __CUDACC__
  x = __float_as_uint(f);
#else
  memcpy(&x, &f, 4);
#endif
  const uint32_t ax = x & 0x7FFFFFFFu;
  uint32_t h;
  if (ax > 0x7F800000u) {
    h = 0x7E00u;
  } else if (ax >= 0x477FF000u) {
    h = 0x7C00u;
  } else if (ax >= 0x38800000u) {  // a normal half: 2^-14 and above
    h = (ax >> 13) - (112u << 10);
    const uint32_t rem = ax & 0x1FFFu;
    if (rem > 0x1000u || (rem == 0x1000u && (h & 1u))) ++h;
  } else if (ax <= 0x33000000u) {  // at most 2^-25: rounds to 0
    h = 0u;
  } else {  // a subnormal half, m * 2^-24
    const uint32_t m = (ax & 0x7FFFFFu) | 0x800000u;
    const int sh = 126 - (int)(ax >> 23);  // 14 .. 24
    h = m >> sh;
    const uint32_t rem = m & ((1u << sh) - 1u), half = 1u << (sh - 1);
    if (rem > half || (rem == half && (h & 1u))) ++h;
  }
  return ((x >> 16) & 0x8000u) | h;
}

// The half-bit proxy of a texel value (kernels/bc6h.py:_to_proxy): its
// half's magnitude bits clamped to the largest finite half (0x7BFF),
// negated where the half is negative (signed), else 0 there.
template <bool S>
__device__ __forceinline__ float to_proxy(float f) {
  const uint32_t h = half_bits(f);
  const int m = (int)(h & 0x7FFFu) < 0x7BFF ? (int)(h & 0x7FFFu) : 0x7BFF;
  const bool neg = (h & 0x8000u) != 0u;
  return (float)(S ? (neg ? -m : m) : (neg ? 0 : m));
}

// The best of round +/-1 of a proxy target under the exact decode model.
template <bool S>
__device__ __forceinline__ int quant(float e, int bits) {
  const int maxq = S ? (1 << (bits - 1)) - 1 : (1 << bits) - 1;
  const double scale = S ? 31.0 * 2048.0 / (double)(1 << bits)
                         : 31.0 * 1024.0 / (double)(1 << bits);
  const float inv = (float)(1.0 / scale);
  const int base = (int)rintf(e * inv);
  const int lo = S ? -maxq : 0;
  int best_q = 0;
  float best_e = 0.0f;
  for (int d = -1; d <= 1; ++d) {
    const int q = clampi(base + d, lo, maxq);
    const float dec = (float)finalize<S>(unquant<S>(q, bits));
    const float err = (dec - e) * (dec - e);
    if (d == -1 || err < best_e) {
      best_q = q;
      best_e = err;
    }
  }
  return best_q;
}

// A block's texels: its proxy rows px[c][t] in the warp's shared memory;
// the selection-domain value pxv and the linearisation scale pxs are made
// from the proxy where they are read.  The function needs them once a
// texel: the counting build of chip_smoke.py defines TEXEL_FORM to leave
// these repeats out of its count, and counts each texel's once.
#ifndef TEXEL_FORM
#define TEXEL_FORM(v) (v)
#endif

struct Texels {
  const float (*px)[16];
  bool code;
};

__device__ __forceinline__ float pxv(const Texels& x, int c, int t) {
  return x.code ? x.px[c][t] : TEXEL_FORM(proxy_to_value(x.px[c][t]));
}

__device__ __forceinline__ float pxs(const Texels& x, int c, int t) {
  return x.code ? 1.0f : TEXEL_FORM(proxy_scale(x.px[c][t]));
}

// The palette entry at index k: each channel's finalised value.
template <bool S, int L>
__device__ __forceinline__ void entry(const int (&u0)[3], const int (&u1)[3], int k,
                                      float (&dec)[3]) {
  const int w = w64<L>(k);
  for (int c = 0; c < 3; ++c) dec[c] = decoded<S>(u0[c], u1[c], w);
}

// Index of one texel on the endpoint line: projection, then the best of
// the 3 nearest indices by the linearised error; dec gets its palette
// entry.
template <bool S, int L>
__device__ __forceinline__ int nearest_index(const Texels& x, int t,
                                             const int (&u0)[3],
                                             const int (&u1)[3],
                                             const float (&lof)[3],
                                             const float (&dd)[3],
                                             float denom, float (&dec)[3]) {
  float s = (x.px[0][t] - lof[0]) * dd[0];
  s += (x.px[1][t] - lof[1]) * dd[1];
  s += (x.px[2][t] - lof[2]) * dd[2];
  const float tt = clampf(s / denom, 0.0f, 1.0f);
  const int k = (int)clampf(rintf(tt * (float)(L - 1)), 0.0f, (float)(L - 1));
  const float sc[3] = {pxs(x, 0, t), pxs(x, 1, t), pxs(x, 2, t)};
  int best_k = 0;
  float best_e = 0.0f;
  for (int dk = -1; dk <= 1; ++dk) {
    const int kk = clampi(k + dk, 0, L - 1);
    float e = 0.0f, dv[3];
    entry<S, L>(u0, u1, kk, dv);
    for (int c = 0; c < 3; ++c) {
      const float d = (x.px[c][t] - dv[c]) * sc[c];
      e = c == 0 ? d * d : e + d * d;
    }
    if (dk == -1 || e < best_e) {
      best_k = kk;
      best_e = e;
      for (int c = 0; c < 3; ++c) dec[c] = dv[c];
    }
  }
  return best_k;
}

// Exact selection-domain error of one texel whose palette entry is dv.
__device__ __forceinline__ float texel_error(const Texels& x, int t, const float (&dv)[3],
                                             bool code) {
  float ev = 0.0f;
  for (int c = 0; c < 3; ++c) {
    const float dec = code ? dv[c] : proxy_to_value(dv[c]);
    const float d = pxv(x, c, t) - dec;
    ev = c == 0 ? d * d : ev + d * d;
  }
  return ev;
}

// Index of texel t in indices packed 4 bits a texel.
__device__ __forceinline__ int idx_at(uint64_t idx, int t) { return (int)((idx >> (4 * t)) & 15u); }

// 16-level indices (packed) and the exact block error
// (bc6h_pallas.py:_assign_full).
template <bool S>
__device__ __forceinline__ float assign_full(const Texels& x, const int (&q0)[3],
                                             const int (&q1)[3], int bits,
                                             bool code, uint64_t& idx) {
  int u0[3], u1[3];
  float lof[3], dd[3];
  for (int c = 0; c < 3; ++c) {
    u0[c] = unquant<S>(q0[c], bits);
    u1[c] = unquant<S>(q1[c], bits);
    lof[c] = (float)finalize<S>(u0[c]);
    dd[c] = (float)finalize<S>(u1[c]) - lof[c];
  }
  float denom = dd[0] * dd[0];
  denom += dd[1] * dd[1];
  denom += dd[2] * dd[2];
  denom = denom + 1e-6f;
  float err = 0.0f;
  idx = 0;
  for (int t = 0; t < 16; ++t) {
    float dec[3];
    const int k = nearest_index<S, 16>(x, t, u0, u1, lof, dd, denom, dec);
    idx |= (uint64_t)k << (4 * t);
    const float ev = texel_error(x, t, dec, code);
    err = t == 0 ? ev : err + ev;
  }
  return err;
}

// The 0/1 mask value of texel t of a 16-bit mask.
__device__ __forceinline__ float mask_at(uint32_t m, int t) { return ((m >> t) & 1u) ? 1.0f : 0.0f; }

// Principal-axis extremes of the texels of mask m, power iteration from
// (1,1,1) (bc6h_pallas.py:_pca_seed).  Each sum is its own left fold in
// texel order, taken in one pass with the others; the centred texels are
// made again where read.
__device__ __forceinline__ void pca_seed(const float (*px)[16], uint32_t m,
                                         float (&hi)[3], float (&lo)[3]) {
  float cnt = 0.0f, mean[3], cov[3][3];
#pragma unroll 1
  for (int t = 0; t < 16; ++t) {
    const float mk = mask_at(m, t);
    cnt = t == 0 ? mk : cnt + mk;
    for (int c = 0; c < 3; ++c) {
      const float y = px[c][t] * mk;
      mean[c] = t == 0 ? y : mean[c] + y;
    }
  }
  cnt = cnt + 1e-6f;
  for (int c = 0; c < 3; ++c) mean[c] = mean[c] / cnt;
#pragma unroll 1
  for (int t = 0; t < 16; ++t) {
    const float mk = mask_at(m, t);
    float a[3];
    for (int c = 0; c < 3; ++c) a[c] = (px[c][t] - mean[c]) * mk;
    for (int c = 0; c < 3; ++c)
      for (int d = c; d < 3; ++d) {
        const float y = a[c] * a[d];
        cov[c][d] = t == 0 ? y : cov[c][d] + y;
      }
  }
  for (int c = 0; c < 3; ++c)
    for (int d = 0; d < c; ++d) cov[c][d] = cov[d][c];
  float v[3] = {1.0f, 1.0f, 1.0f};
  for (int it = 0; it < 3; ++it) {
    float nv[3];
    for (int c = 0; c < 3; ++c) {
      float s = cov[c][0] * v[0];
      s += cov[c][1] * v[1];
      s += cov[c][2] * v[2];
      nv[c] = s;
    }
    float nn = nv[0] * nv[0];
    nn += nv[1] * nv[1];
    nn += nv[2] * nv[2];
    nn = sqrtf(nn);
    if (nn > 1e-10f)
      for (int c = 0; c < 3; ++c) v[c] = nv[c] / (nn + 1e-20f);
  }
  float tmax = -1e30f, tmin = 1e30f;
#pragma unroll 1
  for (int t = 0; t < 16; ++t) {
    const float mk = mask_at(m, t);
    float s = ((px[0][t] - mean[0]) * mk) * v[0];
    s += ((px[1][t] - mean[1]) * mk) * v[1];
    s += ((px[2][t] - mean[2]) * mk) * v[2];
    if (mk > 0.0f) {
      tmax = fmaxf(tmax, s);
      tmin = fminf(tmin, s);
    }
  }
  for (int c = 0; c < 3; ++c) {
    hi[c] = mean[c] + v[c] * tmax;
    lo[c] = mean[c] + v[c] * tmin;
  }
}

// Least-squares endpoints for fixed weights on the texels of mask m
// (bc6h_pallas.py:_ls): every sum a left fold in texel order, in one pass.
__device__ __forceinline__ void ls(const float (*px)[16], const float (&w)[16], uint32_t m,
                                   float (&e1)[3], float (&e0)[3]) {
  float a11 = 0.0f, a12 = 0.0f, a22 = 0.0f, cnt = 0.0f, b1[3], b0[3], sm[3];
#pragma unroll 1
  for (int t = 0; t < 16; ++t) {
    const float mk = mask_at(m, t);
    const float om = 1.0f - w[t], wv = w[t] * mk, uv = om * mk;
    const float x11 = wv * w[t], x12 = wv * om, x22 = uv * om;
    a11 = t == 0 ? x11 : a11 + x11;
    a12 = t == 0 ? x12 : a12 + x12;
    a22 = t == 0 ? x22 : a22 + x22;
    cnt = t == 0 ? mk : cnt + mk;
    for (int c = 0; c < 3; ++c) {
      const float y1 = wv * px[c][t], y0 = uv * px[c][t], ym = px[c][t] * mk;
      b1[c] = t == 0 ? y1 : b1[c] + y1;
      b0[c] = t == 0 ? y0 : b0[c] + y0;
      sm[c] = t == 0 ? ym : sm[c] + ym;
    }
  }
  const float det = a11 * a22 - a12 * a12;
  const bool ok = fabsf(det) > 1e-6f;
  const float safe = ok ? det : 1.0f;
  cnt = cnt + 1e-6f;
  for (int c = 0; c < 3; ++c) {
    const float mean = sm[c] / cnt;
    e1[c] = ok ? (a22 * b1[c] - a12 * b0[c]) / safe : mean;
    e0[c] = ok ? (a11 * b0[c] - a12 * b1[c]) / safe : mean;
  }
}

// ---------------------------------------------------------------------------
// One-region modes 11 / 12
// ---------------------------------------------------------------------------

template <bool S>
__device__ __forceinline__ float mode_candidate(const Texels& x,
                                                const float (&e0)[3],
                                                const float (&e1)[3], int bits,
                                                int delta_bits, bool code,
                                                int (&q0)[3], int (&q1)[3],
                                                uint64_t& idx) {
  for (int c = 0; c < 3; ++c) {
    q0[c] = quant<S>(e0[c], bits);
    q1[c] = quant<S>(e1[c], bits);
    if (delta_bits) {
      const int half = 1 << (delta_bits - 1);
      q1[c] = q0[c] + clampi(q1[c] - q0[c], -half, half - 1);
    }
  }
  return assign_full<S>(x, q0, q1, bits, code, idx);
}

// Mode 11 (bits 10) or 12 (bits 11, 9-bit deltas), fitted and packed.
template <bool S>
__device__ __noinline__ float one_region(const Texels& x, int bits,
                                         int delta_bits, int iters, bool code,
                                         Bits& out) {
  float hi[3], lo[3];
  pca_seed(x.px, 0xFFFFu, hi, lo);
  int q0[3], q1[3];
  uint64_t idx;
  float err = mode_candidate<S>(x, hi, lo, bits, delta_bits, code, q0, q1, idx);
  for (int it = 0; it < iters; ++it) {
    float w[16];
    for (int t = 0; t < 16; ++t) w[t] = (float)w64<16>(idx_at(idx, t)) * (1.0f / 64.0f);
    float e1[3], e0[3];
    ls(x.px, w, 0xFFFFu, e1, e0);
    int c0[3], c1[3];
    uint64_t cidx;
    const float e = mode_candidate<S>(x, e0, e1, bits, delta_bits, code, c0, c1, cidx);
    if (e < err) {
      err = e;
      for (int c = 0; c < 3; ++c) {
        q0[c] = c0[c];
        q1[c] = c1[c];
      }
      idx = cidx;
    }
  }
  // Texel 0 anchors: a set index MSB swaps the endpoints.
  const bool swap = idx_at(idx, 0) >= 8;
  out.clear();
  out.put(delta_bits ? 0x07 : 0x03, 5);
  for (int c = 0; c < 3; ++c) out.put(swap ? q1[c] : q0[c], 10);
  for (int c = 0; c < 3; ++c) {
    const int a = swap ? q1[c] : q0[c];
    const int b = swap ? q0[c] : q1[c];
    if (delta_bits) {
      out.put(clampi(b - a, -256, 255), 9);
      out.put((a >> 10) & 1, 1);
    } else {
      out.put(b, 10);
    }
  }
  for (int t = 0; t < 16; ++t) out.put(swap ? 15 - idx_at(idx, t) : idx_at(idx, t), t ? 4 : 3);
  return err;
}

// ---------------------------------------------------------------------------
// Two-region modes
// ---------------------------------------------------------------------------

// The k lowest within-cluster SSEs of the 32 partitions, best first, ties
// to the lowest partition (bc6h_pallas.py:_screen2).
__device__ __noinline__ void screen2(const float (*px)[16], int k,
                                     int (&parts)[kMaxSeeds]) {
  float sq[16];
  for (int t = 0; t < 16; ++t) {
    float s = px[0][t] * px[0][t];
    s += px[1][t] * px[1][t];
    s += px[2][t] * px[2][t];
    sq[t] = s;
  }
  const float sq_all = rt(sq);
  float s_all[3];
  for (int c = 0; c < 3; ++c) s_all[c] = rt(px[c]);
  float score[kMaxSeeds];
  for (int i = 0; i < kMaxSeeds; ++i) {
    score[i] = INFINITY;
    parts[i] = 0;
  }
  for (int p = 0; p < 32; ++p) {
    const uint32_t m = c_part32[p];
    float s1[3] = {0.0f, 0.0f, 0.0f};
    for (int t = 0; t < 16; ++t) {
      if ((m >> t) & 1u) {
        s1[0] += px[0][t];
        s1[1] += px[1][t];
        s1[2] += px[2][t];
      }
    }
    const float ns = (float)__popc(m);
    const float n1 = ns + 1e-6f;
    const float n0 = (16.0f - ns) + 1e-6f;
    float a = s1[0] * s1[0];
    a += s1[1] * s1[1];
    a += s1[2] * s1[2];
    float b = (s_all[0] - s1[0]) * (s_all[0] - s1[0]);
    b += (s_all[1] - s1[1]) * (s_all[1] - s1[1]);
    b += (s_all[2] - s1[2]) * (s_all[2] - s1[2]);
    const float sse = sq_all - (a / n1 + b / n0);
    if (sse < score[k - 1]) {
      int j = k - 1;
      while (j > 0 && sse < score[j - 1]) {
        score[j] = score[j - 1];
        parts[j] = parts[j - 1];
        --j;
      }
      score[j] = sse;
      parts[j] = p;
    }
  }
}

// Shared float endpoints per region (bc6h_pallas.py:_fit_regions_float):
// PCA seeds, alternating LS kept by the continuous line-fit SSE, each
// region oriented so that its anchor texel is nearer e0.  Returns the SSE.
struct Regions {
  float e0[2][3], e1[2][3];
};

__device__ __forceinline__ float texel_line(const Texels& x, uint32_t m1bits,
                                            const Regions& r, float (&w)[16]) {
  const float (*px)[16] = x.px;
  float sse = 0.0f;
#pragma unroll 1
  for (int t = 0; t < 16; ++t) {
    const float m1 = mask_at(m1bits, t), m0 = 1.0f - m1;
    float e0t[3], dd[3];
    for (int c = 0; c < 3; ++c) {
      e0t[c] = r.e0[0][c] * m0 + r.e0[1][c] * m1;
      const float e1t = r.e1[0][c] * m0 + r.e1[1][c] * m1;
      dd[c] = e1t - e0t[c];
    }
    float denom = dd[0] * dd[0];
    denom += dd[1] * dd[1];
    denom += dd[2] * dd[2];
    denom = denom + 1e-6f;
    float s = (px[0][t] - e0t[0]) * dd[0];
    s += (px[1][t] - e0t[1]) * dd[1];
    s += (px[2][t] - e0t[2]) * dd[2];
    w[t] = clampf(s / denom, 0.0f, 1.0f);
    float q = 0.0f;
    for (int c = 0; c < 3; ++c) {
      const float y = (e0t[c] + w[t] * dd[c] - px[c][t]) * pxs(x, c, t);
      q = c == 0 ? y * y : q + y * y;
    }
    sse = t == 0 ? q : sse + q;
  }
  return sse;
}

__device__ __noinline__ float fit_regions(const Texels& x, uint32_t m1bits,
                                          int anchor1, int iters,
                                          Regions& out) {
  const uint32_t mk[2] = {~m1bits & 0xFFFFu, m1bits};
  Regions r;
  for (int p = 0; p < 2; ++p) pca_seed(x.px, mk[p], r.e1[p], r.e0[p]);
  float w[16];
  float best_sse = texel_line(x, m1bits, r, w);
  Regions best = r;
  for (int it = 0; it < iters - 1; ++it) {
    for (int p = 0; p < 2; ++p) ls(x.px, w, mk[p], r.e1[p], r.e0[p]);
    const float sse = texel_line(x, m1bits, r, w);
    if (sse < best_sse) best = r;
    best_sse = fminf(sse, best_sse);
  }
  for (int p = 0; p < 2; ++p) {
    const int at = p == 0 ? 0 : anchor1;
    float a[3];
    for (int c = 0; c < 3; ++c) {
      a[c] = 0.0f;
      for (int t = 0; t < 16; ++t)
        if (t == at) a[c] = x.px[c][t];
    }
    float d0 = 0.0f, d1 = 0.0f;
    for (int c = 0; c < 3; ++c) {
      const float x0 = a[c] - best.e0[p][c];
      const float x1 = a[c] - best.e1[p][c];
      d0 = c == 0 ? x0 * x0 : d0 + x0 * x0;
      d1 = c == 0 ? x1 * x1 : d1 + x1 * x1;
    }
    const bool flip = d1 < d0;
    for (int c = 0; c < 3; ++c) {
      out.e0[p][c] = flip ? best.e1[p][c] : best.e0[p][c];
      out.e1[p][c] = flip ? best.e0[p][c] : best.e1[p][c];
    }
  }
  return best_sse;
}

// One two-region mode (bc6h_pallas.py:_fit_two_region and
// _pack_two_region): quantise the region endpoints (deltas from rw unless
// direct), index every texel with 3 bits (2 at the anchors) and pack
// through the mode's layout table.  Returns the exact error.
template <bool S>
__device__ __noinline__ float two_region(const Texels& x, uint32_t m1bits,
                                         int part, int anchor1,
                                         const Regions& r, int mode_id,
                                         bool code, Bits& out) {
  const int* mode = c_modes[mode_id - 1];
  const int epbits = mode[1];
  const bool direct = mode[5] != 0;
  int fields[4][3];  // rw, rx, ry, rz
  int eff[4][3];
  for (int c = 0; c < 3; ++c) {
    const int rw = quant<S>(r.e0[0][c], epbits);
    const int vals[3] = {quant<S>(r.e1[0][c], epbits),
                         quant<S>(r.e0[1][c], epbits),
                         quant<S>(r.e1[1][c], epbits)};
    fields[0][c] = eff[0][c] = rw;
    for (int f = 0; f < 3; ++f) {
      if (direct) {
        fields[f + 1][c] = eff[f + 1][c] = vals[f];
      } else {
        const int half = 1 << (mode[2 + c] - 1);
        const int dlt = clampi(vals[f] - rw, -half, half - 1);
        fields[f + 1][c] = dlt;
        eff[f + 1][c] = rw + dlt;
      }
    }
  }
  // Region 0 runs rw -> rx, region 1 ry -> rz.
  int u[2][2][3];
  float lof[2][3], dd[2][3], denom[2];
  for (int p = 0; p < 2; ++p) {
    for (int c = 0; c < 3; ++c) {
      u[p][0][c] = unquant<S>(eff[2 * p][c], epbits);
      u[p][1][c] = unquant<S>(eff[2 * p + 1][c], epbits);
      lof[p][c] = (float)finalize<S>(u[p][0][c]);
      dd[p][c] = (float)finalize<S>(u[p][1][c]) - lof[p][c];
    }
    float dn = dd[p][0] * dd[p][0];
    dn += dd[p][1] * dd[p][1];
    dn += dd[p][2] * dd[p][2];
    denom[p] = dn + 1e-6f;
  }
  uint64_t idx = 0;
  float err = 0.0f;
  for (int t = 0; t < 16; ++t) {
    const int p = (m1bits >> t) & 1u;
    float dec[3];
    int k = nearest_index<S, 8>(x, t, u[p][0], u[p][1], lof[p], dd[p], denom[p], dec);
    if ((t == 0 || t == anchor1) && k > 3) {  // an anchor's index has 2 bits
      k = 3;
      entry<S, 8>(u[p][0], u[p][1], k, dec);
    }
    idx |= (uint64_t)k << (4 * t);
    const float ev = texel_error(x, t, dec, code);
    err = t == 0 ? ev : err + ev;
  }

  out.clear();
  out.lo = (uint64_t)(uint32_t)mode[0];
  for (int i = 0; i < 76; ++i) {
    const int e = c_layout[mode_id - 1][i];
    if (e < 0) break;
    const int field = (e >> 8) & 3, field_bit = (e >> 12) & 15, ch = (e >> 16) & 3;
    out.set_bit(e & 0xFF, ((uint32_t)fields[field][ch] >> field_bit) & 1u);
  }
  for (int i = 0; i < 5; ++i) out.set_bit(77 + i, ((uint32_t)part >> i) & 1u);
  out.pos = 82;
  for (int t = 0; t < 16; ++t)
    out.put(idx_at(idx, t), 3 - (t == 0 ? 1 : 0) - (t == anchor1 ? 1 : 0));
  return err;
}

// ---------------------------------------------------------------------------
// One block
// ---------------------------------------------------------------------------

template <bool S>
__device__ __forceinline__ void encode_block(const Texels& x, int quality,
                                             bool code, uint32_t (&words)[4]) {
  const int iters = c_iters[quality];
  Bits best, cand;
  float err = one_region<S>(x, 10, 0, iters, code, best);
  if (quality >= 2) {
    const float e = one_region<S>(x, 11, 9, iters, code, cand);
    if (e < err) {
      err = e;
      best = cand;
    }
    const int k2 = c_seeds[quality];
    int seeds[kMaxSeeds];
    screen2(x.px, k2, seeds);
    const int d = seeds[0];
    int dwin = d;
    if (k2 > 1) {
      // Rank the screened partitions by a shallow (2-iteration) float fit.
      float fit_sse = 0.0f;
      for (int j = 0; j < k2; ++j) {
        Regions r;
        const float sse =
            fit_regions(x, c_part32[seeds[j]], c_anchor32[seeds[j]], 2, r);
        if (j > 0 && sse < fit_sse) dwin = seeds[j];
        fit_sse = j == 0 ? sse : fminf(fit_sse, sse);
      }
    }
    // The winner with every mode of the plan, then the screen's first
    // with quality 2's modes (skipped when it is the winner: the same fits
    // again, which cannot win a strict comparison).
    for (int gi = 0; gi < (k2 > 1 ? 2 : 1); ++gi) {
      const int dk = gi == 0 ? dwin : d;
      if (gi == 1 && dk == dwin) break;
      const int q = gi == 0 ? quality : 2;
      Regions r;
      fit_regions(x, c_part32[dk], c_anchor32[dk], iters, r);
      for (int i = 0; i < c_plan_len[q]; ++i) {
        const float e2 = two_region<S>(x, c_part32[dk], dk, c_anchor32[dk], r,
                                       c_plan[q][i], code, cand);
        if (e2 < err) {
          err = e2;
          best = cand;
        }
      }
    }
  }
  words[0] = (uint32_t)best.lo;
  words[1] = (uint32_t)(best.lo >> 32);
  words[2] = (uint32_t)best.hi;
  words[3] = (uint32_t)(best.hi >> 32);
}

// Blocks i0 .. i0 + ng - 1 (ng <= kGroup) of blocks [n,16,3] by one warp;
// px: its kGroup * kStride floats of shared memory.  The texels are staged
// as proxies by one coalesced copy, then lane b encodes block b.
template <bool S>
__device__ void encode_group(const float* blocks, long long i0, int ng, int quality, bool code,
                             float* px, uint32_t* out) {
  FOR_LANES(lane) {
    const float* src = blocks + i0 * 48;
    for (int x = lane; x < ng * 48; x += 32) {
      const int b = x / 48, r = x - b * 48, t = r / 3;
      px[b * kStride + (r - 3 * t) * 16 + t] = to_proxy<S>(src[x]);
    }
  }
  WARP_SYNC();
  FOR_LANES(lane) {
    if (lane < ng) {
      const Texels x = {(const float (*)[16])(px + lane * kStride), code};
      uint32_t words[4];
      encode_block<S>(x, quality, code, words);
      for (int k = 0; k < 4; ++k) out[(i0 + lane) * 4 + k] = words[k];
    }
  }
  WARP_SYNC();
}

#ifndef __CUDACC__

// n blocks [n,16,3] -> words [n,4] on the CPU: groups of kGroup blocks, as
// the card's warps take them, each group's lanes one after another.
inline void bc6h_cpu(const float* blocks, uint32_t* out, int n, int quality, bool is_signed,
                     bool code) {
  static float px[kGroup * kStride];
  for (long long i0 = 0; i0 < n; i0 += kGroup) {
    const int ng = n - i0 < kGroup ? (int)(n - i0) : kGroup;
    if (is_signed)
      encode_group<true>(blocks, i0, ng, quality, code, px, out);
    else
      encode_group<false>(blocks, i0, ng, quality, code, px, out);
  }
}

#endif  // !__CUDACC__

#ifdef __CUDACC__

template <bool S>
__global__ void __launch_bounds__(kWarps * 32)
    bc6h_kernel(const float* __restrict__ blocks, uint32_t* __restrict__ out, int n,
                int quality, int code) {
  __shared__ float s_px[kWarps][kGroup * kStride];
  const int warp = threadIdx.x >> 5;
  const long long i0 = ((long long)blockIdx.x * kWarps + warp) * kGroup;
  if (i0 >= n) return;
  const int ng = n - i0 < kGroup ? (int)(n - i0) : kGroup;
  encode_group<S>(blocks, i0, ng, quality, code != 0, s_px[warp], out);
}

#endif  // __CUDACC__

}  // namespace bc6h

#ifdef __CUDACC__

// Copies the 32 region-1 masks and anchors, the [10][6] mode table and the
// [10][76] layout table (host arrays) into constant memory of the current
// device.  Returns a cudaError_t.
extern "C" int bc6h_set_tables(const uint16_t* masks, const int* anchors,
                               const int* modes, const int* layout) {
  cudaError_t e = cudaMemcpyToSymbol(bc6h::c_part32, masks, 32 * sizeof(uint16_t));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(bc6h::c_anchor32, anchors, 32 * sizeof(int));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(bc6h::c_modes, modes, 10 * 6 * sizeof(int));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(bc6h::c_layout, layout, 10 * 76 * sizeof(int));
  return (int)e;
}

// blocks: [n,16,3] float32 device pointer (the texels; the kernel makes
// their half-bit proxy); out: [n,4] uint32.  Launches on `stream` and
// returns cudaGetLastError() (the launch is not synchronised).
extern "C" int bc6h_encode_launch(const void* blocks, void* out, int n,
                                  int quality, int is_signed, int code,
                                  void* stream) {
  if (n <= 0) return 0;
  if (quality < 0 || quality > 4) return (int)cudaErrorInvalidValue;
  constexpr int per_cta = bc6h::kWarps * bc6h::kGroup;
  const dim3 grid((n + per_cta - 1) / per_cta);
  cudaStream_t s = (cudaStream_t)stream;
  const float* in = (const float*)blocks;
  uint32_t* o = (uint32_t*)out;
  if (is_signed)
    bc6h::bc6h_kernel<true><<<grid, bc6h::kWarps * 32, 0, s>>>(in, o, n, quality, code);
  else
    bc6h::bc6h_kernel<false><<<grid, bc6h::kWarps * 32, 0, s>>>(in, o, n, quality, code);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
