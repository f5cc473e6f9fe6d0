// ETC1/ETC2/EAC block encoders, written by hand for Hopper (sm_90a).
//
// Replaces the five TPU kernels of cuttlefish_tpu/kernels/etc_pallas.py:
// encode_eac_r11_pallas (pl.pallas_call at :1083), encode_eac_rg11_pallas
// (:1123), and encode_etc_rgb_pallas, encode_etc2_rgba_pallas and
// encode_eac_alpha_pallas (all through _run, :1231).  They share three
// bodies: _rgb_words (ETC1 differential and, from quality 1, individual
// mode, both flips, over a quant-index neighbourhood of the sub-block means
// ranked by a restricted-table estimate; for ETC2 the planar, T and H modes,
// refined at quality 4), _eac_r11 and _eac_alpha.  The entries compose them
// as the Pallas entries do: RGBA = _eac_alpha on alpha, then _rgb_words with
// ETC2 on; RG11 = _eac_r11 on red, then on green.  The plain PyTorch version
// of the same algorithms is cuttlefish_tpu_torch/kernels/etc.py; the two are
// compared on the card.
//
// Design: one thread per 4x4 block, 128 threads per CTA, grid = ceil(N /
// 128), as the BC kernels.  The TPU kernels put 256-512 blocks on vector
// lanes and unrolled every candidate over [16, TN] tiles; here each thread
// runs its block's sweep alone.  Each candidate family (differential fit,
// individual fit, planar, T, H, the EAC search) is its own non-inlined
// function, so that only the texels, the best words and the best error live
// across families; a fit keeps its base colours and tables and rebuilds its
// 2-bit indices (packed into the word as it goes) only for the winner, and
// the EAC search rebuilds its 3-bit indices once for the winner.  Quality is
// a run-time argument: q2 and q3 are one algorithm, and the families are
// compiled once for all qualities.
//
// What bounds it: arithmetic.  A block reads 256 bytes (64 for A8/R11, 128
// for RG11) and writes 8 or 16, but an ETC2 block at quality 2 evaluates
// some 600 palettes of 8 or 16 texels, and at quality 4 some 1,200 more in
// the planar and T/H refinements.  Loads are per thread and not coalesced
// across a warp; a warp per block and shared-memory staging are later work.
//
// Numerics, so that the kernel agrees with the plain version bit for bit:
// every sum over texels runs in texel order (a sub-block's 8 members alone:
// adding the masked-out +0.0 terms of the reference is exact) and every sum
// over channels in channel order; rounding is rintf (half to even, as
// jnp.round) and floorf; every constant is the float32 value that JAX uses
// (a Python double rounded once, e.g. (float)(31.0 / 255.0)); the build
// passes --fmad=false so that no a*b+c is contracted; division and sqrtf
// stay IEEE.  Every search keeps the first minimum (strict <, in candidate
// order); invalid H candidates add 1e30 to their error in float32, as the
// reference does.  EAC's multiplier seed is span * float32(1 / max_pos[t]),
// the product XLA makes of the reference's division by a constant.
//
// The device functions are plain C++: the __global__ kernels and the
// launchers need nvcc and sit under __CUDACC__.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <math.h>
#include <stdint.h>

namespace etcx {

constexpr int kThreads = 128;
constexpr float kBig = 1e30f;
// Quantiser scales: the Python doubles m / 255.0 rounded once to float32.
constexpr float kQ15 = (float)(15.0 / 255.0);
constexpr float kQ31 = (float)(31.0 / 255.0);
constexpr float kQ63 = (float)(63.0 / 255.0);
constexpr float kQ127 = (float)(127.0 / 255.0);
constexpr int kMaxOthers = 30;  // quality 4: 31 offsets, the centre apart

// ETC1 intensity modifiers [table][index] (etc.py:_ETC1_MODS_NP).
__constant__ int c_etc1_mods[8][4] = {
    {2, 8, -2, -8},     {5, 17, -5, -17},   {9, 29, -9, -29},    {13, 42, -13, -42},
    {18, 60, -18, -60}, {24, 80, -24, -80}, {33, 106, -33, -106}, {47, 183, -47, -183},
};
// EAC modifiers [table][index] (etc.py:_EAC_MODS_NP); column 7 is each
// table's largest positive modifier.
__constant__ int c_eac_mods[16][8] = {
    {-3, -6, -9, -15, 2, 5, 8, 14}, {-3, -7, -10, -13, 2, 6, 9, 12},
    {-2, -5, -8, -13, 1, 4, 7, 12}, {-2, -4, -6, -13, 1, 3, 5, 12},
    {-3, -6, -8, -12, 2, 5, 7, 11}, {-3, -7, -9, -11, 2, 6, 8, 10},
    {-4, -7, -8, -11, 3, 6, 7, 10}, {-3, -5, -8, -11, 2, 4, 7, 10},
    {-2, -6, -8, -10, 1, 5, 7, 9},  {-2, -5, -8, -10, 1, 4, 7, 9},
    {-2, -4, -8, -10, 1, 3, 7, 9},  {-2, -5, -7, -10, 1, 4, 6, 9},
    {-3, -4, -7, -10, 2, 3, 6, 9},  {-1, -2, -3, -10, 0, 1, 2, 9},
    {-4, -6, -8, -9, 3, 5, 7, 8},   {-3, -5, -7, -9, 2, 4, 6, 8},
};
// ETC2 T/H distances (etc.py:_ETC2_DIST_NP).
__constant__ int c_dist[8] = {3, 6, 11, 16, 23, 32, 41, 64};
// EAC multiplier candidates per quality (etc.py:_EAC_MULT_CANDS).
__constant__ int c_eac_ncand[5] = {1, 2, 3, 5, 7};

// Planar least-squares projection [O/H/V][texel]: the float64 matrix of
// etc_pallas.py:_planar_proj, each entry rounded once to float32.
__constant__ float c_planar_proj[3][16] = {
    {0x1.266666p-2f, 0x1.b33334p-3f, 0x1.19999ap-3f, 0x1p-4f,
     0x1.b33334p-3f, 0x1.19999ap-3f, 0x1p-4f, -0x1.99999ap-7f,
     0x1.19999ap-3f, 0x1p-4f, -0x1.99999ap-7f, -0x1.666666p-4f,
     0x1p-4f, -0x1.99999ap-7f, -0x1.666666p-4f, -0x1.4cccccp-3f},
    {-0x1.99999ap-7f, 0x1.ccccccp-4f, 0x1.e66666p-3f, 0x1.733334p-2f,
     -0x1.666666p-4f, 0x1.333334p-5f, 0x1.4cccccp-3f, 0x1.266666p-2f,
     -0x1.4cccccp-3f, -0x1.333334p-5f, 0x1.666666p-4f, 0x1.b33334p-3f,
     -0x1.e66666p-3f, -0x1.ccccccp-4f, 0x1.99999ap-7f, 0x1.19999ap-3f},
    {-0x1.99999ap-7f, -0x1.666666p-4f, -0x1.4cccccp-3f, -0x1.e66666p-3f,
     0x1.ccccccp-4f, 0x1.333334p-5f, -0x1.333334p-5f, -0x1.ccccccp-4f,
     0x1.e66666p-3f, 0x1.4cccccp-3f, 0x1.666666p-4f, 0x1.99999ap-7f,
     0x1.733334p-2f, 0x1.266666p-2f, 0x1.b33334p-3f, 0x1.19999ap-3f},
};

struct Chw {
  float w[3];
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float sq(float x) { return x * x; }

__device__ __forceinline__ int expand4(int v) { return (v << 4) | v; }

__device__ __forceinline__ int expand5(int v) { return (v << 3) | (v >> 2); }

__device__ __forceinline__ uint32_t bswap(uint32_t w) {
  return ((w & 0xFFu) << 24) | ((w & 0xFF00u) << 8) | ((w >> 8) & 0xFF00u) | (w >> 24);
}

// ETC's column-major pixel number of raster texel t (its own inverse).
__device__ __forceinline__ int colmajor(int t) { return 4 * (t & 3) + (t >> 2); }

// Raster texel t lies in sub-block `sub` (0 or 1) of flip `flip`: flip 0
// splits columns 0-1 | 2-3, flip 1 rows 0-1 | 2-3.
__device__ __forceinline__ bool member(int t, int flip, int sub) {
  const bool in2 = flip ? (t >> 2) >= 2 : (t & 3) >= 2;
  return in2 == (sub == 1);
}

// A 2-bit index m of raster texel t in an ETC index word: bit p = its lsb,
// bit 16 + p = its msb, p = the column-major pixel number.
__device__ __forceinline__ uint32_t index_bits(int t, int m) {
  const int p = colmajor(t);
  return ((uint32_t)(m & 1) << p) | ((uint32_t)(m >> 1) << (16 + p));
}

// Offset i of the quant-index neighbourhood (etc_tables.py:_ETC_OFFSETS):
// the 27-point cube in (a, b, c) order, then (-2,-2,-2), (2,2,2), (-3,-3,-3),
// (3,3,3).
__device__ __forceinline__ int offset_of(int i, int c) {
  if (i < 27) return (c == 0 ? i / 9 : c == 1 ? (i / 3) % 3 : i % 3) - 1;
  const int j = i - 27;
  return (j & 1 ? 1 : -1) * (2 + (j >> 1));
}

// Quality ladder: offsets searched and candidates deep-fitted.  Quality 0-1
// search the centre (0,0,0) alone.
__device__ __forceinline__ int n_offsets(int q) { return q < 2 ? 1 : (q < 4 ? 27 : 31); }
__device__ __forceinline__ int est_keep(int q) { return q < 2 ? 0 : (q < 4 ? 4 : 8); }
// The offset index of the j-th non-centre offset (the centre is index 13).
__device__ __forceinline__ int other_offset(int j) { return j < 13 ? j : j + 1; }

// ---------------------------------------------------------------------------
// ETC1 modifier-table fits (etc_pallas.py:_best_table_fit, _best_table_fit2,
// _restricted_err)
// ---------------------------------------------------------------------------

// sum_c chw[c] * (px[c][t] - clip(dec[c] + mod, 0, 255))^2, channels in order.
__device__ __forceinline__ float pix_err(const float (*px)[16], int t, const float (&dec)[3],
                                         float mod, const float* chw) {
  float e = chw[0] * sq(px[0][t] - clampf(dec[0] + mod, 0.0f, 255.0f));
  e = e + chw[1] * sq(px[1][t] - clampf(dec[1] + mod, 0.0f, 255.0f));
  e = e + chw[2] * sq(px[2][t] - clampf(dec[2] + mod, 0.0f, 255.0f));
  return e;
}

__device__ __forceinline__ void dec_of(const int (&b)[3], bool five, float (&dec)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) dec[c] = (float)(five ? expand5(b[c]) : expand4(b[c]));
}

// Error of every modifier table over the members of one sub-block.
__device__ __forceinline__ void table_errs(const float (*px)[16], const float (&dec)[3], int flip,
                                           int sub, const float* chw, float (&err)[8]) {
  for (int tb = 0; tb < 8; ++tb) {
    float mods[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) mods[m] = (float)c_etc1_mods[tb][m];
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      if (!member(t, flip, sub)) continue;
      float e = pix_err(px, t, dec, mods[0], chw);
#pragma unroll
      for (int m = 1; m < 4; ++m) e = fminf(e, pix_err(px, t, dec, mods[m], chw));
      acc = acc + e;
    }
    err[tb] = acc;
  }
}

// First table of least error.
__device__ __forceinline__ int best_table(const float (&err)[8]) {
  int bt = 0;
#pragma unroll
  for (int tb = 1; tb < 8; ++tb)
    if (err[tb] < err[bt]) bt = tb;
  return bt;
}

// (table, error) of the exhaustive fit of one sub-block.
__device__ __forceinline__ float table_fit(const float (*px)[16], const float (&dec)[3], int flip,
                                           int sub, const float* chw, int& table) {
  float err[8];
  table_errs(px, dec, flip, sub, chw, err);
  table = best_table(err);
  return err[table];
}

// The index bits of one sub-block's members under `table` (first minimum).
__device__ __forceinline__ uint32_t table_bits(const float (*px)[16], const float (&dec)[3],
                                               int flip, int sub, const float* chw, int table) {
  uint32_t bits = 0u;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    if (!member(t, flip, sub)) continue;
    float be = pix_err(px, t, dec, (float)c_etc1_mods[table][0], chw);
    int bm = 0;
    for (int m = 1; m < 4; ++m) {
      const float e = pix_err(px, t, dec, (float)c_etc1_mods[table][m], chw);
      if (e < be) {
        be = e;
        bm = m;
      }
    }
    bits |= index_bits(t, bm);
  }
  return bits;
}

// Block error with the table restricted to the 8 values mv, index free.
__device__ __forceinline__ float restricted_err(const float (*px)[16], const float (&dec)[3],
                                                int flip, int sub, const float* chw,
                                                const float (&mv)[8]) {
  float acc = 0.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    if (!member(t, flip, sub)) continue;
    float e = pix_err(px, t, dec, mv[0], chw);
    for (int k = 1; k < 8; ++k) e = fminf(e, pix_err(px, t, dec, mv[k], chw));
    acc = acc + e;
  }
  return acc;
}

// The centre's table fit with its runner-up: mv = the best table's four
// modifiers, then the runner-up's (_table_modvals of both).
__device__ __forceinline__ float centre_fit(const float (*px)[16], const float (&dec)[3], int flip,
                                            int sub, const float* chw, int& table, float (&mv)[8]) {
  float err[8];
  table_errs(px, dec, flip, sub, chw, err);
  table = best_table(err);
  // _best_table_fit2: the first least error with the best table at 1e30.
  int t2 = 0;
  float e2 = table == 0 ? kBig : err[0];
  for (int tb = 1; tb < 8; ++tb) {
    const float ee = tb == table ? kBig : err[tb];
    if (ee < e2) {
      e2 = ee;
      t2 = tb;
    }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    mv[m] = (float)c_etc1_mods[table][m];
    mv[4 + m] = (float)c_etc1_mods[t2][m];
  }
  return err[table];
}

// Lowest estimate among those not chosen yet, ties to the lower index
// (the chosen ones count as 1e30); marks it chosen.
__device__ __forceinline__ int topk_pick(const float* ests, int n, uint32_t& chosen) {
  int bi = 0;
  float be = (chosen & 1u) ? kBig : ests[0];
  for (int i = 1; i < n; ++i) {
    const float ee = ((chosen >> i) & 1u) ? kBig : ests[i];
    if (ee < be) {
      be = ee;
      bi = i;
    }
  }
  chosen |= 1u << bi;
  return bi;
}

// ---------------------------------------------------------------------------
// Differential and individual modes (etc_pallas.py:_diff_fit, _ind_subfit)
// ---------------------------------------------------------------------------

struct DiffFit {
  int b1[3], d[3], t1, t2;
  float err;
};

struct SubFit {
  int b[3], t;
  float err;
};

// Differential mode, both sub-blocks at once: base 1 from the offset, base
// 2 = base 1 + the clipped delta to sub-block 2's rounded mean.
__device__ __noinline__ void diff_fit(const float (*px)[16], const float* chw, int flip,
                                      const float* mean1, const float* mean2, int quality,
                                      DiffFit* out) {
  float base1_q[3];
  int b2n[3];
  for (int c = 0; c < 3; ++c) {
    base1_q[c] = rintf(mean1[c] * kQ31);
    b2n[c] = (int)clampf(rintf(mean2[c] * kQ31), 0.0f, 31.0f);
  }
  DiffFit best;
  // The centre offset (0, 0, 0).
  int b1[3], d[3], b2[3];
  for (int c = 0; c < 3; ++c) {
    b1[c] = (int)clampf(base1_q[c], 0.0f, 31.0f);
    d[c] = clampi(b2n[c] - b1[c], -4, 3);
    b2[c] = b1[c] + d[c];
  }
  float dec1[3], dec2[3], mv1[8], mv2[8];
  dec_of(b1, true, dec1);
  dec_of(b2, true, dec2);
  const int keep = est_keep(quality);
  if (keep == 0) {
    best.err = table_fit(px, dec1, flip, 0, chw, best.t1) + table_fit(px, dec2, flip, 1, chw, best.t2);
  } else {
    const float e1 = centre_fit(px, dec1, flip, 0, chw, best.t1, mv1);
    const float e2 = centre_fit(px, dec2, flip, 1, chw, best.t2, mv2);
    best.err = e1 + e2;
  }
  for (int c = 0; c < 3; ++c) {
    best.b1[c] = b1[c];
    best.d[c] = d[c];
  }
  if (keep > 0) {
    const int n = n_offsets(quality) - 1;
    float ests[kMaxOthers];
    for (int j = 0; j < n; ++j) {
      const int i = other_offset(j);
      for (int c = 0; c < 3; ++c) {
        b1[c] = (int)clampf(base1_q[c] + (float)offset_of(i, c), 0.0f, 31.0f);
        b2[c] = b1[c] + clampi(b2n[c] - b1[c], -4, 3);
      }
      dec_of(b1, true, dec1);
      dec_of(b2, true, dec2);
      const float e1 = restricted_err(px, dec1, flip, 0, chw, mv1);
      ests[j] = e1 + restricted_err(px, dec2, flip, 1, chw, mv2);
    }
    uint32_t chosen = 0u;
    for (int r = 0; r < keep; ++r) {
      const int i = other_offset(topk_pick(ests, n, chosen));
      for (int c = 0; c < 3; ++c) {
        b1[c] = (int)clampf(base1_q[c] + (float)offset_of(i, c), 0.0f, 31.0f);
        d[c] = clampi(b2n[c] - b1[c], -4, 3);
        b2[c] = b1[c] + d[c];
      }
      dec_of(b1, true, dec1);
      dec_of(b2, true, dec2);
      int t1, t2;
      const float e1 = table_fit(px, dec1, flip, 0, chw, t1);
      const float err = e1 + table_fit(px, dec2, flip, 1, chw, t2);
      if (err < best.err) {
        for (int c = 0; c < 3; ++c) {
          best.b1[c] = b1[c];
          best.d[c] = d[c];
        }
        best.t1 = t1;
        best.t2 = t2;
        best.err = err;
      }
    }
  }
  *out = best;
}

// Individual mode, one sub-block: a 4-bit base from the offset.
__device__ __noinline__ void ind_subfit(const float (*px)[16], const float* chw, int flip, int sub,
                                        const float* mean, int quality, SubFit* out) {
  float base_q[3];
  for (int c = 0; c < 3; ++c) base_q[c] = rintf(mean[c] * kQ15);
  SubFit best;
  int b[3];
  for (int c = 0; c < 3; ++c) b[c] = (int)clampf(base_q[c], 0.0f, 15.0f);
  float dec[3], mv[8];
  dec_of(b, false, dec);
  const int keep = est_keep(quality);
  best.err = keep == 0 ? table_fit(px, dec, flip, sub, chw, best.t)
                       : centre_fit(px, dec, flip, sub, chw, best.t, mv);
  for (int c = 0; c < 3; ++c) best.b[c] = b[c];
  if (keep > 0) {
    const int n = n_offsets(quality) - 1;
    float ests[kMaxOthers];
    for (int j = 0; j < n; ++j) {
      const int i = other_offset(j);
      for (int c = 0; c < 3; ++c)
        b[c] = (int)clampf(base_q[c] + (float)offset_of(i, c), 0.0f, 15.0f);
      dec_of(b, false, dec);
      ests[j] = restricted_err(px, dec, flip, sub, chw, mv);
    }
    uint32_t chosen = 0u;
    for (int r = 0; r < keep; ++r) {
      const int i = other_offset(topk_pick(ests, n, chosen));
      for (int c = 0; c < 3; ++c)
        b[c] = (int)clampf(base_q[c] + (float)offset_of(i, c), 0.0f, 15.0f);
      dec_of(b, false, dec);
      int t;
      const float err = table_fit(px, dec, flip, sub, chw, t);
      if (err < best.err) {
        for (int c = 0; c < 3; ++c) best.b[c] = b[c];
        best.t = t;
        best.err = err;
      }
    }
  }
  *out = best;
}

// ---------------------------------------------------------------------------
// ETC2 planar (etc_pallas.py:_planar_candidate, _pack_planar)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dec_planar(int v, int bits) {
  return (float)(bits == 6 ? ((v << 2) | (v >> 4)) : ((v << 1) | (v >> 6)));
}

// chw * (px - clip(floor((x*(H-O) + y*(V-O) + 4*O + 2) / 4)))^2 at texel t.
__device__ __forceinline__ float planar_texel(const float (*px)[16], const float* chw, int c, int t,
                                              float dov, float dhv, float dvv) {
  const float val = (float)(t & 3) * (dhv - dov) + (float)(t >> 2) * (dvv - dov) + 4.0f * dov + 2.0f;
  const float d = clampf(floorf(val * 0.25f), 0.0f, 255.0f);
  return chw[c] * sq(px[c][t] - d);
}

__device__ __forceinline__ float planar_chan(const float (*px)[16], const float* chw, int c,
                                             int o, int h, int v, int bits) {
  const float dov = dec_planar(o, bits), dhv = dec_planar(h, bits), dvv = dec_planar(v, bits);
  float acc = 0.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t) acc = acc + planar_texel(px, chw, c, t, dov, dhv, dvv);
  return acc;
}

__device__ __noinline__ float planar(const float (*px)[16], const float* chw, int refine,
                                     uint32_t* words) {
  int q[3][3];  // [O/H/V][channel]
  for (int k = 0; k < 3; ++k) {
    for (int c = 0; c < 3; ++c) {
      float acc = c_planar_proj[k][0] * px[c][0];
#pragma unroll
      for (int i = 1; i < 16; ++i) acc = acc + c_planar_proj[k][i] * px[c][i];
      const int maxv = c == 1 ? 127 : 63;
      const float scale = c == 1 ? kQ127 : kQ63;
      q[k][c] = (int)clampf(rintf(acc * scale), 0.0f, (float)maxv);
    }
  }
  if (refine) {
    // The +-1 neighbourhood of each channel's (O, H, V), walked from the
    // current best: later steps start from an accepted one.
    for (int c = 0; c < 3; ++c) {
      const int bits = c == 1 ? 7 : 6, maxv = (1 << bits) - 1;
      float best_e = planar_chan(px, chw, c, q[0][c], q[1][c], q[2][c], bits);
      for (int s = 0; s < 27; ++s) {
        if (s == 13) continue;
        const int o = clampi(q[0][c] + s / 9 - 1, 0, maxv);
        const int h = clampi(q[1][c] + (s / 3) % 3 - 1, 0, maxv);
        const int v = clampi(q[2][c] + s % 3 - 1, 0, maxv);
        const float en = planar_chan(px, chw, c, o, h, v, bits);
        if (en < best_e) {
          q[0][c] = o;
          q[1][c] = h;
          q[2][c] = v;
          best_e = en;
        }
      }
    }
  }
  float dq[3][3];
  for (int k = 0; k < 3; ++k)
    for (int c = 0; c < 3; ++c) dq[k][c] = dec_planar(q[k][c], c == 1 ? 7 : 6);
  float err = 0.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    float e = planar_texel(px, chw, 0, t, dq[0][0], dq[1][0], dq[2][0]);
    e = e + planar_texel(px, chw, 1, t, dq[0][1], dq[1][1], dq[2][1]);
    e = e + planar_texel(px, chw, 2, t, dq[0][2], dq[1][2], dq[2][2]);
    err = err + e;
  }
  const uint32_t ro = q[0][0], go = q[0][1], bo = q[0][2];
  const uint32_t rh = q[1][0], gh = q[1][1], bh = q[1][2];
  const uint32_t rv = q[2][0], gv = q[2][1], bv = q[2][2];
  uint32_t hi = (ro << 25) | ((go >> 6) << 24) | ((go & 0x3Fu) << 17) | ((bo >> 5) << 16) |
                (((bo >> 3) & 0x3u) << 11) | ((bo & 0x7u) << 7) | ((rh >> 1) << 2) | (rh & 0x1u) |
                2u;
  const uint32_t lo = (gh << 25) | (bh << 19) | (rv << 13) | (gv << 6) | bv;
  // Overflow markers that select planar mode in the decoder.
  const bool need_a = ((bo >> 3) & 0x3u) + ((bo >> 1) & 0x3u) >= 4u;
  hi |= need_a ? (0x7u << 13) : (1u << 10);
  const int r1 = (int)((ro >> 2) & 0xFu);
  int dr = (int)(((ro & 0x3u) << 1) | (go >> 6));
  dr = dr >= 4 ? dr - 8 : dr;
  if (r1 + dr < 0) hi |= 1u << 31;
  const int g1 = (int)((go >> 2) & 0xFu);
  int dg = (int)(((go & 0x3u) << 1) | (bo >> 5));
  dg = dg >= 4 ? dg - 8 : dg;
  if (g1 + dg < 0) hi |= 1u << 23;
  words[0] = hi;
  words[1] = lo;
  return err;
}

// ---------------------------------------------------------------------------
// ETC2 T and H (etc_pallas.py:_pca_split_means, _etc2_t_candidate,
// _etc2_h_candidate, _pack_t, _pack_h)
// ---------------------------------------------------------------------------

// Principal-axis split of the block -> the means of the two halves.
__device__ __noinline__ void pca_split_means(const float (*px)[16], float* mp, float* mn) {
  float mean[3];
  for (int c = 0; c < 3; ++c) {
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < 16; ++t) acc = acc + px[c][t];
    mean[c] = acc / 16.0f;
  }
  float cov[3][3];
  for (int c = 0; c < 3; ++c) {
    for (int d = 0; d < 3; ++d) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < 16; ++t) acc = acc + (px[c][t] - mean[c]) * (px[d][t] - mean[d]);
      cov[c][d] = acc;
    }
  }
  // The first texel of largest norm starts the power iteration.
  float mx = 0.0f;
  int fidx = 0;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const float c0 = px[0][t] - mean[0], c1 = px[1][t] - mean[1], c2 = px[2][t] - mean[2];
    const float nrm = c0 * c0 + c1 * c1 + c2 * c2;
    if (t == 0 || nrm > mx) {
      mx = nrm;
      fidx = t;
    }
  }
  float v[3];
  for (int c = 0; c < 3; ++c) v[c] = px[c][fidx] - mean[c];
  const float n0 = sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  for (int c = 0; c < 3; ++c) v[c] = n0 > 1e-10f ? v[c] / (n0 + 1e-20f) : 1.0f;
  for (int it = 0; it < 3; ++it) {
    float nv[3];
    for (int c = 0; c < 3; ++c) nv[c] = cov[c][0] * v[0] + cov[c][1] * v[1] + cov[c][2] * v[2];
    const float nn = sqrtf(nv[0] * nv[0] + nv[1] * nv[1] + nv[2] * nv[2]);
    if (nn > 1e-10f)
      for (int c = 0; c < 3; ++c) v[c] = nv[c] / (nn + 1e-20f);
  }
  uint32_t split = 0u;
  float np = 0.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const float s = (px[0][t] - mean[0]) * v[0] + (px[1][t] - mean[1]) * v[1] +
                    (px[2][t] - mean[2]) * v[2];
    if (s > 0.0f) {
      split |= 1u << t;
      np = np + 1.0f;
    }
  }
  const float cp = np + 1e-6f, cn = (16.0f - np) + 1e-6f;
  for (int c = 0; c < 3; ++c) {
    float sp = 0.0f, sn = 0.0f;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      if ((split >> t) & 1u)
        sp = sp + px[c][t];
      else
        sn = sn + px[c][t];
    }
    mp[c] = sp / cp;
    mn[c] = sn / cn;
  }
}

__device__ __forceinline__ void quant444(const float* x, int (&q)[3]) {
  for (int c = 0; c < 3; ++c) q[c] = (int)clampf(rintf(x[c] * kQ15), 0.0f, 15.0f);
}

// Error and index bits of a 4-entry palette pal[k][c] (first minimum).
__device__ __forceinline__ float palette_err(const float (*px)[16], const float* chw,
                                             const float (&pal)[4][3], uint32_t& bits) {
  float err = 0.0f;
  bits = 0u;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    float be = 0.0f;
    int bk = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float e = chw[0] * sq(px[0][t] - pal[k][0]);
      e = e + chw[1] * sq(px[1][t] - pal[k][1]);
      e = e + chw[2] * sq(px[2][t] - pal[k][2]);
      if (k == 0 || e < be) {
        be = e;
        bk = k;
      }
    }
    err = err + be;
    bits |= index_bits(t, bk);
  }
  return err;
}

// T palette [C1, C2 + d, C2, C2 - d]; H palette [C1 + d, C1 - d, C2 + d,
// C2 - d]; colours expanded from 4 bits.
__device__ __forceinline__ float th_eval(const float (*px)[16], const float* chw, bool h,
                                         const int (&q1)[3], const int (&q2)[3], float dist,
                                         uint32_t& bits) {
  float pal[4][3];
  for (int c = 0; c < 3; ++c) {
    const float d1 = (float)expand4(q1[c]), d2 = (float)expand4(q2[c]);
    if (h) {
      pal[0][c] = clampf(d1 + dist, 0.0f, 255.0f);
      pal[1][c] = clampf(d1 - dist, 0.0f, 255.0f);
    } else {
      pal[0][c] = d1;
      pal[1][c] = clampf(d2 + dist, 0.0f, 255.0f);
    }
    pal[2][c] = h ? clampf(d2 + dist, 0.0f, 255.0f) : d2;
    pal[3][c] = clampf(d2 - dist, 0.0f, 255.0f);
  }
  return palette_err(px, chw, pal, bits);
}

struct ThCand {
  int q1[3], q2[3], didx;
  uint32_t bits;
  float err;
};

__device__ __forceinline__ void th_take(ThCand& best, const int (&q1)[3], const int (&q2)[3],
                                        int didx, uint32_t bits, float err) {
  for (int c = 0; c < 3; ++c) {
    best.q1[c] = q1[c];
    best.q2[c] = q2[c];
  }
  best.didx = didx;
  best.bits = bits;
  best.err = err;
}

__device__ __forceinline__ int packed444(const int (&q)[3]) { return (q[0] << 8) | (q[1] << 4) | q[2]; }

// H mode's colour order carries the distance's low bit: put the pair in
// the order that `want` asks for; ok = whether that order holds.
__device__ __forceinline__ bool canon(const int (&q1n)[3], const int (&q2n)[3], int want,
                                      int (&q1c)[3], int (&q2c)[3]) {
  const int p1 = packed444(q1n), p2 = packed444(q2n);
  const bool swap = (int)(p1 >= p2) != want;
  for (int c = 0; c < 3; ++c) {
    q1c[c] = swap ? q2n[c] : q1n[c];
    q2c[c] = swap ? q1n[c] : q2n[c];
  }
  const int p1c = swap ? p2 : p1, p2c = swap ? p1 : p2;
  return (int)(p1c >= p2c) == want;
}

__device__ __forceinline__ void nudge(const int (&q)[3], int c, int dd, int (&out)[3]) {
  for (int i = 0; i < 3; ++i) out[i] = i == c ? clampi(q[i] + dd, 0, 15) : q[i];
}

// T (h = false) or H (h = true) candidate; returns its error, words in
// `words` (hi, lo).
__device__ __noinline__ float th_mode(const float (*px)[16], const float* chw, const float* mp,
                                      const float* mn, bool h, int refine, uint32_t* words) {
  ThCand best;
  bool have = false;
  for (int order = 0; order < 2; ++order) {
    int q1[3], q2[3];
    quant444(order ? mn : mp, q1);
    quant444(order ? mp : mn, q2);
    const int ord_bit = packed444(q1) >= packed444(q2);
    for (int di = 0; di < 8; ++di) {
      uint32_t bits;
      float err = th_eval(px, chw, h, q1, q2, (float)c_dist[di], bits);
      if (h) err = err + ((di & 1) == ord_bit ? 0.0f : kBig);
      if (!have || err < best.err) th_take(best, q1, q2, di, bits, err);
      have = true;
    }
  }
  for (int pass = 0; pass < refine; ++pass) {
    // +-1 coordinate descent over the six colour coordinates with the
    // adjacent distance rungs tried per step, then a distance re-sweep.
    for (int which = 0; which < 2; ++which) {
      for (int c = 0; c < 3; ++c) {
        for (int dd = -1; dd <= 1; dd += 2) {
          int q1n[3], q2n[3];
          if (which == 0) {
            nudge(best.q1, c, dd, q1n);
            for (int i = 0; i < 3; ++i) q2n[i] = best.q2[i];
          } else {
            for (int i = 0; i < 3; ++i) q1n[i] = best.q1[i];
            nudge(best.q2, c, dd, q2n);
          }
          for (int dstep = -1; dstep <= 1; ++dstep) {
            const int didxn = clampi(best.didx + dstep, 0, 7);
            int q1c[3], q2c[3];
            bool ok = true;
            if (h) {
              ok = canon(q1n, q2n, didxn & 1, q1c, q2c);
            } else {
              for (int i = 0; i < 3; ++i) {
                q1c[i] = q1n[i];
                q2c[i] = q2n[i];
              }
            }
            uint32_t bits;
            float errn = th_eval(px, chw, h, q1c, q2c, (float)c_dist[didxn], bits);
            if (h) errn = errn + (ok ? 0.0f : kBig);
            if (errn < best.err) th_take(best, q1c, q2c, didxn, bits, errn);
          }
        }
      }
    }
    if (h) {
      ThCand f = best;
      for (int di = 0; di < 8; ++di) {
        int q1c[3], q2c[3];
        const bool ok = canon(best.q1, best.q2, di & 1, q1c, q2c);
        uint32_t bits;
        float errn = th_eval(px, chw, true, q1c, q2c, (float)c_dist[di], bits);
        errn = errn + (ok ? 0.0f : kBig);
        if (errn < f.err) th_take(f, q1c, q2c, di, bits, errn);
      }
      best = f;
    } else {
      for (int di = 0; di < 8; ++di) {
        uint32_t bits;
        const float errn = th_eval(px, chw, false, best.q1, best.q2, (float)c_dist[di], bits);
        if (errn < best.err) {
          best.didx = di;
          best.bits = bits;
          best.err = errn;
        }
      }
    }
  }
  const int r1 = best.q1[0], g1 = best.q1[1], b1 = best.q1[2];
  const uint32_t d = (uint32_t)best.didx;
  uint32_t hi;
  if (!h) {
    const uint32_t r32 = (uint32_t)r1 >> 2, r10 = (uint32_t)r1 & 0x3u;
    hi = (r32 << 27) | (r10 << 24) | ((uint32_t)g1 << 20) | ((uint32_t)b1 << 16) |
         ((uint32_t)best.q2[0] << 12) | ((uint32_t)best.q2[1] << 8) | ((uint32_t)best.q2[2] << 4) |
         ((d >> 1) << 2) | (d & 1u) | 2u;
    hi |= (r32 + r10) >= 4u ? (0x7u << 29) : (1u << 26);
  } else {
    const int q = 2 * (g1 & 1) + (b1 >> 3), b21 = (b1 >> 1) & 0x3;
    hi = ((uint32_t)r1 << 27) | ((uint32_t)(g1 >> 1) << 24) | ((uint32_t)(g1 & 1) << 20) |
         ((uint32_t)(b1 >> 3) << 19) | ((uint32_t)((b1 >> 1) & 0x3) << 16) |
         ((uint32_t)(b1 & 0x1) << 15) | ((uint32_t)best.q2[0] << 11) |
         ((uint32_t)best.q2[1] << 7) | ((uint32_t)best.q2[2] << 3) | ((d >> 2) << 2) |
         ((d >> 1) & 1u) | 2u;
    hi |= (q + b21) >= 4 ? (7u << 21) : (1u << 18);
    int dr = g1 >> 1;
    dr = dr >= 4 ? dr - 8 : dr;
    if (r1 + dr < 0) hi |= 1u << 31;
  }
  words[0] = hi;
  words[1] = best.bits;
  return best.err;
}

// ---------------------------------------------------------------------------
// The ETC RGB sweep (etc_pallas.py:_rgb_words)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t etc1_hi(const int (&f1)[3], const int (&f2)[3], bool diff,
                                            int flip, int t1, int t2) {
  uint32_t hi = 0u;
  for (int c = 0; c < 3; ++c) {
    if (diff) {
      hi |= (uint32_t)f1[c] << (27 - 8 * c);
      hi |= ((uint32_t)f2[c] & 0x7u) << (24 - 8 * c);
    } else {
      hi |= (uint32_t)f1[c] << (28 - 8 * c);
      hi |= (uint32_t)f2[c] << (24 - 8 * c);
    }
  }
  hi |= ((uint32_t)t1 << 5) | ((uint32_t)t2 << 2);
  if (diff) hi |= 2u;
  if (flip) hi |= 1u;
  return hi;
}

__device__ __forceinline__ void offer(float err, uint32_t hi, uint32_t lo, bool& have,
                                      float& best_err, uint32_t* words) {
  if (!have || err < best_err) {
    best_err = err;
    words[0] = hi;
    words[1] = lo;
  }
  have = true;
}

// The un-swapped (hi, lo) words of the best ETC1 (or ETC2) encoding.
__device__ __noinline__ void rgb_words(const float (*px)[16], const float* chw, int quality,
                                       bool etc2, uint32_t* words) {
  bool have = false;
  float best_err = 0.0f;
  for (int flip = 0; flip < 2; ++flip) {
    float mean1[3], mean2[3];
    for (int c = 0; c < 3; ++c) {
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        if (member(t, flip, 0))
          s1 = s1 + px[c][t];
        else
          s2 = s2 + px[c][t];
      }
      mean1[c] = s1 / 8.0f;
      mean2[c] = s2 / 8.0f;
    }
    DiffFit df;
    diff_fit(px, chw, flip, mean1, mean2, quality, &df);
    {
      int b2[3];
      float dec1[3], dec2[3];
      for (int c = 0; c < 3; ++c) b2[c] = df.b1[c] + df.d[c];
      dec_of(df.b1, true, dec1);
      dec_of(b2, true, dec2);
      const uint32_t lo = table_bits(px, dec1, flip, 0, chw, df.t1) |
                          table_bits(px, dec2, flip, 1, chw, df.t2);
      offer(df.err, etc1_hi(df.b1, df.d, true, flip, df.t1, df.t2), lo, have, best_err, words);
    }
    if (quality >= 1) {
      SubFit i1, i2;
      ind_subfit(px, chw, flip, 0, mean1, quality, &i1);
      ind_subfit(px, chw, flip, 1, mean2, quality, &i2);
      float dec1[3], dec2[3];
      dec_of(i1.b, false, dec1);
      dec_of(i2.b, false, dec2);
      const uint32_t lo = table_bits(px, dec1, flip, 0, chw, i1.t) |
                          table_bits(px, dec2, flip, 1, chw, i2.t);
      offer(i1.err + i2.err, etc1_hi(i1.b, i2.b, false, flip, i1.t, i2.t), lo, have, best_err,
            words);
    }
  }
  if (etc2) {
    const int refine = quality >= 4 ? 2 : 0;
    uint32_t w[2];
    float err = planar(px, chw, refine, w);
    offer(err, w[0], w[1], have, best_err, words);
    float mp[3], mn[3];
    pca_split_means(px, mp, mn);
    err = th_mode(px, chw, mp, mn, false, refine, w);
    offer(err, w[0], w[1], have, best_err, words);
    err = th_mode(px, chw, mp, mn, true, refine, w);
    offer(err, w[0], w[1], have, best_err, words);
  }
}

// ---------------------------------------------------------------------------
// EAC (etc_pallas.py:_eac_alpha, _eac_r11)
// ---------------------------------------------------------------------------

// EAC block of 16 values in the search domain.  R11: values and palette in
// the /8 domain, palette clip(base8 + mod * mult * 8, lo, hi) / 8 with base8
// = base * 8 + offset; alpha: clip(base + mod * mult, 0, 255).
struct EacDomain {
  bool r11;
  float base_v;  // base (alpha) or base * 8 + offset (R11)
  float lo, hi;  // palette clip
};

__device__ __forceinline__ float eac_pal(const EacDomain& dm, float mod, float mult) {
  if (dm.r11) return clampf(dm.base_v + mod * mult * 8.0f, dm.lo, dm.hi) / 8.0f;
  return clampf(dm.base_v + mod * mult, dm.lo, dm.hi);
}

// The table x multiplier search around the range fit; returns the 64-bit
// block's (hi, lo) words before the byte swap, base byte given.
__device__ __noinline__ void eac_block(const float* v, int quality, uint32_t base_byte,
                                       float span, EacDomain dm, uint32_t* words) {
  const int ncand = c_eac_ncand[quality];
  int best_t = 0, best_mult = 1;
  float best_err = 0.0f;
  for (int tb = 0; tb < 16; ++tb) {
    const float inv = 1.0f / (float)c_eac_mods[tb][7];
    const int m0 = (int)clampf(rintf(span * inv), 1.0f, 15.0f);
    for (int dmul = -(ncand / 2); dmul < ncand - ncand / 2; ++dmul) {
      const int mult = clampi(m0 + dmul, 1, 15);
      float pal[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) pal[k] = eac_pal(dm, (float)c_eac_mods[tb][k], (float)mult);
      float err = 0.0f;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        float e = sq(v[t] - pal[0]);
#pragma unroll
        for (int k = 1; k < 8; ++k) e = fminf(e, sq(v[t] - pal[k]));
        err = err + e;
      }
      if ((tb == 0 && dmul == -(ncand / 2)) || err < best_err) {
        best_err = err;
        best_t = tb;
        best_mult = mult;
      }
    }
  }
  float pal[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) pal[k] = eac_pal(dm, (float)c_eac_mods[best_t][k], (float)best_mult);
  uint32_t hi = (base_byte << 24) | ((uint32_t)best_mult << 20) | ((uint32_t)best_t << 16);
  uint32_t lo = 0u;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    float be = sq(v[t] - pal[0]);
    uint32_t bk = 0u;
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      const float e = sq(v[t] - pal[k]);
      if (e < be) {
        be = e;
        bk = (uint32_t)k;
      }
    }
    // Pixel p's index sits at bits 45-3p..47-3p of the 64-bit block; the
    // one at bit 30 straddles the two words.
    const int bitpos = 45 - 3 * colmajor(t);
    if (bitpos >= 32) {
      hi |= bk << (bitpos - 32);
    } else {
      lo |= bk << bitpos;
      if (bitpos > 29) hi |= bk >> (32 - bitpos);
    }
  }
  words[0] = hi;
  words[1] = lo;
}

// a[16] alpha in 0..255.
__device__ __forceinline__ void eac_alpha(const float* a, int quality, uint32_t* words) {
  float lo = a[0], hi = a[0];
  for (int t = 1; t < 16; ++t) {
    lo = fminf(lo, a[t]);
    hi = fmaxf(hi, a[t]);
  }
  const int base = (int)clampf(rintf((lo + hi) * 0.5f), 0.0f, 255.0f);
  const EacDomain dm = {false, (float)base, 0.0f, 255.0f};
  eac_block(a, quality, (uint32_t)base, (hi - lo) * 0.5f, dm, words);
}

// v[16] in the true 11-bit domain (0..2047, or -1023..1023 signed); the
// search runs in the /8 domain (v8 = v / 8).
__device__ __forceinline__ void eac_r11(const float* v, int quality, bool is_signed,
                                        uint32_t* words) {
  float v8[16];
  for (int t = 0; t < 16; ++t) v8[t] = v[t] / 8.0f;
  float lo = v8[0], hi = v8[0];
  for (int t = 1; t < 16; ++t) {
    lo = fminf(lo, v8[t]);
    hi = fmaxf(hi, v8[t]);
  }
  const float blo = is_signed ? -127.0f : 0.0f, bhi = is_signed ? 127.0f : 255.0f;
  const int base = (int)clampf(rintf((lo + hi) * 0.5f), blo, bhi);
  const EacDomain dm = {true, (float)base * 8.0f + (is_signed ? 0.0f : 4.0f),
                        is_signed ? -1023.0f : 0.0f, is_signed ? 1023.0f : 2047.0f};
  eac_block(v8, quality, (uint32_t)base & 0xFFu, (hi - lo) * 0.5f, dm, words);
}

#ifdef __CUDACC__

// blocks: [n,16,nch] float32 (nch >= 3) -> [n] uint2 ETC1/ETC2 RGB words.
__global__ void __launch_bounds__(kThreads)
    etc_rgb_kernel(const float* __restrict__ blocks, uint2* __restrict__ out, int n, int nch,
                   int quality, int etc2, Chw chw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* src = blocks + (size_t)i * 16 * nch;
  float px[3][16];
#pragma unroll
  for (int t = 0; t < 16; ++t)
#pragma unroll
    for (int c = 0; c < 3; ++c) px[c][t] = clampf(src[t * nch + c], 0.0f, 1.0f) * 255.0f;
  uint32_t w[2];
  rgb_words(px, chw.w, quality, etc2 != 0, w);
  out[i] = make_uint2(bswap(w[0]), bswap(w[1]));
}

// blocks: [n,16,4] float32 -> [n] uint4: EAC alpha words, then ETC2 RGB.
__global__ void __launch_bounds__(kThreads)
    etc2_rgba_kernel(const float4* __restrict__ blocks, uint4* __restrict__ out, int n,
                     int quality, Chw chw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float4* src = blocks + (size_t)i * 16;
  float px[3][16], a[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const float4 q = src[t];
    px[0][t] = clampf(q.x, 0.0f, 1.0f) * 255.0f;
    px[1][t] = clampf(q.y, 0.0f, 1.0f) * 255.0f;
    px[2][t] = clampf(q.z, 0.0f, 1.0f) * 255.0f;
    a[t] = clampf(q.w, 0.0f, 1.0f) * 255.0f;
  }
  uint32_t aw[2], cw[2];
  eac_alpha(a, quality, aw);
  rgb_words(px, chw.w, quality, true, cw);
  out[i] = make_uint4(bswap(aw[0]), bswap(aw[1]), bswap(cw[0]), bswap(cw[1]));
}

__device__ __forceinline__ void load16(const float4* src, float lo, float hi, float scale,
                                       float (&v)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 q = src[j];
    v[4 * j] = clampf(q.x, lo, hi) * scale;
    v[4 * j + 1] = clampf(q.y, lo, hi) * scale;
    v[4 * j + 2] = clampf(q.z, lo, hi) * scale;
    v[4 * j + 3] = clampf(q.w, lo, hi) * scale;
  }
}

// vals: [n,16] float32 in 0..1 -> [n] uint2 EAC alpha words.
__global__ void __launch_bounds__(kThreads)
    eac_alpha_kernel(const float4* __restrict__ vals, uint2* __restrict__ out, int n,
                     int quality) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a[16];
  load16(vals + (size_t)i * 4, 0.0f, 1.0f, 255.0f, a);
  uint32_t w[2];
  eac_alpha(a, quality, w);
  out[i] = make_uint2(bswap(w[0]), bswap(w[1]));
}

// vals: [n,16] float32 in [0,1] ([-1,1] signed) -> [n] uint2 R11 words.
__global__ void __launch_bounds__(kThreads)
    eac_r11_kernel(const float4* __restrict__ vals, uint2* __restrict__ out, int n, int quality,
                   int is_signed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v[16];
  load16(vals + (size_t)i * 4, is_signed ? -1.0f : 0.0f, 1.0f, is_signed ? 1023.0f : 2047.0f, v);
  uint32_t w[2];
  eac_r11(v, quality, is_signed != 0, w);
  out[i] = make_uint2(bswap(w[0]), bswap(w[1]));
}

// blocks: [n,16,nch] float32 (nch >= 2) -> [n] uint4: R11 words, G11 words.
__global__ void __launch_bounds__(kThreads)
    eac_rg11_kernel(const float* __restrict__ blocks, uint4* __restrict__ out, int n, int nch,
                    int quality, int is_signed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* src = blocks + (size_t)i * 16 * nch;
  const float lo = is_signed ? -1.0f : 0.0f, scale = is_signed ? 1023.0f : 2047.0f;
  float r[16], g[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    r[t] = clampf(src[t * nch], lo, 1.0f) * scale;
    g[t] = clampf(src[t * nch + 1], lo, 1.0f) * scale;
  }
  uint32_t rw[2], gw[2];
  eac_r11(r, quality, is_signed != 0, rw);
  eac_r11(g, quality, is_signed != 0, gw);
  out[i] = make_uint4(bswap(rw[0]), bswap(rw[1]), bswap(gw[0]), bswap(gw[1]));
}

inline dim3 grid_for(int n) { return dim3((n + kThreads - 1) / kThreads); }

#endif  // __CUDACC__

}  // namespace etcx

#ifdef __CUDACC__

// Each launcher launches on `stream` and returns cudaGetLastError() (the
// launch is not synchronised); quality is 0-4.

// blocks: [n,16,nch] float32, nch >= 3; out: [n,2] uint32.
extern "C" int etc_rgb_encode_launch(const void* blocks, void* out, int n, int nch, int quality,
                                     int etc2, float w0, float w1, float w2, void* stream) {
  if (n <= 0) return 0;
  if (nch < 3 || quality < 0 || quality > 4) return (int)cudaErrorInvalidValue;
  const etcx::Chw chw = {{w0, w1, w2}};
  etcx::etc_rgb_kernel<<<etcx::grid_for(n), etcx::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)blocks, (uint2*)out, n, nch, quality, etc2, chw);
  return (int)cudaGetLastError();
}

// blocks: [n,16,4] float32; out: [n,4] uint32 (2 alpha words, 2 colour words).
extern "C" int etc2_rgba_encode_launch(const void* blocks, void* out, int n, int quality,
                                       float w0, float w1, float w2, void* stream) {
  if (n <= 0) return 0;
  if (quality < 0 || quality > 4) return (int)cudaErrorInvalidValue;
  const etcx::Chw chw = {{w0, w1, w2}};
  etcx::etc2_rgba_kernel<<<etcx::grid_for(n), etcx::kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)blocks, (uint4*)out, n, quality, chw);
  return (int)cudaGetLastError();
}

// vals: [n,16] float32; out: [n,2] uint32.
extern "C" int eac_alpha_encode_launch(const void* vals, void* out, int n, int quality,
                                       void* stream) {
  if (n <= 0) return 0;
  if (quality < 0 || quality > 4) return (int)cudaErrorInvalidValue;
  etcx::eac_alpha_kernel<<<etcx::grid_for(n), etcx::kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)vals, (uint2*)out, n, quality);
  return (int)cudaGetLastError();
}

// vals: [n,16] float32; out: [n,2] uint32.
extern "C" int eac_r11_encode_launch(const void* vals, void* out, int n, int quality,
                                     int is_signed, void* stream) {
  if (n <= 0) return 0;
  if (quality < 0 || quality > 4) return (int)cudaErrorInvalidValue;
  etcx::eac_r11_kernel<<<etcx::grid_for(n), etcx::kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)vals, (uint2*)out, n, quality, is_signed);
  return (int)cudaGetLastError();
}

// blocks: [n,16,nch] float32, nch >= 2; out: [n,4] uint32 (red words, green words).
extern "C" int eac_rg11_encode_launch(const void* blocks, void* out, int n, int nch, int quality,
                                      int is_signed, void* stream) {
  if (n <= 0) return 0;
  if (nch < 2 || quality < 0 || quality > 4) return (int)cudaErrorInvalidValue;
  etcx::eac_rg11_kernel<<<etcx::grid_for(n), etcx::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)blocks, (uint4*)out, n, nch, quality, is_signed);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
