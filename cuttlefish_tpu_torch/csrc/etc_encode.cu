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
// Design.  One thread per 4x4 block, 128 blocks per CTA, grid = ceil(N /
// 128); the TPU kernels put 256-512 blocks on vector lanes, here each
// thread runs its block's sweep alone (RG11: a thread per block and
// channel, 256 a CTA).  Every entry first stages its CTA's blocks in shared
// memory with one coalesced copy (16-byte loads by neighbouring threads),
// clamped and scaled there (R11 in its /8 domain), laid out
// [channel][texel][block] with the block index fastest and rows padded to
// 129, so that a warp's 32 reads of one texel hit 32 banks (RGB and RGBA
// 33 KB a CTA, R11 and alpha 8 KB, RG11 16 KB).  No texel array lives in a
// thread's local frame: in the RGB and RGBA entries each candidate family
// (a sub-block's table fit, the differential and individual searches,
// planar, T and H, RGBA's alpha) is its own non-inlined function that reads
// the texels it needs from shared memory into registers.  Every palette
// entry (a clamped base + modifier) is made once per candidate, not per
// texel; a table fit runs its 8 tables over the 8 member texels held in registers;
// the offset estimates keep a sorted top-8 in registers instead of an array
// of estimates; per-thread table indices (the winner's modifiers, T/H
// distances) are selects over compile-time reads of the constant tables.
// T and H evaluate errors alone along their refinement chains and make the
// winner's indices once.  Each step of those chains, and of planar's
// per-channel walks, starts from the step before, so the independent T and
// H chains, and planar's three channels, run side by side to give the card
// two or three chains to overlap.  The EAC search (eac_block) takes a
// texel's error against a palette as one square of its least distance to
// five of the eight entries, made from a float table, and in the EAC
// entries skips repeated multipliers and leaves a candidate once its
// partial error reaches the best.  With unit channel weights, the default
// of a linear texture, a second instance skips the products by 1, which
// are exact.  Quality is a run-time argument: q2 and q3 are one algorithm.
//
// What bounds it: float instruction throughput.  A block reads 192-256
// bytes and writes 8 or 16, but an ETC2 block at quality 2 evaluates some
// 600 palettes of 8 or 16 texels, and at quality 4 some 1,200 more in the
// planar and T/H refinements; --fmad=false makes every add and multiply an
// instruction of its own.  The ETC1 fits, most of the work, are unrolled
// loops of independent texel errors; the T/H refinements are chains.
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
// reference does.  EAC's multiplier seed is span * (float32(1) /
// max_pos[t]), the product XLA makes of the reference's division by a
// constant.  The sorted top-8 picks what the reference's repeated pick of
// the least unchosen estimate picks while every estimate is below the 1e30
// it gives chosen ones (channel weights below 1e23).
//
// The device functions are plain C++: the __global__ kernels and the
// launchers need nvcc and sit under __CUDACC__; a CPU build runs each CTA's
// staging and then its threads one after another (etc_rgb_cpu,
// etc2_rgba_cpu, eac_alpha_cpu, eac_r11_cpu, eac_rg11_cpu).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <math.h>
#include <stdint.h>

namespace etcx {

#ifndef __CUDACC__
struct float4 {
  float x, y, z, w;
};
#endif

constexpr int kThreads = 128;
// A shared-memory row holds one texel value of each of a CTA's blocks,
// padded by one so that a staging warp's two blocks fall on other banks.
constexpr int kStride = kThreads + 1;
constexpr float kBig = 1e30f;
// Quantiser scales: the Python doubles m / 255.0 rounded once to float32.
constexpr float kQ15 = (float)(15.0 / 255.0);
constexpr float kQ31 = (float)(31.0 / 255.0);
constexpr float kQ63 = (float)(63.0 / 255.0);
constexpr float kQ127 = (float)(127.0 / 255.0);

// ETC1 intensity modifiers [table][index] (etc.py:_ETC1_MODS_NP).
__constant__ int c_etc1_mods[8][4] = {
    {2, 8, -2, -8},     {5, 17, -5, -17},   {9, 29, -9, -29},    {13, 42, -13, -42},
    {18, 60, -18, -60}, {24, 80, -24, -80}, {33, 106, -33, -106}, {47, 183, -47, -183},
};
// EAC modifiers [table][index] (etc.py:_EAC_MODS_NP) as floats: the
// palette's mod * mult (alpha) and mod * (mult * 8) (R11) are small
// integers, as exact as the reference's mod * mult * 8.  Each half is
// ordered by magnitude.
__constant__ float c_eac_mods[16][8] = {
    {-3, -6, -9, -15, 2, 5, 8, 14}, {-3, -7, -10, -13, 2, 6, 9, 12},
    {-2, -5, -8, -13, 1, 4, 7, 12}, {-2, -4, -6, -13, 1, 3, 5, 12},
    {-3, -6, -8, -12, 2, 5, 7, 11}, {-3, -7, -9, -11, 2, 6, 8, 10},
    {-4, -7, -8, -11, 3, 6, 7, 10}, {-3, -5, -8, -11, 2, 4, 7, 10},
    {-2, -6, -8, -10, 1, 5, 7, 9},  {-2, -5, -8, -10, 1, 4, 7, 9},
    {-2, -4, -8, -10, 1, 3, 7, 9},  {-2, -5, -7, -10, 1, 4, 6, 9},
    {-3, -4, -7, -10, 2, 3, 6, 9},  {-1, -2, -3, -10, 0, 1, 2, 9},
    {-4, -6, -8, -9, 3, 5, 7, 8},   {-3, -5, -7, -9, 2, 4, 6, 8},
};
// float32(1) / each table's largest positive modifier, column 7 above
// (etc.py:_EAC_INV_MAX_POS): the multiplier seed's factor.
__constant__ float c_eac_inv[16] = {
    1.0f / 14, 1.0f / 12, 1.0f / 12, 1.0f / 12, 1.0f / 11, 1.0f / 10, 1.0f / 10, 1.0f / 10,
    1.0f / 9,  1.0f / 9,  1.0f / 9,  1.0f / 9,  1.0f / 9,  1.0f / 9,  1.0f / 8,  1.0f / 8,
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

// A CTA's texels, [channel][texel][block] (RGB, then alpha for RGBA).
__shared__ float s_px[64 * kStride];

struct Chw {
  float w[3];
};

// Texel (c, t) of thread `tid`'s block.
struct Px {
  int tid;
  __device__ __forceinline__ float operator()(int c, int t) const {
    return s_px[(16 * c + t) * kStride + tid];
  }
};

// One channel of a block's texels, indexed by texel.
struct PxChan {
  Px px;
  int c;
  __device__ __forceinline__ float operator[](int t) const { return px(c, t); }
};

// Three channel values: a mean or a decoded colour.
struct Rgb {
  float v[3];
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int mini(int a, int b) { return a < b ? a : b; }

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

// The j-th member (raster order) of sub-block `sub` of flip `flip`.
__device__ __forceinline__ int member_texel(int flip, int sub, int j) {
  return flip ? 8 * sub + j : 4 * (j >> 1) + (j & 1) + 2 * sub;
}

// A 2-bit index m of raster texel t in an ETC index word: bit p = its lsb,
// bit 16 + p = its msb, p = the column-major pixel number.
__device__ __forceinline__ uint32_t index_bits(int t, int m) {
  const int p = colmajor(t);
  return ((uint32_t)(m & 1) << p) | ((uint32_t)(m >> 1) << (16 + p));
}

// c_etc1_mods[tb][m] and c_dist[di] for an index that differs between
// threads: selects over compile-time reads, so that no warp reads the
// constant bank at several addresses.
__device__ __forceinline__ float etc1_mod(int tb, int m) {
  int v = c_etc1_mods[0][m];
#pragma unroll
  for (int k = 1; k < 8; ++k) v = tb == k ? c_etc1_mods[k][m] : v;
  return (float)v;
}

__device__ __forceinline__ float dist_of(int di) {
  int v = c_dist[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) v = di == k ? c_dist[k] : v;
  return (float)v;
}

// w_c * x for channel c; with unit weights (UW) the product by 1 is exact
// and skipped.
template <bool UW>
__device__ __forceinline__ float wmul(const Chw& w, int c, float x) {
  return UW ? x : w.w[c] * x;
}

// sum_c w_c * d_c^2, channels in order.
template <bool UW>
__device__ __forceinline__ float err3(const Chw& w, float d0, float d1, float d2) {
  float e = wmul<UW>(w, 0, sq(d0));
  e = e + wmul<UW>(w, 1, sq(d1));
  e = e + wmul<UW>(w, 2, sq(d2));
  return e;
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

// The 8 members of one sub-block, in raster order.
struct Sub {
  float x[3][8];
};

__device__ __forceinline__ void load_sub(const Px& px, int flip, int sub, Sub& s) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int t = member_texel(flip, sub, j);
#pragma unroll
    for (int c = 0; c < 3; ++c) s.x[c][j] = px(c, t);
  }
}

__device__ __forceinline__ void dec_of(const int (&b)[3], bool five, float (&dec)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) dec[c] = (float)(five ? expand5(b[c]) : expand4(b[c]));
}

// Palette entry clip(dec + mod, 0, 255) per channel.
__device__ __forceinline__ void entry(const float (&dec)[3], float mod, float (&p)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) p[c] = clampf(dec[c] + mod, 0.0f, 255.0f);
}

// Sum over the members of each one's least error against K palette
// entries p[k] (the first minimum's value).
template <bool UW, int K>
__device__ __forceinline__ float nearest_sum(const Sub& s, const Chw& w, const float (&p)[K][3]) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float e = err3<UW>(w, s.x[0][j] - p[0][0], s.x[1][j] - p[0][1], s.x[2][j] - p[0][2]);
#pragma unroll
    for (int k = 1; k < K; ++k)
      e = fminf(e, err3<UW>(w, s.x[0][j] - p[k][0], s.x[1][j] - p[k][1], s.x[2][j] - p[k][2]));
    acc = acc + e;
  }
  return acc;
}

// A sub-block's exhaustive table fit: the first table of least error, its
// error, and the runner-up (_best_table_fit2: the first least error with
// the best table at 1e30).
struct TableFit {
  int best, second;
  float err;
};

template <bool UW>
__device__ __noinline__ TableFit table_fit(Px px, int flip, int sub, Rgb dec, Chw w) {
  Sub s;
  load_sub(px, flip, sub, s);
  float err[8];
#pragma unroll
  for (int tb = 0; tb < 8; ++tb) {
    float p[4][3];
#pragma unroll
    for (int m = 0; m < 4; ++m) entry(dec.v, (float)c_etc1_mods[tb][m], p[m]);
    err[tb] = nearest_sum<UW, 4>(s, w, p);
  }
  TableFit f;
  f.best = 0;
  f.err = err[0];
#pragma unroll
  for (int tb = 1; tb < 8; ++tb) {
    if (err[tb] < f.err) {
      f.err = err[tb];
      f.best = tb;
    }
  }
  f.second = 0;
  float e2 = f.best == 0 ? kBig : err[0];
#pragma unroll
  for (int tb = 1; tb < 8; ++tb) {
    const float ee = tb == f.best ? kBig : err[tb];
    if (ee < e2) {
      e2 = ee;
      f.second = tb;
    }
  }
  return f;
}

// The index bits of one sub-block's members under `table` (first minimum).
template <bool UW>
__device__ __noinline__ uint32_t table_bits(Px px, int flip, int sub, Rgb dec, Chw w, int table) {
  float p[4][3];
#pragma unroll
  for (int m = 0; m < 4; ++m) entry(dec.v, etc1_mod(table, m), p[m]);
  uint32_t bits = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int t = member_texel(flip, sub, j);
    const float x0 = px(0, t), x1 = px(1, t), x2 = px(2, t);
    float be = err3<UW>(w, x0 - p[0][0], x1 - p[0][1], x2 - p[0][2]);
    int bm = 0;
#pragma unroll
    for (int m = 1; m < 4; ++m) {
      const float e = err3<UW>(w, x0 - p[m][0], x1 - p[m][1], x2 - p[m][2]);
      if (e < be) {
        be = e;
        bm = m;
      }
    }
    bits |= index_bits(t, bm);
  }
  return bits;
}

// The restricted modifier set of the estimates (_table_modvals of the
// centre's best table, then of its runner-up).
__device__ __forceinline__ void modvals(const TableFit& f, float (&mv)[8]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    mv[m] = etc1_mod(f.best, m);
    mv[4 + m] = etc1_mod(f.second, m);
  }
}

// Block error with the table restricted to the 8 values mv, index free.
template <bool UW>
__device__ __forceinline__ float restricted_err(const Sub& s, const float (&dec)[3], const Chw& w,
                                                const float (&mv)[8]) {
  float p[8][3];
#pragma unroll
  for (int k = 0; k < 8; ++k) entry(dec, mv[k], p[k]);
  return nearest_sum<UW, 8>(s, w, p);
}

// The kMaxKeep least estimates so far, ascending, ties in offset order:
// the order in which the reference's repeated pick of the least unchosen
// estimate (first index on ties) takes them.
constexpr int kMaxKeep = 8;

struct TopK {
  float v[kMaxKeep];
  int j[kMaxKeep];
};

__device__ __forceinline__ void topk_init(TopK& k) {
#pragma unroll
  for (int r = 0; r < kMaxKeep; ++r) {
    k.v[r] = INFINITY;
    k.j[r] = 0;
  }
}

// Insert estimate `est` of offset j (offsets arrive in increasing j).
__device__ __forceinline__ void topk_insert(TopK& k, float est, int j) {
#pragma unroll
  for (int r = kMaxKeep - 1; r >= 0; --r) {
    if (est < k.v[r]) {
      if (r > 0 && est < k.v[r - 1]) {
        k.v[r] = k.v[r - 1];
        k.j[r] = k.j[r - 1];
      } else {
        k.v[r] = est;
        k.j[r] = j;
      }
    }
  }
}

// The r-th pick.
__device__ __forceinline__ int topk_at(const TopK& k, int r) {
  int j = k.j[0];
#pragma unroll
  for (int i = 1; i < kMaxKeep; ++i) j = r == i ? k.j[i] : j;
  return j;
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

// Base 1 of offset i (clipped to 5 bits) and the clipped delta to sub-block
// 2's rounded mean; dec1, dec2 their decoded colours.
__device__ __forceinline__ void diff_bases(const float (&base1_q)[3], const int (&b2n)[3], int i,
                                           int (&b1)[3], int (&d)[3], Rgb& dec1, Rgb& dec2) {
  int b2[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    b1[c] = (int)clampf(base1_q[c] + (float)offset_of(i, c), 0.0f, 31.0f);
    d[c] = clampi(b2n[c] - b1[c], -4, 3);
    b2[c] = b1[c] + d[c];
  }
  dec_of(b1, true, dec1.v);
  dec_of(b2, true, dec2.v);
}

// Differential mode, both sub-blocks at once: base 1 from the offset, base
// 2 = base 1 + the clipped delta to sub-block 2's rounded mean.
template <bool UW>
__device__ __noinline__ void diff_fit(Px px, Chw w, int flip, Rgb mean1, Rgb mean2, int quality,
                                      DiffFit* out) {
  float base1_q[3];
  int b2n[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    base1_q[c] = rintf(mean1.v[c] * kQ31);
    b2n[c] = (int)clampf(rintf(mean2.v[c] * kQ31), 0.0f, 31.0f);
  }
  DiffFit best;
  int b1[3], d[3];
  Rgb dec1, dec2;
  diff_bases(base1_q, b2n, 13, b1, d, dec1, dec2);  // the centre (0, 0, 0)
  const TableFit f1 = table_fit<UW>(px, flip, 0, dec1, w);
  const TableFit f2 = table_fit<UW>(px, flip, 1, dec2, w);
  best.err = f1.err + f2.err;
  best.t1 = f1.best;
  best.t2 = f2.best;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    best.b1[c] = b1[c];
    best.d[c] = d[c];
  }
  const int keep = est_keep(quality);
  if (keep > 0) {
    float mv1[8], mv2[8];
    modvals(f1, mv1);
    modvals(f2, mv2);
    Sub s1, s2;
    load_sub(px, flip, 0, s1);
    load_sub(px, flip, 1, s2);
    TopK top;
    topk_init(top);
    const int n = n_offsets(quality) - 1;
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      diff_bases(base1_q, b2n, other_offset(j), b1, d, dec1, dec2);
      const float e1 = restricted_err<UW>(s1, dec1.v, w, mv1);
      topk_insert(top, e1 + restricted_err<UW>(s2, dec2.v, w, mv2), j);
    }
#pragma unroll 1
    for (int r = 0; r < keep; ++r) {
      diff_bases(base1_q, b2n, other_offset(topk_at(top, r)), b1, d, dec1, dec2);
      const TableFit g1 = table_fit<UW>(px, flip, 0, dec1, w);
      const TableFit g2 = table_fit<UW>(px, flip, 1, dec2, w);
      const float err = g1.err + g2.err;
      if (err < best.err) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          best.b1[c] = b1[c];
          best.d[c] = d[c];
        }
        best.t1 = g1.best;
        best.t2 = g2.best;
        best.err = err;
      }
    }
  }
  *out = best;
}

// The 4-bit base of offset i and its decoded colour.
__device__ __forceinline__ void ind_base(const float (&base_q)[3], int i, int (&b)[3], Rgb& dec) {
#pragma unroll
  for (int c = 0; c < 3; ++c) b[c] = (int)clampf(base_q[c] + (float)offset_of(i, c), 0.0f, 15.0f);
  dec_of(b, false, dec.v);
}

// Individual mode, one sub-block: a 4-bit base from the offset.
template <bool UW>
__device__ __noinline__ void ind_subfit(Px px, Chw w, int flip, int sub, Rgb mean, int quality,
                                        SubFit* out) {
  float base_q[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) base_q[c] = rintf(mean.v[c] * kQ15);
  SubFit best;
  int b[3];
  Rgb dec;
  ind_base(base_q, 13, b, dec);
  const TableFit f = table_fit<UW>(px, flip, sub, dec, w);
  best.err = f.err;
  best.t = f.best;
#pragma unroll
  for (int c = 0; c < 3; ++c) best.b[c] = b[c];
  const int keep = est_keep(quality);
  if (keep > 0) {
    float mv[8];
    modvals(f, mv);
    Sub s;
    load_sub(px, flip, sub, s);
    TopK top;
    topk_init(top);
    const int n = n_offsets(quality) - 1;
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      ind_base(base_q, other_offset(j), b, dec);
      topk_insert(top, restricted_err<UW>(s, dec.v, w, mv), j);
    }
#pragma unroll 1
    for (int r = 0; r < keep; ++r) {
      ind_base(base_q, other_offset(topk_at(top, r)), b, dec);
      const TableFit g = table_fit<UW>(px, flip, sub, dec, w);
      if (g.err < best.err) {
#pragma unroll
        for (int c = 0; c < 3; ++c) best.b[c] = b[c];
        best.t = g.best;
        best.err = g.err;
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

// w * (x - clip(floor((x*(H-O) + y*(V-O) + 4*O + 2) / 4)))^2 at texel t.
template <bool UW>
__device__ __forceinline__ float planar_texel(const Px& px, const Chw& w, int c, int t, float dov,
                                              float dhv, float dvv) {
  const float val = (float)(t & 3) * (dhv - dov) + (float)(t >> 2) * (dvv - dov) + 4.0f * dov + 2.0f;
  const float d = clampf(floorf(val * 0.25f), 0.0f, 255.0f);
  return wmul<UW>(w, c, sq(px(c, t) - d));
}

template <bool UW>
__device__ __forceinline__ float planar_chan(const Px& px, const Chw& w, int c, int o, int h, int v,
                                             int bits) {
  const float dov = dec_planar(o, bits), dhv = dec_planar(h, bits), dvv = dec_planar(v, bits);
  float acc = 0.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t) acc = acc + planar_texel<UW>(px, w, c, t, dov, dhv, dvv);
  return acc;
}

template <bool UW>
__device__ __noinline__ float planar(Px px, Chw w, int refine, uint32_t* words) {
  int q[3][3];  // [O/H/V][channel]
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = c_planar_proj[k][0] * px(c, 0);
#pragma unroll
      for (int i = 1; i < 16; ++i) acc = acc + c_planar_proj[k][i] * px(c, i);
      const int maxv = c == 1 ? 127 : 63;
      const float scale = c == 1 ? kQ127 : kQ63;
      q[k][c] = (int)clampf(rintf(acc * scale), 0.0f, (float)maxv);
    }
  }
  if (refine) {
    // The +-1 neighbourhood of each channel's (O, H, V), walked from the
    // current best: later steps start from an accepted one.  The three
    // channels' walks are independent and run side by side.
    float best_e[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      best_e[c] = planar_chan<UW>(px, w, c, q[0][c], q[1][c], q[2][c], c == 1 ? 7 : 6);
#pragma unroll 1
    for (int s = 0; s < 27; ++s) {
      if (s == 13) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int bits = c == 1 ? 7 : 6, maxv = (1 << bits) - 1;
        const int o = clampi(q[0][c] + s / 9 - 1, 0, maxv);
        const int h = clampi(q[1][c] + (s / 3) % 3 - 1, 0, maxv);
        const int v = clampi(q[2][c] + s % 3 - 1, 0, maxv);
        const float en = planar_chan<UW>(px, w, c, o, h, v, bits);
        if (en < best_e[c]) {
          q[0][c] = o;
          q[1][c] = h;
          q[2][c] = v;
          best_e[c] = en;
        }
      }
    }
  }
  float dq[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) dq[k][c] = dec_planar(q[k][c], c == 1 ? 7 : 6);
  float err = 0.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    float e = planar_texel<UW>(px, w, 0, t, dq[0][0], dq[1][0], dq[2][0]);
    e = e + planar_texel<UW>(px, w, 1, t, dq[0][1], dq[1][1], dq[2][1]);
    e = e + planar_texel<UW>(px, w, 2, t, dq[0][2], dq[1][2], dq[2][2]);
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
__device__ __noinline__ void pca_split_means(Px px, Rgb* mp, Rgb* mn) {
  float mean[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < 16; ++t) acc = acc + px(c, t);
    mean[c] = acc / 16.0f;
  }
  float cov[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < 16; ++t) acc = acc + (px(c, t) - mean[c]) * (px(d, t) - mean[d]);
      cov[c][d] = acc;
    }
  }
  // The first texel of largest norm starts the power iteration.
  float mx = 0.0f;
  int fidx = 0;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const float c0 = px(0, t) - mean[0], c1 = px(1, t) - mean[1], c2 = px(2, t) - mean[2];
    const float nrm = c0 * c0 + c1 * c1 + c2 * c2;
    if (t == 0 || nrm > mx) {
      mx = nrm;
      fidx = t;
    }
  }
  float v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = px(c, fidx) - mean[c];
  const float n0 = sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = n0 > 1e-10f ? v[c] / (n0 + 1e-20f) : 1.0f;
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    float nv[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) nv[c] = cov[c][0] * v[0] + cov[c][1] * v[1] + cov[c][2] * v[2];
    const float nn = sqrtf(nv[0] * nv[0] + nv[1] * nv[1] + nv[2] * nv[2]);
    if (nn > 1e-10f)
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = nv[c] / (nn + 1e-20f);
  }
  uint32_t split = 0u;
  float np = 0.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const float s = (px(0, t) - mean[0]) * v[0] + (px(1, t) - mean[1]) * v[1] +
                    (px(2, t) - mean[2]) * v[2];
    if (s > 0.0f) {
      split |= 1u << t;
      np = np + 1.0f;
    }
  }
  const float cp = np + 1e-6f, cn = (16.0f - np) + 1e-6f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float sp = 0.0f, sn = 0.0f;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      if ((split >> t) & 1u)
        sp = sp + px(c, t);
      else
        sn = sn + px(c, t);
    }
    mp->v[c] = sp / cp;
    mn->v[c] = sn / cn;
  }
}

__device__ __forceinline__ void quant444(const Rgb& x, int (&q)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) q[c] = (int)clampf(rintf(x.v[c] * kQ15), 0.0f, 15.0f);
}

// T palette [C1, C2 + d, C2, C2 - d]; H palette [C1 + d, C1 - d, C2 + d,
// C2 - d]; colours expanded from 4 bits.
__device__ __forceinline__ void th_palette(bool h, const int (&q1)[3], const int (&q2)[3],
                                           float dist, float (&pal)[4][3]) {
#pragma unroll
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
}

// The block's texels in registers.
struct Block {
  float x[3][16];
};

// Error of a T or H candidate: each texel's least error over the palette.
template <bool UW>
__device__ __forceinline__ float th_err(const Block& b, const Chw& w, bool h, const int (&q1)[3],
                                        const int (&q2)[3], float dist) {
  float pal[4][3];
  th_palette(h, q1, q2, dist, pal);
  float err = 0.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    float e = err3<UW>(w, b.x[0][t] - pal[0][0], b.x[1][t] - pal[0][1], b.x[2][t] - pal[0][2]);
#pragma unroll
    for (int k = 1; k < 4; ++k)
      e = fminf(e, err3<UW>(w, b.x[0][t] - pal[k][0], b.x[1][t] - pal[k][1], b.x[2][t] - pal[k][2]));
    err = err + e;
  }
  return err;
}

// The index bits of a T or H candidate (first minimum).
template <bool UW>
__device__ __forceinline__ uint32_t th_bits(const Block& b, const Chw& w, bool h,
                                            const int (&q1)[3], const int (&q2)[3], float dist) {
  float pal[4][3];
  th_palette(h, q1, q2, dist, pal);
  uint32_t bits = 0u;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    float be = err3<UW>(w, b.x[0][t] - pal[0][0], b.x[1][t] - pal[0][1], b.x[2][t] - pal[0][2]);
    int bk = 0;
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      const float e = err3<UW>(w, b.x[0][t] - pal[k][0], b.x[1][t] - pal[k][1], b.x[2][t] - pal[k][2]);
      if (e < be) {
        be = e;
        bk = k;
      }
    }
    bits |= index_bits(t, bk);
  }
  return bits;
}

struct ThCand {
  int q1[3], q2[3], didx;
  float err;
};

__device__ __forceinline__ void th_take(ThCand& best, const int (&q1)[3], const int (&q2)[3],
                                        int didx, float err) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    best.q1[c] = q1[c];
    best.q2[c] = q2[c];
  }
  best.didx = didx;
  best.err = err;
}

__device__ __forceinline__ int packed444(const int (&q)[3]) { return (q[0] << 8) | (q[1] << 4) | q[2]; }

// H mode's colour order carries the distance's low bit: put the pair in
// the order that `want` asks for; ok = whether that order holds.
__device__ __forceinline__ bool canon(const int (&q1n)[3], const int (&q2n)[3], int want,
                                      int (&q1c)[3], int (&q2c)[3]) {
  const int p1 = packed444(q1n), p2 = packed444(q2n);
  const bool swap = (int)(p1 >= p2) != want;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q1c[c] = swap ? q2n[c] : q1n[c];
    q2c[c] = swap ? q1n[c] : q2n[c];
  }
  const int p1c = swap ? p2 : p1, p2c = swap ? p1 : p2;
  return (int)(p1c >= p2c) == want;
}

__device__ __forceinline__ void nudge(const int (&q)[3], int c, int dd, int (&out)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = i == c ? clampi(q[i] + dd, 0, 15) : q[i];
}

// One step of a T (h = false) or H (h = true) search, each from the
// chain's current best.  The first candidate of the initial search is
// taken whatever its error; an H candidate whose colour order does not
// carry its distance's low bit adds 1e30.
template <bool UW, bool h>
__device__ __forceinline__ void th_first(const Block& b, const Chw& w, const int (&q1)[3],
                                         const int (&q2)[3], int ord_bit, int di, bool first,
                                         ThCand& best) {
  float err = th_err<UW>(b, w, h, q1, q2, dist_of(di));
  if (h) err = err + ((di & 1) == ord_bit ? 0.0f : kBig);
  if (first || err < best.err) th_take(best, q1, q2, di, err);
}

// The pair of refinement step `step` from `best`: +-1 on colour coordinate
// step / 2 (q1's R, G, B, then q2's), down for an even step.
__device__ __forceinline__ void th_step_pair(const ThCand& best, int step, int (&q1n)[3],
                                             int (&q2n)[3]) {
  const int which = step / 6, c = (step / 2) % 3, dd = step & 1 ? 1 : -1;
  if (which == 0) {
    nudge(best.q1, c, dd, q1n);
#pragma unroll
    for (int i = 0; i < 3; ++i) q2n[i] = best.q2[i];
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) q1n[i] = best.q1[i];
    nudge(best.q2, c, dd, q2n);
  }
}

// Pair (q1n, q2n) at distance rung didx, for H in the order that didx's
// low bit asks for; taken into `best` if it beats it.
template <bool UW, bool h>
__device__ __forceinline__ void th_try(const Block& b, const Chw& w, const int (&q1n)[3],
                                       const int (&q2n)[3], int didx, ThCand& best) {
  int q1c[3], q2c[3];
  bool ok = true;
  if (h) {
    ok = canon(q1n, q2n, didx & 1, q1c, q2c);
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      q1c[i] = q1n[i];
      q2c[i] = q2n[i];
    }
  }
  float errn = th_err<UW>(b, w, h, q1c, q2c, dist_of(didx));
  if (h) errn = errn + (ok ? 0.0f : kBig);
  if (errn < best.err) th_take(best, q1c, q2c, didx, errn);
}

// The (hi, lo) words of a T or H candidate.
template <bool UW, bool h>
__device__ __forceinline__ void th_words(const Block& b, const Chw& w, const ThCand& best,
                                         uint32_t* words) {
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
  words[1] = th_bits<UW>(b, w, h, best.q1, best.q2, dist_of(best.didx));
}

// The T and H candidates, their two searches run side by side: each step
// of a refinement starts from its own chain's best, so running the
// independent T and H steps together gives the card two chains to overlap.
// out: T's words, then H's; err: T's error, then H's.
template <bool UW>
__device__ __noinline__ void th_modes(Px px, Chw w, Rgb mp, Rgb mn, int refine, uint32_t* out,
                                      float* err) {
  Block b;
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int t = 0; t < 16; ++t) b.x[c][t] = px(c, t);
  ThCand bt, bh;
#pragma unroll 1
  for (int order = 0; order < 2; ++order) {
    int q1[3], q2[3];
    quant444(order ? mn : mp, q1);
    quant444(order ? mp : mn, q2);
    const int ord_bit = packed444(q1) >= packed444(q2);
#pragma unroll 1
    for (int di = 0; di < 8; ++di) {
      const bool first = order == 0 && di == 0;
      th_first<UW, false>(b, w, q1, q2, ord_bit, di, first, bt);
      th_first<UW, true>(b, w, q1, q2, ord_bit, di, first, bh);
    }
  }
#pragma unroll 1
  for (int pass = 0; pass < refine; ++pass) {
    // +-1 coordinate descent over the six colour coordinates with the
    // adjacent distance rungs tried per step, then a distance re-sweep.
#pragma unroll 1
    for (int step = 0; step < 12; ++step) {
      int q1t[3], q2t[3], q1h[3], q2h[3];
      th_step_pair(bt, step, q1t, q2t);
      th_step_pair(bh, step, q1h, q2h);
#pragma unroll 1
      for (int dstep = -1; dstep <= 1; ++dstep) {
        th_try<UW, false>(b, w, q1t, q2t, clampi(bt.didx + dstep, 0, 7), bt);
        th_try<UW, true>(b, w, q1h, q2h, clampi(bh.didx + dstep, 0, 7), bh);
      }
    }
    // The re-sweep tries every rung on the pair it started from.
    ThCand ft = bt, fh = bh;
#pragma unroll 1
    for (int di = 0; di < 8; ++di) {
      th_try<UW, false>(b, w, bt.q1, bt.q2, di, ft);
      th_try<UW, true>(b, w, bh.q1, bh.q2, di, fh);
    }
    bt = ft;
    bh = fh;
  }
  th_words<UW, false>(b, w, bt, out);
  th_words<UW, true>(b, w, bh, out + 2);
  err[0] = bt.err;
  err[1] = bh.err;
}

// ---------------------------------------------------------------------------
// The ETC RGB sweep (etc_pallas.py:_rgb_words)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t etc1_hi(const int (&f1)[3], const int (&f2)[3], bool diff,
                                            int flip, int t1, int t2) {
  uint32_t hi = 0u;
#pragma unroll
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
template <bool UW>
__device__ __noinline__ void rgb_words(Px px, Chw w, int quality, bool etc2, uint32_t* words) {
  bool have = false;
  float best_err = 0.0f;
#pragma unroll 1
  for (int flip = 0; flip < 2; ++flip) {
    Rgb mean1, mean2;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        if (member(t, flip, 0))
          s1 = s1 + px(c, t);
        else
          s2 = s2 + px(c, t);
      }
      mean1.v[c] = s1 / 8.0f;
      mean2.v[c] = s2 / 8.0f;
    }
    DiffFit df;
    diff_fit<UW>(px, w, flip, mean1, mean2, quality, &df);
    {
      int b2[3];
      Rgb dec1, dec2;
#pragma unroll
      for (int c = 0; c < 3; ++c) b2[c] = df.b1[c] + df.d[c];
      dec_of(df.b1, true, dec1.v);
      dec_of(b2, true, dec2.v);
      const uint32_t lo = table_bits<UW>(px, flip, 0, dec1, w, df.t1) |
                          table_bits<UW>(px, flip, 1, dec2, w, df.t2);
      offer(df.err, etc1_hi(df.b1, df.d, true, flip, df.t1, df.t2), lo, have, best_err, words);
    }
    if (quality >= 1) {
      SubFit i1, i2;
      ind_subfit<UW>(px, w, flip, 0, mean1, quality, &i1);
      ind_subfit<UW>(px, w, flip, 1, mean2, quality, &i2);
      Rgb dec1, dec2;
      dec_of(i1.b, false, dec1.v);
      dec_of(i2.b, false, dec2.v);
      const uint32_t lo = table_bits<UW>(px, flip, 0, dec1, w, i1.t) |
                          table_bits<UW>(px, flip, 1, dec2, w, i2.t);
      offer(i1.err + i2.err, etc1_hi(i1.b, i2.b, false, flip, i1.t, i2.t), lo, have, best_err,
            words);
    }
  }
  if (etc2) {
    const int refine = quality >= 4 ? 2 : 0;
    uint32_t wd[2];
    float err = planar<UW>(px, w, refine, wd);
    offer(err, wd[0], wd[1], have, best_err, words);
    Rgb mp, mn;
    pca_split_means(px, &mp, &mn);
    uint32_t th[4];
    float th_e[2];
    th_modes<UW>(px, w, mp, mn, refine, th, th_e);
    offer(th_e[0], th[0], th[1], have, best_err, words);
    offer(th_e[1], th[2], th[3], have, best_err, words);
  }
}

__device__ __forceinline__ bool unit_weights(const Chw& w) {
  return w.w[0] == 1.0f && w.w[1] == 1.0f && w.w[2] == 1.0f;
}

// ---------------------------------------------------------------------------
// EAC (etc_pallas.py:_eac_alpha, _eac_r11)
// ---------------------------------------------------------------------------

// One channel of a thread's block in shared memory (R11, alpha, a RG11
// channel): texel t at p[t * kStride].
struct Chan {
  const float* p;
  __device__ __forceinline__ float operator[](int t) const { return p[t * kStride]; }
};

// min(|a|, |b|): one instruction on the card, which takes |x| as an operand
// modifier of FMNMX.  A CPU build may bring its own (chip_smoke.py's
// counting shim counts it as the one operation it is).
#ifndef ETCX_HAVE_FMIN_ABS
__device__ __forceinline__ float fmin_abs(float a, float b) { return fminf(fabsf(a), fabsf(b)); }
#endif

// Table tb's palette at multiplier mult: alpha clip(base_v + mod * mult, lo,
// hi); R11 (values in the /8 domain) clip(base_v + mod * mult * 8, lo, hi)
// / 8, with base_v = base * 8 + offset.
template <bool R11>
__device__ __forceinline__ void eac_palette(int tb, int mult, float base_v, float lo, float hi,
                                            float (&pal)[8]) {
  const float m = (float)(R11 ? mult * 8 : mult);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float p = clampf(base_v + c_eac_mods[tb][k] * m, lo, hi);
    pal[k] = R11 ? p * 0.125f : p;
  }
}

// Whether texel x's nearest entries lie in the palette's upper half: x at
// or above the base.  The function needs it once a texel; the search makes
// it once a candidate, and the counting build of chip_smoke.py defines
// EAC_SIDE to count it once a texel or as made.
#ifndef EAC_SIDE
#define EAC_SIDE(x, mid) ((x) >= (mid))
#endif

// The table x multiplier search around the range fit; returns the 64-bit
// block's (hi, lo) words before the byte swap, base byte given.  v[t]: a
// channel in shared memory (Chan, or RGBA's staged alpha).  Each shortcut
// gives the reference's floats and choices:
// - a texel's error against a palette is the square of its least |v - p_k|
//   (rounding is monotone, so that is the least square, as the same float);
// - the entries of indices 0-3 (negative modifiers, each half ordered by
//   magnitude) lie at or below the base and those of 4-7 at or above it,
//   whatever the clamp, so a texel at or above the base is nearest to entry
//   0 or one of 4-7, one below it to entry 4 or one of 0-3: five a texel;
// - with EXITS, a multiplier clamped to the one before it in its table
//   repeats that candidate's error and is skipped, and a candidate is left
//   once its partial error, checked every 4 texels, reaches the best (its
//   terms are not negative): under the strict < neither could be taken.
//   The EAC entries take the exits; RGBA's alpha does not: in that kernel
//   (168 registers a thread) they cost more than they saved.
template <bool R11, bool EXITS, class V>
__device__ __forceinline__ void eac_block(const V v, int quality, uint32_t base_byte, float span,
                                          float base_v, float lo, float hi, uint32_t* words) {
  const int ncand = c_eac_ncand[quality];
  const int dlo = -(ncand / 2), dhi = ncand - ncand / 2;
  const float mid = R11 ? base_v * 0.125f : base_v;
  int best_t = 0, best_mult = 1;
  float best_err = 0.0f;
  for (int tb = 0; tb < 16; ++tb) {
    const int m0 = (int)clampf(rintf(span * c_eac_inv[tb]), 1.0f, 15.0f);
    int prev = 0;
    for (int dmul = dlo; dmul < dhi; ++dmul) {
      const int mult = clampi(m0 + dmul, 1, 15);
      if (EXITS && mult == prev) continue;
      prev = mult;
      const bool first = tb == 0 && dmul == dlo;
      float pal[8];
      eac_palette<R11>(tb, mult, base_v, lo, hi, pal);
      float err = 0.0f;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const float x = v[t];
        const bool up = EAC_SIDE(x, mid);
        float d = fmin_abs(x - pal[0], x - pal[4]);
        d = fmin_abs(d, x - (up ? pal[5] : pal[1]));
        d = fmin_abs(d, x - (up ? pal[6] : pal[2]));
        d = fmin_abs(d, x - (up ? pal[7] : pal[3]));
        err = err + sq(d);
        if (EXITS && (t & 3) == 3 && t < 15 && !first && err >= best_err) break;
      }
      if (first || err < best_err) {
        best_err = err;
        best_t = tb;
        best_mult = mult;
      }
    }
  }
  // The indices: the first least square in table order, as the reference.
  float pal[8];
  eac_palette<R11>(best_t, best_mult, base_v, lo, hi, pal);
  uint32_t hi_w = (base_byte << 24) | ((uint32_t)best_mult << 20) | ((uint32_t)best_t << 16);
  uint32_t lo_w = 0u;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const float x = v[t];
    float be = sq(x - pal[0]);
    uint32_t bk = 0u;
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      const float e = sq(x - pal[k]);
      if (e < be) {
        be = e;
        bk = (uint32_t)k;
      }
    }
    // Pixel p's index sits at bits 45-3p..47-3p of the 64-bit block; the
    // one at bit 30 straddles the two words.
    const int bitpos = 45 - 3 * colmajor(t);
    if (bitpos >= 32) {
      hi_w |= bk << (bitpos - 32);
    } else {
      lo_w |= bk << bitpos;
      if (bitpos > 29) hi_w |= bk >> (32 - bitpos);
    }
  }
  words[0] = hi_w;
  words[1] = lo_w;
}

// a[t], t < 16: alpha in 0..255.
template <bool EXITS, class V>
__device__ __forceinline__ void eac_alpha(const V a, int quality, uint32_t* words) {
  float lo = a[0], hi = a[0];
  for (int t = 1; t < 16; ++t) {
    lo = fminf(lo, a[t]);
    hi = fmaxf(hi, a[t]);
  }
  const int base = (int)clampf(rintf((lo + hi) * 0.5f), 0.0f, 255.0f);
  eac_block<false, EXITS>(a, quality, (uint32_t)base, (hi - lo) * 0.5f, (float)base, 0.0f,
                          255.0f, words);
}

// v8[t], t < 16: the /8 domain (v / 8 of 0..2047, or of -1023..1023 signed).
template <class V>
__device__ __forceinline__ void eac_r11(const V v8, int quality, bool is_signed, uint32_t* words) {
  float lo = v8[0], hi = v8[0];
  for (int t = 1; t < 16; ++t) {
    lo = fminf(lo, v8[t]);
    hi = fmaxf(hi, v8[t]);
  }
  const float blo = is_signed ? -127.0f : 0.0f, bhi = is_signed ? 127.0f : 255.0f;
  const int base = (int)clampf(rintf((lo + hi) * 0.5f), blo, bhi);
  eac_block<true, true>(v8, quality, (uint32_t)base & 0xFFu, (hi - lo) * 0.5f,
                        (float)base * 8.0f + (is_signed ? 0.0f : 4.0f),
                        is_signed ? -1023.0f : 0.0f, is_signed ? 1023.0f : 2047.0f, words);
}

// ---------------------------------------------------------------------------
// Staging a CTA's blocks
// ---------------------------------------------------------------------------

// A value as the entries stage it: clamp(x, lo, 1) * scale, and for R11
// its / 8 (0.125 times, the same float).
__device__ __forceinline__ float staged(float x, float lo, float scale, bool r11) {
  const float v = clampf(x, lo, 1.0f) * scale;
  return r11 ? v * 0.125f : v;
}

// Thread tid's share (of nth) of staging values [first, first + nb) of
// vals [n,16] (R11, alpha) into s, a row of kStride floats per texel:
// neighbouring threads read neighbouring float4s (four texels of a block;
// the wrapper hands over 16-byte aligned storage, bc_cuda.launch).
__device__ __forceinline__ void stage_vals(float* s, const float* vals, int first, int nb, float lo,
                                           float scale, bool r11, int tid, int nth) {
  const float4* src = (const float4*)vals + (size_t)first * 4;
  for (int f = tid; f < nb * 4; f += nth) {
    const float4 q = src[f];
    float* d = s + (4 * (f & 3)) * kStride + (f >> 2);
    d[0] = staged(q.x, lo, scale, r11);
    d[kStride] = staged(q.y, lo, scale, r11);
    d[2 * kStride] = staged(q.z, lo, scale, r11);
    d[3 * kStride] = staged(q.w, lo, scale, r11);
  }
}

// Thread tid's share (of nth) of staging blocks [first, first + nb) of
// blocks [n,16,nch] into s: the first nc channels (RG11 2, RGB 3, RGBA 4)
// as rows [channel][texel].  With nch = 4 neighbouring threads read
// neighbouring texels as float4 (the wrapper hands over 16-byte aligned
// storage, bc_cuda.launch), else one float a thread.
__device__ __forceinline__ void stage(float* s, const float* blocks, int first, int nb, int nch,
                                      int nc, float lo, float scale, bool r11, int tid, int nth) {
  if (nch == 4) {
    const float4* src = (const float4*)blocks + (size_t)first * 16;
    for (int f = tid; f < nb * 16; f += nth) {
      const float4 q = src[f];
      float* d = s + (f & 15) * kStride + (f >> 4);
      d[0] = staged(q.x, lo, scale, r11);
      d[16 * kStride] = staged(q.y, lo, scale, r11);
      if (nc > 2) d[32 * kStride] = staged(q.z, lo, scale, r11);
      if (nc > 3) d[48 * kStride] = staged(q.w, lo, scale, r11);
    }
    return;
  }
  const float* src = blocks + (size_t)first * 16 * nch;
  for (int e = tid; e < nb * 16 * nch; e += nth) {
    const int bt = e / nch, c = e - bt * nch;  // bt = block * 16 + texel
    if (c < nc) s[(16 * c + (bt & 15)) * kStride + (bt >> 4)] = staged(src[e], lo, scale, r11);
  }
}

// ---------------------------------------------------------------------------
// The RGB and RGBA entries' CTA body
// ---------------------------------------------------------------------------

// Thread tid's block after staging: its ETC RGB words (2) or its EAC alpha
// then ETC2 RGB words (4), byte-swapped.
__device__ __forceinline__ void rgb_block(int tid, int quality, bool etc2, const Chw& w,
                                          uint32_t* out) {
  uint32_t cw[2];
  if (unit_weights(w))
    rgb_words<true>(Px{tid}, w, quality, etc2, cw);
  else
    rgb_words<false>(Px{tid}, w, quality, etc2, cw);
  out[0] = bswap(cw[0]);
  out[1] = bswap(cw[1]);
}

// RGBA's EAC alpha from the staged rows, a function of its own so that the
// RGB sweep's functions keep their registers.
__device__ __noinline__ void rgba_alpha(int tid, int quality, uint32_t* words) {
  eac_alpha<false>(PxChan{Px{tid}, 3}, quality, words);
}

__device__ __forceinline__ void rgba_block(int tid, int quality, const Chw& w, uint32_t* out) {
  uint32_t aw[2];
  rgba_alpha(tid, quality, aw);
  out[0] = bswap(aw[0]);
  out[1] = bswap(aw[1]);
  rgb_block(tid, quality, true, w, out + 2);
}

#ifndef __CUDACC__

// The RGB and RGBA entries on the CPU: each CTA's staging, then its
// threads one after another.  out: [n, 2] (RGB) or [n, 4] (RGBA) words.
inline void etc_rgb_cpu(const float* blocks, uint32_t* out, int n, int nch, int quality, int etc2,
                        Chw w) {
  for (int first = 0; first < n; first += kThreads) {
    const int nb = mini(kThreads, n - first);
    for (int tid = 0; tid < kThreads; ++tid)
      stage(s_px, blocks, first, nb, nch, 3, 0.0f, 255.0f, false, tid, kThreads);
    for (int tid = 0; tid < nb; ++tid) rgb_block(tid, quality, etc2 != 0, w, out + 2 * (first + tid));
  }
}

inline void etc2_rgba_cpu(const float* blocks, uint32_t* out, int n, int quality, Chw w) {
  for (int first = 0; first < n; first += kThreads) {
    const int nb = mini(kThreads, n - first);
    for (int tid = 0; tid < kThreads; ++tid)
      stage(s_px, blocks, first, nb, 4, 4, 0.0f, 255.0f, false, tid, kThreads);
    for (int tid = 0; tid < nb; ++tid) rgba_block(tid, quality, w, out + 4 * (first + tid));
  }
}

// The EAC entries on the CPU, likewise (RG11 a thread per (block, channel),
// as the card runs it).  out: [n, 2] (alpha, R11) or [n, 4] (RG11) words.
inline void eac_alpha_cpu(const float* vals, uint32_t* out, int n, int quality) {
  for (int first = 0; first < n; first += kThreads) {
    const int nb = mini(kThreads, n - first);
    for (int tid = 0; tid < kThreads; ++tid)
      stage_vals(s_px, vals, first, nb, 0.0f, 255.0f, false, tid, kThreads);
    for (int tid = 0; tid < nb; ++tid) {
      uint32_t w[2];
      eac_alpha<true>(Chan{s_px + tid}, quality, w);
      out[2 * (first + tid)] = bswap(w[0]);
      out[2 * (first + tid) + 1] = bswap(w[1]);
    }
  }
}

inline void eac_r11_cpu(const float* vals, uint32_t* out, int n, int quality, int is_signed) {
  for (int first = 0; first < n; first += kThreads) {
    const int nb = mini(kThreads, n - first);
    for (int tid = 0; tid < kThreads; ++tid)
      stage_vals(s_px, vals, first, nb, is_signed ? -1.0f : 0.0f, is_signed ? 1023.0f : 2047.0f,
                 true, tid, kThreads);
    for (int tid = 0; tid < nb; ++tid) {
      uint32_t w[2];
      eac_r11(Chan{s_px + tid}, quality, is_signed != 0, w);
      out[2 * (first + tid)] = bswap(w[0]);
      out[2 * (first + tid) + 1] = bswap(w[1]);
    }
  }
}

inline void eac_rg11_cpu(const float* blocks, uint32_t* out, int n, int nch, int quality,
                         int is_signed) {
  for (int first = 0; first < n; first += kThreads) {
    const int nb = mini(kThreads, n - first);
    for (int tid = 0; tid < 2 * kThreads; ++tid)
      stage(s_px, blocks, first, nb, nch, 2, is_signed ? -1.0f : 0.0f,
            is_signed ? 1023.0f : 2047.0f, true, tid, 2 * kThreads);
    for (int ch = 0; ch < 2; ++ch)
      for (int b = 0; b < nb; ++b) {
        uint32_t w[2];
        eac_r11(Chan{s_px + 16 * ch * kStride + b}, quality, is_signed != 0, w);
        out[4 * (first + b) + 2 * ch] = bswap(w[0]);
        out[4 * (first + b) + 2 * ch + 1] = bswap(w[1]);
      }
  }
}

#endif  // !__CUDACC__

#ifdef __CUDACC__

// blocks: [n,16,nch] float32 (nch >= 3) -> [n] uint2 ETC1/ETC2 RGB words.
__global__ void __launch_bounds__(kThreads)
    etc_rgb_kernel(const float* __restrict__ blocks, uint2* __restrict__ out, int n, int nch,
                   int quality, int etc2, Chw chw) {
  const int first = blockIdx.x * kThreads, nb = mini(kThreads, n - first);
  stage(s_px, blocks, first, nb, nch, 3, 0.0f, 255.0f, false, threadIdx.x, kThreads);
  __syncthreads();
  if ((int)threadIdx.x >= nb) return;
  uint32_t w[2];
  rgb_block(threadIdx.x, quality, etc2 != 0, chw, w);
  out[first + threadIdx.x] = make_uint2(w[0], w[1]);
}

// blocks: [n,16,4] float32 -> [n] uint4: EAC alpha words, then ETC2 RGB.
__global__ void __launch_bounds__(kThreads)
    etc2_rgba_kernel(const float* __restrict__ blocks, uint4* __restrict__ out, int n, int quality,
                     Chw chw) {
  const int first = blockIdx.x * kThreads, nb = mini(kThreads, n - first);
  stage(s_px, blocks, first, nb, 4, 4, 0.0f, 255.0f, false, threadIdx.x, kThreads);
  __syncthreads();
  if ((int)threadIdx.x >= nb) return;
  uint32_t w[4];
  rgba_block(threadIdx.x, quality, chw, w);
  out[first + threadIdx.x] = make_uint4(w[0], w[1], w[2], w[3]);
}

// vals: [n,16] float32 in 0..1 -> [n] uint2 EAC alpha words.  A thread per
// block, the CTA's blocks staged in shared memory.
__global__ void __launch_bounds__(kThreads)
    eac_alpha_kernel(const float* __restrict__ vals, uint2* __restrict__ out, int n,
                     int quality) {
  __shared__ float s[16 * kStride];
  const int first = blockIdx.x * kThreads, nb = mini(kThreads, n - first);
  stage_vals(s, vals, first, nb, 0.0f, 255.0f, false, threadIdx.x, kThreads);
  __syncthreads();
  if ((int)threadIdx.x >= nb) return;
  uint32_t w[2];
  eac_alpha<true>(Chan{s + threadIdx.x}, quality, w);
  out[first + threadIdx.x] = make_uint2(bswap(w[0]), bswap(w[1]));
}

// vals: [n,16] float32 in [0,1] ([-1,1] signed) -> [n] uint2 R11 words;
// as the alpha entry, the values staged in the /8 domain.
__global__ void __launch_bounds__(kThreads)
    eac_r11_kernel(const float* __restrict__ vals, uint2* __restrict__ out, int n, int quality,
                   int is_signed) {
  __shared__ float s[16 * kStride];
  const int first = blockIdx.x * kThreads, nb = mini(kThreads, n - first);
  stage_vals(s, vals, first, nb, is_signed ? -1.0f : 0.0f, is_signed ? 1023.0f : 2047.0f, true,
             threadIdx.x, kThreads);
  __syncthreads();
  if ((int)threadIdx.x >= nb) return;
  uint32_t w[2];
  eac_r11(Chan{s + threadIdx.x}, quality, is_signed != 0, w);
  out[first + threadIdx.x] = make_uint2(bswap(w[0]), bswap(w[1]));
}

constexpr int kRgThreads = 2 * kThreads;

// blocks: [n,16,nch] float32 (nch >= 2) -> [n] uint4: R11 words, G11 words
// (out as [n,2] uint2).  kThreads blocks a CTA, staged in shared memory, and
// a thread per (block, channel): warps 0-3 on red, 4-7 on green, each
// writing its channel's half of the block.
__global__ void __launch_bounds__(kRgThreads)
    eac_rg11_kernel(const float* __restrict__ blocks, uint2* __restrict__ out, int n, int nch,
                    int quality, int is_signed) {
  __shared__ float s[32 * kStride];
  const int first = blockIdx.x * kThreads, nb = mini(kThreads, n - first);
  stage(s, blocks, first, nb, nch, 2, is_signed ? -1.0f : 0.0f, is_signed ? 1023.0f : 2047.0f,
        true, threadIdx.x, kRgThreads);
  __syncthreads();
  const int ch = threadIdx.x / kThreads, b = threadIdx.x % kThreads;
  if (b >= nb) return;
  uint32_t w[2];
  eac_r11(Chan{s + 16 * ch * kStride + b}, quality, is_signed != 0, w);
  out[2 * (first + b) + ch] = make_uint2(bswap(w[0]), bswap(w[1]));
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
      (const float*)blocks, (uint4*)out, n, quality, chw);
  return (int)cudaGetLastError();
}

// vals: [n,16] float32; out: [n,2] uint32.
extern "C" int eac_alpha_encode_launch(const void* vals, void* out, int n, int quality,
                                       void* stream) {
  if (n <= 0) return 0;
  if (quality < 0 || quality > 4) return (int)cudaErrorInvalidValue;
  etcx::eac_alpha_kernel<<<etcx::grid_for(n), etcx::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)vals, (uint2*)out, n, quality);
  return (int)cudaGetLastError();
}

// vals: [n,16] float32; out: [n,2] uint32.
extern "C" int eac_r11_encode_launch(const void* vals, void* out, int n, int quality,
                                     int is_signed, void* stream) {
  if (n <= 0) return 0;
  if (quality < 0 || quality > 4) return (int)cudaErrorInvalidValue;
  etcx::eac_r11_kernel<<<etcx::grid_for(n), etcx::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)vals, (uint2*)out, n, quality, is_signed);
  return (int)cudaGetLastError();
}

// blocks: [n,16,nch] float32, nch >= 2; out: [n,4] uint32 (red words, green words).
extern "C" int eac_rg11_encode_launch(const void* blocks, void* out, int n, int nch, int quality,
                                      int is_signed, void* stream) {
  if (n <= 0) return 0;
  if (nch < 2 || quality < 0 || quality > 4) return (int)cudaErrorInvalidValue;
  etcx::eac_rg11_kernel<<<etcx::grid_for(n), etcx::kRgThreads, 0, (cudaStream_t)stream>>>(
      (const float*)blocks, (uint2*)out, n, nch, quality, is_signed);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
