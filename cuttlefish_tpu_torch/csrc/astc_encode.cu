// ASTC LDR block encoder (all 14 2D block sizes, quality 0-4), written by
// hand for Hopper (sm_90a).
//
// Replaces the four TPU kernels of cuttlefish_tpu/kernels/astc_pallas.py:
// _kernel_a (pl.pallas_call at :1493: void extent, the 1-partition CEM 8/12
// layout menu, dual-plane fits and, for near-gray blocks, CEM 0/4),
// _kernel_b (:1568: 2-partition screen over the distinct patterns, top-k,
// a continuous-SSE rerank, CEM 8/12 fits), _kernel_c (:1658: 3-partition
// screen, an unrefined-fit rerank, a CEM 8 fit) and _kernel_d (:1737:
// 4-partition luminance CEM 0/4 screen over all 1024 seeds).  Four entries,
// astc_a .. astc_d; the wrapper (kernels/astc_cuda.py) merges their words
// as encode_astc_pallas does.  The plain PyTorch version of the same
// algorithms is cuttlefish_tpu_torch/kernels/astc.py; the two are compared
// on the card.
//
// Design.  Pallas unrolled a Python loop over static layouts; here each
// entry loops over a descriptor table built on the host
// (astc_cuda.py:descriptor): layout records with their ISE ranges, the
// colour/weight LUTs, trit/quint pack tables, each decimated grid's
// pseudo-inverse and infill, and the partition patterns as texel
// bitmasks.  The TPU's one-hot matmul "gathers" are table loads; a fit
// reads its pattern's masks into a 2-bit partition id per texel, held in
// registers.  A decimated grid's infill and Gauss-Seidel footprint scores
// read the infill's at most four non-zero terms a texel, not the TPU
// kernel's dense [T][G] infill and [G][T] footprint (at 12x12, 4 of 32-64
// a row).  Every per-block array
// is sized by the block's texel class (MT = 16 for 4x4, 64 up to 8x8, 144
// up to 12x12), one template instance per class, with per-texel weights
// and endpoints as bytes.
//
// Entry A: a CTA per group of 32 blocks and a warp per task of its list,
// up to 8 (1-partition layouts and dual planes, then CEM 0/4 for near-gray
// blocks).  The group's texels are staged once, coalesced, in dynamic
// shared memory at an odd stride (4 MT + 1 words a block: 32 lanes on 32
// blocks read 32 banks; 74 KB at 12x12); lane b of every warp holds block
// b, warp v runs tasks v, v + warps, ..., so the lanes of a warp fit one
// layout at a time, and lane b of warp 0 merges the warps' bests in the
// task list's order.  At 12x12 there are only 29,241 blocks: a thread per
// block gave about 7 warps an SM, with each block's tasks one after
// another; a warp per task gives up to 8 times the warps.
//
// Entry B at 4x4: one thread per ASTC block, 64 threads per CTA, the CTA's
// blocks staged once, coalesced, in shared memory at the odd stride of
// entry A (Blk<16, 0>: 32 threads on 32 blocks read 32 banks).  The screen
// holds the block's 64 texels in registers for its 438 patterns.  The rest
// of its time is the reranks and fits, whose frames live in local memory
// (1 KB a thread), so the kernel asks for a shared-memory carveout that
// leaves L1 room for them.  The warp body of B above 4x4 was tried here
// and kept out: at 4x4 it gives each lane the screens, reranks and fits a
// thread has, adds the top-k merges, and its 70 KB of shared memory a CTA
// leave L1 less room (0.73x the earlier thread per block, its texels in
// local memory, at q2; 1.00x at q4).
//
// Entries B above 4x4, C and D, whose pattern screens took most of their
// time: a warp per group of G blocks, 4 warps per CTA.  The entry's
// pattern masks are staged once per CTA in dynamic shared memory (B: 5.5
// KB at 8x8, 16 KB at 12x12; D: 12 KB at 4x4, 60 KB at 12x12), each
// block's texels once per warp as [4][T] floats: C's and D's in shared
// memory, B's (32 blocks of up to 2.3 KB) in a device scratch read through
// L1.  For each block the 32 lanes share its patterns (lane j takes j, j +
// 32, ...), reading each texel as a broadcast for all of a pattern's masks
// at once, and keep their own top-k; five levels of pairwise merges by
// (estimate, pattern) give the list of the sequential scan.  The rerank
// (B: a continuous SSE, C and D: an unrefined fit) and the final fits of
// the G blocks then run a lane per (block, candidate) and per (block, seed,
// layout), B's a layout at a time, and a lane per block takes the winner in
// candidate order.  G fills the lanes in the final fits: B 32 blocks (one
// kept seed above 4x4 at every quality), C 10 and D 16 at 4x4 q4; C and D
// at most 512 texels of blocks a warp.  In a CPU build the 32 lanes of each
// phase run one after another (FOR_LANES).
//
// What bounds it: operations.  A block reads 64-576 bytes and writes 20,
// but a 4x4 block at quality 2 runs some twenty layout fits of several
// refinement rounds each and screens 438 partition patterns; at 12x12 a
// screen covers 144 texels per pattern, and a decimated fit runs 17
// footprint scorings a Gauss-Seidel pass.  So the shared bodies do no
// work twice: a fit's refinement rounds end at the first candidate not
// taken (the next round's least squares would start from the same best
// and make it again), the continuous SSE and the block error fold each
// texel's centred values and endpoints once for all their sums, and a
// weight search reads its levels' weights once.
//
// Numerics, so that the kernel agrees with the plain version bit for bit:
// every sum over texels is a left fold in texel order, except the
// partition screens' masked sums, which fold four texel lanes (t mod 4)
// and add them as (s0 + s1) + (s2 + s3), as XLA's CPU dot does; every sum
// over channels or partitions is a left fold; rounding is rintf (half to
// even, as jnp.round) and floorf; every constant is the float32 value JAX
// uses; the build passes --fmad=false; division and sqrtf stay IEEE.  Every
// search keeps the first minimum (strict <, in candidate order).  The luma
// of CEM 0/4 is (r + g + b) * float32(1/3) and the void extent's mean
// sum * float32(1/T), the products XLA makes of the reference's divisions.
//
// The device functions are plain C++: the __global__ kernels and the
// launchers need nvcc and sit under __CUDACC__.

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <mutex>
#endif
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

namespace astcx {

constexpr int kThreads = 64;  // entry B at 4x4: threads per CTA
constexpr int kMaxT = 144;    // 12x12
constexpr int kMaxTopK = 16;

// The texel classes: per-block arrays are sized for 16 (4x4), 64 (up to
// 8x8) or kMaxT texels.  by_texel_class(T, f) calls f with the tag of T's
// class, so f instantiates its template at TexelClass<MT>::value.
template <int MT>
struct TexelClass {
  static constexpr int value = MT;
};
template <class F>
__host__ inline auto by_texel_class(int T, F f) {
  if (T <= 16) return f(TexelClass<16>());
  if (T <= 64) return f(TexelClass<64>());
  return f(TexelClass<kMaxT>());
}

// Weights of a grid of texel class MT (both planes of a dual one).
__host__ __device__ constexpr int max_grid(int MT) { return MT >= 32 ? 64 : 2 * MT; }
constexpr float kInf = INFINITY;
constexpr float kThird = (float)(1.0f / 3.0f);

// Descriptor header (astc_cuda.py:HDR) and layout record (LAY) fields.
enum Hdr {
  H_T, H_BW, H_BH, H_ITERS, H_ITERS12, H_P2ITERS, H_TOPK2, H_KEEP2, H_TOPK3, H_KEEP3,
  H_TOPK4, H_GRAY255, H_NA, H_OFF_A, H_NAG, H_OFF_AG, H_NB, H_OFF_B, H_NC, H_OFF_C, H_ND,
  H_OFF_D, H_NW, H_U2, H_OFF_P2, H_OFF_S2, H_U3, H_OFF_P3, H_OFF_S3, H_OFF_P4, H_OFF_TRIT,
  H_OFF_QUINT,
};
enum LayF {
  L_NPARTS, L_CEM, L_GW, L_GH, L_G, L_WLEVELS, L_CLEVELS, L_DUAL, L_WBITS, L_HEADER, L_MODE,
  L_CKIND, L_CB, L_WKIND, L_WB, L_OFF_CQ, L_OFF_CD, L_OFF_UNQ, L_OFF_UP, L_OFF_DN, L_OFF_WQ,
  L_OFF_WU, L_OFF_GRID,
};

// Trit (quint) block bit slots after each value: lowest bit and width.
__constant__ int c_trit_lo[5] = {0, 2, 4, 5, 7};
__constant__ int c_trit_w[5] = {2, 2, 1, 2, 1};
__constant__ int c_quint_lo[3] = {0, 3, 5};
__constant__ int c_quint_w[3] = {3, 2, 2};

__device__ __forceinline__ float bits_f(int v) {
#ifdef __CUDACC__
  return __int_as_float(v);
#else
  float f;
  memcpy(&f, &v, 4);
  return f;
#endif
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// One layout, read from its record.
struct Lay {
  int nparts, cem, gw, gh, g, wlevels, clevels, dual, wbits, header, mode;
  int ckind, cb, wkind, wb;
  const int *cq, *cd, *unq, *up, *dn, *wq, *wu;
  const int* pinv;     // [G][T] float32 bits, or null for a full grid
  const int* ia;       // [T][4] the C.2.18 infill's non-zero terms, j | weight << 8 (16ths; 0: none)
};

__device__ inline Lay load_lay(const int* d, int off) {
  const int* r = d + off;
  Lay L;
  L.nparts = r[L_NPARTS];
  L.cem = r[L_CEM];
  L.gw = r[L_GW];
  L.gh = r[L_GH];
  L.g = r[L_G];
  L.wlevels = r[L_WLEVELS];
  L.clevels = r[L_CLEVELS];
  L.dual = r[L_DUAL];
  L.wbits = r[L_WBITS];
  L.header = r[L_HEADER];
  L.mode = r[L_MODE];
  L.ckind = r[L_CKIND];
  L.cb = r[L_CB];
  L.wkind = r[L_WKIND];
  L.wb = r[L_WB];
  L.cq = r[L_OFF_CQ] >= 0 ? d + r[L_OFF_CQ] : nullptr;
  L.cd = r[L_OFF_CD] >= 0 ? d + r[L_OFF_CD] : nullptr;
  L.unq = d + r[L_OFF_UNQ];
  L.up = d + r[L_OFF_UP];
  L.dn = d + r[L_OFF_DN];
  L.wq = d + r[L_OFF_WQ];
  L.wu = d + r[L_OFF_WU];
  if (r[L_OFF_GRID] >= 0) {
    const int T = d[H_T];
    L.pinv = d + r[L_OFF_GRID];
    L.ia = L.pinv + L.g * T;
  } else {
    L.pinv = L.ia = nullptr;
  }
  return L;
}

// The block: texels clip(x, 0, 1) * 255, channel-major, sized by the
// texel class MT (16 B a texel and 16 B more, so that arrays of blocks in
// shared memory stay 16-byte aligned: the warp entries read four texels a
// load).
template <int MT, int PAD = 3>
struct alignas(16) Blk {
  float px[4][MT];
  int T;
  int pad[PAD];
};
// Entry A's blocks in shared memory: 4 MT + 1 words, an odd stride, so that
// 32 lanes on 32 consecutive blocks read 32 different banks.
template <int MT>
struct Blk<MT, 0> {
  float px[4][MT];
  int T;
};

// A block's partitions, read from the bitmasks of partitions 1..np (texels
// in none of them are in partition 0) into a 2-bit id per texel, 16 texels
// a word, small enough to pass in registers; np = 0: one partition, every
// texel in it.
template <int MT>
struct Part {
  int np;
  uint32_t id[(MT + 15) / 16];
};

template <int MT>
__device__ inline Part<MT> whole_part() {
  Part<MT> P = {};
  return P;
}

// Partitions of a row of a mask table (np masks of nw words each): a
// texel's id is the last mask that holds it, else 0.
template <int MT>
__device__ inline Part<MT> make_part(const int* row, int np, int nw) {
  Part<MT> P = {};
  P.np = np;
  for (int j = 0; j < np; ++j)
    for (int k = 0; k < nw; ++k) {
      const uint32_t m = (uint32_t)row[j * nw + k];
      for (int b = 0; b < 32; ++b) {
        const int t = 32 * k + b, s = 2 * (t & 15);
        if (t < MT && ((m >> b) & 1u)) P.id[t >> 4] = (P.id[t >> 4] & ~(3u << s)) | ((uint32_t)(j + 1) << s);
      }
    }
  return P;
}

template <int MT>
__device__ __forceinline__ int part_of(const Part<MT>& P, int t) {
  return (int)((P.id[t >> 4] >> (2 * (t & 15))) & 3u);
}

// Fit-space channel c of texel t (CEM 0/4: luma, then alpha).
template <int MT, int PD>
__device__ __forceinline__ float pxf(const Blk<MT, PD>& B, int cem, int c, int t) {
  if (cem == 0 || cem == 4) {
    if (c == 0) return ((B.px[0][t] + B.px[1][t]) + B.px[2][t]) * kThird;
    return B.px[3][t];
  }
  return B.px[c][t];
}

__device__ __forceinline__ int fit_nch(int cem) {
  return cem == 0 ? 1 : cem == 4 ? 2 : cem == 12 ? 4 : 3;
}

// Membership mask of texel t in partition p (np = 0: one partition).
template <int MT>
__device__ __forceinline__ float memb(const Part<MT>& P, int p, int t) {
  return P.np == 0 ? 1.0f : (part_of(P, t) == p ? 1.0f : 0.0f);
}

// Decoded byte of the exact decoder model (16-bit endpoint expansion,
// 64-weight interpolation, top byte): ((d0 * 257 * (64 - w) + d1 * 257 * w
// + 32) >> 6) >> 8, the same integer written as one product by w of the
// texel's constants (a non-negative sum: the two shifts are one).
__device__ __forceinline__ float dec8(int d0, int d1, int w) {
  return (float)((((d1 - d0) * 257) * w + (d0 * 16448 + 32)) >> 14);
}

__device__ __forceinline__ float sq(float x) { return x * x; }

// ---------------------------------------------------------------------------
// PCA seed, endpoint order, colour quantisation, least squares
// ---------------------------------------------------------------------------

template <int MT, int PD>
__device__ float count_of(const Blk<MT, PD>& B, const Part<MT> P, int p) {
  if (P.np == 0) return (float)B.T + 1e-6f;
  float s = memb(P, p, 0);
  for (int t = 1; t < B.T; ++t) s = s + memb(P, p, t);
  return s + 1e-6f;
}

// Power iteration (3 rounds) on a chn x chn covariance.
__device__ void power3(const float cov[4][4], int chn, float v[4]) {
  for (int c = 0; c < chn; ++c) v[c] = 1.0f;
  for (int it = 0; it < 3; ++it) {
    float nv[4];
    for (int c = 0; c < chn; ++c) {
      float s = cov[c][0] * v[0];
      for (int d = 1; d < chn; ++d) s = s + cov[c][d] * v[d];
      nv[c] = s;
    }
    float ss = nv[0] * nv[0];
    for (int c = 1; c < chn; ++c) ss = ss + nv[c] * nv[c];
    const float nn = sqrtf(ss);
    if (nn > 1e-10f) {
      for (int c = 0; c < chn; ++c) v[c] = nv[c] / (nn + 1e-20f);
    }
  }
}

// Masked principal-axis extremes of the fit-space channels chans[0..chn).
// chans[k] < 0 selects fit channel k of `cem`; else raw channel chans[k].
struct Chans {
  int cem;
  int n;
  int idx[4];  // -1: fit-space channel k; else a raw channel
};

template <int MT, int PD>
__device__ __forceinline__ float chv(const Blk<MT, PD>& B, const Chans& C, int k, int t) {
  return C.idx[k] < 0 ? pxf(B, C.cem, k, t) : B.px[C.idx[k]][t];
}

template <int MT, int PD>
__device__ __noinline__ void pca_seed(const Blk<MT, PD>& B, const Chans& C, const Part<MT> P, int p,
                                      float e0[4], float e1[4]) {
  const int T = B.T, chn = C.n;
  const float cnt = count_of(B, P, p);
  float mean[4];
  for (int c = 0; c < chn; ++c) {
    float s = chv(B, C, c, 0) * memb(P, p, 0);
    if (P.np == 0) s = chv(B, C, c, 0);
    for (int t = 1; t < T; ++t) s = s + (P.np == 0 ? chv(B, C, c, t) : chv(B, C, c, t) * memb(P, p, t));
    mean[c] = s / cnt;
  }
  float cov[4][4];
  for (int c = 0; c < chn; ++c)
    for (int d = c; d < chn; ++d) {
      float s = 0.0f;
      for (int t = 0; t < T; ++t) {
        const float m = memb(P, p, t);
        const float a = P.np == 0 ? chv(B, C, c, t) - mean[c] : (chv(B, C, c, t) - mean[c]) * m;
        const float b = P.np == 0 ? chv(B, C, d, t) - mean[d] : (chv(B, C, d, t) - mean[d]) * m;
        s = t == 0 ? a * b : s + a * b;
      }
      cov[c][d] = cov[d][c] = s;
    }
  float v[4];
  power3(cov, chn, v);
  float tmax = -1e30f, tmin = 1e30f;
  for (int t = 0; t < T; ++t) {
    const float m = memb(P, p, t);
    float tt = 0.0f;
    for (int c = 0; c < chn; ++c) {
      const float a = P.np == 0 ? chv(B, C, c, t) - mean[c] : (chv(B, C, c, t) - mean[c]) * m;
      tt = c == 0 ? a * v[c] : tt + a * v[c];
    }
    if (m > 0.0f) {
      tmax = fmaxf(tmax, tt);
      tmin = fminf(tmin, tt);
    }
  }
  for (int c = 0; c < chn; ++c) {
    e1[c] = mean[c] + v[c] * tmax;
    e0[c] = mean[c] + v[c] * tmin;
  }
}

__device__ __forceinline__ void orient(float e0[4], float e1[4], int chn) {
  const float s0 = (e0[0] + e0[1]) + e0[2], s1 = (e1[0] + e1[1]) + e1[2];
  if (s0 > s1)
    for (int c = 0; c < chn; ++c) {
      const float x = e0[c];
      e0[c] = e1[c];
      e1[c] = x;
    }
}

__device__ __forceinline__ void quant_color(const Lay& L, float e, uint8_t& q, uint8_t& d) {
  const int v = (int)clampf(rintf(e), 0.0f, 255.0f);
  if (L.cq == nullptr) {
    q = d = v;
  } else {
    q = L.cq[v];
    d = L.cd[v];
  }
}

// Least-squares endpoints for per-texel weights w (w = 1 -> e1).
template <int MT, int PD>
__device__ __noinline__ void lsq(const Blk<MT, PD>& B, const Chans& C, const float* w, const Part<MT> P,
                                 int p, float e0[4], float e1[4]) {
  const int T = B.T, chn = C.n;
  float a11 = 0, a12 = 0, a22 = 0, b1[4], b0[4], ms[4];
  for (int t = 0; t < T; ++t) {
    const float m = memb(P, p, t);
    const float wv = P.np == 0 ? w[t] : w[t] * m;
    const float uv = P.np == 0 ? 1.0f - w[t] : (1.0f - w[t]) * m;
    const float x11 = wv * w[t], x12 = wv * (1.0f - w[t]), x22 = uv * (1.0f - w[t]);
    a11 = t == 0 ? x11 : a11 + x11;
    a12 = t == 0 ? x12 : a12 + x12;
    a22 = t == 0 ? x22 : a22 + x22;
    for (int c = 0; c < chn; ++c) {
      const float x = chv(B, C, c, t);
      const float y1 = wv * x, y0 = uv * x, ym = P.np == 0 ? x : x * m;
      b1[c] = t == 0 ? y1 : b1[c] + y1;
      b0[c] = t == 0 ? y0 : b0[c] + y0;
      ms[c] = t == 0 ? ym : ms[c] + ym;
    }
  }
  const float det = a11 * a22 - a12 * a12;
  const bool ok = fabsf(det) > 1e-6f;
  const float safe = ok ? det : 1.0f;
  const float cnt = count_of(B, P, p);
  for (int c = 0; c < chn; ++c) {
    const float mean = ms[c] / cnt;
    const float x1 = ok ? (a22 * b1[c] - a12 * b0[c]) / safe : mean;
    const float x0 = ok ? (a11 * b0[c] - a12 * b1[c]) / safe : mean;
    e1[c] = clampf(x1, 0.0f, 255.0f);
    e0[c] = clampf(x0, 0.0f, 255.0f);
  }
}

// ---------------------------------------------------------------------------
// Weights: exact per-texel choice, grid quantisation, infill, Gauss-Seidel
// ---------------------------------------------------------------------------

// Endpoints per partition, expanded to 4 channels (CEM 0: L L L, alpha 255;
// CEM 4: L L L A), with the number of channels that carry endpoints.
struct Ends {
  uint8_t d0[4][4], d1[4][4];  // [partition][channel], 0..255
  int nche;
};

template <int MT>
__device__ __forceinline__ int e0c(const Ends& E, const Part<MT> P, int c, int t) {
  return c < E.nche ? E.d0[part_of(P, t)][c] : 255;
}
template <int MT>
__device__ __forceinline__ int e1c(const Ends& E, const Part<MT> P, int c, int t) {
  return c < E.nche ? E.d1[part_of(P, t)][c] : 255;
}

// One texel's endpoints and values over the channels chs[0..nc), nc <= 4,
// read once for all the weights a search tries.
struct TexelEnds {
  int d0[4], d1[4];
  float x[4];
  int nc;
};

template <int MT, int PD>
__device__ __forceinline__ TexelEnds texel_ends(const Blk<MT, PD>& B, const Ends& E, const Part<MT> P,
                                                const int* chs, int nc, int t) {
  TexelEnds R;
  R.nc = nc;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < nc) {
      const int c = chs[k];
      R.d0[k] = e0c(E, P, c, t);
      R.d1[k] = e1c(E, P, c, t);
      R.x[k] = B.px[c][t];
    }
  return R;
}

// Texel error for weight w64 over those channels.
__device__ __forceinline__ float texel_werr(const TexelEnds& R, int w64) {
  float e = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < R.nc) {
      const float x = sq(dec8(R.d0[k], R.d1[k], w64) - R.x[k]);
      e = k == 0 ? x : e + x;
    }
  return e;
}

// Per-texel weight by exact decode error (full grids).
template <int MT, int PD>
__device__ __noinline__ void wquant_exact(const Blk<MT, PD>& B, const Ends& E, const Part<MT> P,
                                          const int* chs, int nc, const Lay& L, uint8_t* gq,
                                          uint8_t* unq) {
  const int T = B.T, levels = L.wlevels;
  int uq[8];  // the levels' weights, read once for every texel
#pragma unroll
  for (int q = 0; q < 8; ++q) uq[q] = q < levels ? L.unq[q] : 0;
  for (int t = 0; t < T; ++t) {
    const TexelEnds R = texel_ends(B, E, P, chs, nc, t);
    if (levels <= 8) {
      int bq = 0, bu = uq[0];
      float be = texel_werr(R, bu);
#pragma unroll
      for (int q = 1; q < 8; ++q) {
        if (q >= levels) break;
        const int w = uq[q];
        const float e = texel_werr(R, w);
        if (e < be) {
          bq = q;
          bu = w;
          be = e;
        }
      }
      gq[t] = bq;
      unq[t] = bu;
      continue;
    }
    float denom = 0.0f, proj = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < nc) {
        const float df = (float)(R.d1[k] - R.d0[k]);
        denom = k == 0 ? df * df : denom + df * df;
        const float pr = (R.x[k] - (float)R.d0[k]) * df;
        proj = k == 0 ? pr : proj + pr;
      }
    denom = denom + 1e-6f;
    const float tt = clampf(proj / denom, 0.0f, 1.0f);
    const int w64 = (int)clampf(rintf(tt * 64.0f), 0.0f, 64.0f);
    int bq = L.wq[w64], bu = L.wu[w64];
    float be = texel_werr(R, bu);
    const int g0 = bq;
    for (int dir = 0; dir < 2; ++dir) {
      const int cq = (dir == 0 ? L.up : L.dn)[g0];
      const int cu = L.unq[cq];
      const float e = texel_werr(R, cu);
      if (e < be) {
        bq = cq;
        bu = cu;
        be = e;
      }
    }
    gq[t] = bq;
    unq[t] = bu;
  }
}

// C.2.18 infill of grid values gv (ISE values) at texel t -> its w64: the
// at most four non-zero terms of the texel's row (an integer sum, exact in
// any order).
__device__ __forceinline__ int infill_at(const Lay& L, const uint8_t* gv, int t) {
  const int* e = L.ia + 4 * t;
  int s = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) s += (e[k] >> 8) * L.unq[gv[e[k] & 0xFF]];
  return (s + 8) >> 4;
}

__device__ void infill(const Lay& L, int T, const uint8_t* gv, uint8_t* w64) {
  for (int t = 0; t < T; ++t) w64[t] = infill_at(L, gv, t);
}

// Ideal texel weights tw -> grid ISE values gq[G] and texel weights w64[T].
__device__ __noinline__ void grid_quant(const Lay& L, int T, const float* tw, uint8_t* gq,
                                        uint8_t* w64) {
  if (L.pinv == nullptr) {
    for (int t = 0; t < T; ++t) {
      const int w = (int)clampf(rintf(tw[t] * 64.0f), 0.0f, 64.0f);
      gq[t] = L.wq[w];
      w64[t] = L.wu[w];
    }
    return;
  }
  for (int j = 0; j < L.g; ++j) {
    const int* row = L.pinv + j * T;
    float s = bits_f(row[0]) * tw[0];
    for (int t = 1; t < T; ++t) s = s + bits_f(row[t]) * tw[t];
    const int w = (int)clampf(rintf(clampf(s, 0.0f, 1.0f) * 64.0f), 0.0f, 64.0f);
    gq[j] = L.wq[w];
  }
  infill(L, T, gq, w64);
}

// Footprint scores of grid values g: per grid point, the exact error over
// its footprint texels (a left fold in texel order).  The footprint of grid
// point j is the texels whose infill weighs it (foot[j][t] = a[t][j] > 0),
// so one pass over the texels adds each texel's error to the at most four
// points of its infill row, in texel order.  A dense fold over foot
// gives the same float: each of its other terms is 0 * err = +0 (err a
// finite sum of squares, >= +0), and s + 0 = s.
template <int MT, int PD>
__device__ __noinline__ void gs_scores(const Blk<MT, PD>& B, const Ends& E, const Part<MT> P, const Lay& L,
                                       const uint8_t* g, float* sc) {
  const int T = B.T, G = L.g;
  const int* ia = L.ia;
  uint8_t gw[max_grid(MT)];  // each grid point's unquantised weight
  for (int j = 0; j < G; ++j) {
    gw[j] = (uint8_t)L.unq[g[j]];
    sc[j] = 0.0f;
  }
  int a0[4], a1[4];  // one partition: its endpoints at every texel
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    a0[c] = e0c(E, P, c, 0);
    a1[c] = e1c(E, P, c, 0);
  }
  for (int t = 0; t < T; ++t) {
    int ent[4], s = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ent[k] = ia[4 * t + k];
      s += (ent[k] >> 8) * gw[ent[k] & 0xFF];
    }
    const int w64 = (s + 8) >> 4;
    float e = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d0 = P.np == 0 ? a0[c] : e0c(E, P, c, t), d1 = P.np == 0 ? a1[c] : e1c(E, P, c, t);
      const float x = sq(dec8(d0, d1, w64) - B.px[c][t]);
      e = c == 0 ? x : e + x;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (ent[k] >> 8) sc[ent[k] & 0xFF] = sc[ent[k] & 0xFF] + e;
  }
}

// One Gauss-Seidel pass over the four (gx%2, gy%2) checkerboard classes.
template <int MT, int PD>
__device__ __noinline__ void gs_refine(const Blk<MT, PD>& B, const Ends& E, const Part<MT> P, const Lay& L,
                                       uint8_t* gq) {
  float cur[max_grid(MT)], sc[max_grid(MT)];
  uint8_t cand[max_grid(MT)];
  const int G = L.g, gwid = L.gw;
  gs_scores(B, E, P, L, gq, cur);
  for (int cc = 0; cc < 4; ++cc)
    for (int dir = 0; dir < 2; ++dir) {
      const int* tab = dir == 0 ? L.up : L.dn;
      for (int j = 0, x = 0, y = 0; j < G; ++j) {
        cand[j] = (y & 1) * 2 + (x & 1) == cc ? tab[gq[j]] : gq[j];
        if (++x == gwid) x = 0, ++y;
      }
      gs_scores(B, E, P, L, cand, sc);
      for (int j = 0, x = 0, y = 0; j < G; ++j) {
        if ((y & 1) * 2 + (x & 1) == cc && sc[j] < cur[j]) gq[j] = cand[j];
        if (++x == gwid) x = 0, ++y;
      }
      gs_scores(B, E, P, L, gq, cur);
    }
}

// Block error of texel weights w64 (all 4 channels, per channel a fold
// over texels, then over channels): one pass over the texels, each
// texel's partition and weight read once for its four channel folds.
template <int MT, int PD>
__device__ __noinline__ float eval_exact(const Blk<MT, PD>& B, const Ends& E, const Part<MT> P,
                                         const uint8_t* w64) {
  float s[4];
  for (int t = 0; t < B.T; ++t) {
    const int p = part_of(P, t), w = w64[t];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d0 = c < E.nche ? E.d0[p][c] : 255, d1 = c < E.nche ? E.d1[p][c] : 255;
      const float x = sq(dec8(d0, d1, w) - B.px[c][t]);
      s[c] = t == 0 ? x : s[c] + x;
    }
  }
  return ((s[0] + s[1]) + s[2]) + s[3];
}

// ---------------------------------------------------------------------------
// Fits
// ---------------------------------------------------------------------------

template <int MT>
struct Fit {
  uint8_t q0[4][4], q1[4][4];  // [partition][channel] ISE colour values
  uint8_t gq[max_grid(MT)];    // grid weights (plane-interleaved when dual)
  float err;
};

// Single- or multi-partition fit of layout L (_fit_1part / _fit_2part).
template <int MT, int PD>
__device__ __noinline__ void fit_parts(const Blk<MT, PD>& B, const Lay& L, const Part<MT> P, int nparts,
                                       int iters, Fit<MT>& best) {
  const int T = B.T;
  const bool luma = L.cem == 0 || L.cem == 4;
  Chans C;
  C.cem = L.cem;
  C.n = fit_nch(L.cem);
  for (int k = 0; k < 4; ++k) C.idx[k] = -1;
  const int nch = C.n;
  float s0[4][4], s1[4][4];
  for (int p = 0; p < nparts; ++p) {
    pca_seed(B, C, P, p, s0[p], s1[p]);
    if (!luma) orient(s0[p], s1[p], nch);
  }
  uint8_t gq[MT], unq[MT], best_unq[MT];
  float tw[MT];
  int all_ch[4] = {0, 1, 2, 3};
  const int n_it = iters < 1 ? 1 : iters;
  for (int it = 0; it < n_it; ++it) {
    Fit<MT> cand;
    Ends E;
    uint8_t dq0[4][4], dq1[4][4];
    for (int p = 0; p < nparts; ++p) {
      for (int c = 0; c < nch; ++c) {
        quant_color(L, s0[p][c], cand.q0[p][c], dq0[p][c]);
        quant_color(L, s1[p][c], cand.q1[p][c], dq1[p][c]);
      }
      if (!luma && (dq0[p][0] + dq0[p][1]) + dq0[p][2] > (dq1[p][0] + dq1[p][1]) + dq1[p][2]) {
        for (int c = 0; c < nch; ++c) {
          int x = cand.q0[p][c];
          cand.q0[p][c] = cand.q1[p][c];
          cand.q1[p][c] = x;
          x = dq0[p][c];
          dq0[p][c] = dq1[p][c];
          dq1[p][c] = x;
        }
      }
      if (L.cem == 0 || L.cem == 4) {
        for (int c = 0; c < 3; ++c) {
          E.d0[p][c] = dq0[p][0];
          E.d1[p][c] = dq1[p][0];
        }
        E.d0[p][3] = L.cem == 4 ? dq0[p][1] : 255;
        E.d1[p][3] = L.cem == 4 ? dq1[p][1] : 255;
      } else {
        for (int c = 0; c < 4; ++c) {
          E.d0[p][c] = c < nch ? dq0[p][c] : 255;
          E.d1[p][c] = c < nch ? dq1[p][c] : 255;
        }
      }
    }
    E.nche = (L.cem == 0 || L.cem == 8) ? 3 : 4;
    if (L.pinv == nullptr) {
      wquant_exact(B, E, P, all_ch, E.nche, L, gq, unq);
    } else {
      for (int t = 0; t < T; ++t) {
        const int p = part_of(P, t);
        float denom = 0.0f, proj = 0.0f;
        for (int c = 0; c < nch; ++c) {
          const float d0 = (float)dq0[p][c];
          const float df = (float)dq1[p][c] - d0;
          denom = c == 0 ? df * df : denom + df * df;
          const float pr = (pxf(B, L.cem, c, t) - d0) * df;
          proj = c == 0 ? pr : proj + pr;
        }
        denom = denom + 1e-6f;
        tw[t] = clampf(proj / denom, 0.0f, 1.0f);
      }
      grid_quant(L, T, tw, gq, unq);
      if constexpr (MT > 64) {
        if (T > 64) {
          gs_refine(B, E, P, L, gq);
          infill(L, T, gq, unq);
        }
      }
    }
    cand.err = eval_exact(B, E, P, unq);
    const int ng = L.pinv == nullptr ? T : L.g;
    // A candidate not taken leaves best_unq as it was, so every later round
    // would make the same endpoints and the same candidate again.
    if (it > 0 && !(cand.err < best.err)) break;
    for (int p = 0; p < nparts; ++p)
      for (int c = 0; c < nch; ++c) {
        best.q0[p][c] = cand.q0[p][c];
        best.q1[p][c] = cand.q1[p][c];
      }
    for (int j = 0; j < ng; ++j) best.gq[j] = gq[j];
    for (int t = 0; t < T; ++t) best_unq[t] = unq[t];
    best.err = cand.err;
    if (it + 1 < n_it) {
      for (int t = 0; t < T; ++t) tw[t] = (float)best_unq[t] / 64.0f;
      for (int p = 0; p < nparts; ++p) {
        lsq(B, C, tw, P, p, s0[p], s1[p]);
        if (!luma) orient(s0[p], s1[p], nch);
      }
    }
  }
}

// Single-partition dual-plane fit: plane 0 drives the channels other than
// ccs, plane 1 drives ccs (_fit_dual).
template <int MT, int PD>
__device__ __noinline__ void fit_dual(const Blk<MT, PD>& B, const Lay& L, int ccs, int iters, Fit<MT>& best) {
  const int T = B.T;
  const Part<MT> whole = whole_part<MT>();
  const int nch = L.cem == 12 ? 4 : 3;
  Chans R, A;
  R.cem = A.cem = L.cem;
  R.n = 0;
  for (int c = 0; c < nch; ++c)
    if (c != ccs) R.idx[R.n++] = c;
  A.n = 1;
  A.idx[0] = ccs;
  float r0[4], r1[4];
  pca_seed(B, R, whole, 0, r0, r1);
  float lo = B.px[ccs][0], hi = B.px[ccs][0];
  for (int t = 1; t < T; ++t) {
    lo = fminf(lo, B.px[ccs][t]);
    hi = fmaxf(hi, B.px[ccs][t]);
  }
  float e0[4], e1[4];
  for (int k = 0; k < R.n; ++k) {
    e0[R.idx[k]] = r0[k];
    e1[R.idx[k]] = r1[k];
  }
  e0[ccs] = lo;
  e1[ccs] = hi;
  orient(e0, e1, nch);
  uint8_t gq0[MT], unq0[MT], gq1[MT], unq1[MT], b0[MT], b1[MT];
  float tw[MT];
  const int n_it = iters < 1 ? 1 : iters;
  for (int it = 0; it < n_it; ++it) {
    Fit<MT> cand;
    Ends E;
    for (int c = 0; c < nch; ++c) {
      quant_color(L, e0[c], cand.q0[0][c], E.d0[0][c]);
      quant_color(L, e1[c], cand.q1[0][c], E.d1[0][c]);
    }
    if ((E.d0[0][0] + E.d0[0][1]) + E.d0[0][2] > (E.d1[0][0] + E.d1[0][1]) + E.d1[0][2]) {
      for (int c = 0; c < nch; ++c) {
        int x = cand.q0[0][c];
        cand.q0[0][c] = cand.q1[0][c];
        cand.q1[0][c] = x;
        x = E.d0[0][c];
        E.d0[0][c] = E.d1[0][c];
        E.d1[0][c] = x;
      }
    }
    for (int c = nch; c < 4; ++c) E.d0[0][c] = E.d1[0][c] = 255;
    E.nche = nch;
    if (L.pinv == nullptr) {
      wquant_exact(B, E, whole, R.idx, R.n, L, gq0, unq0);
      wquant_exact(B, E, whole, A.idx, 1, L, gq1, unq1);
    } else {
      for (int t = 0; t < T; ++t) {
        float denom = 0.0f, proj = 0.0f;
        for (int k = 0; k < R.n; ++k) {
          const int c = R.idx[k];
          const float df = (float)(E.d1[0][c] - E.d0[0][c]);
          denom = k == 0 ? df * df : denom + df * df;
          const float pr = (B.px[c][t] - (float)E.d0[0][c]) * df;
          proj = k == 0 ? pr : proj + pr;
        }
        denom = denom + 1e-6f;
        tw[t] = clampf(proj / denom, 0.0f, 1.0f);
      }
      grid_quant(L, T, tw, gq0, unq0);
      const float da = (float)(E.d1[0][ccs] - E.d0[0][ccs]);
      const float dasafe = fabsf(da) > 1e-6f ? da : 1.0f;
      for (int t = 0; t < T; ++t)
        tw[t] = clampf((B.px[ccs][t] - (float)E.d0[0][ccs]) / dasafe, 0.0f, 1.0f);
      grid_quant(L, T, tw, gq1, unq1);
    }
    float err = 0.0f;
    for (int c = 0; c < 4; ++c) {
      const uint8_t* w = c == ccs ? unq1 : unq0;
      float s = 0.0f;
      for (int t = 0; t < T; ++t) {
        const float x = sq(dec8(E.d0[0][c], E.d1[0][c], w[t]) - B.px[c][t]);
        s = t == 0 ? x : s + x;
      }
      err = c == 0 ? s : err + s;
    }
    // A candidate not taken leaves b0 and b1 as they were: every later round
    // would repeat it (as fit_parts).
    if (it > 0 && !(err < best.err)) break;
    for (int c = 0; c < nch; ++c) {
      best.q0[0][c] = cand.q0[0][c];
      best.q1[0][c] = cand.q1[0][c];
    }
    for (int j = 0; j < L.g; ++j) {
      best.gq[2 * j] = gq0[j];
      best.gq[2 * j + 1] = gq1[j];
    }
    for (int t = 0; t < T; ++t) {
      b0[t] = unq0[t];
      b1[t] = unq1[t];
    }
    best.err = err;
    if (it + 1 < n_it) {
      float w0[MT];
      for (int t = 0; t < T; ++t) {
        w0[t] = (float)b0[t] / 64.0f;
        tw[t] = (float)b1[t] / 64.0f;
      }
      float x0[4], x1[4], a0[4], a1[4];
      lsq(B, R, w0, whole, 0, x0, x1);
      lsq(B, A, tw, whole, 0, a0, a1);
      for (int k = 0; k < R.n; ++k) {
        e0[R.idx[k]] = x0[k];
        e1[R.idx[k]] = x1[k];
      }
      e0[ccs] = a0[0];
      e1[ccs] = a1[0];
      orient(e0, e1, nch);
    }
  }
}

// ---------------------------------------------------------------------------
// Packing: ISE streams and block headers
// ---------------------------------------------------------------------------

struct Bits {
  uint32_t w[4];
  int pos;
  int start;
  bool reverse;
  __device__ void put(uint32_t v, int nbits, int total) {
    for (int j = 0; j < nbits && pos < total; ++j, ++pos) {
      if ((v >> j) & 1u) {
        const int b = reverse ? 127 - pos : start + pos;
        w[b >> 5] |= 1u << (b & 31);
      }
    }
  }
};

// ISE of vals[0..n) (kind 0 bits / 1 trits / 2 quints, b plain bits).
__device__ __noinline__ void pack_ise(const int* d, uint32_t words[4], const uint8_t* vals, int n, int kind, int b,
                         int start, bool reverse) {
  Bits S;
  S.w[0] = S.w[1] = S.w[2] = S.w[3] = 0u;
  S.pos = 0;
  S.start = start;
  S.reverse = reverse;
  if (kind == 0) {
    const int total = n * b;
    for (int i = 0; i < n; ++i) S.put((uint32_t)vals[i], b, total);
  } else {
    const int per = kind == 1 ? 5 : 3;
    const int radix = kind == 1 ? 3 : 5;
    const int total = kind == 1 ? (8 * n + 4) / 5 + n * b : (7 * n + 2) / 3 + n * b;
    const int* pack = d + (kind == 1 ? d[H_OFF_TRIT] : d[H_OFF_QUINT]);
    for (int g = 0; g * per < n; ++g) {
      int idx = 0;
      for (int k = 0; k < per; ++k) {
        const int i = g * per + k;
        idx = idx * radix + (i < n ? vals[i] >> b : 0);
      }
      const uint32_t pk = (uint32_t)pack[idx];
      for (int k = 0; k < per; ++k) {
        const int i = g * per + k;
        S.put(i < n ? (uint32_t)vals[i] & ((1u << b) - 1u) : 0u, b, total);
        const int lo = kind == 1 ? c_trit_lo[k] : c_quint_lo[k];
        const int wd = kind == 1 ? c_trit_w[k] : c_quint_w[k];
        S.put(pk >> lo, wd, total);
      }
    }
  }
  for (int k = 0; k < 4; ++k) words[k] |= S.w[k];
}

// Words of a fit: 1 partition (with the dual plane's CCS) or several
// (same CEM, partition seed `seed`).
template <int MT>
__device__ __noinline__ void pack_fit(const int* d, const Lay& L, const Fit<MT>& F, int ccs, int seed,
                                      uint32_t words[4]) {
  words[0] = words[1] = words[2] = words[3] = 0u;
  const int vpe = (L.cem >> 2) + 1;  // values per endpoint
  uint8_t cols[18];
  int n = 0;
  if (L.nparts == 1) {
    words[0] |= (uint32_t)(L.mode | (L.cem << 13));
  } else {
    words[0] |= (uint32_t)(L.mode | ((L.nparts - 1) << 11));
    words[0] |= (uint32_t)seed << 13;
    words[0] |= (uint32_t)(L.cem << 2) << 23;
  }
  for (int p = 0; p < L.nparts; ++p)
    for (int c = 0; c < vpe; ++c) {
      cols[n++] = F.q0[p][c];
      cols[n++] = F.q1[p][c];
    }
  pack_ise(d, words, cols, n, L.ckind, L.cb, L.header, false);
  const int nw = L.g * (L.dual ? 2 : 1);
  pack_ise(d, words, F.gq, nw, L.wkind, L.wb, 0, true);
  if (L.dual) {
    const int pos = 128 - L.wbits - 2;
    for (int k = 0; k < 2; ++k)
      if ((ccs >> k) & 1) words[(pos + k) >> 5] |= 1u << ((pos + k) & 31);
  }
}

// ---------------------------------------------------------------------------
// The kernel bodies
// ---------------------------------------------------------------------------

template <int MT, int PD>
__device__ bool is_gray(const int* d, const Blk<MT, PD>& B) {
  float m = 0.0f;
  for (int t = 0; t < B.T; ++t) {
    const float hi = fmaxf(fmaxf(B.px[0][t], B.px[1][t]), B.px[2][t]);
    const float lo = fminf(fminf(B.px[0][t], B.px[1][t]), B.px[2][t]);
    m = t == 0 ? hi - lo : fmaxf(m, hi - lo);
  }
  return m < bits_f(d[H_GRAY255]);
}

__device__ __forceinline__ void take_if(uint32_t w[4], float& e, const uint32_t lw[4], float le) {
  if (le < e) {
    for (int k = 0; k < 4; ++k) w[k] = lw[k];
    e = le;
  }
}

// Kernel A's void extent (its mean colour), the first candidate.
template <int MT, int PD>
__device__ __noinline__ void void_extent(const Blk<MT, PD>& B, uint32_t w[4], float& e) {
  const int T = B.T;
  const float inv = 1.0f / (float)T;
  int v16[4];
  e = 0.0f;
  for (int c = 0; c < 4; ++c) {
    float s = B.px[c][0];
    for (int t = 1; t < T; ++t) s = s + B.px[c][t];
    v16[c] = (int)clampf(rintf(s * inv * 257.0f), 0.0f, 65535.0f);
  }
  for (int c = 0; c < 4; ++c) {
    const float dv = (float)(v16[c] >> 8);
    float s = sq(dv - B.px[c][0]);
    for (int t = 1; t < T; ++t) s = s + sq(dv - B.px[c][t]);
    e = c == 0 ? s : e + s;
  }
  e = e - 1e-3f;
  w[0] = (0x1FCu | (3u << 10)) | 0xFFFFF000u;
  w[1] = 0xFFFFFFFFu;
  w[2] = (uint32_t)(v16[0] | (v16[1] << 16));
  w[3] = (uint32_t)(v16[2] | (v16[3] << 16));
}

// Kernel A's task k: one of the NA 1-partition tasks (k < NA), else gray
// task k - NA (CEM 0/4); its words and error.
template <int MT, int PD>
__device__ __noinline__ float task_a(const int* d, const Blk<MT, PD>& B, int k, uint32_t w[4]) {
  const int na = d[H_NA];
  const int* task = k < na ? d + d[H_OFF_A] + 2 * k : d + d[H_OFF_AG] + 2 * (k - na);
  const Lay L = load_lay(d, task[0]);
  const int ccs = task[1];
  const int iters = L.cem == 12 ? d[H_ITERS12] : d[H_ITERS];
  Fit<MT> F;
  if (ccs < 0)
    fit_parts(B, L, whole_part<MT>(), 1, iters, F);
  else
    fit_dual(B, L, ccs, iters, F);
  pack_fit(d, L, F, ccs < 0 ? 0 : ccs, 0, w);
  return F.err;
}

// Masked sums of NP screen rows of nw words (rows m, m + nw, ...): per
// channel, four texel lanes (t mod 4) each folded in texel order from 0,
// added pairwise as (l0 + l1) + (l2 + l3).  Every texel is tested, so the
// lanes of a warp, each on its own rows, read the same texel at the same
// step (a shared-memory broadcast, four texels a load), once for all NP
// rows.
template <int MT, int NP>
__device__ __forceinline__ void lane_sums_n(const Blk<MT>& B, const int* m, int nw, float s[NP][4]) {
  const int T = MT == 16 ? 16 : B.T;
  float l[NP][4][4];
  for (int j = 0; j < NP; ++j)
    for (int c = 0; c < 4; ++c)
      for (int k = 0; k < 4; ++k) l[j][c][k] = 0.0f;
  for (int t0 = 0; t0 < T; t0 += 4) {
    uint32_t word[NP];
    for (int j = 0; j < NP; ++j) word[j] = (uint32_t)m[j * nw + (t0 >> 5)];
    float x[4][4];  // [channel][texel t0 + k]; past T: never added
    for (int c = 0; c < 4; ++c) {
#ifdef __CUDACC__
      const float4 v = *reinterpret_cast<const float4*>(&B.px[c][t0]);  // MT % 4 == 0
      x[c][0] = v.x;
      x[c][1] = v.y;
      x[c][2] = v.z;
      x[c][3] = v.w;
#else
      for (int k = 0; k < 4; ++k) x[c][k] = t0 + k < T ? B.px[c][t0 + k] : 0.0f;
#endif
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = t0 + k;
      if (t < T)
        for (int j = 0; j < NP; ++j)
          if ((word[j] >> (t & 31)) & 1u)
            for (int c = 0; c < 4; ++c) l[j][c][k] = l[j][c][k] + x[c][k];
    }
  }
  for (int j = 0; j < NP; ++j)
    for (int c = 0; c < 4; ++c) s[j][c] = (l[j][c][0] + l[j][c][1]) + (l[j][c][2] + l[j][c][3]);
}

__device__ __forceinline__ float popf(const int* mask, int nw) {
  int n = 0;
  for (int k = 0; k < nw; ++k) n += __popc((unsigned)mask[k]);
  return (float)n;
}

// Insert (v, idx) into the ascending top-k list (ties keep the earlier).
__device__ __forceinline__ void topk_insert(float* vs, int* ids, int& cnt, int k, float v, int idx) {
  if (cnt == k && !(v < vs[k - 1])) return;
  int pos = cnt < k ? cnt : k - 1;
  while (pos > 0 && v < vs[pos - 1]) {
    vs[pos] = vs[pos - 1];
    ids[pos] = ids[pos - 1];
    --pos;
  }
  vs[pos] = v;
  ids[pos] = idx;
  if (cnt < k) ++cnt;
}

// Continuous-SSE estimate of a 2-partition split (subset 0, then 1).
// Each sum is a fold in texel order; the folds of one pass over the texels
// share the texel's membership and centred values, made once.
template <int MT, int PD>
__device__ __noinline__ float cont_sse(const Blk<MT, PD>& B, const Part<MT> P) {
  const int T = B.T;
  float tot = 0.0f;
  for (int p = 0; p < 2; ++p) {
    float cnt = 0.0f, s[4];
    for (int t = 0; t < T; ++t) {
      const float m = memb(P, p, t);
      cnt = t == 0 ? m : cnt + m;
      for (int c = 0; c < 4; ++c) {
        const float x = B.px[c][t] * m;
        s[c] = t == 0 ? x : s[c] + x;
      }
    }
    cnt = cnt + 1e-6f;
    float mean[4];
    for (int c = 0; c < 4; ++c) mean[c] = s[c] / cnt;
    float cov[4][4];
    for (int t = 0; t < T; ++t) {
      const float m = memb(P, p, t);
      float xc[4];
      for (int c = 0; c < 4; ++c) xc[c] = (B.px[c][t] - mean[c]) * m;
      for (int a = 0; a < 4; ++a)
        for (int b = a; b < 4; ++b) {
          const float x = xc[a] * xc[b];
          cov[a][b] = t == 0 ? x : cov[a][b] + x;
        }
    }
    for (int a = 0; a < 4; ++a)
      for (int b = 0; b < a; ++b) cov[a][b] = cov[b][a];
    float v[4];
    power3(cov, 4, v);
    float e1 = 0.0f, e2 = 0.0f;
    for (int t = 0; t < T; ++t) {
      const float m = memb(P, p, t);
      float cc = 0.0f, pr = 0.0f;
      for (int c = 0; c < 4; ++c) {
        const float x = (B.px[c][t] - mean[c]) * m;
        cc = c == 0 ? x * x : cc + x * x;
        pr = c == 0 ? x * v[c] : pr + x * v[c];
      }
      e1 = t == 0 ? cc : e1 + cc;
      e2 = t == 0 ? pr * pr : e2 + pr * pr;
    }
    tot = p == 0 ? e1 - e2 : tot + (e1 - e2);
  }
  return tot;
}

// Per block, the `keep` seeds of least estimate, the first of equals first.
__device__ void rank_keep(const int* seeds, const float* ests, int k, int keep, int* out) {
  bool chosen[kMaxTopK];
  for (int i = 0; i < k; ++i) chosen[i] = false;
  for (int r = 0; r < keep; ++r) {
    int bi = 0;
    float be = chosen[0] ? kInf : ests[0];
    for (int i = 1; i < k; ++i) {
      const float ee = chosen[i] ? kInf : ests[i];
      if (ee < be) {
        bi = i;
        be = ee;
      }
    }
    out[r] = seeds[bi];
    chosen[bi] = true;
  }
}

template <int MT, int PD>
__device__ void screen_totals(const Blk<MT, PD>& B, float& sq_all, float s_all[4]) {
  for (int t = 0; t < B.T; ++t) {
    const float x = ((B.px[0][t] * B.px[0][t] + B.px[1][t] * B.px[1][t]) + B.px[2][t] * B.px[2][t]) +
                    B.px[3][t] * B.px[3][t];
    sq_all = t == 0 ? x : sq_all + x;
  }
  for (int c = 0; c < 4; ++c) {
    float s = B.px[c][0];
    for (int t = 1; t < B.T; ++t) s = s + B.px[c][t];
    s_all[c] = s;
  }
}

// Kernel B's screen estimate from the masked sums s1 of partition 1 (ns
// texels): the block's SSE less what the two partition means explain;
// invalid (a partition under one texel) is infinite.
__device__ __forceinline__ float screen_b_est(const float s1[4], float ns, float tf, float sq_all,
                                              const float s_all[4]) {
  const float n1 = ns + 1e-6f, n0 = (tf - ns) + 1e-6f;
  float a = s1[0] * s1[0], b = sq(s_all[0] - s1[0]);
  for (int c = 1; c < 4; ++c) {
    a = a + s1[c] * s1[c];
    b = b + sq(s_all[c] - s1[c]);
  }
  float sse = sq_all - (a / n1 + b / n0);
  if (ns < 1.0f || ns > tf - 1.0f) sse = kInf;
  return sse;
}

// Estimate of kernel B's screen for the 2-partition pattern row m (one
// mask: partition 1).
template <int MT>
__device__ __forceinline__ float screen_b(const Blk<MT>& B, const int* m, int nw, float sq_all,
                                          const float s_all[4]) {
  float sp[1][4];
  lane_sums_n<MT, 1>(B, m, nw, sp);
  return screen_b_est(sp[0], popf(m, nw), (float)B.T, sq_all, s_all);
}

// The same at 4x4 with the block's 64 texels in registers (x), read once
// for all its patterns: lane_sums_n's four texel lanes, in its order.
__device__ __forceinline__ float screen_b16(const float (&x)[4][16], uint32_t m, float sq_all,
                                            const float s_all[4]) {
  float l[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < 4; ++k) l[c][k] = 0.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t)
    if ((m >> t) & 1u)
#pragma unroll
      for (int c = 0; c < 4; ++c) l[c][t & 3] = l[c][t & 3] + x[c][t];
  float s1[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) s1[c] = (l[c][0] + l[c][1]) + (l[c][2] + l[c][3]);
  return screen_b_est(s1, (float)__popc(m), 16.0f, sq_all, s_all);
}

// Kernel B at 4x4, a thread per block (its block staged in shared memory):
// 2-partition screen, top-k, rerank, CEM 8 (12) fits.
__device__ __noinline__ void body_b(const int* d, const Blk<16, 0>& B, uint32_t w[4], float& e) {
  constexpr int MT = 16;
  const int nw = d[H_NW], U = d[H_U2];
  const int* masks = d + d[H_OFF_P2];
  const int* smap = d + d[H_OFF_S2];
  float sq_all, s_all[4];
  screen_totals(B, sq_all, s_all);
  const int topk = d[H_TOPK2], keep = d[H_KEEP2];
  float vs[kMaxTopK];
  int ids[kMaxTopK], cnt = 0;
  float x[4][16];  // the texels in registers for the screen's 438 patterns (one mask word each)
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int t = 0; t < 16; ++t) x[c][t] = B.px[c][t];
  for (int u = 0; u < U; ++u)
    topk_insert(vs, ids, cnt, topk, screen_b16(x, (uint32_t)masks[u], sq_all, s_all), u);
  int seeds[kMaxTopK];
  int nseeds = topk;
  if (topk > keep) {
    float ests[kMaxTopK];
    for (int i = 0; i < topk; ++i) ests[i] = cont_sse(B, make_part<MT>(masks + ids[i] * nw, 1, nw));
    rank_keep(ids, ests, topk, keep, seeds);
    nseeds = keep;
  } else {
    for (int i = 0; i < topk; ++i) seeds[i] = ids[i];
  }
  const int iters = d[H_P2ITERS];
  const int* lays = d + d[H_OFF_B];
  bool first = true;
  for (int i = 0; i < nseeds; ++i) {
    const Part<MT> P = make_part<MT>(masks + seeds[i] * nw, 1, nw);
    for (int li = 0; li < d[H_NB]; ++li) {
      const Lay L = load_lay(d, lays[li]);
      Fit<MT> F;
      fit_parts(B, L, P, 2, iters, F);
      uint32_t lw[4];
      pack_fit(d, L, F, 0, smap[seeds[i]], lw);
      if (first) {
        for (int k = 0; k < 4; ++k) w[k] = lw[k];
        e = F.err;
        first = false;
      } else {
        take_if(w, e, lw, F.err);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Kernels B, C and D: a warp per group of blocks
// ---------------------------------------------------------------------------

// Estimate of kernel C's screen for the 3-partition pattern row m (two
// masks: partitions 1 and 2).
template <int MT>
__device__ __forceinline__ float screen_c(const Blk<MT>& B, const int* m, int nw, float sq_all,
                                          const float s_all[4]) {
  const float tf = (float)B.T;
  const float n1 = popf(m, nw), n2 = popf(m + nw, nw);
  float sp[2][4];
  lane_sums_n<MT, 2>(B, m, nw, sp);
  const float* s1 = sp[0];
  const float* s2 = sp[1];
  const float n0 = (tf - n1) - n2;
  float a = sq((s_all[0] - s1[0]) - s2[0]), b = s1[0] * s1[0], c2 = s2[0] * s2[0];
  for (int c = 1; c < 4; ++c) {
    a = a + sq((s_all[c] - s1[c]) - s2[c]);
    b = b + s1[c] * s1[c];
    c2 = c2 + s2[c] * s2[c];
  }
  float sse = sq_all - ((a / fmaxf(n0, 1.0f) + b / fmaxf(n1, 1.0f)) + c2 / fmaxf(n2, 1.0f));
  if (n0 < 1.0f || n1 < 1.0f || n2 < 1.0f) sse = kInf;
  return sse;
}

// Estimate of kernel D's luminance screen for the 4-partition seed row m
// (three masks: partitions 1..3).
template <int MT>
__device__ __forceinline__ float screen_d(const Blk<MT>& B, const int* m, int nw, float sq_all,
                                          const float s_all[4]) {
  const float tf = (float)B.T;
  float ns[3], sp[3][4];
  for (int j = 0; j < 3; ++j) ns[j] = popf(m + j * nw, nw);
  lane_sums_n<MT, 3>(B, m, nw, sp);
  const float n0 = ((tf - ns[0]) - ns[1]) - ns[2];
  float a = 0.0f;
  for (int c = 0; c < 4; ++c) {
    const float x = sq(((s_all[c] - sp[0][c]) - sp[1][c]) - sp[2][c]);
    a = c == 0 ? x : a + x;
  }
  float ex = a / fmaxf(n0, 1.0f);
  for (int j = 0; j < 3; ++j) {
    float s = sp[j][0] * sp[j][0];
    for (int c = 1; c < 4; ++c) s = s + sp[j][c] * sp[j][c];
    ex = ex + s / fmaxf(ns[j], 1.0f);
  }
  float sse = sq_all - ex;
  if (n0 < 1.0f || ns[0] < 1.0f || ns[1] < 1.0f || ns[2] < 1.0f) sse = kInf;
  return sse;
}

__device__ __forceinline__ uint32_t f_bits(float v) {
#ifdef __CUDACC__
  return __float_as_uint(v);
#else
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
#endif
}

// A screen entry as one integer that orders as (estimate, pattern): the
// float's bits made monotone (-0 folded into +0 first, so that equal
// estimates tie), then the pattern index.
__device__ __forceinline__ uint64_t sort_key(float v, int idx) {
  const uint32_t b = f_bits(v + 0.0f);
  const uint32_t o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((uint64_t)o << 32) | (uint32_t)idx;
}

// topk_insert on keys: the same list (the k least (estimate, pattern)
// pairs, ascending); a float compare only against the k-th estimate, the
// place found by key.
__device__ __forceinline__ void topk_insert_key(uint64_t* keys, float* vs, int& cnt, int k, float v,
                                                int idx) {
  if (cnt == k && !(v < vs[k - 1])) return;
  const uint64_t key = sort_key(v, idx);
  int pos = cnt < k ? cnt : k - 1;
  while (pos > 0 && key < keys[pos - 1]) {
    keys[pos] = keys[pos - 1];
    vs[pos] = vs[pos - 1];
    --pos;
  }
  keys[pos] = key;
  vs[pos] = v;
  if (cnt < k) ++cnt;
}

// Merge the ascending key list b[0..nb) into a[0..na), keeping the k least.
__device__ inline void merge_keys(uint64_t* a, int& na, const uint64_t* b, int nb, int k) {
  uint64_t out[kMaxTopK];
  int i = 0, j = 0, n = 0;
  while (n < k && (i < na || j < nb)) {
    if (j >= nb || (i < na && a[i] < b[j]))
      out[n++] = a[i++];
    else
      out[n++] = b[j++];
  }
  for (int x = 0; x < n; ++x) a[x] = out[x];
  na = n;
}

constexpr int kWarps = 4;           // warps per CTA of kernels B, C and D
constexpr int kGroupTexels = 512;   // at most this many texels of blocks per warp

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Per-block values of the warp body (32 bytes).
struct Head {
  float sq_all, s_all[4];
  int gray, pad[2];
};

// How a warp of kernel B (stage 1), C (2) or D (3) splits its work, and
// where its shared memory goes, from the descriptor header.  The final
// fits of a block are its seeds times `nlay` layouts, seed-major (B: kept
// seeds x its layouts, C: kept seeds x 1, D: 1 seed x its layouts).  G
// blocks a warp: as many as fill the 32 lanes with the final fits, at most
// kGroupTexels texels.
struct WarpPlan {
  int topk, keep, rerank, nlay, nfin, group, slots, mask_words, masks_bytes;
  int global_blk;  // B: the blocks' texels in device memory (a scratch), not shared memory
  int blk_off, head_off, ids_off, ests_off, seeds_off, errs_off, words_off, keys_off, cnt_off;
  int warp_bytes, smem_bytes;
};

template <int MT>
__host__ __device__ inline WarpPlan warp_plan(int stage, const int* h) {
  WarpPlan P;
  const int nw = h[H_NW];
  if (stage == 1) {
    P.topk = h[H_TOPK2];
    P.keep = h[H_KEEP2];
    P.rerank = P.topk > P.keep;
    P.nlay = h[H_NB];
    P.nfin = (P.rerank ? P.keep : P.topk) * P.nlay;
    P.mask_words = h[H_U2] * nw;
  } else if (stage == 2) {
    P.topk = h[H_TOPK3];
    P.keep = h[H_KEEP3];
    P.rerank = P.topk > P.keep;
    P.nlay = 1;
    P.nfin = P.rerank ? P.keep : P.topk;
    P.mask_words = h[H_U3] * 2 * nw;
  } else {
    P.topk = h[H_TOPK4];
    P.keep = 1;
    P.rerank = P.topk > 1;
    P.nlay = h[H_ND];
    P.nfin = h[H_ND];
    P.mask_words = 1024 * 3 * nw;
  }
  int g = 32 / (P.nfin > 1 ? P.nfin : 1);
  if (g > kGroupTexels / MT) g = kGroupTexels / MT;
  P.global_blk = 0;
  if (stage == 1) {
    // A block's final fits run one layout at a time, so G fills the lanes
    // with its kept seeds; the G blocks' texels then outgrow shared memory
    // and stay in device memory (L1).
    g = 32 / (P.nfin / P.nlay);
    P.global_blk = 1;
  }
  P.group = g > 1 ? g : 1;
  P.slots = P.topk > P.nfin ? P.topk : P.nfin;
  const int gs = P.group * P.slots;
  int off = 0;
  P.blk_off = off;
  off += P.global_blk ? 0 : P.group * (int)sizeof(Blk<MT>);
  P.head_off = off;
  off += align16(P.group * (int)sizeof(Head));
  P.ids_off = off;
  off += align16(gs * 4);
  P.ests_off = off;
  off += align16(gs * 4);
  P.seeds_off = off;
  off += align16(gs * 4);
  P.errs_off = off;
  off += align16(gs * 4);
  P.words_off = off;
  off += gs * 16;
  P.keys_off = off;
  off += 32 * P.topk * 8;
  P.cnt_off = off;
  off += 32 * 4;
  P.warp_bytes = align16(off);
  P.masks_bytes = align16(P.mask_words * 4);
  P.smem_bytes = P.masks_bytes + kWarps * P.warp_bytes;
  return P;
}

// One warp's shared memory.
template <int MT>
struct WarpMem {
  Blk<MT>* blk;
  Head* head;
  int *ids, *seeds, *cnt;
  float *ests, *errs;
  uint32_t* words;
  uint64_t* keys;
};

template <int MT>
__device__ inline WarpMem<MT> warp_mem(unsigned char* base, const WarpPlan& P, Blk<MT>* gblk) {
  WarpMem<MT> M;
  M.blk = P.global_blk ? gblk : (Blk<MT>*)(base + P.blk_off);
  M.head = (Head*)(base + P.head_off);
  M.ids = (int*)(base + P.ids_off);
  M.ests = (float*)(base + P.ests_off);
  M.seeds = (int*)(base + P.seeds_off);
  M.errs = (float*)(base + P.errs_off);
  M.words = (uint32_t*)(base + P.words_off);
  M.keys = (uint64_t*)(base + P.keys_off);
  M.cnt = (int*)(base + P.cnt_off);
  return M;
}

// Whether entry S at texel class MT runs the warp body (B above 4x4, C,
// D); else a thread per block.
__host__ __device__ constexpr bool warp_entry(int S, int MT) { return S >= 2 || (S == 1 && MT > 16); }

// The header field of stage S's pattern masks (B: 2-, C: 3-, D:
// 4-partition).
__host__ __device__ constexpr int mask_table(int S) {
  return S == 1 ? H_OFF_P2 : S == 2 ? H_OFF_P3 : H_OFF_P4;
}

// The lanes of a warp.  On the card each lane runs the body once, and
// WARP_SYNC orders the warp's shared memory between phases; in a CPU build
// the 32 lanes run one after another.  A phase's lanes share nothing but
// the warp's shared memory.
// FOR_WARPS and CTA_SYNC do the same for the nw warps of a CTA (entry A).
#ifdef __CUDACC__
#define FOR_LANES(lane) for (int lane = (int)(threadIdx.x & 31u), lane##_once = 1; lane##_once; lane##_once = 0)
#define WARP_SYNC() __syncwarp()
#define WARP_FENCE() __threadfence_block()
#define FOR_WARPS(warp, nw) for (int warp = (int)(threadIdx.x >> 5), warp##_once = 1; warp##_once; warp##_once = 0)
#define CTA_SYNC() __syncthreads()
#else
#define FOR_LANES(lane) for (int lane = 0; lane < 32; ++lane)
#define WARP_SYNC()
#define WARP_FENCE()
#define FOR_WARPS(warp, nw) for (int warp = 0; warp < (nw); ++warp)
#define CTA_SYNC()
#endif

// The k least (estimate, pattern) pairs of patterns 0 .. U-1, est(u) the
// estimate of pattern u, by one warp: lane j scores patterns j, j + 32, ...
// into its own ascending top-k (keys[j * k ..], cnt[j]), five levels of
// pairwise merges leave the k least in lane 0's list, and ids gets their
// patterns: the list the sequential scan of topk_insert gives (ties to the
// lowest pattern, infinite estimates ordered by pattern, fewer than k when
// U < k).
template <class Est>
__device__ void warp_topk(const Est& est, int U, int k, uint64_t* keys, int* cnt, int* ids) {
  FOR_LANES(lane) {
    uint64_t* mine = keys + lane * k;
    float vs[kMaxTopK];
    int c = 0;
    for (int u = lane; u < U; u += 32) topk_insert_key(mine, vs, c, k, est(u), u);
    cnt[lane] = c;
  }
  WARP_SYNC();
  for (int s = 1; s < 32; s *= 2) {
    FOR_LANES(lane) {
      if ((lane & (2 * s - 1)) == 0) merge_keys(keys + lane * k, cnt[lane], keys + (lane + s) * k, cnt[lane + s], k);
    }
    WARP_SYNC();
  }
  FOR_LANES(lane) {
    if (lane < cnt[0]) ids[lane] = (int)(uint32_t)keys[lane];
  }
  WARP_SYNC();
}

// Kernel B (S = 1: 2-partition screen over the distinct patterns, top-k,
// continuous-SSE rerank, CEM 8/12 fits of each kept seed and layout), C
// (S = 2: 3-partition screen, top-k, unrefined-fit rerank, CEM 8 fits) or
// D (S = 3: 4-partition luminance screen over all 1024 seeds and CEM 0/4
// fits, near-gray blocks only; other blocks get zero words, error inf) on
// blocks i0 .. i0 + ng - 1 by one warp.  masks: the entry's pattern masks
// (np a row), staged; ws: the warp's shared memory (WarpPlan); gblk: the
// group's texels in device memory where P.global_blk.
template <int S, int MT>
__device__ void encode_group(const int* d, const int* masks, const WarpPlan& P, const float* blocks,
                             long long i0, int ng, unsigned char* ws, Blk<MT>* gblk, uint32_t* out_w,
                             float* out_e) {
  const WarpMem<MT> M = warp_mem<MT>(ws, P, gblk);
  const int T = d[H_T], nw = d[H_NW];
  const int np = S;
  const int U = S == 1 ? d[H_U2] : S == 2 ? d[H_U3] : 1024;
  const int K = P.slots, k = P.topk;
  const int* lays = d + d[S == 1 ? H_OFF_B : S == 2 ? H_OFF_C : H_OFF_D];

  // Texels, read coalesced and scaled to clip(x, 0, 1) * 255; then each
  // block's gate and screen totals, a lane per block.
  FOR_LANES(lane) {
    const float* src = blocks + i0 * T * 4;
    for (int x = lane; x < ng * T * 4; x += 32) {
      const int b = x / (T * 4), r = x - b * (T * 4);
      M.blk[b].px[r & 3][r >> 2] = clampf(src[x], 0.0f, 1.0f) * 255.0f;
    }
    if (lane < ng) M.blk[lane].T = T;
  }
  WARP_FENCE();
  WARP_SYNC();
  FOR_LANES(lane) {
    for (int b = lane; b < ng; b += 32) {
      Head& h = M.head[b];
      h.gray = S < 3 ? 1 : (is_gray(d, M.blk[b]) ? 1 : 0);
      if (h.gray) screen_totals(M.blk[b], h.sq_all, h.s_all);
    }
  }
  WARP_SYNC();

  // The screen, block by block.
  for (int b = 0; b < ng; ++b) {
    if (!M.head[b].gray) continue;
    const Blk<MT>& B = M.blk[b];
    const Head& h = M.head[b];
    warp_topk(
        [&](int u) {
          const int* m = masks + u * np * nw;
          return S == 1   ? screen_b(B, m, nw, h.sq_all, h.s_all)
                 : S == 2 ? screen_c(B, m, nw, h.sq_all, h.s_all)
                          : screen_d(B, m, nw, h.sq_all, h.s_all);
        },
        U, k, M.keys, M.cnt, M.ids + b * K);
  }

  // The rerank, a lane per (block, candidate): B's continuous SSE, C's and
  // D's one-iteration fit.
  if (P.rerank) {
    FOR_LANES(lane) {
      for (int task = lane; task < ng * k; task += 32) {
        const int b = task / k, i = task - b * k;
        if (!M.head[b].gray) continue;
        const Part<MT> part = make_part<MT>(masks + M.ids[b * K + i] * np * nw, np, nw);
        if (S == 1) {
          M.ests[b * K + i] = cont_sse(M.blk[b], part);
        } else {
          const Lay L = load_lay(d, lays[0]);
          Fit<MT> F;
          fit_parts(M.blk[b], L, part, np + 1, 1, F);
          M.ests[b * K + i] = F.err;
        }
      }
    }
    WARP_SYNC();
  }

  // The seeds, a lane per block: B and C keep `keep` by rerank estimate, D
  // the first of least error.
  FOR_LANES(lane) {
    for (int b = lane; b < ng; b += 32) {
      if (!M.head[b].gray) continue;
      const int* ids = M.ids + b * K;
      const float* ests = M.ests + b * K;
      int* seeds = M.seeds + b * K;
      if (S < 3) {
        if (P.rerank) {
          rank_keep(ids, ests, k, P.keep, seeds);
        } else {
          for (int i = 0; i < k; ++i) seeds[i] = ids[i];
        }
      } else {
        int seed = ids[0];
        if (P.rerank) {
          float be = 0.0f;
          for (int i = 0; i < k; ++i)
            if (i == 0 || ests[i] < be) {
              seed = ids[i];
              be = ests[i];
            }
        }
        seeds[0] = seed;
      }
    }
  }
  WARP_SYNC();

  // The final fits, a lane each: one per kept seed and layout, slot j
  // seed-major (B: its layouts on each kept seed, C: one per kept seed, D:
  // one per layout on the block's seed).  B takes its tasks layout-major,
  // so that the warp's lanes fit one layout at a time.
  const int nseed = P.nfin / P.nlay;
  FOR_LANES(lane) {
    for (int task = lane; task < ng * P.nfin; task += 32) {
      int b, j;
      if (S == 1) {
        const int li = task / (ng * nseed), r = task - li * (ng * nseed);
        b = r / nseed;
        j = (r - b * nseed) * P.nlay + li;
      } else {
        b = task / P.nfin;
        j = task - b * P.nfin;
      }
      if (!M.head[b].gray) continue;
      const int seed = M.seeds[b * K + j / P.nlay];
      const Lay L = load_lay(d, lays[j % P.nlay]);
      Fit<MT> F;
      fit_parts(M.blk[b], L, make_part<MT>(masks + seed * np * nw, np, nw), np + 1,
                d[S == 1 ? H_P2ITERS : H_ITERS], F);
      const int id = S == 3 ? seed : d[d[S == 1 ? H_OFF_S2 : H_OFF_S3] + seed];
      pack_fit(d, L, F, 0, id, M.words + (b * K + j) * 4);
      M.errs[b * K + j] = F.err;
    }
  }
  WARP_SYNC();

  // The winner, a lane per block: the candidates in order, strict <.
  FOR_LANES(lane) {
    for (int b = lane; b < ng; b += 32) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      float e = kInf;
      if (M.head[b].gray && P.nfin > 0) {
        for (int x = 0; x < 4; ++x) w[x] = M.words[b * K * 4 + x];
        e = M.errs[b * K];
        for (int j = 1; j < P.nfin; ++j) take_if(w, e, M.words + (b * K + j) * 4, M.errs[b * K + j]);
      }
      for (int x = 0; x < 4; ++x) out_w[(i0 + b) * 4 + x] = w[x];
      out_e[i0 + b] = e;
    }
  }
  WARP_SYNC();
}

// ---------------------------------------------------------------------------
// Kernel A: a CTA per group of blocks, its warps sharing the group's tasks
// ---------------------------------------------------------------------------

constexpr int kAGroup = 32;    // blocks a CTA of entry A: one a lane
constexpr int kAMaxWarps = 8;  // warps a CTA of entry A

// A warp's best candidate for one block: words, error, and its index in
// the candidate order (-1: the void extent, then the tasks, the gray tasks
// last; nt: none yet).
struct ABest {
  uint32_t w[4];
  float e;
  int k;
};

// How a CTA of entry A splits its work: a warp per task of the NA that
// every block runs, up to kAMaxWarps (warp v takes tasks v, v + warps, ...,
// the gray tasks included, which run on near-gray blocks only), the
// group's texels, each warp's best per block and each block's near-gray
// flag in its dynamic shared memory.
struct APlan {
  int ntask, warps, best_off, gray_off, smem_bytes;
};

template <int MT>
__host__ __device__ inline APlan a_plan(const int* h) {
  APlan P;
  P.ntask = h[H_NA] + h[H_NAG];
  P.warps = h[H_NA] < 1 ? 1 : h[H_NA] > kAMaxWarps ? kAMaxWarps : h[H_NA];
  P.best_off = align16(kAGroup * (int)sizeof(Blk<MT, 0>));
  P.gray_off = P.best_off + P.warps * kAGroup * (int)sizeof(ABest);
  P.smem_bytes = P.gray_off + kAGroup * (int)sizeof(int);
  return P;
}

// Entry A (_kernel_a: the void extent, the 1-partition tasks, and CEM 0/4
// for a near-gray block; the first of least error) on blocks i0 .. i0 + ng
// - 1 (ng <= kAGroup) by the P.warps warps of a CTA.  The texels are
// staged once, coalesced, at an odd stride (Blk<MT, 0>); lane b of every
// warp then holds block b, and warp v runs tasks v, v + P.warps, ... of
// the list, so that the 32 lanes of a warp run one layout at a time; warp
// 0 also takes the void extent and, where there are gray tasks, tests
// each block for near-gray once for all warps.  Each warp keeps the first
// of least error among its own candidates, and lane b of warp 0 takes the
// least over the warps, ties to the earliest in the candidate order: the
// candidate that a scan in that order with strict < keeps.
template <int MT>
__device__ void encode_group_a(const int* d, const APlan& P, const float* blocks, long long i0, int ng,
                               unsigned char* smem, uint32_t* out_w, float* out_e) {
  Blk<MT, 0>* blk = (Blk<MT, 0>*)smem;
  ABest* best = (ABest*)(smem + P.best_off);
  int* gray = (int*)(smem + P.gray_off);
  const int T = d[H_T], na = d[H_NA], nt = P.ntask;
  FOR_WARPS(warp, P.warps) {
    FOR_LANES(lane) {
      const int tid = warp * 32 + lane, nth = P.warps * 32;
      const float* src = blocks + i0 * T * 4;
      for (int x = tid; x < ng * T * 4; x += nth) {
        const int b = x / (T * 4), r = x - b * (T * 4);
        blk[b].px[r & 3][r >> 2] = clampf(src[x], 0.0f, 1.0f) * 255.0f;
      }
      if (tid < ng) blk[tid].T = T;
    }
  }
  CTA_SYNC();
  if (nt > na) {
    FOR_WARPS(warp, P.warps) {
      FOR_LANES(lane) {
        if (warp == 0 && lane < ng) gray[lane] = is_gray(d, blk[lane]) ? 1 : 0;
      }
    }
    CTA_SYNC();
  }
  FOR_WARPS(warp, P.warps) {
    FOR_LANES(lane) {
      if (lane < ng) {
        const Blk<MT, 0>& B = blk[lane];
        ABest r = {{0u, 0u, 0u, 0u}, kInf, nt};
        if (warp == 0) {
          void_extent(B, r.w, r.e);
          r.k = -1;
        }
        const int n = nt > na && gray[lane] ? nt : na;
        for (int k = warp; k < n; k += P.warps) {
          uint32_t lw[4];
          const float le = task_a(d, B, k, lw);
          if (le < r.e) {
            for (int x = 0; x < 4; ++x) r.w[x] = lw[x];
            r.e = le;
            r.k = k;
          }
        }
        best[warp * kAGroup + lane] = r;
      }
    }
  }
  CTA_SYNC();
  FOR_WARPS(warp, P.warps) {
    FOR_LANES(lane) {
      if (warp == 0 && lane < ng) {
        ABest r = best[lane];
        for (int v = 1; v < P.warps; ++v) {
          const ABest& o = best[v * kAGroup + lane];
          if (o.e < r.e || (o.e == r.e && o.k < r.k)) r = o;
        }
        for (int x = 0; x < 4; ++x) out_w[(i0 + lane) * 4 + x] = r.w[x];
        out_e[i0 + lane] = r.e;
      }
    }
  }
}

// Thread tid's share of staging blocks i0 .. i0 + ng - 1 of B at 4x4 (a
// thread per block, kThreads a CTA): coalesced, scaled to clip(x, 0, 1) *
// 255, at an odd stride.
__device__ __forceinline__ void stage_b4x4(const float* blocks, long long i0, int ng, int tid,
                                           Blk<16, 0>* blk) {
  const float* src = blocks + i0 * 64;
  for (int x = tid; x < ng * 64; x += kThreads)
    blk[x >> 6].px[x & 3][(x & 63) >> 2] = clampf(src[x], 0.0f, 1.0f) * 255.0f;
  if (tid < ng) blk[tid].T = 16;
}

#ifndef __CUDACC__

// Entry `stage` (0..3 = a..d) on n blocks on the CPU, arrays sized by the
// texel class MT, as the card runs it: A and B at 4x4 block by block, B
// above 4x4, C and D through the warp body (its lanes one after another),
// groups of WarpPlan::group blocks.
template <int MT>
inline void encode_stage_t(int stage, const int* d, const float* blocks, int n, uint32_t* words,
                           float* err) {
  const int T = d[H_T];
  if (stage == 0) {
    const APlan P = a_plan<MT>(d);
    unsigned char* smem = (unsigned char*)aligned_alloc(16, align16(P.smem_bytes));
    for (int i0 = 0; i0 < n; i0 += kAGroup)
      encode_group_a<MT>(d, P, blocks, i0, n - i0 < kAGroup ? n - i0 : kAGroup, smem, words, err);
    free(smem);
    return;
  }
  if (!warp_entry(stage, MT)) {  // B at 4x4: each CTA's blocks staged, then its threads
    if constexpr (MT == 16) {
      Blk<MT, 0>* blk = new Blk<MT, 0>[kThreads];
      for (int i0 = 0; i0 < n; i0 += kThreads) {
        const int ng = n - i0 < kThreads ? n - i0 : kThreads;
        for (int tid = 0; tid < kThreads; ++tid) stage_b4x4(blocks, i0, ng, tid, blk);
        for (int tid = 0; tid < ng; ++tid) body_b(d, blk[tid], words + 4 * (i0 + tid), err[i0 + tid]);
      }
      delete[] blk;
    }
    return;
  }
  const WarpPlan P = warp_plan<MT>(stage, d);
  unsigned char* smem = (unsigned char*)aligned_alloc(16, P.masks_bytes + P.warp_bytes);
  Blk<MT>* gblk = new Blk<MT>[P.group];
  memcpy(smem, d + d[mask_table(stage)], (size_t)P.mask_words * 4);
  for (int i0 = 0; i0 < n; i0 += P.group) {
    const int ng = n - i0 < P.group ? n - i0 : P.group;
    unsigned char* ws = smem + P.masks_bytes;
    if (stage == 1)
      encode_group<1, MT>(d, (const int*)smem, P, blocks, i0, ng, ws, gblk, words, err);
    else if (stage == 2)
      encode_group<2, MT>(d, (const int*)smem, P, blocks, i0, ng, ws, gblk, words, err);
    else
      encode_group<3, MT>(d, (const int*)smem, P, blocks, i0, ng, ws, gblk, words, err);
  }
  delete[] gblk;
  free(smem);
}

// Entry `stage` on n blocks [n, T, 4] -> words [n, 4], errors [n].
inline void encode_stage(int stage, const int* d, const float* blocks, int n, uint32_t* words, float* err) {
  by_texel_class(d[H_T], [&](auto c) {
    encode_stage_t<decltype(c)::value>(stage, d, blocks, n, words, err);
  });
}

#endif  // !__CUDACC__

#ifdef __CUDACC__

// Entry B at 4x4 with a thread per block: the CTA's blocks staged once,
// coalesced, in shared memory at an odd stride.
__global__ void __launch_bounds__(kThreads)
    astc_b4x4_kernel(const float* __restrict__ blocks, const int* __restrict__ desc,
                     uint4* __restrict__ words, float* __restrict__ err, int n) {
  __shared__ Blk<16, 0> blk[kThreads];
  const long long i0 = (long long)blockIdx.x * kThreads;
  const int ng = n - i0 < kThreads ? (int)(n - i0) : kThreads;
  stage_b4x4(blocks, i0, ng, threadIdx.x, blk);
  __syncthreads();
  if ((int)threadIdx.x >= ng) return;
  uint32_t w[4];
  float e;
  body_b(desc, blk[threadIdx.x], w, e);
  words[i0 + threadIdx.x] = make_uint4(w[0], w[1], w[2], w[3]);
  err[i0 + threadIdx.x] = e;
}

// Entry A: a CTA per group of kAGroup blocks, a_plan's warps.  The bounds
// ask for 3 CTAs of 8 warps an SM at 4x4 (80 registers, 96 B of spills: 5 %
// faster than 126 registers there, 7-25 % slower above 4x4) and 2 above
// (at most 128 registers, so that two 8-warp CTAs fit).
template <int MT>
__global__ void __launch_bounds__(kAMaxWarps * 32, MT == 16 ? 3 : 2)
    astc_a_kernel(const float* __restrict__ blocks, const int* __restrict__ desc,
                  uint32_t* __restrict__ words, float* __restrict__ err, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const APlan P = a_plan<MT>(desc);
  const long long i0 = (long long)blockIdx.x * kAGroup;
  const int ng = n - i0 < kAGroup ? (int)(n - i0) : kAGroup;
  encode_group_a<MT>(desc, P, blocks, i0, ng, smem, words, err);
}

// Entries B above 4x4 (S = 1), C (S = 2) and D (S = 3): kWarps warps a CTA,
// a warp per group of blocks; the masks are staged once per CTA.
template <int S, int MT>
__global__ void __launch_bounds__(kWarps * 32)
    astc_warp_kernel(const float* __restrict__ blocks, const int* __restrict__ desc,
                     uint32_t* __restrict__ words, float* __restrict__ err, Blk<MT>* scratch, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WarpPlan P = warp_plan<MT>(S, desc);
  int* masks = (int*)smem;
  const int* src = desc + desc[mask_table(S)];
  for (int i = threadIdx.x; i < P.mask_words; i += blockDim.x) masks[i] = src[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const long long i0 = ((long long)blockIdx.x * kWarps + warp) * P.group;
  if (i0 >= n) return;
  const int ng = n - i0 < P.group ? (int)(n - i0) : P.group;
  encode_group<S, MT>(desc, masks, P, blocks, i0, ng, smem + P.masks_bytes + warp * P.warp_bytes,
                      P.global_blk ? scratch + i0 : nullptr, words, err);
}

// Raises the dynamic shared memory limit of the entry's kernel
// (astc_a_kernel<MT>, astc_warp_kernel<S, MT>) to `bytes` where it is above
// the default 48 KB: once per instance, device and size, since the limit
// stays set for later launches.  Static, so that each library (an earlier
// build loaded beside this one) keeps its own record for its own kernels.
template <int S, int MT>
static cudaError_t allow_smem(int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  static std::mutex mu;
  static int allowed[64] = {};  // per device
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < 64 && bytes <= allowed[dev]) return cudaSuccess;
  if constexpr (S == 0)
    rc = cudaFuncSetAttribute(astc_a_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  else
    rc = cudaFuncSetAttribute(astc_warp_kernel<S, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
  if (rc == cudaSuccess && dev < 64) allowed[dev] = bytes;
  return rc;
}

// Entry B at 4x4 asks for kB4x4Carveout % of each SM's unified L1 and
// shared memory as shared memory, the rest left to L1 for the fits' frames
// in local memory.  A sweep of 10-75 % on the card ran best at 60-75 %;
// the default, shared memory for as many 16.6 KB CTAs as the registers
// allow, left L1 too little and ran 1.2x slower at q4.
constexpr int kB4x4Carveout = 60;

template <int S, int MT>
int launch_mt(const void* blocks, const void* desc, const int* hdr, void* words, void* err,
              void* scratch, int n, cudaStream_t stream) {
  if constexpr (S == 0) {
    const APlan P = a_plan<MT>(hdr);
    const cudaError_t rc = allow_smem<S, MT>(P.smem_bytes);
    if (rc != cudaSuccess) return (int)rc;
    astc_a_kernel<MT><<<(unsigned)((n + kAGroup - 1) / kAGroup), P.warps * 32, P.smem_bytes,
                        stream>>>((const float*)blocks, (const int*)desc, (uint32_t*)words,
                                  (float*)err, n);
  } else if constexpr (!warp_entry(S, MT)) {  // B at 4x4
    const cudaError_t rc = cudaFuncSetAttribute(
        astc_b4x4_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, kB4x4Carveout);
    if (rc != cudaSuccess) return (int)rc;
    astc_b4x4_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        (const float*)blocks, (const int*)desc, (uint4*)words, (float*)err, n);
  } else {
    const WarpPlan P = warp_plan<MT>(S, hdr);
    const long long per_cta = (long long)kWarps * P.group;
    const cudaError_t rc = allow_smem<S, MT>(P.smem_bytes);
    if (rc != cudaSuccess) return (int)rc;
    astc_warp_kernel<S, MT><<<(unsigned)((n + per_cta - 1) / per_cta), kWarps * 32, P.smem_bytes,
                              stream>>>((const float*)blocks, (const int*)desc, (uint32_t*)words,
                                        (float*)err, (Blk<MT>*)scratch, n);
  }
  return (int)cudaGetLastError();
}

// The template instance of the block's texel class.
template <int S>
int launch(const void* blocks, const void* desc, const void* hdr, void* words, void* err,
           void* scratch, int n, void* stream) {
  if (n <= 0) return 0;
  const int T = ((const int*)hdr)[H_T];
  const cudaStream_t s = (cudaStream_t)stream;
  if (T < 16 || T > kMaxT) return (int)cudaErrorInvalidValue;
  return by_texel_class(T, [&](auto c) {
    return launch_mt<S, decltype(c)::value>(blocks, desc, (const int*)hdr, words, err, scratch, n,
                                            s);
  });
}

#endif  // __CUDACC__

}  // namespace astcx

#ifdef __CUDACC__

// Each launcher launches on `stream` and returns cudaGetLastError() (the
// launch is not synchronised).  blocks: [n, T, 4] float32; desc: the int32
// descriptor of astc_cuda.py:descriptor on the device, hdr: the same on
// the host (the launch reads its header); words: [n, 4] uint32; err: [n]
// float32; scratch: n times astc_warp_plan's scratch bytes a block of
// device memory (entry B above 16 texels), else unused.
extern "C" int astc_a_launch(const void* blocks, const void* desc, const void* hdr, void* words,
                             void* err, int n, void* stream, void* scratch) {
  return astcx::launch<0>(blocks, desc, hdr, words, err, scratch, n, stream);
}
extern "C" int astc_b_launch(const void* blocks, const void* desc, const void* hdr, void* words,
                             void* err, int n, void* stream, void* scratch) {
  return astcx::launch<1>(blocks, desc, hdr, words, err, scratch, n, stream);
}
extern "C" int astc_c_launch(const void* blocks, const void* desc, const void* hdr, void* words,
                             void* err, int n, void* stream, void* scratch) {
  return astcx::launch<2>(blocks, desc, hdr, words, err, scratch, n, stream);
}
extern "C" int astc_d_launch(const void* blocks, const void* desc, const void* hdr, void* words,
                             void* err, int n, void* stream, void* scratch) {
  return astcx::launch<3>(blocks, desc, hdr, words, err, scratch, n, stream);
}

// The plan of entry A (stage 0), B (1), C (2) or D (3) for the host
// descriptor hdr: out = {blocks a warp (A: a CTA), dynamic shared memory
// bytes a CTA, of it the staged masks, scratch bytes a block, warps a CTA};
// all 0 where the entry runs a thread per block (B at 4x4).
extern "C" void astc_warp_plan(int stage, const void* hdr, int* out) {
  const int* h = (const int*)hdr;
  astcx::by_texel_class(h[astcx::H_T], [&](auto c) {
    constexpr int MT = decltype(c)::value;
    if (stage == 0) {
      const astcx::APlan A = astcx::a_plan<MT>(h);
      out[0] = astcx::kAGroup;
      out[1] = A.smem_bytes;
      out[2] = out[3] = 0;
      out[4] = A.warps;
      return;
    }
    const bool warp = astcx::warp_entry(stage, MT);
    const astcx::WarpPlan P = astcx::warp_plan<MT>(stage, h);
    out[0] = warp ? P.group : 0;
    out[1] = warp ? P.smem_bytes : 0;
    out[2] = warp ? P.masks_bytes : 0;
    out[3] = warp && P.global_blk ? (int)sizeof(astcx::Blk<MT>) : 0;
    out[4] = warp ? astcx::kWarps : 0;
  });
}

#endif  // __CUDACC__
