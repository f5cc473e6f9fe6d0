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
// Design: one thread per ASTC block, 64 threads per CTA.  Pallas unrolled a
// Python loop over static layouts; here each entry loops over a descriptor
// table built on the host (astc_cuda.py:descriptor): layout records with
// their ISE ranges, the colour/weight LUTs, trit/quint pack tables, each
// decimated grid's infill, pseudo-inverse and footprint, and the partition
// patterns as texel bitmasks.  The TPU's one-hot matmul "gathers" are table
// loads; the partition screens are masked sums over the bitmask rows, the
// same rows for every thread of a warp at the same time.  The texels
// (4 x 144 floats at 12x12) and the per-texel weights live in the thread's
// local memory: a warp per block and shared-memory staging are later work.
//
// What bounds it: operations.  A block reads 64-576 bytes and writes 20,
// but a 4x4 block at quality 2 runs some twenty layout fits of several
// refinement rounds each and screens 438 partition patterns; at 12x12 a
// screen covers 144 texels per pattern.
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
#endif
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace astcx {

constexpr int kThreads = 64;
constexpr int kMaxT = 144;  // 12x12
constexpr int kMaxG = 64;   // weights of a grid (both planes of a dual one)
constexpr int kMaxTopK = 16;
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
  const int* a;        // [T][G] C.2.18 infill (16ths), or null for a full grid
  const int* pinv;     // [G][T] float32 bits
  const int* foot;     // [G][T] 0/1
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
    L.a = d + r[L_OFF_GRID];
    L.pinv = L.a + T * L.g;
    L.foot = L.pinv + L.g * T;
  } else {
    L.a = L.pinv = L.foot = nullptr;
  }
  return L;
}

// The block: texels clip(x, 0, 1) * 255, channel-major.
struct Blk {
  float px[4][kMaxT];
  int T;
};

// Fit-space channel c of texel t (CEM 0/4: luma, then alpha).
__device__ __forceinline__ float pxf(const Blk& B, int cem, int c, int t) {
  if (cem == 0 || cem == 4) {
    if (c == 0) return ((B.px[0][t] + B.px[1][t]) + B.px[2][t]) * kThird;
    return B.px[3][t];
  }
  return B.px[c][t];
}

__device__ __forceinline__ int fit_nch(int cem) {
  return cem == 0 ? 1 : cem == 4 ? 2 : cem == 12 ? 4 : 3;
}

// Membership mask of texel t in partition p (pid null: one partition).
__device__ __forceinline__ float memb(const uint8_t* pid, int p, int t) {
  return pid == nullptr ? 1.0f : (pid[t] == p ? 1.0f : 0.0f);
}

// Decoded byte of the exact decoder model (16-bit endpoint expansion,
// 64-weight interpolation, top byte).
__device__ __forceinline__ float dec8(int d0, int d1, int w) {
  const int c16 = (d0 * 257 * (64 - w) + d1 * 257 * w + 32) >> 6;
  return (float)(c16 >> 8);
}

__device__ __forceinline__ float sq(float x) { return x * x; }

// ---------------------------------------------------------------------------
// PCA seed, endpoint order, colour quantisation, least squares
// ---------------------------------------------------------------------------

__device__ float count_of(const Blk& B, const uint8_t* pid, int p) {
  if (pid == nullptr) return (float)B.T + 1e-6f;
  float s = memb(pid, p, 0);
  for (int t = 1; t < B.T; ++t) s = s + memb(pid, p, t);
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

__device__ __forceinline__ float chv(const Blk& B, const Chans& C, int k, int t) {
  return C.idx[k] < 0 ? pxf(B, C.cem, k, t) : B.px[C.idx[k]][t];
}

__device__ __noinline__ void pca_seed(const Blk& B, const Chans& C, const uint8_t* pid, int p, float e0[4],
                         float e1[4]) {
  const int T = B.T, chn = C.n;
  const float cnt = count_of(B, pid, p);
  float mean[4];
  for (int c = 0; c < chn; ++c) {
    float s = chv(B, C, c, 0) * memb(pid, p, 0);
    if (pid == nullptr) s = chv(B, C, c, 0);
    for (int t = 1; t < T; ++t) s = s + (pid == nullptr ? chv(B, C, c, t) : chv(B, C, c, t) * memb(pid, p, t));
    mean[c] = s / cnt;
  }
  float cov[4][4];
  for (int c = 0; c < chn; ++c)
    for (int d = c; d < chn; ++d) {
      float s = 0.0f;
      for (int t = 0; t < T; ++t) {
        const float m = memb(pid, p, t);
        const float a = pid == nullptr ? chv(B, C, c, t) - mean[c] : (chv(B, C, c, t) - mean[c]) * m;
        const float b = pid == nullptr ? chv(B, C, d, t) - mean[d] : (chv(B, C, d, t) - mean[d]) * m;
        s = t == 0 ? a * b : s + a * b;
      }
      cov[c][d] = cov[d][c] = s;
    }
  float v[4];
  power3(cov, chn, v);
  float tmax = -1e30f, tmin = 1e30f;
  for (int t = 0; t < T; ++t) {
    const float m = memb(pid, p, t);
    float tt = 0.0f;
    for (int c = 0; c < chn; ++c) {
      const float a = pid == nullptr ? chv(B, C, c, t) - mean[c] : (chv(B, C, c, t) - mean[c]) * m;
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

__device__ __forceinline__ void quant_color(const Lay& L, float e, int& q, int& d) {
  const int v = (int)clampf(rintf(e), 0.0f, 255.0f);
  if (L.cq == nullptr) {
    q = d = v;
  } else {
    q = L.cq[v];
    d = L.cd[v];
  }
}

// Least-squares endpoints for per-texel weights w (w = 1 -> e1).
__device__ __noinline__ void lsq(const Blk& B, const Chans& C, const float* w, const uint8_t* pid, int p,
                    float e0[4], float e1[4]) {
  const int T = B.T, chn = C.n;
  float a11 = 0, a12 = 0, a22 = 0, b1[4], b0[4], ms[4];
  for (int t = 0; t < T; ++t) {
    const float m = memb(pid, p, t);
    const float wv = pid == nullptr ? w[t] : w[t] * m;
    const float uv = pid == nullptr ? 1.0f - w[t] : (1.0f - w[t]) * m;
    const float x11 = wv * w[t], x12 = wv * (1.0f - w[t]), x22 = uv * (1.0f - w[t]);
    a11 = t == 0 ? x11 : a11 + x11;
    a12 = t == 0 ? x12 : a12 + x12;
    a22 = t == 0 ? x22 : a22 + x22;
    for (int c = 0; c < chn; ++c) {
      const float x = chv(B, C, c, t);
      const float y1 = wv * x, y0 = uv * x, ym = pid == nullptr ? x : x * m;
      b1[c] = t == 0 ? y1 : b1[c] + y1;
      b0[c] = t == 0 ? y0 : b0[c] + y0;
      ms[c] = t == 0 ? ym : ms[c] + ym;
    }
  }
  const float det = a11 * a22 - a12 * a12;
  const bool ok = fabsf(det) > 1e-6f;
  const float safe = ok ? det : 1.0f;
  const float cnt = count_of(B, pid, p);
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
  int d0[4][4], d1[4][4];  // [partition][channel]
  int nche;
};

__device__ __forceinline__ int part_of(const uint8_t* pid, int t) { return pid == nullptr ? 0 : pid[t]; }

__device__ __forceinline__ int e0c(const Ends& E, const uint8_t* pid, int c, int t) {
  return c < E.nche ? E.d0[part_of(pid, t)][c] : 255;
}
__device__ __forceinline__ int e1c(const Ends& E, const uint8_t* pid, int c, int t) {
  return c < E.nche ? E.d1[part_of(pid, t)][c] : 255;
}

// Texel error for weight w64 over the channels list chs[0..nc).
__device__ __forceinline__ float texel_werr(const Blk& B, const Ends& E, const uint8_t* pid,
                                            const int* chs, int nc, int t, int w64) {
  float e = 0.0f;
  for (int k = 0; k < nc; ++k) {
    const int c = chs[k];
    const float x = sq(dec8(e0c(E, pid, c, t), e1c(E, pid, c, t), w64) - B.px[c][t]);
    e = k == 0 ? x : e + x;
  }
  return e;
}

// Per-texel weight by exact decode error (full grids).
__device__ __noinline__ void wquant_exact(const Blk& B, const Ends& E, const uint8_t* pid, const int* chs,
                             int nc, const Lay& L, int* gq, int* unq) {
  const int T = B.T, levels = L.wlevels;
  for (int t = 0; t < T; ++t) {
    if (levels <= 8) {
      int bq = 0, bu = L.unq[0];
      float be = texel_werr(B, E, pid, chs, nc, t, bu);
      for (int q = 1; q < levels; ++q) {
        const int w = L.unq[q];
        const float e = texel_werr(B, E, pid, chs, nc, t, w);
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
    for (int k = 0; k < nc; ++k) {
      const int c = chs[k];
      const int d0 = e0c(E, pid, c, t), d1 = e1c(E, pid, c, t);
      const float df = (float)(d1 - d0);
      denom = k == 0 ? df * df : denom + df * df;
      const float pr = (B.px[c][t] - (float)d0) * df;
      proj = k == 0 ? pr : proj + pr;
    }
    denom = denom + 1e-6f;
    const float tt = clampf(proj / denom, 0.0f, 1.0f);
    const int w64 = (int)clampf(rintf(tt * 64.0f), 0.0f, 64.0f);
    int bq = L.wq[w64], bu = L.wu[w64];
    float be = texel_werr(B, E, pid, chs, nc, t, bu);
    const int g0 = bq;
    for (int dir = 0; dir < 2; ++dir) {
      const int cq = (dir == 0 ? L.up : L.dn)[g0];
      const int cu = L.unq[cq];
      const float e = texel_werr(B, E, pid, chs, nc, t, cu);
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

// C.2.18 infill of grid values gv (ISE values) -> per-texel w64.
__device__ void infill(const Lay& L, int T, const int* gv, int* w64) {
  for (int t = 0; t < T; ++t) {
    int s = 0;
    const int* row = L.a + t * L.g;
    for (int j = 0; j < L.g; ++j) s += row[j] * L.unq[gv[j]];
    w64[t] = (s + 8) >> 4;
  }
}

// Ideal texel weights tw -> grid ISE values gq[G] and texel weights w64[T].
__device__ __noinline__ void grid_quant(const Lay& L, int T, const float* tw, int* gq, int* w64) {
  if (L.a == nullptr) {
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
// its footprint texels (a left fold in texel order).
__device__ __noinline__ void gs_scores(const Blk& B, const Ends& E, const uint8_t* pid, const Lay& L,
                          const int* g, float* sc) {
  const int T = B.T;
  int w64[kMaxT];
  float err[kMaxT];
  infill(L, T, g, w64);
  for (int t = 0; t < T; ++t) {
    float e = 0.0f;
    for (int c = 0; c < 4; ++c) {
      const float x = sq(dec8(e0c(E, pid, c, t), e1c(E, pid, c, t), w64[t]) - B.px[c][t]);
      e = c == 0 ? x : e + x;
    }
    err[t] = e;
  }
  for (int j = 0; j < L.g; ++j) {
    const int* f = L.foot + j * T;
    float s = (float)f[0] * err[0];
    for (int t = 1; t < T; ++t) s = s + (float)f[t] * err[t];
    sc[j] = s;
  }
}

// One Gauss-Seidel pass over the four (gx%2, gy%2) checkerboard classes.
__device__ __noinline__ void gs_refine(const Blk& B, const Ends& E, const uint8_t* pid, const Lay& L, int* gq) {
  float cur[kMaxG], sc[kMaxG];
  int cand[kMaxG];
  gs_scores(B, E, pid, L, gq, cur);
  for (int cc = 0; cc < 4; ++cc)
    for (int dir = 0; dir < 2; ++dir) {
      const int* tab = dir == 0 ? L.up : L.dn;
      for (int j = 0; j < L.g; ++j) {
        const int cls = ((j / L.gw) % 2) * 2 + (j % L.gw) % 2;
        cand[j] = cls == cc ? tab[gq[j]] : gq[j];
      }
      gs_scores(B, E, pid, L, cand, sc);
      for (int j = 0; j < L.g; ++j) {
        const int cls = ((j / L.gw) % 2) * 2 + (j % L.gw) % 2;
        if (cls == cc && sc[j] < cur[j]) gq[j] = cand[j];
      }
      gs_scores(B, E, pid, L, gq, cur);
    }
}

// Block error of texel weights w64 (all 4 channels, per channel a fold
// over texels, then over channels).
__device__ __noinline__ float eval_exact(const Blk& B, const Ends& E, const uint8_t* pid, const int* w64) {
  float err = 0.0f;
  for (int c = 0; c < 4; ++c) {
    float s = 0.0f;
    for (int t = 0; t < B.T; ++t) {
      const float x = sq(dec8(e0c(E, pid, c, t), e1c(E, pid, c, t), w64[t]) - B.px[c][t]);
      s = t == 0 ? x : s + x;
    }
    err = c == 0 ? s : err + s;
  }
  return err;
}

// ---------------------------------------------------------------------------
// Fits
// ---------------------------------------------------------------------------

struct Fit {
  int q0[4][4], q1[4][4];  // [partition][channel] ISE colour values
  int gq[kMaxG];           // grid weights (plane-interleaved when dual)
  float err;
};

// Single- or multi-partition fit of layout L (_fit_1part / _fit_2part).
__device__ __noinline__ void fit_parts(const Blk& B, const Lay& L, const uint8_t* pid, int nparts, int iters,
                          Fit& best) {
  const int T = B.T;
  const bool luma = L.cem == 0 || L.cem == 4;
  Chans C;
  C.cem = L.cem;
  C.n = fit_nch(L.cem);
  for (int k = 0; k < 4; ++k) C.idx[k] = -1;
  const int nch = C.n;
  float s0[4][4], s1[4][4];
  for (int p = 0; p < nparts; ++p) {
    pca_seed(B, C, pid, p, s0[p], s1[p]);
    if (!luma) orient(s0[p], s1[p], nch);
  }
  int gq[kMaxT], unq[kMaxT], best_unq[kMaxT];
  float tw[kMaxT];
  int all_ch[4] = {0, 1, 2, 3};
  const int n_it = iters < 1 ? 1 : iters;
  for (int it = 0; it < n_it; ++it) {
    Fit cand;
    Ends E;
    int dq0[4][4], dq1[4][4];
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
    if (L.a == nullptr) {
      wquant_exact(B, E, pid, all_ch, E.nche, L, gq, unq);
    } else {
      for (int t = 0; t < T; ++t) {
        const int p = part_of(pid, t);
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
      if (T > 64) {
        gs_refine(B, E, pid, L, gq);
        infill(L, T, gq, unq);
      }
    }
    cand.err = eval_exact(B, E, pid, unq);
    const int ng = L.a == nullptr ? T : L.g;
    if (it == 0 || cand.err < best.err) {
      for (int p = 0; p < nparts; ++p)
        for (int c = 0; c < nch; ++c) {
          best.q0[p][c] = cand.q0[p][c];
          best.q1[p][c] = cand.q1[p][c];
        }
      for (int j = 0; j < ng; ++j) best.gq[j] = gq[j];
      for (int t = 0; t < T; ++t) best_unq[t] = unq[t];
      best.err = cand.err;
    }
    if (it + 1 < n_it) {
      for (int t = 0; t < T; ++t) tw[t] = (float)best_unq[t] / 64.0f;
      for (int p = 0; p < nparts; ++p) {
        lsq(B, C, tw, pid, p, s0[p], s1[p]);
        if (!luma) orient(s0[p], s1[p], nch);
      }
    }
  }
}

// Single-partition dual-plane fit: plane 0 drives the channels other than
// ccs, plane 1 drives ccs (_fit_dual).
__device__ __noinline__ void fit_dual(const Blk& B, const Lay& L, int ccs, int iters, Fit& best) {
  const int T = B.T;
  const int nch = L.cem == 12 ? 4 : 3;
  Chans R, A;
  R.cem = A.cem = L.cem;
  R.n = 0;
  for (int c = 0; c < nch; ++c)
    if (c != ccs) R.idx[R.n++] = c;
  A.n = 1;
  A.idx[0] = ccs;
  float r0[4], r1[4];
  pca_seed(B, R, nullptr, 0, r0, r1);
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
  int gq0[kMaxT], unq0[kMaxT], gq1[kMaxT], unq1[kMaxT], b0[kMaxT], b1[kMaxT];
  float tw[kMaxT];
  const int n_it = iters < 1 ? 1 : iters;
  for (int it = 0; it < n_it; ++it) {
    Fit cand;
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
    if (L.a == nullptr) {
      wquant_exact(B, E, nullptr, R.idx, R.n, L, gq0, unq0);
      wquant_exact(B, E, nullptr, A.idx, 1, L, gq1, unq1);
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
      const int* w = c == ccs ? unq1 : unq0;
      float s = 0.0f;
      for (int t = 0; t < T; ++t) {
        const float x = sq(dec8(E.d0[0][c], E.d1[0][c], w[t]) - B.px[c][t]);
        s = t == 0 ? x : s + x;
      }
      err = c == 0 ? s : err + s;
    }
    if (it == 0 || err < best.err) {
      for (int c = 0; c < nch; ++c) {
        best.q0[0][c] = cand.q0[0][c];
        best.q1[0][c] = cand.q1[0][c];
      }
      const int g = L.g;
      for (int j = 0; j < g; ++j) {
        best.gq[2 * j] = gq0[j];
        best.gq[2 * j + 1] = gq1[j];
      }
      for (int t = 0; t < T; ++t) {
        b0[t] = unq0[t];
        b1[t] = unq1[t];
      }
      best.err = err;
    }
    if (it + 1 < n_it) {
      float w0[kMaxT];
      for (int t = 0; t < T; ++t) {
        w0[t] = (float)b0[t] / 64.0f;
        tw[t] = (float)b1[t] / 64.0f;
      }
      float x0[4], x1[4], a0[4], a1[4];
      lsq(B, R, w0, nullptr, 0, x0, x1);
      lsq(B, A, tw, nullptr, 0, a0, a1);
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
__device__ __noinline__ void pack_ise(const int* d, uint32_t words[4], const int* vals, int n, int kind, int b,
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
__device__ __noinline__ void pack_fit(const int* d, const Lay& L, const Fit& F, int ccs, int seed,
                         uint32_t words[4]) {
  words[0] = words[1] = words[2] = words[3] = 0u;
  const int vpe = (L.cem >> 2) + 1;  // values per endpoint
  int cols[18];
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
// The four kernel bodies
// ---------------------------------------------------------------------------

__device__ void load_block(const float* src, int T, Blk& B) {
  B.T = T;
  for (int t = 0; t < T; ++t)
    for (int c = 0; c < 4; ++c) B.px[c][t] = clampf(src[t * 4 + c], 0.0f, 1.0f) * 255.0f;
}

__device__ bool is_gray(const int* d, const Blk& B) {
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

// Kernel A: void extent, then the 1-partition tasks (and CEM 0/4 for a
// near-gray block).
__device__ __noinline__ void body_a(const int* d, const Blk& B, uint32_t w[4], float& e) {
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
  const bool gray = d[H_NAG] > 0 && is_gray(d, B);
  for (int pass = 0; pass < 2; ++pass) {
    const int n = pass == 0 ? d[H_NA] : (gray ? d[H_NAG] : 0);
    const int* tasks = d + (pass == 0 ? d[H_OFF_A] : d[H_OFF_AG]);
    for (int k = 0; k < n; ++k) {
      const Lay L = load_lay(d, tasks[2 * k]);
      const int ccs = tasks[2 * k + 1];
      const int iters = L.cem == 12 ? d[H_ITERS12] : d[H_ITERS];
      Fit F;
      if (ccs < 0)
        fit_parts(B, L, nullptr, 1, iters, F);
      else
        fit_dual(B, L, ccs, iters, F);
      uint32_t lw[4];
      pack_fit(d, L, F, ccs < 0 ? 0 : ccs, 0, lw);
      take_if(w, e, lw, F.err);
    }
  }
}

// Masked sums of a screen row: four texel lanes (t mod 4), added pairwise.
__device__ __forceinline__ void lane_sums(const Blk& B, const int* mask, float s[4]) {
  for (int c = 0; c < 4; ++c) {
    float l[4];
    for (int k = 0; k < 4; ++k) {
      float a = 0.0f;
      for (int t = k; t < B.T; t += 4)
        if ((mask[t >> 5] >> (t & 31)) & 1) a = a + B.px[c][t];
      l[k] = a;
    }
    s[c] = (l[0] + l[1]) + (l[2] + l[3]);
  }
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

// Partition ids of row `row` of a table with np masks per row.
__device__ void pids_of(const int* masks, int row, int np, int nw, int T, uint8_t* pid) {
  const int* r = masks + row * np * nw;
  for (int t = 0; t < T; ++t) {
    int p = 0;
    for (int j = 0; j < np; ++j)
      if ((r[j * nw + (t >> 5)] >> (t & 31)) & 1) p = j + 1;
    pid[t] = (uint8_t)p;
  }
}

// Continuous-SSE estimate of a 2-partition split (subset 0, then 1).
__device__ __noinline__ float cont_sse(const Blk& B, const uint8_t* pid) {
  const int T = B.T;
  float tot = 0.0f;
  for (int p = 0; p < 2; ++p) {
    float cnt = memb(pid, p, 0);
    for (int t = 1; t < T; ++t) cnt = cnt + memb(pid, p, t);
    cnt = cnt + 1e-6f;
    float mean[4];
    for (int c = 0; c < 4; ++c) {
      float s = B.px[c][0] * memb(pid, p, 0);
      for (int t = 1; t < T; ++t) s = s + B.px[c][t] * memb(pid, p, t);
      mean[c] = s / cnt;
    }
    float cov[4][4];
    for (int a = 0; a < 4; ++a)
      for (int b = a; b < 4; ++b) {
        float s = 0.0f;
        for (int t = 0; t < T; ++t) {
          const float m = memb(pid, p, t);
          const float x = ((B.px[a][t] - mean[a]) * m) * ((B.px[b][t] - mean[b]) * m);
          s = t == 0 ? x : s + x;
        }
        cov[a][b] = cov[b][a] = s;
      }
    float v[4];
    power3(cov, 4, v);
    float e1 = 0.0f, e2 = 0.0f;
    for (int t = 0; t < T; ++t) {
      const float m = memb(pid, p, t);
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

__device__ void screen_totals(const Blk& B, float& sq_all, float s_all[4]) {
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

// Kernel B: 2-partition screen, top-k, rerank, CEM 8 (12) fits.
__device__ __noinline__ void body_b(const int* d, const Blk& B, uint32_t w[4], float& e) {
  const int T = B.T, nw = d[H_NW], U = d[H_U2];
  const float tf = (float)T;
  const int* masks = d + d[H_OFF_P2];
  const int* smap = d + d[H_OFF_S2];
  float sq_all, s_all[4];
  screen_totals(B, sq_all, s_all);
  const int topk = d[H_TOPK2], keep = d[H_KEEP2];
  float vs[kMaxTopK];
  int ids[kMaxTopK], cnt = 0;
  for (int u = 0; u < U; ++u) {
    const int* m = masks + u * nw;
    const float ns = popf(m, nw);
    float s1[4];
    lane_sums(B, m, s1);
    const float n1 = ns + 1e-6f, n0 = (tf - ns) + 1e-6f;
    float a = s1[0] * s1[0], b = sq(s_all[0] - s1[0]);
    for (int c = 1; c < 4; ++c) {
      a = a + s1[c] * s1[c];
      b = b + sq(s_all[c] - s1[c]);
    }
    float sse = sq_all - (a / n1 + b / n0);
    if (ns < 1.0f || ns > tf - 1.0f) sse = kInf;
    topk_insert(vs, ids, cnt, topk, sse, u);
  }
  int seeds[kMaxTopK];
  int nseeds = topk;
  uint8_t pid[kMaxT];
  if (topk > keep) {
    float ests[kMaxTopK];
    for (int i = 0; i < topk; ++i) {
      pids_of(masks, ids[i], 1, nw, T, pid);
      ests[i] = cont_sse(B, pid);
    }
    rank_keep(ids, ests, topk, keep, seeds);
    nseeds = keep;
  } else {
    for (int i = 0; i < topk; ++i) seeds[i] = ids[i];
  }
  const int iters = d[H_P2ITERS];
  const int* lays = d + d[H_OFF_B];
  bool first = true;
  for (int i = 0; i < nseeds; ++i) {
    pids_of(masks, seeds[i], 1, nw, T, pid);
    for (int li = 0; li < d[H_NB]; ++li) {
      const Lay L = load_lay(d, lays[li]);
      Fit F;
      fit_parts(B, L, pid, 2, iters, F);
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

// Kernel C: 3-partition screen, top-k, unrefined-fit rerank, CEM 8 fit.
__device__ __noinline__ void body_c(const int* d, const Blk& B, uint32_t w[4], float& e) {
  const int T = B.T, nw = d[H_NW], U = d[H_U3];
  const float tf = (float)T;
  const int* masks = d + d[H_OFF_P3];
  const int* smap = d + d[H_OFF_S3];
  float sq_all, s_all[4];
  screen_totals(B, sq_all, s_all);
  const int topk = d[H_TOPK3], keep = d[H_KEEP3];
  float vs[kMaxTopK];
  int ids[kMaxTopK], cnt = 0;
  for (int u = 0; u < U; ++u) {
    const int* m1 = masks + u * 2 * nw;
    const int* m2 = m1 + nw;
    const float n1 = popf(m1, nw), n2 = popf(m2, nw);
    float s1[4], s2[4];
    lane_sums(B, m1, s1);
    lane_sums(B, m2, s2);
    const float n0 = (tf - n1) - n2;
    float a = sq((s_all[0] - s1[0]) - s2[0]), b = s1[0] * s1[0], c2 = s2[0] * s2[0];
    for (int c = 1; c < 4; ++c) {
      a = a + sq((s_all[c] - s1[c]) - s2[c]);
      b = b + s1[c] * s1[c];
      c2 = c2 + s2[c] * s2[c];
    }
    float sse = sq_all - ((a / fmaxf(n0, 1.0f) + b / fmaxf(n1, 1.0f)) + c2 / fmaxf(n2, 1.0f));
    if (n0 < 1.0f || n1 < 1.0f || n2 < 1.0f) sse = kInf;
    topk_insert(vs, ids, cnt, topk, sse, u);
  }
  const Lay L = load_lay(d, d[d[H_OFF_C]]);
  int seeds[kMaxTopK];
  int nseeds = topk;
  uint8_t pid[kMaxT];
  if (topk > keep) {
    float ests[kMaxTopK];
    for (int i = 0; i < topk; ++i) {
      pids_of(masks, ids[i], 2, nw, T, pid);
      Fit F;
      fit_parts(B, L, pid, 3, 1, F);
      ests[i] = F.err;
    }
    rank_keep(ids, ests, topk, keep, seeds);
    nseeds = keep;
  } else {
    for (int i = 0; i < topk; ++i) seeds[i] = ids[i];
  }
  for (int i = 0; i < nseeds; ++i) {
    pids_of(masks, seeds[i], 2, nw, T, pid);
    Fit F;
    fit_parts(B, L, pid, 3, d[H_ITERS], F);
    uint32_t lw[4];
    pack_fit(d, L, F, 0, smap[seeds[i]], lw);
    if (i == 0) {
      for (int k = 0; k < 4; ++k) w[k] = lw[k];
      e = F.err;
    } else {
      take_if(w, e, lw, F.err);
    }
  }
}

// Kernel D: 4-partition luminance screen over all 1024 seeds and CEM 0/4
// fits, for a near-gray block only (other blocks: zero words, error inf).
__device__ __noinline__ void body_d(const int* d, const Blk& B, uint32_t w[4], float& e) {
  w[0] = w[1] = w[2] = w[3] = 0u;
  e = kInf;
  if (!is_gray(d, B)) return;
  const int T = B.T, nw = d[H_NW];
  const float tf = (float)T;
  const int* masks = d + d[H_OFF_P4];
  float sq_all, s_all[4];
  screen_totals(B, sq_all, s_all);
  const int topk = d[H_TOPK4];
  float vs[kMaxTopK];
  int ids[kMaxTopK], cnt = 0;
  for (int u = 0; u < 1024; ++u) {
    const int* m = masks + u * 3 * nw;
    float ns[3], sp[3][4];
    for (int j = 0; j < 3; ++j) {
      ns[j] = popf(m + j * nw, nw);
      lane_sums(B, m + j * nw, sp[j]);
    }
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
    topk_insert(vs, ids, cnt, topk, sse, u);
  }
  const int* lays = d + d[H_OFF_D];
  uint8_t pid[kMaxT];
  int seed = ids[0];
  if (topk > 1) {
    const Lay L0 = load_lay(d, lays[0]);
    float be = 0.0f;
    for (int i = 0; i < topk; ++i) {
      pids_of(masks, ids[i], 3, nw, T, pid);
      Fit F;
      fit_parts(B, L0, pid, 4, 1, F);
      if (i == 0 || F.err < be) {
        seed = ids[i];
        be = F.err;
      }
    }
  }
  pids_of(masks, seed, 3, nw, T, pid);
  for (int li = 0; li < d[H_ND]; ++li) {
    const Lay L = load_lay(d, lays[li]);
    Fit F;
    fit_parts(B, L, pid, 4, d[H_ITERS], F);
    uint32_t lw[4];
    pack_fit(d, L, F, 0, seed, lw);
    if (li == 0) {
      for (int k = 0; k < 4; ++k) w[k] = lw[k];
      e = F.err;
    } else {
      take_if(w, e, lw, F.err);
    }
  }
}

// One block through one entry (0..3 = a..d).
__device__ void encode_stage(int stage, const int* d, const float* src, uint32_t w[4], float& e) {
  Blk B;
  load_block(src, d[H_T], B);
  if (stage == 0)
    body_a(d, B, w, e);
  else if (stage == 1)
    body_b(d, B, w, e);
  else if (stage == 2)
    body_c(d, B, w, e);
  else
    body_d(d, B, w, e);
}

#ifdef __CUDACC__

template <int S>
__global__ void __launch_bounds__(kThreads)
    astc_kernel(const float* __restrict__ blocks, const int* __restrict__ desc,
                uint4* __restrict__ words, float* __restrict__ err, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int T = desc[H_T];
  uint32_t w[4];
  float e;
  encode_stage(S, desc, blocks + (size_t)i * T * 4, w, e);
  words[i] = make_uint4(w[0], w[1], w[2], w[3]);
  err[i] = e;
}

inline dim3 grid_for(int n) { return dim3((n + kThreads - 1) / kThreads); }

template <int S>
int launch(const void* blocks, const void* desc, void* words, void* err, int n, void* stream) {
  if (n <= 0) return 0;
  astc_kernel<S><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)blocks, (const int*)desc, (uint4*)words, (float*)err, n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace astcx

#ifdef __CUDACC__

// Each launcher launches on `stream` and returns cudaGetLastError() (the
// launch is not synchronised).  blocks: [n, T, 4] float32; desc: the int32
// descriptor of astc_cuda.py:descriptor; words: [n, 4] uint32; err: [n]
// float32.
extern "C" int astc_a_launch(const void* blocks, const void* desc, void* words, void* err, int n,
                             void* stream) {
  return astcx::launch<0>(blocks, desc, words, err, n, stream);
}
extern "C" int astc_b_launch(const void* blocks, const void* desc, void* words, void* err, int n,
                             void* stream) {
  return astcx::launch<1>(blocks, desc, words, err, n, stream);
}
extern "C" int astc_c_launch(const void* blocks, const void* desc, void* words, void* err, int n,
                             void* stream) {
  return astcx::launch<2>(blocks, desc, words, err, n, stream);
}
extern "C" int astc_d_launch(const void* blocks, const void* desc, void* words, void* err, int n,
                             void* stream) {
  return astcx::launch<3>(blocks, desc, words, err, n, stream);
}

#endif  // __CUDACC__
