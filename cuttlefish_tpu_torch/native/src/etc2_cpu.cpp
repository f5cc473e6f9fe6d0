// CPU ETC2 encoder: independent reference-class quality baseline.
//
// An original implementation in the etc2comp-"basic" algorithm class (the
// reference drives etc2comp via /root/reference/lib/src/EtcConverter.cpp;
// its effort ladder at 34-54 maps quality to search breadth).  Used by
// tests/test_cpu_reference.py to back the BASELINE.md north-star claim
// for the ETC family alongside bc7_cpu.cpp (BC7) and astc_cpu.cpp (ASTC).
//
// Modes searched per block, exact decode model throughout:
//   - ETC1 individual (4+4-bit bases) and differential (5+3-bit), both
//     flips, full 8-table x 4-modifier sweep, base-color neighborhood at
//     higher quality
//   - ETC2 T and H (4-bit palette colors, 8 distances, cluster split)
//   - ETC2 planar (least-squares O/H/V fit, 6/7/6-bit quantization)
//   - EAC A8 (separate entry point; base/multiplier/table sweep)
// T/H/planar are signaled by forcing the differential R/G/B overflow; the
// filler-bit rules below are derived from the field layout the spec (and
// decode/etc.py) reads back.  Blocks are big-endian 64-bit words with
// column-major pixel order.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

const int kMods[8][4] = {
    {2, 8, -2, -8},     {5, 17, -5, -17},   {9, 29, -9, -29},
    {13, 42, -13, -42}, {18, 60, -18, -60}, {24, 80, -24, -80},
    {33, 106, -33, -106}, {47, 183, -47, -183}};
const int kTDist[8] = {3, 6, 11, 16, 23, 32, 41, 64};
const int kEacMods[16][8] = {
    {-3, -6, -9, -15, 2, 5, 8, 14}, {-3, -7, -10, -13, 2, 6, 9, 12},
    {-2, -5, -8, -13, 1, 4, 7, 12}, {-2, -4, -6, -13, 1, 3, 5, 12},
    {-3, -6, -8, -12, 2, 5, 7, 11}, {-3, -7, -9, -11, 2, 6, 8, 10},
    {-4, -7, -8, -11, 3, 6, 7, 10}, {-3, -5, -8, -11, 2, 4, 7, 10},
    {-2, -6, -8, -10, 1, 5, 7, 9},  {-2, -5, -8, -10, 1, 4, 7, 9},
    {-2, -4, -8, -10, 1, 3, 7, 9},  {-2, -5, -7, -10, 1, 4, 6, 9},
    {-3, -4, -7, -10, 2, 3, 6, 9},  {-1, -2, -3, -10, 0, 1, 2, 9},
    {-4, -6, -8, -9, 3, 5, 7, 8},   {-3, -5, -7, -9, 2, 4, 6, 8}};

inline int clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }
inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
inline int expand4(int v) { return (v << 4) | v; }
inline int expand5(int v) { return (v << 3) | (v >> 2); }

// px: [16][3] raster order (0..255 floats).  ETC pixel p = 4*x + y.
struct Block {
  float px[16][3];
};

// ---------------------------------------------------------------------------
// ETC1 individual / differential
// ---------------------------------------------------------------------------

// Fit one subblock (8 texels, raster indices in `idx`) against a decoded
// base color; returns SSE and the chosen (table, per-pixel mod index).
double fit_subblock(const Block& B, const int* idx, const int base[3],
                    int* table_out, int* sel_out /*[8]*/) {
  double best = 1e30;
  for (int t = 0; t < 8; ++t) {
    double err = 0;
    int sel[8];
    for (int i = 0; i < 8; ++i) {
      const float* p = B.px[idx[i]];
      double be = 1e30;
      int bk = 0;
      for (int k = 0; k < 4; ++k) {
        double e = 0;
        for (int c = 0; c < 3; ++c) {
          double d = p[c] - clamp255(base[c] + kMods[t][k]);
          e += d * d;
        }
        if (e < be) { be = e; bk = k; }
      }
      sel[i] = bk;
      err += be;
    }
    if (err < best) {
      best = err;
      *table_out = t;
      std::memcpy(sel_out, sel, sizeof sel);
    }
  }
  return best;
}

void subblock_indices(int flip, int sub, int* idx) {
  int n = 0;
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) {
      int in2 = flip ? (y >= 2) : (x >= 2);
      if (in2 == sub) idx[n++] = 4 * y + x;
    }
}

void put_pixel_bits(uint64_t* blk, const int* idx8_a, const int* sel_a,
                    const int* idx8_b, const int* sel_b) {
  for (int half = 0; half < 2; ++half) {
    const int* idx8 = half ? idx8_b : idx8_a;
    const int* sel = half ? sel_b : sel_a;
    for (int i = 0; i < 8; ++i) {
      int ri = idx8[i];
      int x = ri % 4, y = ri / 4;
      int p = 4 * x + y;  // column-major pixel number
      int msb = (sel[i] >> 1) & 1, lsb = sel[i] & 1;
      *blk |= (uint64_t)msb << (16 + p);
      *blk |= (uint64_t)lsb << p;
    }
  }
}

double encode_etc1(const Block& B, int quality, uint64_t* out) {
  double best = 1e30;
  // base neighborhood radius: effort-100 class widens to 2 at Highest
  // (EtcConverter.cpp:34-54 maps quality 4 -> etc2comp effort 100)
  int nbh = quality >= 4 ? 2 : (quality >= 2 ? 1 : 0);
  for (int flip = 0; flip < 2; ++flip) {
    int idx0[8], idx1[8];
    subblock_indices(flip, 0, idx0);
    subblock_indices(flip, 1, idx1);
    float mean[2][3] = {};
    for (int i = 0; i < 8; ++i)
      for (int c = 0; c < 3; ++c) {
        mean[0][c] += B.px[idx0[i]][c] / 8.0f;
        mean[1][c] += B.px[idx1[i]][c] / 8.0f;
      }
    // Individual mode (4+4 bases): the subblocks are independent, so
    // neighborhood-sweep each on its own.
    {
      int bq[2][3], bt[2], bsel[2][8];
      double terr = 0;
      for (int sub = 0; sub < 2; ++sub) {
        const int* idx = sub ? idx1 : idx0;
        int q[3];
        for (int c = 0; c < 3; ++c)
          q[c] = clampi((int)std::lround(mean[sub][c] / 17.0f), 0, 15);
        double sbest = 1e30;
        for (int dr = -nbh; dr <= nbh; ++dr)
          for (int dg = -nbh; dg <= nbh; ++dg)
            for (int db = -nbh; db <= nbh; ++db) {
              int bqc[3] = {clampi(q[0] + dr, 0, 15),
                            clampi(q[1] + dg, 0, 15),
                            clampi(q[2] + db, 0, 15)};
              int base[3] = {expand4(bqc[0]), expand4(bqc[1]),
                             expand4(bqc[2])};
              int t, sel[8];
              double e = fit_subblock(B, idx, base, &t, sel);
              if (e < sbest) {
                sbest = e;
                std::memcpy(bq[sub], bqc, sizeof bqc);
                bt[sub] = t;
                std::memcpy(bsel[sub], sel, sizeof sel);
              }
            }
        terr += sbest;
      }
      if (terr < best) {
        best = terr;
        uint64_t blk = 0;
        blk |= (uint64_t)bq[0][0] << 60;
        blk |= (uint64_t)bq[0][1] << 52;
        blk |= (uint64_t)bq[0][2] << 44;
        blk |= (uint64_t)bq[1][0] << 56;
        blk |= (uint64_t)bq[1][1] << 48;
        blk |= (uint64_t)bq[1][2] << 40;
        blk |= (uint64_t)bt[0] << 37;
        blk |= (uint64_t)bt[1] << 34;
        blk |= (uint64_t)flip << 32;
        put_pixel_bits(&blk, idx0, bsel[0], idx1, bsel[1]);
        *out = blk;
      }
    }
    // Differential mode (5-bit base + 3-bit delta): joint sweep so the
    // delta clamp sees each base-1 candidate.
    {
      int q0[3], q1[3];
      for (int c = 0; c < 3; ++c) {
        q0[c] = clampi((int)std::lround(mean[0][c] * 31.0f / 255.0f), 0, 31);
        q1[c] = clampi((int)std::lround(mean[1][c] * 31.0f / 255.0f), 0, 31);
      }
      for (int d0r = -nbh; d0r <= nbh; ++d0r)
        for (int d0g = -nbh; d0g <= nbh; ++d0g)
          for (int d0b = -nbh; d0b <= nbh; ++d0b) {
            int b0q[3] = {clampi(q0[0] + d0r, 0, 31),
                          clampi(q0[1] + d0g, 0, 31),
                          clampi(q0[2] + d0b, 0, 31)};
            int b1q[3], base0[3], base1[3];
            for (int c = 0; c < 3; ++c) {
              b1q[c] = b0q[c] + clampi(q1[c] - b0q[c], -4, 3);
              base0[c] = expand5(b0q[c]);
              base1[c] = expand5(b1q[c]);
            }
            int t0, t1, sel0[8], sel1[8];
            double err = fit_subblock(B, idx0, base0, &t0, sel0) +
                         fit_subblock(B, idx1, base1, &t1, sel1);
            if (err >= best) continue;
            best = err;
            uint64_t blk = 0;
            blk |= (uint64_t)b0q[0] << 59;
            blk |= (uint64_t)b0q[1] << 51;
            blk |= (uint64_t)b0q[2] << 43;
            blk |= (uint64_t)((b1q[0] - b0q[0]) & 7) << 56;
            blk |= (uint64_t)((b1q[1] - b0q[1]) & 7) << 48;
            blk |= (uint64_t)((b1q[2] - b0q[2]) & 7) << 40;
            blk |= 1ull << 33;
            blk |= (uint64_t)t0 << 37;
            blk |= (uint64_t)t1 << 34;
            blk |= (uint64_t)flip << 32;
            put_pixel_bits(&blk, idx0, sel0, idx1, sel1);
            *out = blk;
          }
    }
  }
  return best;
}

// ---------------------------------------------------------------------------
// ETC2 T / H modes
// ---------------------------------------------------------------------------

// Two-cluster split along the principal axis -> two 4-bit colors.
void cluster_colors(const Block& B, int c1[3], int c2[3]) {
  float mean[3] = {};
  for (auto& p : B.px)
    for (int c = 0; c < 3; ++c) mean[c] += p[c] / 16.0f;
  double cov[3][3] = {};
  for (auto& p : B.px)
    for (int c = 0; c < 3; ++c)
      for (int d = 0; d < 3; ++d)
        cov[c][d] += (p[c] - mean[c]) * (p[d] - mean[d]);
  double axis[3] = {1, 1, 1};
  for (int it = 0; it < 4; ++it) {
    double nv[3] = {}, nn = 0;
    for (int c = 0; c < 3; ++c)
      for (int d = 0; d < 3; ++d) nv[c] += cov[c][d] * axis[d];
    for (int c = 0; c < 3; ++c) nn += nv[c] * nv[c];
    nn = std::sqrt(nn);
    if (nn < 1e-10) break;
    for (int c = 0; c < 3; ++c) axis[c] = nv[c] / nn;
  }
  float m1[3] = {}, m2[3] = {};
  int n1 = 0, n2 = 0;
  for (auto& p : B.px) {
    double t = 0;
    for (int c = 0; c < 3; ++c) t += (p[c] - mean[c]) * axis[c];
    if (t < 0) {
      ++n1;
      for (int c = 0; c < 3; ++c) m1[c] += p[c];
    } else {
      ++n2;
      for (int c = 0; c < 3; ++c) m2[c] += p[c];
    }
  }
  for (int c = 0; c < 3; ++c) {
    c1[c] = clampi((int)std::lround((n1 ? m1[c] / n1 : mean[c]) / 17.0f), 0, 15);
    c2[c] = clampi((int)std::lround((n2 ? m2[c] / n2 : mean[c]) / 17.0f), 0, 15);
  }
}

double assign_palette(const Block& B, const int pal[4][3], int* sel /*[16]*/) {
  double err = 0;
  for (int t = 0; t < 16; ++t) {
    double be = 1e30;
    int bk = 0;
    for (int k = 0; k < 4; ++k) {
      double e = 0;
      for (int c = 0; c < 3; ++c) {
        double d = B.px[t][c] - pal[k][c];
        e += d * d;
      }
      if (e < be) { be = e; bk = k; }
    }
    sel[t] = bk;
    err += be;
  }
  return err;
}

void put_sel_bits(uint64_t* blk, const int* sel) {
  for (int ri = 0; ri < 16; ++ri) {
    int x = ri % 4, y = ri / 4;
    int p = 4 * x + y;
    *blk |= (uint64_t)((sel[ri] >> 1) & 1) << (16 + p);
    *blk |= (uint64_t)(sel[ri] & 1) << p;
  }
}

// T mode: palette [C1, C2+d, C2, C2-d].  R-overflow filler rule: with
// S = r1[3:2] + r1[1:0], S >= 4 -> overflow high (filler 111/0), else
// overflow low (filler 000/1).
double encode_t(const Block& B, const int c1[3], const int c2[3],
                uint64_t* out) {
  double best = 1e30;
  for (int di = 0; di < 8; ++di) {
    int d = kTDist[di];
    int e1[3], e2[3];
    for (int c = 0; c < 3; ++c) {
      e1[c] = expand4(c1[c]);
      e2[c] = expand4(c2[c]);
    }
    int pal[4][3];
    for (int c = 0; c < 3; ++c) {
      pal[0][c] = e1[c];
      pal[1][c] = clamp255(e2[c] + d);
      pal[2][c] = e2[c];
      pal[3][c] = clamp255(e2[c] - d);
    }
    int sel[16];
    double err = assign_palette(B, pal, sel);
    if (err >= best) continue;
    best = err;
    uint64_t blk = 0;
    int r1 = c1[0];
    int S = (r1 >> 2) + (r1 & 3);
    if (S >= 4) {
      blk |= 7ull << 61;  // filler -> base high, delta positive: overflow
    } else {
      blk |= 1ull << 58;  // delta MSB set -> negative: underflow
    }
    blk |= (uint64_t)(r1 >> 2) << 59;
    blk |= (uint64_t)(r1 & 3) << 56;
    blk |= (uint64_t)c1[1] << 52;
    blk |= (uint64_t)c1[2] << 48;
    blk |= (uint64_t)c2[0] << 44;
    blk |= (uint64_t)c2[1] << 40;
    blk |= (uint64_t)c2[2] << 36;
    blk |= (uint64_t)((di >> 1) & 3) << 34;
    blk |= 1ull << 33;  // diff
    blk |= (uint64_t)(di & 1) << 32;
    put_sel_bits(&blk, sel);
    *out = blk;
  }
  return best;
}

// H mode: palette [S1+d, S1-d, S2+d, S2-d]; distance LSB is carried by the
// color ordering, so (s1,s2) are swapped to match.  G-overflow filler rule:
// with S = 2*g1[0] + b1[3] + 2*b1[2] + b1[1], S >= 4 -> overflow high
// (bits 55..53 = 111, bit 50 = 0), else overflow low (000 / 1).  Bit 63
// copies g1[3] so the R channel stays in range.
double encode_h(const Block& B, const int c1[3], const int c2[3],
                uint64_t* out) {
  double best = 1e30;
  for (int di = 0; di < 8; ++di) {
    int d = kTDist[di];
    const int* s1 = c1;
    const int* s2 = c2;
    int p1 = (s1[0] << 8) | (s1[1] << 4) | s1[2];
    int p2 = (s2[0] << 8) | (s2[1] << 4) | s2[2];
    if (((p1 >= p2) ? 1 : 0) != (di & 1)) {
      std::swap(s1, s2);
      std::swap(p1, p2);
      if (((p1 >= p2) ? 1 : 0) != (di & 1)) continue;  // p1 == p2, LSB 0
    }
    int pal[4][3];
    for (int c = 0; c < 3; ++c) {
      int a = expand4(s1[c]), b = expand4(s2[c]);
      pal[0][c] = clamp255(a + d);
      pal[1][c] = clamp255(a - d);
      pal[2][c] = clamp255(b + d);
      pal[3][c] = clamp255(b - d);
    }
    int sel[16];
    double err = assign_palette(B, pal, sel);
    if (err >= best) continue;
    best = err;
    uint64_t blk = 0;
    int g1 = s1[1], b1 = s1[2];
    blk |= (uint64_t)((g1 >> 3) & 1) << 63;  // keep R in range
    blk |= (uint64_t)s1[0] << 59;
    blk |= (uint64_t)((g1 >> 1) & 7) << 56;
    int S = 2 * (g1 & 1) + ((b1 >> 3) & 1) + 2 * ((b1 >> 2) & 1) +
            ((b1 >> 1) & 1);
    if (S >= 4)
      blk |= 7ull << 53;  // G base high, delta positive: overflow
    else
      blk |= 1ull << 50;  // delta MSB set: underflow
    blk |= (uint64_t)(g1 & 1) << 52;
    blk |= (uint64_t)((b1 >> 3) & 1) << 51;
    blk |= (uint64_t)((b1 >> 1) & 3) << 48;
    blk |= (uint64_t)(b1 & 1) << 47;
    blk |= (uint64_t)s2[0] << 43;
    blk |= (uint64_t)s2[1] << 39;
    blk |= (uint64_t)s2[2] << 35;
    blk |= (uint64_t)((di >> 2) & 1) << 34;
    blk |= 1ull << 33;  // diff
    blk |= (uint64_t)((di >> 1) & 1) << 32;
    put_sel_bits(&blk, sel);
    *out = blk;
  }
  return best;
}

// ---------------------------------------------------------------------------
// ETC2 planar
// ---------------------------------------------------------------------------

// decode: v = (x*(H-O) + y*(V-O) + 4*O + 2) >> 2 — linear in O/H/V, so fit
// by least squares with design row [(4-x-y), x, y] / 4 and quantize.
double encode_planar(const Block& B, int quality, uint64_t* out) {
  // normal equations for the fixed 16x3 design matrix
  double ata[3][3] = {}, atb[3][3] = {};
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) {
      double row[3] = {(4.0 - x - y) / 4.0, x / 4.0, y / 4.0};
      for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) ata[i][j] += row[i] * row[j];
        for (int c = 0; c < 3; ++c)
          atb[i][c] += row[i] * B.px[4 * y + x][c];
      }
    }
  // solve 3x3 via Cramer
  auto det3 = [](double m[3][3]) {
    return m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1]) -
           m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0]) +
           m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]);
  };
  double D = det3(ata);
  if (std::fabs(D) < 1e-9) return 1e30;
  double ohv[3][3];  // [O/H/V][channel]
  for (int c = 0; c < 3; ++c) {
    for (int i = 0; i < 3; ++i) {
      double m[3][3];
      std::memcpy(m, ata, sizeof m);
      for (int r = 0; r < 3; ++r) m[r][i] = atb[r][c];
      ohv[i][c] = det3(m) / D;
    }
  }
  auto q6 = [](double v) {
    return clampi((int)std::lround(v * 63.0 / 255.0), 0, 63);
  };
  auto q7 = [](double v) {
    return clampi((int)std::lround(v * 127.0 / 255.0), 0, 127);
  };
  auto ext6 = [](int v) { return (v << 2) | (v >> 4); };
  auto ext7 = [](int v) { return (v << 1) | (v >> 6); };
  int O[3] = {q6(ohv[0][0]), q7(ohv[0][1]), q6(ohv[0][2])};
  int H[3] = {q6(ohv[1][0]), q7(ohv[1][1]), q6(ohv[1][2])};
  int V[3] = {q6(ohv[2][0]), q7(ohv[2][1]), q6(ohv[2][2])};
  if (quality >= 4) {
    // effort-100 tier: the rounded (O,H,V) triple is not the exact-error
    // argmin (decode clamps and truncates); per channel the error is
    // independent, so sweep the 27-combo +-1 neighborhood exactly.
    for (int c = 0; c < 3; ++c) {
      int maxq = c == 1 ? 127 : 63;
      auto ext = [&](int v) {
        return c == 1 ? ((v << 1) | (v >> 6)) : ((v << 2) | (v >> 4));
      };
      double cbest = 1e30;
      int bo = O[c], bh = H[c], bv = V[c];
      for (int d0 = -1; d0 <= 1; ++d0)
        for (int d1 = -1; d1 <= 1; ++d1)
          for (int d2 = -1; d2 <= 1; ++d2) {
            int o = clampi(O[c] + d0, 0, maxq);
            int h = clampi(H[c] + d1, 0, maxq);
            int v = clampi(V[c] + d2, 0, maxq);
            int oe = ext(o), he = ext(h), ve = ext(v);
            double e = 0;
            for (int y = 0; y < 4; ++y)
              for (int x = 0; x < 4; ++x) {
                int dv = clamp255(
                    (x * (he - oe) + y * (ve - oe) + 4 * oe + 2) >> 2);
                double d = B.px[4 * y + x][c] - dv;
                e += d * d;
              }
            if (e < cbest) { cbest = e; bo = o; bh = h; bv = v; }
          }
      O[c] = bo;
      H[c] = bh;
      V[c] = bv;
    }
  }
  int Oe[3] = {ext6(O[0]), ext7(O[1]), ext6(O[2])};
  int He[3] = {ext6(H[0]), ext7(H[1]), ext6(H[2])};
  int Ve[3] = {ext6(V[0]), ext7(V[1]), ext6(V[2])};
  double err = 0;
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x)
      for (int c = 0; c < 3; ++c) {
        int v = clamp255(
            (x * (He[c] - Oe[c]) + y * (Ve[c] - Oe[c]) + 4 * Oe[c] + 2) >> 2);
        double d = B.px[4 * y + x][c] - v;
        err += d * d;
      }
  // pack (B-overflow filler rule; bits 63/55 keep R and G in range)
  uint64_t blk = 0;
  int ro = O[0], go = O[1], bo = O[2];
  blk |= (uint64_t)((ro >> 1) & 1) << 63;  // R in range
  blk |= (uint64_t)ro << 57;
  blk |= (uint64_t)((go >> 6) & 1) << 56;
  blk |= (uint64_t)((go >> 1) & 1) << 55;  // G in range (sign of G delta)
  blk |= (uint64_t)(go & 0x3F) << 49;
  blk |= (uint64_t)((bo >> 5) & 1) << 48;
  int S = 2 * ((bo >> 4) & 1) + ((bo >> 3) & 1) + 2 * ((bo >> 2) & 1) +
          ((bo >> 1) & 1);
  if (S >= 4)
    blk |= 7ull << 45;  // B base high, delta positive: overflow
  else
    blk |= 1ull << 42;  // delta MSB set: underflow
  blk |= (uint64_t)((bo >> 3) & 3) << 43;
  blk |= (uint64_t)(bo & 7) << 39;
  blk |= (uint64_t)((H[0] >> 1) & 0x1F) << 34;
  blk |= 1ull << 33;  // diff
  blk |= (uint64_t)(H[0] & 1) << 32;
  blk |= (uint64_t)H[1] << 25;
  blk |= (uint64_t)H[2] << 19;
  blk |= (uint64_t)V[0] << 13;
  blk |= (uint64_t)V[1] << 6;
  blk |= (uint64_t)V[2];
  *out = blk;
  return err;
}

// Greedy coordinate descent over the six 4-bit palette-color
// coordinates (the effort-100 T/H refinement): each step re-runs the
// full distance sweep, so the search sees the exact final objective.
template <class EncodeFn>
double refine_th(const Block& B, int c1[3], int c2[3], EncodeFn enc,
                 double best, uint64_t* out) {
  bool improved = true;
  for (int pass = 0; pass < 4 && improved; ++pass) {
    improved = false;
    for (int ci = 0; ci < 6; ++ci) {
      int* col = ci < 3 ? c1 : c2;
      int c = ci % 3;
      for (int dd = -1; dd <= 1; dd += 2) {
        int orig = col[c];
        int v = clampi(orig + dd, 0, 15);
        if (v == orig) continue;
        col[c] = v;
        uint64_t tb;
        double e = enc(B, c1, c2, &tb);
        if (e < best) {
          best = e;
          *out = tb;
          improved = true;
        } else {
          col[c] = orig;
        }
      }
    }
  }
  return best;
}

void encode_block(const Block& B, int quality, bool etc2, uint8_t* out8) {
  uint64_t best_blk = 0, blk;
  double best = encode_etc1(B, quality, &best_blk);
  if (etc2) {
    int c1[3], c2[3];
    cluster_colors(B, c1, c2);
    double e;
    e = encode_t(B, c1, c2, &blk);
    if (e < best) { best = e; best_blk = blk; }
    e = encode_t(B, c2, c1, &blk);  // swapped roles (C1 is the lone color)
    if (e < best) { best = e; best_blk = blk; }
    e = encode_h(B, c1, c2, &blk);
    if (e < best) { best = e; best_blk = blk; }
    if (quality >= 4) {
      // effort-100 tier: coordinate-descent the T/H palette colors.
      int t1[3], t2[3];
      uint64_t rb;
      std::memcpy(t1, c1, sizeof t1);
      std::memcpy(t2, c2, sizeof t2);
      e = refine_th(
          B, t1, t2,
          [](const Block& b, int* a, int* bb, uint64_t* o) {
            return encode_t(b, a, bb, o);
          },
          best, &rb);
      if (e < best) { best = e; best_blk = rb; }
      std::memcpy(t1, c2, sizeof t1);
      std::memcpy(t2, c1, sizeof t2);
      e = refine_th(
          B, t1, t2,
          [](const Block& b, int* a, int* bb, uint64_t* o) {
            return encode_t(b, a, bb, o);
          },
          best, &rb);
      if (e < best) { best = e; best_blk = rb; }
      std::memcpy(t1, c1, sizeof t1);
      std::memcpy(t2, c2, sizeof t2);
      e = refine_th(
          B, t1, t2,
          [](const Block& b, int* a, int* bb, uint64_t* o) {
            return encode_h(b, a, bb, o);
          },
          best, &rb);
      if (e < best) { best = e; best_blk = rb; }
    }
    e = encode_planar(B, quality, &blk);
    if (e < best) { best = e; best_blk = blk; }
  }
  for (int i = 0; i < 8; ++i)
    out8[i] = (uint8_t)(best_blk >> (56 - 8 * i));  // big-endian
}

double encode_eac_a8(const float* alpha /*[16] 0..255*/, int quality,
                     uint8_t* out8) {
  float mn = 255.f, mx = 0.f, mean = 0.f;
  for (int i = 0; i < 16; ++i) {
    mn = std::min(mn, alpha[i]);
    mx = std::max(mx, alpha[i]);
    mean += alpha[i] / 16.0f;
  }
  double best = 1e30;
  uint64_t best_blk = 0;
  int bctr = (int)std::lround(mean);
  int brange = quality >= 2 ? 2 : 0;
  for (int t = 0; t < 16; ++t) {
    int span = kEacMods[t][7] - kEacMods[t][3];  // max - min modifier
    int m0 = span > 0 ? (int)std::lround((mx - mn) / span) : 1;
    for (int dm = -1; dm <= 1; ++dm) {
      int mult = clampi(m0 + dm, 1, 15);
      for (int db = -brange; db <= brange; ++db) {
        int base = clampi(bctr + db, 0, 255);
        double err = 0;
        int sel[16];
        for (int i = 0; i < 16; ++i) {
          double be = 1e30;
          int bk = 0;
          for (int k = 0; k < 8; ++k) {
            int v = clamp255(base + kEacMods[t][k] * mult);
            double d = alpha[i] - v;
            d *= d;
            if (d < be) { be = d; bk = k; }
          }
          sel[i] = bk;
          err += be;
        }
        if (err >= best) continue;
        best = err;
        uint64_t blk = ((uint64_t)base << 56) | ((uint64_t)mult << 52) |
                       ((uint64_t)t << 48);
        for (int ri = 0; ri < 16; ++ri) {
          int x = ri % 4, y = ri / 4;
          int p = 4 * x + y;
          blk |= (uint64_t)sel[ri] << (45 - 3 * p);
        }
        best_blk = blk;
      }
    }
  }
  for (int i = 0; i < 8; ++i)
    out8[i] = (uint8_t)(best_blk >> (56 - 8 * i));
  return best;
}

double encode_eac_r11(const float* vals /*[16] 0..1*/, int quality,
                      uint8_t* out8) {
  // Unsigned R11: decode v = clip(base*8+4 + mod*(mult? mult*8 : 1),
  // 0, 2047) (Khronos EAC; mirrors decode/etc.py:decode_eac_r11).
  float v11[16];
  float mn = 2047.f, mx = 0.f, mean = 0.f;
  for (int i = 0; i < 16; ++i) {
    v11[i] = std::min(std::max(vals[i], 0.0f), 1.0f) * 2047.0f;
    mn = std::min(mn, v11[i]);
    mx = std::max(mx, v11[i]);
    mean += v11[i] / 16.0f;
  }
  double best = 1e30;
  uint64_t best_blk = 0;
  int bctr = clampi((int)std::lround((mean - 4.0f) / 8.0f), 0, 255);
  int brange = quality >= 2 ? 2 : 0;
  for (int t = 0; t < 16; ++t) {
    int span = kEacMods[t][7] - kEacMods[t][3];
    int m0 = span > 0 ? (int)std::lround((mx - mn) / (8.0f * span)) : 1;
    for (int dm = -1; dm <= 1; ++dm) {
      int mult = clampi(m0 + dm, 0, 15);
      int mscale = mult ? mult * 8 : 1;
      for (int db = -brange; db <= brange; ++db) {
        int base = clampi(bctr + db, 0, 255);
        double err = 0;
        int sel[16];
        for (int i = 0; i < 16; ++i) {
          double be = 1e30;
          int bk = 0;
          for (int k = 0; k < 8; ++k) {
            int v = clampi(base * 8 + 4 + kEacMods[t][k] * mscale, 0, 2047);
            double d = v11[i] - v;
            d *= d;
            if (d < be) { be = d; bk = k; }
          }
          sel[i] = bk;
          err += be;
        }
        if (err >= best) continue;
        best = err;
        uint64_t blk = ((uint64_t)base << 56) | ((uint64_t)mult << 52) |
                       ((uint64_t)t << 48);
        for (int ri = 0; ri < 16; ++ri) {
          int x = ri % 4, y = ri / 4;
          int p = 4 * x + y;
          blk |= (uint64_t)sel[ri] << (45 - 3 * p);
        }
        best_blk = blk;
      }
    }
  }
  for (int i = 0; i < 8; ++i)
    out8[i] = (uint8_t)(best_blk >> (56 - 8 * i));
  return best;
}

}  // namespace

extern "C" {

// rgba: N * 16 * 4 floats in [0,1] (raster order); out: N * 8 bytes.
void ctpu_etc2_rgb_encode(const float* rgba, int n, int quality, int etc2,
                          int threads, uint8_t* out) {
  if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
  std::atomic<int> counter{0};
  const int kChunk = 64;
  auto worker = [&]() {
    Block B;
    for (;;) {
      int start = counter.fetch_add(kChunk);
      if (start >= n) break;
      int end = std::min(n, start + kChunk);
      for (int b = start; b < end; ++b) {
        for (int t = 0; t < 16; ++t)
          for (int c = 0; c < 3; ++c)
            B.px[t][c] = std::min(
                255.0f, std::max(0.0f, rgba[b * 64 + t * 4 + c] * 255.0f));
        encode_block(B, quality, etc2 != 0, out + b * 8);
      }
    }
  };
  if (threads <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

// rgba: N * 16 * 4 floats in [0,1]; alpha channel -> N * 8 bytes EAC A8.
void ctpu_eac_r11_encode(const float* vals, int n, int quality,
                         int threads, uint8_t* out) {
  if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
  std::atomic<int> counter{0};
  const int kChunk = 64;
  auto worker = [&]() {
    for (;;) {
      int start = counter.fetch_add(kChunk);
      if (start >= n) break;
      int end = std::min(n, start + kChunk);
      for (int b = start; b < end; ++b)
        encode_eac_r11(vals + b * 16, quality, out + b * 8);
    }
  };
  if (threads <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

void ctpu_eac_a8_encode(const float* rgba, int n, int quality, int threads,
                        uint8_t* out) {
  if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
  std::atomic<int> counter{0};
  const int kChunk = 64;
  auto worker = [&]() {
    float a[16];
    for (;;) {
      int start = counter.fetch_add(kChunk);
      if (start >= n) break;
      int end = std::min(n, start + kChunk);
      for (int b = start; b < end; ++b) {
        for (int t = 0; t < 16; ++t)
          a[t] = std::min(255.0f,
                          std::max(0.0f, rgba[b * 64 + t * 4 + 3] * 255.0f));
        encode_eac_a8(a, quality, out + b * 8);
      }
    }
  };
  if (threads <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

}  // extern "C"
