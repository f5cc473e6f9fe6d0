// CPU ASTC 4x4 encoder: independent reference-class quality baseline.
//
// An original implementation in the astcenc-"fast" algorithm class (the
// reference drives astcenc via /root/reference/lib/src/AstcConverter.cpp;
// its effort ladder at 174-195 maps quality to search breadth).  Used by
// tests/test_cpu_reference.py to back the BASELINE.md north-star claim
// ("per-image PSNR >= reference at matching quality") for ASTC the same
// way native/src/bc7_cpu.cpp backs it for BC7.
//
// Search space (all 4x4 weight grid, single plane, LDR):
//   A: 1-partition CEM 8 (RGB direct),  8-level weights, 256-level color
//   B: 1-partition CEM 8,              16-level weights, 192-level color
//   C: 1-partition CEM 12 (RGBA),       4-level weights, 256-level color
//   D: 1-partition CEM 12,              8-level weights, 192-level color
//   E: 2-partition CEM 8,               4-level weights,  40-level color
//   F: 2-partition CEM 12,              4-level weights,  16-level color
//   G: 2-partition CEM 8,               8-level weights,  16-level color
// Color ranges are the ones the ASTC implied-range rule derives from each
// layout's leftover bit budget (spec C.2.22), so every emitted block is
// conformant and decodes identically under decode/astc.py and Mesa GL.
// Partition search screens all 1024 seeds by cluster SSE and deep-fits the
// top K.  Per-layout fitting is PCA seed + least-squares refinement with
// exact-decode-model candidate selection (keep-best across iterations).
//
// ISE (spec C.2.12): trit/quint packed blocks are inverted by brute force
// from the spec decode functions at init; pack tables prefer the smallest
// block value so truncated final groups stay consistent.

#include <algorithm>
#include <array>
#include <atomic>
#include <mutex>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// ISE: trit/quint blocks (spec C.2.12)
// ---------------------------------------------------------------------------

void decode_trit_block(int t, int* out) {
  int c, t4, t3;
  if (((t >> 2) & 0x7) == 0x7) {
    c = (((t >> 5) & 0x7) << 2) | (t & 0x3);
    t4 = t3 = 2;
  } else {
    c = t & 0x1F;
    if (((t >> 5) & 0x3) == 0x3) {
      t4 = 2;
      t3 = (t >> 7) & 1;
    } else {
      t4 = (t >> 7) & 1;
      t3 = (t >> 5) & 0x3;
    }
  }
  int t2, t1, t0;
  if ((c & 0x3) == 0x3) {
    t2 = 2;
    t1 = (c >> 4) & 1;
    t0 = (((c >> 3) & 1) << 1) | ((c >> 2) & 1 & ~((c >> 3) & 1));
  } else if (((c >> 2) & 0x3) == 0x3) {
    t2 = 2;
    t1 = 2;
    t0 = c & 0x3;
  } else {
    t2 = (c >> 4) & 1;
    t1 = (c >> 2) & 0x3;
    t0 = (c & 0x2) | ((c & 1) & ~((c >> 1) & 1));
  }
  out[0] = t0; out[1] = t1; out[2] = t2; out[3] = t3; out[4] = t4;
}

void decode_quint_block(int q, int* out) {
  int q2, q1, q0;
  if (((q >> 1) & 0x3) == 0x3 && ((q >> 5) & 0x3) == 0x0) {
    q2 = ((q & 1) << 2) | (((q >> 4) & 1 & ~(q & 1)) << 1) |
         ((q >> 3) & 1 & ~(q & 1));
    q1 = 4;
    q0 = 4;
  } else {
    int c;
    if (((q >> 1) & 0x3) == 0x3) {
      q2 = 4;
      c = (((q >> 3) & 0x3) << 3) | ((~(q >> 5) & 0x3) << 1) | (q & 1);
    } else {
      q2 = (q >> 5) & 0x3;
      c = q & 0x1F;
    }
    if ((c & 0x7) == 0x5) {
      q1 = 4;
      q0 = (c >> 3) & 0x3;
    } else {
      q1 = (c >> 3) & 0x3;
      q0 = c & 0x7;
    }
  }
  out[0] = q0; out[1] = q1; out[2] = q2;
}

struct IseTables {
  int trit_pack[3][3][3][3][3];
  int quint_pack[5][5][5];
  IseTables() {
    for (auto& a : trit_pack)
      for (auto& b : a)
        for (auto& c : b)
          for (auto& d : c)
            for (int& e : d) e = -1;
    for (auto& a : quint_pack)
      for (auto& b : a)
        for (int& c : b) c = -1;
    for (int t = 0; t < 256; ++t) {
      int tr[5];
      decode_trit_block(t, tr);
      int& slot = trit_pack[tr[0]][tr[1]][tr[2]][tr[3]][tr[4]];
      if (slot < 0) slot = t;  // smallest block value first
    }
    for (int q = 0; q < 128; ++q) {
      int qu[3];
      decode_quint_block(q, qu);
      int& slot = quint_pack[qu[0]][qu[1]][qu[2]];
      if (slot < 0) slot = q;
    }
  }
};
const IseTables& ise_tables() {
  static IseTables t;
  return t;
}

// kind: 0 = bits, 1 = trit, 2 = quint
int ise_bits(int n, int kind, int b) {
  if (kind == 0) return n * b;
  if (kind == 1) return (8 * n + 4) / 5 + n * b;
  return (7 * n + 2) / 3 + n * b;
}

// Append the ISE stream for n quantized values to `bits` (LSB-first vector
// of 0/1), matching the spec interleave (m bits then packed T/Q slots).
void ise_encode(const int* vals, int n, int kind, int b,
                std::vector<uint8_t>* bits) {
  const int trit_slots[5][2] = {{0, 2}, {2, 2}, {4, 1}, {5, 2}, {7, 1}};
  const int quint_slots[3][2] = {{0, 3}, {3, 2}, {5, 2}};
  int total = ise_bits(n, kind, b);
  size_t base = bits->size();
  if (kind == 0) {
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < b; ++j) bits->push_back((vals[i] >> j) & 1);
    return;
  }
  int per = kind == 1 ? 5 : 3;
  auto slots = kind == 1 ? trit_slots : quint_slots;
  int ngroups = (n + per - 1) / per;
  for (int g = 0; g < ngroups; ++g) {
    int digits[5] = {0, 0, 0, 0, 0};
    for (int k = 0; k < per; ++k) {
      int i = g * per + k;
      if (i < n) digits[k] = vals[i] >> b;
    }
    int packed = kind == 1 ? ise_tables().trit_pack[digits[0]][digits[1]]
                                 [digits[2]][digits[3]][digits[4]]
                           : ise_tables().quint_pack[digits[0]][digits[1]]
                                 [digits[2]];
    for (int k = 0; k < per; ++k) {
      int i = g * per + k;
      int m = i < n ? (vals[i] & ((1 << b) - 1)) : 0;
      for (int j = 0; j < b; ++j) bits->push_back((m >> j) & 1);
      for (int j = slots[k][0]; j < slots[k][0] + slots[k][1]; ++j)
        bits->push_back((packed >> j) & 1);
    }
  }
  bits->resize(base + total);  // truncate the final partial group
}

// ---------------------------------------------------------------------------
// Unquantization (spec C.2.13/C.2.17; trit/quint color tables are the
// public spec constants, Mesa-validated in tests/test_gl_parity.py)
// ---------------------------------------------------------------------------

// Weight unquant (spec C.2.17): bit-only ranges replicate to 6 bits and
// bump past the midpoint; trit/quint ranges use the A/B/C scheme.
struct WRange {
  int levels;
  int kind;  // 0 bits / 1 trit / 2 quint
  int bits;
  int unq[32];
};

int weight_B(int kind, int b, int m) {
  if (b <= 1) return 0;
  int x = (m >> 1) & 1;
  if (b == 2 && kind == 1) return (x << 6) | (x << 2) | x;
  if (b == 2 && kind == 2) return (x << 6) | (x << 1);
  if (b == 3 && kind == 1) {
    int y = (m >> 2) & 1;
    return (y << 6) | (x << 5) | (y << 1) | x;
  }
  return 0;
}

void build_weight_range(int levels, WRange* r) {
  r->levels = levels;
  int C = 0;
  switch (levels) {
    case 2: r->kind = 0; r->bits = 1; break;
    case 4: r->kind = 0; r->bits = 2; break;
    case 8: r->kind = 0; r->bits = 3; break;
    case 16: r->kind = 0; r->bits = 4; break;
    case 32: r->kind = 0; r->bits = 5; break;
    case 3: r->kind = 1; r->bits = 0; break;
    case 6: r->kind = 1; r->bits = 1; C = 50; break;
    case 12: r->kind = 1; r->bits = 2; C = 23; break;
    case 24: r->kind = 1; r->bits = 3; C = 11; break;
    case 5: r->kind = 2; r->bits = 0; break;
    case 10: r->kind = 2; r->bits = 1; C = 28; break;
    case 20: r->kind = 2; r->bits = 2; C = 13; break;
  }
  for (int v = 0; v < levels; ++v) {
    int w;
    if (r->kind == 0) {
      int x = 0, shift = 6;
      while (shift > 0) {
        shift -= r->bits;
        x |= shift >= 0 ? (v << shift) : (v >> -shift);
      }
      x &= 0x3F;
      if (x > 32) x += 1;
      w = x;
    } else if (r->bits == 0) {
      static const int t0[3] = {0, 32, 64};
      static const int q0[5] = {0, 16, 32, 48, 64};
      w = r->kind == 1 ? t0[v] : q0[v];
    } else {
      int d = v >> r->bits, m = v & ((1 << r->bits) - 1);
      int A = (m & 1) ? 0x7F : 0;
      int T = d * C + weight_B(r->kind, r->bits, m);
      T ^= A;
      T = (A & 0x20) | (T >> 2);
      if (T > 32) T += 1;
      w = T;
    }
    r->unq[v] = w;
  }
}

const int kColor40[40] = {
    0, 255, 32, 223, 65, 190, 97, 158, 6, 249, 39, 216, 71, 184, 104, 151,
    13, 242, 45, 210, 78, 177, 110, 145, 19, 236, 52, 203, 84, 171, 117, 138,
    26, 229, 58, 197, 91, 164, 123, 132};
const int kColor24[24] = {
    0, 255, 33, 222, 66, 189, 99, 156, 11, 244, 44, 211, 77, 178, 110, 145,
    22, 233, 55, 200, 88, 167, 121, 134};
const int kColor192[192] = {
    0, 255, 4, 251, 8, 247, 12, 243, 16, 239, 20, 235, 24, 231, 28, 227,
    32, 223, 36, 219, 40, 215, 44, 211, 48, 207, 52, 203, 56, 199, 60, 195,
    64, 191, 68, 187, 72, 183, 76, 179, 80, 175, 84, 171, 88, 167, 92, 163,
    96, 159, 100, 155, 104, 151, 108, 147, 112, 143, 116, 139, 120, 135, 124, 131,
    1, 254, 5, 250, 9, 246, 13, 242, 17, 238, 21, 234, 25, 230, 29, 226,
    33, 222, 37, 218, 41, 214, 45, 210, 49, 206, 53, 202, 57, 198, 61, 194,
    65, 190, 69, 186, 73, 182, 77, 178, 81, 174, 85, 170, 89, 166, 93, 162,
    97, 158, 101, 154, 105, 150, 109, 146, 113, 142, 117, 138, 121, 134, 125, 130,
    2, 253, 6, 249, 10, 245, 14, 241, 18, 237, 22, 233, 26, 229, 30, 225,
    34, 221, 38, 217, 42, 213, 46, 209, 50, 205, 54, 201, 58, 197, 62, 193,
    66, 189, 70, 185, 74, 181, 78, 177, 82, 173, 86, 169, 90, 165, 94, 161,
    98, 157, 102, 153, 106, 149, 110, 145, 114, 141, 118, 137, 122, 133, 126, 129,
};
const int kColor96[96] = {
    0, 255, 8, 247, 16, 239, 24, 231, 32, 223, 40, 215, 48, 207, 56, 199,
    64, 191, 72, 183, 80, 175, 88, 167, 96, 159, 104, 151, 112, 143, 120,
    135, 2, 253, 10, 245, 18, 237, 26, 229, 35, 220, 43, 212, 51, 204, 59,
    196, 67, 188, 75, 180, 83, 172, 91, 164, 99, 156, 107, 148, 115, 140,
    123, 132, 5, 250, 13, 242, 21, 234, 29, 226, 37, 218, 45, 210, 53, 202,
    61, 194, 70, 185, 78, 177, 86, 169, 94, 161, 102, 153, 110, 145, 118,
    137, 126, 129};

struct ColorRange {
  int levels;
  int kind;  // 0 bits / 1 trit / 2 quint
  int bits;
  int unq[256];  // quantized value -> 0..255
  int nearest[256];  // 0..255 -> quantized value minimizing |unq - x|
};

void build_color_range(int levels, ColorRange* r) {
  r->levels = levels;
  if (levels == 256) {
    r->kind = 0; r->bits = 8;
    for (int v = 0; v < 256; ++v) r->unq[v] = v;
  } else if (levels == 16) {
    r->kind = 0; r->bits = 4;
    for (int v = 0; v < 16; ++v) r->unq[v] = (v << 4) | v;
  } else if (levels == 32) {
    r->kind = 0; r->bits = 5;
    for (int v = 0; v < 32; ++v) r->unq[v] = (v << 3) | (v >> 2);
  } else if (levels == 64) {
    r->kind = 0; r->bits = 6;
    for (int v = 0; v < 64; ++v) r->unq[v] = (v << 2) | (v >> 4);
  } else if (levels == 24) {
    r->kind = 1; r->bits = 3;
    for (int v = 0; v < 24; ++v) r->unq[v] = kColor24[v];
  } else if (levels == 40) {
    r->kind = 2; r->bits = 3;
    for (int v = 0; v < 40; ++v) r->unq[v] = kColor40[v];
  } else if (levels == 96) {
    r->kind = 1; r->bits = 5;
    for (int v = 0; v < 96; ++v) r->unq[v] = kColor96[v];
  } else if (levels == 192) {
    r->kind = 1; r->bits = 6;
    for (int v = 0; v < 192; ++v) r->unq[v] = kColor192[v];
  }
  else if (levels == 12) {
    static const int kColor12[12] = {0,   255, 69,  186, 23,  232,
                                     92,  163, 46,  209, 116, 139};
    r->kind = 1; r->bits = 2;
    for (int v = 0; v < 12; ++v) r->unq[v] = kColor12[v];
  }
  for (int x = 0; x < 256; ++x) {
    int best = 0, bd = 1 << 30;
    for (int v = 0; v < r->levels; ++v) {
      int d = r->unq[v] - x;
      d *= d;
      if (d < bd) { bd = d; best = v; }
    }
    r->nearest[x] = best;
  }
}

// ---------------------------------------------------------------------------
// Partition function (spec C.2.21)
// ---------------------------------------------------------------------------

uint32_t hash52(uint32_t p) {
  p ^= p >> 15;
  p -= p << 17;
  p += p << 7;
  p += p << 4;
  p ^= p >> 5;
  p += p << 16;
  p ^= p >> 7;
  p ^= p >> 3;
  p ^= p << 6;
  p ^= p >> 17;
  return p;
}

int select_partition(int seed, int x, int y, int partition_count) {
  // 4x4: small block -> coordinates doubled
  x <<= 1;
  y <<= 1;
  seed += (partition_count - 1) * 1024;
  uint32_t rnum = hash52((uint32_t)seed);
  int s[12];
  for (int i = 0; i < 8; ++i) s[i] = (rnum >> (4 * i)) & 0xF;
  s[8] = (rnum >> 18) & 0xF;
  s[9] = (rnum >> 22) & 0xF;
  s[10] = (rnum >> 26) & 0xF;
  s[11] = ((rnum >> 30) | (rnum << 2)) & 0xF;
  for (int& v : s) v *= v;
  int sh1, sh2;
  if (seed & 1) {
    sh1 = (seed & 2) ? 4 : 5;
    sh2 = partition_count == 3 ? 6 : 5;
  } else {
    sh1 = partition_count == 3 ? 6 : 5;
    sh2 = (seed & 2) ? 4 : 5;
  }
  int sh3 = (seed & 0x10) ? sh1 : sh2;
  int sd[12] = {s[0] >> sh1, s[1] >> sh2, s[2] >> sh1, s[3] >> sh2,
                s[4] >> sh1, s[5] >> sh2, s[6] >> sh1, s[7] >> sh2,
                s[8] >> sh3, s[9] >> sh3, s[10] >> sh3, s[11] >> sh3};
  int a = (sd[0] * x + sd[1] * y + (int)(rnum >> 14)) & 0x3F;
  int b = (sd[2] * x + sd[3] * y + (int)(rnum >> 10)) & 0x3F;
  int c = (sd[4] * x + sd[5] * y + (int)(rnum >> 6)) & 0x3F;
  int d = (sd[6] * x + sd[7] * y + (int)(rnum >> 2)) & 0x3F;
  if (partition_count < 4) d = 0;
  if (partition_count < 3) c = 0;
  if (partition_count < 2) b = 0;
  if (a >= b && a >= c && a >= d) return 0;
  if (b >= c && b >= d) return 1;
  if (c >= d) return 2;
  return 3;
}

struct PartTables {
  uint8_t part2[1024][16];
  uint8_t part3[1024][16];
  PartTables() {
    for (int seed = 0; seed < 1024; ++seed)
      for (int t = 0; t < 16; ++t) {
        part2[seed][t] =
            (uint8_t)select_partition(seed, t % 4, t / 4, 2);
        part3[seed][t] =
            (uint8_t)select_partition(seed, t % 4, t / 4, 3);
      }
  }
};
const PartTables& part_tables() {
  static PartTables t;
  return t;
}

// ---------------------------------------------------------------------------
// Layout fitting
// ---------------------------------------------------------------------------

struct Layout {
  int block_mode;   // 11-bit field (4x4 grid, single plane)
  const WRange* w;  // weight range
  int cem;          // 8 or 12
  int nparts;       // 1, 2 or 3
  const ColorRange* color;
};

struct Fitted {
  double err;
  int q[3][8];    // per-partition quantized color values (v0..)
  int wq[16];     // quantized weights per texel
};

inline int decode_texel(int e0, int e1, int w64) {
  int v0 = (e0 << 8) | e0;
  int v1 = (e1 << 8) | e1;
  return (((v0 * (64 - w64) + v1 * w64 + 32) >> 6) >> 8);
}

// Fit one layout for one block; px = 16*4 floats (0..255).
// part_of: texel -> partition (all zero for 1-partition).
double fit_layout(const float* px, const Layout& L, const uint8_t* part_of,
                  int iters, Fitted* out) {
  int nch = L.cem == 12 ? 4 : 3;
  // per-partition float endpoints
  float e0[3][4], e1[3][4];
  for (int p = 0; p < L.nparts; ++p) {
    // PCA seed
    float mean[4] = {0, 0, 0, 0};
    int cnt = 0;
    for (int t = 0; t < 16; ++t) {
      if (part_of[t] != p) continue;
      ++cnt;
      for (int c = 0; c < nch; ++c) mean[c] += px[t * 4 + c];
    }
    if (!cnt) cnt = 1;
    for (int c = 0; c < nch; ++c) mean[c] /= cnt;
    double cov[4][4] = {};
    for (int t = 0; t < 16; ++t) {
      if (part_of[t] != p) continue;
      for (int c = 0; c < nch; ++c)
        for (int d = 0; d < nch; ++d)
          cov[c][d] += (px[t * 4 + c] - mean[c]) * (px[t * 4 + d] - mean[d]);
    }
    double axis[4] = {1, 1, 1, 1};
    for (int it = 0; it < 4; ++it) {
      double nv[4] = {}, nn = 0;
      for (int c = 0; c < nch; ++c)
        for (int d = 0; d < nch; ++d) nv[c] += cov[c][d] * axis[d];
      for (int c = 0; c < nch; ++c) nn += nv[c] * nv[c];
      nn = std::sqrt(nn);
      if (nn < 1e-10) break;
      for (int c = 0; c < nch; ++c) axis[c] = nv[c] / nn;
    }
    float tmin = 1e30f, tmax = -1e30f;
    for (int t = 0; t < 16; ++t) {
      if (part_of[t] != p) continue;
      float tt = 0;
      for (int c = 0; c < nch; ++c)
        tt += (px[t * 4 + c] - mean[c]) * (float)axis[c];
      tmin = std::min(tmin, tt);
      tmax = std::max(tmax, tt);
    }
    for (int c = 0; c < 4; ++c) {
      e0[p][c] = c < nch
                     ? std::min(255.f, std::max(0.f, mean[c] + (float)axis[c] * tmin))
                     : 255.f;
      e1[p][c] = c < nch
                     ? std::min(255.f, std::max(0.f, mean[c] + (float)axis[c] * tmax))
                     : 255.f;
    }
  }

  double best_err = 1e30;
  for (int it = 0; it <= iters; ++it) {
    // quantize endpoints; enforce no-blue-contract ordering (s0 <= s1)
    int d0[3][4], d1[3][4], qv[3][8];
    for (int p = 0; p < L.nparts; ++p) {
      for (int c = 0; c < nch; ++c) {
        int x0 = (int)std::lround(e0[p][c]);
        int x1 = (int)std::lround(e1[p][c]);
        x0 = std::min(255, std::max(0, x0));
        x1 = std::min(255, std::max(0, x1));
        int q0 = L.color->nearest[x0], q1 = L.color->nearest[x1];
        d0[p][c] = L.color->unq[q0];
        d1[p][c] = L.color->unq[q1];
        if (L.cem == 8) {
          qv[p][2 * c] = q0;
          qv[p][2 * c + 1] = q1;
        } else {  // CEM 12: r0 r1 g0 g1 b0 b1 a0 a1
          qv[p][2 * c] = q0;
          qv[p][2 * c + 1] = q1;
        }
      }
      if (L.cem == 8) {  // implicit opaque alpha
        d0[p][3] = 255;
        d1[p][3] = 255;
      }
      int s0 = d0[p][0] + d0[p][1] + d0[p][2];
      int s1 = d1[p][0] + d1[p][1] + d1[p][2];
      if (s0 > s1) {  // swap to dodge blue-contract; weights re-chosen below
        for (int c = 0; c < 4; ++c) std::swap(d0[p][c], d1[p][c]);
        for (int c = 0; c < nch; ++c) std::swap(qv[p][2 * c], qv[p][2 * c + 1]);
      }
    }
    // exact per-texel weight sweep
    double err = 0;
    int wq[16];
    float wfrac[16];
    for (int t = 0; t < 16; ++t) {
      int p = part_of[t];
      double be = 1e30;
      int bw = 0;
      for (int w = 0; w < L.w->levels; ++w) {
        int w64 = L.w->unq[w];
        double e = 0;
        for (int c = 0; c < 4; ++c) {
          int dc = decode_texel(d0[p][c], d1[p][c], w64);
          double d = px[t * 4 + c] - dc;
          e += d * d;
        }
        if (e < be) { be = e; bw = w; }
      }
      wq[t] = bw;
      wfrac[t] = L.w->unq[bw] / 64.0f;
      err += be;
    }
    if (err < best_err) {
      best_err = err;
      std::memcpy(out->wq, wq, sizeof wq);
      for (int p = 0; p < L.nparts; ++p)
        std::memcpy(out->q[p], qv[p], sizeof qv[p]);
    }
    if (it == iters) break;
    // LS refine per partition from the weight fractions
    for (int p = 0; p < L.nparts; ++p) {
      double a = 0, b = 0, c2 = 0, r0[4] = {}, r1[4] = {};
      for (int t = 0; t < 16; ++t) {
        if (part_of[t] != p) continue;
        double w = wfrac[t];
        a += w * w;
        b += w * (1 - w);
        c2 += (1 - w) * (1 - w);
        for (int c = 0; c < nch; ++c) {
          r1[c] += w * px[t * 4 + c];
          r0[c] += (1 - w) * px[t * 4 + c];
        }
      }
      double det = a * c2 - b * b;
      if (std::fabs(det) < 1e-6) continue;
      for (int c = 0; c < nch; ++c) {
        double n1 = (c2 * r1[c] - b * r0[c]) / det;
        double n0 = (a * r0[c] - b * r1[c]) / det;
        e1[p][c] = (float)std::min(255.0, std::max(0.0, n1));
        e0[p][c] = (float)std::min(255.0, std::max(0.0, n0));
      }
    }
  }
  out->err = best_err;
  return best_err;
}

// ---------------------------------------------------------------------------
// Block assembly
// ---------------------------------------------------------------------------

void set_bit(uint8_t* blk, int pos, int v) {
  if (v) blk[pos >> 3] |= (uint8_t)(1 << (pos & 7));
}

void pack_block(const Layout& L, const Fitted& f, int seed, uint8_t* blk) {
  std::memset(blk, 0, 16);
  for (int i = 0; i < 11; ++i) set_bit(blk, i, (L.block_mode >> i) & 1);
  set_bit(blk, 11, (L.nparts - 1) & 1);
  set_bit(blk, 12, ((L.nparts - 1) >> 1) & 1);
  int color_start;
  if (L.nparts == 1) {
    for (int i = 0; i < 4; ++i) set_bit(blk, 13 + i, (L.cem >> i) & 1);
    color_start = 17;
  } else {
    for (int i = 0; i < 10; ++i) set_bit(blk, 13 + i, (seed >> i) & 1);
    int cem_field = L.cem << 2;  // all-same-CEM encoding (low bits 0)
    for (int i = 0; i < 6; ++i) set_bit(blk, 23 + i, (cem_field >> i) & 1);
    color_start = 29;
  }
  // color ISE
  int nper = 2 * ((L.cem >> 2) + 1);
  int vals[24];
  for (int p = 0; p < L.nparts; ++p)
    for (int i = 0; i < nper; ++i) vals[p * nper + i] = f.q[p][i];
  std::vector<uint8_t> cbits;
  ise_encode(vals, nper * L.nparts, L.color->kind, L.color->bits, &cbits);
  for (size_t i = 0; i < cbits.size(); ++i)
    set_bit(blk, color_start + (int)i, cbits[i]);
  // weights: stream bit j at block bit 127-j
  std::vector<uint8_t> wbits;
  ise_encode(f.wq, 16, L.w->kind, L.w->bits, &wbits);
  for (size_t i = 0; i < wbits.size(); ++i)
    set_bit(blk, 127 - (int)i, wbits[i]);
}

// ---------------------------------------------------------------------------
// Dual-plane fit (CEM 12, 1 partition): plane 0 drives every channel
// except `ccs`, plane 1 drives `ccs` (spec C.2.10) — the thorough-tier
// layout astcenc's "1 plane of 2" trials cover at THOROUGH/EXHAUSTIVE.
// ---------------------------------------------------------------------------

struct FittedDP {
  double err;
  int q[8];                 // CEM 12 quantized color values
  int wq0[16], wq1[16];     // per-texel quantized weights, plane 0 / 1
};

double fit_dual(const float* px, const WRange* W, const ColorRange* C,
                int ccs, int iters, FittedDP* out) {
  int rest[3], nr = 0;
  for (int c = 0; c < 4; ++c)
    if (c != ccs) rest[nr++] = c;

  // plane-0 seed: PCA over the rest channels; plane-1 seed: min/max.
  float mean[3] = {0, 0, 0};
  for (int t = 0; t < 16; ++t)
    for (int i = 0; i < 3; ++i) mean[i] += px[t * 4 + rest[i]];
  for (int i = 0; i < 3; ++i) mean[i] /= 16.0f;
  double cov[3][3] = {};
  for (int t = 0; t < 16; ++t)
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        cov[i][j] += (px[t * 4 + rest[i]] - mean[i]) *
                     (px[t * 4 + rest[j]] - mean[j]);
  double axis[3] = {1, 1, 1};
  for (int it = 0; it < 4; ++it) {
    double nv[3] = {}, nn = 0;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) nv[i] += cov[i][j] * axis[j];
    for (int i = 0; i < 3; ++i) nn += nv[i] * nv[i];
    nn = std::sqrt(nn);
    if (nn < 1e-10) break;
    for (int i = 0; i < 3; ++i) axis[i] = nv[i] / nn;
  }
  float tmin = 1e30f, tmax = -1e30f, amin = 1e30f, amax = -1e30f;
  for (int t = 0; t < 16; ++t) {
    float tt = 0;
    for (int i = 0; i < 3; ++i)
      tt += (px[t * 4 + rest[i]] - mean[i]) * (float)axis[i];
    tmin = std::min(tmin, tt);
    tmax = std::max(tmax, tt);
    amin = std::min(amin, px[t * 4 + ccs]);
    amax = std::max(amax, px[t * 4 + ccs]);
  }
  float e0[4], e1[4];
  for (int i = 0; i < 3; ++i) {
    e0[rest[i]] =
        std::min(255.f, std::max(0.f, mean[i] + (float)axis[i] * tmin));
    e1[rest[i]] =
        std::min(255.f, std::max(0.f, mean[i] + (float)axis[i] * tmax));
  }
  e0[ccs] = amin;
  e1[ccs] = amax;

  double best_err = 1e30;
  for (int it = 0; it <= iters; ++it) {
    int d0[4], d1[4], qv[8];
    for (int c = 0; c < 4; ++c) {
      int x0 = std::min(255, std::max(0, (int)std::lround(e0[c])));
      int x1 = std::min(255, std::max(0, (int)std::lround(e1[c])));
      int q0 = C->nearest[x0], q1 = C->nearest[x1];
      d0[c] = C->unq[q0];
      d1[c] = C->unq[q1];
      qv[2 * c] = q0;
      qv[2 * c + 1] = q1;
    }
    // no-blue-contract ordering: swap BOTH planes' endpoints as a unit
    // (decode swaps e0/e1 globally); weights re-chosen below.
    int s0 = d0[0] + d0[1] + d0[2];
    int s1 = d1[0] + d1[1] + d1[2];
    if (s0 > s1) {
      for (int c = 0; c < 4; ++c) std::swap(d0[c], d1[c]);
      for (int c = 0; c < 4; ++c) std::swap(qv[2 * c], qv[2 * c + 1]);
    }
    double err = 0;
    int wq0[16], wq1[16];
    float wf0[16], wf1[16];
    for (int t = 0; t < 16; ++t) {
      double be = 1e30;
      int bw = 0;
      for (int w = 0; w < W->levels; ++w) {
        int w64 = W->unq[w];
        double e = 0;
        for (int i = 0; i < 3; ++i) {
          int c = rest[i];
          int dc = decode_texel(d0[c], d1[c], w64);
          double d = px[t * 4 + c] - dc;
          e += d * d;
        }
        if (e < be) { be = e; bw = w; }
      }
      wq0[t] = bw;
      wf0[t] = W->unq[bw] / 64.0f;
      err += be;
      be = 1e30;
      bw = 0;
      for (int w = 0; w < W->levels; ++w) {
        int dc = decode_texel(d0[ccs], d1[ccs], W->unq[w]);
        double d = px[t * 4 + ccs] - dc;
        if (d * d < be) { be = d * d; bw = w; }
      }
      wq1[t] = bw;
      wf1[t] = W->unq[bw] / 64.0f;
      err += be;
    }
    if (err < best_err) {
      best_err = err;
      std::memcpy(out->wq0, wq0, sizeof wq0);
      std::memcpy(out->wq1, wq1, sizeof wq1);
      std::memcpy(out->q, qv, sizeof qv);
    }
    if (it == iters) break;
    // LS refine per plane
    for (int pl = 0; pl < 2; ++pl) {
      const float* wf = pl == 0 ? wf0 : wf1;
      double a = 0, b = 0, c2 = 0;
      double r0[4] = {}, r1[4] = {};
      for (int t = 0; t < 16; ++t) {
        double w = wf[t];
        a += w * w;
        b += w * (1 - w);
        c2 += (1 - w) * (1 - w);
        if (pl == 0) {
          for (int i = 0; i < 3; ++i) {
            r1[rest[i]] += w * px[t * 4 + rest[i]];
            r0[rest[i]] += (1 - w) * px[t * 4 + rest[i]];
          }
        } else {
          r1[ccs] += w * px[t * 4 + ccs];
          r0[ccs] += (1 - w) * px[t * 4 + ccs];
        }
      }
      double det = a * c2 - b * b;
      if (std::fabs(det) < 1e-6) continue;
      for (int c = 0; c < 4; ++c) {
        bool mine = (pl == 1) == (c == ccs);
        if (!mine) continue;
        double n1 = (c2 * r1[c] - b * r0[c]) / det;
        double n0 = (a * r0[c] - b * r1[c]) / det;
        e1[c] = (float)std::min(255.0, std::max(0.0, n1));
        e0[c] = (float)std::min(255.0, std::max(0.0, n0));
      }
    }
  }
  out->err = best_err;
  return best_err;
}

void pack_block_dp(int block_mode, const FittedDP& f, int ccs,
                   const WRange* W, const ColorRange* C, uint8_t* blk) {
  std::memset(blk, 0, 16);
  for (int i = 0; i < 11; ++i) set_bit(blk, i, (block_mode >> i) & 1);
  // nparts = 1: bits 11..12 zero; CEM 12 at 13..16
  for (int i = 0; i < 4; ++i) set_bit(blk, 13 + i, (12 >> i) & 1);
  std::vector<uint8_t> cbits;
  ise_encode(f.q, 8, C->kind, C->bits, &cbits);
  for (size_t i = 0; i < cbits.size(); ++i)
    set_bit(blk, 17 + (int)i, cbits[i]);
  // plane-interleaved weights, reversed from bit 127
  int wv[32];
  for (int t = 0; t < 16; ++t) {
    wv[2 * t] = f.wq0[t];
    wv[2 * t + 1] = f.wq1[t];
  }
  std::vector<uint8_t> wbits;
  ise_encode(wv, 32, W->kind, W->bits, &wbits);
  for (size_t i = 0; i < wbits.size(); ++i)
    set_bit(blk, 127 - (int)i, wbits[i]);
  // CCS: two bits directly below the weight data
  int ccs_pos = 128 - (int)wbits.size() - 2;
  set_bit(blk, ccs_pos, ccs & 1);
  set_bit(blk, ccs_pos + 1, (ccs >> 1) & 1);
}

// ---------------------------------------------------------------------------
// Per-block encode
// ---------------------------------------------------------------------------

struct Ranges {
  ColorRange c256, c192, c96, c64, c40, c24, c16, c12;
  WRange w4, w5, w6, w8, w12, w16, w24;
  Ranges() {
    build_color_range(256, &c256);
    build_color_range(192, &c192);
    build_color_range(96, &c96);
    build_color_range(64, &c64);
    build_color_range(40, &c40);
    build_color_range(24, &c24);
    build_color_range(16, &c16);
    build_color_range(12, &c12);
    build_weight_range(4, &w4);
    build_weight_range(5, &w5);
    build_weight_range(6, &w6);
    build_weight_range(8, &w8);
    build_weight_range(12, &w12);
    build_weight_range(16, &w16);
    build_weight_range(24, &w24);
  }
};
const Ranges& ranges() {
  static Ranges r;
  return r;
}

void encode_block(const float* px, int quality, uint8_t* out_blk) {
  const Ranges& R = ranges();
  // 4x4-grid block modes (cfg 00, bb=0 -> gw=4, a=2 -> gh=4; mode bits
  // [1:0]=r[2:1], [4]=r[0], [6:5]=a, [9]=h): each weight range's (r, h)
  // per the spec ladder in decode/astc.py `_WEIGHT_RANGE_FROM_RH`.
  const int bm4 = 2 | (2 << 5);                 // (100, 0) ->  4 levels
  const int bm6 = 3 | (2 << 5);                 // (110, 0) ->  6
  const int bm8 = 3 | (1 << 4) | (2 << 5);      // (111, 0) ->  8
  const int bm12 = 1 | (1 << 4) | (2 << 5) | (1 << 9);  // (011,1) -> 12
  const int bm16 = 2 | (2 << 5) | (1 << 9);     // (100, 1) -> 16
  const int bm24 = 3 | (2 << 5) | (1 << 9);     // (110, 1) -> 24

  bool has_alpha = false;
  for (int t = 0; t < 16; ++t)
    if (px[t * 4 + 3] < 254.5f) { has_alpha = true; break; }

  std::vector<Layout> layouts;
  int iters = quality <= 0 ? 1 : (quality >= 4 ? 5 : quality + 1);
  layouts.push_back({bm8, &R.w8, 8, 1, &R.c256});              // A
  if (quality >= 1)
    layouts.push_back({bm12, &R.w12, 8, 1, &R.c256});          // A2
  if (quality >= 2) {
    layouts.push_back({bm16, &R.w16, 8, 1, &R.c192});          // B
    layouts.push_back({bm24, &R.w24, 8, 1, &R.c64});           // B2
  }
  if (has_alpha) {
    layouts.push_back({bm4, &R.w4, 12, 1, &R.c256});           // C
    if (quality >= 2) {
      layouts.push_back({bm8, &R.w8, 12, 1, &R.c192});         // D
      layouts.push_back({bm12, &R.w12, 12, 1, &R.c96});        // C2
    }
  }

  uint8_t part0[16] = {};
  Fitted f, best_f;
  double best = 1e30;
  Layout best_L = layouts[0];
  int best_seed = 0;
  for (const Layout& L : layouts) {
    if (fit_layout(px, L, part0, iters, &f) < best) {
      best = f.err;
      best_f = f;
      best_L = L;
    }
  }

  if (quality >= 2) {
    // 2-partition: screen all 1024 seeds by cluster SSE, deep-fit top K.
    // Partition-index limits per preset class (astcenc's
    // tune_2partition_index_limit role: fast / medium / thorough).
    int K = quality >= 4 ? 16 : (quality >= 3 ? 8 : 4);
    struct Scored { double sse; int seed; };
    std::vector<Scored> scored;
    scored.reserve(1024);
    for (int seed = 0; seed < 1024; ++seed) {
      const uint8_t* po = part_tables().part2[seed];
      double sum[2][4] = {}, sq = 0;
      int cnt[2] = {};
      for (int t = 0; t < 16; ++t) {
        int p = po[t];
        ++cnt[p];
        for (int c = 0; c < 4; ++c) {
          sum[p][c] += px[t * 4 + c];
          sq += px[t * 4 + c] * px[t * 4 + c];
        }
      }
      if (!cnt[0] || !cnt[1]) continue;
      double expl = 0;
      for (int p = 0; p < 2; ++p) {
        double m2 = 0;
        for (int c = 0; c < 4; ++c) m2 += sum[p][c] * sum[p][c];
        expl += m2 / cnt[p];
      }
      scored.push_back({sq - expl, seed});
    }
    std::partial_sort(
        scored.begin(), scored.begin() + std::min<size_t>(K, scored.size()),
        scored.end(), [](const Scored& a, const Scored& b) {
          return a.sse < b.sse;
        });
    std::vector<Layout> plays;
    plays.push_back({bm4, &R.w4, 8, 2, &R.c40});            // E
    plays.push_back({bm6, &R.w6, 8, 2, &R.c24});            // E2
    if (quality >= 4) {
      plays.push_back({bm8, &R.w8, 8, 2, &R.c16});          // G
      if (has_alpha) plays.push_back({bm4, &R.w4, 12, 2, &R.c16});  // F
    }
    for (int k = 0; k < (int)std::min<size_t>(K, scored.size()); ++k) {
      int seed = scored[k].seed;
      const uint8_t* po = part_tables().part2[seed];
      for (const Layout& L : plays) {
        if (fit_layout(px, L, po, iters, &f) < best) {
          best = f.err;
          best_f = f;
          best_L = L;
          best_seed = seed;
        }
      }
    }
  }

  // Thorough tier (astcenc THOROUGH/EXHAUSTIVE breadth,
  // AstcConverter.cpp:174-195): 3-partition sweep + dual-plane trials.
  bool best_is_dp = false;
  FittedDP best_dp;
  int best_ccs = 0;
  if (quality >= 4) {
    // 3-partition CEM 8 (grid 4x4, 4-level weights, 12-level color —
    // the implied-range layout, mirroring the TPU menu's kernel C).
    struct Scored3 { double sse; int seed; };
    std::vector<Scored3> sc3;
    sc3.reserve(1024);
    for (int seed = 0; seed < 1024; ++seed) {
      const uint8_t* po = part_tables().part3[seed];
      double sum[3][4] = {}, sq = 0;
      int cnt[3] = {};
      for (int t = 0; t < 16; ++t) {
        int p = po[t];
        ++cnt[p];
        for (int c = 0; c < 4; ++c) {
          sum[p][c] += px[t * 4 + c];
          sq += px[t * 4 + c] * px[t * 4 + c];
        }
      }
      if (!cnt[0] || !cnt[1] || !cnt[2]) continue;
      double expl = 0;
      for (int p = 0; p < 3; ++p) {
        double m2 = 0;
        for (int c = 0; c < 4; ++c) m2 += sum[p][c] * sum[p][c];
        expl += m2 / cnt[p];
      }
      sc3.push_back({sq - expl, seed});
    }
    const int K3 = 4;
    std::partial_sort(
        sc3.begin(), sc3.begin() + std::min<size_t>(K3, sc3.size()),
        sc3.end(), [](const Scored3& a, const Scored3& b) {
          return a.sse < b.sse;
        });
    Layout L3 = {bm4, &R.w4, 8, 3, &R.c12};
    for (int k = 0; k < (int)std::min<size_t>(K3, sc3.size()); ++k) {
      int seed = sc3[k].seed;
      if (fit_layout(px, L3, part_tables().part3[seed], iters, &f) < best) {
        best = f.err;
        best_f = f;
        best_L = L3;
        best_seed = seed;
      }
    }

    // Dual-plane CEM 12 (grid 4x4, 5-level weights, 16-level color), all
    // four CCS candidates.
    const int bm5dp = 1106;  // block_mode_field(4, 4, 5, dual=True)
    FittedDP fdp;
    for (int ccs = 0; ccs < 4; ++ccs) {
      if (fit_dual(px, &R.w5, &R.c16, ccs, iters, &fdp) < best) {
        best = fdp.err;
        best_dp = fdp;
        best_ccs = ccs;
        best_is_dp = true;
      }
    }
    (void)bm5dp;
  }

  if (best_is_dp)
    pack_block_dp(1106, best_dp, best_ccs, &R.w5, &R.c16, out_blk);
  else
    pack_block(best_L, best_f, best_seed, out_blk);
}


// ===========================================================================
// Generalized NxM encoder (6x6 / 8x8 quality baselines, decimated weight
// grids via the spec C.2.18 bilinear infill).  The 4x4 path above stays
// untouched; this section backs tests/test_cpu_reference.py's larger-size
// rows the same way.
// ===========================================================================

#include "astc_color_tables.inc"

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct ColorRangeG {
  int levels, kind, bits;
  const int* unq;
  uint8_t nearest[256];
};

std::mutex& g_cache_mu() {
  static std::mutex mu;
  return mu;
}

const ColorRangeG* color_range_g(int levels) {
  static ColorRangeG cache[32];
  static int cached[32];
  static int ncached = 0;
  std::lock_guard<std::mutex> lock(g_cache_mu());
  for (int i = 0; i < ncached; ++i)
    if (cached[i] == levels) return &cache[i];
  for (int d = 0; d < kNumColorDefs; ++d) {
    if (kColorDefs[d].levels != levels) continue;
    ColorRangeG* r = &cache[ncached];
    cached[ncached++] = levels;
    r->levels = levels;
    r->kind = kColorDefs[d].kind;
    r->bits = kColorDefs[d].bits;
    r->unq = kColorDefs[d].unq;
    for (int x = 0; x < 256; ++x) {
      int best = 0, bd = 1 << 30;
      for (int v = 0; v < levels; ++v) {
        int dd = r->unq[v] - x;
        dd *= dd;
        if (dd < bd) { bd = dd; best = v; }
      }
      r->nearest[x] = (uint8_t)best;
    }
    return r;
  }
  return nullptr;
}

// Spec C.2.22 implied color range: the LARGEST ladder range whose ISE
// stream fits the leftover budget (must match decode/astc.py exactly).
int implied_color_levels(int nvals, int budget) {
  static const int ladder[] = {256, 192, 160, 128, 96, 80, 64, 48, 40, 32,
                               24, 20, 16, 12, 10, 8, 6, 5, 4, 3, 2};
  for (int lv : ladder) {
    int kind, b;
    if (lv == 3) { kind = 1; b = 0; }
    else if (lv == 5) { kind = 2; b = 0; }
    else {
      const ColorRangeG* r = color_range_g(lv);
      if (!r) continue;
      kind = r->kind;
      b = r->bits;
    }
    if (ise_bits(nvals, kind, b) <= budget) return lv;
  }
  return 0;
}

// kernels/astc.py:block_mode_field (primary rows only, single plane).
int block_mode_for(int gw, int gh, int wlevels) {
  struct RH { int lv, r, h; };
  static const RH rh[] = {{2, 2, 0}, {3, 3, 0}, {4, 4, 0}, {5, 5, 0},
                          {6, 6, 0}, {8, 7, 0}, {10, 2, 1}, {12, 3, 1},
                          {16, 4, 1}, {20, 5, 1}, {24, 6, 1}, {32, 7, 1}};
  int r = -1, h = 0;
  for (auto& e : rh)
    if (e.lv == wlevels) { r = e.r; h = e.h; }
  if (r < 0) return -1;
  int r0 = r & 1, r21 = r >> 1, a, b, cfg;
  if (4 <= gw && gw <= 7 && 2 <= gh && gh <= 5) {
    b = gw - 4; a = gh - 2; cfg = 0;
  } else if (8 <= gw && gw <= 11 && 2 <= gh && gh <= 5) {
    b = gw - 8; a = gh - 2; cfg = 1;
  } else if (2 <= gw && gw <= 5 && 8 <= gh && gh <= 11) {
    b = gh - 8; a = gw - 2; cfg = 2;
  } else {
    // Extended rows (bits[1:0]==00): mirror of
    // kernels/astc.py:block_mode_field.
    int base = (r21 << 2) | (r0 << 4);
    if (gw == 12 && 2 <= gh && gh <= 5)
      return (h << 9) | (0 << 7) | ((gh - 2) << 5) | base;
    if (gh == 12 && 2 <= gw && gw <= 5)
      return (h << 9) | (1 << 7) | ((gw - 2) << 5) | base;
    if (gw == 6 && gh == 10) return (h << 9) | (3 << 7) | (0 << 5) | base;
    if (gw == 10 && gh == 6) return (h << 9) | (3 << 7) | (1 << 5) | base;
    if (6 <= gw && gw <= 9 && 6 <= gh && gh <= 9) {
      if (h) return -1;  // no H bit on these rows
      return ((gh - 6) << 9) | (2 << 7) | ((gw - 6) << 5) | base;
    }
    return -1;
  }
  return (h << 9) | (b << 7) | (a << 5) | (r0 << 4) | (cfg << 2) | r21;
}

const WRange* weight_range_g(int levels) {
  static WRange cache[16];
  static int cached[16];
  static int ncached = 0;
  std::lock_guard<std::mutex> lock(g_cache_mu());
  for (int i = 0; i < ncached; ++i)
    if (cached[i] == levels) return &cache[i];
  WRange* r = &cache[ncached];
  cached[ncached++] = levels;
  build_weight_range(levels, r);
  return r;
}

int wkind_of(int levels) {
  switch (levels) {
    case 3: case 6: case 12: case 24: return 1;
    case 5: case 10: case 20: return 2;
    default: return 0;
  }
}
int wbits_of(int levels) {
  switch (levels) {
    case 2: return 1; case 4: return 2; case 8: return 3; case 16: return 4;
    case 32: return 5; case 3: return 0; case 6: return 1; case 12: return 2;
    case 24: return 3; case 5: return 0; case 10: return 1; case 20: return 2;
  }
  return 0;
}

struct LayoutG {
  int gw, gh, wlevels, cem, nparts, block_mode, nweights, wbits;
  const WRange* w;
  const ColorRangeG* color;
};

bool make_layout_g(int bw, int bh, int nparts, int cem, int gw, int gh,
                   int wl, LayoutG* out) {
  int bm = block_mode_for(gw, gh, wl);
  if (bm < 0 || gw > bw || gh > bh) return false;
  int nweights = gw * gh;
  if (nweights > 64) return false;
  int wbits = ise_bits(nweights, wkind_of(wl), wbits_of(wl));
  if (wbits < 24 || wbits > 96) return false;
  int nvals = nparts * 2 * ((cem >> 2) + 1);
  if (nvals > 18) return false;
  int header = nparts == 1 ? 17 : 29;
  int budget = 128 - header - wbits;
  int levels = implied_color_levels(nvals, budget);
  const ColorRangeG* cr = color_range_g(levels);
  if (!cr || levels < 16) return false;
  out->gw = gw; out->gh = gh; out->wlevels = wl; out->cem = cem;
  out->nparts = nparts; out->block_mode = bm; out->nweights = nweights;
  out->wbits = wbits; out->w = weight_range_g(wl); out->color = cr;
  return true;
}

// Spec C.2.18 bilinear infill matrix: A[t*G+j], weights /16.  Cached.
struct Infill {
  int bw, bh, gw, gh;
  std::vector<int> a;                 // [T*G]
  std::vector<std::vector<int>> foot; // grid point -> texel list
};
const Infill* infill_g(int bw, int bh, int gw, int gh) {
  static std::vector<Infill*> cache;
  std::lock_guard<std::mutex> lock(g_cache_mu());
  for (auto* f : cache)
    if (f->bw == bw && f->bh == bh && f->gw == gw && f->gh == gh) return f;
  Infill* f = new Infill{bw, bh, gw, gh, {}, {}};
  int T = bw * bh, G = gw * gh;
  f->a.assign(T * G, 0);
  f->foot.assign(G, {});
  int ds = (1024 + bw / 2) / (bw - 1);
  int dt = (1024 + bh / 2) / (bh - 1);
  for (int ty = 0; ty < bh; ++ty)
    for (int tx = 0; tx < bw; ++tx) {
      int cs = ds * tx, ct = dt * ty;
      int gs = (cs * (gw - 1) + 32) >> 6;
      int gt = (ct * (gh - 1) + 32) >> 6;
      int js = gs >> 4, fs = gs & 0xF;
      int jt = gt >> 4, ft = gt & 0xF;
      int w11 = (fs * ft + 8) >> 4;
      int w01 = fs - w11, w10 = ft - w11, w00 = 16 - fs - ft + w11;
      int t = ty * bw + tx;
      const int js_[4] = {js, js + 1, js, js + 1};
      const int jt_[4] = {jt, jt, jt + 1, jt + 1};
      const int w_[4] = {w00, w01, w10, w11};
      for (int k = 0; k < 4; ++k)
        if (w_[k] && js_[k] < gw && jt_[k] < gh)
          f->a[t * G + jt_[k] * gw + js_[k]] += w_[k];
    }
  for (int j = 0; j < G; ++j)
    for (int t = 0; t < T; ++t)
      if (f->a[t * G + j]) f->foot[j].push_back(t);
  cache.push_back(f);
  return f;
}

// Sized partition tables: no coordinate doubling for blocks >= 31 texels.
int select_partition_g(int seed, int x, int y, int partition_count,
                       bool small_block) {
  if (small_block) { x <<= 1; y <<= 1; }
  seed += (partition_count - 1) * 1024;
  uint32_t rnum = hash52((uint32_t)seed);
  int s[12];
  for (int i = 0; i < 8; ++i) s[i] = (rnum >> (4 * i)) & 0xF;
  s[8] = (rnum >> 18) & 0xF;
  s[9] = (rnum >> 22) & 0xF;
  s[10] = (rnum >> 26) & 0xF;
  s[11] = ((rnum >> 30) | (rnum << 2)) & 0xF;
  for (int& v : s) v *= v;
  int sh1, sh2;
  if (seed & 1) {
    sh1 = (seed & 2) ? 4 : 5;
    sh2 = partition_count == 3 ? 6 : 5;
  } else {
    sh1 = partition_count == 3 ? 6 : 5;
    sh2 = (seed & 2) ? 4 : 5;
  }
  int sh3 = (seed & 0x10) ? sh1 : sh2;
  int sd[12] = {s[0] >> sh1, s[1] >> sh2, s[2] >> sh1, s[3] >> sh2,
                s[4] >> sh1, s[5] >> sh2, s[6] >> sh1, s[7] >> sh2,
                s[8] >> sh3, s[9] >> sh3, s[10] >> sh3, s[11] >> sh3};
  int a = (sd[0] * x + sd[1] * y + (int)(rnum >> 14)) & 0x3F;
  int b = (sd[2] * x + sd[3] * y + (int)(rnum >> 10)) & 0x3F;
  int c = (sd[4] * x + sd[5] * y + (int)(rnum >> 6)) & 0x3F;
  int d = (sd[6] * x + sd[7] * y + (int)(rnum >> 2)) & 0x3F;
  if (partition_count < 4) d = 0;
  if (partition_count < 3) c = 0;
  if (partition_count < 2) b = 0;
  if (a >= b && a >= c && a >= d) return 0;
  if (b >= c && b >= d) return 1;
  if (c >= d) return 2;
  return 3;
}

const std::vector<std::array<uint8_t, 144>>& part2_tables_g(int bw, int bh) {
  struct Entry {
    int bw, bh;
    std::vector<std::array<uint8_t, 144>> tab;
  };
  static std::vector<Entry*> cache;
  std::lock_guard<std::mutex> lock(g_cache_mu());
  for (auto* e : cache)
    if (e->bw == bw && e->bh == bh) return e->tab;
  Entry* e = new Entry{bw, bh, {}};
  bool small = bw * bh < 31;
  e->tab.resize(1024);
  for (int seed = 0; seed < 1024; ++seed)
    for (int y = 0; y < bh; ++y)
      for (int x = 0; x < bw; ++x)
        e->tab[seed][y * bw + x] =
            (uint8_t)select_partition_g(seed, x, y, 2, small);
  cache.push_back(e);
  return e->tab;
}

struct FittedG {
  double err;
  int q[2][8];
  int gq[64];  // quantized grid weight values
};

// Solve the dense G x G normal equations (Gaussian, partial pivot).
bool solve_dense(std::vector<double>& m, std::vector<double>& rhs, int g) {
  for (int col = 0; col < g; ++col) {
    int piv = col;
    for (int r2 = col + 1; r2 < g; ++r2)
      if (std::fabs(m[r2 * g + col]) > std::fabs(m[piv * g + col])) piv = r2;
    if (std::fabs(m[piv * g + col]) < 1e-9) return false;
    if (piv != col) {
      for (int c = 0; c < g; ++c) std::swap(m[col * g + c], m[piv * g + c]);
      std::swap(rhs[col], rhs[piv]);
    }
    double inv = 1.0 / m[col * g + col];
    for (int r2 = col + 1; r2 < g; ++r2) {
      double f = m[r2 * g + col] * inv;
      if (f == 0) continue;
      for (int c = col; c < g; ++c) m[r2 * g + c] -= f * m[col * g + c];
      rhs[r2] -= f * rhs[col];
    }
  }
  for (int col = g - 1; col >= 0; --col) {
    double v = rhs[col];
    for (int c = col + 1; c < g; ++c) v -= m[col * g + c] * rhs[c];
    rhs[col] = v / m[col * g + col];
  }
  return true;
}

double fit_layout_g(const float* px, int T, int bw, int bh, const LayoutG& L,
                    const uint8_t* part_of, int iters, FittedG* out) {
  int nch = L.cem == 12 ? 4 : 3;
  int G = L.nweights;
  const Infill* inf = infill_g(bw, bh, L.gw, L.gh);

  float e0[2][4], e1[2][4];
  for (int p = 0; p < L.nparts; ++p) {
    float mean[4] = {0, 0, 0, 0};
    int cnt = 0;
    for (int t = 0; t < T; ++t) {
      if (part_of[t] != p) continue;
      ++cnt;
      for (int c = 0; c < nch; ++c) mean[c] += px[t * 4 + c];
    }
    if (!cnt) cnt = 1;
    for (int c = 0; c < nch; ++c) mean[c] /= cnt;
    double cov[4][4] = {};
    for (int t = 0; t < T; ++t) {
      if (part_of[t] != p) continue;
      for (int c = 0; c < nch; ++c)
        for (int d = 0; d < nch; ++d)
          cov[c][d] += (px[t * 4 + c] - mean[c]) * (px[t * 4 + d] - mean[d]);
    }
    double axis[4] = {1, 1, 1, 1};
    for (int it = 0; it < 4; ++it) {
      double nv[4] = {}, nn = 0;
      for (int c = 0; c < nch; ++c)
        for (int d = 0; d < nch; ++d) nv[c] += cov[c][d] * axis[d];
      for (int c = 0; c < nch; ++c) nn += nv[c] * nv[c];
      nn = std::sqrt(nn);
      if (nn < 1e-10) break;
      for (int c = 0; c < nch; ++c) axis[c] = nv[c] / nn;
    }
    float tmin = 1e30f, tmax = -1e30f;
    for (int t = 0; t < T; ++t) {
      if (part_of[t] != p) continue;
      float tt = 0;
      for (int c = 0; c < nch; ++c)
        tt += (px[t * 4 + c] - mean[c]) * (float)axis[c];
      tmin = std::min(tmin, tt);
      tmax = std::max(tmax, tt);
    }
    for (int c = 0; c < 4; ++c) {
      e0[p][c] = c < nch ? std::min(255.f, std::max(0.f, mean[c] + (float)axis[c] * tmin)) : 255.f;
      e1[p][c] = c < nch ? std::min(255.f, std::max(0.f, mean[c] + (float)axis[c] * tmax)) : 255.f;
    }
  }

  std::vector<double> tt(T), m, rhs;
  std::vector<int> gq(G), acc(T), w64(T);
  double best_err = 1e30;
  for (int it = 0; it <= iters; ++it) {
    int d0[2][4], d1[2][4], qv[2][8];
    for (int p = 0; p < L.nparts; ++p) {
      for (int c = 0; c < nch; ++c) {
        int x0 = clampi((int)std::lround(e0[p][c]), 0, 255);
        int x1 = clampi((int)std::lround(e1[p][c]), 0, 255);
        int q0 = L.color->nearest[x0], q1 = L.color->nearest[x1];
        d0[p][c] = L.color->unq[q0];
        d1[p][c] = L.color->unq[q1];
        qv[p][2 * c] = q0;
        qv[p][2 * c + 1] = q1;
      }
      if (L.cem == 8) { d0[p][3] = 255; d1[p][3] = 255; }
      int s0 = d0[p][0] + d0[p][1] + d0[p][2];
      int s1 = d1[p][0] + d1[p][1] + d1[p][2];
      if (s0 > s1) {
        for (int c = 0; c < 4; ++c) std::swap(d0[p][c], d1[p][c]);
        for (int c = 0; c < nch; ++c) std::swap(qv[p][2 * c], qv[p][2 * c + 1]);
      }
    }
    // ideal per-texel weight fraction
    for (int t = 0; t < T; ++t) {
      int p = part_of[t];
      double num = 0, den = 0;
      for (int c = 0; c < 4; ++c) {
        double dd = (double)d1[p][c] - d0[p][c];
        num += (px[t * 4 + c] - d0[p][c]) * dd;
        den += dd * dd;
      }
      tt[t] = den > 1e-9 ? std::min(1.0, std::max(0.0, num / den)) : 0.5;
    }
    // grid LS: minimize || (A/16) g - tt ||^2, g in [0,1]
    m.assign(G * G, 0.0);
    rhs.assign(G, 0.0);
    for (int t = 0; t < T; ++t) {
      const int* row = &inf->a[t * G];
      for (int j = 0; j < G; ++j) {
        if (!row[j]) continue;
        double aj = row[j] / 16.0;
        rhs[j] += aj * tt[t];
        for (int k = j; k < G; ++k)
          if (row[k]) m[j * G + k] += aj * (row[k] / 16.0);
      }
    }
    for (int j = 0; j < G; ++j)
      for (int k = 0; k < j; ++k) m[j * G + k] = m[k * G + j];
    for (int j = 0; j < G; ++j) m[j * G + j] += 1e-6;
    std::vector<double> g_sol = rhs;
    std::vector<double> m2 = m;
    if (!solve_dense(m2, g_sol, G))
      for (int j = 0; j < G; ++j) g_sol[j] = 0.5;
    for (int j = 0; j < G; ++j) {
      double w = std::min(1.0, std::max(0.0, g_sol[j])) * 64.0;
      int bq = 0, bd = 1 << 30;
      for (int v = 0; v < L.w->levels; ++v) {
        int dd = (int)std::lround(std::fabs(L.w->unq[v] - w));
        if (dd < bd) { bd = dd; bq = v; }
      }
      gq[j] = bq;
    }
    auto texel_err = [&](int t, int w64v) {
      int p = part_of[t];
      double e = 0;
      for (int c = 0; c < 4; ++c) {
        int dc = decode_texel(d0[p][c], d1[p][c], w64v);
        double dd = px[t * 4 + c] - dc;
        e += dd * dd;
      }
      return e;
    };
    // accumulators + exact per-texel error
    for (int t = 0; t < T; ++t) {
      const int* row = &inf->a[t * G];
      int a = 0;
      for (int j = 0; j < G; ++j)
        if (row[j]) a += row[j] * L.w->unq[gq[j]];
      acc[t] = a;
      w64[t] = (a + 8) >> 4;
    }
    // coordinate refine on the quantized grid (2 passes, ladder +-1 in
    // unquant order)
    std::vector<int> order(L.w->levels), rank(L.w->levels);
    for (int v = 0; v < L.w->levels; ++v) order[v] = v;
    std::sort(order.begin(), order.end(), [&](int a2, int b2) {
      return L.w->unq[a2] < L.w->unq[b2];
    });
    for (int i = 0; i < L.w->levels; ++i) rank[order[i]] = i;
    for (int pass = 0; pass < 2; ++pass) {
      bool changed = false;
      for (int j = 0; j < G; ++j) {
        int cur = gq[j];
        double cur_e = 0;
        for (int t : inf->foot[j]) cur_e += texel_err(t, (acc[t] + 8) >> 4);
        for (int dr = -1; dr <= 1; dr += 2) {
          int r2 = rank[cur] + dr;
          if (r2 < 0 || r2 >= L.w->levels) continue;
          int cand = order[r2];
          int du = L.w->unq[cand] - L.w->unq[gq[j]];
          double e = 0;
          for (int t : inf->foot[j])
            e += texel_err(t, (acc[t] + inf->a[t * G + j] * du + 8) >> 4);
          if (e + 1e-9 < cur_e) {
            for (int t : inf->foot[j]) acc[t] += inf->a[t * G + j] * du;
            gq[j] = cand;
            cur_e = e;
            changed = true;
          }
        }
      }
      if (!changed) break;
    }
    double err = 0;
    for (int t = 0; t < T; ++t) {
      w64[t] = (acc[t] + 8) >> 4;
      err += texel_err(t, w64[t]);
    }
    if (err < best_err) {
      best_err = err;
      for (int j = 0; j < G; ++j) out->gq[j] = gq[j];
      for (int p = 0; p < L.nparts; ++p)
        std::memcpy(out->q[p], qv[p], sizeof qv[p]);
    }
    if (it == iters) break;
    // LS endpoint refine from the decoded weight fractions
    for (int p = 0; p < L.nparts; ++p) {
      double a2 = 0, b2 = 0, c2 = 0, r0[4] = {}, r1[4] = {};
      for (int t = 0; t < T; ++t) {
        if (part_of[t] != p) continue;
        double w = w64[t] / 64.0;
        a2 += w * w;
        b2 += w * (1 - w);
        c2 += (1 - w) * (1 - w);
        for (int c = 0; c < nch; ++c) {
          r1[c] += w * px[t * 4 + c];
          r0[c] += (1 - w) * px[t * 4 + c];
        }
      }
      double det = a2 * c2 - b2 * b2;
      if (std::fabs(det) < 1e-6) continue;
      for (int c = 0; c < nch; ++c) {
        double n1 = (c2 * r1[c] - b2 * r0[c]) / det;
        double n0 = (a2 * r0[c] - b2 * r1[c]) / det;
        e1[p][c] = (float)std::min(255.0, std::max(0.0, n1));
        e0[p][c] = (float)std::min(255.0, std::max(0.0, n0));
      }
    }
  }
  out->err = best_err;
  return best_err;
}

void pack_block_g(const LayoutG& L, const FittedG& f, int seed,
                  uint8_t* blk) {
  std::memset(blk, 0, 16);
  for (int i = 0; i < 11; ++i) set_bit(blk, i, (L.block_mode >> i) & 1);
  set_bit(blk, 11, (L.nparts - 1) & 1);
  set_bit(blk, 12, ((L.nparts - 1) >> 1) & 1);
  int color_start;
  if (L.nparts == 1) {
    for (int i = 0; i < 4; ++i) set_bit(blk, 13 + i, (L.cem >> i) & 1);
    color_start = 17;
  } else {
    for (int i = 0; i < 10; ++i) set_bit(blk, 13 + i, (seed >> i) & 1);
    int cem_field = L.cem << 2;
    for (int i = 0; i < 6; ++i) set_bit(blk, 23 + i, (cem_field >> i) & 1);
    color_start = 29;
  }
  int nper = 2 * ((L.cem >> 2) + 1);
  int vals[24];
  for (int p = 0; p < L.nparts; ++p)
    for (int i = 0; i < nper; ++i) vals[p * nper + i] = f.q[p][i];
  std::vector<uint8_t> cbits;
  ise_encode(vals, nper * L.nparts, L.color->kind, L.color->bits, &cbits);
  for (size_t i = 0; i < cbits.size(); ++i)
    set_bit(blk, color_start + (int)i, cbits[i]);
  std::vector<uint8_t> wbits;
  ise_encode(f.gq, L.nweights, wkind_of(L.wlevels), wbits_of(L.wlevels),
             &wbits);
  for (size_t i = 0; i < wbits.size(); ++i)
    set_bit(blk, 127 - (int)i, wbits[i]);
}

void encode_block_g(const float* px, int bw, int bh, int quality,
                    uint8_t* out_blk) {
  int T = bw * bh;
  bool has_alpha = false;
  for (int t = 0; t < T; ++t)
    if (px[t * 4 + 3] < 254.5f) { has_alpha = true; break; }

  int iters = quality <= 0 ? 1 : (quality >= 4 ? 5 : quality + 1);
  std::vector<LayoutG> layouts;
  LayoutG L;
  // 1-partition CEM 8 ladder: coarse-to-fine weight precision, same role
  // as the 4x4 set (grids capped by the primary block-mode rows).
  if (make_layout_g(bw, bh, 1, 8, 6, 5, 4, &L)) layouts.push_back(L);
  if (bw >= 8 && bh >= 8 && make_layout_g(bw, bh, 1, 8, 8, 8, 2, &L))
    layouts.push_back(L);  // extended-row full-coverage grid
  if (quality >= 1 && make_layout_g(bw, bh, 1, 8, 5, 5, 6, &L))
    layouts.push_back(L);
  if (quality >= 2 && make_layout_g(bw, bh, 1, 8, 4, 4, 12, &L))
    layouts.push_back(L);
  if (has_alpha) {
    if (make_layout_g(bw, bh, 1, 12, 5, 5, 4, &L)) layouts.push_back(L);
    if (quality >= 2 && make_layout_g(bw, bh, 1, 12, 4, 4, 8, &L))
      layouts.push_back(L);
  }

  std::vector<uint8_t> part0(T, 0);
  FittedG f, best_f;
  double best = 1e30;
  LayoutG best_L = layouts[0];
  int best_seed = 0;
  for (const LayoutG& LL : layouts) {
    if (fit_layout_g(px, T, bw, bh, LL, part0.data(), iters, &f) < best) {
      best = f.err;
      best_f = f;
      best_L = LL;
    }
  }

  if (quality >= 2) {
    int K = quality >= 4 ? 12 : (quality >= 3 ? 6 : 3);
    auto& tabs = part2_tables_g(bw, bh);
    struct Scored { double sse; int seed; };
    std::vector<Scored> scored;
    scored.reserve(1024);
    for (int seed = 0; seed < 1024; ++seed) {
      const uint8_t* po = tabs[seed].data();
      double sum[2][4] = {}, sq = 0;
      int cnt[2] = {};
      for (int t = 0; t < T; ++t) {
        int p = po[t];
        ++cnt[p];
        for (int c = 0; c < 4; ++c) {
          sum[p][c] += px[t * 4 + c];
          sq += px[t * 4 + c] * px[t * 4 + c];
        }
      }
      if (!cnt[0] || !cnt[1]) continue;
      double expl = 0;
      for (int p = 0; p < 2; ++p) {
        double m2s = 0;
        for (int c = 0; c < 4; ++c) m2s += sum[p][c] * sum[p][c];
        expl += m2s / cnt[p];
      }
      scored.push_back({sq - expl, seed});
    }
    std::partial_sort(
        scored.begin(), scored.begin() + std::min<size_t>(K, scored.size()),
        scored.end(),
        [](const Scored& a, const Scored& b) { return a.sse < b.sse; });
    std::vector<LayoutG> plays;
    if (make_layout_g(bw, bh, 2, 8, 4, 4, 4, &L)) plays.push_back(L);
    if (make_layout_g(bw, bh, 2, 8, 5, 4, 4, &L)) plays.push_back(L);
    for (int k = 0; k < (int)std::min<size_t>(K, scored.size()); ++k) {
      int seed = scored[k].seed;
      const uint8_t* po = tabs[seed].data();
      for (const LayoutG& LL : plays) {
        if (fit_layout_g(px, T, bw, bh, LL, po, iters, &f) < best) {
          best = f.err;
          best_f = f;
          best_L = LL;
          best_seed = seed;
        }
      }
    }
  }
  pack_block_g(best_L, best_f, best_seed, out_blk);
}

}  // namespace

// ---------------------------------------------------------------------------
// HDR tier (CEM 11 direct submode / CEM 14) — the astcenc-fast-class
// bar for the HDR / HDR_RGB_LDR_A profiles the reference maps UFloat to
// (/root/reference/lib/src/AstcConverter.cpp:151-163).  Fitting runs in
// the spec's LNS16 code space for RGB (approximately relative error) and
// UNORM16 for alpha, mirroring kernels/astc.py:_fit_hdr_layout's error
// model; weights assign against the exact 16-bit decode interpolation.
// ---------------------------------------------------------------------------

// f32 -> half bits (unsigned clamp, round-to-nearest-even).
uint16_t hdr_f32_to_half(float f) {
  if (!(f > 0.0f)) return 0;
  if (f >= 65504.0f) return 0x7BFF;
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  uint32_t exp = (bits >> 23) & 0xFF;
  uint32_t man = bits & 0x7FFFFF;
  int e = (int)exp - 127 + 15;
  if (e <= 0) {
    if (e < -10) return 0;
    man |= 0x800000;
    int shift = 14 - e;
    uint32_t half = man >> shift;
    uint32_t rem = man & ((1u << shift) - 1);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half & 1))) ++half;
    return (uint16_t)half;
  }
  uint32_t half = ((uint32_t)e << 10) | (man >> 13);
  uint32_t rem = man & 0x1FFF;
  if (rem > 0x1000 || (rem == 0x1000 && (half & 1))) ++half;
  return (uint16_t)std::min(half, 0x7BFFu);
}

// half bits -> 16-bit LNS code (kernels/astc.py:_sf16_to_lns_jnp).
int hdr_half_to_lns(uint16_t h) {
  h = (uint16_t)std::min<int>(h, 0x7BFF);
  int e = h >> 10;
  int mt = (h & 0x3FF) << 3;
  int m;
  if (mt < 3 * 512) m = (mt + 1) / 3;
  else if (mt < 4 * 1536 - 512) m = (mt + 514) / 4;
  else m = (mt + 2050) / 5;
  return (e << 11) | std::min(m, 0x7FF);
}

// Fit CEM 11 (use_alpha=false, 3ch) / CEM 14 (4ch): t16 [16][4] float
// LNS16 RGB + UNORM16 A targets.  Writes quantized ISE values (6 or 8)
// and weight values; returns the LNS/UNORM16-domain SSE over nch
// channels.
double fit_hdr_layout(const float t16[16][4], const WRange* W,
                      bool use_alpha, int quality, int q_out[8],
                      int wq_out[16]) {
  int nch = use_alpha ? 4 : 3;
  // PCA seed in the 16-bit target domain.
  double mean[4] = {0, 0, 0, 0};
  for (int t = 0; t < 16; ++t)
    for (int c = 0; c < nch; ++c) mean[c] += t16[t][c] / 16.0;
  double cov[4][4] = {};
  for (int t = 0; t < 16; ++t)
    for (int c = 0; c < nch; ++c)
      for (int d = 0; d < nch; ++d)
        cov[c][d] += (t16[t][c] - mean[c]) * (t16[t][d] - mean[d]);
  double axis[4] = {1, 1, 1, 1};
  for (int it = 0; it < 4; ++it) {
    double nv[4] = {}, nn = 0;
    for (int c = 0; c < nch; ++c)
      for (int d = 0; d < nch; ++d) nv[c] += cov[c][d] * axis[d];
    for (int c = 0; c < nch; ++c) nn += nv[c] * nv[c];
    nn = std::sqrt(nn);
    if (nn < 1e-10) break;
    for (int c = 0; c < nch; ++c) axis[c] = nv[c] / nn;
  }
  double tmin = 1e30, tmax = -1e30;
  for (int t = 0; t < 16; ++t) {
    double tt = 0;
    for (int c = 0; c < nch; ++c) tt += (t16[t][c] - mean[c]) * axis[c];
    tmin = std::min(tmin, tt);
    tmax = std::max(tmax, tt);
  }
  double e0[4], e1[4];
  for (int c = 0; c < nch; ++c) {
    e0[c] = std::min(65535.0, std::max(0.0, mean[c] + axis[c] * tmin));
    e1[c] = std::min(65535.0, std::max(0.0, mean[c] + axis[c] * tmax));
  }

  // Quantize to the CEM 11 direct-submode fields (r,g: 8-bit * 256;
  // b: 7-bit * 512 with the major-component-3 flag; a: 8-bit * 257).
  auto quantize = [&](const double e[4], int vals[4], double dec[4]) {
    int r = clampi((int)std::lround(e[0] / 256.0), 0, 255);
    int g = clampi((int)std::lround(e[1] / 256.0), 0, 255);
    int b7 = clampi((int)std::lround(e[2] / 512.0), 0, 127);
    vals[0] = r;
    vals[1] = g;
    vals[2] = 0x80 | b7;
    dec[0] = r * 256.0;
    dec[1] = g * 256.0;
    dec[2] = b7 * 512.0;
    if (use_alpha) {
      int a8 = clampi((int)std::lround(e[3] / 257.0), 0, 255);
      vals[3] = a8;
      dec[3] = a8 * 257.0;
    }
  };

  double best_err = 1e30;
  int iters = quality <= 0 ? 1 : (quality >= 4 ? 5 : quality + 1);
  for (int it = 0; it <= iters; ++it) {
    int v0[4], v1[4];
    double d0[4], d1[4];
    quantize(e0, v0, d0);
    quantize(e1, v1, d1);
    // exact per-texel weight sweep against the 16-bit decode model
    double err = 0;
    int wq[16];
    float wfrac[16];
    for (int t = 0; t < 16; ++t) {
      double be = 1e30;
      int bw2 = 0;
      for (int w = 0; w < W->levels; ++w) {
        int w64 = W->unq[w];
        double e = 0;
        for (int c = 0; c < nch; ++c) {
          double c16 = std::floor(
              (d0[c] * (64 - w64) + d1[c] * w64 + 32.0) / 64.0);
          double d = c16 - t16[t][c];
          e += d * d;
        }
        if (e < be) { be = e; bw2 = w; }
      }
      wq[t] = bw2;
      wfrac[t] = W->unq[bw2] / 64.0f;
      err += be;
    }
    if (err < best_err) {
      best_err = err;
      std::memcpy(wq_out, wq, sizeof wq);
      for (int c = 0; c < 3; ++c) {
        q_out[2 * c] = v0[c];
        q_out[2 * c + 1] = v1[c];
      }
      if (use_alpha) {
        q_out[6] = v0[3];
        q_out[7] = v1[3];
      }
    }
    if (it == iters) break;
    // LS refine in the 16-bit interpolation domain
    double a = 0, b = 0, c2 = 0, r0[4] = {}, r1[4] = {};
    for (int t = 0; t < 16; ++t) {
      double w = wfrac[t];
      a += w * w;
      b += w * (1 - w);
      c2 += (1 - w) * (1 - w);
      for (int c = 0; c < nch; ++c) {
        r1[c] += w * t16[t][c];
        r0[c] += (1 - w) * t16[t][c];
      }
    }
    double det = a * c2 - b * b;
    if (std::fabs(det) < 1e-9) break;
    for (int c = 0; c < nch; ++c) {
      double n1 = (c2 * r1[c] - b * r0[c]) / det;
      double n0 = (a * r0[c] - b * r1[c]) / det;
      e1[c] = std::min(65535.0, std::max(0.0, n1));
      e0[c] = std::min(65535.0, std::max(0.0, n0));
    }
  }
  return best_err;
}

// rgba [16][4] float: RGB non-negative HDR, A in [0,1].
void encode_block_hdr(const float* rgba, int quality, int alpha_ldr,
                      uint8_t* out_blk) {
  const Ranges& R = ranges();
  const int bm6 = 3 | (2 << 5);                          // 6-level weights
  const int bm12 = 1 | (1 << 4) | (2 << 5) | (1 << 9);   // 12-level

  float t16[16][4];
  bool has_alpha = false;
  for (int t = 0; t < 16; ++t) {
    for (int c = 0; c < 3; ++c)
      t16[t][c] =
          (float)hdr_half_to_lns(hdr_f32_to_half(rgba[t * 4 + c]));
    float a = std::min(1.0f, std::max(0.0f, rgba[t * 4 + 3]));
    t16[t][3] = a * 65535.0f;
    if (a < 254.5f / 255.0f) has_alpha = true;
  }

  // CEM 11 (alpha decodes to exactly 1.0): grid 4x4, 12-level weights,
  // mirroring kernels/astc.py hdr_layout_menu(4,4).
  Fitted f;
  int q11[8], wq11[16];
  double err11 = fit_hdr_layout(t16, &R.w12, false, quality, q11, wq11);
  for (int t = 0; t < 16; ++t)
    err11 += (t16[t][3] - 65535.0) * (t16[t][3] - 65535.0);

  Layout L11 = {bm12, &R.w12, 11, 1, &R.c256};
  Layout L14 = {bm6, &R.w6, 14, 1, &R.c256};
  int q14[8], wq14[16];
  double err14 = 1e30;
  if (alpha_ldr && has_alpha)
    err14 = fit_hdr_layout(t16, &R.w6, true, quality, q14, wq14);

  if (err14 < err11) {
    std::memcpy(f.q[0], q14, sizeof q14);
    std::memcpy(f.wq, wq14, sizeof wq14);
    pack_block(L14, f, 0, out_blk);
  } else {
    std::memcpy(f.q[0], q11, sizeof q11);
    std::memcpy(f.wq, wq11, sizeof wq11);
    pack_block(L11, f, 0, out_blk);
  }
}

extern "C" {

// rgba: N * 16 * 4 floats in [0,1]; out: N * 16 bytes (ASTC 4x4 blocks).
void ctpu_astc4x4_encode(const float* rgba, int n, int quality, int threads,
                         uint8_t* out) {
  ranges();
  part_tables();
  ise_tables();
  if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
  std::atomic<int> counter{0};
  const int kChunk = 32;
  auto worker = [&]() {
    float px[64];
    for (;;) {
      int start = counter.fetch_add(kChunk);
      if (start >= n) break;
      int end = std::min(n, start + kChunk);
      for (int b = start; b < end; ++b) {
        for (int i = 0; i < 64; ++i)
          px[i] = std::min(255.0f, std::max(0.0f, rgba[b * 64 + i] * 255.0f));
        encode_block(px, quality, out + b * 16);
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


// rgba: N * 16 * 4 floats (RGB HDR >= 0, A in [0,1]); out: N * 16 bytes
// of ASTC 4x4 HDR blocks (CEM 11 / CEM 14 when alpha_ldr and alpha
// varies).
void ctpu_astc_hdr_encode(const float* rgba, int n, int quality,
                          int alpha_ldr, int threads, uint8_t* out) {
  ranges();
  ise_tables();
  if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
  std::atomic<int> counter{0};
  const int kChunk = 32;
  auto worker = [&]() {
    for (;;) {
      int start = counter.fetch_add(kChunk);
      if (start >= n) break;
      int end = std::min(n, start + kChunk);
      for (int b = start; b < end; ++b)
        encode_block_hdr(rgba + b * 64, quality, alpha_ldr, out + b * 16);
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


// rgba: N * (bw*bh) * 4 floats in [0,1]; out: N * 16 bytes (ASTC blocks).
void ctpu_astc_sized_encode(const float* rgba, int n, int bw, int bh,
                            int quality, int threads, uint8_t* out) {
  ranges();
  ise_tables();
  part2_tables_g(bw, bh);
  int T = bw * bh;
  if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
  std::atomic<int> counter{0};
  const int kChunk = 16;
  auto worker = [&]() {
    std::vector<float> px(T * 4);
    for (;;) {
      int start = counter.fetch_add(kChunk);
      if (start >= n) break;
      int end = std::min(n, start + kChunk);
      for (int b = start; b < end; ++b) {
        for (int i = 0; i < T * 4; ++i)
          px[i] = std::min(
              255.0f, std::max(0.0f, rgba[b * T * 4 + i] * 255.0f));
        encode_block_g(px.data(), bw, bh, quality, out + b * 16);
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
