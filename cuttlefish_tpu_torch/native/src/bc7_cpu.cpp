// CPU BC7 encoder: the measured host-side baseline for bench.py.
//
// An original implementation of the same algorithm the JAX kernel runs
// (kernels/bc7.py): PCA endpoint seeding, least-squares refinement,
// exact-decode-model candidate selection, mode 6 (single subset, 7.7+pbit,
// 4-bit indices) and mode 1 (2 subsets over the 64-pattern table with
// full-partition screening, 6.6 + shared pbit, 3-bit indices).  Threading
// mirrors the reference's Converter::convert design
// (/root/reference/lib/src/Converter.cpp:508-593): a pool of std::threads
// pulling block ranges off a std::atomic counter.
//
// This is deliberately the *same quality class* as the TPU path at Normal
// quality so the vs_baseline ratio in bench.py compares equal work.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// BPTC 2-subset partition table (public spec constants; first 64 rows).
const uint16_t kPart2[64] = {
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80,
    0xC800, 0xFFEC, 0xFE80, 0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000,
    0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310, 0x3100, 0x8CCE,
    0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C,
    0xAAAA, 0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A,
    0x73CE, 0x13C8, 0x324C, 0x3BDC, 0x6996, 0xC33C, 0x9966, 0x0660,
    0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6, 0x639C,
    0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22,
};
const uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15,  2,  8,  2,  2,  8,  8, 15,  2,  8,  2,  2,  8,  8,  2,  2,
    15, 15,  6,  8,  2,  8, 15, 15,  2,  8,  2,  2,  2, 15, 15,  6,
     6,  2,  6,  8, 15, 15,  2,  2, 15, 15, 15, 15, 15,  2,  2, 15,
};

inline int weight_of(int i, int levels) {
  // round(i * 64 / (levels - 1))
  return (i * 64 * 2 + (levels - 1)) / (2 * (levels - 1));
}

struct Vec4 {
  float v[4];
};

inline int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

// Quantize a float endpoint (0..255) at `bits` with a p-bit, exact decode.
inline void quant_pbit(const float* e, int bits, int nch, int* q, int* pbit,
                       int* dec) {
  double best = 1e30;
  for (int p = 0; p < 2; ++p) {
    int qq[4], dd[4];
    double err = 0;
    for (int c = 0; c < nch; ++c) {
      int maxq = (1 << bits) - 1;
      // decode: v = ((q<<1|p) << (8-bits-1)); replicate to 8 bits
      int bq = (int)std::lround(e[c] / 255.0f * maxq);
      bq = clampi(bq, 0, maxq);
      double cand_err = 1e30;
      int cand_q = bq, cand_d = 0;
      for (int dq = -1; dq <= 1; ++dq) {
        int q2 = clampi(bq + dq, 0, maxq);
        int full = (q2 << 1) | p;  // bits+1 bits
        int shift = 8 - (bits + 1);
        int d = (full << shift) | (full >> (2 * (bits + 1) - 8));
        double er = (d - e[c]) * (d - e[c]);
        if (er < cand_err) { cand_err = er; cand_q = q2; cand_d = d; }
      }
      qq[c] = cand_q;
      dd[c] = cand_d;
      err += cand_err;
    }
    if (err < best) {
      best = err;
      *pbit = p;
      for (int c = 0; c < nch; ++c) { q[c] = qq[c]; dec[c] = dd[c]; }
    }
  }
}

// Least-squares endpoints from weights (w in [0,1]) over a texel subset.
inline void ls_solve(const float* px, const uint8_t* member, int n,
                     const float* w, int nch, float* e0, float* e1) {
  double a = 0, b = 0, c2 = 0, r0[4] = {0}, r1[4] = {0};
  for (int i = 0; i < n; ++i) {
    if (!member[i]) continue;
    double wi = w[i];
    a += wi * wi;
    b += wi * (1 - wi);
    c2 += (1 - wi) * (1 - wi);
    for (int c = 0; c < nch; ++c) {
      r1[c] += wi * px[i * 4 + c];
      r0[c] += (1 - wi) * px[i * 4 + c];
    }
  }
  double det = a * c2 - b * b;
  if (std::fabs(det) < 1e-6) return;  // keep seeds
  for (int c = 0; c < nch; ++c) {
    double n1 = (c2 * r1[c] - b * r0[c]) / det;
    double n0 = (a * r0[c] - b * r1[c]) / det;
    e1[c] = (float)std::min(255.0, std::max(0.0, n1));
    e0[c] = (float)std::min(255.0, std::max(0.0, n0));
  }
}

// PCA principal axis over a subset.
inline void pca_axis(const float* px, const uint8_t* member, int n, int nch,
                     float* mean, float* axis) {
  int cnt = 0;
  for (int c = 0; c < nch; ++c) mean[c] = 0;
  for (int i = 0; i < n; ++i) {
    if (!member[i]) continue;
    ++cnt;
    for (int c = 0; c < nch; ++c) mean[c] += px[i * 4 + c];
  }
  if (!cnt) cnt = 1;
  for (int c = 0; c < nch; ++c) mean[c] /= cnt;
  double cov[4][4] = {};
  for (int i = 0; i < n; ++i) {
    if (!member[i]) continue;
    for (int c = 0; c < nch; ++c)
      for (int d = 0; d <= c; ++d)
        cov[c][d] += (px[i * 4 + c] - mean[c]) * (px[i * 4 + d] - mean[d]);
  }
  for (int c = 0; c < nch; ++c)
    for (int d = c + 1; d < nch; ++d) cov[c][d] = cov[d][c];
  for (int c = 0; c < nch; ++c) axis[c] = 1.0f;
  for (int it = 0; it < 4; ++it) {
    double nv[4] = {};
    for (int c = 0; c < nch; ++c)
      for (int d = 0; d < nch; ++d) nv[c] += cov[c][d] * axis[d];
    double nn = 0;
    for (int c = 0; c < nch; ++c) nn += nv[c] * nv[c];
    nn = std::sqrt(nn);
    if (nn < 1e-10) break;
    for (int c = 0; c < nch; ++c) axis[c] = (float)(nv[c] / nn);
  }
}

// Fit one subset: returns SSE; outputs quantized endpoints/pbit/indices.
double fit_subset(const float* px, const uint8_t* member, int n, int bits,
                  int levels, int iters, int* q0, int* q1, int* pb0, int* pb1,
                  uint8_t* idx) {
  float mean[4], axis[4];
  pca_axis(px, member, n, 3, mean, axis);
  float tmin = 1e30f, tmax = -1e30f;
  for (int i = 0; i < n; ++i) {
    if (!member[i]) continue;
    float t = 0;
    for (int c = 0; c < 3; ++c) t += (px[i * 4 + c] - mean[c]) * axis[c];
    tmin = std::min(tmin, t);
    tmax = std::max(tmax, t);
  }
  float e0[4], e1[4];
  for (int c = 0; c < 3; ++c) {
    e0[c] = std::min(255.0f, std::max(0.0f, mean[c] + axis[c] * tmin));
    e1[c] = std::min(255.0f, std::max(0.0f, mean[c] + axis[c] * tmax));
  }
  double best_err = 1e30;
  int bq0[4], bq1[4], bp0 = 0, bp1 = 0;
  uint8_t bidx[16];
  float w[16];
  for (int it = 0; it <= iters; ++it) {
    int d0[4], d1[4], tq0[4], tq1[4], tp0, tp1;
    quant_pbit(e0, bits, 3, tq0, &tp0, d0);
    quant_pbit(e1, bits, 3, tq1, &tp1, d1);
    int pal[16][3];
    for (int k = 0; k < levels; ++k) {
      int wk = weight_of(k, levels);
      for (int c = 0; c < 3; ++c)
        pal[k][c] = (d0[c] * (64 - wk) + d1[c] * wk + 32) >> 6;
    }
    double err = 0;
    for (int i = 0; i < n; ++i) {
      if (!member[i]) continue;
      double be = 1e30;
      int bk = 0;
      for (int k = 0; k < levels; ++k) {
        double e = 0;
        for (int c = 0; c < 3; ++c) {
          double d = px[i * 4 + c] - pal[k][c];
          e += d * d;
        }
        if (e < be) { be = e; bk = k; }
      }
      idx[i] = (uint8_t)bk;
      w[i] = weight_of(bk, levels) / 64.0f;
      err += be;
    }
    if (err < best_err) {
      best_err = err;
      std::memcpy(bq0, tq0, sizeof bq0);
      std::memcpy(bq1, tq1, sizeof bq1);
      bp0 = tp0; bp1 = tp1;
      std::memcpy(bidx, idx, 16);
    }
    if (it == iters) break;
    ls_solve(px, member, n, w, 3, e0, e1);
  }
  std::memcpy(q0, bq0, sizeof bq0);
  std::memcpy(q1, bq1, sizeof bq1);
  *pb0 = bp0; *pb1 = bp1;
  std::memcpy(idx, bidx, 16);
  return best_err;
}

struct BitPacker {
  uint32_t w[4] = {0, 0, 0, 0};
  int pos = 0;
  void put(uint32_t v, int nbits) {
    int word = pos >> 5, bit = pos & 31;
    w[word] |= v << bit;
    if (bit + nbits > 32) w[word + 1] |= v >> (32 - bit);
    pos += nbits;
  }
};

// Mode 6 encode for one block; returns SSE.
double encode_mode6(const float* px, int iters, uint32_t* out) {
  uint8_t all[16];
  std::memset(all, 1, 16);
  // Mode 6: RGBA 7.7 per-endpoint pbit, 16 levels.  Reuse fit_subset for
  // RGB then fold alpha via a 4-channel pass below (content here is fed
  // opaque by the bench; alpha handled as constant 255).
  int q0[4], q1[4], p0, p1;
  uint8_t idx[16];
  double err = fit_subset(px, all, 16, 7, 16, iters, q0, q1, &p0, &p1, idx);
  // alpha endpoints: constant 255
  int qa = 127;
  // anchor fixup: index 0 must have MSB clear
  if (idx[0] >= 8) {
    std::swap(q0[0], q1[0]); std::swap(q0[1], q1[1]); std::swap(q0[2], q1[2]);
    std::swap(p0, p1);
    for (int i = 0; i < 16; ++i) idx[i] = 15 - idx[i];
  }
  BitPacker pk;
  pk.put(1u << 6, 7);
  for (int c = 0; c < 3; ++c) { pk.put(q0[c], 7); pk.put(q1[c], 7); }
  pk.put(qa, 7); pk.put(qa, 7);
  pk.put(p0, 1); pk.put(p1, 1);
  pk.put(idx[0], 3);
  for (int i = 1; i < 16; ++i) pk.put(idx[i], 4);
  std::memcpy(out, pk.w, 16);
  return err;
}

// Mode 1 encode (2 subsets, full partition screen); returns SSE.
double encode_mode1(const float* px, int iters, uint32_t* out) {
  // screen partitions by within-subset variance along per-subset mean
  double best_score = 1e30;
  int best_d = 0;
  for (int d = 0; d < 64; ++d) {
    double sum[2][3] = {}, sq[2] = {};
    int cnt[2] = {};
    for (int i = 0; i < 16; ++i) {
      int s = (kPart2[d] >> i) & 1;
      ++cnt[s];
      for (int c = 0; c < 3; ++c) {
        sum[s][c] += px[i * 4 + c];
        sq[s] += px[i * 4 + c] * px[i * 4 + c];
      }
    }
    double score = 0;
    for (int s = 0; s < 2; ++s) {
      if (!cnt[s]) continue;
      double m2 = 0;
      for (int c = 0; c < 3; ++c) m2 += sum[s][c] * sum[s][c];
      score += sq[s] - m2 / cnt[s];
    }
    if (score < best_score) { best_score = score; best_d = d; }
  }
  uint8_t mem0[16], mem1[16];
  for (int i = 0; i < 16; ++i) {
    mem1[i] = (kPart2[best_d] >> i) & 1;
    mem0[i] = !mem1[i];
  }
  int q0a[4], q1a[4], q0b[4], q1b[4], p0a, p1a, p0b, p1b;
  uint8_t idxa[16], idxb[16];
  // mode 1 shares one pbit per subset: approximate with per-endpoint fit
  // then reuse endpoint-0's pbit (same decode family).
  double err = fit_subset(px, mem0, 16, 6, 8, iters, q0a, q1a, &p0a, &p1a, idxa)
             + fit_subset(px, mem1, 16, 6, 8, iters, q0b, q1b, &p0b, &p1b, idxb);
  uint8_t idx[16];
  for (int i = 0; i < 16; ++i) idx[i] = mem1[i] ? idxb[i] : idxa[i];
  int anchor1 = kAnchor2[best_d];
  if (idx[0] >= 4) {
    for (int c = 0; c < 3; ++c) std::swap(q0a[c], q1a[c]);
    for (int i = 0; i < 16; ++i) if (mem0[i]) idx[i] = 7 - idx[i];
  }
  if (idx[anchor1] >= 4) {
    for (int c = 0; c < 3; ++c) std::swap(q0b[c], q1b[c]);
    for (int i = 0; i < 16; ++i) if (mem1[i]) idx[i] = 7 - idx[i];
  }
  BitPacker pk;
  pk.put(1u << 1, 2);
  pk.put(best_d, 6);
  for (int c = 0; c < 3; ++c) {
    pk.put(q0a[c], 6); pk.put(q1a[c], 6); pk.put(q0b[c], 6); pk.put(q1b[c], 6);
  }
  pk.put(p0a, 1); pk.put(p0b, 1);
  for (int i = 0; i < 16; ++i) {
    int nbits = (i == 0 || i == anchor1) ? 2 : 3;
    pk.put(idx[i], nbits);
  }
  std::memcpy(out, pk.w, 16);
  return err;
}

}  // namespace

extern "C" {

// rgba: N * 16 * 4 floats in [0,1]; out: N * 4 uint32 words.
void ctpu_bc7_encode(const float* rgba, int n, int quality, int threads,
                     uint32_t* out) {
  int iters = quality <= 0 ? 1 : (quality >= 4 ? 4 : quality);
  if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
  std::atomic<int> counter{0};
  const int kChunk = 64;
  auto worker = [&]() {
    std::vector<float> px(16 * 4);
    for (;;) {
      int start = counter.fetch_add(kChunk);
      if (start >= n) break;
      int end = std::min(n, start + kChunk);
      for (int b = start; b < end; ++b) {
        for (int i = 0; i < 64; ++i)
          px[i] = std::min(255.0f, std::max(0.0f, rgba[b * 64 + i] * 255.0f));
        uint32_t w6[4], w1[4];
        double e6 = encode_mode6(px.data(), iters, w6);
        double e1 = encode_mode1(px.data(), iters, w1);
        std::memcpy(out + b * 4, e1 < e6 ? w1 : w6, 16);
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
