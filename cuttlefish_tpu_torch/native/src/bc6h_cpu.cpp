// CPU BC6H encoder: independent reference-class quality baseline.
//
// From-scratch ispc_texcomp-class BC6H (unsigned) encoder — the
// reference drives ispc::CompressBlocksBC6H with profiles
// veryfast..veryslow (/root/reference/lib/src/S3tcConverter.cpp:497-569);
// the quality ladder here mirrors that breadth.  Used by
// tests/test_cpu_reference.py to back the BASELINE.md north-star PSNR
// claim for BC6H the same way bc7/astc/etc2/bc1_cpu.cpp do for theirs.
//
//   q0/q1 (veryfast):  mode 11 only (one region, 10.10 endpoints,
//                      4-bit indices) — min/max seed, exact-palette
//                      index assign, LS endpoint refinement.
//   q2    (basic):     + mode 12 (11-bit base, 9-bit deltas) and the
//                      two-region modes 1/2/10 on the best-screened
//                      BPTC partition; per-channel +-1 quant sweeps.
//   q3    (slow):      + mode 6, top-2 partitions, deeper LS.
//   q4    (veryslow):  all ten two-region modes over the top-8
//                      partitions plus an endpoint quant-neighborhood
//                      sweep on the winning two-region candidate —
//                      the thorough-class tier (round-5 VERDICT item 1).
//
// All palettes are the EXACT decode model (unquant + 31/64 finalize,
// mirroring decode/bc6h.py); two-region field placement comes from
// bc6h_tables.inc (Mesa-extracted layouts shared with the TPU packer —
// the search algorithms stay independent).  Error is SSE on the decoded
// half-bit codes (monotone in the float ordering, the standard BC6H
// encoder metric).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Same atomic-counter worker pool as astc_cpu.cpp/etc2_cpu.cpp (the
// reference's Converter.cpp:508-593 thread-pool role).
template <class F>
void run_blocks(int n, int threads, F&& fn) {
  if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
  if (threads <= 1 || n < 128) {
    for (int b = 0; b < n; ++b) fn(b);
    return;
  }
  std::atomic<int> counter{0};
  const int kChunk = 64;
  auto worker = [&]() {
    for (;;) {
      int start = counter.fetch_add(kChunk);
      if (start >= n) break;
      int end = std::min(n, start + kChunk);
      for (int b = start; b < end; ++b) fn(b);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// f32 -> half bits (round-to-nearest-even), negatives clamped to 0
// (BC6H unsigned), inf/nan clamped to max finite half.
uint16_t f32_to_half_u(float f) {
  if (!(f > 0.0f)) return 0;
  if (f >= 65504.0f) return 0x7BFF;
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  uint32_t exp = (bits >> 23) & 0xFF;
  uint32_t man = bits & 0x7FFFFF;
  int e = (int)exp - 127 + 15;
  if (e <= 0) {
    // subnormal half
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

// decode/bc6h.py:_unquant_unsigned, arbitrary endpoint precision.
inline int unquant_u(int q, int bits) {
  int maxq = (1 << bits) - 1;
  if (q <= 0) return 0;
  if (q >= maxq) return 0xFFFF;
  return ((q << 16) + 0x8000) >> bits;
}

inline int unquant10(int q) { return unquant_u(q, 10); }

inline int finalize_u(int v) { return (v * 31) >> 6; }

// Nearest b-bit quantization of an interpolation-domain (64/31-scaled)
// target; inverse of unquant_u.
inline int quant_u(double v16, int bits) {
  int maxq = (1 << bits) - 1;
  if (v16 <= 0) return 0;
  if (v16 >= 65535.0) return maxq;
  int q = (int)std::lround(v16 * (double)(1 << bits) / 65536.0);
  return clampi(q, 0, maxq);
}

// 4-bit / 3-bit interpolation weights (bc7_tables.WEIGHTS4/WEIGHTS3).
const int W4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};
const int W3[8] = {0, 9, 18, 27, 37, 46, 55, 64};

#include "bc6h_tables.inc"

struct Block {
  int v[16][3];  // half-bit codes 0..0x7BFF
};

// Exact mode-11 palette entry for quantized endpoints.
inline int pal_entry(int u0, int u1, int w) {
  return finalize_u((u0 * (64 - w) + u1 * w + 32) >> 6);
}

// Index fit against the exact decode palette at `bits` endpoint
// precision (mode 11: bits=10; mode 12: bits=11).
double fit_indices(const Block& B, const int q0[3], const int q1[3],
                   int sel[16], int bits) {
  int pal[16][3];
  for (int c = 0; c < 3; ++c) {
    int u0 = unquant_u(q0[c], bits);
    int u1 = unquant_u(q1[c], bits);
    for (int i = 0; i < 16; ++i) pal[i][c] = pal_entry(u0, u1, W4[i]);
  }
  // Targets in the finalized domain: the decoded half bits ARE
  // finalize_u(unq); compare against the source half bits directly.
  double err = 0;
  for (int t = 0; t < 16; ++t) {
    double best = 1e30;
    int bi = 0;
    for (int i = 0; i < 16; ++i) {
      double e = 0;
      for (int c = 0; c < 3; ++c) {
        double d = (double)B.v[t][c] - pal[i][c];
        e += d * d;
      }
      if (e < best) { best = e; bi = i; }
    }
    sel[t] = bi;
    err += best;
  }
  return err;
}

inline int quant10(double v16) { return quant_u(v16, 10); }

void ls_endpoints(const Block& B, const int sel[16], double e0[3],
                  double e1[3]) {
  double a00 = 0, a01 = 0, a11 = 0, bx[3] = {0, 0, 0}, by[3] = {0, 0, 0};
  for (int t = 0; t < 16; ++t) {
    double w1 = W4[sel[t]] / 64.0, w0 = 1.0 - w1;
    a00 += w0 * w0;
    a01 += w0 * w1;
    a11 += w1 * w1;
    for (int c = 0; c < 3; ++c) {
      // Invert the 31/64 finalize so the LS target lives in the
      // interpolation domain.
      double tv = (double)B.v[t][c] * 64.0 / 31.0;
      bx[c] += w0 * tv;
      by[c] += w1 * tv;
    }
  }
  double det = a00 * a11 - a01 * a01;
  if (std::fabs(det) < 1e-9) return;
  for (int c = 0; c < 3; ++c) {
    e0[c] = (a11 * bx[c] - a01 * by[c]) / det;
    e1[c] = (a00 * by[c] - a01 * bx[c]) / det;
  }
}

// Apply the mode-12 delta constraint: q1 must be expressible as
// q0 + d with d in [-256, 255].
inline void apply_delta9(const int q0[3], int q1[3]) {
  for (int c = 0; c < 3; ++c)
    q1[c] = q0[c] + clampi(q1[c] - q0[c], -256, 255);
}

double try_pair(const Block& B, const int q0[3], const int q1in[3],
                int bq0[3], int bq1[3], int bsel[16], double best, int bits,
                bool delta9) {
  int sel[16];
  int q1[3] = {q1in[0], q1in[1], q1in[2]};
  if (delta9) apply_delta9(q0, q1);
  double err = fit_indices(B, q0, q1, sel, bits);
  if (err < best) {
    std::memcpy(bq0, q0, 3 * sizeof(int));
    std::memcpy(bq1, q1, 3 * sizeof(int));
    std::memcpy(bsel, sel, 16 * sizeof(int));
    return err;
  }
  return best;
}

// One-region search shared by modes 11 (bits=10) and 12 (bits=11 with
// 9-bit deltas): min/max seed, LS refinement, quant-neighborhood sweep.
double fit_one_region(const Block& B, int quality, int bits, bool delta9,
                      int bq0[3], int bq1[3], int bsel[16]) {
  // Seed: per-channel min/max (the veryfast bounding-box seed).
  double lo[3], hi[3];
  for (int c = 0; c < 3; ++c) {
    lo[c] = 1e30;
    hi[c] = -1e30;
    for (int t = 0; t < 16; ++t) {
      lo[c] = std::min(lo[c], (double)B.v[t][c]);
      hi[c] = std::max(hi[c], (double)B.v[t][c]);
    }
    // finalize-inverse into the interpolation domain
    lo[c] = lo[c] * 64.0 / 31.0;
    hi[c] = hi[c] * 64.0 / 31.0;
  }
  int q0[3], q1[3];
  int maxq = (1 << bits) - 1;
  for (int c = 0; c < 3; ++c) {
    q0[c] = quant_u(lo[c], bits);
    q1[c] = quant_u(hi[c], bits);
  }
  double best = 1e30;
  best = try_pair(B, q0, q1, bq0, bq1, bsel, best, bits, delta9);

  int rounds = quality <= 0 ? 1 : (quality >= 4 ? 6 : quality + 1);
  for (int it = 0; it < rounds; ++it) {
    double e0[3], e1[3];
    for (int c = 0; c < 3; ++c) {
      e0[c] = unquant_u(bq0[c], bits);
      e1[c] = unquant_u(bq1[c], bits);
    }
    ls_endpoints(B, bsel, e0, e1);
    int nq0[3], nq1[3];
    for (int c = 0; c < 3; ++c) {
      nq0[c] = quant_u(e0[c], bits);
      nq1[c] = quant_u(e1[c], bits);
    }
    double prev = best;
    best = try_pair(B, nq0, nq1, bq0, bq1, bsel, best, bits, delta9);
    if (best >= prev - 1e-9) break;
  }

  if (quality >= 2) {
    for (int pass = 0; pass < 2; ++pass) {
      int base0[3], base1[3];
      std::memcpy(base0, bq0, sizeof base0);
      std::memcpy(base1, bq1, sizeof base1);
      for (int c = 0; c < 3; ++c)
        for (int d0 = -1; d0 <= 1; ++d0)
          for (int d1 = -1; d1 <= 1; ++d1) {
            if (!d0 && !d1) continue;
            int nq0[3], nq1[3];
            std::memcpy(nq0, base0, sizeof nq0);
            std::memcpy(nq1, base1, sizeof nq1);
            nq0[c] = clampi(base0[c] + d0, 0, maxq);
            nq1[c] = clampi(base1[c] + d1, 0, maxq);
            best = try_pair(B, nq0, nq1, bq0, bq1, bsel, best, bits, delta9);
          }
      if (!std::memcmp(base0, bq0, sizeof base0) &&
          !std::memcmp(base1, bq1, sizeof base1))
        break;
    }
  }

  // Fixup: anchor index 0 must have its MSB clear (the spec drops the
  // anchor's top bit); swap endpoints if needed (palette reverses).
  if (bsel[0] & 8) {
    std::swap(bq0[0], bq1[0]);
    std::swap(bq0[1], bq1[1]);
    std::swap(bq0[2], bq1[2]);
    for (int t = 0; t < 16; ++t) bsel[t] = 15 - bsel[t];
    if (delta9) {
      // The swap negates the delta, which fits unless it was -256;
      // re-clamp (matching kernels/bc6h.py _pack_mode12).
      apply_delta9(bq0, bq1);
    }
  }
  return best;
}

void pack_mode11(const int bq0[3], const int bq1[3], const int bsel[16],
                 uint8_t out[16]) {
  // Mode 11: 5 mode bits 00011, then rw[9:0] gw[9:0] bw[9:0]
  // rx[9:0] gx[9:0] bx[9:0], then 63 index bits (anchor 3 bits).
  uint8_t bits[16] = {};
  int pos = 0;
  auto put = [&](uint64_t v, int n) {
    for (int i = 0; i < n; ++i) {
      if ((v >> i) & 1) bits[(pos + i) >> 3] |= (uint8_t)(1 << ((pos + i) & 7));
    }
    pos += n;
  };
  put(0x03, 5);  // mode 11 = 00011 (LSB-first: bits 0..4)
  for (int c = 0; c < 3; ++c) put((uint64_t)bq0[c], 10);
  for (int c = 0; c < 3; ++c) put((uint64_t)bq1[c], 10);
  put((uint64_t)(bsel[0] & 7), 3);
  for (int t = 1; t < 16; ++t) put((uint64_t)(bsel[t] & 15), 4);
  std::memcpy(out, bits, 16);
}

void pack_mode12(const int bq0[3], const int bq1[3], const int bsel[16],
                 uint8_t out[16]) {
  // Mode 12 (kernels/bc6h.py _pack_mode12): 5 mode bits 00111, rw low 10
  // bits per channel, then per channel the 9-bit delta and rw bit 10.
  uint8_t bits[16] = {};
  int pos = 0;
  auto put = [&](uint64_t v, int n) {
    for (int i = 0; i < n; ++i) {
      if ((v >> i) & 1) bits[(pos + i) >> 3] |= (uint8_t)(1 << ((pos + i) & 7));
    }
    pos += n;
  };
  put(0x07, 5);
  for (int c = 0; c < 3; ++c) put((uint64_t)(bq0[c] & 0x3FF), 10);
  for (int c = 0; c < 3; ++c) {
    uint32_t d = (uint32_t)(bq1[c] - bq0[c]);
    put(d & 0x1FF, 9);
    put((uint64_t)((bq0[c] >> 10) & 1), 1);
  }
  put((uint64_t)(bsel[0] & 7), 3);
  for (int t = 1; t < 16; ++t) put((uint64_t)(bsel[t] & 15), 4);
  std::memcpy(out, bits, 16);
}

// ---------------------------------------------------------------------------
// Two-region modes (the ispc slow/veryslow breadth; layouts from
// bc6h_tables.inc, field semantics per kernels/bc6h_tables.py)
// ---------------------------------------------------------------------------

// Within-cluster SSE over the 32 BPTC partitions; fills `order` with all
// 32 partition ids sorted ascending by SSE.
void screen_partitions(const Block& B, int order[32]) {
  double score[32];
  for (int p = 0; p < 32; ++p) {
    uint16_t mask = kBptcPartition2[p];
    double sum[2][3] = {{0, 0, 0}, {0, 0, 0}}, cnt[2] = {0, 0}, sq = 0;
    for (int t = 0; t < 16; ++t) {
      int s = (mask >> t) & 1;
      cnt[s] += 1.0;
      for (int c = 0; c < 3; ++c) {
        double v = B.v[t][c];
        sum[s][c] += v;
        sq += v * v;
      }
    }
    double expl = 0;
    for (int s = 0; s < 2; ++s)
      for (int c = 0; c < 3; ++c) expl += sum[s][c] * sum[s][c] / cnt[s];
    score[p] = sq - expl;
    order[p] = p;
  }
  std::sort(order, order + 32,
            [&](int a, int b) { return score[a] < score[b]; });
}

// Exact decode-model evaluation of a two-region candidate.  qs holds the
// EFFECTIVE quantized endpoints [subset*2 + lo/hi][3]; anchors are index
// -clamped to 3 (MSB clear) rather than fixed up by swapping, matching
// the pre-oriented seeds.
double tr_eval(const Block& B, uint16_t mask, int anchor1, int epbits,
               const int qs[4][3], int sel[16]) {
  int pal[2][8][3];
  for (int s = 0; s < 2; ++s)
    for (int c = 0; c < 3; ++c) {
      int u0 = unquant_u(qs[2 * s][c], epbits);
      int u1 = unquant_u(qs[2 * s + 1][c], epbits);
      for (int i = 0; i < 8; ++i)
        pal[s][i][c] =
            finalize_u((u0 * (64 - W3[i]) + u1 * W3[i] + 32) >> 6);
    }
  double err = 0;
  for (int t = 0; t < 16; ++t) {
    int s = (mask >> t) & 1;
    int lim = (t == 0 || t == anchor1) ? 4 : 8;
    double bb = 1e30;
    int bi = 0;
    for (int i = 0; i < lim; ++i) {
      double e = 0;
      for (int c = 0; c < 3; ++c) {
        double d = (double)B.v[t][c] - pal[s][i][c];
        e += d * d;
      }
      if (e < bb) { bb = e; bi = i; }
    }
    sel[t] = bi;
    err += bb;
  }
  return err;
}

// Quantize float endpoints (interp domain) for one mode, applying the
// delta clamps.  The clamp pulls the target toward rw, so the effective
// value always stays in [0, maxq] (no field wrap).
void tr_quant(const double e[2][2][3], const Bc6hModeInfo& MI,
              int qs[4][3]) {
  const int db[3] = {MI.dr, MI.dg, MI.db};
  for (int c = 0; c < 3; ++c) qs[0][c] = quant_u(e[0][0][c], MI.epbits);
  const double* tgt[3] = {e[0][1], e[1][0], e[1][1]};
  for (int k = 1; k < 4; ++k)
    for (int c = 0; c < 3; ++c) {
      int q = quant_u(tgt[k - 1][c], MI.epbits);
      if (!MI.direct) {
        int h = 1 << (db[c] - 1);
        q = qs[0][c] + clampi(q - qs[0][c], -h, h - 1);
      }
      qs[k][c] = q;
    }
}

// Per-subset LS endpoint refinement from a 3-bit index assignment.
void tr_ls(const Block& B, uint16_t mask, const int sel[16], int s,
           double e0[3], double e1[3]) {
  double a00 = 0, a01 = 0, a11 = 0, bx[3] = {0, 0, 0}, by[3] = {0, 0, 0};
  for (int t = 0; t < 16; ++t) {
    if (((mask >> t) & 1) != s) continue;
    double w1 = W3[sel[t]] / 64.0, w0 = 1.0 - w1;
    a00 += w0 * w0;
    a01 += w0 * w1;
    a11 += w1 * w1;
    for (int c = 0; c < 3; ++c) {
      double tv = (double)B.v[t][c] * 64.0 / 31.0;
      bx[c] += w0 * tv;
      by[c] += w1 * tv;
    }
  }
  double det = a00 * a11 - a01 * a01;
  if (std::fabs(det) < 1e-9) return;
  for (int c = 0; c < 3; ++c) {
    e0[c] = (a11 * bx[c] - a01 * by[c]) / det;
    e1[c] = (a00 * by[c] - a01 * bx[c]) / det;
  }
}

void pack_two_region(int mode_idx, int p, const int qs[4][3],
                     const int sel[16], uint8_t out[16]) {
  const Bc6hModeInfo& MI = kBc6hModes[mode_idx];
  uint8_t bits[16] = {};
  auto setbit = [&](int pos) {
    bits[pos >> 3] |= (uint8_t)(1 << (pos & 7));
  };
  for (int i = 0; i < MI.mode_len; ++i)
    if ((MI.mode_bits >> i) & 1) setbit(i);
  // Field raw values: rw absolute; rx/ry/rz deltas (two's complement)
  // unless the mode stores direct endpoints.
  uint32_t fv[4][3];
  for (int c = 0; c < 3; ++c) {
    fv[0][c] = (uint32_t)qs[0][c];
    for (int k = 1; k < 4; ++k)
      fv[k][c] = (uint32_t)(MI.direct ? qs[k][c] : qs[k][c] - qs[0][c]);
  }
  const Bc6hLayoutBit* L = kBc6hLayouts[mode_idx];
  for (int i = 0; i < kBc6hLayoutLen[mode_idx]; ++i)
    if ((fv[L[i].field][L[i].ch] >> L[i].field_bit) & 1)
      setbit(L[i].block_bit);
  for (int i = 0; i < 5; ++i)
    if ((p >> i) & 1) setbit(77 + i);
  int anchor1 = kBptcAnchor2[p];
  int pos = 82;
  for (int t = 0; t < 16; ++t) {
    int w = 3 - (t == 0 ? 1 : 0) - (t == anchor1 ? 1 : 0);
    for (int i = 0; i < w; ++i)
      if ((sel[t] >> i) & 1) setbit(pos + i);
    pos += w;
  }
  std::memcpy(out, bits, 16);
}

// Search the two-region modes over the top-K screened partitions; writes
// the winning block to `out` if it beats `best`.  Returns min(best, err).
double encode_two_region(const Block& B, int quality, uint8_t out[16],
                         double best) {
  if (quality < 2) return best;
  static const int kModesQ2[] = {0, 1, 9};     // ids 1, 2, 10
  static const int kModesQ3[] = {0, 1, 5, 9};  // ids 1, 2, 6, 10
  static const int kModesAll[] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9};
  const int* modes;
  int nmodes, K, iters;
  if (quality == 2) { modes = kModesQ2; nmodes = 3; K = 1; iters = 2; }
  else if (quality == 3) { modes = kModesQ3; nmodes = 4; K = 2; iters = 3; }
  else { modes = kModesAll; nmodes = 10; K = 8; iters = 4; }

  int order[32];
  screen_partitions(B, order);

  // Track the best two-region candidate for the q4 neighborhood sweep.
  bool have = false;
  int w_mode = 0, w_p = 0, w_qs[4][3], w_sel[16];
  double tr_best = 1e30;

  for (int pi = 0; pi < K; ++pi) {
    int p = order[pi];
    uint16_t mask = kBptcPartition2[p];
    int anchor1 = kBptcAnchor2[p];

    // Float seed per subset: per-channel min/max in the interp domain,
    // oriented so the subset's anchor texel is nearer e0 (keeps the
    // anchor index MSB clear without pack-time swaps).
    double e[2][2][3];
    for (int s = 0; s < 2; ++s) {
      for (int c = 0; c < 3; ++c) {
        double lo = 1e30, hi = -1e30;
        for (int t = 0; t < 16; ++t) {
          if (((mask >> t) & 1) != s) continue;
          lo = std::min(lo, (double)B.v[t][c]);
          hi = std::max(hi, (double)B.v[t][c]);
        }
        e[s][0][c] = lo * 64.0 / 31.0;
        e[s][1][c] = hi * 64.0 / 31.0;
      }
      int ta = s == 0 ? 0 : anchor1;
      double d0 = 0, d1 = 0;
      for (int c = 0; c < 3; ++c) {
        double tv = (double)B.v[ta][c] * 64.0 / 31.0;
        d0 += (tv - e[s][0][c]) * (tv - e[s][0][c]);
        d1 += (tv - e[s][1][c]) * (tv - e[s][1][c]);
      }
      if (d1 < d0)
        for (int c = 0; c < 3; ++c) std::swap(e[s][0][c], e[s][1][c]);
    }

    for (int mi = 0; mi < nmodes; ++mi) {
      int m = modes[mi];
      const Bc6hModeInfo& MI = kBc6hModes[m];
      double ecur[2][2][3];
      std::memcpy(ecur, e, sizeof ecur);
      int qs[4][3], sel[16];
      double mode_best = 1e30;
      int bqs[4][3], bsel2[16];
      for (int it = 0; it < iters; ++it) {
        tr_quant(ecur, MI, qs);
        double err = tr_eval(B, mask, anchor1, MI.epbits, qs, sel);
        if (err < mode_best) {
          mode_best = err;
          std::memcpy(bqs, qs, sizeof bqs);
          std::memcpy(bsel2, sel, sizeof bsel2);
        }
        if (it + 1 < iters) {
          for (int s = 0; s < 2; ++s)
            tr_ls(B, mask, sel, s, ecur[s][0], ecur[s][1]);
          // Re-orient after LS (it can flip the gradient direction).
          int ta = 0;
          for (int s = 0; s < 2; ++s) {
            ta = s == 0 ? 0 : anchor1;
            double d0 = 0, d1 = 0;
            for (int c = 0; c < 3; ++c) {
              double tv = (double)B.v[ta][c] * 64.0 / 31.0;
              d0 += (tv - ecur[s][0][c]) * (tv - ecur[s][0][c]);
              d1 += (tv - ecur[s][1][c]) * (tv - ecur[s][1][c]);
            }
            if (d1 < d0)
              for (int c = 0; c < 3; ++c)
                std::swap(ecur[s][0][c], ecur[s][1][c]);
          }
        }
      }
      if (mode_best < tr_best) {
        tr_best = mode_best;
        w_mode = m;
        w_p = p;
        std::memcpy(w_qs, bqs, sizeof w_qs);
        std::memcpy(w_sel, bsel2, sizeof w_sel);
        have = true;
      }
    }
  }

  if (have && quality >= 4) {
    // Endpoint quant-neighborhood sweep on the winner (the veryslow
    // refinement): +-1 on each endpoint channel, deltas re-clamped.
    const Bc6hModeInfo& MI = kBc6hModes[w_mode];
    uint16_t mask = kBptcPartition2[w_p];
    int anchor1 = kBptcAnchor2[w_p];
    const int db[3] = {MI.dr, MI.dg, MI.db};
    int maxq = (1 << MI.epbits) - 1;
    for (int pass = 0; pass < 2; ++pass) {
      int base[4][3];
      std::memcpy(base, w_qs, sizeof base);
      for (int k = 0; k < 4; ++k)
        for (int c = 0; c < 3; ++c)
          for (int dd = -1; dd <= 1; dd += 2) {
            int qs[4][3], sel[16];
            std::memcpy(qs, base, sizeof qs);
            qs[k][c] = clampi(base[k][c] + dd, 0, maxq);
            if (!MI.direct) {
              // Keep every delta representable relative to (possibly
              // moved) rw.
              for (int kk = 1; kk < 4; ++kk)
                for (int cc = 0; cc < 3; ++cc) {
                  int h = 1 << (db[cc] - 1);
                  qs[kk][cc] =
                      qs[0][cc] +
                      clampi(qs[kk][cc] - qs[0][cc], -h, h - 1);
                }
            }
            double err = tr_eval(B, mask, anchor1, MI.epbits, qs, sel);
            if (err < tr_best) {
              tr_best = err;
              std::memcpy(w_qs, qs, sizeof w_qs);
              std::memcpy(w_sel, sel, sizeof w_sel);
            }
          }
      if (!std::memcmp(base, w_qs, sizeof base)) break;
    }
  }

  if (have && tr_best < best) {
    pack_two_region(w_mode, w_p, w_qs, w_sel, out);
    return tr_best;
  }
  return best;
}

void encode_block(const float* rgb /*16*3*/, int quality, uint8_t out[16]) {
  Block B;
  for (int t = 0; t < 16; ++t)
    for (int c = 0; c < 3; ++c)
      B.v[t][c] = f32_to_half_u(rgb[t * 3 + c]);

  int bq0[3], bq1[3], bsel[16];
  double best = fit_one_region(B, quality, 10, false, bq0, bq1, bsel);
  pack_mode11(bq0, bq1, bsel, out);

  if (quality >= 2) {
    uint8_t tmp[16];
    int q0b[3], q1b[3], selb[16];
    double e12 = fit_one_region(B, quality, 11, true, q0b, q1b, selb);
    if (e12 < best) {
      best = e12;
      pack_mode12(q0b, q1b, selb, out);
    }
    double e2r = encode_two_region(B, quality, tmp, best);
    if (e2r < best) {
      best = e2r;
      std::memcpy(out, tmp, 16);
    }
  }
}

}  // namespace

extern "C" {

// rgb [n,16,3] float (non-negative HDR) -> out [n,16] BC6H unsigned blocks.
void ctpu_bc6h_encode(const float* rgb, int n, int quality, int threads,
                      uint8_t* out) {
  run_blocks(n, threads, [&](int b) {
    encode_block(rgb + b * 48, quality, out + b * 16);
  });
}

}  // extern "C"
