// Baseline JPEG decoder (ITU-T T.81 sequential DCT, 8-bit).
//
// Fills part of the FreeImage decode role for the most common interchange
// format (lib/src/Image.cpp:870-922 loads JPEG through
// FreeImage).  Scope: SOF0/SOF1, 1- or 3-component interleaved scans,
// chroma subsampling up to 4x2/2x2, restart markers, 8- and 16-bit
// quantization tables.  Progressive (SOF2), arithmetic coding, 12-bit, and
// hierarchical files return failure and the Python layer falls back to PIL.
//
// The IDCT is the float AAN (Arai-Agui-Nakajima) factorization; output is
// rounded to match integer decoders within +/-1 LSB in practice (JPEG
// permits per-sample IDCT variance; the test oracle allows a small
// tolerance vs PIL/libjpeg).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct HuffTable {
  // Canonical code tables built from BITS/HUFFVAL (T.81 Annex C).
  int32_t mincode[17];
  int32_t maxcode[18];  // maxcode[17] sentinel
  int32_t valptr[17];
  uint8_t huffval[256];
  bool present = false;
};

struct Component {
  int id = 0;
  int h = 1, v = 1;       // sampling factors
  int tq = 0;             // quant table index
  int td = 0, ta = 0;     // huffman table indices (DC/AC)
  int dc_pred = 0;
  int bx = 0, by = 0;     // blocks per MCU row/col covering the image
  std::vector<int16_t> coef;  // decoded samples per component plane
};

struct BitReader {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  bool saw_marker = false;  // hit a non-RST marker (e.g. EOI) inside scan

  // Returns next entropy-coded byte with 0xFF00 destuffing.
  int next_byte() {
    if (pos >= n) return -1;
    uint8_t b = p[pos++];
    if (b == 0xFF) {
      if (pos >= n) return -1;
      uint8_t m = p[pos];
      if (m == 0x00) {
        pos++;
        return 0xFF;
      }
      // Marker inside scan: back up so the caller can see it.
      pos--;
      saw_marker = true;
      return -1;
    }
    return b;
  }

  int get_bit() {
    if (bitcnt == 0) {
      int b = next_byte();
      if (b < 0) return 0;  // pad with zeros past the end (T.81 F.2.2.5)
      bitbuf = static_cast<uint32_t>(b);
      bitcnt = 8;
    }
    bitcnt--;
    return (bitbuf >> bitcnt) & 1;
  }

  int get_bits(int k) {
    int v = 0;
    for (int i = 0; i < k; ++i) v = (v << 1) | get_bit();
    return v;
  }

  void reset() {  // after RSTn
    bitcnt = 0;
    saw_marker = false;
  }
};

int huff_decode(BitReader& br, const HuffTable& t) {
  int code = br.get_bit();
  int len = 1;
  while (len <= 16 && code > t.maxcode[len]) {
    code = (code << 1) | br.get_bit();
    len++;
  }
  if (len > 16) return -1;
  int idx = t.valptr[len] + (code - t.mincode[len]);
  if (idx < 0 || idx > 255) return -1;
  return t.huffval[idx];
}

// EXTEND (T.81 F.2.2.1): map magnitude-category bits to signed value.
inline int extend(int v, int t) {
  return (t == 0) ? 0 : ((v < (1 << (t - 1))) ? v - (1 << t) + 1 : v);
}

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Float AAN IDCT, 8x8 in place, then level shift +128 and clamp.
void idct8x8(const float* in, uint8_t* out, int out_stride) {
  float tmp[64];
  // Rows then columns of the 1-D AAN inverse transform.
  auto pass1d = [](const float* s, float* d, int ss, int ds) {
    float s0 = s[0 * ss], s1 = s[1 * ss], s2 = s[2 * ss], s3 = s[3 * ss];
    float s4 = s[4 * ss], s5 = s[5 * ss], s6 = s[6 * ss], s7 = s[7 * ss];
    // Even part.
    float p2 = s2, p3 = s6;
    float p1 = (p2 + p3) * 0.5411961f;
    float t2 = p1 + p3 * -1.847759f;
    float t3 = p1 + p2 * 0.765367f;
    p2 = s0;
    p3 = s4;
    float t0 = p2 + p3;
    float t1 = p2 - p3;
    float x0 = t0 + t3;
    float x3 = t0 - t3;
    float x1 = t1 + t2;
    float x2 = t1 - t2;
    // Odd part.
    t0 = s7;
    t1 = s5;
    t2 = s3;
    t3 = s1;
    p1 = t0 + t3;
    p2 = t1 + t2;
    p3 = t0 + t2;
    float p4 = t1 + t3;
    float p5 = (p3 + p4) * 1.175876f;
    t0 *= 0.298631f;
    t1 *= 2.053120f;
    t2 *= 3.072711f;
    t3 *= 1.501321f;
    p1 *= -0.899976f;
    p2 *= -2.562915f;
    p3 = p3 * -1.961571f + p5;
    p4 = p4 * -0.390181f + p5;
    t3 += p1 + p4;
    t2 += p2 + p3;
    t1 += p2 + p4;
    t0 += p1 + p3;
    d[0 * ds] = x0 + t3;
    d[7 * ds] = x0 - t3;
    d[1 * ds] = x1 + t2;
    d[6 * ds] = x1 - t2;
    d[2 * ds] = x2 + t1;
    d[5 * ds] = x2 - t1;
    d[3 * ds] = x3 + t0;
    d[4 * ds] = x3 - t0;
  };
  for (int r = 0; r < 8; ++r) pass1d(in + r * 8, tmp + r * 8, 1, 1);
  float col[8];
  for (int c = 0; c < 8; ++c) {
    pass1d(tmp + c, col, 8, 1);
    for (int r = 0; r < 8; ++r) {
      // 1/8 scale (the two 1-D passes above are the unscaled LLM/AAN
      // variant with a total gain of 8).
      float v = col[r] * 0.125f + 128.0f;
      int iv = static_cast<int>(v + 0.5f) - (v < -0.5f ? 1 : 0);
      if (iv < 0) iv = 0;
      if (iv > 255) iv = 255;
      out[r * out_stride + c] = static_cast<uint8_t>(iv);
    }
  }
}

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;

  uint16_t qt[4][64];      // dequant tables, natural order
  bool qt_present[4] = {};
  HuffTable hdc[4], hac[4];
  Component comp[3];
  int ncomp = 0;
  int width = 0, height = 0;
  int hmax = 1, vmax = 1;
  int restart_interval = 0;

  bool fail(const char*) { return false; }

  int u8() { return pos < n ? data[pos++] : -1; }
  int u16() {
    int a = u8(), b = u8();
    return (a < 0 || b < 0) ? -1 : (a << 8) | b;
  }

  bool parse_dqt(size_t seg_end) {
    while (pos < seg_end) {
      int pq_tq = u8();
      if (pq_tq < 0) return false;
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) return false;
      for (int i = 0; i < 64; ++i) {
        int v = pq ? u16() : u8();
        if (v < 0) return false;
        qt[tq][kZigzag[i]] = static_cast<uint16_t>(v);
      }
      qt_present[tq] = true;
    }
    return true;
  }

  bool parse_dht(size_t seg_end) {
    while (pos < seg_end) {
      int tc_th = u8();
      if (tc_th < 0) return false;
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) return false;
      uint8_t bits[17];
      int total = 0;
      for (int i = 1; i <= 16; ++i) {
        int v = u8();
        if (v < 0) return false;
        bits[i] = static_cast<uint8_t>(v);
        total += v;
      }
      if (total > 256 || pos + total > seg_end) return false;
      HuffTable& t = tc ? hac[th] : hdc[th];
      for (int i = 0; i < total; ++i) t.huffval[i] = data[pos++];
      // Canonical code assignment (T.81 C.2).
      int code = 0, k = 0;
      for (int len = 1; len <= 16; ++len) {
        t.valptr[len] = k;
        t.mincode[len] = code;
        code += bits[len];
        k += bits[len];
        t.maxcode[len] = bits[len] ? code - 1 : -1;
        code <<= 1;
      }
      t.maxcode[17] = 0x7FFFFFFF;
      t.present = true;
    }
    return true;
  }

  bool parse_sof(size_t seg_end) {
    int prec = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (prec != 8 || height <= 0 || width <= 0) return false;
    if (ncomp != 1 && ncomp != 3) return false;
    for (int c = 0; c < ncomp; ++c) {
      comp[c].id = u8();
      int hv = u8();
      comp[c].h = hv >> 4;
      comp[c].v = hv & 15;
      comp[c].tq = u8();
      if (comp[c].h < 1 || comp[c].h > 4 || comp[c].v < 1 || comp[c].v > 4 ||
          comp[c].tq > 3)
        return false;
      if (comp[c].h > hmax) hmax = comp[c].h;
      if (comp[c].v > vmax) vmax = comp[c].v;
    }
    return pos <= seg_end;
  }

  // Decode one 8x8 block's coefficients into coef (natural order,
  // dequantized), then IDCT into the component plane.
  bool decode_block(BitReader& br, Component& c, uint8_t* plane,
                    int plane_w, int bx, int by) {
    float block[64];
    const uint16_t* q = qt[c.tq];
    int s = huff_decode(br, hdc[c.td]);
    if (s < 0 || s > 15) return false;
    int diff = extend(br.get_bits(s), s);
    c.dc_pred += diff;
    std::memset(block, 0, sizeof(block));
    block[0] = static_cast<float>(c.dc_pred * q[0]);
    int k = 1;
    while (k < 64) {
      int rs = huff_decode(br, hac[c.ta]);
      if (rs < 0) return false;
      int r = rs >> 4, sz = rs & 15;
      if (sz == 0) {
        if (r == 15) {
          k += 16;  // ZRL
          continue;
        }
        break;  // EOB
      }
      k += r;
      if (k > 63) return false;
      int zz = kZigzag[k];
      block[zz] = static_cast<float>(extend(br.get_bits(sz), sz) * q[zz]);
      k++;
    }
    uint8_t tile[64];
    idct8x8(block, tile, 8);
    int x0 = bx * 8, y0 = by * 8;
    int ph = (plane_w > 0) ? plane_w : 0;
    (void)ph;
    for (int y = 0; y < 8; ++y) {
      std::memcpy(plane + (y0 + y) * plane_w + x0, tile + y * 8, 8);
    }
    return true;
  }

  // Upsample one chroma plane (MCU-padded, row stride `stride`) with
  // sampling factors (ch, cv) to a tight width x height plane.  Factor-2
  // ratios reproduce libjpeg's triangular filters (jdsample.c
  // h2v1_fancy_upsample / h2v2_fancy_upsample, incl. the +1/+2 and +7/+8
  // rounding asymmetry and edge replication); other ratios use nearest.
  std::vector<uint8_t> upsample_plane(const std::vector<uint8_t>& src,
                                      int stride, int ch, int cv) {
    std::vector<uint8_t> out(static_cast<size_t>(width) * height);
    if (ch == hmax && cv == vmax) {
      for (int y = 0; y < height; ++y)
        std::memcpy(out.data() + static_cast<size_t>(y) * width,
                    src.data() + static_cast<size_t>(y) * stride, width);
      return out;
    }
    int cw = (width * ch + hmax - 1) / hmax;    // downsampled width
    int chh = (height * cv + vmax - 1) / vmax;  // downsampled height
    auto h2_row = [&](const uint8_t* s, uint8_t* d, int dlen) {
      // o[2i] leans on s[i-1], o[2i+1] on s[i+1]; edges replicate.
      std::vector<uint8_t> tmp(2 * cw);
      if (cw == 1) {
        tmp[0] = tmp[1] = s[0];
      } else {
        tmp[0] = s[0];
        tmp[1] = static_cast<uint8_t>((3 * s[0] + s[1] + 2) >> 2);
        for (int i = 1; i < cw - 1; ++i) {
          int v3 = 3 * s[i];
          tmp[2 * i] = static_cast<uint8_t>((v3 + s[i - 1] + 1) >> 2);
          tmp[2 * i + 1] = static_cast<uint8_t>((v3 + s[i + 1] + 2) >> 2);
        }
        tmp[2 * cw - 2] =
            static_cast<uint8_t>((3 * s[cw - 1] + s[cw - 2] + 1) >> 2);
        tmp[2 * cw - 1] = s[cw - 1];
      }
      std::memcpy(d, tmp.data(), dlen);
    };
    if (hmax == 2 * ch && vmax == cv) {
      for (int y = 0; y < height; ++y)
        h2_row(src.data() + static_cast<size_t>(y) * stride,
               out.data() + static_cast<size_t>(y) * width, width);
      return out;
    }
    if (hmax == 2 * ch && vmax == 2 * cv) {
      // Column sums 3*cur + adjacent row (above for even output rows,
      // below for odd), then the horizontal triangle on the sums.
      std::vector<int> colsum(cw);
      for (int oy = 0; oy < height; ++oy) {
        int sy = oy >> 1;
        int ay = (oy & 1) ? (sy + 1 < chh ? sy + 1 : chh - 1)
                          : (sy > 0 ? sy - 1 : 0);
        const uint8_t* r0 = src.data() + static_cast<size_t>(sy) * stride;
        const uint8_t* r1 = src.data() + static_cast<size_t>(ay) * stride;
        for (int i = 0; i < cw; ++i) colsum[i] = 3 * r0[i] + r1[i];
        uint8_t* d = out.data() + static_cast<size_t>(oy) * width;
        std::vector<uint8_t> tmp(2 * cw);
        if (cw == 1) {
          tmp[0] = tmp[1] = static_cast<uint8_t>((colsum[0] * 4 + 8) >> 4);
        } else {
          tmp[0] = static_cast<uint8_t>((colsum[0] * 4 + 8) >> 4);
          tmp[1] =
              static_cast<uint8_t>((colsum[0] * 3 + colsum[1] + 7) >> 4);
          for (int i = 1; i < cw - 1; ++i) {
            int v3 = colsum[i] * 3;
            tmp[2 * i] = static_cast<uint8_t>((v3 + colsum[i - 1] + 8) >> 4);
            tmp[2 * i + 1] =
                static_cast<uint8_t>((v3 + colsum[i + 1] + 7) >> 4);
          }
          tmp[2 * cw - 2] = static_cast<uint8_t>(
              (colsum[cw - 1] * 3 + colsum[cw - 2] + 8) >> 4);
          tmp[2 * cw - 1] =
              static_cast<uint8_t>((colsum[cw - 1] * 4 + 7) >> 4);
        }
        std::memcpy(d, tmp.data(), width);
      }
      return out;
    }
    // General ratios: nearest.
    for (int y = 0; y < height; ++y) {
      int sy = y * cv / vmax;
      if (sy >= chh) sy = chh - 1;
      const uint8_t* s = src.data() + static_cast<size_t>(sy) * stride;
      uint8_t* d = out.data() + static_cast<size_t>(y) * width;
      for (int x = 0; x < width; ++x) {
        int sx = x * ch / hmax;
        if (sx >= cw) sx = cw - 1;
        d[x] = s[sx];
      }
    }
    return out;
  }

  bool decode_scan(std::vector<std::vector<uint8_t>>& planes,
                   std::vector<int>& plane_w, std::vector<int>& plane_h) {
    // SOS header.
    int ns = u8();
    if (ns != ncomp) return false;  // non-interleaved: PIL fallback
    int order[3];
    for (int i = 0; i < ns; ++i) {
      int cs = u8();
      int tdta = u8();
      int found = -1;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == cs) found = c;
      if (found < 0) return false;
      comp[found].td = tdta >> 4;
      comp[found].ta = tdta & 15;
      if (!hdc[comp[found].td].present || !hac[comp[found].ta].present)
        return false;
      order[i] = found;
    }
    pos += 3;  // Ss, Se, Ah/Al (fixed 0,63,0 in baseline)
    if (pos > n) return false;

    int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    plane_w.resize(ncomp);
    plane_h.resize(ncomp);
    planes.resize(ncomp);
    for (int c = 0; c < ncomp; ++c) {
      plane_w[c] = mcux * comp[c].h * 8;
      plane_h[c] = mcuy * comp[c].v * 8;
      planes[c].assign(static_cast<size_t>(plane_w[c]) * plane_h[c], 0);
      if (!qt_present[comp[c].tq]) return false;
    }

    BitReader br{data + pos, n - pos};
    int mcu_count = 0;
    for (int my = 0; my < mcuy; ++my) {
      for (int mx = 0; mx < mcux; ++mx) {
        if (restart_interval && mcu_count == restart_interval) {
          // Expect RSTn marker: align to byte, consume FFD0-FFD7.
          br.bitcnt = 0;
          size_t p2 = br.pos;
          if (p2 + 1 < br.n && br.p[p2] == 0xFF && br.p[p2 + 1] >= 0xD0 &&
              br.p[p2 + 1] <= 0xD7) {
            br.pos = p2 + 2;
          }
          br.reset();
          for (int c = 0; c < ncomp; ++c) comp[c].dc_pred = 0;
          mcu_count = 0;
        }
        for (int i = 0; i < ns; ++i) {
          Component& c = comp[order[i]];
          for (int v = 0; v < c.v; ++v) {
            for (int h = 0; h < c.h; ++h) {
              if (!decode_block(br, c, planes[order[i]].data(),
                                plane_w[order[i]], mx * c.h + h,
                                my * c.v + v))
                return false;
            }
          }
        }
        mcu_count++;
      }
    }
    return true;
  }

  // Returns channels (1 or 3) on success, 0 on failure.
  int decode(uint8_t** out) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) return 0;
    pos = 2;
    bool have_sof = false;
    std::vector<std::vector<uint8_t>> planes;
    std::vector<int> pw, ph;
    while (pos + 4 <= n) {
      if (data[pos] != 0xFF) return 0;
      int marker = data[pos + 1];
      pos += 2;
      if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      if (marker == 0xD9) break;  // EOI
      int len = u16();
      if (len < 2) return 0;
      size_t seg_end = pos + len - 2;
      if (seg_end > n) return 0;
      switch (marker) {
        case 0xC0:
        case 0xC1:  // SOF0/SOF1 baseline
          if (!parse_sof(seg_end)) return 0;
          have_sof = true;
          break;
        case 0xC2:  // progressive: not handled here
        case 0xC3:
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          return 0;
        case 0xC4:
          if (!parse_dht(seg_end)) return 0;
          break;
        case 0xDB:
          if (!parse_dqt(seg_end)) return 0;
          break;
        case 0xDD:
          restart_interval = u16();
          break;
        case 0xDA: {  // SOS
          if (!have_sof) return 0;
          if (!decode_scan(planes, pw, ph)) return 0;
          // Assemble output.
          size_t px = static_cast<size_t>(width) * height;
          int channels = (ncomp == 1) ? 1 : 3;
          uint8_t* rgb = static_cast<uint8_t*>(
              std::malloc(px * channels));
          if (!rgb) return 0;
          if (ncomp == 1) {
            for (int y = 0; y < height; ++y)
              std::memcpy(rgb + static_cast<size_t>(y) * width,
                          planes[0].data() + static_cast<size_t>(y) * pw[0],
                          width);
          } else {
            // Upsample chroma to full resolution first.  Factor-2 ratios
            // use libjpeg's triangular "fancy" filter (jdsample.c) for
            // pixel-level agreement with libjpeg/PIL; other ratios fall
            // back to nearest.
            std::vector<uint8_t> up[2];
            for (int ci = 1; ci <= 2; ++ci) {
              up[ci - 1] = upsample_plane(
                  planes[ci], pw[ci], comp[ci].h, comp[ci].v);
            }
            for (int y = 0; y < height; ++y) {
              for (int x = 0; x < width; ++x) {
                int Y = planes[0][static_cast<size_t>(y) * pw[0] + x];
                int Cb = up[0][static_cast<size_t>(y) * width + x];
                int Cr = up[1][static_cast<size_t>(y) * width + x];
                // JFIF YCbCr -> RGB (fixed point, matches libjpeg tables).
                int cb = Cb - 128, cr = Cr - 128;
                int r = Y + ((91881 * cr + 32768) >> 16);
                int g = Y - ((22554 * cb + 46802 * cr + 32768) >> 16);
                int b = Y + ((116130 * cb + 32768) >> 16);
                uint8_t* o =
                    rgb + (static_cast<size_t>(y) * width + x) * 3;
                o[0] = static_cast<uint8_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
                o[1] = static_cast<uint8_t>(g < 0 ? 0 : (g > 255 ? 255 : g));
                o[2] = static_cast<uint8_t>(b < 0 ? 0 : (b > 255 ? 255 : b));
              }
            }
          }
          *out = rgb;
          return channels;
        }
        default:
          break;  // APPn / COM / others: skip
      }
      pos = seg_end;
    }
    return 0;
  }
};

}  // namespace

extern "C" {

// Decode a baseline JPEG.  On success returns 1 and fills out/w/h/channels
// (channels 1=gray, 3=RGB; caller frees with ctpu_free).  Returns 0 on any
// unsupported feature (progressive, 12-bit, CMYK, ...) so the caller can
// fall back.
int ctpu_jpeg_decode(const uint8_t* data, size_t n, uint8_t** out,
                     uint32_t* w, uint32_t* h, uint32_t* channels) {
  Decoder d{data, n};
  uint8_t* pixels = nullptr;
  int ch = d.decode(&pixels);
  if (ch == 0) return 0;
  *out = pixels;
  *w = static_cast<uint32_t>(d.width);
  *h = static_cast<uint32_t>(d.height);
  *channels = static_cast<uint32_t>(ch);
  return 1;
}

}  // extern "C"
