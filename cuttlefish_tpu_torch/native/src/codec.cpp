// Native host-side image codec layer.
//
// Fills the role FreeImage plays in the reference
// (lib/src/Image.cpp): file decode/encode for the formats
// the pipeline ingests.  Implemented from the public format specs: PNG
// (zlib DEFLATE, filters 0-4, gray/rgb/palette/alpha, 8/16-bit), TGA
// (uncompressed + RLE, 8/24/32-bit), and BMP (uncompressed 24/32-bit).
// Exposed as a C API consumed through ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <zlib.h>

extern "C" {

void ctpu_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

namespace {

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  bool ok = true;

  uint32_t u32() {
    if (pos + 4 > n) { ok = false; return 0; }
    uint32_t v = (uint32_t(p[pos]) << 24) | (uint32_t(p[pos + 1]) << 16) |
                 (uint32_t(p[pos + 2]) << 8) | uint32_t(p[pos + 3]);
    pos += 4;
    return v;
  }
  const uint8_t* bytes(size_t k) {
    if (pos + k > n) { ok = false; return nullptr; }
    const uint8_t* r = p + pos;
    pos += k;
    return r;
  }
};

bool inflate_all(const std::vector<uint8_t>& in, std::vector<uint8_t>& out,
                 size_t expected) {
  out.resize(expected);
  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(in.data());
  zs.avail_in = static_cast<uInt>(in.size());
  zs.next_out = out.data();
  zs.avail_out = static_cast<uInt>(out.size());
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END || (rc == Z_OK && zs.avail_out == 0);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

}  // namespace

// Decode PNG.  On success fills out (malloc'd, caller frees via ctpu_free)
// with row-major samples, channels interleaved, 8- or 16-bit native-endian.
// Returns 0 on success.
int ctpu_png_decode(const uint8_t* data, size_t size, uint8_t** out,
                    uint32_t* out_w, uint32_t* out_h, uint32_t* out_channels,
                    uint32_t* out_bit_depth) {
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  if (size < 8 || std::memcmp(data, kSig, 8) != 0) return 1;
  Reader r{data, size, 8};

  uint32_t w = 0, h = 0;
  int bit_depth = 0, color_type = -1, interlace = 0;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;     // rgb triples
  std::vector<uint8_t> trns;        // palette alpha
  bool have_trns_color = false;
  uint16_t trns_color[3] = {0, 0, 0};

  while (r.ok && r.pos + 8 <= size) {
    uint32_t len = r.u32();
    const uint8_t* type = r.bytes(4);
    if (!r.ok) return 1;
    const uint8_t* body = r.bytes(len);
    if (!r.ok) return 1;
    r.u32();  // CRC (unchecked)
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) return 1;
      w = (uint32_t(body[0]) << 24) | (body[1] << 16) | (body[2] << 8) | body[3];
      h = (uint32_t(body[4]) << 24) | (body[5] << 16) | (body[6] << 8) | body[7];
      bit_depth = body[8];
      color_type = body[9];
      interlace = body[12];
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      palette.assign(body, body + len);
    } else if (std::memcmp(type, "tRNS", 4) == 0) {
      if (color_type == 3) {
        trns.assign(body, body + len);
      } else if (color_type == 0 && len >= 2) {
        have_trns_color = true;
        trns_color[0] = (body[0] << 8) | body[1];
      } else if (color_type == 2 && len >= 6) {
        have_trns_color = true;
        for (int c = 0; c < 3; ++c)
          trns_color[c] = (body[2 * c] << 8) | body[2 * c + 1];
      }
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
  }
  if (w == 0 || h == 0 || interlace != 0 || idat.empty()) return 2;

  int src_channels;
  switch (color_type) {
    case 0: src_channels = 1; break;
    case 2: src_channels = 3; break;
    case 3: src_channels = 1; break;
    case 4: src_channels = 2; break;
    case 6: src_channels = 4; break;
    default: return 2;
  }
  if (bit_depth != 1 && bit_depth != 2 && bit_depth != 4 && bit_depth != 8 &&
      bit_depth != 16)
    return 2;

  size_t bits_per_px = size_t(bit_depth) * src_channels;
  size_t row_bytes = (size_t(w) * bits_per_px + 7) / 8;
  size_t raw_size = (row_bytes + 1) * h;
  std::vector<uint8_t> raw;
  if (!inflate_all(idat, raw, raw_size)) return 3;

  // Unfilter in place.
  size_t bpp = (bits_per_px + 7) / 8;
  std::vector<uint8_t> prev(row_bytes, 0);
  std::vector<uint8_t> cur(row_bytes);
  std::vector<uint8_t> image(row_bytes * h);
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t* src = raw.data() + y * (row_bytes + 1);
    uint8_t filter = src[0];
    std::memcpy(cur.data(), src + 1, row_bytes);
    switch (filter) {
      case 0: break;
      case 1:
        for (size_t i = bpp; i < row_bytes; ++i) cur[i] += cur[i - bpp];
        break;
      case 2:
        for (size_t i = 0; i < row_bytes; ++i) cur[i] += prev[i];
        break;
      case 3:
        for (size_t i = 0; i < row_bytes; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          cur[i] += uint8_t((a + prev[i]) / 2);
        }
        break;
      case 4:
        for (size_t i = 0; i < row_bytes; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int c = i >= bpp ? prev[i - bpp] : 0;
          cur[i] += uint8_t(paeth(a, prev[i], c));
        }
        break;
      default:
        return 3;
    }
    std::memcpy(image.data() + y * row_bytes, cur.data(), row_bytes);
    std::swap(prev, cur);
  }

  // Expand to 8/16-bit interleaved channels.
  bool palette_mode = color_type == 3;
  bool expand_alpha = palette_mode ? !trns.empty() : have_trns_color;
  int out_ch = palette_mode ? (expand_alpha ? 4 : 3)
                            : src_channels + (have_trns_color ? 1 : 0);
  int out_depth = (bit_depth == 16) ? 16 : 8;
  size_t sample_bytes = out_depth / 8;
  uint8_t* dst = static_cast<uint8_t*>(
      std::malloc(size_t(w) * h * out_ch * sample_bytes));
  if (!dst) return 4;

  auto get_sample = [&](uint32_t y, uint32_t x, int c) -> uint32_t {
    const uint8_t* row = image.data() + size_t(y) * row_bytes;
    if (bit_depth == 16) {
      size_t off = (size_t(x) * src_channels + c) * 2;
      return (uint32_t(row[off]) << 8) | row[off + 1];
    }
    if (bit_depth == 8) return row[size_t(x) * src_channels + c];
    size_t bitpos = size_t(x) * bits_per_px + size_t(c) * bit_depth;
    uint8_t byte = row[bitpos / 8];
    int shift = 8 - bit_depth - int(bitpos % 8);
    return (byte >> shift) & ((1 << bit_depth) - 1);
  };
  uint32_t maxv = (1u << bit_depth) - 1;

  for (uint32_t y = 0; y < h; ++y) {
    for (uint32_t x = 0; x < w; ++x) {
      uint32_t vals[4] = {0, 0, 0, 0};
      if (palette_mode) {
        uint32_t idx = get_sample(y, x, 0);
        if (size_t(idx) * 3 + 2 < palette.size()) {
          vals[0] = palette[idx * 3];
          vals[1] = palette[idx * 3 + 1];
          vals[2] = palette[idx * 3 + 2];
        }
        if (expand_alpha)
          vals[3] = idx < trns.size() ? trns[idx] : 255;
      } else {
        bool transparent = have_trns_color;
        for (int c = 0; c < src_channels; ++c) {
          uint32_t v = get_sample(y, x, c);
          if (have_trns_color && c < 3 && v != trns_color[c])
            transparent = false;
          if (bit_depth < 8) v = v * 255 / maxv;  // scale to 8-bit
          vals[c] = v;
        }
        if (have_trns_color) {
          uint32_t amax = out_depth == 16 ? 0xFFFF : 0xFF;
          vals[src_channels] = transparent ? 0 : amax;
        }
      }
      size_t base = (size_t(y) * w + x) * out_ch * sample_bytes;
      for (int c = 0; c < out_ch; ++c) {
        if (out_depth == 16) {
          uint16_t v = uint16_t(vals[c]);
          std::memcpy(dst + base + c * 2, &v, 2);  // native endian
        } else {
          dst[base + c] = uint8_t(vals[c]);
        }
      }
    }
  }

  *out = dst;
  *out_w = w;
  *out_h = h;
  *out_channels = uint32_t(out_ch);
  *out_bit_depth = uint32_t(out_depth);
  return 0;
}

// Encode PNG (filter 0 rows, zlib default level).  channels: 1,2,3,4;
// bit_depth: 8 or 16 (16-bit input native endian).  Returns 0 on success.
int ctpu_png_encode(const uint8_t* pixels, uint32_t w, uint32_t h,
                    uint32_t channels, uint32_t bit_depth, uint8_t** out,
                    size_t* out_size) {
  if (channels < 1 || channels > 4 || (bit_depth != 8 && bit_depth != 16))
    return 1;
  static const int kColorType[5] = {-1, 0, 4, 2, 6};
  size_t sample_bytes = bit_depth / 8;
  size_t row_bytes = size_t(w) * channels * sample_bytes;
  std::vector<uint8_t> raw((row_bytes + 1) * h);
  for (uint32_t y = 0; y < h; ++y) {
    uint8_t* dst = raw.data() + y * (row_bytes + 1);
    dst[0] = 0;
    const uint8_t* src = pixels + y * row_bytes;
    if (bit_depth == 8) {
      std::memcpy(dst + 1, src, row_bytes);
    } else {
      for (size_t i = 0; i < row_bytes; i += 2) {  // to big-endian
        uint16_t v;
        std::memcpy(&v, src + i, 2);
        dst[1 + i] = uint8_t(v >> 8);
        dst[2 + i] = uint8_t(v);
      }
    }
  }

  uLongf comp_bound = compressBound(uLong(raw.size()));
  std::vector<uint8_t> comp(comp_bound);
  if (compress2(comp.data(), &comp_bound, raw.data(), uLong(raw.size()),
                Z_DEFAULT_COMPRESSION) != Z_OK)
    return 2;
  comp.resize(comp_bound);

  std::vector<uint8_t> file;
  file.reserve(comp.size() + 128);
  auto put32 = [&](uint32_t v) {
    file.push_back(uint8_t(v >> 24));
    file.push_back(uint8_t(v >> 16));
    file.push_back(uint8_t(v >> 8));
    file.push_back(uint8_t(v));
  };
  auto chunk = [&](const char* type, const uint8_t* body, size_t len) {
    put32(uint32_t(len));
    size_t start = file.size();
    file.insert(file.end(), type, type + 4);
    if (len) file.insert(file.end(), body, body + len);
    uint32_t crc = uint32_t(
        crc32(0, file.data() + start, uInt(file.size() - start)));
    put32(crc);
  };
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  file.insert(file.end(), kSig, kSig + 8);
  uint8_t ihdr[13];
  ihdr[0] = uint8_t(w >> 24); ihdr[1] = uint8_t(w >> 16);
  ihdr[2] = uint8_t(w >> 8); ihdr[3] = uint8_t(w);
  ihdr[4] = uint8_t(h >> 24); ihdr[5] = uint8_t(h >> 16);
  ihdr[6] = uint8_t(h >> 8); ihdr[7] = uint8_t(h);
  ihdr[8] = uint8_t(bit_depth);
  ihdr[9] = uint8_t(kColorType[channels]);
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  chunk("IHDR", ihdr, 13);
  chunk("IDAT", comp.data(), comp.size());
  chunk("IEND", nullptr, 0);

  uint8_t* buf = static_cast<uint8_t*>(std::malloc(file.size()));
  if (!buf) return 3;
  std::memcpy(buf, file.data(), file.size());
  *out = buf;
  *out_size = file.size();
  return 0;
}

// ---------------------------------------------------------------------------
// TGA (types 2/3 uncompressed, 10/11 RLE; 8/24/32-bit; bottom-up honored)
// ---------------------------------------------------------------------------

int ctpu_tga_decode(const uint8_t* data, size_t size, uint8_t** out,
                    uint32_t* out_w, uint32_t* out_h, uint32_t* out_channels) {
  if (size < 18) return 1;
  uint8_t id_len = data[0];
  uint8_t cmap_type = data[1];
  uint8_t img_type = data[2];
  if (cmap_type != 0) return 2;
  uint32_t w = data[12] | (data[13] << 8);
  uint32_t h = data[14] | (data[15] << 8);
  uint8_t depth = data[16];
  bool top_down = (data[17] & 0x20) != 0;
  if (w == 0 || h == 0) return 2;
  int ch;
  if (depth == 8) ch = 1;
  else if (depth == 24) ch = 3;
  else if (depth == 32) ch = 4;
  else return 2;
  bool rle = img_type == 10 || img_type == 11;
  if (!rle && img_type != 2 && img_type != 3) return 2;

  size_t pos = 18 + id_len;
  size_t px_bytes = size_t(depth) / 8;
  size_t total = size_t(w) * h;
  std::vector<uint8_t> px(total * px_bytes);
  if (!rle) {
    if (pos + total * px_bytes > size) return 3;
    std::memcpy(px.data(), data + pos, total * px_bytes);
  } else {
    size_t got = 0;
    while (got < total && pos < size) {
      uint8_t hdr = data[pos++];
      size_t count = (hdr & 0x7F) + 1;
      if (hdr & 0x80) {
        if (pos + px_bytes > size) return 3;
        for (size_t i = 0; i < count && got < total; ++i, ++got)
          std::memcpy(px.data() + got * px_bytes, data + pos, px_bytes);
        pos += px_bytes;
      } else {
        if (pos + count * px_bytes > size) return 3;
        for (size_t i = 0; i < count && got < total; ++i, ++got) {
          std::memcpy(px.data() + got * px_bytes, data + pos, px_bytes);
          pos += px_bytes;
        }
      }
    }
    if (got < total) return 3;
  }

  uint8_t* dst = static_cast<uint8_t*>(std::malloc(total * ch));
  if (!dst) return 4;
  for (uint32_t y = 0; y < h; ++y) {
    uint32_t sy = top_down ? y : (h - 1 - y);
    for (uint32_t x = 0; x < w; ++x) {
      const uint8_t* s = px.data() + (size_t(sy) * w + x) * px_bytes;
      uint8_t* d = dst + (size_t(y) * w + x) * ch;
      if (ch == 1) {
        d[0] = s[0];
      } else {
        d[0] = s[2];  // BGR(A) -> RGB(A)
        d[1] = s[1];
        d[2] = s[0];
        if (ch == 4) d[3] = s[3];
      }
    }
  }
  *out = dst;
  *out_w = w;
  *out_h = h;
  *out_channels = uint32_t(ch);
  return 0;
}

int ctpu_tga_encode(const uint8_t* pixels, uint32_t w, uint32_t h,
                    uint32_t channels, uint8_t** out, size_t* out_size) {
  if (channels != 1 && channels != 3 && channels != 4) return 1;
  size_t total = size_t(w) * h;
  size_t sz = 18 + total * channels;
  uint8_t* buf = static_cast<uint8_t*>(std::calloc(1, sz));
  if (!buf) return 2;
  buf[2] = channels == 1 ? 3 : 2;
  buf[12] = uint8_t(w); buf[13] = uint8_t(w >> 8);
  buf[14] = uint8_t(h); buf[15] = uint8_t(h >> 8);
  buf[16] = uint8_t(channels * 8);
  buf[17] = 0x20;  // top-down
  uint8_t* d = buf + 18;
  for (size_t i = 0; i < total; ++i) {
    const uint8_t* s = pixels + i * channels;
    if (channels == 1) {
      d[i] = s[0];
    } else {
      uint8_t* e = d + i * channels;
      e[0] = s[2]; e[1] = s[1]; e[2] = s[0];
      if (channels == 4) e[3] = s[3];
    }
  }
  *out = buf;
  *out_size = sz;
  return 0;
}

// ---------------------------------------------------------------------------
// Block runtime: surface <-> batched block tiles (edge clamp), multithreaded
// elsewhere if needed; these are memcpy-bound so single-threaded suffices.
// ---------------------------------------------------------------------------

// surface [h,w,c] float32 -> blocks [ceil(h/bh)*ceil(w/bw), bh*bw, c].
void ctpu_extract_blocks(const float* surface, int h, int w, int c, int bw,
                         int bh, float* out) {
  int nbx = (w + bw - 1) / bw;
  int nby = (h + bh - 1) / bh;
  for (int by = 0; by < nby; ++by) {
    for (int bx = 0; bx < nbx; ++bx) {
      float* blk = out + (size_t(by) * nbx + bx) * bh * bw * c;
      for (int fy = 0; fy < bh; ++fy) {
        int sy = by * bh + fy;
        if (sy >= h) sy = h - 1;
        for (int fx = 0; fx < bw; ++fx) {
          int sx = bx * bw + fx;
          if (sx >= w) sx = w - 1;
          std::memcpy(blk + (size_t(fy) * bw + fx) * c,
                      surface + (size_t(sy) * w + sx) * c,
                      sizeof(float) * c);
        }
      }
    }
  }
}

}  // extern "C"
