// Native GIF + baseline TIFF decoders (the FreeImage-analog long tail).
//
// The reference ingests ~30 formats through FreeImage
// (lib/src/Image.cpp:21); this file extends the native
// codec layer (codec.cpp: PNG/TGA/BMP, jpeg.cpp: baseline JPEG) with:
//   - GIF87a/GIF89a: first frame, global/local color tables, interlace,
//     GIF-LZW (LSB-first codes), transparency via the graphic control
//     extension -> RGBA8 when transparent, else RGB8.
//   - Baseline TIFF: II/MM byte orders, 8/16-bit, gray/palette/RGB/RGBA,
//     compression none/PackBits/LZW (MSB-first codes, early-change) with
//     the horizontal-differencing predictor, strip organization,
//     contiguous planar config.
// Validated byte-for-byte against PIL in tests/test_native.py (PIL
// encodes the fixtures; both decoders must agree).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// GIF
// ---------------------------------------------------------------------------

struct ByteReader {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool ok = true;

  uint8_t u8() {
    if (off >= n) { ok = false; return 0; }
    return p[off++];
  }
  uint16_t u16le() {
    uint16_t a = u8(), b = u8();
    return (uint16_t)(a | (b << 8));
  }
  bool skip(size_t k) {
    if (off + k > n) { ok = false; return false; }
    off += k;
    return true;
  }
  bool read(uint8_t* dst, size_t k) {
    if (off + k > n) { ok = false; return false; }
    std::memcpy(dst, p + off, k);
    off += k;
    return true;
  }
};

// GIF LZW: codes are packed LSB-first across the concatenated sub-block
// payload.
bool gif_lzw_decode(const std::vector<uint8_t>& in, int min_code_size,
                    size_t max_out, std::vector<uint8_t>* out) {
  if (min_code_size < 2 || min_code_size > 11) return false;
  const int clear_code = 1 << min_code_size;
  const int end_code = clear_code + 1;
  // dictionary: prefix index + appended byte
  std::vector<int> prefix(4096, -1);
  std::vector<uint8_t> suffix(4096, 0);
  std::vector<uint8_t> stack;
  stack.reserve(4096);

  int code_size = min_code_size + 1;
  int next_code = end_code + 1;
  int prev = -1;

  size_t bitpos = 0;
  const size_t nbits = in.size() * 8;
  auto read_code = [&]() -> int {
    if (bitpos + code_size > nbits) return -1;
    int v = 0;
    for (int i = 0; i < code_size; ++i) {
      size_t b = bitpos + i;
      v |= ((in[b >> 3] >> (b & 7)) & 1) << i;
    }
    bitpos += code_size;
    return v;
  };

  auto emit_code = [&](int code) -> bool {
    stack.clear();
    int c = code;
    int guard = 0;
    while (c >= clear_code + 2) {
      stack.push_back(suffix[c]);
      c = prefix[c];
      if (++guard > 4096) return false;
    }
    if (c < 0 || c >= clear_code) return false;
    stack.push_back((uint8_t)c);
    for (size_t i = stack.size(); i-- > 0;) {
      if (out->size() >= max_out) return true;  // tolerate overfull streams
      out->push_back(stack[i]);
    }
    return true;
  };

  for (;;) {
    int code = read_code();
    if (code < 0) break;  // truncated stream: keep what we have
    if (code == clear_code) {
      code_size = min_code_size + 1;
      next_code = end_code + 1;
      prev = -1;
      continue;
    }
    if (code == end_code) break;
    if (prev < 0) {
      if (code >= clear_code) return false;
      if (!emit_code(code)) return false;
      prev = code;
      continue;
    }
    int first_char_code;
    if (code < next_code && code != end_code) {
      // known code
      int c = code;
      while (c >= clear_code + 2) c = prefix[c];
      first_char_code = c;
      if (!emit_code(code)) return false;
    } else if (code == next_code) {
      // KwK case
      int c = prev;
      while (c >= clear_code + 2) c = prefix[c];
      first_char_code = c;
      // emit prev + first char of prev
      stack.clear();
      c = prev;
      int guard = 0;
      while (c >= clear_code + 2) {
        stack.push_back(suffix[c]);
        c = prefix[c];
        if (++guard > 4096) return false;
      }
      stack.push_back((uint8_t)c);
      for (size_t i = stack.size(); i-- > 0;)
        if (out->size() < max_out) out->push_back(stack[i]);
      if (out->size() < max_out) out->push_back((uint8_t)first_char_code);
    } else {
      return false;  // code beyond dictionary
    }
    if (next_code < 4096) {
      prefix[next_code] = prev;
      suffix[next_code] = (uint8_t)first_char_code;
      ++next_code;
      if (next_code == (1 << code_size) && code_size < 12) ++code_size;
    }
    prev = code;
    if (out->size() >= max_out) break;
  }
  return true;
}

}  // namespace

extern "C" {

// GIF -> first frame composed onto the logical screen.
// On success (return 0): *out = malloc'd pixel data (free via ctpu_free),
// *w/*h = logical screen size, *channels = 3 (opaque) or 4 (transparency).
int ctpu_gif_decode(const uint8_t* data, size_t size, uint8_t** out,
                    uint32_t* w, uint32_t* h, uint32_t* channels) {
  ByteReader r{data, size};
  uint8_t magic[6];
  if (!r.read(magic, 6)) return 1;
  if (std::memcmp(magic, "GIF87a", 6) && std::memcmp(magic, "GIF89a", 6))
    return 1;
  uint16_t sw = r.u16le(), sh = r.u16le();
  uint8_t flags = r.u8();
  uint8_t bg_index = r.u8();
  r.u8();  // aspect
  if (!r.ok || sw == 0 || sh == 0) return 1;
  if ((uint64_t)sw * sh > (uint64_t)1 << 28) return 2;

  uint8_t gct[256][3];
  int gct_size = 0;
  if (flags & 0x80) {
    gct_size = 2 << (flags & 0x07);
    for (int i = 0; i < gct_size; ++i)
      if (!r.read(gct[i], 3)) return 1;
  }

  int transparent_index = -1;
  for (;;) {
    uint8_t kind = r.u8();
    if (!r.ok) return 1;
    if (kind == 0x3B) return 1;  // trailer before any image
    if (kind == 0x21) {          // extension
      uint8_t label = r.u8();
      if (label == 0xF9) {  // graphic control
        uint8_t bs = r.u8();
        if (bs >= 4) {
          uint8_t gflags = r.u8();
          r.u16le();  // delay
          uint8_t tindex = r.u8();
          if (gflags & 1) transparent_index = tindex;
          r.skip(bs - 4);
        } else {
          r.skip(bs);
        }
        // remaining sub-blocks
        for (;;) {
          uint8_t sb = r.u8();
          if (!r.ok) return 1;
          if (sb == 0) break;
          r.skip(sb);
        }
      } else {
        for (;;) {
          uint8_t sb = r.u8();
          if (!r.ok) return 1;
          if (sb == 0) break;
          r.skip(sb);
        }
      }
      continue;
    }
    if (kind != 0x2C) return 1;  // not an image descriptor
    break;
  }

  uint16_t ix = r.u16le(), iy = r.u16le();
  uint16_t iw = r.u16le(), ih = r.u16le();
  uint8_t iflags = r.u8();
  if (!r.ok || iw == 0 || ih == 0) return 1;
  uint8_t lct[256][3];
  const uint8_t(*ct)[3] = gct;
  int ct_size = gct_size;
  if (iflags & 0x80) {
    ct_size = 2 << (iflags & 0x07);
    for (int i = 0; i < ct_size; ++i)
      if (!r.read(lct[i], 3)) return 1;
    ct = lct;
  }
  if (ct_size == 0) return 1;
  bool interlaced = (iflags & 0x40) != 0;

  uint8_t min_code = r.u8();
  std::vector<uint8_t> lzw;
  for (;;) {
    uint8_t sb = r.u8();
    if (!r.ok) return 1;
    if (sb == 0) break;
    size_t start = lzw.size();
    lzw.resize(start + sb);
    if (!r.read(lzw.data() + start, sb)) return 1;
  }
  std::vector<uint8_t> idx;
  idx.reserve((size_t)iw * ih);
  if (!gif_lzw_decode(lzw, min_code, (size_t)iw * ih, &idx)) return 1;
  if (idx.size() < (size_t)iw * ih) idx.resize((size_t)iw * ih, 0);

  // de-interlace: map sequential rows to the 4-pass order
  std::vector<uint32_t> row_of(ih);
  if (interlaced) {
    uint32_t k = 0;
    for (uint32_t y = 0; y < ih; y += 8) row_of[k++] = y;
    for (uint32_t y = 4; y < ih; y += 8) row_of[k++] = y;
    for (uint32_t y = 2; y < ih; y += 4) row_of[k++] = y;
    for (uint32_t y = 1; y < ih; y += 2) row_of[k++] = y;
  } else {
    for (uint32_t y = 0; y < ih; ++y) row_of[y] = y;
  }

  const bool has_alpha = transparent_index >= 0;
  const uint32_t nch = has_alpha ? 4 : 3;
  uint8_t* pix = (uint8_t*)std::malloc((size_t)sw * sh * nch);
  if (!pix) return 2;
  // background: PIL composes the first frame with the frame's own data
  // only; uncovered logical-screen area is transparent (alpha) or the
  // background color (opaque).
  if (has_alpha) {
    std::memset(pix, 0, (size_t)sw * sh * 4);
  } else {
    const uint8_t* bg = ct[bg_index < ct_size ? bg_index : 0];
    for (size_t t = 0; t < (size_t)sw * sh; ++t) {
      pix[t * 3 + 0] = bg[0];
      pix[t * 3 + 1] = bg[1];
      pix[t * 3 + 2] = bg[2];
    }
  }
  for (uint32_t ry = 0; ry < ih; ++ry) {
    uint32_t y = row_of[ry];
    uint32_t oy = iy + y;
    if (oy >= sh) continue;
    for (uint32_t x = 0; x < iw; ++x) {
      uint32_t ox = ix + x;
      if (ox >= sw) continue;
      uint8_t ci = idx[(size_t)ry * iw + x];
      uint8_t* dst = pix + ((size_t)oy * sw + ox) * nch;
      if (has_alpha && (int)ci == transparent_index) {
        dst[0] = dst[1] = dst[2] = dst[3] = 0;
        continue;
      }
      const uint8_t* c = ct[ci < ct_size ? ci : 0];
      dst[0] = c[0];
      dst[1] = c[1];
      dst[2] = c[2];
      if (has_alpha) dst[3] = 255;
    }
  }
  *out = pix;
  *w = sw;
  *h = sh;
  *channels = nch;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// TIFF
// ---------------------------------------------------------------------------

namespace {

struct TiffReader {
  const uint8_t* p;
  size_t n;
  bool le;

  uint16_t u16(size_t off) const {
    if (off + 2 > n) return 0;
    return le ? (uint16_t)(p[off] | (p[off + 1] << 8))
              : (uint16_t)((p[off] << 8) | p[off + 1]);
  }
  uint32_t u32(size_t off) const {
    if (off + 4 > n) return 0;
    return le ? ((uint32_t)p[off] | ((uint32_t)p[off + 1] << 8) |
                 ((uint32_t)p[off + 2] << 16) | ((uint32_t)p[off + 3] << 24))
              : (((uint32_t)p[off] << 24) | ((uint32_t)p[off + 1] << 16) |
                 ((uint32_t)p[off + 2] << 8) | (uint32_t)p[off + 3]);
  }
};

struct TiffTag {
  uint16_t id = 0;
  uint16_t type = 0;
  uint32_t count = 0;
  size_t value_off = 0;  // absolute offset of the value payload
};

size_t type_size(uint16_t t) {
  switch (t) {
    case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: return 4;
    case 5: case 10: case 12: return 8;
    default: return 0;
  }
}

uint32_t tag_value(const TiffReader& r, const TiffTag& t, uint32_t i) {
  size_t sz = type_size(t.type);
  size_t off = t.value_off + (size_t)i * sz;
  if (sz == 1) return r.p[off < r.n ? off : 0];
  if (sz == 2) return r.u16(off);
  return r.u32(off);
}

// TIFF LZW: MSB-first codes, early code-size change, clear = 256,
// end = 257.
bool tiff_lzw_decode(const uint8_t* in, size_t n, size_t max_out,
                     std::vector<uint8_t>* out) {
  const int kClear = 256, kEoi = 257;
  std::vector<int> prefix(4096, -1);
  std::vector<int> length(4096, 1);
  std::vector<uint8_t> suffix(4096, 0), first(4096, 0);
  for (int i = 0; i < 256; ++i) {
    suffix[i] = (uint8_t)i;
    first[i] = (uint8_t)i;
  }
  int code_size = 9;
  int next_code = 258;
  int prev = -1;
  size_t bitpos = 0;
  const size_t nbits = n * 8;

  auto read_code = [&]() -> int {
    if (bitpos + code_size > nbits) return -1;
    int v = 0;
    for (int i = 0; i < code_size; ++i) {
      size_t b = bitpos + i;
      v = (v << 1) | ((in[b >> 3] >> (7 - (b & 7))) & 1);
    }
    bitpos += code_size;
    return v;
  };

  auto emit = [&](int code) {
    std::vector<uint8_t> stack;
    int c = code;
    while (c >= 258) {
      stack.push_back(suffix[c]);
      c = prefix[c];
    }
    stack.push_back((uint8_t)c);
    for (size_t i = stack.size(); i-- > 0;)
      if (out->size() < max_out) out->push_back(stack[i]);
  };

  for (;;) {
    int code = read_code();
    if (code < 0 || code == kEoi) break;
    if (code == kClear) {
      code_size = 9;
      next_code = 258;
      prev = -1;
      continue;
    }
    if (prev < 0) {
      if (code >= 256) return false;
      emit(code);
      prev = code;
    } else {
      int fc;
      if (code < next_code) {
        fc = first[code];
        emit(code);
      } else if (code == next_code) {
        fc = first[prev];
        emit(prev);
        if (out->size() < max_out) out->push_back((uint8_t)fc);
      } else {
        return false;
      }
      if (next_code < 4096) {
        prefix[next_code] = prev;
        suffix[next_code] = (uint8_t)fc;
        first[next_code] = first[prev];
        ++next_code;
      }
      prev = code;
    }
    // early change: TIFF bumps the code width when next_code+1 hits the
    // limit
    if (next_code + 1 >= (1 << code_size) && code_size < 12) ++code_size;
    if (out->size() >= max_out) break;
  }
  return true;
}

bool packbits_decode(const uint8_t* in, size_t n, size_t max_out,
                     std::vector<uint8_t>* out) {
  size_t i = 0;
  while (i < n && out->size() < max_out) {
    int8_t c = (int8_t)in[i++];
    if (c >= 0) {
      size_t k = (size_t)c + 1;
      if (i + k > n) return false;
      for (size_t j = 0; j < k && out->size() < max_out; ++j)
        out->push_back(in[i + j]);
      i += k;
    } else if (c != -128) {
      if (i >= n) return false;
      uint8_t v = in[i++];
      size_t k = (size_t)(-c) + 1;
      for (size_t j = 0; j < k && out->size() < max_out; ++j)
        out->push_back(v);
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Baseline TIFF -> interleaved pixel rows.
// On success (return 0): *out = malloc'd data (ctpu_free), *channels in
// {1,3,4}, *depth in {8,16}.  16-bit output is native-endian uint16.
int ctpu_tiff_decode(const uint8_t* data, size_t size, uint8_t** out,
                     uint32_t* w, uint32_t* h, uint32_t* channels,
                     uint32_t* depth) {
  if (size < 8) return 1;
  bool le;
  if (data[0] == 'I' && data[1] == 'I') le = true;
  else if (data[0] == 'M' && data[1] == 'M') le = false;
  else return 1;
  TiffReader r{data, size, le};
  if (r.u16(2) != 42) return 1;
  size_t ifd = r.u32(4);
  if (ifd + 2 > size) return 1;
  uint16_t nent = r.u16(ifd);
  if (ifd + 2 + (size_t)nent * 12 > size) return 1;

  uint32_t width = 0, height = 0, bps = 8, comp = 1, photo = 1, spp = 1;
  uint32_t rows_per_strip = 0xFFFFFFFF, predictor = 1, planar = 1;
  TiffTag strip_offsets, strip_counts, colormap, bits_tag;
  for (uint16_t e = 0; e < nent; ++e) {
    size_t off = ifd + 2 + (size_t)e * 12;
    TiffTag t;
    t.id = r.u16(off);
    t.type = r.u16(off + 2);
    t.count = r.u32(off + 4);
    size_t vsz = type_size(t.type) * t.count;
    t.value_off = vsz <= 4 ? off + 8 : r.u32(off + 8);
    if (t.value_off + vsz > size && t.id != 0) {
      if (vsz > 4) return 1;
    }
    switch (t.id) {
      case 256: width = tag_value(r, t, 0); break;
      case 257: height = tag_value(r, t, 0); break;
      case 258: bits_tag = t; bps = tag_value(r, t, 0); break;
      case 259: comp = tag_value(r, t, 0); break;
      case 262: photo = tag_value(r, t, 0); break;
      case 273: strip_offsets = t; break;
      case 277: spp = tag_value(r, t, 0); break;
      case 278: rows_per_strip = tag_value(r, t, 0); break;
      case 279: strip_counts = t; break;
      case 284: planar = tag_value(r, t, 0); break;
      case 317: predictor = tag_value(r, t, 0); break;
      case 320: colormap = t; break;
      default: break;
    }
  }
  if (!width || !height || !strip_offsets.id) return 1;
  if ((uint64_t)width * height > (uint64_t)1 << 28) return 2;
  if (planar != 1) return 1;               // contiguous only
  if (comp != 1 && comp != 5 && comp != 32773) return 1;
  if (bps != 8 && bps != 16) return 1;
  if (bits_tag.id) {
    for (uint32_t i = 1; i < bits_tag.count; ++i)
      if (tag_value(r, bits_tag, i) != bps) return 1;  // uniform depths only
    if (bits_tag.count > 1 && spp == 1) spp = bits_tag.count;
  }
  bool is_palette = photo == 3;
  if (is_palette && (bps != 8 || spp != 1)) return 1;
  if (spp < 1 || spp > 4) return 1;

  const size_t bytes_per_px = (size_t)spp * (bps / 8);
  const size_t row_bytes = (size_t)width * bytes_per_px;
  std::vector<uint8_t> raw;
  raw.reserve(row_bytes * height);

  uint32_t nstrips = strip_offsets.count;
  uint32_t rps = rows_per_strip == 0xFFFFFFFF ? height : rows_per_strip;
  if (rps == 0) rps = height;
  for (uint32_t s = 0; s < nstrips; ++s) {
    size_t soff = tag_value(r, strip_offsets, s);
    size_t scount = strip_counts.id ? tag_value(r, strip_counts, s)
                                    : size - soff;
    if (soff + scount > size) return 1;
    uint32_t rows =
        s + 1 == nstrips ? height - (uint32_t)(s * (size_t)rps) : rps;
    size_t want = row_bytes * rows;
    size_t before = raw.size();
    if (comp == 1) {
      if (scount < want) return 1;
      raw.insert(raw.end(), data + soff, data + soff + want);
    } else if (comp == 32773) {
      if (!packbits_decode(data + soff, scount, before + want, &raw))
        return 1;
    } else {
      if (!tiff_lzw_decode(data + soff, scount, before + want, &raw))
        return 1;
    }
    if (raw.size() < before + want) raw.resize(before + want, 0);
    if (predictor == 2) {
      // horizontal differencing applies per strip row, per sample
      for (uint32_t y = 0; y < rows; ++y) {
        uint8_t* row = raw.data() + before + (size_t)y * row_bytes;
        if (bps == 8) {
          for (size_t x = spp; x < row_bytes; ++x)
            row[x] = (uint8_t)(row[x] + row[x - spp]);
        } else {
          for (size_t x = spp; x < (size_t)width * spp; ++x) {
            size_t cur = x * 2, prev = (x - spp) * 2;
            uint16_t a = le ? (uint16_t)(row[cur] | (row[cur + 1] << 8))
                            : (uint16_t)((row[cur] << 8) | row[cur + 1]);
            uint16_t b = le ? (uint16_t)(row[prev] | (row[prev + 1] << 8))
                            : (uint16_t)((row[prev] << 8) | row[prev + 1]);
            uint16_t v = (uint16_t)(a + b);
            if (le) {
              row[cur] = (uint8_t)(v & 0xFF);
              row[cur + 1] = (uint8_t)(v >> 8);
            } else {
              row[cur] = (uint8_t)(v >> 8);
              row[cur + 1] = (uint8_t)(v & 0xFF);
            }
          }
        }
      }
    }
  }
  if (raw.size() < row_bytes * height) return 1;

  if (is_palette) {
    if (!colormap.id || colormap.count < 3 * 256) return 1;
    uint8_t* pix = (uint8_t*)std::malloc((size_t)width * height * 3);
    if (!pix) return 2;
    for (size_t t = 0; t < (size_t)width * height; ++t) {
      uint8_t ci = raw[t];
      // TIFF colormaps are 16-bit; PIL scales by >> 8
      pix[t * 3 + 0] = (uint8_t)(tag_value(r, colormap, ci) >> 8);
      pix[t * 3 + 1] = (uint8_t)(tag_value(r, colormap, 256 + ci) >> 8);
      pix[t * 3 + 2] = (uint8_t)(tag_value(r, colormap, 512 + ci) >> 8);
    }
    *out = pix;
    *w = width;
    *h = height;
    *channels = 3;
    *depth = 8;
    return 0;
  }

  // photometric 0 (white-is-zero) inverts; 1/2 pass through
  uint8_t* pix = (uint8_t*)std::malloc(row_bytes * height);
  if (!pix) return 2;
  std::memcpy(pix, raw.data(), row_bytes * height);
  if (photo == 0) {
    if (bps == 8) {
      for (size_t t = 0; t < row_bytes * height; ++t) pix[t] = 255 - pix[t];
    } else {
      for (size_t t = 0; t + 1 < row_bytes * height; t += 2) {
        uint16_t v = le ? (uint16_t)(pix[t] | (pix[t + 1] << 8))
                        : (uint16_t)((pix[t] << 8) | pix[t + 1]);
        v = (uint16_t)(0xFFFF - v);
        if (le) {
          pix[t] = (uint8_t)(v & 0xFF);
          pix[t + 1] = (uint8_t)(v >> 8);
        } else {
          pix[t] = (uint8_t)(v >> 8);
          pix[t + 1] = (uint8_t)(v & 0xFF);
        }
      }
    }
  }
  if (bps == 16) {
    // normalize to native-endian uint16 (the Python wrapper reads
    // native u16)
    const bool native_le = [] {
      uint16_t probe = 1;
      return *(uint8_t*)&probe == 1;
    }();
    if (le != native_le) {
      for (size_t t = 0; t + 1 < row_bytes * height; t += 2) {
        uint8_t tmp = pix[t];
        pix[t] = pix[t + 1];
        pix[t + 1] = tmp;
      }
    }
  }
  *out = pix;
  *w = width;
  *h = height;
  *channels = spp;
  *depth = bps;
  return 0;
}

}  // extern "C"
