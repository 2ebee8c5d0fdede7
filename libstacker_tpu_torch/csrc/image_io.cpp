// Image reader and writer on zlib alone, for hosts that have zlib but not
// libjpeg, libpng or libtiff.
//
// It exports the C ABI of native/stacker_io.cpp (stacker_probe,
// stacker_decode_batch, stacker_decode_batch16, stacker_write_png16,
// stacker_rgb_to_gray) with the same per-file status codes and the same
// thread pool, and reproduces that file's libpng transforms.  A file it
// does not take gets kErrFormat, and the Python side decodes it through
// PIL: JPEG, and a TIFF outside the subset below.  The file's first bytes
// decide its format, not its name.
//
// PNG: IHDR, PLTE, tRNS, IDAT and IEND (ancillary chunks skipped; a CRC
// failure in a critical chunk, or an unknown critical chunk, is
// kErrDecode), colour types 0/2/3/4/6 at every depth the spec allows, the
// five row filters and Adam7.  The 8-bit output keeps the high byte of a
// 16-bit sample (png_set_strip_16), the full-depth output expands 8-bit
// samples x257 (png_set_expand_16), grey 1/2/4 scale x255/x85/x17 first,
// palettes expand to RGB, grey replicates to RGB, and alpha and tRNS are
// dropped, not composited.
//
// TIFF: the first IFD, byte order II or MM, strips, PlanarConfiguration 1,
// unsigned 8- or 16-bit samples, SamplesPerPixel 1 (MinIsBlack) or 3 and
// 4 (RGB, the extra sample dropped), compression none, LZW, Deflate or
// PackBits, Predictor 1 or 2 (applied, as libtiff applies it, for LZW and
// Deflate only).  Rows are read as stored, whatever the Orientation tag
// says, as libtiff's scanline reader reads them.  A 16-bit sample gives
// its high byte at 8 bits, an 8-bit one x257 at full depth.
//
// The less common forms are decoded here, not left to PIL, because the
// libraries of native/stacker_io.cpp decode them and such files reach a
// stacker: palette and 1/2/4-bit grey PNGs are what lossless optimisers
// (optipng, oxipng) rewrite few-colour frames into, Adam7 is an export
// option of GIMP and ImageMagick (-interlace PNG), and PackBits is one of
// the TIFF compressions of macOS Preview and of tiffcp (-c packbits).
//
// Build: g++ -O3 -fPIC -std=c++17 -Wall image_io.cpp -o libimage_io.so
//        -shared -lz   (utils/native_loader.py builds it on first use).

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <utility>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kErrOpen = 1;
constexpr int kErrDecode = 2;
constexpr int kErrSize = 3;
constexpr int kErrFormat = 4;

// A decode stops by throwing its status; the per-file boundary catches
// it, so no exception crosses the C ABI.
struct Status {
  int code;
};

[[noreturn]] void fail(int code) { throw Status{code}; }

// ---- files ------------------------------------------------------------

struct File {
  FILE* f;
  explicit File(const char* path, const char* mode = "rb")
      : f(std::fopen(path, mode)) {}
  ~File() {
    if (f) std::fclose(f);
  }
  File(const File&) = delete;
  File& operator=(const File&) = delete;
};

// n bytes at `off` of a file read on demand (probe) or held whole (decode);
// false past the end.
struct Source {
  FILE* file = nullptr;
  const std::vector<uint8_t>* mem = nullptr;

  bool read_at(uint64_t off, void* dst, size_t n) const {
    if (mem) {
      if (off > mem->size() || n > mem->size() - off) return false;
      std::memcpy(dst, mem->data() + off, n);
      return true;
    }
    if (fseeko(file, (off_t)off, SEEK_SET) != 0) return false;
    return std::fread(dst, 1, n, file) == n;
  }
};

enum class Kind { kPng, kTiff, kOther };

Kind sniff(const uint8_t* head, size_t n) {
  static const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a,
                                     '\n'};
  if (n >= 8 && std::memcmp(head, kPngSig, 8) == 0) return Kind::kPng;
  if (n >= 4 && ((head[0] == 'I' && head[1] == 'I' && head[2] == 42 &&
                  head[3] == 0) ||
                 (head[0] == 'M' && head[1] == 'M' && head[2] == 0 &&
                  head[3] == 42)))
    return Kind::kTiff;  // classic TIFF; BigTIFF (43) is not taken
  return Kind::kOther;
}

// ---- output samples ---------------------------------------------------

template <typename T>
inline T from8(uint32_t v);
template <>
inline uint8_t from8<uint8_t>(uint32_t v) {
  return (uint8_t)v;
}
template <>
inline uint16_t from8<uint16_t>(uint32_t v) {
  return (uint16_t)(v * 257);  // 0xAB -> 0xABAB, 255 -> 65535
}

template <typename T>
inline T from16(uint32_t v);
template <>
inline uint8_t from16<uint8_t>(uint32_t v) {
  return (uint8_t)(v >> 8);  // the high byte, as png_set_strip_16
}
template <>
inline uint16_t from16<uint16_t>(uint32_t v) {
  return (uint16_t)v;
}

inline uint32_t be16(const uint8_t* p) { return (uint32_t)p[0] << 8 | p[1]; }

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 |
         p[3];
}

// ---- zlib -------------------------------------------------------------

// Inflates one zlib stream split over spans (a PNG's IDAT chunks, a TIFF
// strip) in exact-size reads.
class Inflater {
 public:
  explicit Inflater(std::vector<std::pair<const uint8_t*, size_t>> spans)
      : spans_(std::move(spans)) {
    if (inflateInit(&z_) != Z_OK) fail(kErrDecode);
  }
  ~Inflater() { inflateEnd(&z_); }
  Inflater(const Inflater&) = delete;
  Inflater& operator=(const Inflater&) = delete;

  void read(uint8_t* dst, size_t n) {
    z_.next_out = dst;
    z_.avail_out = (uInt)n;
    while (z_.avail_out) {
      if (ended_) fail(kErrDecode);  // the stream ended short
      if (z_.avail_in == 0) {
        if (next_ == spans_.size()) fail(kErrDecode);  // the data ran out
        z_.next_in = const_cast<Bytef*>(spans_[next_].first);
        z_.avail_in = (uInt)spans_[next_].second;
        ++next_;
        continue;
      }
      const int rc = ::inflate(&z_, Z_NO_FLUSH);
      if (rc == Z_STREAM_END)
        ended_ = true;
      else if (rc != Z_OK)
        fail(kErrDecode);
    }
  }

 private:
  z_stream z_{};
  std::vector<std::pair<const uint8_t*, size_t>> spans_;
  size_t next_ = 0;
  bool ended_ = false;
};

// ---- PNG --------------------------------------------------------------

struct PngHeader {
  uint32_t w, h;
  int depth, color, interlace;
};

int png_channels(int color) {
  switch (color) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
  }
  return 0;
}

// p: the signature and the IHDR chunk (29 bytes)
PngHeader png_header(const uint8_t* p) {
  if (be32(p + 8) != 13 || std::memcmp(p + 12, "IHDR", 4) != 0)
    fail(kErrDecode);
  PngHeader hd{be32(p + 16), be32(p + 20), p[24], p[25], p[28]};
  const int compression = p[26], filter = p[27];
  if (hd.w == 0 || hd.h == 0 || hd.w > 0x7fffffffu || hd.h > 0x7fffffffu ||
      compression != 0 || filter != 0 || hd.interlace > 1)
    fail(kErrDecode);
  const int d = hd.depth;
  bool ok;
  switch (hd.color) {
    case 0: ok = d == 1 || d == 2 || d == 4 || d == 8 || d == 16; break;
    case 3: ok = d == 1 || d == 2 || d == 4 || d == 8; break;
    case 2: case 4: case 6: ok = d == 8 || d == 16; break;
    default: ok = false;
  }
  if (!ok) fail(kErrDecode);
  return hd;
}

// The spec's predictor, ties to a, then b, then c; with p = a + b - c,
// |p - a| = |b - c|, |p - b| = |a - c| and |p - c| = |a + b - 2c|, which
// the compiler turns into selects rather than branches.
inline uint8_t paeth(int a, int b, int c) {
  const int pa = std::abs(b - c), pb = std::abs(a - c),
            pc = std::abs(a + b - 2 * c);
  const int bc = pb <= pc ? b : c;
  return (uint8_t)(pa <= pb && pa <= pc ? a : bc);
}

// Undo one row's filter in place; `prev` is the pass's previous row (zeros
// for its first), `bpp` the bytes per complete pixel, at least 1.
void unfilter(uint8_t* cur, const uint8_t* prev, size_t n, size_t bpp,
              int type) {
  switch (type) {
    case 0:
      break;
    case 1:
      for (size_t i = bpp; i < n; ++i) cur[i] += cur[i - bpp];
      break;
    case 2:
      for (size_t i = 0; i < n; ++i) cur[i] += prev[i];
      break;
    case 3:
      for (size_t i = 0; i < std::min(bpp, n); ++i) cur[i] += prev[i] >> 1;
      for (size_t i = bpp; i < n; ++i)
        cur[i] += (uint8_t)(((unsigned)cur[i - bpp] + prev[i]) >> 1);
      break;
    case 4:
      for (size_t i = 0; i < std::min(bpp, n); ++i) cur[i] += prev[i];
      for (size_t i = bpp; i < n; ++i)
        cur[i] += paeth(cur[i - bpp], prev[i], prev[i - bpp]);
      break;
    default:
      fail(kErrDecode);
  }
}

// sample i of a row packed at `d` < 8 bits, most significant bits first
inline uint32_t packed(const uint8_t* row, size_t i, int d) {
  const size_t bit = i * (size_t)d;
  return (row[bit >> 3] >> (8 - d - (int)(bit & 7))) & ((1u << d) - 1);
}

// One unfiltered row of `npix` pixels to RGB samples at dst, dst + step, ...
template <typename T>
void png_emit(const PngHeader& hd, const uint8_t* pal, const uint8_t* row,
              size_t npix, T* dst, size_t step) {
  const int d = hd.depth;
  if (hd.color == 2 || hd.color == 6) {
    const size_t ch = hd.color == 2 ? 3 : 4;
    if (d == 8) {
      for (size_t i = 0; i < npix; ++i, dst += step) {
        const uint8_t* s = row + i * ch;
        dst[0] = from8<T>(s[0]);
        dst[1] = from8<T>(s[1]);
        dst[2] = from8<T>(s[2]);
      }
    } else {
      for (size_t i = 0; i < npix; ++i, dst += step) {
        const uint8_t* s = row + i * ch * 2;
        dst[0] = from16<T>(be16(s));
        dst[1] = from16<T>(be16(s + 2));
        dst[2] = from16<T>(be16(s + 4));
      }
    }
  } else if (hd.color == 0 || hd.color == 4) {
    const size_t ch = hd.color == 0 ? 1 : 2;
    for (size_t i = 0; i < npix; ++i, dst += step) {
      T v;
      if (d == 16)
        v = from16<T>(be16(row + i * ch * 2));
      else if (d == 8)
        v = from8<T>(row[i * ch]);
      else  // grey 1/2/4 scaled to 8 bits: x255, x85, x17
        v = from8<T>(packed(row, i, d) * (255u / ((1u << d) - 1)));
      dst[0] = dst[1] = dst[2] = v;
    }
  } else {  // palette
    for (size_t i = 0; i < npix; ++i, dst += step) {
      const uint8_t* p = pal + 3 * (d == 8 ? row[i] : packed(row, i, d));
      dst[0] = from8<T>(p[0]);
      dst[1] = from8<T>(p[1]);
      dst[2] = from8<T>(p[2]);
    }
  }
}

template <typename T>
void decode_png(const std::vector<uint8_t>& buf, T* out, int64_t want_h,
                int64_t want_w) {
  if (buf.size() < 33) fail(kErrDecode);
  const PngHeader hd = png_header(buf.data());
  if ((int64_t)hd.h != want_h || (int64_t)hd.w != want_w) fail(kErrSize);

  // indices past the palette's end read black, as libpng's zeroed table
  uint8_t palette[256 * 3] = {0};
  bool have_plte = false;
  std::vector<std::pair<const uint8_t*, size_t>> idat;
  size_t pos = 8;
  bool first = true;
  while (pos + 12 <= buf.size()) {
    const uint32_t len = be32(&buf[pos]);
    if (len > 0x7fffffffu || len > buf.size() - pos - 12)
      break;  // truncated: the data read so far decides
    const uint8_t* type = &buf[pos + 4];
    const uint8_t* data = type + 4;
    const bool critical = !(type[0] & 0x20);
    if (critical && crc32(0L, type, len + 4) != be32(data + len))
      fail(kErrDecode);
    if (first) {
      first = false;  // IHDR, checked above
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.emplace_back(data, len);
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      if (len == 0 || len % 3 != 0 || !idat.empty()) fail(kErrDecode);
      std::memcpy(palette, data, std::min<size_t>(len, sizeof(palette)));
      have_plte = true;
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    } else if (critical) {
      fail(kErrDecode);  // a second IHDR, or a critical chunk not known
    }
    pos += 12 + (size_t)len;
  }
  if (hd.color == 3 && !have_plte) fail(kErrDecode);

  const size_t bits_pp = (size_t)png_channels(hd.color) * hd.depth;
  const size_t bpp = std::max<size_t>(1, bits_pp / 8);
  const size_t w = hd.w, h = hd.h;
  std::vector<uint8_t> buf_a((w * bits_pp + 7) / 8 + 1);
  std::vector<uint8_t> buf_b(buf_a.size());
  uint8_t* cur = buf_a.data();  // [0] the filter byte, then the row
  uint8_t* prev = buf_b.data();
  Inflater inf(std::move(idat));

  auto pass = [&](size_t x0, size_t y0, size_t dx, size_t dy) {
    if (w <= x0 || h <= y0) return;  // an empty pass has no filter bytes
    const size_t pw = (w - x0 + dx - 1) / dx, ph = (h - y0 + dy - 1) / dy;
    const size_t rb = (pw * bits_pp + 7) / 8;
    std::fill(prev + 1, prev + 1 + rb, 0);
    for (size_t r = 0; r < ph; ++r) {
      inf.read(cur, rb + 1);
      unfilter(cur + 1, prev + 1, rb, bpp, cur[0]);
      png_emit<T>(hd, palette, cur + 1, pw, out + ((y0 + r * dy) * w + x0) * 3,
                  dx * 3);
      std::swap(cur, prev);
    }
  };
  if (hd.interlace == 0) {
    pass(0, 0, 1, 1);
  } else {  // Adam7
    static const size_t kX0[7] = {0, 4, 0, 2, 0, 1, 0};
    static const size_t kY0[7] = {0, 0, 4, 0, 2, 0, 1};
    static const size_t kDx[7] = {8, 8, 4, 4, 2, 2, 1};
    static const size_t kDy[7] = {8, 8, 8, 4, 4, 2, 2};
    for (int p = 0; p < 7; ++p) pass(kX0[p], kY0[p], kDx[p], kDy[p]);
  }
}

// ---- TIFF -------------------------------------------------------------

struct TiffEntry {
  uint16_t type = 0;
  uint32_t count = 0;
  uint8_t field[4] = {0, 0, 0, 0};
  bool present = false;
};

struct Tiff {
  const Source& src;
  bool be = false;
  uint32_t w = 0, h = 0;
  bool has_w = false, has_h = false, tiled = false;
  uint32_t spp = 1, compression = 1, photometric = 0xffffffffu, planar = 1,
           predictor = 1, fill = 1, rows_per_strip = 0xffffffffu;
  TiffEntry bits, format, offsets, counts;

  uint32_t u16(const uint8_t* p) const {
    return be ? (uint32_t)p[0] << 8 | p[1] : (uint32_t)p[1] << 8 | p[0];
  }
  uint32_t u32(const uint8_t* p) const {
    return be ? be32(p)
              : (uint32_t)p[3] << 24 | (uint32_t)p[2] << 16 |
                    (uint32_t)p[1] << 8 | p[0];
  }

  // value i of a BYTE, SHORT or LONG entry
  uint32_t value(const TiffEntry& e, uint32_t i) const {
    const size_t size = e.type == 1 ? 1 : e.type == 3 ? 2 : e.type == 4 ? 4 : 0;
    if (size == 0) fail(kErrFormat);
    if (i >= e.count) fail(kErrDecode);
    uint8_t tmp[4];
    const uint8_t* p = tmp;
    if ((uint64_t)size * e.count <= 4) {
      p = e.field + i * size;
    } else if (!src.read_at((uint64_t)u32(e.field) + (uint64_t)i * size, tmp,
                            size)) {
      fail(kErrDecode);
    }
    return size == 1 ? p[0] : size == 2 ? u16(p) : u32(p);
  }

  // the header and the first IFD's entries (values out of line are read
  // when asked for)
  explicit Tiff(const Source& s) : src(s) {
    uint8_t hdr[8];
    if (!src.read_at(0, hdr, 8)) fail(kErrDecode);
    be = hdr[0] == 'M';
    const uint64_t ifd = u32(hdr + 4);
    uint8_t cnt[2];
    if (!src.read_at(ifd, cnt, 2)) fail(kErrDecode);
    const uint32_t n = u16(cnt);
    std::vector<uint8_t> ents((size_t)n * 12);
    if (n && !src.read_at(ifd + 2, ents.data(), ents.size())) fail(kErrDecode);
    for (uint32_t k = 0; k < n; ++k) {
      const uint8_t* p = &ents[(size_t)k * 12];
      TiffEntry e;
      e.type = (uint16_t)u16(p + 2);
      e.count = u32(p + 4);
      std::memcpy(e.field, p + 8, 4);
      e.present = true;
      switch (u16(p)) {
        case 256: w = value(e, 0); has_w = true; break;
        case 257: h = value(e, 0); has_h = true; break;
        case 258: bits = e; break;
        case 259: compression = value(e, 0); break;
        case 262: photometric = value(e, 0); break;
        case 266: fill = value(e, 0); break;
        case 273: offsets = e; break;
        case 277: spp = value(e, 0); break;
        case 278: rows_per_strip = value(e, 0); break;
        case 279: counts = e; break;
        case 284: planar = value(e, 0); break;
        case 317: predictor = value(e, 0); break;
        case 339: format = e; break;
        case 322: case 323: case 324: case 325: tiled = true; break;
      }
    }
    if (!has_w || !has_h) fail(kErrDecode);
  }
};

// TIFF LZW, codes most significant bit first, the width growing one code
// early (at 511, 1023, 2047); fills exactly `need` bytes.
void lzw_decode(const uint8_t* in, size_t n, uint8_t* out, size_t need) {
  if (n >= 2 && in[0] == 0 && (in[1] & 1))
    fail(kErrFormat);  // the old, LSB-first LZW of early writers
  constexpr uint32_t kClear = 256, kEoi = 257, kMax = 4096;
  uint16_t prefix[kMax];
  uint8_t suffix[kMax], first[kMax];
  uint16_t length[kMax];
  for (uint32_t i = 0; i < 256; ++i) {
    prefix[i] = 0;
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  size_t pos = 0, o = 0;
  uint64_t acc = 0;
  int have = 0, width = 9;
  uint32_t next = 258, old = kMax;
  std::vector<uint8_t> tail;
  auto code = [&]() -> uint32_t {
    while (have < width) {
      if (pos == n) return kEoi;  // a strip without EOI ends here
      acc = acc << 8 | in[pos++];
      have += 8;
    }
    have -= width;
    return (uint32_t)(acc >> have) & ((1u << width) - 1);
  };
  auto emit = [&](uint32_t c) {  // write string c, cut at `need`
    const size_t len = length[c];
    if (o + len <= need) {
      for (size_t k = len; k-- > 0; c = prefix[c]) out[o + k] = suffix[c];
      o += len;
      return;
    }
    tail.resize(len);
    for (size_t k = len; k-- > 0; c = prefix[c]) tail[k] = suffix[c];
    std::memcpy(out + o, tail.data(), need - o);
    o = need;
  };
  while (o < need) {
    uint32_t c = code();
    if (c == kEoi) break;
    if (c == kClear) {
      width = 9;
      next = 258;
      c = code();
      if (c == kEoi) break;
      if (c > 255) fail(kErrDecode);
      out[o++] = (uint8_t)c;
      old = c;
      continue;
    }
    if (old == kMax) {  // data before the first ClearCode
      if (c > 255) fail(kErrDecode);
      out[o++] = (uint8_t)c;
      old = c;
      continue;
    }
    if (c > next || (c == next && next >= kMax)) fail(kErrDecode);
    if (next < kMax) {
      prefix[next] = (uint16_t)old;
      suffix[next] = first[c == next ? old : c];
      first[next] = first[old];
      length[next] = (uint16_t)(length[old] + 1);
      ++next;
      if (next >= (1u << width) - 1 && width < 12) ++width;
    }
    emit(c);
    old = c;
  }
  if (o < need) fail(kErrDecode);
}

void packbits_decode(const uint8_t* in, size_t n, uint8_t* out, size_t need) {
  size_t i = 0, o = 0;
  while (o < need && i < n) {
    const int c = (int8_t)in[i++];
    if (c >= 0) {
      const size_t run = (size_t)c + 1;
      if (run > n - i) fail(kErrDecode);
      const size_t k = std::min(run, need - o);
      std::memcpy(out + o, in + i, k);
      i += run;
      o += k;
    } else if (c != -128) {
      if (i == n) fail(kErrDecode);
      const size_t k = std::min<size_t>(1 - c, need - o);
      std::memset(out + o, in[i++], k);
      o += k;
    }
  }
  if (o < need) fail(kErrDecode);
}

template <typename T>
void decode_tiff(const std::vector<uint8_t>& buf, T* out, int64_t want_h,
                 int64_t want_w) {
  const Source src{nullptr, &buf};
  const Tiff t(src);
  if ((int64_t)t.h != want_h || (int64_t)t.w != want_w) fail(kErrSize);

  // the subset; anything else goes to PIL
  if (t.tiled || t.planar != 1 || t.fill != 1 || !t.bits.present)
    fail(kErrFormat);
  const uint32_t bits = t.value(t.bits, 0);
  for (uint32_t i = 1; i < t.bits.count; ++i)
    if (t.value(t.bits, i) != bits) fail(kErrFormat);
  if (bits != 8 && bits != 16) fail(kErrFormat);
  if (t.format.present)
    for (uint32_t i = 0; i < t.format.count; ++i)
      if (t.value(t.format, i) != 1) fail(kErrFormat);
  const uint32_t spp = t.spp;
  if (!((t.photometric == 1 && spp == 1) ||
        (t.photometric == 2 && (spp == 3 || spp == 4))))
    fail(kErrFormat);
  const uint32_t comp = t.compression;
  if (comp != 1 && comp != 5 && comp != 8 && comp != 32946 && comp != 32773)
    fail(kErrFormat);
  const bool predicted = comp == 5 || comp == 8 || comp == 32946;
  if (predicted && t.predictor != 1 && t.predictor != 2) fail(kErrFormat);
  const bool diff = predicted && t.predictor == 2;
  if (!t.offsets.present) fail(kErrDecode);
  if (!t.counts.present) fail(kErrFormat);

  const size_t w = t.w, h = t.h;
  const size_t rps = std::min<size_t>(t.rows_per_strip, h);
  if (rps == 0) fail(kErrDecode);
  const size_t nstrips = (h + rps - 1) / rps;
  if (t.offsets.count < nstrips || t.counts.count < nstrips) fail(kErrDecode);
  const size_t row_samples = w * spp;
  const size_t row_bytes = row_samples * (bits / 8);

  std::vector<uint8_t> strip;
  std::vector<uint16_t> row16(bits == 16 ? row_samples : 0);
  for (size_t s = 0; s < nstrips; ++s) {
    const size_t rows = std::min(rps, h - s * rps);
    const size_t need = rows * row_bytes;
    const size_t off = t.value(t.offsets, (uint32_t)s);
    const size_t cnt = t.value(t.counts, (uint32_t)s);
    if (off > buf.size() || cnt > buf.size() - off) fail(kErrDecode);
    const uint8_t* in = buf.data() + off;
    uint8_t* data;
    if (comp == 1) {
      if (cnt < need) fail(kErrDecode);
      data = const_cast<uint8_t*>(in);  // read only: no predictor here
    } else {
      strip.resize(need);
      data = strip.data();
      if (comp == 5) {
        lzw_decode(in, cnt, data, need);
      } else if (comp == 32773) {
        packbits_decode(in, cnt, data, need);
      } else {
        Inflater inf({{in, cnt}});
        inf.read(data, need);
      }
    }
    for (size_t r = 0; r < rows; ++r) {
      uint8_t* row = data + r * row_bytes;
      T* dst = out + (s * rps + r) * w * 3;
      if (bits == 8) {
        if (diff)
          for (size_t i = spp; i < row_samples; ++i) row[i] += row[i - spp];
        for (size_t x = 0; x < w; ++x, dst += 3) {
          const uint8_t* p = row + x * spp;
          if (spp == 1) {
            dst[0] = dst[1] = dst[2] = from8<T>(p[0]);
          } else {
            dst[0] = from8<T>(p[0]);
            dst[1] = from8<T>(p[1]);
            dst[2] = from8<T>(p[2]);
          }
        }
      } else {
        for (size_t i = 0; i < row_samples; ++i)
          row16[i] = (uint16_t)t.u16(row + 2 * i);
        if (diff)  // at 16 bits, on the samples in the file's byte order
          for (size_t i = spp; i < row_samples; ++i)
            row16[i] = (uint16_t)(row16[i] + row16[i - spp]);
        for (size_t x = 0; x < w; ++x, dst += 3) {
          const uint16_t* p = row16.data() + x * spp;
          if (spp == 1) {
            dst[0] = dst[1] = dst[2] = from16<T>(p[0]);
          } else {
            dst[0] = from16<T>(p[0]);
            dst[1] = from16<T>(p[1]);
            dst[2] = from16<T>(p[2]);
          }
        }
      }
    }
  }
}

// ---- per file ---------------------------------------------------------

template <typename T>
int decode_file(const char* path, T* out, int64_t h, int64_t w) {
  try {
    File f(path);
    if (!f.f) return kErrOpen;
    uint8_t head[8];
    const size_t got = std::fread(head, 1, sizeof(head), f.f);
    const Kind kind = sniff(head, got);
    if (kind == Kind::kOther) return kErrFormat;
    if (fseeko(f.f, 0, SEEK_END) != 0) return kErrDecode;
    const off_t size = ftello(f.f);
    if (size < 0 || fseeko(f.f, 0, SEEK_SET) != 0) return kErrDecode;
    std::vector<uint8_t> buf((size_t)size);
    if (std::fread(buf.data(), 1, buf.size(), f.f) != buf.size())
      return kErrDecode;
    if (kind == Kind::kPng)
      decode_png<T>(buf, out, h, w);
    else
      decode_tiff<T>(buf, out, h, w);
    return kOk;
  } catch (const Status& s) {
    return s.code;
  } catch (...) {  // std::bad_alloc and the like: this file fails alone
    return kErrDecode;
  }
}

template <typename T>
int decode_batch(const char** paths, int64_t n, T* out, int64_t h, int64_t w,
                 int threads, int* statuses) {
  if (n <= 0) return 0;
  if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
  if (threads <= 0) threads = 1;
  if (threads > n) threads = (int)n;
  std::atomic<int64_t> next(0);
  std::atomic<int> failures(0);
  const int64_t frame = h * w * 3;
  auto worker = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n) break;
      const int rc = decode_file<T>(paths[i], out + i * frame, h, w);
      statuses[i] = rc;
      if (rc != kOk) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  try {
    for (int t = 1; t < threads; ++t) pool.emplace_back(worker);
  } catch (...) {  // fewer threads than asked: the ones started share it
  }
  worker();
  for (auto& th : pool) th.join();
  return failures.load();
}

// ---- PNG writer -------------------------------------------------------

void put_u32(std::vector<uint8_t>& v, uint32_t x) {
  const uint8_t b[4] = {(uint8_t)(x >> 24), (uint8_t)(x >> 16),
                        (uint8_t)(x >> 8), (uint8_t)x};
  v.insert(v.end(), b, b + 4);
}

void put_chunk(FILE* f, const char* type, const uint8_t* data, size_t len) {
  std::vector<uint8_t> head;
  put_u32(head, (uint32_t)len);
  head.insert(head.end(), type, type + 4);
  uLong crc = crc32(0L, head.data() + 4, 4);
  if (len) crc = crc32(crc, data, (uInt)len);
  std::vector<uint8_t> tail;
  put_u32(tail, (uint32_t)crc);
  if (std::fwrite(head.data(), 1, 8, f) != 8 ||
      (len && std::fwrite(data, 1, len, f) != len) ||
      std::fwrite(tail.data(), 1, 4, f) != 4)
    fail(kErrDecode);
}

class Deflater {
 public:
  explicit Deflater(FILE* f) : f_(f), buf_(1 << 20) {
    if (deflateInit(&z_, Z_DEFAULT_COMPRESSION) != Z_OK) fail(kErrDecode);
    z_.next_out = buf_.data();
    z_.avail_out = (uInt)buf_.size();
  }
  ~Deflater() { deflateEnd(&z_); }
  Deflater(const Deflater&) = delete;
  Deflater& operator=(const Deflater&) = delete;

  // compress n bytes; Z_FINISH ends the stream and writes what is left
  void write(const uint8_t* src, size_t n, int flush) {
    z_.next_in = const_cast<Bytef*>(src);
    z_.avail_in = (uInt)n;
    for (;;) {
      const int rc = ::deflate(&z_, flush);
      if (rc == Z_STREAM_ERROR) fail(kErrDecode);
      if (z_.avail_out == 0) {
        emit(buf_.size());
        continue;
      }
      if (flush == Z_FINISH ? rc == Z_STREAM_END : z_.avail_in == 0) break;
    }
    if (flush == Z_FINISH) emit(buf_.size() - z_.avail_out);
  }

 private:
  void emit(size_t len) {  // one IDAT chunk
    if (len) put_chunk(f_, "IDAT", buf_.data(), len);
    z_.next_out = buf_.data();
    z_.avail_out = (uInt)buf_.size();
  }

  FILE* f_;
  z_stream z_{};
  std::vector<uint8_t> buf_;
};

}  // namespace

extern "C" {

// Probe image dimensions from the PNG's IHDR or the TIFF's first IFD.
// Returns 0 on success, kErrFormat for a format not taken.
int stacker_probe(const char* path, int64_t* h, int64_t* w) {
  try {
    File f(path);
    if (!f.f) return kErrOpen;
    uint8_t head[29];
    const size_t got = std::fread(head, 1, sizeof(head), f.f);
    switch (sniff(head, got)) {
      case Kind::kPng: {
        if (got < sizeof(head)) return kErrDecode;
        const PngHeader hd = png_header(head);
        *h = hd.h;
        *w = hd.w;
        return kOk;
      }
      case Kind::kTiff: {
        const Source src{f.f, nullptr};
        const Tiff t(src);
        *h = t.h;
        *w = t.w;
        return kOk;
      }
      default:
        return kErrFormat;
    }
  } catch (const Status& s) {
    return s.code;
  } catch (...) {
    return kErrDecode;
  }
}

// Decode n files into out[n, h, w, 3] (uint8 RGB, C-contiguous) on a
// thread pool (threads <= 0: one per hardware thread).  statuses[n]
// receives a per-file status code (0 = ok).  Returns the number of failed
// files.
int stacker_decode_batch(const char** paths, int64_t n, uint8_t* out,
                         int64_t h, int64_t w, int threads, int* statuses) {
  return decode_batch<uint8_t>(paths, n, out, h, w, threads, statuses);
}

// Full-depth batch decode into out[n, h, w, 3] native-endian uint16 RGB:
// 16-bit samples at depth, 8-bit ones x257.  Same pool and statuses as
// stacker_decode_batch.
int stacker_decode_batch16(const char** paths, int64_t n, uint16_t* out,
                           int64_t h, int64_t w, int threads, int* statuses) {
  return decode_batch<uint16_t>(paths, n, out, h, w, threads, statuses);
}

// Write a 16-bit RGB PNG (filter Up on every row, zlib's default level)
// from a C-contiguous native-endian uint16 [h, w, 3] buffer.  Returns 0
// on success.
int stacker_write_png16(const char* path, const uint16_t* rgb, int64_t h,
                        int64_t w) {
  if (h <= 0 || w <= 0 || h > 0x7fffffff || w > 0x7fffffff / 6)
    return kErrDecode;
  try {
    File f(path, "wb");
    if (!f.f) return kErrOpen;
    static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a,
                                    '\n'};
    if (std::fwrite(kSig, 1, 8, f.f) != 8) return kErrDecode;
    std::vector<uint8_t> ihdr;
    put_u32(ihdr, (uint32_t)w);
    put_u32(ihdr, (uint32_t)h);
    const uint8_t rest[5] = {16, 2, 0, 0, 0};  // depth, RGB, deflate, 0, none
    ihdr.insert(ihdr.end(), rest, rest + 5);
    put_chunk(f.f, "IHDR", ihdr.data(), ihdr.size());

    const size_t rb = (size_t)w * 6;
    std::vector<uint8_t> raw(rb), prev(rb, 0), line(rb + 1);
    line[0] = 2;  // Up
    Deflater z(f.f);
    for (int64_t y = 0; y < h; ++y) {
      const uint16_t* src = rgb + (size_t)y * (size_t)w * 3;
      for (size_t i = 0; i < (size_t)w * 3; ++i) {
        raw[2 * i] = (uint8_t)(src[i] >> 8);  // PNG samples are big-endian
        raw[2 * i + 1] = (uint8_t)src[i];
      }
      for (size_t i = 0; i < rb; ++i) line[i + 1] = (uint8_t)(raw[i] - prev[i]);
      z.write(line.data(), line.size(), y + 1 == h ? Z_FINISH : Z_NO_FLUSH);
      std::swap(raw, prev);
    }
    put_chunk(f.f, "IEND", nullptr, 0);
    if (std::fflush(f.f) != 0) return kErrDecode;
    return kOk;
  } catch (const Status& s) {
    return s.code;
  } catch (...) {
    return kErrDecode;
  }
}

// Fixed-point Rec.601 grayscale of a batch (same arithmetic as the device
// path: (9798 R + 19235 G + 3735 B + 2^14) >> 15).
void stacker_rgb_to_gray(const uint8_t* rgb, uint8_t* gray, int64_t npx,
                         int threads) {
  if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
  if (threads <= 0) threads = 1;
  const int64_t chunk = (npx + threads - 1) / threads;
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* p = rgb + i * 3;
      gray[i] = (uint8_t)((9798 * p[0] + 19235 * p[1] + 3735 * p[2] +
                           (1 << 14)) >> 15);
    }
  };
  std::vector<std::thread> pool;
  int64_t done = 0;  // rows of the threads that started
  try {
    for (int t = 0; t < threads; ++t) {
      const int64_t lo = t * chunk, hi = std::min(npx, lo + chunk);
      if (lo >= hi) break;
      pool.emplace_back(worker, lo, hi);
      done = hi;
    }
  } catch (...) {  // could not start another thread: this one does the rest
  }
  worker(done, npx);
  for (auto& th : pool) th.join();
}

}  // extern "C"
