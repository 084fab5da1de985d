// tiff.cpp: the port's host TIFF reader (imextract's plane decode).
//
// Counterpart: the tifflite reader of the JAX package's native library
// (native/tmnative.cpp), kept here as the port's own copy: classic
// little/big-endian TIFF, strip-organized, grayscale 8/16-bit,
// uncompressed / LZW (with the horizontal predictor) / PackBits,
// multi-page.  Anything else returns an error code, and the Python
// caller (tmlibrary_tpu_torch/readers.py) goes on to the Python reader
// for BigTIFF and deflate strips, then to the decode of every page cv2
// reads (readers.decode_tiff_page), whose colour pages end in
// tm_bgr2gray_int or tm_bgr2gray_f32 here.  Built with the
// host compiler at first use, bound with ctypes
// (tmlibrary_tpu_torch/native.py).  C ABI only.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace tifflite {

struct Buf {
  std::vector<uint8_t> d;
  bool le = true;
  uint16_t rd16(size_t o) const {
    if (o + 2 > d.size()) return 0;
    return le ? (uint16_t)(d[o] | (d[o + 1] << 8))
              : (uint16_t)((d[o] << 8) | d[o + 1]);
  }
  uint32_t rd32(size_t o) const {
    if (o + 4 > d.size()) return 0;
    return le ? ((uint32_t)d[o] | ((uint32_t)d[o + 1] << 8) |
                 ((uint32_t)d[o + 2] << 16) | ((uint32_t)d[o + 3] << 24))
              : (((uint32_t)d[o] << 24) | ((uint32_t)d[o + 1] << 16) |
                 ((uint32_t)d[o + 2] << 8) | (uint32_t)d[o + 3]);
  }
};

static bool load_file(const char* path, Buf& b) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  // reject non-TIFF from the 4-byte header BEFORE slurping the file, so a
  // PNG handed to the reader costs 4 bytes of IO, not a full read
  uint8_t hdr[4];
  if (std::fread(hdr, 1, 4, f) != 4) { std::fclose(f); return false; }
  if (hdr[0] == 'I' && hdr[1] == 'I') b.le = true;
  else if (hdr[0] == 'M' && hdr[1] == 'M') b.le = false;
  else { std::fclose(f); return false; }
  uint16_t magic = b.le ? (uint16_t)(hdr[2] | (hdr[3] << 8))
                        : (uint16_t)((hdr[2] << 8) | hdr[3]);
  if (magic != 42) { std::fclose(f); return false; }  // classic TIFF only
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  if (sz <= 8) { std::fclose(f); return false; }
  std::fseek(f, 0, SEEK_SET);
  b.d.resize((size_t)sz);
  size_t got = std::fread(b.d.data(), 1, (size_t)sz, f);
  std::fclose(f);
  return got == (size_t)sz;
}

// cap on IFD-chain walks: bounds page counts AND terminates on cyclic
// next-IFD pointers in corrupt/malicious files
constexpr int32_t kMaxPages = 65535;

struct Entry { uint16_t type; uint32_t count; size_t value_off; };

// value_off points at the 4-byte value field itself; values larger than
// 4 bytes live at the offset stored there.
static size_t entry_data(const Buf& b, const Entry& e, size_t elem_size) {
  size_t total = (size_t)e.count * elem_size;
  return total <= 4 ? e.value_off : (size_t)b.rd32(e.value_off);
}

static uint32_t entry_int(const Buf& b, const Entry& e, uint32_t idx) {
  size_t elem = e.type == 3 ? 2 : 4;  // SHORT or LONG
  size_t base = entry_data(b, e, elem);
  return elem == 2 ? b.rd16(base + 2 * idx) : b.rd32(base + 4 * idx);
}

struct IFD {
  uint32_t width = 0, height = 0, bits = 0, compression = 1;
  uint32_t samples = 1, rows_per_strip = 0xFFFFFFFFu, predictor = 1;
  std::vector<size_t> strip_offsets, strip_counts;
};

static bool parse_ifd(const Buf& b, size_t off, IFD& out, size_t* next) {
  if (off == 0 || off + 2 > b.d.size()) return false;
  uint16_t n = b.rd16(off);
  size_t p = off + 2;
  if (p + 12 * (size_t)n + 4 > b.d.size()) return false;
  Entry so{0, 0, 0}, sc{0, 0, 0};
  for (uint16_t i = 0; i < n; ++i, p += 12) {
    uint16_t tag = b.rd16(p);
    Entry e{b.rd16(p + 2), b.rd32(p + 4), p + 8};
    switch (tag) {
      case 256: out.width = entry_int(b, e, 0); break;
      case 257: out.height = entry_int(b, e, 0); break;
      case 258: out.bits = entry_int(b, e, 0); break;
      case 259: out.compression = entry_int(b, e, 0); break;
      case 273: so = e; break;
      case 277: out.samples = entry_int(b, e, 0); break;
      case 278: out.rows_per_strip = entry_int(b, e, 0); break;
      case 279: sc = e; break;
      case 317: out.predictor = entry_int(b, e, 0); break;
      default: break;
    }
  }
  *next = b.rd32(p);
  if (so.count == 0 || sc.count == 0 || so.count != sc.count) return false;
  for (uint32_t i = 0; i < so.count; ++i) {
    out.strip_offsets.push_back(entry_int(b, so, i));
    out.strip_counts.push_back(entry_int(b, sc, i));
  }
  return out.width > 0 && out.height > 0;
}

static bool lzw_decode(const uint8_t* src, size_t n, std::vector<uint8_t>& out,
                       size_t expect) {
  // TIFF LZW: MSB-first codes, 256=Clear, 257=EOI, early code-width
  // change.  Output-reference table: every code's expansion is a
  // substring of the ALREADY-DECODED output (entry next_free is the
  // previous emission plus the first byte of the current one — two
  // consecutive appends, so its bytes are contiguous in `out`), so each
  // entry stores (output offset, length) and emitting a string is ONE
  // memcpy from earlier output instead of a per-byte chain walk +
  // reverse (the chain-table form this replaces ran ~160 MB/s; the copy
  // form removes the O(length) pointer chase per code).
  uint32_t tpos[4096];
  uint32_t tlen[4096];
  int next_free = 258;
  // ONE up-front allocation sized expect + the largest possible single
  // emission (4095) + 8 bytes of chunked-copy overrun margin: the hot
  // loop then writes through a raw pointer with no growth checks, and
  // the 8-byte block copies below may read/write up to 7 bytes past a
  // string's end, always inside this buffer
  out.assign(expect + 4104, 0);
  uint8_t* o = out.data();
  size_t olen = 0;
  size_t pos = 0;
  uint64_t acc = 0;
  int nbits = 0;
  int width = 9;
  int prev = -1;
  uint32_t prev_pos = 0, prev_len = 0;
  while (olen < expect) {
    if (nbits < width) {  // bulk refill: ~once per several codes
      while (nbits <= 56 && pos < n) {
        acc = (acc << 8) | src[pos++];
        nbits += 8;
      }
      if (nbits < width) break;  // truncated stream
    }
    nbits -= width;
    int code = (int)((acc >> nbits) & ((1u << width) - 1));
    if (code == 257) break;  // EOI
    if (code == 256) {       // Clear
      next_free = 258;
      width = 9;
      prev = -1;
      continue;
    }
    const uint32_t at = (uint32_t)olen;
    uint32_t len;
    if (prev < 0) {
      // first code after Clear must be a literal
      if (code > 255) { out.resize(olen); return false; }
      o[olen++] = (uint8_t)code;
      prev = code;
      prev_pos = at;
      prev_len = 1;
      continue;
    }
    if (code < 256) {
      o[olen++] = (uint8_t)code;
      len = 1;
    } else if (code < next_free) {
      len = tlen[code];
      const uint8_t* s = o + tpos[code];
      uint8_t* d = o + at;
      if (at - tpos[code] >= 8) {
        // 8-byte chunks; the ≤7-byte tail overrun lands in dest bytes
        // the next emission (or the final resize) overwrites/discards
        for (uint32_t i = 0; i < len; i += 8) std::memcpy(d + i, s + i, 8);
      } else {  // source too close to dest for chunking (e.g. "ababab")
        for (uint32_t i = 0; i < len; ++i) d[i] = s[i];
      }
      olen += len;
    } else if (code == next_free) {
      // KwKwK: previous string + its own first byte
      len = prev_len + 1;
      const uint8_t* s = o + prev_pos;
      uint8_t* d = o + at;
      if (at - prev_pos >= 8) {
        for (uint32_t i = 0; i < prev_len; i += 8)
          std::memcpy(d + i, s + i, 8);
      } else {
        for (uint32_t i = 0; i < prev_len; ++i) d[i] = s[i];
      }
      d[prev_len] = s[0];
      olen += len;
    } else {
      out.resize(olen);
      return false;  // corrupt stream
    }
    if (next_free < 4096) {
      // previous emission [prev_pos, prev_pos+prev_len) is immediately
      // followed by this one, so the new entry's bytes are contiguous
      tpos[next_free] = prev_pos;
      tlen[next_free] = prev_len + 1;
      ++next_free;
    }
    // early change: width grows when the NEXT code would not fit
    if (next_free + 1 >= (1 << width) && width < 12) ++width;
    prev = code;
    prev_pos = at;
    prev_len = len;
  }
  out.resize(olen);
  return olen >= expect;
}

static bool packbits_decode(const uint8_t* src, size_t n,
                            std::vector<uint8_t>& out, size_t expect) {
  out.clear();
  out.reserve(expect);
  size_t i = 0;
  while (i < n && out.size() < expect) {
    int8_t c = (int8_t)src[i++];
    if (c >= 0) {
      size_t cnt = (size_t)c + 1;
      if (i + cnt > n) return false;
      out.insert(out.end(), src + i, src + i + cnt);
      i += cnt;
    } else if (c != -128) {
      if (i >= n) return false;
      out.insert(out.end(), (size_t)(1 - c), src[i++]);
    }
  }
  return out.size() >= expect;
}

// Walk to page `page`; -1 errors, else fills ifd.
static int walk(const Buf& b, int32_t page, IFD& ifd) {
  if (page >= kMaxPages) return -1;
  size_t off = b.rd32(4);
  for (int32_t i = 0; i < kMaxPages; ++i) {
    IFD cur;
    size_t next = 0;
    if (!parse_ifd(b, off, cur, &next)) return -1;
    if (i == page) { ifd = cur; return 0; }
    if (next == 0) return -1;
    off = next;
  }
  return -1;
}

}  // namespace tifflite

// cv2's BGR2GRAY of 8- or 16-bit samples: its 15-bit fixed-point weights
// (B 3735, G 19235, R 9798, summing to 1 << 15), rounded half up; the sum
// fits 32 bits.
template <typename T>
static void bgr2gray_int(const T* s, int64_t n, int32_t scn, T* o) {
  for (int64_t i = 0; i < n; ++i, s += scn)
    o[i] = (T)((s[0] * 3735u + s[1] * 19235u + s[2] * 9798u + (1u << 14)) >> 15);
}

extern "C" {

// Raw TIFF-variant LZW strip decode (MSB-first codes, early width change)
// into a caller-sized buffer.  Exported for the Python TIFF reader's LZW
// strips (BigTIFF pages) — the pure-Python bit-unpacking twin
// is ~100x slower on megabyte strips.  Returns 1 on success, 0 on corrupt
// input or short output.
int32_t tm_lzw_decode(const uint8_t* src, int64_t n, uint8_t* out,
                      int64_t expect) {
  if (!src || !out || n < 0 || expect < 0) return 0;
  std::vector<uint8_t> buf;
  if (!tifflite::lzw_decode(src, (size_t)n, buf, (size_t)expect)) return 0;
  std::memcpy(out, buf.data(), (size_t)expect);
  return 1;
}

// PackBits strip decode, same contract as tm_lzw_decode.
int32_t tm_packbits_decode(const uint8_t* src, int64_t n, uint8_t* out,
                           int64_t expect) {
  if (!src || !out || n < 0 || expect < 0) return 0;
  std::vector<uint8_t> buf;
  if (!tifflite::packbits_decode(src, (size_t)n, buf, (size_t)expect)) return 0;
  std::memcpy(out, buf.data(), (size_t)expect);
  return 1;
}

// out4: [n_pages, height, width, bits] of page 0.  Returns 0, or -1 when
// the file is not a TIFF this reader handles.
int32_t tm_tiff_info(const char* path, int32_t* out4) {
  if (!path || !out4) return -1;
  tifflite::Buf b;
  if (!tifflite::load_file(path, b)) return -1;
  tifflite::IFD first;
  size_t off = b.rd32(4), next = 0;
  if (!tifflite::parse_ifd(b, off, first, &next)) return -1;
  int32_t pages = 1;
  while (next != 0 && pages < tifflite::kMaxPages) {
    tifflite::IFD cur;
    size_t nn = 0;
    if (!tifflite::parse_ifd(b, next, cur, &nn)) break;
    ++pages;
    next = nn;
  }
  out4[0] = pages;
  out4[1] = (int32_t)first.height;
  out4[2] = (int32_t)first.width;
  out4[3] = (int32_t)first.bits;
  return 0;
}

// Decode grayscale page `page` into out (row-major uint16, h*w elements,
// 8-bit samples are widened).  Returns 0 on success; -1 on any
// parse/shape/unsupported-feature condition (the caller goes on to the
// Python reader).
static int32_t tiff_decode_gray(const tifflite::Buf& b,
                                const tifflite::IFD& ifd, uint16_t* out,
                                int32_t h, int32_t w) {
  if (ifd.samples != 1) return -1;                    // grayscale only
  if (ifd.bits != 8 && ifd.bits != 16) return -1;
  if (ifd.predictor != 1 && ifd.predictor != 2) return -1;

  const size_t bytes_per_row = (size_t)w * (ifd.bits / 8);
  std::vector<uint8_t> plane;
  plane.reserve(bytes_per_row * (size_t)h);
  uint32_t rps = ifd.rows_per_strip ? ifd.rows_per_strip : (uint32_t)h;
  std::vector<uint8_t> strip;
  for (size_t s = 0; s < ifd.strip_offsets.size(); ++s) {
    uint32_t rows = rps;
    uint32_t row0 = (uint32_t)s * rps;
    if (row0 >= (uint32_t)h) break;
    if (row0 + rows > (uint32_t)h) rows = (uint32_t)h - row0;
    size_t expect = bytes_per_row * rows;
    size_t off = ifd.strip_offsets[s], cnt = ifd.strip_counts[s];
    if (off + cnt > b.d.size()) return -1;
    const uint8_t* src = b.d.data() + off;
    if (ifd.compression == 1) {
      if (cnt < expect) return -1;
      plane.insert(plane.end(), src, src + expect);
    } else if (ifd.compression == 5) {
      if (!tifflite::lzw_decode(src, cnt, strip, expect)) return -1;
      plane.insert(plane.end(), strip.begin(), strip.begin() + expect);
    } else if (ifd.compression == 32773) {
      if (!tifflite::packbits_decode(src, cnt, strip, expect)) return -1;
      plane.insert(plane.end(), strip.begin(), strip.begin() + expect);
    } else {
      return -1;  // unsupported codec
    }
  }
  if (plane.size() < bytes_per_row * (size_t)h) return -1;

  // samples -> uint16 with file byte order, then the horizontal predictor
  for (int32_t y = 0; y < h; ++y) {
    const uint8_t* row = plane.data() + (size_t)y * bytes_per_row;
    uint16_t* dst = out + (size_t)y * (size_t)w;
    if (ifd.bits == 8) {
      for (int32_t x = 0; x < w; ++x) dst[x] = row[x];
    } else {
      for (int32_t x = 0; x < w; ++x) {
        dst[x] = b.le ? (uint16_t)(row[2 * x] | (row[2 * x + 1] << 8))
                      : (uint16_t)((row[2 * x] << 8) | row[2 * x + 1]);
      }
    }
    if (ifd.predictor == 2) {
      // horizontal differencing accumulates in the SAMPLE width: 8-bit
      // samples wrap at 256, 16-bit at 65536
      if (ifd.bits == 8) {
        for (int32_t x = 1; x < w; ++x)
          dst[x] = (uint16_t)((dst[x] + dst[x - 1]) & 0xFF);
      } else {
        for (int32_t x = 1; x < w; ++x)
          dst[x] = (uint16_t)(dst[x] + dst[x - 1]);
      }
    }
  }
  return 0;
}

int32_t tm_tiff_read(const char* path, int32_t page, uint16_t* out,
                     int32_t h, int32_t w) {
  if (!path || !out || h <= 0 || w <= 0 || page < 0) return -1;
  tifflite::Buf b;
  if (!tifflite::load_file(path, b)) return -1;
  tifflite::IFD ifd;
  if (tifflite::walk(b, page, ifd) != 0) return -1;
  if ((int32_t)ifd.height != h || (int32_t)ifd.width != w) return -1;
  return tiff_decode_gray(b, ifd, out, h, w);
}

// Combined parse + decode in ONE file load: fills hw_out[0..2] with the
// page's height/width/bits and decodes into `out` when h*w fits
// `capacity` pixels.  Returns 0 on success, -2 when the capacity is too small
// (hw_out is still filled so the caller retries sized exactly), -1 on
// anything the paged reader does not handle.  Exists because the
// info-then-read protocol loaded and walked the file TWICE per page
// (~0.1 ms of the ~1 ms ingest cost per 256-px file).
int32_t tm_tiff_read2(const char* path, int32_t page, uint16_t* out,
                      int64_t capacity, int32_t* hw_out) {
  if (!path || !out || !hw_out || page < 0 || capacity < 0) return -1;
  tifflite::Buf b;
  if (!tifflite::load_file(path, b)) return -1;
  tifflite::IFD ifd;
  if (tifflite::walk(b, page, ifd) != 0) return -1;
  hw_out[0] = (int32_t)ifd.height;
  hw_out[1] = (int32_t)ifd.width;
  hw_out[2] = (int32_t)ifd.bits;
  if (ifd.height <= 0 || ifd.width <= 0) return -1;
  if ((int64_t)ifd.height * (int64_t)ifd.width > capacity) return -2;
  return tiff_decode_gray(b, ifd, out, (int32_t)ifd.height,
                          (int32_t)ifd.width);
}

// cv2.cvtColor(COLOR_BGR2GRAY) of an 8- or 16-bit (`bytes` 1 or 2)
// BGR(A) image (bgr2gray_int above).
void tm_bgr2gray_int(const void* src, int64_t rows, int64_t cols, int32_t scn, int32_t bytes,
                     void* dst) {
  if (bytes == 1)
    bgr2gray_int((const uint8_t*)src, rows * cols, scn, (uint8_t*)dst);
  else
    bgr2gray_int((const uint16_t*)src, rows * cols, scn, (uint16_t*)dst);
}

// cv2.cvtColor(COLOR_BGR2GRAY) of a float32 BGR(A) image as this
// OpenCV build computes it (its IPP kernel): every pixel as fma(R, 0.299f,
// fma(B, 0.114f, G * 0.587f)), except that from 3-channel rows, in the
// block of 4 pixels that follows a row's blocks of 16 and 8, the even
// pixels take fma(R, 0.299f, fma(G, 0.587f, B * 0.114f)).  Explicit
// fmaf: no compiler contraction decides the roundings.
void tm_bgr2gray_f32(const float* src, int64_t rows, int64_t cols, int32_t scn, float* dst) {
  const float cb = 0.114f, cg = 0.587f, cr = 0.299f;
  for (int64_t y = 0; y < rows; ++y) {
    const float* s = src + (size_t)y * cols * scn;
    float* o = dst + (size_t)y * cols;
    int64_t four = scn == 3 && (cols % 16) % 8 >= 4 ? cols - cols % 16 % 8 : -1;
    for (int64_t x = 0; x < cols; ++x) {
      const float b = s[x * scn], g = s[x * scn + 1], r = s[x * scn + 2];
      bool even_of_four = four >= 0 && x >= four && x < four + 4 && ((x - four) & 1) == 0;
      o[x] = even_of_four ? std::fmaf(r, cr, std::fmaf(g, cg, b * cb))
                          : std::fmaf(r, cr, std::fmaf(b, cb, g * cg));
    }
  }
}

}  // extern "C"
