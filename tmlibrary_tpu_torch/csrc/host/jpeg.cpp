// jpeg.cpp: the port's baseline-JPEG codec for grey images (CZI
// compression 1 subblocks and grey .jpg site files).
//
// Decoder: 8-bit, one component, SOF0/SOF1, Huffman tables (the Annex K
// tables where a stream defines none, as libjpeg does), 8- and 16-bit
// quantisation tables, DRI with restart markers, and any APPn/COM/fill
// bytes.  It reproduces libjpeg's integer inverse DCT (jidctint.c:
// CONST_BITS 13, PASS1_BITS 2) as libjpeg-turbo's x86-64 SIMD runs it
// (16-bit lanes, saturating), which is jidctint.c's arithmetic on every
// block whose values stay in range, and
// libjpeg's handling of damaged entropy data -- zero bits past a marker
// that ends a segment, a code of 17 bits or more read as symbol 0, the
// rest of a segment left grey once data ran out, restart-marker resync --
// so a stream decodes to the pixels libjpeg gives.  Progressive,
// arithmetic-coded, lossless, hierarchical, 12-bit and multi-component
// streams are refused naming the feature; a stream that ends before its
// entropy data does fails, as it does through an in-memory libjpeg source.
//
// Encoder: grey baseline JPEG with the integer forward DCT (jfdctint.c)
// and the Annex K luminance tables scaled by libjpeg's quality formula;
// integer arithmetic only, so its bytes are the same on every machine.
//
// Built into the port's host library (tmlibrary_tpu_torch/native.py),
// bound with ctypes.  C ABI only; errors come back as a negative return
// and a message (tm_jpeg_error).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace tmjpeg {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] static void fail(const std::string& what) { throw Error(what); }

static thread_local std::string g_error;

// natural order of zigzag index k, with libjpeg's 16 guard entries
static const int NATURAL[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// Annex K.3 luminance tables: BITS[1..16] then HUFFVAL
static const uint8_t STD_DC[16 + 12] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0,
                                        0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t STD_AC[16 + 162] = {
    0,    2,    1,    3,    3,    2,    4,    3,    5,    5,    4,    4,    0,    0,    1,    0x7d,
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5,
    0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8,
    0xf9, 0xfa};

// Annex K.1 luminance quantisation table, natural order
static const int STD_Q[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                              14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                              18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                              49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

// ---------------------------------------------------------- Huffman
struct HTable {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
};

struct DTable {  // jpeg_make_d_derived_tbl
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  int16_t look_nbits[256];
  uint8_t look_sym[256];
};

static void derive(const HTable& h, bool dc, DTable& d) {
  char huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int i = h.bits[l];
    if (p + i > 256) fail("corrupt JPEG: bogus Huffman table definition");
    while (i--) huffsize[p++] = (char)l;
  }
  huffsize[p] = 0;
  int numsymbols = p;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      code++;
    }
    if ((int64_t)code >= ((int64_t)1 << si)) fail("corrupt JPEG: bogus Huffman table definition");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (h.bits[l]) {
      d.valoffset[l] = p - (int32_t)huffcode[p];
      p += h.bits[l];
      d.maxcode[l] = (int32_t)huffcode[p - 1];
    } else {
      d.maxcode[l] = -1;
    }
  }
  d.valoffset[17] = 0;
  d.maxcode[17] = 0xFFFFF;
  std::memcpy(d.vals, h.vals, 256);
  for (int i = 0; i < 256; ++i) d.look_nbits[i] = 0;
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 1; i <= h.bits[l]; ++i, ++p) {
      int lookbits = (int)(huffcode[p] << (8 - l));
      for (int ctr = 1 << (8 - l); ctr > 0; --ctr) {
        d.look_nbits[lookbits] = (int16_t)l;
        d.look_sym[lookbits] = h.vals[p];
        lookbits++;
      }
    }
  }
  if (dc)
    for (int i = 0; i < numsymbols; ++i)
      if (h.vals[i] > 15) fail("corrupt JPEG: bogus Huffman table definition");
}

// --------------------------------------------------------- the source
struct Source {
  const uint8_t* p;
  size_t n, pos = 0;
  int byte() {
    if (pos >= n) fail("corrupt JPEG: premature end of data");
    return p[pos++];
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  void skip(long k) {
    if (k <= 0) return;
    if ((size_t)k > n - pos) fail("corrupt JPEG: premature end of data");
    pos += (size_t)k;
  }
  // next_marker(): skip garbage and FF00 pairs up to a marker
  int next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do c = byte();
      while (c == 0xFF);
      if (c != 0) return c;
    }
  }
};

struct Image {
  int precision = 0, height = 0, width = 0, ncomp = 0;
  int comp_id = 0, hs = 1, vs = 1, tq = 0;
  bool saw_sof = false;
  int restart = 0;
  bool qdef[4] = {false, false, false, false};
  uint16_t q[4][64];
  HTable dc[4], ac[4];
};

static const char* sof_feature(int m) {
  switch (m) {
    case 0xC2: return "progressive JPEG (SOF2)";
    case 0xC3: return "lossless JPEG (SOF3)";
    case 0xC5: return "hierarchical JPEG (SOF5)";
    case 0xC6: return "hierarchical progressive JPEG (SOF6)";
    case 0xC7: return "hierarchical lossless JPEG (SOF7)";
    case 0xC8: return "JPEG extension (JPG marker)";
    case 0xC9: return "arithmetic-coded JPEG (SOF9)";
    case 0xCA: return "arithmetic-coded progressive JPEG (SOF10)";
    case 0xCB: return "arithmetic-coded lossless JPEG (SOF11)";
    case 0xCD: return "arithmetic-coded hierarchical JPEG (SOF13)";
    case 0xCE: return "arithmetic-coded hierarchical progressive JPEG (SOF14)";
    case 0xCF: return "arithmetic-coded hierarchical lossless JPEG (SOF15)";
  }
  return nullptr;
}

static void get_dqt(Source& s, Image& im) {
  long length = s.u16() - 2;
  while (length > 0) {
    length--;
    int n = s.byte();
    int prec = n >> 4;
    n &= 0x0F;
    if (n >= 4) fail("corrupt JPEG: bogus DQT index " + std::to_string(n));
    for (int i = 0; i < 64; ++i) im.q[n][NATURAL[i]] = (uint16_t)(prec ? s.u16() : s.byte());
    im.qdef[n] = true;
    length -= 64;
    if (prec) length -= 64;
  }
  if (length != 0) fail("corrupt JPEG: bogus marker length");
}

static void get_dht(Source& s, Image& im) {
  long length = s.u16() - 2;
  while (length > 16) {
    int index = s.byte();
    uint8_t bits[17] = {0};
    int count = 0;
    for (int i = 1; i <= 16; ++i) {
      bits[i] = (uint8_t)s.byte();
      count += bits[i];
    }
    length -= 1 + 16;
    if (count > 256 || count > length) fail("corrupt JPEG: bogus Huffman table definition");
    uint8_t vals[256] = {0};
    for (int i = 0; i < count; ++i) vals[i] = (uint8_t)s.byte();
    length -= count;
    HTable* t;
    if (index & 0x10) {
      index -= 0x10;
      if (index < 0 || index >= 4) fail("corrupt JPEG: bogus DHT index " + std::to_string(index));
      t = &im.ac[index];
    } else {
      if (index < 0 || index >= 4) fail("corrupt JPEG: bogus DHT index " + std::to_string(index));
      t = &im.dc[index];
    }
    std::memcpy(t->bits, bits, 17);
    std::memcpy(t->vals, vals, 256);
    t->defined = true;
  }
  if (length != 0) fail("corrupt JPEG: bogus marker length");
}

static void get_sof(Source& s, Image& im, int marker) {
  long length = s.u16();
  im.precision = s.byte();
  im.height = s.u16();
  im.width = s.u16();
  im.ncomp = s.byte();
  length -= 8;
  if (im.saw_sof) fail("corrupt JPEG: duplicate SOF marker");
  if (im.height <= 0 || im.width <= 0 || im.ncomp <= 0)
    fail("corrupt JPEG: empty image (height, width or components 0)");
  if (length != im.ncomp * 3) fail("corrupt JPEG: bogus marker length");
  for (int c = 0; c < im.ncomp; ++c) {
    int id = s.byte(), hv = s.byte(), tq = s.byte();
    if (c == 0) {
      im.comp_id = id;
      im.hs = (hv >> 4) & 15;
      im.vs = hv & 15;
      im.tq = tq;
    }
  }
  im.saw_sof = true;
  if (const char* f = sof_feature(marker)) fail(std::string(f) + " is not supported");
  if (im.precision != 8) fail(std::to_string(im.precision) + "-bit JPEG is not supported");
  if (im.ncomp != 1)
    fail("multi-component JPEG (" + std::to_string(im.ncomp) + " components) is not supported");
  if (im.height > 65500 || im.width > 65500) fail("corrupt JPEG: image too big");
  if ((int64_t)im.height * im.width > ((int64_t)1 << 30)) fail("corrupt JPEG: image too big");
  if (im.hs <= 0 || im.hs > 4 || im.vs <= 0 || im.vs > 4) fail("corrupt JPEG: bogus sampling factors");
}

static void get_dac(Source& s) {
  long length = s.u16() - 2;
  while (length > 0) {
    int index = s.byte(), val = s.byte();
    length -= 2;
    if (index < 0 || index >= 32) fail("corrupt JPEG: bogus DAC index");
    if (index >= 16) {
      if (val < 1 || val > 63) fail("corrupt JPEG: bogus DAC value");
    } else if ((val & 0x0F) > (val >> 4)) {
      fail("corrupt JPEG: bogus DAC value");
    }
  }
  if (length != 0) fail("corrupt JPEG: bogus marker length");
}

// ------------------------------------------------------ inverse DCT
static const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                     F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                     F2562 = 20995, F3072 = 25172;

static inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

static inline int16_t wrap16(int64_t v) { return (int16_t)(uint16_t)(v & 0xFFFF); }
static inline int16_t sat16(int64_t v) { return (int16_t)(v > 32767 ? 32767 : v < -32768 ? -32768 : v); }

// One 1-D pass of jidctint's algorithm as libjpeg-turbo's x86-64 SIMD
// runs it (jidctint-avx2.asm): 16-bit lanes, so in0 +- in4, in3 + in7 and
// in1 + in5 wrap at 16 bits, products are exact 32-bit sums, and each
// output is descaled and saturated to 16 bits.  On every block whose
// values stay in range this is jidctint.c's arithmetic exactly.
static void idct_pass(const int16_t* in, int16_t* out, int shift) {
  int64_t tmp3 = (int64_t)in[2] * (F0541 + F0765) + (int64_t)in[6] * F0541;
  int64_t tmp2 = (int64_t)in[2] * F0541 + (int64_t)in[6] * (F0541 - F1847);
  int64_t tmp0 = (int64_t)wrap16((int32_t)in[0] + in[4]) * 8192;
  int64_t tmp1 = (int64_t)wrap16((int32_t)in[0] - in[4]) * 8192;
  int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
  int64_t z3 = wrap16((int32_t)in[7] + in[3]), z4 = wrap16((int32_t)in[5] + in[1]);
  int64_t z3p = z3 * (F1175 - F1961) + z4 * F1175;
  int64_t z4p = z3 * F1175 + z4 * (F1175 - F0390);
  int64_t o0 = (int64_t)in[7] * (F0298 - F0899) + (int64_t)in[1] * -F0899 + z3p;
  int64_t o3 = (int64_t)in[7] * -F0899 + (int64_t)in[1] * (F1501 - F0899) + z4p;
  int64_t o1 = (int64_t)in[5] * (F2053 - F2562) + (int64_t)in[3] * -F2562 + z4p;
  int64_t o2 = (int64_t)in[5] * -F2562 + (int64_t)in[3] * (F3072 - F2562) + z3p;
  out[0] = sat16(descale(t10 + o3, shift));
  out[7] = sat16(descale(t10 - o3, shift));
  out[1] = sat16(descale(t11 + o2, shift));
  out[6] = sat16(descale(t11 - o2, shift));
  out[2] = sat16(descale(t12 + o1, shift));
  out[5] = sat16(descale(t12 - o1, shift));
  out[3] = sat16(descale(t13 + o0, shift));
  out[4] = sat16(descale(t13 - o0, shift));
}

// The 8x8 inverse DCT: columns (CONST_BITS - PASS1_BITS), then rows
// (CONST_BITS + PASS1_BITS + 3), saturated to 8 bits and level-shifted;
// a block whose rows 1-7 are all zero takes the DC-only column path
// (the dequantized first row << PASS1_BITS, 16-bit).
static void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int16_t ws[64];
  bool ac_zero = true;
  for (int i = 8; i < 64 && ac_zero; ++i) ac_zero = coef[i] == 0;
  for (int c = 0; c < 8; ++c) {
    int16_t col[8], res[8];
    for (int r = 0; r < 8; ++r) col[r] = wrap16((int32_t)coef[8 * r + c] * (int16_t)q[8 * r + c]);
    if (ac_zero) {
      int16_t v = wrap16((int32_t)col[0] * 4);
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = v;
      continue;
    }
    idct_pass(col, res, 11);
    for (int r = 0; r < 8; ++r) ws[8 * r + c] = res[r];
  }
  for (int r = 0; r < 8; ++r) {
    int16_t res[8];
    idct_pass(ws + 8 * r, res, 18);
    uint8_t* o = out + (size_t)r * stride;
    for (int k = 0; k < 8; ++k) o[k] = (uint8_t)(std::max(-128, std::min(127, (int)res[k])) + 128);
  }
}

// ---------------------------------------------- the entropy decoder
// libjpeg's bit reader (jdhuff.c) over the source: bytes are loaded until
// 57 bits are buffered or a marker is met; past a marker, zero bits.
struct Entropy {
  Source& s;
  uint64_t buf = 0;
  int left = 0;
  int unread_marker = 0;
  bool insufficient = false;
  int last_dc = 0;
  explicit Entropy(Source& src) : s(src) {}

  void fill(int nbits) {
    if (unread_marker == 0) {
      while (left < 57) {
        int c = s.byte();
        if (c == 0xFF) {
          do c = s.byte();
          while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            unread_marker = c;
            goto no_more;
          }
        }
        buf = (buf << 8) | (uint64_t)c;
        left += 8;
      }
      return;
    }
  no_more:
    if (nbits > left) {
      insufficient = true;
      buf <<= 57 - left;
      left = 57;
    }
  }
  int get(int n) {
    if (left < n) fill(n);
    left -= n;
    return (int)((buf >> left) & ((1ULL << n) - 1));
  }
  int slow(const DTable& t, int l) {
    if (left < l) fill(l);
    left -= l;
    int32_t code = (int32_t)((buf >> left) & ((1ULL << l) - 1));
    while (code > t.maxcode[l]) {
      code <<= 1;
      if (left < 1) fill(1);
      left -= 1;
      code |= (int32_t)((buf >> left) & 1);
      l++;
    }
    if (l > 16) return 0;
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
  int decode(const DTable& t) {  // HUFF_DECODE
    if (left < 8) {
      fill(0);
      if (left < 8) return slow(t, 1);
    }
    int look = (int)((buf >> (left - 8)) & 0xFF);
    int nb = t.look_nbits[look];
    if (nb) {
      left -= nb;
      return t.look_sym[look];
    }
    return slow(t, 9);
  }
  static int extend(int r, int s) { return r < (1 << (s - 1)) ? r + (int)((~0u << s) + 1) : r; }

  void block(const DTable& dct, const DTable& act, int16_t* blk) {
    int s = decode(dct);
    if (s) {
      int r = get(s);
      s = extend(r, s);
    }
    last_dc = (int)((uint32_t)last_dc + (uint32_t)s);
    blk[0] = (int16_t)last_dc;
    for (int k = 1; k < 64; ++k) {
      s = decode(act);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        int v = get(s);
        blk[NATURAL[k]] = (int16_t)extend(v, s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // libjpeg-turbo's decode_mcu_fast: reads six bytes at a time and gives
  // up (the state untouched) at a marker, for the slow path to redo
  bool block_fast(const DTable& dct, const DTable& act, int16_t* blk) {
    uint64_t b = buf;
    int l = left;
    size_t pos = s.pos;
    bool marker = false;
    auto fill6 = [&]() {
      if (l <= 16) {
        for (int k = 0; k < 6; ++k) {
          int c0 = s.p[pos++];
          int c1 = s.p[pos];
          b = (b << 8) | (uint64_t)c0;
          l += 8;
          if (c0 == 0xFF) {
            pos++;
            if (c1 != 0) {
              marker = true;
              pos -= 2;
              b &= ~(uint64_t)0xFF;
            }
          }
        }
      }
    };
    auto getb = [&](int n) {
      l -= n;
      return (int)((b >> l) & ((1ULL << n) - 1));
    };
    auto dec = [&](const DTable& t) {
      fill6();
      int look = (int)((b >> (l - 8)) & 0xFF);
      int nb = t.look_nbits[look];
      if (nb) {
        l -= nb;
        return (int)t.look_sym[look];
      }
      nb = 9;
      l -= nb;
      int32_t code = (int32_t)((b >> l) & ((1ULL << nb) - 1));
      while (code > t.maxcode[nb]) {
        code <<= 1;
        code |= getb(1);
        nb++;
      }
      if (nb > 16) return 0;
      return (int)t.vals[(code + t.valoffset[nb]) & 0xFF];
    };
    int16_t tmp[64] = {0};
    int dc = last_dc;
    int sym = dec(dct);
    if (sym) {
      fill6();
      int r = getb(sym);
      sym = extend(r, sym);
    }
    dc = (int)((uint32_t)dc + (uint32_t)sym);
    tmp[0] = (int16_t)dc;
    for (int k = 1; k < 64; ++k) {
      sym = dec(act);
      int r = sym >> 4;
      sym &= 15;
      if (sym) {
        k += r;
        fill6();
        int v = getb(sym);
        tmp[NATURAL[k]] = (int16_t)extend(v, sym);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    if (marker) return false;
    std::memcpy(blk, tmp, sizeof(tmp));
    buf = b;
    left = l;
    s.pos = pos;
    last_dc = dc;
    return true;
  }
};

static void decode(const uint8_t* src, size_t n, uint8_t* dst, int32_t* hw, bool header_only) {
  Source s{src, n};
  // the signature readers check before they hand a file to libjpeg
  if (n < 3 || src[0] != 0xFF || src[1] != 0xD8 || src[2] != 0xFF)
    fail("not a JPEG file: no FF D8 FF signature");
  s.pos = 2;
  Image im;
  bool saw_soi = true;
  for (;;) {
    int m = s.next_marker();
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC) {
      get_sof(s, im, m);
      hw[0] = im.height;
      hw[1] = im.width;
      if (header_only) return;
      continue;
    }
    if (m == 0xDA) break;
    switch (m) {
      case 0xD8:
        if (saw_soi) fail("corrupt JPEG: duplicate SOI marker");
        break;
      case 0xC4: get_dht(s, im); break;
      case 0xCC: get_dac(s); break;
      case 0xDB: get_dqt(s, im); break;
      case 0xDD: {
        long length = s.u16();
        if (length != 4) fail("corrupt JPEG: bogus marker length");
        im.restart = s.u16();
        break;
      }
      case 0xD9: fail("corrupt JPEG: no image before EOI");
      case 0x01:
      case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6: case 0xD7:
        break;
      default:
        if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
          s.skip(s.u16() - 2);
          break;
        }
        fail("corrupt JPEG: unsupported marker 0x" + std::to_string(m));
    }
  }
  // SOS
  if (!im.saw_sof) fail("corrupt JPEG: SOS before SOF");
  long length = s.u16();
  int ns = s.byte();
  if (length != ns * 2 + 6 || ns < 1 || ns > 4) fail("corrupt JPEG: bogus marker length");
  int td = 0, ta = 0;
  for (int i = 0; i < ns; ++i) {
    int cc = s.byte(), c = s.byte();
    if (i > 0 || cc != im.comp_id) fail("corrupt JPEG: invalid component ID in SOS");
    td = (c >> 4) & 15;
    ta = c & 15;
  }
  s.byte();  // Ss, Se, Ah/Al: libjpeg only warns when they are not 0, 63, 0
  s.byte();
  s.byte();
  if (im.tq >= 4 || !im.qdef[im.tq]) fail("corrupt JPEG: quantization table 0x" + std::to_string(im.tq) + " was not defined");
  if (td >= 4 || ta >= 4) fail("corrupt JPEG: Huffman table index out of range");
  HTable dct = im.dc[td], act = im.ac[ta];
  if (!dct.defined) {
    if (td != 0) fail("corrupt JPEG: Huffman table 0x" + std::to_string(td) + " was not defined");
    std::memcpy(dct.bits + 1, STD_DC, 16);
    std::memcpy(dct.vals, STD_DC + 16, 12);
  }
  if (!act.defined) {
    if (ta != 0) fail("corrupt JPEG: Huffman table 0x" + std::to_string(ta) + " was not defined");
    std::memcpy(act.bits + 1, STD_AC, 16);
    std::memcpy(act.vals, STD_AC + 16, 162);
  }
  DTable d_dc, d_ac;
  derive(dct, true, d_dc);
  derive(act, false, d_ac);
  const uint16_t* q = im.q[im.tq];

  int bw = (im.width + 7) / 8, bh = (im.height + 7) / 8;
  Entropy e(s);
  int restarts_to_go = im.restart, next_restart = 0;
  uint8_t tile[64];
  for (int by = 0; by < bh; ++by) {
    for (int bx = 0; bx < bw; ++bx) {
      if (im.restart) {
        if (restarts_to_go == 0) {
          // process_restart: drop the buffered bits, find the marker
          e.left = 0;
          if (e.unread_marker == 0) e.unread_marker = s.next_marker();
          int desired = next_restart;
          if (e.unread_marker == 0xD0 + desired) {
            e.unread_marker = 0;
          } else {
            for (;;) {  // jpeg_resync_to_restart
              int mk = e.unread_marker, action;
              if (mk < 0xC0) action = 2;
              else if (mk < 0xD0 || mk > 0xD7) action = 3;
              else if (mk == 0xD0 + ((desired + 1) & 7) || mk == 0xD0 + ((desired + 2) & 7)) action = 3;
              else if (mk == 0xD0 + ((desired - 1) & 7) || mk == 0xD0 + ((desired - 2) & 7)) action = 2;
              else action = 1;
              if (action == 1) {
                e.unread_marker = 0;
                break;
              }
              if (action == 3) break;
              e.unread_marker = s.next_marker();
            }
          }
          next_restart = (next_restart + 1) & 7;
          e.last_dc = 0;
          restarts_to_go = im.restart;
          if (e.unread_marker == 0) e.insufficient = false;
        }
      }
      int16_t blk[64] = {0};
      if (!e.insufficient) {
        bool fast = e.unread_marker == 0 && n - s.pos >= 512;
        if (!fast || !e.block_fast(d_dc, d_ac, blk)) {
          std::memset(blk, 0, sizeof(blk));
          e.block(d_dc, d_ac, blk);
        }
      }
      if (im.restart) restarts_to_go--;
      idct_islow(blk, q, tile, 8);
      int y0 = by * 8, x0 = bx * 8;
      int hh = std::min(8, im.height - y0), ww = std::min(8, im.width - x0);
      for (int r = 0; r < hh; ++r) std::memcpy(dst + (size_t)(y0 + r) * im.width + x0, tile + 8 * r, ww);
    }
  }
}

// ------------------------------------------------------------ encoder
struct ETable {
  uint16_t code[256];
  uint8_t size[256];
};

static void build_etable(const uint8_t* bits, const uint8_t* vals, ETable& t) {
  std::memset(t.size, 0, sizeof(t.size));
  uint32_t code = 0;
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++p) {
      t.code[vals[p]] = (uint16_t)code;
      t.size[vals[p]] = (uint8_t)l;
      code++;
    }
    code <<= 1;
  }
}

struct BitOut {
  std::vector<uint8_t>& o;
  uint32_t acc = 0;
  int n = 0;
  explicit BitOut(std::vector<uint8_t>& out) : o(out) {}
  void put(uint32_t v, int nb) {
    for (int i = nb - 1; i >= 0; --i) {
      acc = (acc << 1) | ((v >> i) & 1);
      if (++n == 8) {
        o.push_back((uint8_t)acc);
        if (acc == 0xFF) o.push_back(0);
        acc = 0;
        n = 0;
      }
    }
  }
  void flush() {  // pad with 1 bits
    while (n) put(1, 1);
  }
};

static void fdct_islow(int32_t* d) {
  for (int r = 0; r < 8; ++r) {
    int32_t* p = d + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7], tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5], tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    p[0] = (int32_t)((t10 + t11) * 4);
    p[4] = (int32_t)((t10 - t11) * 4);
    int64_t z1 = (t12 + t13) * F0541;
    p[2] = (int32_t)descale(z1 + t13 * F0765, 11);
    p[6] = (int32_t)descale(z1 + t12 * -F1847, 11);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7, z5 = (z3 + z4) * F1175;
    tmp4 *= F0298;
    tmp5 *= F2053;
    tmp6 *= F3072;
    tmp7 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    p[7] = (int32_t)descale(tmp4 + z1 + z3, 11);
    p[5] = (int32_t)descale(tmp5 + z2 + z4, 11);
    p[3] = (int32_t)descale(tmp6 + z2 + z3, 11);
    p[1] = (int32_t)descale(tmp7 + z1 + z4, 11);
  }
  for (int c = 0; c < 8; ++c) {
    int32_t* p = d + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56], tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40], tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    p[0] = (int32_t)descale(t10 + t11, 2);
    p[32] = (int32_t)descale(t10 - t11, 2);
    int64_t z1 = (t12 + t13) * F0541;
    p[16] = (int32_t)descale(z1 + t13 * F0765, 15);
    p[48] = (int32_t)descale(z1 + t12 * -F1847, 15);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7, z5 = (z3 + z4) * F1175;
    tmp4 *= F0298;
    tmp5 *= F2053;
    tmp6 *= F3072;
    tmp7 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    p[56] = (int32_t)descale(tmp4 + z1 + z3, 15);
    p[40] = (int32_t)descale(tmp5 + z2 + z4, 15);
    p[24] = (int32_t)descale(tmp6 + z2 + z3, 15);
    p[8] = (int32_t)descale(tmp7 + z1 + z4, 15);
  }
}

static int nbits(int v) {
  v = v < 0 ? -v : v;
  int n = 0;
  while (v) {
    n++;
    v >>= 1;
  }
  return n;
}

static std::vector<uint8_t> encode(const uint8_t* img, int h, int w, int quality) {
  if (h <= 0 || w <= 0 || h > 65500 || w > 65500) fail("JPEG encode: bad image size");
  quality = std::max(1, std::min(100, quality));
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t q[64];
  for (int i = 0; i < 64; ++i) {
    long v = ((long)STD_Q[i] * scale + 50) / 100;
    q[i] = (uint16_t)std::max(1L, std::min(255L, v));
  }
  std::vector<uint8_t> o = {0xFF, 0xD8, 0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  o.insert(o.end(), {0xFF, 0xDB, 0, 67, 0});
  for (int k = 0; k < 64; ++k) o.push_back((uint8_t)q[NATURAL[k]]);
  o.insert(o.end(), {0xFF, 0xC0, 0, 11, 8, (uint8_t)(h >> 8), (uint8_t)h, (uint8_t)(w >> 8), (uint8_t)w, 1,
                     1, 0x11, 0});
  o.insert(o.end(), {0xFF, 0xC4, 0, 31, 0x00});
  o.insert(o.end(), STD_DC, STD_DC + 28);
  o.insert(o.end(), {0xFF, 0xC4, 0, 181, 0x10});
  o.insert(o.end(), STD_AC, STD_AC + 178);
  o.insert(o.end(), {0xFF, 0xDA, 0, 8, 1, 1, 0x00, 0, 63, 0});
  ETable dc, ac;
  build_etable(STD_DC, STD_DC + 16, dc);
  build_etable(STD_AC, STD_AC + 16, ac);
  BitOut bo(o);
  int bw = (w + 7) / 8, bh = (h + 7) / 8, last = 0;
  for (int by = 0; by < bh; ++by) {
    for (int bx = 0; bx < bw; ++bx) {
      int32_t d[64];
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c) {
          int y = std::min(by * 8 + r, h - 1), x = std::min(bx * 8 + c, w - 1);  // edge replicate
          d[8 * r + c] = (int32_t)img[(size_t)y * w + x] - 128;
        }
      fdct_islow(d);
      int zz[64];
      for (int k = 0; k < 64; ++k) {
        int i = NATURAL[k];
        int64_t qv = (int64_t)q[i] * 8, t = d[i];
        zz[k] = (int)(t < 0 ? -((-t + qv / 2) / qv) : (t + qv / 2) / qv);
      }
      int diff = zz[0] - last;
      last = zz[0];
      int s = nbits(diff);
      bo.put(dc.code[s], dc.size[s]);
      if (s) bo.put((uint32_t)(diff < 0 ? diff - 1 : diff), s);
      int run = 0;
      for (int k = 1; k < 64; ++k) {
        if (zz[k] == 0) {
          run++;
          continue;
        }
        while (run > 15) {
          bo.put(ac.code[0xF0], ac.size[0xF0]);
          run -= 16;
        }
        int v = zz[k], sz = nbits(v);
        int sym = (run << 4) | sz;
        bo.put(ac.code[sym], ac.size[sym]);
        bo.put((uint32_t)(v < 0 ? v - 1 : v), sz);
        run = 0;
      }
      if (run) bo.put(ac.code[0], ac.size[0]);
    }
  }
  bo.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

}  // namespace tmjpeg

extern "C" {

const char* tm_jpeg_error() { return tmjpeg::g_error.c_str(); }

// decode a grey JPEG into dst (h*w bytes, row-major); hw gets (h, w).
// With dst null only the header is read.  0 on success, -1 on error
// (message in tm_jpeg_error).
int32_t tm_jpeg_decode(const uint8_t* src, int64_t n, uint8_t* dst, int32_t* hw) {
  using namespace tmjpeg;
  try {
    hw[0] = hw[1] = 0;
    decode(src, (size_t)n, dst, hw, dst == nullptr);
    if (dst == nullptr && hw[0] == 0) fail("corrupt JPEG: no SOF marker");
    return 0;
  } catch (const std::exception& e) {
    g_error = e.what();
    return -1;
  }
}

// encode an (h, w) grey image; returns the stream's length (written when
// it fits in cap), -1 on error
int64_t tm_jpeg_encode(const uint8_t* img, int32_t h, int32_t w, int32_t quality, uint8_t* dst,
                       int64_t cap) {
  using namespace tmjpeg;
  try {
    std::vector<uint8_t> o = encode(img, h, w, quality);
    if ((int64_t)o.size() <= cap) std::memcpy(dst, o.data(), o.size());
    return (int64_t)o.size();
  } catch (const std::exception& e) {
    g_error = e.what();
    return -1;
  }
}

}  // extern "C"
