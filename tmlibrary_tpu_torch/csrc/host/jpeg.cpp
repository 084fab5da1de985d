// jpeg.cpp: the port's JPEG codec (CZI compression 1 subblocks, .jpg
// site files, the JPEG strips and tiles of TIFF pages).
//
// Decoder: every 8-bit JPEG stream cv2.imdecode(..., IMREAD_UNCHANGED)
// reads, as libjpeg-turbo 3.1 decodes it there: sequential (SOF0/SOF1)
// and progressive (SOF2) Huffman, sequential (SOF9) and progressive
// (SOF10) arithmetic coding, and lossless (SOF3) at precisions 2-8; of 1,
// 3 or 4 (CMYK/YCCK) components:
// - markers: Huffman tables (the Annex K tables in empty slots 0 and 1
//   of a sequential Huffman stream, as jdhuff.c fills them), arithmetic
//   conditioning (DAC: L, U and Kx, defaults 0, 1 and 5), 8- and 16-bit
//   quantisation tables latched at each component's first scan, DRI, JFIF
//   and Adobe segments (which decide the colour space with the component
//   ids, default_decompress_parms), APPn/COM/fill bytes;
// - scans: interleaved and non-interleaved; progressive DC first and
//   refinement, AC first (EOB runs) and refinement (correction bits);
//   restart markers with libjpeg's resync;
// - arithmetic decoding as jdarith.c does it: the QM decoder over Annex
//   D's Qe table, DC conditioning by L and U, AC by Kx, statistics reset at
//   each restart, zero data past a marker, and a spectral or magnitude
//   overflow (ct = -1) that leaves the rest of the restart interval as it
//   was;
// - lossless decoding as jdlhuff.c, jddiffct.c and jdlossls.c do it:
//   predictors 1-7 and the point transform, the first row of a scan and of
//   each restart interval predicted from the left and each first column
//   from above, samples modulo 2^16 stored in 8 bits;
// - libjpeg's integer inverse DCT (jidctint.c: CONST_BITS 13,
//   PASS1_BITS 2) as libjpeg-turbo's x86-64 SIMD runs it (16-bit lanes,
//   saturating), which is jidctint.c's arithmetic on every block whose
//   values stay in range;
// - block smoothing of a progressive stream whose scans stop before its
//   first AC coefficients are known in full (jdcoefct.c
//   decompress_smooth_data: the 5x5 DC neighbourhood, the latched
//   coefficient bits);
// - colour as jdsample.c and jdcolor.c make it: fancy h2v1, h2v2 and h1v2
//   upsampling (rows past the last repeating it; lossless streams
//   replicate), replication for 4:1:1 and other integral factors, the
//   YCbCr -> RGB tables, BGR out; YCCK -> CMYK (ycck_cmyk_convert), then
//   CMYK -> BGR as cv2 turns libjpeg's JCS_CMYK into three channels
//   (inverted Adobe CMYK: k - ((255 - c) * k >> 8));
// - damaged entropy data as libjpeg handles it: zero bits past a marker
//   that ends a segment, a code of 17 bits or more read as symbol 0, the
//   rest of a segment left as it was once data ran out, restart-marker
//   resync -- so a stream decodes to the pixels libjpeg gives.
// What cv2 returns None for is refused naming the feature: hierarchical
// and arithmetic-coded lossless streams, 12- and 16-bit streams, 2
// components, fractional sampling, a lossless stream that would need a
// colour conversion (YCbCr, YCCK), a lossless stream without Huffman
// tables; a stream that ends before its data does fails, as it does
// through an in-memory libjpeg source.  All state is per call: imextract's
// decode threads call it at once.
//
// Encoder: baseline JPEG of a grey or BGR image byte for byte as
// libjpeg-turbo 3.1 writes it for cv2.imencode(".jpg") at its defaults:
// the integer forward DCT (jfdctint.c), the Annex K tables scaled by
// libjpeg's quality formula, colour as YCbCr 4:2:0 (jccolor.c's tables,
// jcsample.c's h2v2 downsampling, jcprepct.c's edge padding, jccoefct.c's
// dummy blocks); integer arithmetic only, so its bytes are the same on
// every machine.
//
// Built into the port's host library (tmlibrary_tpu_torch/native.py),
// bound with ctypes.  C ABI only; errors come back as a negative return
// and a message (tm_jpeg_error, thread-local).

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

// max_dc: the largest DC symbol a table may hold (15, 16 in lossless
// mode), -1 for an AC table
static void derive(const HTable& h, int max_dc, DTable& d) {
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
  if (max_dc >= 0)
    for (int i = 0; i < numsymbols; ++i)
      if (h.vals[i] > max_dc) fail("corrupt JPEG: bogus Huffman table definition");
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

// Annex K.3 chrominance tables, libjpeg's defaults for Huffman slot 1
static const uint8_t STD_DC_C[16 + 12] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0,
                                          0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t STD_AC_C[16 + 162] = {
    0,    2,    1,    2,    4,    4,    3,    4,    7,    5,    4,    4,    0,    1,    2,    0x77,
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0,
    0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8,
    0xf9, 0xfa};

// how the components of a colour stream become BGR
enum ColorMode { GUESS = 0, FORCE_YCC = 1, RAW = 2 };
// the colour space of a stream's components, as libjpeg decides it
enum Space { SPACE_GREY, SPACE_YCC, SPACE_RGB, SPACE_CMYK, SPACE_YCCK, SPACE_RAW };

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;    // width_in_blocks, height_in_blocks (samples when lossless)
  int dw = 0, dh = 0;    // downsampled_width, downsampled_height
  int bwp = 0, bhp = 0;  // the coefficient grid, padded to whole MCUs
  int dc_tbl = 0, ac_tbl = 0;
  bool latched = false;  // its quantisation table, copied at its first scan
  bool scanned = false;  // lossless: a scan wrote its samples
  uint16_t q[64] = {0};
  int coef_bits[64];     // progressive: the Al each coefficient reached, -1 none
  int prev_bits[64];     // coef_bits before the component's latest scan (coefficients 0-9)
  int latch[10], prev_latch[10];  // smoothing_ok's copies of both
  std::vector<int16_t> coef;
  std::vector<uint8_t> samples;  // lossless: the component's samples, bw x bh
  int16_t* block(int bx, int by) { return coef.data() + ((size_t)by * bwp + bx) * 64; }
};

struct Image {
  int precision = 0, height = 0, width = 0, ncomp = 0, sof = 0;
  Comp comp[4];
  bool saw_sof = false, progressive = false, arith = false, lossless = false;
  bool started = false, multi_scan = false;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  int restart = 0;
  int max_h = 1, max_v = 1, mcux = 0, mcuy = 0;
  int space = SPACE_GREY;  // latched at the first SOS, as jpeg_start_decompress does
  int scans = 0;      // input_scan_number
  int last_good = 0;  // the last iMCU row an MCU of was decoded with data (last_good_iMCU_row)
  bool qdef[4] = {false, false, false, false};
  uint16_t q[4][64];
  HTable dc[4], ac[4];
  uint8_t dac_l[16], dac_u[16], dac_k[16];  // arithmetic conditioning, reset at SOI
  Image() {
    std::memset(dac_l, 0, 16);
    std::memset(dac_u, 1, 16);
    std::memset(dac_k, 5, 16);
  }
};

// what cv2 returns None for, by SOF marker
static const char* sof_feature(int m) {
  switch (m) {
    case 0xC5: return "hierarchical JPEG (SOF5)";
    case 0xC6: return "hierarchical progressive JPEG (SOF6)";
    case 0xC7: return "hierarchical lossless JPEG (SOF7)";
    case 0xC8: return "JPEG extension (JPG marker)";
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
    if (c < 4) {
      im.comp[c].id = id;
      im.comp[c].h = (hv >> 4) & 15;
      im.comp[c].v = hv & 15;
      im.comp[c].tq = tq;
    }
  }
  im.saw_sof = true;
  im.sof = marker;
  im.progressive = marker == 0xC2 || marker == 0xCA;
  im.arith = marker >= 0xC9;
  im.lossless = marker == 0xC3;
  if (const char* f = sof_feature(marker))
    fail(std::string(f) + " is not supported (cv2 reads no such stream)");
  if (im.lossless) {
    if (im.precision < 2 || im.precision > 8)
      fail(std::to_string(im.precision) + "-bit lossless JPEG is not supported (cv2 reads 2 to 8 bits)");
  } else if (im.precision != 8) {
    fail(std::to_string(im.precision) + "-bit JPEG is not supported (cv2 reads 8 bits)");
  }
  if (im.ncomp != 1 && im.ncomp != 3 && im.ncomp != 4)
    fail(std::to_string(im.ncomp) + "-component JPEG is not supported (cv2 reads 1, 3 or 4)");
  if (im.height > 65500 || im.width > 65500) fail("corrupt JPEG: image too big");
  if ((int64_t)im.height * im.width > ((int64_t)1 << 30)) fail("corrupt JPEG: image too big");
  for (int c = 0; c < im.ncomp; ++c)
    if (im.comp[c].h <= 0 || im.comp[c].h > 4 || im.comp[c].v <= 0 || im.comp[c].v > 4)
      fail("corrupt JPEG: bogus sampling factors");
}

// jdmarker.c get_dac: DC conditioning (L, U) of slots 0-15, AC (Kx) of
// slots 16-31; libjpeg takes any Kx
static void get_dac(Source& s, Image& im) {
  long length = s.u16() - 2;
  while (length > 0) {
    int index = s.byte(), val = s.byte();
    length -= 2;
    if (index < 0 || index >= 32) fail("corrupt JPEG: bogus DAC index " + std::to_string(index));
    if (index >= 16) {
      im.dac_k[index - 16] = (uint8_t)val;
    } else {
      im.dac_l[index] = (uint8_t)(val & 0x0F);
      im.dac_u[index] = (uint8_t)(val >> 4);
      if (im.dac_l[index] > im.dac_u[index])
        fail("corrupt JPEG: bogus DAC value 0x" + std::to_string(val));
    }
  }
  if (length != 0) fail("corrupt JPEG: bogus marker length");
}

// APP0 and APP14 as libjpeg's get_interesting_appn reads them: the
// first 14 bytes name a JFIF or an Adobe segment (which decide the
// colour space of a 3- or 4-component stream), the rest is skipped
static void get_appn(Source& s, Image& im, int m) {
  long length = s.u16() - 2;
  long numtoread = length >= 14 ? 14 : length > 0 ? length : 0;
  uint8_t b[14];
  for (long i = 0; i < numtoread; ++i) b[i] = (uint8_t)s.byte();
  if (m == 0xE0 && numtoread >= 14 && std::memcmp(b, "JFIF\0", 5) == 0) im.jfif = true;
  if (m == 0xEE && numtoread >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
    im.adobe = true;
    im.adobe_transform = b[11];
  }
  s.skip(length - numtoread);
}

// default_decompress_parms and what jinit_color_deconverter allows: the
// colour space of the components (mode as tm_jpeg_decode's)
static Space colour_space(const Image& im, int mode) {
  if (im.ncomp == 1) return SPACE_GREY;
  if (mode == RAW) return SPACE_RAW;
  if (im.ncomp == 3) {
    bool ycc;
    if (mode == FORCE_YCC) ycc = true;
    else if (im.jfif) ycc = true;
    else if (im.adobe) ycc = im.adobe_transform != 0;
    else if (im.comp[0].id == 82 && im.comp[1].id == 71 && im.comp[2].id == 66) ycc = false;
    else ycc = !im.lossless;  // ids 1, 2, 3 or unknown: YCbCr, RGB when lossless
    if (ycc && im.lossless)
      fail("lossless JPEG in YCbCr is not supported (libjpeg converts no colour in lossless "
           "mode; cv2 reads no such stream)");
    return ycc ? SPACE_YCC : SPACE_RGB;
  }
  if (mode == FORCE_YCC) fail("corrupt JPEG: YCbCr of 4 components");
  bool ycck = im.adobe && im.adobe_transform != 0;
  if (ycck && im.lossless)
    fail("lossless YCCK JPEG is not supported (libjpeg converts no colour in lossless mode; "
         "cv2 reads no such stream)");
  return ycck ? SPACE_YCCK : SPACE_CMYK;
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
  int last_dc[4] = {0, 0, 0, 0};
  unsigned eobrun = 0;
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

  // decode_mcu_slow, one block
  void block(const DTable& dct, const DTable& act, int16_t* blk, int& dc) {
    int s = decode(dct);
    if (s) {
      int r = get(s);
      s = extend(r, s);
    }
    dc = (int)((uint32_t)dc + (uint32_t)s);
    blk[0] = (int16_t)dc;
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
  // up at a marker (the bit state and DC predictions untouched, what it
  // wrote into the blocks left there, as turbo leaves it) for the slow
  // path to redo the MCU
  bool mcu_fast(int nblk, const DTable* const* dct, const DTable* const* act, const int* ci,
                int16_t* const* blks) {
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
    int dc[4];
    std::memcpy(dc, last_dc, sizeof(dc));
    for (int bi = 0; bi < nblk; ++bi) {
      int16_t* blk = blks[bi];
      int sym = dec(*dct[bi]);
      if (sym) {
        fill6();
        int r = getb(sym);
        sym = extend(r, sym);
      }
      dc[ci[bi]] = (int)((uint32_t)dc[ci[bi]] + (uint32_t)sym);
      blk[0] = (int16_t)dc[ci[bi]];
      for (int k = 1; k < 64; ++k) {
        sym = dec(*act[bi]);
        int r = sym >> 4;
        sym &= 15;
        if (sym) {
          k += r;
          fill6();
          int v = getb(sym);
          blk[NATURAL[k]] = (int16_t)extend(v, sym);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
    if (marker) return false;
    buf = b;
    left = l;
    s.pos = pos;
    std::memcpy(last_dc, dc, sizeof(dc));
    return true;
  }

  // jdphuff.c: the four kinds of progressive scan
  void dc_first(int nblk, const DTable* const* dct, const int* ci, int16_t* const* blks, int al) {
    for (int bi = 0; bi < nblk; ++bi) {
      int s = decode(*dct[bi]);
      if (s) {
        int r = get(s);
        s = extend(r, s);
      }
      int& dc = last_dc[ci[bi]];
      if ((dc >= 0 && s > INT32_MAX - dc) || (dc < 0 && s < INT32_MIN - dc))
        fail("corrupt JPEG: DCT coefficient out of range");
      dc += s;
      blks[bi][0] = (int16_t)(uint16_t)((uint32_t)dc << al);
    }
  }
  void dc_refine(int nblk, int16_t* const* blks, int al) {
    for (int bi = 0; bi < nblk; ++bi)
      if (get(1)) blks[bi][0] = (int16_t)(blks[bi][0] | (1 << al));
  }
  void ac_first(const DTable& t, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int s = decode(t);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        r = get(s);
        s = extend(r, s);
        blk[NATURAL[k]] = (int16_t)(uint16_t)((unsigned)s << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1u << r;
        if (r) eobrun += (unsigned)get(r);
        eobrun--;
        break;
      }
    }
  }
  void ac_refine(const DTable& t, int16_t* blk, int ss, int se, int al) {
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    auto correct = [&](int16_t& c) {
      if (get(1) && (c & p1) == 0) c = (int16_t)(c >= 0 ? c + p1 : c + m1);
    };
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int s = decode(t);
        int r = s >> 4;
        s &= 15;
        if (s) {
          s = get(1) ? p1 : m1;  // a size other than 1 only warns
        } else if (r != 15) {
          eobrun = 1u << r;
          if (r) eobrun += (unsigned)get(r);
          break;
        }
        do {
          int16_t& c = blk[NATURAL[k]];
          if (c != 0) {
            correct(c);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) blk[NATURAL[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& c = blk[NATURAL[k]];
        if (c != 0) correct(c);
      }
      eobrun--;
    }
  }
};

// ------------------------------------ the arithmetic decoder (jdarith.c)
// jaricom.c's packing of Annex D's Table D.2: Qe << 16 | Next_Index_MPS
// << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5
// estimate of ITU-T T.851
static const uint32_t ARITAB[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719,
    0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b,
    0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320,
    0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e,
    0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a,
    0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171};

// The QM decoder (arith_decode: C holds the interval base and the bit
// buffer, CT the cut between them; -16 before the first two bytes, -1
// after an overflow, when the rest of the restart interval is skipped)
// and jdarith.c's MCU decoders.  Statistics are per scan: each scan sets
// them to 0 (start_pass), as each restart does.
struct Arith {
  Source& s;
  int64_t c = 0, a = 0;
  int ct = -16;
  int unread_marker = 0;
  int last_dc[4] = {0, 0, 0, 0}, dc_context[4] = {0, 0, 0, 0};
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin = 113;
  const uint8_t *L, *U, *K;
  explicit Arith(Source& src, const Image& im) : s(src), L(im.dac_l), U(im.dac_u), K(im.dac_k) {
    std::memset(dc_stats, 0, sizeof dc_stats);
    std::memset(ac_stats, 0, sizeof ac_stats);
  }

  int decode(uint8_t* st) {
    while (a < 0x8000) {  // renormalisation and data input, D.2.6
      if (--ct < 0) {
        int data;
        if (unread_marker) {
          data = 0;  // past a marker: zero data
        } else {
          data = s.byte();
          if (data == 0xFF) {
            do data = s.byte();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              unread_marker = data;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // the two initial bytes read
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = ARITAB[sv & 0x7F];
    int nl = (int)(qe & 0xFF);
    qe >>= 8;
    int nm = (int)(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional LPS exchange
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {  // conditional MPS exchange
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // F.19, F.21-F.24: a DC difference of scan component ci added to its
  // last value; false on a magnitude overflow
  bool dc(int ci, int tbl) {
    uint8_t* st = dc_stats[tbl] + dc_context[ci];
    if (decode(st) == 0) {
      dc_context[ci] = 0;
      return true;
    }
    int sign = decode(st + 1);
    st += 2 + sign;
    int m = decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;
      while (decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ct = -1;
          return false;
        }
        st += 1;
      }
    }
    if (m < (int)((1L << L[tbl]) >> 1)) dc_context[ci] = 0;
    else if (m > (int)((1L << U[tbl]) >> 1)) dc_context[ci] = 12 + sign * 4;
    else dc_context[ci] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last_dc[ci] = (last_dc[ci] + v) & 0xFFFF;
    return true;
  }

  // F.20-F.24: AC coefficients ss..se, each scaled by al; false on a
  // spectral or magnitude overflow
  bool ac(int16_t* blk, int tbl, int ss, int se, int al) {
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (decode(st)) break;  // EOB
      while (decode(st + 1) == 0) {
        st += 3;
        k++;
        if (k > se) {
          ct = -1;  // spectral overflow
          return false;
        }
      }
      int sign = decode(&fixed_bin);
      st += 2;
      int m = decode(st);
      if (m != 0 && decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= K[tbl] ? 189 : 217);
        while (decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ct = -1;  // magnitude overflow
            return false;
          }
          st += 1;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[NATURAL[k]] = (int16_t)(uint16_t)((unsigned)v << al);
    }
    return true;
  }

  // G.1.3.3: successive approximation of AC coefficients ss..se
  void ac_refine(int16_t* blk, int tbl, int ss, int se, int al) {
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;
    for (; kex > 0; kex--)
      if (blk[NATURAL[kex]]) break;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && decode(st)) break;  // EOB
      for (;;) {
        int16_t& c = blk[NATURAL[k]];
        if (c) {  // previously nonzero
          if (decode(st + 2)) c = (int16_t)(c < 0 ? c + m1 : c + p1);
          break;
        }
        if (decode(st + 1)) {  // newly nonzero
          c = (int16_t)(decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        k++;
        if (k > se) {
          ct = -1;  // spectral overflow
          return;
        }
      }
    }
  }
};

// ------------------------------------------------------ the scans
static void load_table(const HTable& h, int max_dc, DTable& d, int index) {
  if (index >= 4) fail("corrupt JPEG: Huffman table index out of range");
  if (!h.defined) fail("corrupt JPEG: Huffman table 0x" + std::to_string(index) + " was not defined");
  derive(h, max_dc, d);
}

// read_restart_marker: the expected RSTn, or jpeg_resync_to_restart's
// way past whatever came instead
static void read_restart_marker(Source& s, int& unread_marker, int& next_restart) {
  if (unread_marker == 0) unread_marker = s.next_marker();
  int desired = next_restart;
  if (unread_marker == 0xD0 + desired) {
    unread_marker = 0;
  } else {
    for (;;) {
      int mk = unread_marker, action;
      if (mk < 0xC0) action = 2;
      else if (mk < 0xD0 || mk > 0xD7) action = 3;
      else if (mk == 0xD0 + ((desired + 1) & 7) || mk == 0xD0 + ((desired + 2) & 7)) action = 3;
      else if (mk == 0xD0 + ((desired - 1) & 7) || mk == 0xD0 + ((desired - 2) & 7)) action = 2;
      else action = 1;
      if (action == 1) {
        unread_marker = 0;
        break;
      }
      if (action == 3) break;
      unread_marker = s.next_marker();
    }
  }
  next_restart = (next_restart + 1) & 7;
}

// the Huffman decoders' process_restart: buffered bits dropped, the
// marker read, DC predictions and the EOB run reset
static void process_restart(Source& s, Entropy& e, int& next_restart, int ncomp) {
  e.left = 0;
  read_restart_marker(s, e.unread_marker, next_restart);
  for (int c = 0; c < ncomp; ++c) e.last_dc[c] = 0;
  e.eobrun = 0;
  if (e.unread_marker == 0) e.insufficient = false;
}

// jdinput.c initial_setup and what jpeg_start_decompress checks: the
// component geometry (data units of 8 samples, 1 when lossless) and
// upsampling that libjpeg does not refuse
static void geometry(Image& im) {
  const int unit = im.lossless ? 1 : 8;
  for (int c = 0; c < im.ncomp; ++c) {
    im.max_h = std::max(im.max_h, im.comp[c].h);
    im.max_v = std::max(im.max_v, im.comp[c].v);
  }
  im.mcux = (int)(((int64_t)im.width + im.max_h * unit - 1) / (im.max_h * unit));
  im.mcuy = (int)(((int64_t)im.height + im.max_v * unit - 1) / (im.max_v * unit));
  for (int c = 0; c < im.ncomp; ++c) {
    Comp& k = im.comp[c];
    k.bw = (int)(((int64_t)im.width * k.h + im.max_h * unit - 1) / (im.max_h * unit));
    k.bh = (int)(((int64_t)im.height * k.v + im.max_v * unit - 1) / (im.max_v * unit));
    k.dw = (int)(((int64_t)im.width * k.h + im.max_h - 1) / im.max_h);
    k.dh = (int)(((int64_t)im.height * k.v + im.max_v - 1) / im.max_v);
    k.bwp = std::max(k.bw, im.mcux * k.h);
    k.bhp = std::max(k.bh, im.mcuy * k.v);
    if (im.ncomp > 1 && (im.max_h % k.h || im.max_v % k.v))
      fail("fractional JPEG sampling (" + std::to_string(k.h) + "x" + std::to_string(k.v) +
           " in " + std::to_string(im.max_h) + "x" + std::to_string(im.max_v) +
           ") is not supported (cv2 reads no such stream)");
  }
}

// the first scan: coefficient (or sample) memory, libjpeg's default
// Huffman tables in empty slots 0 and 1 of a sequential Huffman stream
// (jdhuff.c; the progressive and lossless decoders have none)
static void start(Image& im) {
  im.started = true;
  for (int c = 0; c < im.ncomp; ++c) {
    Comp& k = im.comp[c];
    if (im.lossless) k.samples.assign((size_t)k.bw * k.bh, 0);
    else k.coef.assign((size_t)k.bwp * k.bhp * 64, 0);
    for (int i = 0; i < 64; ++i) k.coef_bits[i] = k.prev_bits[i] = -1;
  }
  const uint8_t* std_tables[2][2] = {{STD_DC, STD_AC}, {STD_DC_C, STD_AC_C}};
  for (int t = 0; t < 2 && !im.progressive && !im.arith && !im.lossless; ++t) {
    if (!im.dc[t].defined) {
      std::memcpy(im.dc[t].bits + 1, std_tables[t][0], 16);
      std::memcpy(im.dc[t].vals, std_tables[t][0] + 16, 12);
      im.dc[t].defined = true;
    }
    if (!im.ac[t].defined) {
      std::memcpy(im.ac[t].bits + 1, std_tables[t][1], 16);
      std::memcpy(im.ac[t].vals, std_tables[t][1] + 16, 162);
      im.ac[t].defined = true;
    }
  }
}

// the blocks (or samples) of one MCU of a scan: per_scan_setup
struct McuLayout {
  int nblk = 0, ci[10], bdx[10], bdy[10];
  Comp* bc[10];
  int mcux = 0, mcuy = 0;
  McuLayout(Image& im, int ns, Comp* const* sc) {
    for (int i = 0; i < ns; ++i) {
      int bx = ns == 1 ? 1 : sc[i]->h, by = ns == 1 ? 1 : sc[i]->v;
      if (nblk + bx * by > 10) fail("corrupt JPEG: sampling factors too large for an interleaved scan");
      for (int y = 0; y < by; ++y)
        for (int x = 0; x < bx; ++x) {
          ci[nblk] = i;
          bc[nblk] = sc[i];
          bdx[nblk] = x;
          bdy[nblk] = y;
          nblk++;
        }
    }
    if (ns == 1) {
      mcux = sc[0]->bw;
      mcuy = sc[0]->bh;
    } else {
      mcux = im.mcux;
      mcuy = im.mcuy;
    }
  }
  // (x, y) of block b of MCU (mx, my) in its component's grid
  int x(int b, int mx, int ns) const { return mx * (ns == 1 ? 1 : bc[b]->h) + bdx[b]; }
  int y(int b, int my, int ns) const { return my * (ns == 1 ? 1 : bc[b]->v) + bdy[b]; }
};

// jddiffct.c, jdlhuff.c and jdlossls.c: one lossless scan.  An iMCU row's
// differences are decoded MCU row by MCU row (a restart or a row met with
// no data left resets every component to the first-row predictor), then
// undifferenced row by row: the first row after a reset from the left
// (2^(P - Pt - 1) at its first sample), the rest by the predictor Ss, each
// first column from above; samples modulo 2^16, shifted by Pt into 8 bits.
static int lossless_scan(Source& s, Image& im, int ns, Comp* const* sc, int ss, int se, int ah,
                         int al) {
  if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= im.precision)
    fail("corrupt JPEG: invalid lossless parameters Ss=" + std::to_string(ss) + " Se=" +
         std::to_string(se) + " Ah=" + std::to_string(ah) + " Al=" + std::to_string(al));
  McuLayout lay(im, ns, sc);
  DTable dtab[4];
  for (int i = 0; i < ns; ++i)
    load_table(sc[i]->dc_tbl < 4 ? im.dc[sc[i]->dc_tbl] : HTable(), 16, dtab[i], sc[i]->dc_tbl);
  const int T = (int)(((int64_t)im.height + im.max_v - 1) / im.max_v);  // total_iMCU_rows
  const int per_row = lay.mcux;
  if (im.restart && im.restart % per_row)
    fail("corrupt JPEG: restart interval " + std::to_string(im.restart) + " is not a multiple of "
         "the " + std::to_string(per_row) + " MCUs in a row (lossless JPEG)");
  // each scan component's difference rows (one iMCU row) and undifferenced rows
  std::vector<int32_t> diff[4], undiff[4];
  int dwid[4];
  bool first[4];
  for (int i = 0; i < ns; ++i) {
    sc[i]->scanned = true;
    dwid[i] = ns == 1 ? sc[i]->bw : im.mcux * sc[i]->h;
    diff[i].assign((size_t)sc[i]->v * dwid[i], 0);
    undiff[i].assign((size_t)sc[i]->v * sc[i]->bw, 0);
    first[i] = true;
  }
  const int init = 1 << (im.precision - al - 1);
  Entropy e(s);
  int rows_to_go = im.restart ? im.restart / per_row : 0, next_restart = 0;
  for (int r = 0; r < T; ++r) {
    int last_height = ns == 1 ? (sc[0]->bh % sc[0]->v ? sc[0]->bh % sc[0]->v : sc[0]->v) : 1;
    int mcu_rows = ns > 1 ? 1 : (r < T - 1 ? sc[0]->v : last_height);
    for (int yo = 0; yo < mcu_rows; ++yo) {
      if (im.restart) {
        if (rows_to_go == 0) {
          e.left = 0;
          read_restart_marker(s, e.unread_marker, next_restart);
          if (e.unread_marker == 0) e.insufficient = false;
          for (int i = 0; i < ns; ++i) first[i] = true;
          rows_to_go = im.restart / per_row;
        }
      }
      if (e.insufficient) {  // no data left: zero differences, predictors reset
        for (int b = 0; b < lay.nblk; ++b) {
          int i = lay.ci[b], row = ns == 1 ? yo : lay.bdy[b];
          std::fill(diff[i].begin() + (size_t)row * dwid[i],
                    diff[i].begin() + (size_t)(row + 1) * dwid[i], 0);
        }
        for (int i = 0; i < ns; ++i) first[i] = true;
      } else {
        for (int mx = 0; mx < per_row; ++mx)
          for (int b = 0; b < lay.nblk; ++b) {
            int i = lay.ci[b];
            int v = e.decode(dtab[i]);
            if (v == 16) {
              v = 32768;
            } else if (v) {
              int bits = e.get(v);
              v = Entropy::extend(bits, v);
            }
            int row = ns == 1 ? yo : lay.bdy[b];
            diff[i][(size_t)row * dwid[i] + lay.x(b, mx, ns)] = v;
          }
      }
      if (im.restart) rows_to_go--;
    }
    for (int i = 0; i < ns; ++i) {
      Comp& k = *sc[i];
      const int V = k.v, W = k.bw;
      int rows = r < T - 1 ? V : (k.bh % V ? k.bh % V : V);
      for (int row = 0; row < rows; ++row) {
        const int32_t* d = diff[i].data() + (size_t)row * dwid[i];
        const int32_t* prev = undiff[i].data() + (size_t)(row == 0 ? V - 1 : row - 1) * W;
        int32_t* cur = undiff[i].data() + (size_t)row * W;
        if (first[i] || ss == 1) {  // UNDIFFERENCE_1D
          int ra = (d[0] + (first[i] ? init : prev[0])) & 0xFFFF;
          cur[0] = ra;
          for (int x = 1; x < W; ++x) {
            ra = (d[x] + ra) & 0xFFFF;
            cur[x] = ra;
          }
          first[i] = false;
        } else {  // UNDIFFERENCE_2D: prev may be cur (one row an iMCU row)
          int rb = prev[0], rc;
          int ra = (d[0] + rb) & 0xFFFF;
          cur[0] = ra;
          for (int x = 1; x < W; ++x) {
            rc = rb;
            rb = prev[x];
            int p;
            switch (ss) {
              case 2: p = rb; break;
              case 3: p = rc; break;
              case 4: p = ra + rb - rc; break;
              case 5: p = ra + ((rb - rc) >> 1); break;
              case 6: p = rb + ((ra - rc) >> 1); break;
              default: p = (ra + rb) >> 1; break;
            }
            ra = (d[x] + p) & 0xFFFF;
            cur[x] = ra;
          }
        }
        uint8_t* out = k.samples.data() + (size_t)(r * V + row) * W;
        for (int x = 0; x < W; ++x) out[x] = (uint8_t)(cur[x] << al);
      }
    }
  }
  return e.unread_marker;
}

// jdarith.c: one arithmetic-coded scan; the restart processing and the
// ct = -1 check come first in every MCU, as decode_mcu does them
static int arith_scan(Source& s, Image& im, int ns, Comp* const* sc, const McuLayout& lay, int ss,
                      int se, int ah, int al) {
  Arith e(s, im);
  int restarts_to_go = im.restart, next_restart = 0;
  int16_t* blks[10];
  for (int my = 0; my < lay.mcuy; ++my) {
    for (int mx = 0; mx < lay.mcux; ++mx) {
      im.last_good = ns == 1 ? my / sc[0]->v : my;
      if (im.restart) {
        if (restarts_to_go == 0) {  // process_restart
          read_restart_marker(s, e.unread_marker, next_restart);
          for (int i = 0; i < ns; ++i) {
            if (!im.progressive || (ss == 0 && ah == 0)) {
              std::memset(e.dc_stats[sc[i]->dc_tbl], 0, 64);
              e.last_dc[i] = e.dc_context[i] = 0;
            }
            if (!im.progressive || ss) std::memset(e.ac_stats[sc[i]->ac_tbl], 0, 256);
          }
          e.c = e.a = 0;
          e.ct = -16;
          restarts_to_go = im.restart;
        }
        restarts_to_go--;
      }
      for (int b = 0; b < lay.nblk; ++b) blks[b] = lay.bc[b]->block(lay.x(b, mx, ns), lay.y(b, my, ns));
      if (!im.progressive) {
        if (e.ct == -1) continue;
        for (int b = 0; b < lay.nblk; ++b) {
          int i = lay.ci[b];
          if (!e.dc(i, sc[i]->dc_tbl)) break;
          blks[b][0] = (int16_t)e.last_dc[i];
          if (!e.ac(blks[b], sc[i]->ac_tbl, 1, 63, 0)) break;
        }
      } else if (ss == 0 && ah == 0) {
        if (e.ct == -1) continue;
        for (int b = 0; b < lay.nblk; ++b) {
          int i = lay.ci[b];
          if (!e.dc(i, sc[i]->dc_tbl)) break;
          blks[b][0] = (int16_t)(uint16_t)((uint32_t)e.last_dc[i] << al);
        }
      } else if (ss == 0) {
        for (int b = 0; b < lay.nblk; ++b)
          if (e.decode(&e.fixed_bin)) blks[b][0] = (int16_t)(blks[b][0] | (1 << al));
      } else if (ah == 0) {
        if (e.ct == -1) continue;
        e.ac(blks[0], sc[0]->ac_tbl, ss, se, al);
      } else {
        if (e.ct == -1) continue;
        e.ac_refine(blks[0], sc[0]->ac_tbl, ss, se, al);
      }
    }
  }
  return e.unread_marker;
}

// SOS and the entropy-coded segment after it (the source is just past
// the marker); returns the marker that ended the data, if one did
static int scan(Source& s, Image& im) {
  long length = s.u16();
  int ns = s.byte();
  if (length != ns * 2 + 6 || ns < 1 || ns > 4) fail("corrupt JPEG: bogus marker length");
  Comp* sc[4];
  for (int i = 0; i < ns; ++i) {
    int cc = s.byte(), c = s.byte();
    int found = -1;
    for (int k = 0; k < im.ncomp && found < 0; ++k)
      if (im.comp[k].id == cc) found = k;
    if (found < 0) fail("corrupt JPEG: invalid component ID " + std::to_string(cc) + " in SOS");
    sc[i] = &im.comp[found];
    sc[i]->dc_tbl = (c >> 4) & 15;
    sc[i]->ac_tbl = c & 15;
    for (int j = 0; j < i; ++j)
      if (sc[j] == sc[i]) fail("corrupt JPEG: invalid component ID " + std::to_string(cc) + " in SOS");
  }
  int ss = s.byte(), se = s.byte(), a = s.byte();
  int ah = (a >> 4) & 15, al = a & 15;
  im.scans++;
  if (!im.started) {
    start(im);
    im.multi_scan = im.progressive || ns < im.ncomp;
  }
  if (im.lossless) return lossless_scan(s, im, ns, sc, ss, se, ah, al);
  if (im.progressive) {  // start_pass_phuff_decoder / jdarith.c start_pass
    bool bad = ss == 0 ? se != 0 : (ss > se || se >= 64 || ns != 1);
    if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
    if (bad)
      fail("corrupt JPEG: invalid progressive parameters Ss=" + std::to_string(ss) + " Se=" +
           std::to_string(se) + " Ah=" + std::to_string(ah) + " Al=" + std::to_string(al));
    for (int i = 0; i < ns; ++i) {
      for (int k = std::min(ss, 1); k <= std::max(se, 9); ++k)
        sc[i]->prev_bits[k] = im.scans > 1 ? sc[i]->coef_bits[k] : 0;
      for (int k = ss; k <= se; ++k) sc[i]->coef_bits[k] = al;
    }
  }
  McuLayout lay(im, ns, sc);
  for (int i = 0; i < ns; ++i) {  // latch_quant_tables
    Comp& k = *sc[i];
    if (k.latched) continue;
    if (k.tq >= 4 || !im.qdef[k.tq])
      fail("corrupt JPEG: quantization table 0x" + std::to_string(k.tq) + " was not defined");
    std::memcpy(k.q, im.q[k.tq], sizeof(k.q));
    k.latched = true;
  }
  if (im.arith) return arith_scan(s, im, ns, sc, lay, ss, se, ah, al);
  DTable dtab[10], atab[10];
  const DTable* dct[10];
  const DTable* act[10];
  for (int i = 0; i < ns; ++i) {
    if (!im.progressive || (ss == 0 && ah == 0)) {
      load_table(sc[i]->dc_tbl < 4 ? im.dc[sc[i]->dc_tbl] : HTable(), 15, dtab[i], sc[i]->dc_tbl);
    }
    if (!im.progressive || ss != 0) {
      load_table(sc[i]->ac_tbl < 4 ? im.ac[sc[i]->ac_tbl] : HTable(), -1, atab[i], sc[i]->ac_tbl);
    }
  }
  const int nblk = lay.nblk;
  for (int b = 0; b < nblk; ++b) {
    dct[b] = &dtab[lay.ci[b]];
    act[b] = &atab[lay.ci[b]];
  }

  Entropy e(s);
  int restarts_to_go = im.restart, next_restart = 0;
  int16_t* blks[10];
  for (int my = 0; my < lay.mcuy; ++my) {
    for (int mx = 0; mx < lay.mcux; ++mx) {
      if (!e.insufficient) im.last_good = ns == 1 ? my / sc[0]->v : my;
      if (im.restart && restarts_to_go == 0) {
        process_restart(s, e, next_restart, ns);
        restarts_to_go = im.restart;
      }
      for (int b = 0; b < nblk; ++b) blks[b] = lay.bc[b]->block(lay.x(b, mx, ns), lay.y(b, my, ns));
      if (!e.insufficient) {
        if (!im.progressive) {
          bool fast = e.unread_marker == 0 && s.n - s.pos >= (size_t)512 * nblk;
          if (!fast || !e.mcu_fast(nblk, dct, act, lay.ci, blks))
            for (int b = 0; b < nblk; ++b) e.block(*dct[b], *act[b], blks[b], e.last_dc[lay.ci[b]]);
        } else if (ss == 0) {
          if (ah == 0) e.dc_first(nblk, dct, lay.ci, blks, al);
          else e.dc_refine(nblk, blks, al);
        } else if (ah == 0) {
          e.ac_first(*act[0], blks[0], ss, se, al);
        } else {
          e.ac_refine(*act[0], blks[0], ss, se, al);
        }
      }
      if (im.restart) restarts_to_go--;
    }
  }
  return e.unread_marker;
}

// jdcoefct.c smoothing_ok: whether libjpeg runs block smoothing over the
// coefficients of a progressive stream whose scans stopped before the
// first AC coefficients were known in full; latches each component's
// coefficient bits (and those before its latest scan) for it
static bool smoothing_ok(Image& im) {
  static const int POS[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  if (!im.progressive) return false;
  bool useful = false;
  for (int c = 0; c < im.ncomp; ++c) {
    Comp& k = im.comp[c];
    if (!k.latched) return false;
    for (int i = 0; i < 10; ++i)
      if (k.q[POS[i]] == 0) return false;
    if (k.coef_bits[0] < 0) return false;
    k.latch[0] = k.coef_bits[0];
    for (int i = 1; i < 10; ++i) {
      k.prev_latch[i] = im.scans > 1 ? k.prev_bits[i] : -1;
      k.latch[i] = k.coef_bits[i];
      if (k.coef_bits[i] != 0) useful = true;
    }
  }
  return useful;
}

// jdcoefct.c decompress_smooth_data (libjpeg-turbo 3.1): each block's
// first nine AC coefficients, where still zero and not known in full,
// estimated from the DC values of its 5x5 neighbourhood of blocks (edges
// replicated); with no AC data at all, a Gaussian-like estimate of those
// and of the DC itself.  Past the last iMCU row decoded with data, the
// coefficient bits from before the latest scan hold.
static void smooth_component(const Image& im, Comp& k, uint8_t* plane, int stride) {
  const int T = im.mcuy;  // total_iMCU_rows
  const int V = k.v, last_col = k.bw - 1;
  const int64_t Q00 = k.q[0], Q01 = k.q[1], Q10 = k.q[8], Q20 = k.q[16], Q11 = k.q[9],
                Q02 = k.q[2], Q03 = k.q[3], Q12 = k.q[10], Q21 = k.q[17], Q30 = k.q[24];
  auto dcv = [&](int r, int c) { return (int)k.block(c, r)[0]; };
  for (int out = 0; out < T; ++out) {
    int block_rows = out < T - 1 ? V : (k.bh % V ? k.bh % V : V);
    const int* bits = out > im.last_good ? k.prev_latch : k.latch;
    bool change_dc = true;
    for (int i = 1; i < 10; ++i)
      if (bits[i] != -1) change_dc = false;
    const int image_block_rows = block_rows * T;
    for (int br = 0; br < block_rows; ++br) {
      const int ibr = out * block_rows + br, r = out * V + br;
      const int rp = ibr > 0 ? r - 1 : r;
      const int rpp = ibr > 1 ? r - 2 : rp;
      const int rn = ibr < image_block_rows - 1 ? r + 1 : r;
      const int rnn = ibr < image_block_rows - 2 ? r + 2 : rn;
      const int rows5[5] = {rpp, rp, r, rn, rnn};
      for (int bn = 0; bn <= last_col; ++bn) {
        int16_t ws[64];
        std::memcpy(ws, k.block(bn, r), sizeof ws);
        // the 5x5 DC values around the block, D01-D05 two rows above
        int D[26];
        for (int i = 0; i < 5; ++i)
          for (int j = 0; j < 5; ++j)
            D[1 + 5 * i + j] = dcv(rows5[i], std::min(std::max(bn + j - 2, 0), last_col));
        const int64_t D01 = D[1], D02 = D[2], D03 = D[3], D04 = D[4], D05 = D[5], D06 = D[6],
                      D07 = D[7], D08 = D[8], D09 = D[9], D10 = D[10], D11 = D[11], D12 = D[12],
                      D13 = D[13], D14 = D[14], D15 = D[15], D16 = D[16], D17 = D[17],
                      D18 = D[18], D19 = D[19], D20 = D[20], D21 = D[21], D22 = D[22],
                      D23 = D[23], D24 = D[24], D25 = D[25];
        auto predict = [&](int al, int pos, int64_t qk, int64_t sum) {
          if (al == 0 || ws[pos] != 0) return;
          int64_t num = Q00 * sum;
          int pred;
          if (num >= 0) {
            pred = (int)(((qk << 7) + num) / (qk << 8));
            if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
          } else {
            pred = (int)(((qk << 7) - num) / (qk << 8));
            if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
            pred = -pred;
          }
          ws[pos] = (int16_t)pred;
        };
        predict(bits[1], 1, Q01,
                change_dc ? -D01 - D02 + D04 + D05 - 3 * D06 + 13 * D07 - 13 * D09 +
                                3 * D10 - 3 * D11 + 38 * D12 - 38 * D14 + 3 * D15 - 3 * D16 +
                                13 * D17 - 13 * D19 + 3 * D20 - D21 - D22 + D24 + D25
                          : -7 * D11 + 50 * D12 - 50 * D14 + 7 * D15);
        predict(bits[2], 8, Q10,
                change_dc ? -D01 - 3 * D02 - 3 * D03 - 3 * D04 - D05 - D06 + 13 * D07 +
                                38 * D08 + 13 * D09 - D10 + D16 - 13 * D17 - 38 * D18 -
                                13 * D19 + D20 + D21 + 3 * D22 + 3 * D23 + 3 * D24 + D25
                          : -7 * D03 + 50 * D08 - 50 * D18 + 7 * D23);
        predict(bits[3], 16, Q20,
                change_dc ? D03 + 2 * D07 + 7 * D08 + 2 * D09 - 5 * D12 - 14 * D13 -
                                5 * D14 + 2 * D17 + 7 * D18 + 2 * D19 + D23
                          : -D03 + 13 * D08 - 24 * D13 + 13 * D18 - D23);
        predict(bits[4], 9, Q11,
                change_dc ? -D01 + D05 + 9 * D07 - 9 * D09 - 9 * D17 + 9 * D19 + D21 - D25
                          : D10 + D16 - 10 * D17 + 10 * D19 - D02 - D20 + D22 - D24 +
                                D04 - D06 + 10 * D07 - 10 * D09);
        predict(bits[5], 2, Q02,
                change_dc ? 2 * D07 - 5 * D08 + 2 * D09 + D11 + 7 * D12 - 14 * D13 +
                                7 * D14 + D15 + 2 * D17 - 5 * D18 + 2 * D19
                          : -D11 + 13 * D12 - 24 * D13 + 13 * D14 - D15);
        if (change_dc) {
          predict(bits[6], 3, Q03, D07 - D09 + 2 * D12 - 2 * D14 + D17 - D19);
          predict(bits[7], 10, Q12, D07 - 3 * D08 + D09 - D17 + 3 * D18 - D19);
          predict(bits[8], 17, Q21, D07 - D09 - 3 * D12 + 3 * D14 + D17 - D19);
          predict(bits[9], 24, Q30, D07 + 2 * D08 + D09 - D17 - 2 * D18 - D19);
          int64_t num = Q00 * (-2 * D01 - 6 * D02 - 8 * D03 - 6 * D04 - 2 * D05 -
                               6 * D06 + 6 * D07 + 42 * D08 + 6 * D09 - 6 * D10 - 8 * D11 +
                               42 * D12 + 152 * D13 + 42 * D14 - 8 * D15 - 6 * D16 + 6 * D17 +
                               42 * D18 + 6 * D19 - 6 * D20 - 2 * D21 - 6 * D22 - 8 * D23 -
                               6 * D24 - 2 * D25);
          int pred = num >= 0 ? (int)(((Q00 << 7) + num) / (Q00 << 8))
                              : -(int)(((Q00 << 7) - num) / (Q00 << 8));
          ws[0] = (int16_t)pred;
        }
        idct_islow(ws, k.q, plane + (size_t)r * 8 * stride + (size_t)bn * 8, stride);
      }
    }
  }
}

// ------------------------------------------------ upsampling, colour
// One component at full size as libjpeg-turbo's jdsample.c makes it:
// fancy h2v1, h2v2 (triangle filters; plain replication where the
// component is at most 2 samples wide) and h1v2, replication for every
// other integral factor and for every factor of a lossless stream (no
// fancy upsampling at a scaled size of 1).  Rows past the component's
// last row repeat it (jdmainct.c's context rows), the row above the first
// is the first.
static void upsample(const Image& im, const Comp& k, const uint8_t* plane, int stride,
                     uint8_t* out) {
  const int H = im.height, W = im.width;
  const int fx = im.max_h / k.h, fy = im.max_v / k.v;
  const bool fancy = !im.lossless;
  auto row = [&](int y) { return plane + (size_t)std::min(std::max(y, 0), k.dh - 1) * stride; };
  std::vector<uint8_t> line((size_t)k.dw * 2 + 2);
  for (int y = 0; y < H; ++y) {
    uint8_t* o = out + (size_t)y * W;
    if (fx == 1 && fy == 1) {
      std::memcpy(o, row(y), W);
    } else if (fancy && fx == 2 && fy == 1 && k.dw > 2) {
      const uint8_t* in = row(y);
      uint8_t* l = line.data();
      l[0] = in[0];
      l[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
      for (int c = 1; c < k.dw - 1; ++c) {
        int v = in[c] * 3;
        l[2 * c] = (uint8_t)((v + in[c - 1] + 1) >> 2);
        l[2 * c + 1] = (uint8_t)((v + in[c + 1] + 2) >> 2);
      }
      int last = k.dw - 1;
      l[2 * last] = (uint8_t)((in[last] * 3 + in[last - 1] + 1) >> 2);
      l[2 * last + 1] = in[last];
      std::memcpy(o, l, W);
    } else if (fancy && fx == 1 && fy == 2) {
      int iy = y >> 1;
      const uint8_t* in0 = row(iy);
      const uint8_t* in1 = row(y & 1 ? iy + 1 : iy - 1);
      int bias = y & 1 ? 2 : 1;
      for (int x = 0; x < W; ++x) o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
    } else if (fancy && fx == 2 && fy == 2 && k.dw > 2) {
      int iy = y >> 1;
      const uint8_t* in0 = row(iy);
      const uint8_t* in1 = row(y & 1 ? iy + 1 : iy - 1);
      uint8_t* l = line.data();
      int thiscol = in0[0] * 3 + in1[0], nextcol = in0[1] * 3 + in1[1], lastcol;
      l[0] = (uint8_t)((thiscol * 4 + 8) >> 4);
      l[1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
      lastcol = thiscol;
      thiscol = nextcol;
      for (int c = 2; c < k.dw; ++c) {
        nextcol = in0[c] * 3 + in1[c];
        l[2 * c - 2] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
        l[2 * c - 1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
      }
      l[2 * k.dw - 2] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
      l[2 * k.dw - 1] = (uint8_t)((thiscol * 4 + 7) >> 4);
      std::memcpy(o, l, W);
    } else {
      const uint8_t* in = row(y / fy);
      for (int x = 0; x < W; ++x) o[x] = in[x / fx];
    }
  }
}

// jdcolor.c's YCbCr -> RGB tables (SCALEBITS 16)
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t half = 1 << 15;
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((91881 * x + half) >> 16);   // FIX(1.40200)
      cb_b[i] = (int)((116130 * x + half) >> 16);  // FIX(1.77200)
      cr_g[i] = (int32_t)(-46802 * x);             // -FIX(0.71414)
      cb_g[i] = (int32_t)(-22554 * x + half);      // -FIX(0.34414), + ONE_HALF
    }
  }
};

static inline uint8_t clamp8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// cv2's icvCvt_CMYK2BGR_8u_C4C3R: one ink of libjpeg's (inverted Adobe)
// CMYK and its K into a BGR channel
static inline uint8_t cmyk_channel(int ink, int k) { return (uint8_t)(k - ((255 - ink) * k >> 8)); }

// The markers up to the first SOS (all of them with header_only, which
// then checks what jpeg_start_decompress would refuse and returns), then
// every scan, the inverse DCT (block-smoothed where libjpeg smooths) or
// the lossless samples, upsampling and colour.
static void decode(const uint8_t* src, size_t n, uint8_t* dst, int32_t* hwc, bool header_only,
                   int mode, Image* header = nullptr) {
  Source s{src, n};
  // the signature readers check before they hand a file to libjpeg
  if (n < 3 || src[0] != 0xFF || src[1] != 0xD8 || src[2] != 0xFF)
    fail("not a JPEG file: no FF D8 FF signature");
  s.pos = 2;
  Image im;
  int pending = 0;  // a marker that ended a scan's data
  for (;;) {
    int m = pending ? pending : s.next_marker();
    pending = 0;
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC) {
      get_sof(s, im, m);
      hwc[0] = im.height;
      hwc[1] = im.width;
      hwc[2] = im.ncomp == 1 ? 1 : mode == RAW ? im.ncomp : 3;
      continue;
    }
    if (m == 0xDA) {
      if (!im.saw_sof) fail("corrupt JPEG: SOS before SOF");
      if (!im.started) {
        geometry(im);
        im.space = colour_space(im, mode);
        if (header_only) {
          if (header) *header = im;
          return;
        }
      }
      pending = scan(s, im);
      if (!im.multi_scan) break;  // one scan holds the image: libjpeg reads no further
      continue;
    }
    switch (m) {
      case 0xD8: fail("corrupt JPEG: duplicate SOI marker");
      case 0xC4: get_dht(s, im); break;
      case 0xCC: get_dac(s, im); break;
      case 0xDB: get_dqt(s, im); break;
      case 0xDD: {
        long length = s.u16();
        if (length != 4) fail("corrupt JPEG: bogus marker length");
        im.restart = s.u16();
        break;
      }
      case 0xD9:
        if (!im.started) fail("corrupt JPEG: no image before EOI");
        break;
      case 0x01:
      case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6: case 0xD7:
        break;
      case 0xE0: case 0xEE: get_appn(s, im, m); break;
      default:
        if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
          s.skip(s.u16() - 2);
          break;
        }
        fail("corrupt JPEG: unsupported marker 0x" + std::to_string(m));
    }
    if (m == 0xD9) break;
  }
  const int space = im.space;
  for (int c = 0; c < im.ncomp && im.lossless; ++c)  // jddiffct.c's arrays are not pre-zeroed
    if (!im.comp[c].scanned)
      fail("corrupt JPEG: a lossless component that no scan holds (libjpeg reads undefined "
           "samples; cv2 reads no such stream)");

  // each component's samples: the lossless scans', or the inverse DCT of
  // every block that holds image samples
  const int H = im.height, W = im.width;
  std::vector<uint8_t> planes[4];
  int strides[4];
  const bool smooth = smoothing_ok(im);
  for (int c = 0; c < im.ncomp; ++c) {
    Comp& k = im.comp[c];
    if (im.lossless) {
      planes[c] = std::move(k.samples);
      strides[c] = k.bw;
      continue;
    }
    strides[c] = k.bw * 8;
    planes[c].resize((size_t)strides[c] * k.bh * 8);
    if (smooth) {
      smooth_component(im, k, planes[c].data(), strides[c]);
      continue;
    }
    for (int by = 0; by < k.bh; ++by)
      for (int bx = 0; bx < k.bw; ++bx)
        idct_islow(k.block(bx, by), k.q, planes[c].data() + (size_t)by * 8 * strides[c] + bx * 8,
                   strides[c]);
  }
  if (im.ncomp == 1) {
    for (int y = 0; y < H; ++y)
      std::memcpy(dst + (size_t)y * W, planes[0].data() + (size_t)y * strides[0], W);
    return;
  }
  const size_t np = (size_t)H * W;
  std::vector<uint8_t> full((size_t)im.ncomp * np);
  for (int c = 0; c < im.ncomp; ++c)
    upsample(im, im.comp[c], planes[c].data(), strides[c], full.data() + (size_t)c * np);
  static const YccTables T;
  const uint8_t *p0 = full.data(), *p1 = p0 + np, *p2 = p1 + np, *p3 = p2 + np;
  for (size_t i = 0; i < np; ++i) {
    if (space == SPACE_RAW) {  // the components as stored
      uint8_t* o = dst + (size_t)im.ncomp * i;
      for (int c = 0; c < im.ncomp; ++c) o[c] = full[(size_t)c * np + i];
      continue;
    }
    uint8_t* o = dst + 3 * i;
    if (space == SPACE_YCC) {
      int y = p0[i], cb = p1[i], cr = p2[i];
      o[0] = clamp8(y + T.cb_b[cb]);
      o[1] = clamp8(y + (int)((T.cb_g[cb] + T.cr_g[cr]) >> 16));
      o[2] = clamp8(y + T.cr_r[cr]);
    } else if (space == SPACE_RGB) {  // BGR order out
      o[0] = p2[i];
      o[1] = p1[i];
      o[2] = p0[i];
    } else {
      int c = p0[i], m = p1[i], y = p2[i], k = p3[i];
      if (space == SPACE_YCCK) {  // ycck_cmyk_convert: YCbCr -> RGB, inverted
        int l = p0[i], cb = p1[i], cr = p2[i];
        c = clamp8(255 - (l + T.cr_r[cr]));
        m = clamp8(255 - (l + (int)((T.cb_g[cb] + T.cr_g[cr]) >> 16)));
        y = clamp8(255 - (l + T.cb_b[cb]));
      }
      o[0] = cmyk_channel(y, k);
      o[1] = cmyk_channel(m, k);
      o[2] = cmyk_channel(c, k);
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

// Annex K.2 chrominance quantisation table, natural order
static const int STD_QC[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                               24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                               99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                               99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// libjpeg's jpeg_quality_scaling and jpeg_add_quant_table (baseline)
static void scale_table(const int* base, int quality, uint16_t* q) {
  quality = std::max(1, std::min(100, quality));
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long v = ((long)base[i] * scale + 50) / 100;
    q[i] = (uint16_t)std::max(1L, std::min(255L, v));
  }
}

// the forward DCT of one 8x8 block of level-shifted samples, quantised
// (libjpeg's rounding division by 8q), in zigzag order
static void quantize_block(int32_t* d, const uint16_t* q, int* zz) {
  fdct_islow(d);
  for (int k = 0; k < 64; ++k) {
    int i = NATURAL[k];
    int64_t qv = (int64_t)q[i] * 8, t = d[i];
    zz[k] = (int)(t < 0 ? -((-t + qv / 2) / qv) : (t + qv / 2) / qv);
  }
}

// one block's Huffman codes: the DC difference, then the AC run lengths
static void emit_block(const int* zz, int& last, const ETable& dc, const ETable& ac, BitOut& bo) {
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

static void put_dqt(std::vector<uint8_t>& o, int index, const uint16_t* q) {
  o.insert(o.end(), {0xFF, 0xDB, 0, 67, (uint8_t)index});
  for (int k = 0; k < 64; ++k) o.push_back((uint8_t)q[NATURAL[k]]);
}

static void put_dht(std::vector<uint8_t>& o, int klass_index, const uint8_t* table) {
  int count = 0;
  for (int i = 0; i < 16; ++i) count += table[i];
  o.insert(o.end(), {0xFF, 0xC4, (uint8_t)((19 + count) >> 8), (uint8_t)(19 + count),
                     (uint8_t)klass_index});
  o.insert(o.end(), table, table + 16 + count);
}

// A baseline JPEG of an (h, w) grey or (h, w, 3) BGR image as
// libjpeg-turbo 3.1 writes it at cv2.imencode's defaults: JFIF 1.01, the
// Annex K tables scaled by quality, the integer forward DCT; colour as
// YCbCr 4:2:0 (jccolor.c's integer tables, jcsample.c's h2v2 averaging
// with its alternating 1, 2 bias, edges replicated to whole blocks and
// iMCU rows as jcprepct.c does, dummy blocks past the image as jccoefct.c
// makes them: the DC of the block before, no AC).
static std::vector<uint8_t> encode(const uint8_t* img, int h, int w, int nc, int quality) {
  if (h <= 0 || w <= 0 || h > 65500 || w > 65500) fail("JPEG encode: bad image size");
  if (nc != 1 && nc != 3) fail("JPEG encode: 1 or 3 channels");
  uint16_t q[2][64];
  scale_table(STD_Q, quality, q[0]);
  scale_table(STD_QC, quality, q[1]);
  std::vector<uint8_t> o = {0xFF, 0xD8, 0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  put_dqt(o, 0, q[0]);
  if (nc == 3) put_dqt(o, 1, q[1]);
  if (nc == 1) {
    o.insert(o.end(), {0xFF, 0xC0, 0, 11, 8, (uint8_t)(h >> 8), (uint8_t)h, (uint8_t)(w >> 8), (uint8_t)w,
                       1, 1, 0x11, 0});
  } else {
    o.insert(o.end(), {0xFF, 0xC0, 0, 17, 8, (uint8_t)(h >> 8), (uint8_t)h, (uint8_t)(w >> 8), (uint8_t)w,
                       3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1});
  }
  put_dht(o, 0x00, STD_DC);
  put_dht(o, 0x10, STD_AC);
  if (nc == 3) {
    put_dht(o, 0x01, STD_DC_C);
    put_dht(o, 0x11, STD_AC_C);
    o.insert(o.end(), {0xFF, 0xDA, 0, 12, 3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0});
  } else {
    o.insert(o.end(), {0xFF, 0xDA, 0, 8, 1, 1, 0x00, 0, 63, 0});
  }
  ETable dc[2], ac[2];
  build_etable(STD_DC, STD_DC + 16, dc[0]);
  build_etable(STD_AC, STD_AC + 16, ac[0]);
  build_etable(STD_DC_C, STD_DC_C + 16, dc[1]);
  build_etable(STD_AC_C, STD_AC_C + 16, ac[1]);
  BitOut bo(o);
  int zz[64];
  int32_t d[64];
  if (nc == 1) {  // one component: blocks in raster order, edges replicated
    int bw = (w + 7) / 8, bh = (h + 7) / 8, last = 0;
    for (int by = 0; by < bh; ++by)
      for (int bx = 0; bx < bw; ++bx) {
        for (int r = 0; r < 8; ++r)
          for (int c = 0; c < 8; ++c) {
            int y = std::min(by * 8 + r, h - 1), x = std::min(bx * 8 + c, w - 1);
            d[8 * r + c] = (int32_t)img[(size_t)y * w + x] - 128;
          }
        quantize_block(d, q[0], zz);
        emit_block(zz, last, dc[0], ac[0], bo);
      }
  } else {
    // colour conversion (jccolor.c rgb_ycc_convert, BGR in)
    const int32_t FY_R = 19595, FY_G = 38470, FY_B = 7471, FCB_R = 11059, FCB_G = 21709,
                  FHALF = 32768, FCR_G = 27439, FCR_B = 5329;
    const int32_t ONE_HALF = 1 << 15, CBCR = 128 << 16;
    // Y: width_in_blocks * 8 columns, whole iMCU rows; chroma: input
    // padded to an even row count and 16-column groups, then h2v2
    int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
    int yw = ((w + 7) / 8) * 8, yh = mcuy * 16, cw = mcux * 8, ch = mcuy * 8;
    int hw = mcux * 16, hh = (h + 1) / 2 * 2;  // the downsampler's input extent
    std::vector<uint8_t> Y((size_t)yw * yh), Cb((size_t)cw * ch), Cr((size_t)cw * ch);
    std::vector<uint8_t> cbf((size_t)hw * hh), crf((size_t)hw * hh);
    for (int y = 0; y < hh; ++y) {
      const uint8_t* row = img + (size_t)std::min(y, h - 1) * w * 3;
      for (int x = 0; x < hw; ++x) {
        const uint8_t* p = row + (size_t)std::min(x, w - 1) * 3;
        int32_t b = p[0], g = p[1], r = p[2];
        uint8_t yy = (uint8_t)((FY_R * r + FY_G * g + FY_B * b + ONE_HALF) >> 16);
        uint8_t cb = (uint8_t)((-FCB_R * r - FCB_G * g + FHALF * b + CBCR + ONE_HALF - 1) >> 16);
        uint8_t cr = (uint8_t)((FHALF * r - FCR_G * g - FCR_B * b + CBCR + ONE_HALF - 1) >> 16);
        if (x < yw) Y[(size_t)y * yw + x] = yy;
        cbf[(size_t)y * hw + x] = cb;
        crf[(size_t)y * hw + x] = cr;
      }
    }
    for (int y = hh; y < yh; ++y)  // iMCU padding: the last row again
      std::memcpy(&Y[(size_t)y * yw], &Y[(size_t)(hh - 1) * yw], (size_t)yw);
    for (int y = 0; y < ch; ++y) {
      int sy = std::min(y, hh / 2 - 1);
      const uint8_t* b0 = &cbf[(size_t)(2 * sy) * hw];
      const uint8_t* b1 = b0 + hw;
      const uint8_t* r0 = &crf[(size_t)(2 * sy) * hw];
      const uint8_t* r1 = r0 + hw;
      int bias = 1;
      for (int x = 0; x < cw; ++x, bias ^= 3) {
        Cb[(size_t)y * cw + x] = (uint8_t)((b0[2 * x] + b0[2 * x + 1] + b1[2 * x] + b1[2 * x + 1] + bias) >> 2);
        Cr[(size_t)y * cw + x] = (uint8_t)((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
      }
    }
    auto load = [&](const std::vector<uint8_t>& plane, int stride, int by, int bx) {
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c) d[8 * r + c] = (int32_t)plane[(size_t)(by * 8 + r) * stride + bx * 8 + c] - 128;
    };
    int ybw = (w + 7) / 8, ybh = (h + 7) / 8, last[3] = {0, 0, 0};
    int yzz[4][64];
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx) {
        for (int yi = 0; yi < 2; ++yi)
          for (int xi = 0; xi < 2; ++xi) {
            int k = 2 * yi + xi, by = 2 * my + yi, bx = 2 * mx + xi;
            if (by >= ybh) {  // a dummy row: the DC of the row above's last block
              std::memset(yzz[k], 0, sizeof yzz[k]);
              yzz[k][0] = yzz[1][0];
            } else if (bx >= ybw) {  // a dummy column: the DC of the block before
              std::memset(yzz[k], 0, sizeof yzz[k]);
              yzz[k][0] = yzz[k - 1][0];
            } else {
              load(Y, yw, by, bx);
              quantize_block(d, q[0], yzz[k]);
            }
          }
        for (int k = 0; k < 4; ++k) emit_block(yzz[k], last[0], dc[0], ac[0], bo);
        load(Cb, cw, my, mx);
        quantize_block(d, q[1], zz);
        emit_block(zz, last[1], dc[1], ac[1], bo);
        load(Cr, cw, my, mx);
        quantize_block(d, q[1], zz);
        emit_block(zz, last[2], dc[1], ac[1], bo);
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

// decode a JPEG into dst (h*w*c bytes, row-major, c = 1 for grey, 3 for
// colour as BGR, the component count in mode 2); hwc gets (h, w, c).
// mode: 0 the colour space as libjpeg guesses it, 1 YCbCr whatever the
// markers say, 2 the components as stored (TIFF's JPEGCOLORMODE_RGB and
// raw RGB, CMYK).  With dst null only the markers up to the first SOS are
// read (and what jpeg_start_decompress refuses is refused).  0 on
// success, -1 on error (message in tm_jpeg_error).
int32_t tm_jpeg_decode(const uint8_t* src, int64_t n, uint8_t* dst, int32_t* hwc, int32_t mode) {
  using namespace tmjpeg;
  try {
    hwc[0] = hwc[1] = hwc[2] = 0;
    decode(src, (size_t)n, dst, hwc, dst == nullptr, mode);
    if (dst == nullptr && hwc[0] == 0) fail("corrupt JPEG: no SOF marker");
    return 0;
  } catch (const std::exception& e) {
    g_error = e.what();
    return -1;
  }
}

// the frame of a stream (its markers up to the first SOS, in mode as
// tm_jpeg_decode's): info gets (h, w, components, progressive, then each
// component's horizontal and vertical sampling factors in 4-11, the SOF
// marker in 12 and the sample precision in 13); 0 or -1
int32_t tm_jpeg_header(const uint8_t* src, int64_t n, int32_t* info, int32_t mode) {
  using namespace tmjpeg;
  try {
    int32_t hwc[3] = {0, 0, 0};
    Image im;
    decode(src, (size_t)n, nullptr, hwc, true, mode, &im);
    if (hwc[0] == 0) fail("corrupt JPEG: no SOF marker");
    info[0] = im.height;
    info[1] = im.width;
    info[2] = im.ncomp;
    info[3] = im.progressive;
    for (int c = 0; c < im.ncomp && c < 4; ++c) {
      info[4 + 2 * c] = im.comp[c].h;
      info[5 + 2 * c] = im.comp[c].v;
    }
    info[12] = im.sof;
    info[13] = im.precision;
    return 0;
  } catch (const std::exception& e) {
    g_error = e.what();
    return -1;
  }
}

// encode an (h, w, nc) image, nc 1 (grey) or 3 (BGR); returns the
// stream's length (written when it fits in cap), -1 on error
int64_t tm_jpeg_encode(const uint8_t* img, int32_t h, int32_t w, int32_t nc, int32_t quality,
                       uint8_t* dst, int64_t cap) {
  using namespace tmjpeg;
  try {
    std::vector<uint8_t> o = encode(img, h, w, nc, quality);
    if ((int64_t)o.size() <= cap) std::memcpy(dst, o.data(), o.size());
    return (int64_t)o.size();
  } catch (const std::exception& e) {
    g_error = e.what();
    return -1;
  }
}

}  // extern "C"
