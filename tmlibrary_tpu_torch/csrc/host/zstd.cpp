// zstd.cpp: the port's Zstandard codec (RFC 8878), for CZI subblocks
// compressed as zstd0/zstd1 and the writers that make them.
//
// Decoder: the whole frame format -- frames back to back, skippable
// frames, the window descriptor, raw/RLE/compressed blocks, the content
// checksum (XXH64) -- with literals raw, RLE, Huffman-compressed and
// treeless (1 and 4 streams), and sequences in predefined, RLE,
// FSE-compressed and repeat modes with repeat offsets.  Frames with a
// dictionary id are refused (there is no dictionary).  The checks follow
// the reference implementation's decoder, so a stream it refuses is
// refused here and one it accepts decodes to the same bytes.  Every read
// is bounded by the input and every write by the caller's capacity; the
// declared content size is checked against that capacity before a byte
// is decoded.
//
// Encoder: one frame with the content size, single segment; per block of at most 128 KiB a greedy hash matcher, Huffman
// (1 or 4 streams) or raw/RLE literals, and sequences coded in
// predefined, RLE or FSE-compressed mode, whichever is smallest; raw or
// RLE blocks where they are smaller.
//
// Built into the port's host library (tmlibrary_tpu_torch/native.py),
// bound with ctypes.  C ABI only; errors come back as a negative return
// and a message (tm_zstd_error).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace tmzstd {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] static void fail(const char* what) { throw Error(what); }

static thread_local std::string g_error;

static inline uint32_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
static inline uint32_t rd24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
static inline uint32_t rd32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}
static inline uint64_t rd64(const uint8_t* p) {
  return (uint64_t)rd32(p) | ((uint64_t)rd32(p + 4) << 32);
}
static inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// ---------------------------------------------------------------- XXH64
static const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                      P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                      P5 = 2870177450012600261ULL;
static inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
static inline uint64_t xround(uint64_t acc, uint64_t in) {
  acc += in * P2;
  return rotl(acc, 31) * P1;
}
static inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  acc ^= xround(0, v);
  return acc * P1 + P4;
}

static uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed = 0) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = seed + P5;
  }
  h += (uint64_t)n;
  while (p + 8 <= end) {
    h ^= xround(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)rd32(p) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// --------------------------------------------------------- code tables
static const uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                                     12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                                     48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
static const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  1,  1,
                                    1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,  16,   17,   18,   19,   20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30,  31,  32,  33,  34,   35,   37,   39,   41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
static const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                    2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                       2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
enum { MAX_LL = 35, MAX_ML = 52, MAX_OF = 31 };
static const int MAX_LOG[3] = {9, 8, 9};  // LL, OF, ML
static const size_t BLOCK_MAX = 128 * 1024;

static int ll_code(uint32_t ll) {
  static const uint8_t small[64] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12,
                                    13, 14, 15, 16, 16, 17, 17, 18, 18, 19, 19, 20, 20,
                                    20, 20, 21, 21, 21, 21, 22, 22, 22, 22, 22, 22, 22,
                                    22, 23, 23, 23, 23, 23, 23, 23, 23, 24, 24, 24, 24,
                                    24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24};
  return ll > 63 ? highbit(ll) + 19 : small[ll];
}
static int ml_code(uint32_t ml) {  // ml >= 3
  uint32_t mb = ml - 3;
  if (mb < 32) return (int)mb;
  for (int c = 52; c >= 32; --c)
    if (ml >= ML_BASE[c]) return c;
  return 32;
}

// ------------------------------------------------------- bit readers
// The backward bit stream of FSE and Huffman: the last byte holds a
// 1-bit marker above the final bits; reading starts just below it.
// Bits past the start of the stream read as zeros and count as consumed,
// so over-reading shows in `consumed > total`.
struct BackBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t total = 0, pos = 0;

  void init(const uint8_t* src, size_t len) {
    if (len < 1) fail("Src size is incorrect");
    p = src;
    n = len;
    uint8_t last = src[len - 1];
    if (last == 0) fail("Corrupted block detected");
    total = 8 * (int64_t)(len - 1) + highbit(last);
    pos = 0;
  }
  uint64_t load64(int64_t byte) const {  // bytes [byte, byte+8) with zero padding
    if (byte >= 0 && (size_t)byte + 8 <= n) return rd64(p + byte);
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) {
      int64_t b = byte + i;
      if (b >= 0 && (size_t)b < n) v |= (uint64_t)p[b] << (8 * i);
    }
    return v;
  }
  // the next nb (<= 56) bits, MSB first, without consuming them
  uint32_t peek(int nb) const {
    if (nb == 0) return 0;
    int64_t start = total - pos - nb;  // lowest bit index of the field
    if (start >= 0) {
      uint64_t v = load64(start >> 3) >> (start & 7);
      return (uint32_t)(v & ((1ULL << nb) - 1));
    }
    int have = (int)(nb + start);  // bits still in the stream
    if (have <= 0) return 0;
    uint64_t v = load64(0) & ((1ULL << have) - 1);
    return (uint32_t)(v << (-start));
  }
  uint32_t read(int nb) {
    uint32_t v = peek(nb);
    pos += nb;
    return v;
  }
  bool overflow() const { return pos > total; }
  bool finished() const { return pos == total; }
};

// ------------------------------------------------------------- FSE
struct FseEntry {
  uint16_t symbol;
  uint8_t nbBits;
  uint16_t base;  // next state base
};
struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
};

static void fse_spread(const int16_t* norm, int maxSym, int log, std::vector<uint16_t>& symbols) {
  uint32_t size = 1u << log, high = size - 1, step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  symbols.assign(size, 0);
  for (int s = 0; s <= maxSym; ++s)
    if (norm[s] == -1) symbols[high--] = (uint16_t)s;
  uint32_t pos = 0;
  for (int s = 0; s <= maxSym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      symbols[pos] = (uint16_t)s;
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail("Corrupted block detected");
}

static void fse_build(const int16_t* norm, int maxSym, int log, FseTable& out) {
  uint32_t size = 1u << log;
  std::vector<uint16_t> symbols;
  fse_spread(norm, maxSym, log, symbols);
  std::vector<uint32_t> next(maxSym + 1);
  for (int s = 0; s <= maxSym; ++s) next[s] = norm[s] == -1 ? 1 : (uint32_t)std::max<int>(norm[s], 0);
  out.log = log;
  out.t.resize(size);
  for (uint32_t u = 0; u < size; ++u) {
    uint16_t s = symbols[u];
    uint32_t ns = next[s]++;
    int nb = log - highbit(ns);
    out.t[u].symbol = s;
    out.t[u].nbBits = (uint8_t)nb;
    out.t[u].base = (uint16_t)((ns << nb) - size);
  }
}

// FSE_readNCount of the reference decoder, literally: returns the header
// size; *maxSym in/out, *log out.
static size_t read_ncount_body(int16_t* norm, int* maxSym, int* tableLog, const uint8_t* src, size_t n) {
  const uint8_t* istart = src;
  const uint8_t* iend = src + n;
  const uint8_t* ip = src;
  int maxSV1 = *maxSym + 1;
  int previous0 = 0;
  std::memset(norm, 0, sizeof(int16_t) * maxSV1);
  uint32_t bitStream = rd32(ip);
  int nbBits = (bitStream & 0xF) + 5;
  if (nbBits > 15) fail("tableLog requested is too large");
  bitStream >>= 4;
  int bitCount = 4;
  *tableLog = nbBits;
  int remaining = (1 << nbBits) + 1;
  int threshold = 1 << nbBits;
  nbBits++;
  int charnum = 0;
  for (;;) {
    if (previous0) {
      int repeats = __builtin_ctz(~bitStream | 0x80000000) >> 1;
      while (repeats >= 12) {
        charnum += 3 * 12;
        if (ip <= iend - 7) {
          ip += 3;
        } else {
          bitCount -= (int)(8 * (iend - 7 - ip));
          bitCount &= 31;
          ip = iend - 4;
        }
        bitStream = rd32(ip) >> bitCount;
        repeats = __builtin_ctz(~bitStream | 0x80000000) >> 1;
      }
      charnum += 3 * repeats;
      bitStream >>= 2 * repeats;
      bitCount += 2 * repeats;
      charnum += bitStream & 3;
      bitCount += 2;
      if (charnum >= maxSV1) break;
      if (ip <= iend - 7 || ip + (bitCount >> 3) <= iend - 4) {
        ip += bitCount >> 3;
        bitCount &= 7;
      } else {
        bitCount -= (int)(8 * (iend - 4 - ip));
        bitCount &= 31;
        ip = iend - 4;
      }
      bitStream = rd32(ip) >> bitCount;
    }
    {
      int max = (2 * threshold - 1) - remaining;
      int count;
      if ((int)(bitStream & (threshold - 1)) < max) {
        count = bitStream & (threshold - 1);
        bitCount += nbBits - 1;
      } else {
        count = bitStream & (2 * threshold - 1);
        if (count >= threshold) count -= max;
        bitCount += nbBits;
      }
      count--;
      if (count >= 0) remaining -= count;
      else remaining += count;
      norm[charnum++] = (int16_t)count;
      previous0 = !count;
      if (remaining < threshold) {
        if (remaining <= 1) break;
        nbBits = highbit(remaining) + 1;
        threshold = 1 << (nbBits - 1);
      }
      if (charnum >= maxSV1) break;
      if (ip <= iend - 7 || ip + (bitCount >> 3) <= iend - 4) {
        ip += bitCount >> 3;
        bitCount &= 7;
      } else {
        bitCount -= (int)(8 * (iend - 4 - ip));
        bitCount &= 31;
        ip = iend - 4;
      }
      bitStream = rd32(ip) >> bitCount;
    }
  }
  if (remaining != 1) fail("Corrupted block detected");
  if (charnum > maxSV1) fail("Unsupported max Symbol Value : too large");
  if (bitCount > 32) fail("Corrupted block detected");
  *maxSym = charnum - 1;
  ip += (bitCount + 7) >> 3;
  return (size_t)(ip - istart);
}

static size_t read_ncount(int16_t* norm, int* maxSym, int* tableLog, const uint8_t* src, size_t n) {
  if (n < 8) {
    uint8_t buf[8] = {0};
    if (n) std::memcpy(buf, src, n);
    size_t used = read_ncount_body(norm, maxSym, tableLog, buf, 8);
    if (used > n) fail("Corrupted block detected");
    return used;
  }
  return read_ncount_body(norm, maxSym, tableLog, src, n);
}

// ------------------------------------------------------------ Huffman
struct HufTable {
  int log = 0;
  std::vector<uint16_t> t;  // symbol | nbBits << 8
};

// FSE-compressed Huffman weights (FSE_decompress_wksp, max 255 outputs)
static size_t fse_weights(uint8_t* out, size_t cap, const uint8_t* src, size_t n) {
  int16_t norm[256];
  int maxSym = 255, log = 0;
  size_t h = read_ncount(norm, &maxSym, &log, src, n);
  if (log > 6) fail("tableLog requested is too large");
  src += h;
  n -= h;
  FseTable t;
  fse_build(norm, maxSym, log, t);
  BackBits b;
  b.init(src, n);
  uint32_t s1 = b.read(log), s2 = b.read(log);
  size_t op = 0;
  auto emit = [&](uint32_t& st) {
    const FseEntry& e = t.t[st];
    out[op++] = (uint8_t)e.symbol;
    st = e.base + b.read(e.nbBits);
  };
  for (;;) {
    if (op > cap - 2) fail("Destination buffer is too small");
    emit(s1);
    if (b.overflow()) {
      out[op++] = (uint8_t)t.t[s2].symbol;
      break;
    }
    if (op > cap - 2) fail("Destination buffer is too small");
    emit(s2);
    if (b.overflow()) {
      out[op++] = (uint8_t)t.t[s1].symbol;
      break;
    }
  }
  return op;
}

// HUF_readStats + table build; returns the bytes of the tree description
static size_t huf_read_table(HufTable& ht, const uint8_t* src, size_t n) {
  if (n == 0) fail("Src size is incorrect");
  uint8_t w[256 + 1] = {0};
  size_t iSize = src[0], oSize;
  if (iSize >= 128) {
    oSize = iSize - 127;
    iSize = (oSize + 1) / 2;
    if (iSize + 1 > n) fail("Src size is incorrect");
    if (oSize >= 256) fail("Corrupted block detected");
    for (size_t i = 0; i < oSize; i += 2) {
      w[i] = src[1 + i / 2] >> 4;
      w[i + 1] = src[1 + i / 2] & 15;
    }
  } else {
    if (iSize + 1 > n) fail("Src size is incorrect");
    oSize = fse_weights(w, 255, src + 1, iSize);
  }
  uint32_t rank[13] = {0}, total = 0;
  for (size_t i = 0; i < oSize; ++i) {
    if (w[i] > 12) fail("Corrupted block detected");
    rank[w[i]]++;
    total += (1u << w[i]) >> 1;
  }
  if (total == 0) fail("Corrupted block detected");
  int log = highbit(total) + 1;
  if (log > 12) fail("Corrupted block detected");
  uint32_t rest = (1u << log) - total;
  uint32_t verif = 1u << highbit(rest);
  if (verif != rest) fail("Corrupted block detected");
  int lastW = highbit(rest) + 1;
  w[oSize] = (uint8_t)lastW;
  rank[lastW]++;
  if (rank[1] < 2 || (rank[1] & 1)) fail("Corrupted block detected");
  size_t nsym = oSize + 1;
  uint32_t start[13] = {0}, acc = 0;
  for (int k = 1; k <= log; ++k) {
    start[k] = acc;
    acc += rank[k] << (k - 1);
  }
  ht.log = log;
  ht.t.assign(1u << log, 0);
  for (size_t s = 0; s < nsym; ++s) {
    int wt = w[s];
    if (!wt) continue;
    uint32_t len = 1u << (wt - 1);
    uint16_t e = (uint16_t)(s | ((log + 1 - wt) << 8));
    for (uint32_t i = 0; i < len; ++i) ht.t[start[wt] + i] = e;
    start[wt] += len;
  }
  return iSize + 1;
}

static void huf_stream(const HufTable& ht, const uint8_t* src, size_t n, uint8_t* out, size_t count) {
  BackBits b;
  b.init(src, n);
  const int log = ht.log;
  for (size_t i = 0; i < count; ++i) {
    uint16_t e = ht.t[b.peek(log)];
    out[i] = (uint8_t)e;
    b.pos += e >> 8;
  }
  if (!b.finished()) fail("Corrupted block detected");
}

static void huf_decode(const HufTable& ht, bool single, const uint8_t* src, size_t n, uint8_t* out,
                       size_t count) {
  if (single) {
    huf_stream(ht, src, n, out, count);
    return;
  }
  if (n < 10) fail("Corrupted block detected");
  if (count < 6) fail("Corrupted block detected");
  size_t l1 = rd16(src), l2 = rd16(src + 2), l3 = rd16(src + 4);
  if (l1 + l2 + l3 + 6 > n) fail("Corrupted block detected");
  size_t l4 = n - (l1 + l2 + l3 + 6);
  size_t seg = (count + 3) / 4;
  if (3 * seg > count) fail("Corrupted block detected");
  const uint8_t* p = src + 6;
  huf_stream(ht, p, l1, out, seg);
  huf_stream(ht, p + l1, l2, out + seg, seg);
  huf_stream(ht, p + l1 + l2, l3, out + 2 * seg, seg);
  huf_stream(ht, p + l1 + l2 + l3, l4, out + 3 * seg, count - 3 * seg);
}

// ------------------------------------------------------------- frames
struct SeqTable {
  int log = 0;
  struct E {
    uint32_t base;
    uint8_t extra;
    uint8_t nbBits;
    uint16_t next;
  };
  std::vector<E> t;
};

struct Decoder {
  uint8_t* dst;
  size_t cap, pos = 0, frameStart = 0, blockMax = BLOCK_MAX;
  uint32_t rep[3] = {1, 4, 8};
  bool haveHuf = false, haveSeq = false;
  HufTable huf;
  SeqTable seq[3];  // LL, OF, ML
  std::vector<uint8_t> lits;

  void build_seq(int which, const int16_t* norm, int maxSym, int log) {
    FseTable f;
    fse_build(norm, maxSym, log, f);
    SeqTable& st = seq[which];
    st.log = log;
    st.t.resize(f.t.size());
    for (size_t i = 0; i < f.t.size(); ++i) {
      uint32_t sym = f.t[i].symbol;
      SeqTable::E& e = st.t[i];
      e.nbBits = f.t[i].nbBits;
      e.next = f.t[i].base;
      if (which == 0) e.base = LL_BASE[sym], e.extra = LL_BITS[sym];
      else if (which == 2) e.base = ML_BASE[sym], e.extra = ML_BITS[sym];
      else e.base = sym, e.extra = (uint8_t)sym;  // offset code
    }
  }

  size_t literals(const uint8_t* src, size_t n) {
    if (n < 2) fail("Corrupted block detected");
    int type = src[0] & 3, sf = (src[0] >> 2) & 3;
    size_t lsize, csize = 0, hsize;
    if (type < 2) {
      switch (sf) {
        case 1: hsize = 2; lsize = rd16(src) >> 4; break;
        case 3:
          hsize = 3;
          if (n < 3) fail("Corrupted block detected");
          lsize = rd24(src) >> 4;
          break;
        default: hsize = 1; lsize = src[0] >> 3; break;
      }
      if (lsize > blockMax) fail("Corrupted block detected");
      if (type == 0) {
        if (lsize + hsize > n) fail("Corrupted block detected");
        lits.assign(src + hsize, src + hsize + lsize);
        return hsize + lsize;
      }
      if (hsize + 1 > n) fail("Corrupted block detected");
      lits.assign(lsize, src[hsize]);
      return hsize + 1;
    }
    if (n < 5) fail("Corrupted block detected");
    uint32_t lhc = rd32(src);
    bool single = false;
    switch (sf) {
      case 0: single = true; /* fall through */
      case 1:
        hsize = 3;
        lsize = (lhc >> 4) & 0x3FF;
        csize = (lhc >> 14) & 0x3FF;
        break;
      case 2:
        hsize = 4;
        lsize = (lhc >> 4) & 0x3FFF;
        csize = lhc >> 18;
        break;
      default:
        hsize = 5;
        lsize = (lhc >> 4) & 0x3FFFF;
        csize = (lhc >> 22) + ((size_t)src[4] << 10);
        break;
    }
    if (!single && lsize < 6) fail("Header of Literals' block doesn't respect format specification");
    if (lsize > blockMax) fail("Corrupted block detected");
    if (csize + hsize > n) fail("Corrupted block detected");
    const uint8_t* p = src + hsize;
    size_t cs = csize;
    if (type == 3) {
      if (!haveHuf) fail("Dictionary is corrupted");
    } else {
      if (cs == 0) fail("Corrupted block detected");
      size_t used = huf_read_table(huf, p, cs);
      if (used >= cs) fail("Src size is incorrect");
      p += used;
      cs -= used;
      haveHuf = true;
    }
    lits.resize(lsize);
    huf_decode(huf, single, p, cs, lits.data(), lsize);
    return hsize + csize;
  }

  void table(int which, int mode, const uint8_t*& ip, const uint8_t* iend) {
    static const int16_t* defaults[3] = {LL_DEFAULT, OF_DEFAULT, ML_DEFAULT};
    static const int defMax[3] = {35, 28, 52}, defLog[3] = {6, 5, 6}, maxSym[3] = {MAX_LL, MAX_OF, MAX_ML};
    switch (mode) {
      case 0: build_seq(which, defaults[which], defMax[which], defLog[which]); break;
      case 1: {
        if (ip >= iend) fail("Src size is incorrect");
        int sym = *ip++;
        if (sym > maxSym[which]) fail("Corrupted block detected");
        int16_t norm[64] = {0};
        norm[sym] = 1;
        build_seq(which, norm, sym, 0);
        break;
      }
      case 2: {
        int16_t norm[64];
        int ms = maxSym[which], log = 0;
        size_t h;
        try {
          h = read_ncount(norm, &ms, &log, ip, (size_t)(iend - ip));
        } catch (const Error&) {
          fail("Corrupted block detected");
        }
        if (log > MAX_LOG[which]) fail("Corrupted block detected");
        build_seq(which, norm, ms, log);
        ip += h;
        break;
      }
      default:
        if (!haveSeq) fail("Corrupted block detected");
        break;
    }
  }

  void block(const uint8_t* src, size_t n) {
    if (n > blockMax) fail("Src size is incorrect");
    size_t used = literals(src, n);
    const uint8_t* ip = src + used;
    const uint8_t* iend = src + n;
    size_t room = std::min(blockMax, cap - pos);
    if (lits.size() > room) fail("Destination buffer is too small");
    if (ip >= iend) fail("Src size is incorrect");
    size_t nbSeq = *ip++;
    if (nbSeq > 0x7F) {
      if (nbSeq == 0xFF) {
        if (ip + 2 > iend) fail("Src size is incorrect");
        nbSeq = rd16(ip) + 0x7F00;
        ip += 2;
      } else {
        if (ip >= iend) fail("Src size is incorrect");
        nbSeq = ((nbSeq - 0x80) << 8) + *ip++;
      }
    }
    if (nbSeq == 0) {
      if (ip != iend) fail("Corrupted block detected");
    } else {
      if (ip + 1 > iend) fail("Src size is incorrect");
      uint8_t modes = *ip++;
      if (modes & 3) fail("Corrupted block detected");
      table(0, modes >> 6, ip, iend);
      table(1, (modes >> 4) & 3, ip, iend);
      table(2, (modes >> 2) & 3, ip, iend);
      haveSeq = true;
    }
    size_t lp = 0, op = pos;
    const size_t oend = pos + room;
    if (nbSeq) {
      BackBits b;
      b.init(ip, (size_t)(iend - ip));
      uint32_t sLL = b.read(seq[0].log), sOF = b.read(seq[1].log), sML = b.read(seq[2].log);
      for (size_t i = 0; i < nbSeq; ++i) {
        const SeqTable::E &eLL = seq[0].t[sLL], &eOF = seq[1].t[sOF], &eML = seq[2].t[sML];
        uint32_t ofCode = eOF.extra;
        uint64_t offset;
        uint32_t ll0 = eLL.base == 0;
        if (ofCode > 1) {
          offset = ((uint64_t)1 << ofCode) + b.read(ofCode) - 3;
          rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = (uint32_t)offset;
        } else if (ofCode == 0) {
          offset = rep[ll0];
          rep[1] = rep[!ll0];
          rep[0] = (uint32_t)offset;
        } else {
          uint32_t idx = 1 + ll0 + b.read(1);
          uint64_t temp = idx == 3 ? (uint64_t)rep[0] - 1 : rep[idx];
          if (temp == 0) temp = UINT64_MAX;
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = (uint32_t)temp;
          offset = temp;
        }
        uint64_t ml = eML.base + (uint64_t)b.read(eML.extra);
        uint64_t ll = eLL.base + (uint64_t)b.read(eLL.extra);
        if (i + 1 < nbSeq) {
          sLL = eLL.next + b.read(eLL.nbBits);
          sML = eML.next + b.read(eML.nbBits);
          sOF = eOF.next + b.read(eOF.nbBits);
        }
        if (op + ll + ml > oend) fail("Destination buffer is too small");
        if (lp + ll > lits.size()) fail("Corrupted block detected");
        std::memcpy(dst + op, lits.data() + lp, ll);
        op += ll;
        lp += ll;
        if (offset > op - frameStart) fail("Corrupted block detected");
        uint8_t* d = dst + op;
        const uint8_t* s = d - offset;
        if (offset >= ml) std::memcpy(d, s, ml);
        else
          for (uint64_t k = 0; k < ml; ++k) d[k] = s[k];
        op += ml;
      }
      if (!b.finished()) fail("Corrupted block detected");
    }
    size_t last = lits.size() - lp;
    if (op + last > oend) fail("Destination buffer is too small");
    std::memcpy(dst + op, lits.data() + lp, last);
    pos = op + last;
  }

  // one frame at src; returns the bytes it took
  size_t frame(const uint8_t* src, size_t n, uint64_t* declared) {
    if (n < 4) fail("Src size is incorrect");
    uint32_t magic = rd32(src);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n < 8) fail("Src size is incorrect");
      uint64_t len = rd32(src + 4);
      if (8 + len > n) fail("Src size is incorrect");
      *declared = 0;
      return (size_t)(8 + len);
    }
    if (magic != 0xFD2FB528u) fail("Unknown frame descriptor");
    if (n < 5) fail("Src size is incorrect");
    uint8_t fhd = src[4];
    int fcsFlag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, didFlag = fhd & 3;
    if (fhd & 0x08) fail("Unsupported frame parameter");
    size_t hsize = 5 + !single + (didFlag ? (1 << (didFlag - 1)) : 0) +
                   (fcsFlag ? (1 << fcsFlag) : single);
    if (hsize > n) fail("Src size is incorrect");
    const uint8_t* ip = src + 5;
    uint64_t window = 0;
    if (!single) {
      uint8_t wd = *ip++;
      int wlog = (wd >> 3) + 10;
      if (wlog > 31) fail("Frame requires too much memory for decoding");
      uint64_t base = 1ULL << wlog;
      window = base + (base / 8) * (wd & 7);
    }
    uint32_t dictId = 0;
    if (didFlag) {
      int sz = 1 << (didFlag - 1);
      for (int i = 0; i < sz; ++i) dictId |= (uint32_t)ip[i] << (8 * i);
      ip += sz;
    }
    uint64_t fcs = UINT64_MAX;
    switch (fcsFlag) {
      case 0: if (single) fcs = *ip++; break;
      case 1: fcs = rd16(ip) + 256; ip += 2; break;
      case 2: fcs = rd32(ip); ip += 4; break;
      default: fcs = rd64(ip); ip += 8; break;
    }
    if (single) window = fcs;
    if (dictId != 0) fail("Dictionary mismatch");
    *declared = fcs;
    if (fcs != UINT64_MAX && fcs > cap - pos)
      fail("Destination buffer is too small");
    blockMax = (size_t)std::min<uint64_t>(window, BLOCK_MAX);
    frameStart = pos;
    rep[0] = 1, rep[1] = 4, rep[2] = 8;
    haveHuf = haveSeq = false;
    const uint8_t* iend = src + n;
    for (;;) {
      if (ip + 3 > iend) fail("Src size is incorrect");
      uint32_t bh = rd24(ip);
      ip += 3;
      int last = bh & 1, type = (bh >> 1) & 3;
      size_t bsize = bh >> 3;
      if (type == 3) fail("Corrupted block detected");
      size_t csize = type == 1 ? 1 : bsize;
      if (ip + csize > iend) fail("Src size is incorrect");
      if (type == 0) {
        if (bsize > cap - pos) fail("Destination buffer is too small");
        std::memcpy(dst + pos, ip, bsize);
        pos += bsize;
      } else if (type == 1) {
        if (bsize > std::min(blockMax, cap - pos)) fail("Destination buffer is too small");
        std::memset(dst + pos, *ip, bsize);
        pos += bsize;
      } else {
        block(ip, bsize);
      }
      ip += csize;
      if (last) break;
    }
    if (fcs != UINT64_MAX && pos - frameStart != fcs) fail("Corrupted block detected");
    if (checksum) {
      if (ip + 4 > iend) fail("Restored data doesn't match checksum");
      uint32_t want = rd32(ip);
      uint32_t got = (uint32_t)xxh64(dst + frameStart, pos - frameStart);
      if (want != got) fail("Restored data doesn't match checksum");
      ip += 4;
    }
    return (size_t)(ip - src);
  }
};

// ------------------------------------------------------------ encoder
struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int n = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void add(uint64_t v, int nb) {
    if (nb == 0) return;
    acc |= (v & ((1ULL << nb) - 1)) << n;
    n += nb;
    while (n >= 8) {
      out.push_back((uint8_t)acc);
      acc >>= 8;
      n -= 8;
    }
  }
  void close() {  // the 1-bit end marker, then the last partial byte
    add(1, 1);
    if (n) out.push_back((uint8_t)acc);
    acc = 0;
    n = 0;
  }
};

struct CTable {
  int log = 0;
  std::vector<uint16_t> state;
  std::vector<int32_t> findState;
  std::vector<uint32_t> deltaNb;
};

static void fse_ctable(const int16_t* norm, int maxSym, int log, CTable& ct) {
  uint32_t size = 1u << log;
  std::vector<uint16_t> symbols;
  fse_spread(norm, maxSym, log, symbols);
  std::vector<uint32_t> cumul(maxSym + 2);
  cumul[0] = 0;
  for (int s = 1; s <= maxSym + 1; ++s)
    cumul[s] = cumul[s - 1] + (norm[s - 1] == -1 ? 1 : (uint32_t)std::max<int>(norm[s - 1], 0));
  ct.log = log;
  ct.state.assign(size, 0);
  for (uint32_t u = 0; u < size; ++u) ct.state[cumul[symbols[u]]++] = (uint16_t)(size + u);
  ct.findState.assign(maxSym + 1, 0);
  ct.deltaNb.assign(maxSym + 1, 0);
  int total = 0;
  for (int s = 0; s <= maxSym; ++s) {
    int c = norm[s];
    if (c == 0) {
      ct.deltaNb[s] = ((uint32_t)(log + 1) << 16) - size;
    } else if (c == 1 || c == -1) {
      ct.deltaNb[s] = ((uint32_t)log << 16) - size;
      ct.findState[s] = total - 1;
      total++;
    } else {
      uint32_t maxOut = log - highbit((uint32_t)c - 1);
      uint32_t minPlus = (uint32_t)c << maxOut;
      ct.deltaNb[s] = (maxOut << 16) - minPlus;
      ct.findState[s] = total - c;
      total += c;
    }
  }
}

struct CState {
  const CTable* ct = nullptr;
  uint32_t value = 0;
  void init(const CTable& t, int sym) {
    ct = &t;
    uint32_t nbOut = (t.deltaNb[sym] + (1 << 15)) >> 16;
    uint32_t v = (nbOut << 16) - t.deltaNb[sym];
    value = t.state[(int32_t)(v >> nbOut) + t.findState[sym]];
  }
  void encode(BitWriter& w, int sym) {
    uint32_t nbOut = (value + ct->deltaNb[sym]) >> 16;
    w.add(value, nbOut);
    value = ct->state[(int32_t)(value >> nbOut) + ct->findState[sym]];
  }
  void flush(BitWriter& w) { w.add(value, ct->log); }
};

// counts -> normalized counts summing to 1 << log (no -1 entries)
static void normalize(const uint32_t* count, int maxSym, uint32_t total, int log, int16_t* norm) {
  int32_t size = 1 << log, sum = 0, big = 0;
  for (int s = 0; s <= maxSym; ++s) {
    if (!count[s]) {
      norm[s] = 0;
      continue;
    }
    int32_t v = (int32_t)(((uint64_t)count[s] * size + total / 2) / total);
    if (v < 1) v = 1;
    norm[s] = (int16_t)v;
    sum += v;
    if (norm[s] > norm[big] || !count[big]) big = s;
  }
  while (sum > size) {  // take from the largest counts that can spare one
    int pick = -1;
    for (int s = 0; s <= maxSym; ++s)
      if (norm[s] > 1 && (pick < 0 || norm[s] > norm[pick])) pick = s;
    int32_t take = std::min<int32_t>(sum - size, norm[pick] - 1);
    take = std::max<int32_t>(1, std::min<int32_t>(take, norm[pick] / 2));
    norm[pick] -= (int16_t)take;
    sum -= take;
  }
  norm[big] += (int16_t)(size - sum);
}

static void write_ncount(const int16_t* norm, int maxSym, int log, std::vector<uint8_t>& out) {
  BitWriter w(out);
  w.add(log - 5, 4);
  int remaining = (1 << log) + 1, threshold = 1 << log, nbBits = log + 1;
  int symbol = 0, alphabet = maxSym + 1;
  bool previous0 = false;
  while (symbol < alphabet && remaining > 1) {
    if (previous0) {
      int start = symbol;
      while (symbol < alphabet && !norm[symbol]) symbol++;
      while (symbol >= start + 3) {
        start += 3;
        w.add(3, 2);
      }
      w.add(symbol - start, 2);
    }
    int count = norm[symbol++];
    int max = (2 * threshold - 1) - remaining;
    remaining -= count < 0 ? -count : count;
    count++;
    if (count >= threshold) count += max;
    w.add(count, nbBits - (count < max));
    previous0 = count == 1;
    while (remaining < threshold) {
      nbBits--;
      threshold >>= 1;
    }
  }
  if (w.n) out.push_back((uint8_t)w.acc);
}

// Huffman code lengths limited to 11 bits (counts halved until they fit)
static int huf_lengths(const uint32_t* count0, int maxSym, uint8_t* len) {
  std::vector<uint32_t> count(count0, count0 + maxSym + 1);
  for (;;) {
    struct Node {
      uint64_t w;
      int a, b;
    };
    std::vector<Node> nodes;
    std::vector<int> heap;
    auto cmp = [&](int x, int y) { return nodes[x].w > nodes[y].w || (nodes[x].w == nodes[y].w && x > y); };
    for (int s = 0; s <= maxSym; ++s)
      if (count[s]) {
        nodes.push_back({count[s], -1, s});
        heap.push_back((int)nodes.size() - 1);
      }
    std::make_heap(heap.begin(), heap.end(), cmp);
    while (heap.size() > 1) {
      std::pop_heap(heap.begin(), heap.end(), cmp);
      int x = heap.back();
      heap.pop_back();
      std::pop_heap(heap.begin(), heap.end(), cmp);
      int y = heap.back();
      heap.pop_back();
      nodes.push_back({nodes[x].w + nodes[y].w, x, y});
      heap.push_back((int)nodes.size() - 1);
      std::push_heap(heap.begin(), heap.end(), cmp);
    }
    std::memset(len, 0, maxSym + 1);
    int maxLen = 0;
    std::vector<std::pair<int, int>> stack = {{heap[0], 0}};
    while (!stack.empty()) {
      auto [i, d] = stack.back();
      stack.pop_back();
      if (nodes[i].a < 0) {
        len[nodes[i].b] = (uint8_t)d;
        maxLen = std::max(maxLen, d);
      } else {
        stack.push_back({nodes[i].a, d + 1});
        stack.push_back({nodes[i].b, d + 1});
      }
    }
    if (maxLen <= 11) return maxLen;
    for (auto& c : count)
      if (c) c = (c + 1) / 2;
  }
}

struct HufCode {
  int log = 0, maxSym = 0;
  uint16_t code[256];
  uint8_t nb[256];
  std::vector<uint8_t> header;
};

// a Huffman code for the literals, or false where it cannot be described
// with direct weights (maxSym > 128) or has one symbol only
static bool huf_build(const uint8_t* lits, size_t n, HufCode& hc) {
  uint32_t count[256] = {0};
  for (size_t i = 0; i < n; ++i) count[lits[i]]++;
  int maxSym = 255, distinct = 0;
  while (maxSym > 0 && !count[maxSym]) maxSym--;
  for (int s = 0; s <= maxSym; ++s) distinct += count[s] != 0;
  if (distinct < 2 || maxSym > 128) return false;
  uint8_t len[256];
  int log = huf_lengths(count, maxSym, len);
  hc.log = log;
  hc.maxSym = maxSym;
  uint8_t w[256];
  uint32_t rank[13] = {0};
  for (int s = 0; s <= maxSym; ++s) {
    w[s] = len[s] ? (uint8_t)(log + 1 - len[s]) : 0;
    rank[w[s]]++;
  }
  uint32_t start[13] = {0}, acc = 0;
  for (int k = 1; k <= log; ++k) {
    start[k] = acc;
    acc += rank[k] << (k - 1);
  }
  for (int s = 0; s <= maxSym; ++s) {
    hc.nb[s] = len[s];
    if (!w[s]) continue;
    hc.code[s] = (uint16_t)(start[w[s]] >> (w[s] - 1));
    start[w[s]] += 1u << (w[s] - 1);
  }
  hc.header.clear();
  hc.header.push_back((uint8_t)(127 + maxSym));
  for (int s = 0; s < maxSym; s += 2)
    hc.header.push_back((uint8_t)((w[s] << 4) | (s + 1 < maxSym ? w[s + 1] : 0)));
  return true;
}

static void huf_encode_stream(const HufCode& hc, const uint8_t* p, size_t n, std::vector<uint8_t>& out) {
  BitWriter w(out);
  for (size_t i = n; i-- > 0;) w.add(hc.code[p[i]], hc.nb[p[i]]);
  w.close();
}

static void put_raw_lits_header(std::vector<uint8_t>& o, int type, size_t n) {
  if (n < 32) {
    o.push_back((uint8_t)(type | (n << 3)));
  } else if (n < 4096) {
    uint32_t v = type | (1 << 2) | (uint32_t)(n << 4);
    o.push_back((uint8_t)v);
    o.push_back((uint8_t)(v >> 8));
  } else {
    uint32_t v = type | (3 << 2) | (uint32_t)(n << 4);
    o.push_back((uint8_t)v);
    o.push_back((uint8_t)(v >> 8));
    o.push_back((uint8_t)(v >> 16));
  }
}

static void encode_literals(const uint8_t* lits, size_t n, std::vector<uint8_t>& o) {
  bool same = n > 0;
  for (size_t i = 1; i < n && same; ++i) same = lits[i] == lits[0];
  if (same && n > 2) {
    put_raw_lits_header(o, 1, n);
    o.push_back(lits[0]);
    return;
  }
  HufCode hc;
  if (n >= 32 && huf_build(lits, n, hc)) {
    std::vector<uint8_t> body(hc.header);
    bool single = n <= 1023;
    if (single) {
      huf_encode_stream(hc, lits, n, body);
    } else {
      size_t seg = (n + 3) / 4;
      size_t jump = body.size();
      body.resize(jump + 6);
      size_t sizes[4];
      for (int k = 0; k < 4; ++k) {
        size_t b = std::min(n, k * seg), e = std::min(n, (k + 1) * seg);
        if (k == 3) e = n;
        size_t before = body.size();
        huf_encode_stream(hc, lits + b, e - b, body);
        sizes[k] = body.size() - before;
      }
      for (int k = 0; k < 3; ++k) {
        if (sizes[k] > 0xFFFF) single = true;
        body[jump + 2 * k] = (uint8_t)sizes[k];
        body[jump + 2 * k + 1] = (uint8_t)(sizes[k] >> 8);
      }
    }
    size_t cs = body.size();
    int sf;
    size_t hs;
    if (single && n <= 1023 && cs <= 1023) sf = 0, hs = 3;
    else if (!single && n <= 1023 && cs <= 1023) sf = 1, hs = 3;
    else if (!single && n <= 16383 && cs <= 16383) sf = 2, hs = 4;
    else if (!single && n <= 262143 && cs <= 262143) sf = 3, hs = 5;
    else sf = -1, hs = 0;
    size_t rawCost = n + (n < 32 ? 1 : n < 4096 ? 2 : 3);
    if (sf >= 0 && cs + hs < rawCost) {
      uint64_t v = 2 | (sf << 2);
      if (hs == 3) v |= ((uint64_t)n << 4) | ((uint64_t)cs << 14);
      else if (hs == 4) v |= ((uint64_t)n << 4) | ((uint64_t)cs << 18);
      else v |= ((uint64_t)n << 4) | ((uint64_t)cs << 22);
      for (size_t k = 0; k < hs; ++k) o.push_back((uint8_t)(v >> (8 * k)));
      o.insert(o.end(), body.begin(), body.end());
      return;
    }
  }
  put_raw_lits_header(o, 0, n);
  o.insert(o.end(), lits, lits + n);
}

struct Seq {
  uint32_t ll, ml, off;  // literal length, match length, offset value (offset + 3)
};

static double table_cost(const uint32_t* count, int maxSym, const int16_t* norm, int log) {
  double bits = 0;
  for (int s = 0; s <= maxSym; ++s) {
    if (!count[s]) continue;
    int n = norm[s] == -1 ? 1 : norm[s];
    if (n <= 0) return 1e300;
    bits += count[s] * (log - std::log2((double)n));
  }
  return bits;
}

static void encode_sequences(const std::vector<Seq>& seqs, std::vector<uint8_t>& o) {
  size_t nb = seqs.size();
  if (nb < 128) {
    o.push_back((uint8_t)nb);
  } else if (nb < 0x7F00) {
    o.push_back((uint8_t)((nb >> 8) + 0x80));
    o.push_back((uint8_t)nb);
  } else {
    o.push_back(0xFF);
    o.push_back((uint8_t)(nb - 0x7F00));
    o.push_back((uint8_t)((nb - 0x7F00) >> 8));
  }
  if (!nb) return;
  std::vector<uint8_t> codes[3];  // LL, OF, ML
  for (auto& c : codes) c.resize(nb);
  uint32_t count[3][64] = {{0}};
  for (size_t i = 0; i < nb; ++i) {
    codes[0][i] = (uint8_t)ll_code(seqs[i].ll);
    codes[1][i] = (uint8_t)highbit(seqs[i].off);
    codes[2][i] = (uint8_t)ml_code(seqs[i].ml);
    for (int k = 0; k < 3; ++k) count[k][codes[k][i]]++;
  }
  static const int16_t* defaults[3] = {LL_DEFAULT, OF_DEFAULT, ML_DEFAULT};
  static const int defMax[3] = {35, 28, 52}, defLog[3] = {6, 5, 6};
  CTable ct[3];
  int mode[3];
  std::vector<uint8_t> headers;
  for (int k = 0; k < 3; ++k) {
    int maxSym = 63;
    while (!count[k][maxSym]) maxSym--;
    int distinct = 0;
    for (int s = 0; s <= maxSym; ++s) distinct += count[k][s] != 0;
    if (distinct == 1) {
      mode[k] = 1;
      headers.push_back((uint8_t)maxSym);
      continue;
    }
    double pre = maxSym <= defMax[k] ? table_cost(count[k], maxSym, defaults[k], defLog[k]) : 1e300;
    int log = std::min(MAX_LOG[k], std::max(5, highbit((uint32_t)nb) + 1));
    log = std::max(log, std::min(MAX_LOG[k], highbit((uint32_t)distinct) + 2));
    int16_t norm[64];
    normalize(count[k], maxSym, (uint32_t)nb, log, norm);
    std::vector<uint8_t> h;
    write_ncount(norm, maxSym, log, h);
    double comp = table_cost(count[k], maxSym, norm, log) + 8.0 * h.size();
    if (pre <= comp) {
      mode[k] = 0;
      fse_ctable(defaults[k], defMax[k], defLog[k], ct[k]);
    } else {
      mode[k] = 2;
      fse_ctable(norm, maxSym, log, ct[k]);
      headers.insert(headers.end(), h.begin(), h.end());
    }
  }
  o.push_back((uint8_t)((mode[0] << 6) | (mode[1] << 4) | (mode[2] << 2)));
  o.insert(o.end(), headers.begin(), headers.end());
  BitWriter w(o);
  CState st[3];
  size_t last = nb - 1;
  auto extras = [&](size_t i) {
    int lc = codes[0][i], mc = codes[2][i], oc = codes[1][i];
    w.add(seqs[i].ll - LL_BASE[lc], LL_BITS[lc]);
    w.add(seqs[i].ml - ML_BASE[mc], ML_BITS[mc]);
    w.add(seqs[i].off, oc);
  };
  // init order ML, OF, LL (the reverse of the decoder's LL, OF, ML reads)
  if (mode[2] != 1) st[2].init(ct[2], codes[2][last]);
  if (mode[1] != 1) st[1].init(ct[1], codes[1][last]);
  if (mode[0] != 1) st[0].init(ct[0], codes[0][last]);
  extras(last);
  for (size_t i = last; i-- > 0;) {
    if (mode[1] != 1) st[1].encode(w, codes[1][i]);
    if (mode[2] != 1) st[2].encode(w, codes[2][i]);
    if (mode[0] != 1) st[0].encode(w, codes[0][i]);
    extras(i);
  }
  if (mode[2] != 1) st[2].flush(w);
  if (mode[1] != 1) st[1].flush(w);
  if (mode[0] != 1) st[0].flush(w);
  w.close();
}

// greedy matching over one block; `base` is the frame's first byte
static void compress_block(const uint8_t* base, size_t begin, size_t end, std::vector<uint32_t>& hash,
                           std::vector<uint8_t>& out) {
  const int HBITS = 17;
  std::vector<Seq> seqs;
  std::vector<uint8_t> lits;
  size_t i = begin, anchor = begin;
  uint32_t misses = 0;
  auto h4 = [&](size_t p) { return (rd32(base + p) * 2654435761u) >> (32 - HBITS); };
  while (i + 8 <= end) {
    uint32_t h = h4(i);
    size_t cand = hash[h];
    hash[h] = (uint32_t)(i + 1);
    if (cand && cand - 1 < i && rd32(base + cand - 1) == rd32(base + i)) {
      size_t c = cand - 1, len = 4;
      while (i + len < end && base[c + len] == base[i + len]) len++;
      len = std::min<size_t>(len, 131074);
      lits.insert(lits.end(), base + anchor, base + i);
      seqs.push_back({(uint32_t)(i - anchor), (uint32_t)len, (uint32_t)(i - c + 3)});
      size_t stop = i + len;
      for (size_t p = i + 1; p + 8 <= end && p < stop; p += 2) hash[h4(p)] = (uint32_t)(p + 1);
      i = anchor = stop;
      misses = 0;
    } else {
      i += 1 + (misses++ >> 5);
    }
  }
  lits.insert(lits.end(), base + anchor, base + end);
  encode_literals(lits.data(), lits.size(), out);
  encode_sequences(seqs, out);
}

static std::vector<uint8_t> compress(const uint8_t* src, size_t n) {
  std::vector<uint8_t> out = {0x28, 0xB5, 0x2F, 0xFD};
  int fcsFlag = n < 256 ? 0 : n < 65536 + 256 ? 1 : n <= 0xFFFFFFFFu ? 2 : 3;
  out.push_back((uint8_t)((fcsFlag << 6) | (1 << 5)));
  if (fcsFlag == 0) out.push_back((uint8_t)n);
  else if (fcsFlag == 1) {
    out.push_back((uint8_t)(n - 256));
    out.push_back((uint8_t)((n - 256) >> 8));
  } else {
    for (int k = 0; k < (fcsFlag == 2 ? 4 : 8); ++k) out.push_back((uint8_t)((uint64_t)n >> (8 * k)));
  }
  std::vector<uint32_t> hash(1u << 17, 0);
  size_t pos = 0;
  do {
    size_t len = std::min(BLOCK_MAX, n - pos);
    bool last = pos + len == n;
    bool same = len > 0;
    for (size_t i = 1; i < len && same; ++i) same = src[pos + i] == src[pos];
    std::vector<uint8_t> body;
    int type = 0;
    if (same && len > 1) {
      type = 1;
      body.push_back(src[pos]);
    } else if (len >= 64) {
      compress_block(src, pos, pos + len, hash, body);
      if (body.size() < len) type = 2;
    }
    if (type == 0) body.assign(src + pos, src + pos + len);
    // the size field: the compressed size of a compressed block, else the content's
    uint32_t bh = (uint32_t)last | (type << 1) | (uint32_t)((type == 2 ? body.size() : len) << 3);
    out.push_back((uint8_t)bh);
    out.push_back((uint8_t)(bh >> 8));
    out.push_back((uint8_t)(bh >> 16));
    out.insert(out.end(), body.begin(), body.end());
    pos += len;
  } while (pos < n);
  return out;
}

}  // namespace tmzstd

extern "C" {

const char* tm_zstd_error() { return tmzstd::g_error.c_str(); }

// content size of the first frame: >= 0, -1 when not declared, -2 on error
int64_t tm_zstd_frame_content_size(const uint8_t* src, int64_t n) {
  using namespace tmzstd;
  if (n < 4) return -2;
  uint32_t magic = rd32(src);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) return n >= 8 ? 0 : -2;
  if (magic != 0xFD2FB528u || n < 5) return -2;
  uint8_t fhd = src[4];
  int fcsFlag = fhd >> 6, single = (fhd >> 5) & 1, didFlag = fhd & 3;
  if (fhd & 0x08) return -2;
  int64_t hsize = 5 + !single + (didFlag ? (1 << (didFlag - 1)) : 0) + (fcsFlag ? (1 << fcsFlag) : single);
  if (hsize > n) return -2;
  if (!single && ((src[5] >> 3) + 10) > 31) return -2;
  const uint8_t* p = src + 5 + !single + (didFlag ? (1 << (didFlag - 1)) : 0);
  switch (fcsFlag) {
    case 0: return single ? (int64_t)*p : -1;
    case 1: return (int64_t)rd16(p) + 256;
    case 2: return (int64_t)rd32(p);
    default: {
      uint64_t v = rd64(p);
      return v > (uint64_t)INT64_MAX ? -2 : (int64_t)v;
    }
  }
}

// decode into dst[0:cap]: every frame back to back (all_frames) or the
// first frame only; returns the bytes written, -1 on error
int64_t tm_zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, int32_t all_frames) {
  using namespace tmzstd;
  try {
    Decoder d;
    d.dst = dst;
    d.cap = (size_t)cap;
    size_t at = 0;
    do {
      uint64_t declared = 0;
      at += d.frame(src + at, (size_t)n - at, &declared);
    } while (all_frames && at < (size_t)n);
    return (int64_t)d.pos;
  } catch (const std::exception& e) {
    g_error = e.what();
    return -1;
  }
}

// one frame of src with its content size; returns its length, or the
// length needed when cap is too small, -1 on error
int64_t tm_zstd_compress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  using namespace tmzstd;
  try {
    std::vector<uint8_t> out = compress(src, (size_t)n);
    if ((int64_t)out.size() <= cap) std::memcpy(dst, out.data(), out.size());
    return (int64_t)out.size();
  } catch (const std::exception& e) {
    g_error = e.what();
    return -1;
  }
}

}  // extern "C"
