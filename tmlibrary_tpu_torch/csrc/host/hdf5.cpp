// hdf5.cpp: the byte loops of the port's HDF5 code
// (tmlibrary_tpu_torch/io/hdf5.py).
//
// - Jenkins' lookup3 ``hashlittle`` with an initial value, which HDF5
//   uses (``H5_checksum_lookup3``) for the checksums of its version-2
//   metadata: superblocks 2/3, object headers 2, fractal heaps, v2
//   B-trees, fixed and extensible arrays, and as the hash of link and
//   attribute names in dense storage.
// - LZF (Marc Lehmann's format, as h5py's ``lzf`` filter 32000 stores a
//   chunk): literal runs of 1-32 bytes (control byte < 32) and back
//   references of 3-264 bytes at a distance of 1-8192.  The decoder
//   bounds every read by the input and every write by the caller's
//   capacity; the encoder is a greedy matcher over a hash of three
//   bytes and reports a stream that would not shrink the input.
//
// Built into the port's host library (tmlibrary_tpu_torch/native.py),
// bound with ctypes.  C ABI only.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint32_t rot(uint32_t x, int k) { return (x << k) | (x >> (32 - k)); }

inline void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  a -= c; a ^= rot(c, 4);  c += b;
  b -= a; b ^= rot(a, 6);  a += c;
  c -= b; c ^= rot(b, 8);  b += a;
  a -= c; a ^= rot(c, 16); c += b;
  b -= a; b ^= rot(a, 19); a += c;
  c -= b; c ^= rot(b, 4);  b += a;
}

inline void final_mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  c ^= b; c -= rot(b, 14);
  a ^= c; a -= rot(c, 11);
  b ^= a; b -= rot(a, 25);
  c ^= b; c -= rot(b, 16);
  a ^= c; a -= rot(c, 4);
  b ^= a; b -= rot(a, 14);
  c ^= b; c -= rot(b, 24);
}

}  // namespace

extern "C" {

// HDF5's H5_checksum_lookup3: hashlittle over bytes, in byte order.
uint32_t tm_lookup3(const uint8_t* k, int64_t length, uint32_t initval) {
  uint32_t a, b, c;
  a = b = c = 0xdeadbeefu + static_cast<uint32_t>(length) + initval;
  while (length > 12) {
    a += k[0] + (uint32_t(k[1]) << 8) + (uint32_t(k[2]) << 16) + (uint32_t(k[3]) << 24);
    b += k[4] + (uint32_t(k[5]) << 8) + (uint32_t(k[6]) << 16) + (uint32_t(k[7]) << 24);
    c += k[8] + (uint32_t(k[9]) << 8) + (uint32_t(k[10]) << 16) + (uint32_t(k[11]) << 24);
    mix(a, b, c);
    length -= 12;
    k += 12;
  }
  switch (length) {
    case 12: c += uint32_t(k[11]) << 24; [[fallthrough]];
    case 11: c += uint32_t(k[10]) << 16; [[fallthrough]];
    case 10: c += uint32_t(k[9]) << 8; [[fallthrough]];
    case 9: c += k[8]; [[fallthrough]];
    case 8: b += uint32_t(k[7]) << 24; [[fallthrough]];
    case 7: b += uint32_t(k[6]) << 16; [[fallthrough]];
    case 6: b += uint32_t(k[5]) << 8; [[fallthrough]];
    case 5: b += k[4]; [[fallthrough]];
    case 4: a += uint32_t(k[3]) << 24; [[fallthrough]];
    case 3: a += uint32_t(k[2]) << 16; [[fallthrough]];
    case 2: a += uint32_t(k[1]) << 8; [[fallthrough]];
    case 1: a += k[0]; break;
    case 0: return c;
  }
  final_mix(a, b, c);
  return c;
}

// LZF decode of src[0:n] into out[0:cap]: the number of bytes written, -1
// for a damaged stream (a reference before the start of the output or a
// run past the end of the input), -2 when the output would exceed cap.
int64_t tm_lzf_decompress(const uint8_t* src, int64_t n, uint8_t* out, int64_t cap) {
  int64_t ip = 0, op = 0;
  while (ip < n) {
    uint32_t ctrl = src[ip++];
    if (ctrl < 32) {
      int64_t run = ctrl + 1;
      if (ip + run > n) return -1;
      if (op + run > cap) return -2;
      std::memcpy(out + op, src + ip, run);
      ip += run;
      op += run;
    } else {
      int64_t len = ctrl >> 5;
      if (len == 7) {
        if (ip >= n) return -1;
        len += src[ip++];
      }
      if (ip >= n) return -1;
      int64_t back = ((int64_t(ctrl & 0x1f) << 8) | src[ip++]) + 1;
      len += 2;
      if (back > op) return -1;
      if (op + len > cap) return -2;
      const uint8_t* ref = out + op - back;
      for (int64_t i = 0; i < len; ++i) out[op + i] = ref[i];  // runs may overlap
      op += len;
    }
  }
  return op;
}

// LZF encode of src[0:n] into out[0:cap]: the number of bytes written, or
// 0 when the stream would not fit in cap (h5py's filter then stores the
// chunk as it is).
int64_t tm_lzf_compress(const uint8_t* src, int64_t n, uint8_t* out, int64_t cap) {
  constexpr int kHashBits = 16;
  constexpr int64_t kMaxOff = 1 << 13, kMaxRef = (1 << 8) + (1 << 3), kMaxLit = 1 << 5;
  if (n == 0) return 0;
  std::vector<int64_t> table(size_t(1) << kHashBits, -1);
  int64_t ip = 0, op = 0, lit = 0, lit_at = 0;
  auto flush = [&]() -> bool {  // the pending literal run
    while (lit > 0) {
      int64_t run = lit < kMaxLit ? lit : kMaxLit;
      if (op + 1 + run > cap) return false;
      out[op++] = uint8_t(run - 1);
      std::memcpy(out + op, src + lit_at, run);
      op += run;
      lit_at += run;
      lit -= run;
    }
    return true;
  };
  while (ip < n) {
    int64_t ref = -1;
    if (ip + 2 < n) {
      uint32_t h = (uint32_t(src[ip]) << 16) | (uint32_t(src[ip + 1]) << 8) | src[ip + 2];
      h = (h * 2654435761u) >> (32 - kHashBits);
      ref = table[h];
      table[h] = ip;
      if (ref >= 0 && (ip - ref > kMaxOff || src[ref] != src[ip] || src[ref + 1] != src[ip + 1] ||
                       src[ref + 2] != src[ip + 2]))
        ref = -1;
    }
    if (ref < 0) {
      if (lit == 0) lit_at = ip;
      ++lit;
      ++ip;
      continue;
    }
    int64_t len = 3, most = n - ip < kMaxRef ? n - ip : kMaxRef;
    while (len < most && src[ref + len] == src[ip + len]) ++len;
    if (!flush()) return 0;
    int64_t off = ip - ref - 1, l = len - 2;
    if (op + 3 > cap) return 0;
    if (l < 7) {
      out[op++] = uint8_t((l << 5) | (off >> 8));
    } else {
      out[op++] = uint8_t((7 << 5) | (off >> 8));
      out[op++] = uint8_t(l - 7);
    }
    out[op++] = uint8_t(off & 0xff);
    ip += len;
  }
  if (!flush()) return 0;
  return op;
}

}  // extern "C"
