// raster.cpp: the per-pixel loops of the port's image readers, the parts
// of PNG, TIFF and BMP decoding that numpy cannot vectorise.
//
// - tm_png_unfilter: PNG's five row filters undone (None, Sub, Up,
//   Average, Paeth), one pass of rows at a time.
// - tm_unpack_bits: samples of 1 to 16 bits packed most significant bit
//   first, each row starting on a byte (TIFF's FillOrder 1, PNG), to
//   uint16.
// - tm_bmp_rle: a BMP's RLE4 or RLE8 stream to palette indices, as
//   OpenCV's BmpDecoder (grfmt_bmp.cpp) walks it: runs, absolute runs,
//   end of line, delta and end of bitmap, skipped pixels at index 0.
// - tm_tiff_ycbcr: libtiff's TIFFYCbCrToRGBInit tables and
//   TIFFYCbCrtoRGB (tif_color.c), which TIFFReadRGBA* applies to an
//   8-bit YCbCr page that is not JPEG.
// - tm_tiff_cielab: libtiff's TIFFCIELabToRGBInit with its sRGB display,
//   TIFFCIELab16ToXYZ and TIFFXYZToRGB (tif_color.c), float for float,
//   for 8- and 16-bit CIELab pages.
//
// Built into the port's host library (tmlibrary_tpu_torch/native.py),
// bound with ctypes; C ABI only, no state.

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p, pc = p > c ? p - c : c - p;
  return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}

}  // namespace

extern "C" {

// raw: h rows of 1 + stride bytes (the filter type first); out: h rows of
// stride bytes.  bpp is the filter's byte distance (at least 1).  Returns
// 0, or -(row + 1) for a row of an unknown filter type.
int32_t tm_png_unfilter(const uint8_t* raw, int64_t h, int64_t stride, int32_t bpp,
                        uint8_t* out) {
  const uint8_t* prior = nullptr;
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* x = raw + y * (stride + 1) + 1;
    uint8_t* cur = out + y * stride;
    switch (raw[y * (stride + 1)]) {
      case 0:
        std::memcpy(cur, x, (size_t)stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i) cur[i] = (uint8_t)(x[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i) cur[i] = (uint8_t)(x[i] + (prior ? prior[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = prior ? prior[i] : 0;
          cur[i] = (uint8_t)(x[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = prior ? prior[i] : 0;
          int c = (i >= bpp && prior) ? prior[i - bpp] : 0;
          cur[i] = (uint8_t)(x[i] + paeth(a, b, c));
        }
        break;
      default:
        return (int32_t)(-(y + 1));
    }
    prior = cur;
  }
  return 0;
}

// rows of row_bytes bytes, each holding n samples of `bits` bits (1-16)
// most significant bit first, into rows * n uint16 values
void tm_unpack_bits(const uint8_t* src, int64_t rows, int64_t row_bytes, int64_t n, int32_t bits,
                    uint16_t* out) {
  const uint32_t mask = (1u << bits) - 1u;
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t* s = src + r * row_bytes;
    uint16_t* o = out + r * n;
    uint64_t acc = 0;
    int have = 0;
    int64_t at = 0;
    for (int64_t i = 0; i < n; ++i) {
      while (have < bits) {
        acc = (acc << 8) | (at < row_bytes ? s[at] : 0);
        ++at;
        have += 8;
      }
      have -= bits;
      o[i] = (uint16_t)((acc >> have) & mask);
    }
  }
}

// A BMP RLE stream (bits 4 or 8) into an (height, width) plane of palette
// indices in the file's row order.  OpenCV 5.0's walk: a run of n pixels
// alternates its two nibbles (RLE4) or repeats its byte (RLE8); an RLE8
// run that ends its row moves to the next and an end of line that
// follows is then ignored; an absolute run copies its pixels (padded to
// a word).  RLE8: end of line skips the rest of the row, a delta (dx, dy)
// dx pixels and dy rows, end of bitmap the rest of the image.  RLE4: end
// of line and end of bitmap both skip the rest of the row and the walk
// goes on, a delta skips dx pixels alone.  Skipped pixels take index 0;
// the walk ends with the last row; a run or absolute run past its row
// ends it with an error.  Returns 0, or -1 when the stream ends before
// the last row or a run leaves its row.
int32_t tm_bmp_rle(const uint8_t* src, int64_t n, int32_t width, int32_t height, int32_t bits,
                   uint8_t* out) {
  std::memset(out, 0, (size_t)width * (size_t)height);
  int64_t pos = 0, y = 0, x = 0;
  bool line_end_flag = false;
  auto byte = [&](int& v) {
    if (pos >= n) return false;
    v = src[pos++];
    return true;
  };
  // skip `count` pixels from (y, x), wrapping rows (OpenCV's FillUniColor)
  auto skip = [&](int64_t count) {
    do {
      int64_t step = std::min<int64_t>(count, width - x);
      x += step;
      count -= step;
      if (x >= width) {
        x = 0;
        if (++y >= height) break;
      }
    } while (count > 0);
  };
  while (y < height) {
    int len, code;
    if (!byte(len) || !byte(code)) return -1;
    if (len != 0) {
      if (x + len > width) return -1;
      for (int i = 0; i < len; ++i)
        out[y * width + x + i] = bits == 8 ? (uint8_t)code : (uint8_t)((i & 1) ? code & 15 : code >> 4);
      x += len;
      if (bits == 8) {
        int64_t prev = y;
        if (x >= width) {
          x = 0;
          ++y;
        }
        line_end_flag = y != prev;
      }
    } else if (code > 2) {
      if (x + code > width) return -1;
      int64_t bytes = bits == 8 ? ((code + 1) & ~1) : ((((code + 1) >> 1) + 1) & ~1);
      if (pos + bytes > n) return -1;
      for (int i = 0; i < code; ++i) {
        int v = bits == 8 ? src[pos + i] : ((i & 1) ? src[pos + i / 2] & 15 : src[pos + i / 2] >> 4);
        out[y * width + x + i] = (uint8_t)v;
      }
      pos += bytes;
      x += code;
      line_end_flag = false;
    } else {
      int64_t dx = width - x, dy = height - y;
      if (code == 2) {
        int a, b;
        if (!byte(a) || !byte(b)) return -1;
        dx = a;
        dy = b;
      }
      if (bits == 4) {
        skip(dx);  // OpenCV 5.0's RLE4: every escape skips dx, dy and the rest unread
      } else if (code || !line_end_flag || dx < width) {
        skip(dx + (code == 0 ? 0 : dy * width));
      }
      line_end_flag = false;
    }
  }
  return 0;
}

// n pixels of 8-bit YCbCr (y, cb, cr) to RGB (3 bytes a pixel) as
// libtiff's TIFFYCbCrtoRGB, its tables made from luma (YCbCrCoefficients)
// and refbw (ReferenceBlackWhite) as TIFFYCbCrToRGBInit makes them
void tm_tiff_ycbcr(const uint8_t* yy, const uint8_t* cb, const uint8_t* cr, int64_t n,
                   const float* luma, const float* refbw, uint8_t* rgb) {
  const int SHIFT = 16;
  const int32_t ONE_HALF = 1 << (SHIFT - 1);
  auto clampf = [](float f, float lo, float hi) { return !(f >= lo) ? lo : f > hi ? hi : f; };
  auto fix = [](float x) { return (int32_t)(x * (1L << 16) + 0.5); };
  auto code2v = [](int c, float rb, float rw, int cr) {
    return ((c - (int32_t)rb) * (float)cr) / (float)((rw - rb != 0) ? (rw - rb) : 1);
  };
  auto clampw = [](float v, float lo, float hi) { return v < lo ? lo : v > hi ? hi : v; };
  float f1 = 2 - 2 * luma[0];
  int32_t D1 = fix(clampf(f1, 0.0F, 2.0F));
  float f2 = luma[0] * f1 / luma[1];
  int32_t D2 = -fix(clampf(f2, 0.0F, 2.0F));
  float f3 = 2 - 2 * luma[2];
  int32_t D3 = fix(clampf(f3, 0.0F, 2.0F));
  float f4 = luma[2] * f3 / luma[1];
  int32_t D4 = -fix(clampf(f4, 0.0F, 2.0F));
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256], ytab[256];
  for (int i = 0, x = -128; i < 256; ++i, ++x) {
    int32_t Cr = (int32_t)clampw(code2v(x, refbw[4] - 128.0F, refbw[5] - 128.0F, 127), -128.0F * 32,
                                 128.0F * 32);
    int32_t Cb = (int32_t)clampw(code2v(x, refbw[2] - 128.0F, refbw[3] - 128.0F, 127), -128.0F * 32,
                                 128.0F * 32);
    cr_r[i] = (int32_t)((D1 * Cr + ONE_HALF) >> SHIFT);
    cb_b[i] = (int32_t)((D3 * Cb + ONE_HALF) >> SHIFT);
    cr_g[i] = D2 * Cr;
    cb_g[i] = D4 * Cb + ONE_HALF;
    ytab[i] = (int32_t)clampw(code2v(x + 128, refbw[0], refbw[1], 255), -128.0F * 32, 128.0F * 32);
  }
  auto clamp255 = [](int32_t v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
  for (int64_t i = 0; i < n; ++i) {
    int32_t Y = ytab[yy[i]], Cb = cb[i], Cr = cr[i];
    rgb[3 * i] = clamp255(Y + cr_r[Cr]);
    rgb[3 * i + 1] = clamp255(Y + (int32_t)((cb_g[Cb] + cr_g[Cr]) >> SHIFT));
    rgb[3 * i + 2] = clamp255(Y + cb_b[Cb]);
  }
}

// n pixels of CIELab (L unsigned, a and b signed; bits 8 or 16, 3 samples
// a pixel, native order) to RGB bytes as libtiff's putcontig8bitCIELab8
// and putcontig8bitCIELab16 make them, for the white point (x, y) given
void tm_tiff_cielab(const void* lab, int64_t n, int32_t bits, const float* white, uint8_t* rgb) {
  // libtiff's display_sRGB
  const float mat[9] = {3.2410F, -1.5374F, -0.4986F, -0.9692F, 1.8760F, 0.0416F,
                        0.0556F, -0.2040F, 1.0570F};
  const float YC = 100.0F, Y0 = 1.0F, gamma = 2.4F;
  const uint32_t Vrw = 255;
  const int range = 1500;
  static thread_local float steps[1501];
  double dfGamma = 1.0 / gamma;
  float step = (YC - Y0) / range;
  for (int i = 0; i <= range; ++i) steps[i] = Vrw * ((float)std::pow((double)i / range, dfGamma));
  float refWhite[3];
  refWhite[1] = 100.0F;
  refWhite[0] = white[0] / white[1] * refWhite[1];
  refWhite[2] = (1.0F - white[0] - white[1]) / white[1] * refWhite[1];
  const float X0 = refWhite[0], Y0w = refWhite[1], Z0 = refWhite[2];
  auto to_byte = [&](float Yv) {
    Yv = Yv > Y0 ? Yv : Y0;
    Yv = Yv < YC ? Yv : YC;
    size_t i = (size_t)((Yv - Y0) / step);
    i = i < (size_t)range ? i : (size_t)range;
    float R = steps[i];
    uint32_t v = (uint32_t)(R > 0 ? (R + 0.5) : (R - 0.5));
    return (uint8_t)(v < Vrw ? v : Vrw);
  };
  for (int64_t k = 0; k < n; ++k) {
    uint32_t l;
    int32_t a, b;
    if (bits == 8) {
      const uint8_t* p = (const uint8_t*)lab + 3 * k;
      l = (uint32_t)p[0] * 257;
      a = (int32_t)(int8_t)p[1] * 256;
      b = (int32_t)(int8_t)p[2] * 256;
    } else {
      const uint16_t* p = (const uint16_t*)lab + 3 * k;
      l = p[0];
      a = (int16_t)p[1];
      b = (int16_t)p[2];
    }
    float L = (float)l * 100.0F / 65535.0F;
    float cby, tmp, X, Y, Z;
    if (L < 8.856F) {
      Y = (L * Y0w) / 903.292F;
      cby = 7.787F * (Y / Y0w) + 16.0F / 116.0F;
    } else {
      cby = (L + 16.0F) / 116.0F;
      Y = Y0w * cby * cby * cby;
    }
    tmp = (float)a / 256.0F / 500.0F + cby;
    if (tmp < 0.2069F)
      X = X0 * (tmp - 0.13793F) / 7.787F;
    else
      X = X0 * tmp * tmp * tmp;
    tmp = cby - (float)b / 256.0F / 200.0F;
    if (tmp < 0.2069F)
      Z = Z0 * (tmp - 0.13793F) / 7.787F;
    else
      Z = Z0 * tmp * tmp * tmp;
    float Yr = mat[0] * X + mat[1] * Y + mat[2] * Z;
    float Yg = mat[3] * X + mat[4] * Y + mat[5] * Z;
    float Yb = mat[6] * X + mat[7] * Y + mat[8] * Z;
    rgb[3 * k] = to_byte(Yr);
    rgb[3 * k + 1] = to_byte(Yg);
    rgb[3 * k + 2] = to_byte(Yb);
  }
}

}  // extern "C"
