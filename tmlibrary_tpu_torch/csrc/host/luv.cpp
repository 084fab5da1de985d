// luv.cpp: libtiff's SGILog codec (tif_luv.c, libtiff 4.7) as cv2 5.0
// reads its pages, for the TIFF pages of tmlibrary_tpu_torch/readers.py.
//
// - Compression 34676: each row's pixels as byte planes, most significant
//   first, each run-length coded (a byte of 128 + n - 2 then one byte n
//   times, or a count below 128 then that many bytes; a count of 0 is a
//   no-op): LogL16 (photometric LogL, 2 planes) and LogLuv32 (LogLuv, 4
//   planes).  Compression 34677: LogLuv24, three bytes a pixel.  A row
//   short of its data fails, as LogL16Decode and LogLuvDecode32/24 do.
// - LogLuv pixels as libtiff gives them under SGILOGDATAFMT_FLOAT
//   (LogLuv32toXYZ, LogLuv24toXYZ: luminance by exp, (u', v') from the
//   8-bit u and v, or from the 14-bit index over uvcode.h's 163 rows),
//   then cv2's cvtColor(COLOR_XYZ2BGR) of them: float32 products summed
//   as x * c0 + (y * c1 + z * c2) over the first multiple of 4 pixels of a
//   row (its vector loop) and as (x * c0 + y * c1) + z * c2 after it.
// - LogL pixels as libtiff's RGBA interface gives them to cv2
//   (SGILOGDATAFMT_8BIT, L16toGry: 256 * sqrt(Y), 0 at or below 0, 255 at
//   or above 1).
// The luminances come from the host's exp (33,792 arguments in all:
// tm_sgilog_luminances returns them for the callers to hold); the rest is
// IEEE arithmetic in a fixed order.
//
// Built into the port's host library (tmlibrary_tpu_torch/native.py),
// bound with ctypes.  C ABI only.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace tmluv {

// uvcode.h (libtiff): UV_SQSIZ, UV_VSTART, UV_NDIVS and each v row's
// first u, count of u squares and cumulative index
static const float UV_SQSIZ = 0.003500f, UV_VSTART = 0.016940f;
static const int UV_NDIVS = 16289, UV_NVS = 163;
struct UvRow {
  float ustart;
  short nus, ncum;
};
static const UvRow UV_ROW[UV_NVS] = {
    {0.247663f, 4, 0}, {0.243779f, 6, 4}, {0.241684f, 7, 10}, {0.237874f, 9, 17},
    {0.235906f, 10, 26}, {0.232153f, 12, 36}, {0.228352f, 14, 48}, {0.226259f, 15, 62},
    {0.222371f, 17, 77}, {0.22041f, 18, 94}, {0.21471f, 21, 112}, {0.212714f, 22, 133},
    {0.210721f, 23, 155}, {0.204976f, 26, 178}, {0.202986f, 27, 204}, {0.199245f, 29, 231},
    {0.195525f, 31, 260}, {0.19356f, 32, 291}, {0.189878f, 34, 323}, {0.186216f, 36, 357},
    {0.186216f, 36, 393}, {0.182592f, 38, 429}, {0.179003f, 40, 467}, {0.175466f, 42, 507},
    {0.172001f, 44, 549}, {0.172001f, 44, 593}, {0.168612f, 46, 637}, {0.168612f, 46, 683},
    {0.163575f, 49, 729}, {0.158642f, 52, 778}, {0.158642f, 52, 830}, {0.158642f, 52, 882},
    {0.153815f, 55, 934}, {0.153815f, 55, 989}, {0.149097f, 58, 1044}, {0.149097f, 58, 1102},
    {0.142746f, 62, 1160}, {0.142746f, 62, 1222}, {0.142746f, 62, 1284}, {0.13827f, 65, 1346},
    {0.13827f, 65, 1411}, {0.13827f, 65, 1476}, {0.132166f, 69, 1541}, {0.132166f, 69, 1610},
    {0.126204f, 73, 1679}, {0.126204f, 73, 1752}, {0.126204f, 73, 1825}, {0.120381f, 77, 1898},
    {0.120381f, 77, 1975}, {0.120381f, 77, 2052}, {0.120381f, 77, 2129}, {0.112962f, 82, 2206},
    {0.112962f, 82, 2288}, {0.112962f, 82, 2370}, {0.10745f, 86, 2452}, {0.10745f, 86, 2538},
    {0.10745f, 86, 2624}, {0.10745f, 86, 2710}, {0.100343f, 91, 2796}, {0.100343f, 91, 2887},
    {0.100343f, 91, 2978}, {0.095126f, 95, 3069}, {0.095126f, 95, 3164}, {0.095126f, 95, 3259},
    {0.095126f, 95, 3354}, {0.088276f, 100, 3449}, {0.088276f, 100, 3549}, {0.088276f, 100, 3649},
    {0.088276f, 100, 3749}, {0.081523f, 105, 3849}, {0.081523f, 105, 3954}, {0.081523f, 105, 4059},
    {0.081523f, 105, 4164}, {0.074861f, 110, 4269}, {0.074861f, 110, 4379}, {0.074861f, 110, 4489},
    {0.074861f, 110, 4599}, {0.06829f, 115, 4709}, {0.06829f, 115, 4824}, {0.06829f, 115, 4939},
    {0.06829f, 115, 5054}, {0.063573f, 119, 5169}, {0.063573f, 119, 5288}, {0.063573f, 119, 5407},
    {0.063573f, 119, 5526}, {0.057219f, 124, 5645}, {0.057219f, 124, 5769}, {0.057219f, 124, 5893},
    {0.057219f, 124, 6017}, {0.050985f, 129, 6141}, {0.050985f, 129, 6270}, {0.050985f, 129, 6399},
    {0.050985f, 129, 6528}, {0.050985f, 129, 6657}, {0.044859f, 134, 6786}, {0.044859f, 134, 6920},
    {0.044859f, 134, 7054}, {0.044859f, 134, 7188}, {0.040571f, 138, 7322}, {0.040571f, 138, 7460},
    {0.040571f, 138, 7598}, {0.040571f, 138, 7736}, {0.036339f, 142, 7874}, {0.036339f, 142, 8016},
    {0.036339f, 142, 8158}, {0.036339f, 142, 8300}, {0.032139f, 146, 8442}, {0.032139f, 146, 8588},
    {0.032139f, 146, 8734}, {0.032139f, 146, 8880}, {0.027947f, 150, 9026}, {0.027947f, 150, 9176},
    {0.027947f, 150, 9326}, {0.023739f, 154, 9476}, {0.023739f, 154, 9630}, {0.023739f, 154, 9784},
    {0.023739f, 154, 9938}, {0.019504f, 158, 10092}, {0.019504f, 158, 10250}, {0.019504f, 158, 10408},
    {0.016976f, 161, 10566}, {0.016976f, 161, 10727}, {0.016976f, 161, 10888}, {0.016976f, 161, 11049},
    {0.012639f, 165, 11210}, {0.012639f, 165, 11375}, {0.012639f, 165, 11540}, {0.009991f, 168, 11705},
    {0.009991f, 168, 11873}, {0.009991f, 168, 12041}, {0.009016f, 170, 12209}, {0.009016f, 170, 12379},
    {0.009016f, 170, 12549}, {0.006217f, 173, 12719}, {0.006217f, 173, 12892}, {0.005097f, 175, 13065},
    {0.005097f, 175, 13240}, {0.005097f, 175, 13415}, {0.003909f, 177, 13590}, {0.003909f, 177, 13767},
    {0.00234f, 177, 13944}, {0.002389f, 170, 14121}, {0.001068f, 164, 14291}, {0.001653f, 157, 14455},
    {0.000717f, 150, 14612}, {0.001614f, 143, 14762}, {0.00027f, 136, 14905}, {0.000484f, 129, 15041},
    {0.001103f, 123, 15170}, {0.001242f, 115, 15293}, {0.001188f, 109, 15408}, {0.001011f, 103, 15517},
    {0.000709f, 97, 15620}, {0.000301f, 89, 15717}, {0.002416f, 82, 15806}, {0.003251f, 76, 15888},
    {0.003246f, 69, 15964}, {0.004141f, 62, 16033}, {0.005963f, 55, 16095}, {0.008839f, 47, 16150},
    {0.01049f, 40, 16197}, {0.016994f, 31, 16237}, {0.023659f, 21, 16268},
};

static const double LN2 = 0.69314718055994530942;  // M_LN2
static const double U_NEU = 0.210526316, V_NEU = 0.473684211, UVSCALE = 410.;

static double logl16_to_y(int p16) {
  int le = p16 & 0x7fff;
  if (!le) return 0.;
  double y = std::exp(LN2 / 256. * (le + .5) - LN2 * 64.);
  return !(p16 & 0x8000) ? y : -y;
}

static double logl10_to_y(int p10) {
  if (p10 == 0) return 0.;
  return std::exp(LN2 / 64. * (p10 + .5) - LN2 * 12.);
}

static int uv_decode(double* up, double* vp, int c) {
  if (c < 0 || c >= UV_NDIVS) return -1;
  int lower = 0, upper = UV_NVS;  // binary search
  while (upper - lower > 1) {
    int vi = (lower + upper) >> 1;
    int ui = c - UV_ROW[vi].ncum;
    if (ui > 0) {
      lower = vi;
    } else if (ui < 0) {
      upper = vi;
    } else {
      lower = vi;
      break;
    }
  }
  int vi = lower, ui = c - UV_ROW[vi].ncum;
  *up = UV_ROW[vi].ustart + (ui + .5) * UV_SQSIZ;
  *vp = UV_VSTART + (vi + .5) * UV_SQSIZ;
  return 0;
}

static void uv_to_xyz(double L, double u, double v, float* xyz) {
  double s = 1. / (6. * u - 16. * v + 12.);
  double x = 9. * u * s, y = 4. * v * s;
  xyz[0] = (float)(x / y * L);
  xyz[1] = (float)L;
  xyz[2] = (float)((1. - x - y) / y * L);
}

static void luv32_to_xyz(uint32_t p, float* xyz) {
  double L = logl16_to_y((int)p >> 16);
  if (L <= 0.) {
    xyz[0] = xyz[1] = xyz[2] = 0.f;
    return;
  }
  double u = 1. / UVSCALE * ((p >> 8 & 0xff) + .5);
  double v = 1. / UVSCALE * ((p & 0xff) + .5);
  uv_to_xyz(L, u, v, xyz);
}

static void luv24_to_xyz(uint32_t p, float* xyz) {
  double L = logl10_to_y(p >> 14 & 0x3ff);
  if (L <= 0.) {
    xyz[0] = xyz[1] = xyz[2] = 0.f;
    return;
  }
  double u, v;
  if (uv_decode(&u, &v, p & 0x3fff) < 0) {
    u = U_NEU;
    v = V_NEU;
  }
  uv_to_xyz(L, u, v, xyz);
}

// one row's run-length-coded byte planes (LogL16Decode, LogLuvDecode32)
// ORed into codes; false when the data ends first
static bool rle_row(const uint8_t*& bp, int64_t& cc, int nplanes, int64_t npix, uint32_t* tp) {
  std::memset(tp, 0, (size_t)npix * sizeof(uint32_t));
  for (int shft = 8 * (nplanes - 1); shft >= 0; shft -= 8) {
    int64_t i = 0;
    while (i < npix && cc > 0) {
      if (*bp >= 128) {  // a run
        if (cc < 2) break;
        int rc = *bp++ + (2 - 128);
        uint32_t b = (uint32_t)*bp++ << shft;
        cc -= 2;
        while (rc-- && i < npix) tp[i++] |= b;
      } else {  // literal bytes; a count of 0 is a no-op
        int rc = *bp++;
        while (--cc && rc-- && i < npix) tp[i++] |= (uint32_t)*bp++ << shft;
      }
    }
    if (i != npix) return false;
  }
  return true;
}

}  // namespace tmluv

extern "C" {

// Decode rows x width pixels of one SGILog strip or tile: kind 0 LogL16
// (34676) into uint8 grey (L16toGry), kind 1 LogLuv32 (34676) and kind 2
// LogLuv24 (34677) into float32 X, Y, Z.  Returns the bytes read, or -1
// - r when row r runs out of data.
int64_t tm_sgilog_decode(const uint8_t* src, int64_t n, int32_t kind, int64_t width,
                         int64_t rows, void* out) {
  using namespace tmluv;
  const uint8_t* bp = src;
  int64_t cc = n;
  uint32_t* tp = new uint32_t[(size_t)(width > 0 ? width : 1)];
  for (int64_t r = 0; r < rows; ++r) {
    if (kind == 2) {
      int64_t i = 0;
      for (; i < width && cc >= 3; ++i, bp += 3, cc -= 3)
        tp[i] = (uint32_t)bp[0] << 16 | (uint32_t)bp[1] << 8 | bp[2];
      if (i != width) {
        delete[] tp;
        return -1 - r;
      }
    } else if (!rle_row(bp, cc, kind == 0 ? 2 : 4, width, tp)) {
      delete[] tp;
      return -1 - r;
    }
    if (kind == 0) {
      uint8_t* g = (uint8_t*)out + r * width;
      for (int64_t i = 0; i < width; ++i) {
        double y = logl16_to_y((int16_t)tp[i]);
        g[i] = (uint8_t)(y <= 0. ? 0 : y >= 1. ? 255 : (int)(256. * std::sqrt(y)));
      }
    } else {
      float* xyz = (float*)out + r * width * 3;
      for (int64_t i = 0; i < width; ++i)
        (kind == 1 ? luv32_to_xyz : luv24_to_xyz)(tp[i], xyz + 3 * i);
    }
  }
  delete[] tp;
  return n - cc;
}

// cv2's cvtColor(COLOR_XYZ2BGR) of float32 rows (width pixels of X, Y, Z)
void tm_xyz2bgr(const float* xyz, int64_t rows, int64_t width, float* bgr) {
  static const float C[3][3] = {{0.055648f, -0.204043f, 1.057311f},
                                {-0.969256f, 1.875991f, 0.041556f},
                                {3.240479f, -1.53715f, -0.498535f}};
  const int64_t body = width / 4 * 4;
  for (int64_t r = 0; r < rows; ++r)
    for (int64_t i = 0; i < width; ++i) {
      const float* p = xyz + (r * width + i) * 3;
      float* o = bgr + (r * width + i) * 3;
      for (int c = 0; c < 3; ++c) {
        float a = p[0] * C[c][0], b = p[1] * C[c][1], d = p[2] * C[c][2];
        o[c] = i < body ? a + (b + d) : (a + b) + d;
      }
    }
}

// the luminances the codec takes from exp: LogL16's 32,768 (index Le) and
// LogL10's 1,024, as doubles
void tm_sgilog_luminances(double* l16, double* l10) {
  using namespace tmluv;
  for (int i = 0; i < 32768; ++i) l16[i] = logl16_to_y(i);
  for (int i = 0; i < 1024; ++i) l10[i] = logl10_to_y(i);
}

}  // extern "C"
