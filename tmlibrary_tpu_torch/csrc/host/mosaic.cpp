// Host passes of the spatial layout over a whole-well label mosaic:
// the Moore boundary trace behind the polygons, and the per-object
// morphology and intensity accumulators behind the mosaic features.
//
// Counterpart: native/tmnative.cpp tm_trace_boundary, tm_mosaic_morph and
// tm_mosaic_intensity of the JAX package, with the same arguments,
// order of visits and float64 accumulation, so the outputs are the same
// bit for bit.
#include <cstdint>
#include <cstddef>
#include <limits>

extern "C" {

// Moore-neighbour boundary trace of one labeled object (8-connected
// boundary, clockwise, starting at its first pixel in scan order, ended
// by Jacob's criterion: the start pixel re-entered from its first
// backtrack).  out_yx receives up to max_pts (y, x) pairs; returns the
// true number of points (callers retry with a larger buffer when it
// exceeds max_pts), 0 if the label is absent, -1 on invalid arguments.
int32_t tm_trace_boundary(const int32_t* labels, int32_t h, int32_t w, int32_t label,
                          int32_t* out_yx, int32_t max_pts) {
  if (!labels || !out_yx || h <= 0 || w <= 0 || max_pts <= 0) return -1;
  auto at = [&](int32_t y, int32_t x) -> bool {
    return y >= 0 && y < h && x >= 0 && x < w &&
           labels[static_cast<size_t>(y) * w + x] == label;
  };
  int32_t sy = -1, sx = -1;
  for (int32_t y = 0; y < h && sy < 0; ++y)
    for (int32_t x = 0; x < w; ++x)
      if (at(y, x)) { sy = y; sx = x; break; }
  if (sy < 0) return 0;

  // clockwise Moore neighbourhood: W, NW, N, NE, E, SE, S, SW
  static const int32_t dy[8] = {0, -1, -1, -1, 0, 1, 1, 1};
  static const int32_t dx[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
  int32_t cy = sy, cx = sx;
  int32_t back = 0;  // direction from the current pixel to its backtrack
  const int32_t back0 = back;
  int32_t count = 0;
  const int64_t limit = static_cast<int64_t>(h) * w * 4 + 8;
  for (int64_t iter = 0; iter < limit; ++iter) {
    if (iter == 0 || !(cy == sy && cx == sx)) {
      if (count < max_pts) {
        out_yx[2 * count] = cy;
        out_yx[2 * count + 1] = cx;
      }
      ++count;
    }
    int32_t k = 1;
    int32_t d = -1;
    for (; k <= 8; ++k) {
      d = (back + k) % 8;
      if (at(cy + dy[d], cx + dx[d])) break;
    }
    if (k > 8) break;  // an isolated pixel
    // the new backtrack: the neighbour scanned just before d, seen from
    // the new pixel
    const int32_t prev = (back + k - 1) % 8;
    const int32_t py = cy + dy[prev], px = cx + dx[prev];
    cy += dy[d];
    cx += dx[d];
    back = 0;
    for (int32_t j = 0; j < 8; ++j) {
      if (cy + dy[j] == py && cx + dx[j] == px) { back = j; break; }
    }
    if (cy == sy && cx == sx && back == back0) break;
  }
  return count;
}

// Per-label sum, sum of squares (float64), min and max of a float32
// mosaic in one pass; arrays of count + 1 with index 0 the background.
// Returns 0, or -1 on bad arguments or a label outside [0, count].
int32_t tm_mosaic_intensity(const int32_t* labels, const float* vals, int64_t n,
                            int32_t count, double* sum_out, double* sq_out,
                            double* min_out, double* max_out) {
  if (!labels || !vals || !sum_out || !sq_out || !min_out || !max_out || n < 0 ||
      count < 0)
    return -1;
  const double inf = std::numeric_limits<double>::infinity();
  for (int32_t k = 0; k <= count; ++k) {
    sum_out[k] = 0.0;
    sq_out[k] = 0.0;
    min_out[k] = inf;
    max_out[k] = -inf;
  }
  for (int64_t i = 0; i < n; ++i) {
    const int32_t l = labels[i];
    if (l < 0 || l > count) return -1;
    const double v = static_cast<double>(vals[i]);
    sum_out[l] += v;
    sq_out[l] += v * v;
    if (v < min_out[l]) min_out[l] = v;
    if (v > max_out[l]) max_out[l] = v;
  }
  return 0;
}

// Per-label pixel area, centroid sums (float64) and bounding boxes in one
// pass; arrays of count + 1 (index 0 the background), ymin/xmin starting
// at h/w and ymax/xmax at -1 so absent labels keep those sentinels.
int32_t tm_mosaic_morph(const int32_t* labels, int32_t h, int32_t w, int32_t count,
                        int64_t* area_out, double* cy_out, double* cx_out,
                        int64_t* ymin_out, int64_t* ymax_out, int64_t* xmin_out,
                        int64_t* xmax_out) {
  if (!labels || !area_out || !cy_out || !cx_out || !ymin_out || !ymax_out || !xmin_out ||
      !xmax_out || h <= 0 || w <= 0 || count < 0)
    return -1;
  for (int32_t k = 0; k <= count; ++k) {
    area_out[k] = 0;
    cy_out[k] = 0.0;
    cx_out[k] = 0.0;
    ymin_out[k] = h;
    ymax_out[k] = -1;
    xmin_out[k] = w;
    xmax_out[k] = -1;
  }
  for (int32_t y = 0; y < h; ++y) {
    const int32_t* row = labels + static_cast<int64_t>(y) * w;
    for (int32_t x = 0; x < w; ++x) {
      const int32_t l = row[x];
      if (l < 0 || l > count) return -1;
      area_out[l] += 1;
      cy_out[l] += y;
      cx_out[l] += x;
      if (y < ymin_out[l]) ymin_out[l] = y;
      if (y > ymax_out[l]) ymax_out[l] = y;
      if (x < xmin_out[l]) xmin_out[l] = x;
      if (x > xmax_out[l]) xmax_out[l] = x;
    }
  }
  return 0;
}

}  // extern "C"
