// Per-object convex-hull pixel counts, host side (solidity's denominator).
//
// Counterpart: tm_hull_pixel_counts in the JAX package's native library.
// Object l's hull is Andrew's monotone chain over the centres of its
// pixels; the count is the number of pixel centres inside or on it
// (skimage convex_hull_image semantics).  Objects of one or two pixels,
// and collinear objects, count their own pixels.  Ids outside
// [1, max_label] are skipped.  Two shortcuts give the reference's counts
// exactly: the chain runs over the first and last pixel of each of the
// object's rows (their hull is the hull of all its pixels, and they are
// collinear only when all its pixels are), and each row of the bounding
// box gets the interval of columns every edge allows, in O(rows x edges),
// where the reference tests every pixel against every edge.  All
// arithmetic is integer.  One call takes a batch of sites and also
// returns each object's pixel count, solidity's numerator, from the
// same scan.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

using Point = std::pair<int32_t, int32_t>;  // (x, y)

inline int64_t cross(const Point& o, const Point& a, int64_t bx, int64_t by) {
  return (int64_t(a.first) - o.first) * (by - o.second) -
         (int64_t(a.second) - o.second) * (bx - o.first);
}

// floor(a / d) for d > 0
inline int64_t floor_div(int64_t a, int64_t d) {
  int64_t q = a / d;
  return (a % d != 0 && a < 0) ? q - 1 : q;
}

// Pixel centres (x, y) of row y inside or on the counter-clockwise hull
// of m vertices, within columns [x0, x1]: for edge a -> b the centre is
// kept iff ex * (y - ay) - ey * (x - ax) >= 0 (left of or on the edge),
// a bound on x from above (ey > 0) or below (ey < 0), or the whole row
// or none of it (ey == 0).
inline int64_t row_count(const std::vector<Point>& hull, size_t m, int64_t y, int64_t x0,
                         int64_t x1) {
  int64_t lo = x0, hi = x1;
  for (size_t i = 0; i < m && lo <= hi; ++i) {
    const Point& a = hull[i];
    const Point& b = hull[(i + 1) % m];
    const int64_t ex = int64_t(b.first) - a.first, ey = int64_t(b.second) - a.second;
    const int64_t r = ex * (y - a.second);  // need ey * (x - ax) <= r
    if (ey > 0) {
      hi = std::min(hi, a.first + floor_div(r, ey));
    } else if (ey < 0) {
      lo = std::max(lo, a.first - floor_div(r, -ey));  // x - ax >= ceil(-r / -ey)
    } else if (r < 0) {
      return 0;
    }
  }
  return hi >= lo ? hi - lo + 1 : 0;
}

// One site: out[l - 1] the hull count and area[l - 1] the pixel count of
// object l, both zeroed first.
void hull_site(const int32_t* labels, int32_t h, int32_t w, int32_t max_label, int32_t* out,
               int32_t* area) {
  std::memset(out, 0, sizeof(int32_t) * static_cast<size_t>(max_label));
  std::memset(area, 0, sizeof(int32_t) * static_cast<size_t>(max_label));

  // one row-major scan: every object's pixel count and, per row it
  // touches, the row and its first and last column
  std::vector<std::vector<std::array<int32_t, 3>>> runs(max_label);
  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      const int32_t v = labels[static_cast<size_t>(y) * w + x];
      if (v < 1 || v > max_label) continue;
      auto& r = runs[v - 1];
      if (r.empty() || r.back()[0] != y) r.push_back({y, x, x});
      else r.back()[2] = x;
      ++area[v - 1];
    }
  }

  std::vector<Point> hull, p;
  for (int32_t l = 0; l < max_label; ++l) {
    const int32_t n_pixels = area[l];
    if (n_pixels == 0) continue;
    if (n_pixels <= 2) { out[l] = n_pixels; continue; }
    p.clear();
    int32_t x_min = w, x_max = -1;
    for (const auto& r : runs[l]) {
      p.emplace_back(r[1], r[0]);
      if (r[2] != r[1]) p.emplace_back(r[2], r[0]);
      x_min = std::min(x_min, r[1]);
      x_max = std::max(x_max, r[2]);
    }
    const size_t n = p.size();
    std::sort(p.begin(), p.end());  // by (x, y), as the chain expects
    hull.assign(2 * n, Point());
    size_t k = 0;
    for (size_t i = 0; i < n; ++i) {  // lower hull; cross <= 0 pops collinear points
      while (k >= 2 && cross(hull[k - 2], hull[k - 1], p[i].first, p[i].second) <= 0) --k;
      hull[k++] = p[i];
    }
    for (size_t i = n - 1, t = k + 1; i-- > 0;) {  // upper hull
      while (k >= t && cross(hull[k - 2], hull[k - 1], p[i].first, p[i].second) <= 0) --k;
      hull[k++] = p[i];
    }
    const size_t m = k - 1;  // the last point repeats the first
    if (m <= 2) {  // collinear: the hull holds the object's own pixels
      out[l] = n_pixels;
      continue;
    }
    int64_t count = 0;
    for (int32_t y = runs[l].front()[0]; y <= runs[l].back()[0]; ++y)
      count += row_count(hull, m, y, x_min, x_max);
    out[l] = static_cast<int32_t>(count);
  }
}

}  // namespace

// b sites of (h, w) int32 labels -> hull[b, max_label] and area[b,
// max_label] int32 (ids outside [1, max_label] skipped).  Returns -1 on
// invalid arguments, else 0.
extern "C" int32_t tm_hull_pixel_counts_batch(const int32_t* labels, int32_t b, int32_t h,
                                              int32_t w, int32_t max_label, int32_t* hull,
                                              int32_t* area) {
  if (!labels || !hull || !area || b < 0 || h <= 0 || w <= 0 || max_label <= 0) return -1;
  const size_t site = static_cast<size_t>(h) * w, row = static_cast<size_t>(max_label);
  for (int32_t i = 0; i < b; ++i)
    hull_site(labels + i * site, h, w, max_label, hull + i * row, area + i * row);
  return 0;
}
