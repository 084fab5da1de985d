// Douglas-Peucker simplification of a closed polygon ring, behind the
// `export --simplify` GeoJSON polygons.
//
// Counterpart: native/tmnative.cpp tm_simplify_polygon of the JAX
// package, with the same arguments, the same split of the ring at vertex
// 0 and its farthest vertex, the same order of the range stack and the
// same float64 distances, so the same vertices survive.
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

extern "C" {

// pts: n rows of (y, x); keep: n flags (out), 1 = the vertex survives.
// tol: perpendicular-distance tolerance in pixels.  Vertex 0 and the
// vertex farthest from it are always kept, so the closing edge is
// simplified like any other.  Returns the number of kept vertices, or
// -1 on invalid arguments.
int32_t tm_simplify_polygon(const int32_t* pts, int32_t n, double tol, uint8_t* keep) {
  if (!pts || !keep || n < 0) return -1;
  std::memset(keep, 0, static_cast<size_t>(n));
  if (n <= 2) {
    for (int32_t i = 0; i < n; ++i) keep[i] = 1;
    return n;
  }
  const double tol2 = tol * tol;
  auto px = [&](int32_t i) { return static_cast<double>(pts[2 * i + 1]); };
  auto py = [&](int32_t i) { return static_cast<double>(pts[2 * i]); };

  // squared perpendicular distance of vertex i to the chord (a, b)
  auto dist2 = [&](int32_t i, int32_t a, int32_t b) {
    const double ax = px(a), ay = py(a), bx = px(b), by = py(b);
    const double dx = bx - ax, dy = by - ay;
    const double len2 = dx * dx + dy * dy;
    if (len2 == 0.0) {
      const double ex = px(i) - ax, ey = py(i) - ay;
      return ex * ex + ey * ey;
    }
    const double cross = dx * (py(i) - ay) - dy * (px(i) - ax);
    return cross * cross / len2;
  };

  int32_t far_i = 1;
  double far_d = -1.0;
  for (int32_t i = 1; i < n; ++i) {
    const double ex = px(i) - px(0), ey = py(i) - py(0);
    const double d = ex * ex + ey * ey;
    if (d > far_d) { far_d = d; far_i = i; }
  }
  keep[0] = 1;
  keep[far_i] = 1;

  // ranges [a, b] of the two arcs 0..far_i and far_i..n (b == n: the
  // chord ends at vertex 0)
  std::vector<std::pair<int32_t, int32_t>> stack;
  stack.emplace_back(0, far_i);
  stack.emplace_back(far_i, n);
  while (!stack.empty()) {
    const auto [a, b] = stack.back();
    stack.pop_back();
    const int32_t chord_b = (b == n) ? 0 : b;
    int32_t worst = -1;
    double worst_d = tol2;
    for (int32_t i = a + 1; i < b; ++i) {
      const double d = dist2(i, a, chord_b);
      if (d > worst_d) { worst_d = d; worst = i; }
    }
    if (worst >= 0) {
      keep[worst] = 1;
      stack.emplace_back(a, worst);
      stack.emplace_back(worst, b);
    }
  }
  int32_t kept = 0;
  for (int32_t i = 0; i < n; ++i) kept += keep[i];
  return kept;
}

}  // extern "C"
