// Host geometry of the speed pipeline in C++: the minimum-area rotated
// rectangle, the outer contours of a binary mask, and run-length encoding.
//
// Each function is a transliteration of the numpy version in
// yolo_puncture_tpu_torch/ops/geometry.py, which stays as its plain version and
// which the tests hold it to:
//   min_area_rect   <- min_area_rect / convex_hull (monotone chain, every hull
//                      edge angle mod 90 degrees tried, the first least area kept)
//   trace_contours  <- _trace_contours_np (cv2's RETR_EXTERNAL /
//                      CHAIN_APPROX_SIMPLE polygons, in cv2's order; with
//                      largest_only, cv2's rule: the polygon with the most points)
//   rle_encode      <- _rle_encoding_np (1-based starts, row-major)
// Built with -ffp-contract=off, so that a*b + c*d rounds each product as numpy does.
//
// C interface for ctypes; no dependencies beyond the standard library.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

using Pt = std::pair<double, double>;

double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.first - o.first) * (b.second - o.second) - (a.second - o.second) * (b.first - o.first);
}

// Andrew's monotone chain over the unique points sorted by (x, y): vertices
// counter-clockwise; two or fewer unique points are returned as they are.
std::vector<Pt> convex_hull(std::vector<Pt> p) {
  std::sort(p.begin(), p.end());
  p.erase(std::unique(p.begin(), p.end()), p.end());
  if (p.size() <= 2) return p;
  auto half = [](auto begin, auto end) {
    std::vector<Pt> out;
    for (auto it = begin; it != end; ++it) {
      while (out.size() >= 2 && cross(out[out.size() - 2], out.back(), *it) <= 0) out.pop_back();
      out.push_back(*it);
    }
    return out;
  };
  std::vector<Pt> lower = half(p.begin(), p.end()), upper = half(p.rbegin(), p.rend());
  std::vector<Pt> hull(lower.begin(), lower.end() - 1);
  hull.insert(hull.end(), upper.begin(), upper.end() - 1);
  return hull;
}

// Python's float modulo (the sign of the divisor), as numpy's remainder.
double py_mod(double a, double b) {
  double m = std::fmod(a, b);
  if (m != 0 && ((b < 0) != (m < 0))) m += b;
  return m;
}

constexpr int kCCW[8][2] = {{0, 1}, {-1, 1}, {-1, 0}, {-1, -1}, {0, -1}, {1, -1}, {1, 0}, {1, 1}};  // (dy, dx)

}  // namespace

extern "C" {

// points: n (x, y) pairs in float64.  out: cx, cy, w, h, angle in degrees, the
// structure cv2.minAreaRect returns.  Returns 0.
int min_area_rect(const double* pts, int64_t n, double* out) {
  std::vector<Pt> p(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) p[i] = {pts[2 * i], pts[2 * i + 1]};
  const std::vector<Pt> hull = convex_hull(std::move(p));
  const size_t m = hull.size();
  std::fill(out, out + 5, 0.0);
  if (m == 0) return 0;
  if (m == 1) {
    out[0] = hull[0].first;
    out[1] = hull[0].second;
    return 0;
  }
  if (m == 2) {
    const double dx = hull[1].first - hull[0].first, dy = hull[1].second - hull[0].second;
    out[0] = (hull[0].first + hull[1].first) / 2;
    out[1] = (hull[0].second + hull[1].second) / 2;
    out[2] = std::hypot(dx, dy);
    out[4] = std::atan2(dy, dx) * (180.0 / M_PI);
    return 0;
  }
  std::vector<double> angles(m);
  for (size_t i = 0; i < m; ++i) {
    const Pt& a = hull[i];
    const Pt& b = hull[(i + 1) % m];
    angles[i] = py_mod(std::atan2(b.second - a.second, b.first - a.first), M_PI / 2);
  }
  std::sort(angles.begin(), angles.end());
  angles.erase(std::unique(angles.begin(), angles.end()), angles.end());
  double best = 0, bw = 0, bh = 0, bcxr = 0, bcyr = 0, ba = 0;
  for (size_t k = 0; k < angles.size(); ++k) {
    const double c = std::cos(angles[k]), s = std::sin(angles[k]);
    double min0 = INFINITY, max0 = -INFINITY, min1 = INFINITY, max1 = -INFINITY;
    for (const Pt& q : hull) {  // rotated by -angle
      const double r0 = c * q.first + s * q.second, r1 = -s * q.first + c * q.second;
      min0 = std::min(min0, r0), max0 = std::max(max0, r0);
      min1 = std::min(min1, r1), max1 = std::max(max1, r1);
    }
    const double w = max0 - min0, h = max1 - min1, area = w * h;
    if (k == 0 || area < best) {
      best = area, bw = w, bh = h, ba = angles[k];
      bcxr = (min0 + max0) / 2, bcyr = (min1 + max1) / 2;
    }
  }
  out[0] = bcxr * std::cos(ba) - bcyr * std::sin(ba);
  out[1] = bcxr * std::sin(ba) + bcyr * std::cos(ba);
  out[2] = bw;
  out[3] = bh;
  out[4] = ba * (180.0 / M_PI);
  return 0;
}

// The outer contours of a mask (H, W; nonzero is foreground), as _trace_contours_np
// finds them: 8-connected components, those that touch the background reaching
// the frame's edge (4-connected), each border walked counter-clockwise from its
// first pixel in raster order, straight runs reduced to their end points,
// polygons in the reverse of raster order.  With largest_only, only the first of
// them with the most points.  Writes (x, y) int32 pairs to xy and each polygon's
// point count to lens when the caller's capacities hold them all; *n_polys gets
// the number of polygons.  Returns the total number of points, or -1 if a walk
// did not close.
int64_t trace_contours(const uint8_t* full, int64_t H, int64_t W, int largest_only, int32_t* xy, int64_t cap_pts,
                       int64_t* lens, int64_t cap_polys, int64_t* n_polys) {
  // the work is done on the foreground's bounding box: everything around it is
  // background that reaches the frame's edge, as the box's own edges then do
  int64_t y0 = H, y1 = -1, x0 = W, x1 = -1;
  for (int64_t y = 0; y < H; ++y)
    for (int64_t x = 0; x < W; ++x)
      if (full[y * W + x]) y0 = std::min(y0, y), y1 = std::max(y1, y), x0 = std::min(x0, x), x1 = std::max(x1, x);
  *n_polys = 0;
  if (y1 < 0) return 0;
  const int64_t h = y1 - y0 + 1, w = x1 - x0 + 1, n = h * w;
  std::vector<uint8_t> crop(static_cast<size_t>(n));
  for (int64_t y = 0; y < h; ++y)
    for (int64_t x = 0; x < w; ++x) crop[y * w + x] = full[(y + y0) * W + x + x0] != 0;
  const uint8_t* mask = crop.data();
  auto fg = [&](int64_t y, int64_t x) { return y >= 0 && y < h && x >= 0 && x < w && mask[y * w + x] != 0; };

  // 8-connected components, labelled in raster order of their first pixel
  std::vector<int32_t> label(static_cast<size_t>(n), 0);
  std::vector<int64_t> first, stack;
  for (int64_t i = 0; i < n; ++i) {
    if (!mask[i] || label[i]) continue;
    const int32_t lab = static_cast<int32_t>(first.size()) + 1;
    first.push_back(i);
    label[i] = lab;
    stack.assign(1, i);
    while (!stack.empty()) {
      const int64_t p = stack.back();
      stack.pop_back();
      const int64_t py = p / w, px = p % w;
      for (int d = 0; d < 8; ++d) {
        const int64_t y = py + kCCW[d][0], x = px + kCCW[d][1];
        if (fg(y, x) && !label[y * w + x]) {
          label[y * w + x] = lab;
          stack.push_back(y * w + x);
        }
      }
    }
  }

  // the background 4-connected to the frame's edge, and the components that touch it
  std::vector<uint8_t> outside(static_cast<size_t>(n), 0);
  stack.clear();
  for (int64_t i = 0; i < n; ++i) {
    const int64_t y = i / w, x = i % w;
    if (!mask[i] && (y == 0 || y == h - 1 || x == 0 || x == w - 1)) {
      outside[i] = 1;
      stack.push_back(i);
    }
  }
  while (!stack.empty()) {
    const int64_t p = stack.back();
    stack.pop_back();
    const int64_t py = p / w, px = p % w;
    for (int d = 0; d < 8; d += 2) {  // E, N, W, S
      const int64_t y = py + kCCW[d][0], x = px + kCCW[d][1];
      if (y >= 0 && y < h && x >= 0 && x < w && !mask[y * w + x] && !outside[y * w + x]) {
        outside[y * w + x] = 1;
        stack.push_back(y * w + x);
      }
    }
  }
  std::vector<uint8_t> external(first.size() + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    if (!mask[i] || external[label[i]]) continue;
    const int64_t y = i / w, x = i % w;
    bool touch = y == 0 || y == h - 1 || x == 0 || x == w - 1;
    for (int d = 0; d < 8 && !touch; d += 2) touch = outside[(y + kCCW[d][0]) * w + x + kCCW[d][1]] != 0;
    external[label[i]] = touch;
  }

  // the walks, in reverse label order (cv2's order)
  std::vector<std::vector<int32_t>> polys;
  std::vector<int64_t> walk;  // y * w + x of each point
  const int64_t limit = 8 * n + 8;
  for (int64_t lab = static_cast<int64_t>(first.size()); lab >= 1; --lab) {
    if (!external[lab]) continue;
    const int64_t start = first[lab - 1];
    int64_t cur = start, second = -1;
    int d = 6;  // the first search begins west
    walk.clear();
    for (int64_t steps = 0;; ++steps) {
      if (steps > limit) return -1;
      int64_t nxt = -1;
      const int64_t cy = cur / w, cx = cur % w;
      for (int i = 0; i < 8; ++i) {
        const int nd = (d + 6 + i) % 8;
        if (fg(cy + kCCW[nd][0], cx + kCCW[nd][1])) {
          nxt = (cy + kCCW[nd][0]) * w + cx + kCCW[nd][1];
          d = nd;
          break;
        }
      }
      if (nxt < 0) {  // a lone pixel
        walk.push_back(cur);
        break;
      }
      if (cur == start && nxt == second) break;
      walk.push_back(cur);
      if (second < 0) second = nxt;
      cur = nxt;
    }
    const size_t k = walk.size();
    std::vector<int32_t> poly;
    for (size_t i = 0; i < k; ++i) {
      const int64_t p = walk[i], prev = walk[(i + k - 1) % k], next = walk[(i + 1) % k];
      const int64_t py = p / w, px = p % w;
      const bool keep = k <= 2 || (next / w - py) != (py - prev / w) || (next % w - px) != (px - prev % w);
      if (keep) {
        poly.push_back(static_cast<int32_t>(px + x0));
        poly.push_back(static_cast<int32_t>(py + y0));
      }
    }
    polys.push_back(std::move(poly));
  }
  if (largest_only && !polys.empty()) {
    size_t best = 0;
    for (size_t i = 1; i < polys.size(); ++i)
      if (polys[i].size() > polys[best].size()) best = i;
    std::vector<std::vector<int32_t>> one(1, std::move(polys[best]));
    polys.swap(one);
  }

  int64_t total = 0;
  for (const auto& p : polys) total += static_cast<int64_t>(p.size() / 2);
  *n_polys = static_cast<int64_t>(polys.size());
  if (total <= cap_pts && *n_polys <= cap_polys) {
    int64_t at = 0;
    for (size_t i = 0; i < polys.size(); ++i) {
      std::memcpy(xy + 2 * at, polys[i].data(), polys[i].size() * sizeof(int32_t));
      lens[i] = static_cast<int64_t>(polys[i].size() / 2);
      at += lens[i];
    }
  }
  return total;
}

// Runs of nonzero bytes of mask (n bytes, row-major): (1-based start, length)
// pairs into out, which holds n / 2 + 1 pairs.  Returns the number of pairs.
int64_t rle_encode(const uint8_t* mask, int64_t n, int64_t* out) {
  int64_t count = 0, i = 0;
  while (i < n) {
    while (i < n && !mask[i]) ++i;
    if (i >= n) break;
    const int64_t start = i + 1;
    while (i < n && mask[i]) ++i;
    out[2 * count] = start;
    out[2 * count + 1] = i + 1 - start;
    ++count;
  }
  return count;
}

}  // extern "C"
