// polyboolean.cpp — host-side polygon boolean engine for subzero_tpu (the
// PyTorch port's copy of subzero_tpu/native/polyboolean.cpp; the code is
// identical, so both packages give the same contours).
//
// The reference ships Clipper v6.4.2 (C++, int64 Vatti) as its only native
// component (SubZero's private/clipper.cpp), driving every polygon
// boolean in the model.  This engine fills the same role for the TPU
// framework's host-side lifecycle surgery (floe fusion/welding unions,
// ridging differences, fracture region splitting) and acts as the exact
// oracle for the on-device boundary-integral kernels.
//
// Algorithm (deliberately NOT a Clipper port): subsegment classification +
// stitching, the same construction as the device kernel in
// subzero_tpu/geometry/clip.py:
//   1. split every edge of P at its intersections with Q's edges and at the
//      projections of Q's vertices (robust for collinear overlaps);
//   2. classify each subsegment by two probe points (midpoint +- eps along
//      the edge normal): weight 1 = strictly on the result boundary,
//      1/2 = lying on the other polygon's boundary (resolved by an
//      orientation tie-break), 0 = not on the boundary;
//   3. likewise for Q (orientation reversed for difference);
//   4. stitch kept subsegments into closed contours by snapped-endpoint
//      matching, choosing the most-counterclockwise continuation at
//      multi-way junctions.
//
// Result contours are CCW for outer boundaries, CW for holes.
//
// C ABI at the bottom; built as a shared library loaded via ctypes
// (no pybind11 in this environment).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

using Contour = std::vector<Pt>;
using Poly = std::vector<Contour>;  // contour 0.. : outer CCW or hole CW

struct Seg {
  Pt a, b;
};

double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

double signed_area(const Contour& c) {
  double s = 0;
  size_t n = c.size();
  for (size_t i = 0; i < n; ++i) {
    const Pt& p = c[i];
    const Pt& q = c[(i + 1) % n];
    s += p.x * q.y - q.x * p.y;
  }
  return 0.5 * s;
}

// Even-odd point-in-polygon over all contours (holes included naturally).
bool point_in_poly(const Pt& p, const Poly& poly) {
  bool in = false;
  for (const Contour& c : poly) {
    size_t n = c.size();
    for (size_t i = 0; i < n; ++i) {
      const Pt& a = c[i];
      const Pt& b = c[(i + 1) % n];
      if ((a.y > p.y) != (b.y > p.y)) {
        double xint = a.x + (p.y - a.y) / (b.y - a.y) * (b.x - a.x);
        if (p.x < xint) in = !in;
      }
    }
  }
  return in;
}

double poly_scale(const Poly& p) {
  double s = 1.0;
  for (const Contour& c : p)
    for (const Pt& q : c) s = std::max(s, std::max(std::fabs(q.x), std::fabs(q.y)));
  return s;
}

// Half-piece (boundary-coincident subsegment) tie-break rules.  A probe
// pattern with the other polygon's interior on the SAME side as src's
// interior (in_minus && !in_plus) is a shared same-direction edge; interior
// on the outside (in_plus && !in_minus) is an anti-parallel touching edge.
enum HalfRule {
  HALF_DROP = 0,       // never keep coincident pieces (secondary side)
  HALF_SAME_DIR = 1,   // keep shared same-direction edges (int / union)
  HALF_ANTI_DIR = 2,   // keep anti-parallel touching edges (difference)
};

// Split the edges of `src` against `other`; classify subsegments.
// keep_inside: keep pieces whose probes land inside `other`.
// If `reverse`, emitted segments are flipped (for difference's Q side).
void collect_side(const Poly& src, const Poly& other, bool keep_inside,
                  HalfRule half_rule, bool reverse, double eps,
                  std::vector<Seg>& out) {
  for (const Contour& c : src) {
    size_t n = c.size();
    for (size_t i = 0; i < n; ++i) {
      Pt a = c[i], b = c[(i + 1) % n];
      double dx = b.x - a.x, dy = b.y - a.y;
      double len2 = dx * dx + dy * dy;
      if (len2 <= 0) continue;
      // split params: proper intersections + vertex projections
      std::vector<double> ts{0.0, 1.0};
      for (const Contour& oc : other) {
        size_t m = oc.size();
        for (size_t j = 0; j < m; ++j) {
          Pt p = oc[j], q = oc[(j + 1) % m];
          double ex = q.x - p.x, ey = q.y - p.y;
          double denom = dx * ey - dy * ex;
          if (std::fabs(denom) > 0) {
            double t = ((p.x - a.x) * ey - (p.y - a.y) * ex) / denom;
            double s = ((p.x - a.x) * dy - (p.y - a.y) * dx) / denom;
            if (t > 0 && t < 1 && s >= 0 && s <= 1) ts.push_back(t);
          }
          // projection of vertex p onto this edge
          double tp = ((p.x - a.x) * dx + (p.y - a.y) * dy) / len2;
          if (tp > 0 && tp < 1) ts.push_back(tp);
        }
      }
      std::sort(ts.begin(), ts.end());
      double elen = std::sqrt(len2);
      double nx = dy / elen, ny = -dx / elen;  // outward for CCW
      for (size_t k = 0; k + 1 < ts.size(); ++k) {
        double t0 = ts[k], t1 = ts[k + 1];
        if (t1 - t0 < 1e-14) continue;
        double tm = 0.5 * (t0 + t1);
        Pt mid{a.x + tm * dx, a.y + tm * dy};
        bool in_plus = point_in_poly({mid.x + eps * nx, mid.y + eps * ny}, other);
        bool in_minus = point_in_poly({mid.x - eps * nx, mid.y - eps * ny}, other);
        bool keep;
        if (in_plus == in_minus) {
          // strictly interior (both true) or exterior (both false)
          keep = keep_inside ? in_plus : !in_plus;
        } else if (half_rule == HALF_SAME_DIR) {
          keep = in_minus && !in_plus;
        } else if (half_rule == HALF_ANTI_DIR) {
          keep = in_plus && !in_minus;
        } else {
          keep = false;
        }
        if (!keep) continue;
        Pt s0{a.x + t0 * dx, a.y + t0 * dy};
        Pt s1{a.x + t1 * dx, a.y + t1 * dy};
        if (reverse) out.push_back({s1, s0});
        else out.push_back({s0, s1});
      }
    }
  }
}

// Snap key for endpoint matching.
struct Key {
  int64_t x, y;
  bool operator<(const Key& o) const {
    return x < o.x || (x == o.x && y < o.y);
  }
};

Key snap(const Pt& p, double inv_tol) {
  return Key{(int64_t)std::llround(p.x * inv_tol),
             (int64_t)std::llround(p.y * inv_tol)};
}

// Stitch segments into closed contours.
Poly stitch(std::vector<Seg>& segs, double tol) {
  double inv_tol = 1.0 / tol;
  std::multimap<Key, size_t> by_start;
  for (size_t i = 0; i < segs.size(); ++i)
    by_start.insert({snap(segs[i].a, inv_tol), i});
  std::vector<bool> used(segs.size(), false);
  Poly result;

  for (size_t i0 = 0; i0 < segs.size(); ++i0) {
    if (used[i0]) continue;
    Contour contour;
    size_t cur = i0;
    Key start = snap(segs[i0].a, inv_tol);
    int guard = 0;
    while (true) {
      used[cur] = true;
      contour.push_back(segs[cur].a);
      Key end = snap(segs[cur].b, inv_tol);
      if (end.x == start.x && end.y == start.y) break;  // closed
      // candidates out of this endpoint
      auto range = by_start.equal_range(end);
      size_t best = SIZE_MAX;
      double best_turn = -1e30;
      double inx = segs[cur].b.x - segs[cur].a.x;
      double iny = segs[cur].b.y - segs[cur].a.y;
      double inlen = std::sqrt(inx * inx + iny * iny);
      for (auto it = range.first; it != range.second; ++it) {
        size_t j = it->second;
        if (used[j]) continue;
        double ox = segs[j].b.x - segs[j].a.x;
        double oy = segs[j].b.y - segs[j].a.y;
        double olen = std::sqrt(ox * ox + oy * oy);
        if (olen <= 0 || inlen <= 0) continue;
        // prefer the sharpest left turn (most CCW continuation)
        double sin_t = (inx * oy - iny * ox) / (inlen * olen);
        double cos_t = (inx * ox + iny * oy) / (inlen * olen);
        double ang = std::atan2(sin_t, cos_t);  // (-pi, pi], left positive
        if (ang > best_turn + 1e-12) {
          best_turn = ang;
          best = j;
        }
      }
      if (best == SIZE_MAX) break;  // open chain (numerical orphan): drop
      cur = best;
      if (++guard > (int)segs.size() + 2) break;
    }
    Key end = snap(segs[cur].b, inv_tol);
    if (!(end.x == start.x && end.y == start.y)) continue;  // not closed
    // clean collinear / duplicate vertices
    Contour clean;
    size_t n = contour.size();
    for (size_t i = 0; i < n; ++i) {
      const Pt& prev = contour[(i + n - 1) % n];
      const Pt& cury = contour[i];
      const Pt& next = contour[(i + 1) % n];
      double d2 = (cury.x - prev.x) * (cury.x - prev.x) +
                  (cury.y - prev.y) * (cury.y - prev.y);
      if (d2 < tol * tol) continue;
      if (std::fabs(cross(prev, cury, next)) <
          1e-12 * (std::fabs(cury.x - prev.x) + std::fabs(next.x - cury.x) +
                   std::fabs(cury.y - prev.y) + std::fabs(next.y - cury.y) + tol))
        continue;
      clean.push_back(cury);
    }
    if (clean.size() >= 3 && std::fabs(signed_area(clean)) > tol * tol)
      result.push_back(clean);
  }
  return result;
}

// op: 0=intersection, 1=union, 2=difference (P minus Q), 3=xor
Poly boolean_op(const Poly& P, const Poly& Q, int op) {
  double scale = std::max(poly_scale(P), poly_scale(Q));
  double eps = scale * 1e-9;
  double tol = scale * 1e-9;
  std::vector<Seg> segs;
  switch (op) {
    case 0:  // P and Q
      collect_side(P, Q, true, HALF_SAME_DIR, false, eps, segs);
      collect_side(Q, P, true, HALF_DROP, false, eps, segs);
      break;
    case 1:  // P or Q
      collect_side(P, Q, false, HALF_SAME_DIR, false, eps, segs);
      collect_side(Q, P, false, HALF_DROP, false, eps, segs);
      break;
    case 2:  // P minus Q
      collect_side(P, Q, false, HALF_ANTI_DIR, false, eps, segs);
      collect_side(Q, P, true, HALF_DROP, true, eps, segs);
      break;
    case 3: {  // symmetric difference = (P-Q) or (Q-P)
      Poly a = boolean_op(P, Q, 2);
      Poly b = boolean_op(Q, P, 2);
      for (const Contour& c : b) a.push_back(c);
      return a;
    }
  }
  return stitch(segs, tol);
}

}  // namespace

// ----------------------------------------------------------------------
// C ABI
//
// Polygons are passed as flat double arrays [x0,y0,x1,y1,...] plus a
// per-contour vertex-count array.  Result is written into caller buffers;
// returns the number of result contours, or -1 on overflow.
extern "C" {

int subzero_poly_boolean(
    const double* p_pts, const int32_t* p_sizes, int32_t p_ncont,
    const double* q_pts, const int32_t* q_sizes, int32_t q_ncont,
    int32_t op,
    double* out_pts, int32_t* out_sizes,
    int32_t max_pts, int32_t max_contours) {
  Poly P, Q;
  size_t off = 0;
  for (int32_t i = 0; i < p_ncont; ++i) {
    Contour c(p_sizes[i]);
    for (int32_t j = 0; j < p_sizes[i]; ++j)
      c[j] = {p_pts[2 * (off + j)], p_pts[2 * (off + j) + 1]};
    off += p_sizes[i];
    P.push_back(c);
  }
  off = 0;
  for (int32_t i = 0; i < q_ncont; ++i) {
    Contour c(q_sizes[i]);
    for (int32_t j = 0; j < q_sizes[i]; ++j)
      c[j] = {q_pts[2 * (off + j)], q_pts[2 * (off + j) + 1]};
    off += q_sizes[i];
    Q.push_back(c);
  }
  Poly R = boolean_op(P, Q, op);
  int32_t total = 0;
  for (const Contour& c : R) total += (int32_t)c.size();
  if ((int32_t)R.size() > max_contours || total > max_pts) return -1;
  size_t k = 0;
  for (size_t i = 0; i < R.size(); ++i) {
    out_sizes[i] = (int32_t)R[i].size();
    for (const Pt& p : R[i]) {
      out_pts[2 * k] = p.x;
      out_pts[2 * k + 1] = p.y;
      ++k;
    }
  }
  return (int32_t)R.size();
}

double subzero_poly_area(const double* pts, int32_t n) {
  Contour c(n);
  for (int32_t i = 0; i < n; ++i) c[i] = {pts[2 * i], pts[2 * i + 1]};
  return signed_area(c);
}

}  // extern "C"
