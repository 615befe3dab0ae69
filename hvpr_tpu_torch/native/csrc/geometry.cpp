// Host-side geometry kernels for the data pipeline.
//
// The port's copy of hvpr_tpu/native/csrc/geometry.cpp:
//   * rotated BEV IoU (the counterpart of OpenPCDet's iou3d_cpu.cpp, used by
//     the gt-database sampler collision test, database_sampler.py:184-185)
//   * point-in-rotated-box (OpenPCDet: roiaware_pool3d, used by
//     gt-database creation, kitti_dataset.py:217)
//
// Box convention: (x, y, z, dx, dy, dz, heading), z at box center, heading CCW
// around +z from +x. Compiled as a plain shared library, bound via ctypes.

#include <cmath>
#include <cstdint>
#include <algorithm>

namespace {

constexpr float EPS = 1e-8f;

struct Point2 {
  float x, y;
  Point2() : x(0), y(0) {}
  Point2(float x_, float y_) : x(x_), y(y_) {}
};

inline float cross(const Point2 &o, const Point2 &a, const Point2 &b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// corners of a rotated bev box (x, y, dx, dy, r)
inline void box_corners(const float *b, Point2 *c) {
  const float cosa = std::cos(b[4]), sina = std::sin(b[4]);
  const float hx = b[2] * 0.5f, hy = b[3] * 0.5f;
  const float lx[4] = {hx, hx, -hx, -hx};
  const float ly[4] = {-hy, hy, hy, -hy};
  for (int i = 0; i < 4; ++i) {
    c[i].x = b[0] + lx[i] * cosa - ly[i] * sina;
    c[i].y = b[1] + lx[i] * sina + ly[i] * cosa;
  }
}

inline bool point_in_box(const Point2 &p, const float *b) {
  const float cosa = std::cos(b[4]), sina = std::sin(b[4]);
  const float dx = p.x - b[0], dy = p.y - b[1];
  const float lx = dx * cosa + dy * sina;
  const float ly = -dx * sina + dy * cosa;
  return std::fabs(lx) <= b[2] * 0.5f + EPS && std::fabs(ly) <= b[3] * 0.5f + EPS;
}

inline bool seg_intersect(const Point2 &p1, const Point2 &p2, const Point2 &q1,
                          const Point2 &q2, Point2 &out) {
  const float d1x = p2.x - p1.x, d1y = p2.y - p1.y;
  const float d2x = q2.x - q1.x, d2y = q2.y - q1.y;
  const float denom = d1x * d2y - d1y * d2x;
  if (std::fabs(denom) < EPS) return false;
  const float qpx = q1.x - p1.x, qpy = q1.y - p1.y;
  const float t = (qpx * d2y - qpy * d2x) / denom;
  const float s = (qpx * d1y - qpy * d1x) / denom;
  if (t < 0 || t > 1 || s < 0 || s > 1) return false;
  out.x = p1.x + t * d1x;
  out.y = p1.y + t * d1y;
  return true;
}

// intersection area of two rotated bev boxes (x, y, dx, dy, r)
float box_intersection_area(const float *a, const float *b) {
  Point2 ca[4], cb[4];
  box_corners(a, ca);
  box_corners(b, cb);

  Point2 pts[24];
  int n = 0;
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) {
      Point2 p;
      if (seg_intersect(ca[i], ca[(i + 1) & 3], cb[j], cb[(j + 1) & 3], p))
        pts[n++] = p;
    }
  }
  for (int i = 0; i < 4; ++i) {
    if (point_in_box(ca[i], b)) pts[n++] = ca[i];
    if (point_in_box(cb[i], a)) pts[n++] = cb[i];
  }
  if (n < 3) return 0.0f;

  Point2 c(0, 0);
  for (int i = 0; i < n; ++i) { c.x += pts[i].x; c.y += pts[i].y; }
  c.x /= n; c.y /= n;

  float ang[24];
  int order[24];
  for (int i = 0; i < n; ++i) {
    ang[i] = std::atan2(pts[i].y - c.y, pts[i].x - c.x);
    order[i] = i;
  }
  std::sort(order, order + n, [&](int i, int j) { return ang[i] < ang[j]; });

  float area = 0.0f;
  for (int i = 0; i < n; ++i) {
    const Point2 &p0 = pts[order[i]];
    const Point2 &p1 = pts[order[(i + 1) % n]];
    area += (p0.x - c.x) * (p1.y - c.y) - (p0.y - c.y) * (p1.x - c.x);
  }
  return 0.5f * std::fabs(area);
}

}  // namespace

extern "C" {

// boxes: (n, 7) / (m, 7) full 3d boxes; out: (n, m) rotated bev IoU
void boxes_iou_bev_cpu(const float *boxes_a, int64_t n, const float *boxes_b,
                       int64_t m, float *out) {
  for (int64_t i = 0; i < n; ++i) {
    const float *ba = boxes_a + i * 7;
    const float a5[5] = {ba[0], ba[1], ba[3], ba[4], ba[6]};
    const float area_a = ba[3] * ba[4];
    for (int64_t j = 0; j < m; ++j) {
      const float *bb = boxes_b + j * 7;
      const float b5[5] = {bb[0], bb[1], bb[3], bb[4], bb[6]};
      const float inter = box_intersection_area(a5, b5);
      const float uni = area_a + bb[3] * bb[4] - inter;
      out[i * m + j] = inter / std::max(uni, 1e-6f);
    }
  }
}

// boxes: (n, 7) / (m, 7); out: (n, m) raw rotated-BEV intersection AREA
// (needed by the KITTI evaluator's criterion!=-1 overlap modes and the
//  3D-overlap prefix — OpenPCDet rotate_iou criterion semantics)
void boxes_overlap_bev_cpu(const float *boxes_a, int64_t n,
                           const float *boxes_b, int64_t m, float *out) {
  for (int64_t i = 0; i < n; ++i) {
    const float *ba = boxes_a + i * 7;
    const float a5[5] = {ba[0], ba[1], ba[3], ba[4], ba[6]};
    for (int64_t j = 0; j < m; ++j) {
      const float *bb = boxes_b + j * 7;
      const float b5[5] = {bb[0], bb[1], bb[3], bb[4], bb[6]};
      out[i * m + j] = box_intersection_area(a5, b5);
    }
  }
}

// boxes: (n, 7) / (m, 7); out: (n, m) 3d IoU (z-center convention)
void boxes_iou3d_cpu(const float *boxes_a, int64_t n, const float *boxes_b,
                     int64_t m, float *out) {
  for (int64_t i = 0; i < n; ++i) {
    const float *ba = boxes_a + i * 7;
    const float a5[5] = {ba[0], ba[1], ba[3], ba[4], ba[6]};
    const float vol_a = ba[3] * ba[4] * ba[5];
    const float az0 = ba[2] - ba[5] * 0.5f, az1 = ba[2] + ba[5] * 0.5f;
    for (int64_t j = 0; j < m; ++j) {
      const float *bb = boxes_b + j * 7;
      const float b5[5] = {bb[0], bb[1], bb[3], bb[4], bb[6]};
      const float inter_bev = box_intersection_area(a5, b5);
      const float bz0 = bb[2] - bb[5] * 0.5f, bz1 = bb[2] + bb[5] * 0.5f;
      const float hz = std::max(0.0f, std::min(az1, bz1) - std::max(az0, bz0));
      const float inter = inter_bev * hz;
      const float uni = vol_a + bb[3] * bb[4] * bb[5] - inter;
      out[i * m + j] = inter / std::max(uni, 1e-6f);
    }
  }
}

// points: (n, 3); boxes: (m, 7); out: (m, n) int32 membership mask
void points_in_boxes_cpu_kernel(const float *points, int64_t n,
                                const float *boxes, int64_t m, int32_t *out) {
  for (int64_t j = 0; j < m; ++j) {
    const float *b = boxes + j * 7;
    const float cosa = std::cos(b[6]), sina = std::sin(b[6]);
    const float hx = b[3] * 0.5f, hy = b[4] * 0.5f, hz = b[5] * 0.5f;
    for (int64_t i = 0; i < n; ++i) {
      const float dx = points[i * 3 + 0] - b[0];
      const float dy = points[i * 3 + 1] - b[1];
      const float dz = points[i * 3 + 2] - b[2];
      const float lx = dx * cosa + dy * sina;
      const float ly = -dx * sina + dy * cosa;
      out[j * n + i] =
          (std::fabs(lx) <= hx && std::fabs(ly) <= hy && std::fabs(dz) <= hz) ? 1 : 0;
    }
  }
}

}  // extern "C"
