// Native host geometry library of the PyTorch port (brepgen_tpu_torch).
//
// The port's own copy of brepgen_tpu/geometry/native/brepnative.cpp. It
// covers the host-side per-sample post-processing hot spots that the
// reference delegated to native code (OpenCASCADE / CUDA chamferdist):
//   * UV-domain face trimming + tessellation (point-in-polygon over the
//     grid cells of every generated face),
//   * nearest-grid-point projection of boundary loops,
//   * area-weighted triangle sampling (point-cloud evaluation),
//   * one-directional squared chamfer (edge->surface residuals).
//
// Exposed as a C ABI consumed via ctypes
// (brepgen_tpu_torch/geometry/native_bindings.py), which builds it with g++
// at first use into build/ and raises when the build fails: there is no
// silent numpy fallback, since the numpy versions break exact distance ties
// the other way.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// Even-odd point-in-polygon for every cell center of an (nu-1)x(nv-1) grid.
// polys: concatenated polygon vertices (fractional grid coords), poly_sizes:
// vertex count per polygon. out: (nu-1)*(nv-1) bytes, 1 = inside.
void cells_inside_polygons(
    const double* polys, const int64_t* poly_sizes, int64_t n_polys,
    int64_t nu, int64_t nv, uint8_t* out) {
  const int64_t H = nu - 1, W = nv - 1;
  std::memset(out, 0, (size_t)(H * W));
  int64_t off = 0;
  for (int64_t p = 0; p < n_polys; ++p) {
    const int64_t n = poly_sizes[p];
    const double* poly = polys + 2 * off;
    for (int64_t i = 0; i < H; ++i) {
      const double px = i + 0.5;
      for (int64_t j = 0; j < W; ++j) {
        const double py = j + 0.5;
        bool inside = false;
        for (int64_t k = 0; k < n; ++k) {
          const double x1 = poly[2 * k], y1 = poly[2 * k + 1];
          const int64_t k2 = (k + 1) % n;
          const double x2 = poly[2 * k2], y2 = poly[2 * k2 + 1];
          if ((y1 > py) != (y2 > py)) {
            const double xi = (x2 - x1) * (py - y1) / (y2 - y1 + 1e-30) + x1;
            if (px < xi) inside = !inside;
          }
        }
        if (inside) out[i * W + j] ^= 1;
      }
    }
    off += n;
  }
}

// Map n 3D points to their nearest sample in an (nu x nv) grid.
// grid: nu*nv*3 doubles; out: n pairs of (i, j) as doubles.
void nearest_grid_index(
    const double* points, int64_t n, const double* grid, int64_t nu,
    int64_t nv, double* out) {
  for (int64_t t = 0; t < n; ++t) {
    const double x = points[3 * t], y = points[3 * t + 1], z = points[3 * t + 2];
    double best = 1e300;
    int64_t bi = 0, bj = 0;
    for (int64_t i = 0; i < nu; ++i) {
      for (int64_t j = 0; j < nv; ++j) {
        const double* g = grid + 3 * (i * nv + j);
        const double dx = g[0] - x, dy = g[1] - y, dz = g[2] - z;
        const double d = dx * dx + dy * dy + dz * dz;
        if (d < best) { best = d; bi = i; bj = j; }
      }
    }
    out[2 * t] = (double)bi;
    out[2 * t + 1] = (double)bj;
  }
}

// Emit two triangles for every inside cell. Returns triangle count.
// grid: nu*nv*3; inside: (nu-1)*(nv-1); out: up to 2*(nu-1)*(nv-1)*9 doubles.
int64_t tessellate_cells(
    const double* grid, int64_t nu, int64_t nv, const uint8_t* inside,
    double* out) {
  const int64_t W = nv - 1;
  int64_t t = 0;
  for (int64_t i = 0; i < nu - 1; ++i) {
    for (int64_t j = 0; j < W; ++j) {
      if (!inside[i * W + j]) continue;
      const double* a = grid + 3 * (i * nv + j);
      const double* b = grid + 3 * ((i + 1) * nv + j);
      const double* c = grid + 3 * ((i + 1) * nv + j + 1);
      const double* d = grid + 3 * (i * nv + j + 1);
      double* t1 = out + 9 * t;
      std::memcpy(t1, a, 24); std::memcpy(t1 + 3, b, 24); std::memcpy(t1 + 6, c, 24);
      double* t2 = out + 9 * (t + 1);
      std::memcpy(t2, a, 24); std::memcpy(t2 + 3, c, 24); std::memcpy(t2 + 6, d, 24);
      t += 2;
    }
  }
  return t;
}

// Area-weighted uniform sampling of n points on a triangle soup.
void sample_triangles(
    const double* tris, int64_t n_tris, int64_t n_points, uint64_t seed,
    double* out) {
  std::vector<double> cum(n_tris);
  double total = 0.0;
  for (int64_t t = 0; t < n_tris; ++t) {
    const double* a = tris + 9 * t;
    const double* b = a + 3;
    const double* c = a + 6;
    const double ux = b[0] - a[0], uy = b[1] - a[1], uz = b[2] - a[2];
    const double vx = c[0] - a[0], vy = c[1] - a[1], vz = c[2] - a[2];
    const double cx = uy * vz - uz * vy, cy = uz * vx - ux * vz, cz = ux * vy - uy * vx;
    total += 0.5 * std::sqrt(cx * cx + cy * cy + cz * cz);
    cum[t] = total;
  }
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  for (int64_t p = 0; p < n_points; ++p) {
    const double r = uni(rng) * total;
    int64_t lo = 0, hi = n_tris - 1;
    while (lo < hi) {
      const int64_t mid = (lo + hi) / 2;
      if (cum[mid] < r) lo = mid + 1; else hi = mid;
    }
    const double* a = tris + 9 * lo;
    const double* b = a + 3;
    const double* c = a + 6;
    double u = uni(rng), v = uni(rng);
    if (u + v > 1.0) { u = 1.0 - u; v = 1.0 - v; }
    for (int d = 0; d < 3; ++d)
      out[3 * p + d] = a[d] + u * (b[d] - a[d]) + v * (c[d] - a[d]);
  }
}

// One-directional squared chamfer: sum over a of min over b of ||a-b||^2.
double chamfer_one_directional(
    const double* a, int64_t na, const double* b, int64_t nb) {
  double total = 0.0;
  for (int64_t i = 0; i < na; ++i) {
    const double x = a[3 * i], y = a[3 * i + 1], z = a[3 * i + 2];
    double best = 1e300;
    for (int64_t j = 0; j < nb; ++j) {
      const double dx = b[3 * j] - x, dy = b[3 * j + 1] - y, dz = b[3 * j + 2] - z;
      const double d = dx * dx + dy * dy + dz * dz;
      if (d < best) best = d;
    }
    total += best;
  }
  return total;
}

}  // extern "C"
