// Windowed dynamic-time-warping core for the nDTW/SDTW metrics (the port's
// own copy of robo_vln_tpu/sim/dtw.cc).
//
// Evaluates DTW over an explicit (i, j) cell window (row-major sorted), the
// primitive both exact DTW (full window) and fastdtw (projected window) reduce
// to.  Points are D-dimensional doubles; distance is euclidean.  Episodes run
// to 1000 steps at 30 Hz and the reference recomputes DTW every sim step
// during eval (habitat_extensions/measures.py:316-334), so this is the hot
// host-side metric path.

#include <cmath>
#include <cstdint>
#include <limits>
#include <unordered_map>

namespace {

inline double dist(const double* a, const double* b, int d) {
  double s = 0;
  for (int k = 0; k < d; ++k) {
    double diff = a[k] - b[k];
    s += diff * diff;
  }
  return std::sqrt(s);
}

inline int64_t key(int i, int j) {
  return (static_cast<int64_t>(i) << 32) | static_cast<uint32_t>(j);
}

}  // namespace

extern "C" {

// window: flattened (i, j) int32 pairs, monotonically ordered so that
// dependencies (i-1,j), (i,j-1), (i-1,j-1) are computed before (i,j).
double dtw_window(const double* x, int n, const double* y, int m, int d,
                  const int* window, int wlen) {
  const double INF = std::numeric_limits<double>::infinity();
  std::unordered_map<int64_t, double> D;
  D.reserve(wlen * 2);
  for (int w = 0; w < wlen; ++w) {
    int i = window[2 * w];
    int j = window[2 * w + 1];
    double c = dist(x + i * d, y + j * d, d);
    double best;
    if (i == 0 && j == 0) {
      best = 0.0;
    } else {
      best = INF;
      auto it = D.find(key(i - 1, j));
      if (it != D.end() && it->second < best) best = it->second;
      it = D.find(key(i, j - 1));
      if (it != D.end() && it->second < best) best = it->second;
      it = D.find(key(i - 1, j - 1));
      if (it != D.end() && it->second < best) best = it->second;
    }
    D[key(i, j)] = c + best;
  }
  auto it = D.find(key(n - 1, m - 1));
  return it == D.end() ? INF : it->second;
}

}  // extern "C"
