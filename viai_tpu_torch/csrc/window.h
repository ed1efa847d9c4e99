// viai_tpu/data/av.py::_window_indices, shared by the frame-directory
// reader (imagedec.cpp) and the video reader (videodec.cpp):
// np.linspace(w0·hi, w1·hi, n) in float64, hi = max(total − 1, 0),
// rounded half to even, clipped to [0, hi].
#pragma once

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace viai_window {

inline std::vector<int64_t> window_indices(int64_t total, int n, double w0,
                                           double w1) {
  int64_t hi = std::max<int64_t>(total - 1, 0);
  double start = w0 * double(hi), stop = w1 * double(hi);
  std::vector<int64_t> idx(n);
  int div = n - 1;
  double delta = stop - start;
  for (int i = 0; i < n; ++i) {
    double y;
    if (div > 0) {
      double step = delta / div;
      volatile double t = step == 0.0 ? (double(i) / div) * delta
                                      : double(i) * step;
      y = t + start;
      if (i == n - 1) y = stop;
    } else {
      y = double(i) * delta + start;
    }
    double r = std::nearbyint(y);
    int64_t v = int64_t(r);
    idx[i] = std::min(std::max<int64_t>(v, 0), hi);
  }
  return idx;
}

}  // namespace viai_window
