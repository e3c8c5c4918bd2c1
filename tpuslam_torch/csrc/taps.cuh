// Gaussian taps as a kernel parameter, and the step from a run-time radius
// to a kernel's compile-time one. Shared by image.cu (the blur) and
// lsd_front.cu (the detector's prefilter), so both sum the same taps.
#pragma once

#include <type_traits>

namespace tpuslam {

constexpr int kMaxTaps = 32;
constexpr int kMaxRadius = (kMaxTaps - 1) / 2;  // 15

// Passed by value: the taps sit in the kernel's parameters (constant bank).
struct Taps {
  float w[kMaxTaps];
  int n;
};

inline bool make_taps(const float* taps, int ntaps, Taps* t) {
  if (ntaps < 1 || ntaps > kMaxTaps || ntaps % 2 == 0) return false;
  t->n = ntaps;
  for (int k = 0; k < ntaps; ++k) t->w[k] = taps[k];
  return true;
}

// Calls f(std::integral_constant<int, r>{}) for r in [1, kMaxRadius] and
// returns true; returns false for any other r (radius 0 is no blur, which
// the port never asks a kernel for).
template <class F>
bool with_radius(int r, F&& f) {
  switch (r) {
#define TPUSLAM_RADIUS_CASE(R) \
  case R:                      \
    f(std::integral_constant<int, R>{}); \
    return true;
    TPUSLAM_RADIUS_CASE(1) TPUSLAM_RADIUS_CASE(2) TPUSLAM_RADIUS_CASE(3) TPUSLAM_RADIUS_CASE(4)
    TPUSLAM_RADIUS_CASE(5) TPUSLAM_RADIUS_CASE(6) TPUSLAM_RADIUS_CASE(7) TPUSLAM_RADIUS_CASE(8)
    TPUSLAM_RADIUS_CASE(9) TPUSLAM_RADIUS_CASE(10) TPUSLAM_RADIUS_CASE(11) TPUSLAM_RADIUS_CASE(12)
    TPUSLAM_RADIUS_CASE(13) TPUSLAM_RADIUS_CASE(14) TPUSLAM_RADIUS_CASE(15)
#undef TPUSLAM_RADIUS_CASE
    default:
      return false;
  }
}

}  // namespace tpuslam
