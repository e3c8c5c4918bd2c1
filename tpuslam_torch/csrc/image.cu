// Image kernels of the tracking front end: central-difference gradients and
// the separable Gaussian blur, for Hopper (sm_90a).
//
// Replaces, in the JAX package:
//   tpuslam/kernels/pallas_image.py  _grad_kernel / gradients_pallas
//   tpuslam/kernels/pallas_image.py  _blur_kernel / blur_pallas
// and follows the math of the main path's plain versions
// (tpuslam/kernels/image.py image_gradients, gaussian_blur): the blur uses
// edge-replicated reads, as image.gaussian_blur's edge padding does (the
// Pallas twin renormalised its border taps instead).
//
// What bounds them: both are memory-bound stencils. The gradients read one
// float per pixel and write four (gx, gy, mag, angle): 20 B/pixel, about
// 6 MB at 480x640, a few microseconds of device-memory time at 3.35 TB/s.
// The blur reads and writes each pixel once per pass through an intermediate
// plane: 16 B/pixel over two passes. The neighbour reads of a stencil hit in
// L1/L2, so device memory sees each plane about once.
//
// Design: one thread per pixel, 32x8 blocks so a warp reads one contiguous
// row segment (coalesced). The gradient kernel fuses atan2f into the same
// pass (Mosaic had no atan2, so the Pallas kernel left the angle to XLA).
// The blur runs rows then columns with taps passed by value (they land in
// the constant bank) and accumulates in tap order. Shared-memory tiling of
// the blur, or fusing it with the gradients, is later work; at these sizes
// each launch is close to its launch cost already.
//
// Built with --fmad=false so that gx*gx + gy*gy rounds as the plain PyTorch
// version rounds it: the detector thresholds these magnitudes.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 32;

struct Taps {
  float w[kMaxTaps];
  int n;
};

__global__ void gradients_kernel(const float* __restrict__ img, float* __restrict__ gx,
                                 float* __restrict__ gy, float* __restrict__ mag,
                                 float* __restrict__ angle, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const long i = static_cast<long>(y) * W + x;
  const bool col_in = x > 0 && x < W - 1;
  const bool row_in = y > 0 && y < H - 1;
  const float gxv = col_in ? (img[i + 1] - img[i - 1]) * 0.5f : 0.0f;
  const float gyv = row_in ? (img[i + W] - img[i - W]) * 0.5f : 0.0f;
  gx[i] = gxv;
  gy[i] = gyv;
  mag[i] = (col_in && row_in) ? sqrtf(gxv * gxv + gyv * gyv) : 0.0f;
  angle[i] = atan2f(gxv, -gyv);
}

// ROWS: taps run along x (within a row); otherwise along y.
template <bool ROWS>
__global__ void blur_pass_kernel(const float* __restrict__ in, float* __restrict__ out,
                                 int H, int W, Taps taps) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const int r = taps.n / 2;
  float acc = 0.0f;
  for (int k = 0; k < taps.n; ++k) {
    int xx = x, yy = y;
    if (ROWS) {
      xx = min(max(x + k - r, 0), W - 1);
    } else {
      yy = min(max(y + k - r, 0), H - 1);
    }
    acc += taps.w[k] * in[static_cast<long>(yy) * W + xx];
  }
  out[static_cast<long>(y) * W + x] = acc;
}

dim3 grid_for(int H, int W, dim3 block) {
  return dim3((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
}

}  // namespace

extern "C" {

const char* tpuslam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// (H, W) float32 image -> gx, gy, mag, angle, each (H, W) float32.
int tpuslam_gradients(const float* img, float* gx, float* gy, float* mag, float* angle,
                      int H, int W, void* stream) {
  const dim3 block(32, 8);
  gradients_kernel<<<grid_for(H, W, block), block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, gx, gy, mag, angle, H, W);
  return static_cast<int>(cudaGetLastError());
}

// Separable blur: rows of `img` into `tmp`, then columns of `tmp` into `out`.
// `taps` is a host array of `ntaps` (odd, <= 32) float32 weights.
int tpuslam_blur(const float* img, float* tmp, float* out, int H, int W, const float* taps,
                 int ntaps, void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps || ntaps % 2 == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps t;
  t.n = ntaps;
  for (int k = 0; k < ntaps; ++k) t.w[k] = taps[k];
  const dim3 block(32, 8);
  const dim3 grid = grid_for(H, W, block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  blur_pass_kernel<true><<<grid, block, 0, s>>>(img, tmp, H, W, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  blur_pass_kernel<false><<<grid, block, 0, s>>>(tmp, out, H, W, t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
