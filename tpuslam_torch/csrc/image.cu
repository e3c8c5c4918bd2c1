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
// float per pixel and write four (gx, gy, mag, angle): 20 B/pixel, 6.1 MB
// at 480x640, 1.8 us at 3.35 TB/s. The blur reads one plane and writes one:
// 8 B/pixel, 2.5 MB at 480x640, 0.73 us; its 4 flops per tap and pixel
// (0.13 us at 67 TFLOP/s for 7 taps) are far below that.
//
// Gradients: one thread per pixel, 32x8 blocks so a warp reads one
// contiguous row segment (coalesced); atan2f fused into the same pass
// (Mosaic had no atan2, so the Pallas kernel left the angle to XLA).
//
// Blur (blur_tile_kernel): one launch. Each block loads the
// (32 + 2r) x (32 + 2r) input window of its 32x32 output tile into shared
// memory with edge-clamped indices, runs the row pass into a
// (32 + 2r) x 32 shared plane, and after __syncthreads() the column pass to
// the output. No intermediate plane goes through device memory. Shared
// memory is 4 ((32 + 2r)^2 + 32 (32 + 2r)) B: 10,640 B at r = 3, 23,312 B
// at the largest radius (15, kMaxTaps = 32), under the 48 KB static limit.
// The radius is a template parameter (one instance per r = 1..15): the tap
// loops unroll and each tap is read from the kernel's parameters in the
// constant bank (a loop over a run-time tap count indexes the parameter
// array at run time, which the two-pass form still does). Taps are summed in
// tap order, a separate multiply and add each (--fmad=false), with a
// float32 intermediate, so the result is bit-equal to the two-pass form.
// ptxas -v (sm_90a, nvcc of CUDA 12.8): 29-30 registers, no spills, 8,976 B
// (r = 1) to 23,312 B (r = 15) of static shared memory. At 480x640, r = 3:
// 4.15 us per call against 8.66 us for the two-pass form and 15.98 us for
// one cuDNN F.conv2d with the 7x7 outer product (chip_smoke.py, NVIDIA H100
// 80GB HBM3, 700.00 W). A plain one-pass kernel (gradients_kernel) takes
// about as long on the same plane: launch and one wave of memory latency,
// not bytes, set both.
//
// The first form, two launches of blur_pass_kernel through a global
// intermediate plane, stays as tpuslam_blur_two_pass: chip_smoke.py times
// it beside the one-launch kernel and the card tests hold the two
// bit-equal. The front end never calls it.
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

constexpr int kBlurTile = 32;  // output tile is kBlurTile x kBlurTile
constexpr int kBlurThreadsY = 8;

// R: the radius (taps = 2R + 1), a template parameter so the tap loops
// unroll and each tap is a constant-bank operand.
template <int R>
__global__ void __launch_bounds__(kBlurTile * kBlurThreadsY)
    blur_tile_kernel(const float* __restrict__ in, float* __restrict__ out, int H, int W,
                     Taps taps) {
  constexpr int WN = kBlurTile + 2 * R;  // window side
  __shared__ float win[WN * WN];         // edge-clamped input
  __shared__ float mid[WN * kBlurTile];  // after the row pass
  const int y0 = blockIdx.y * kBlurTile;
  const int x0 = blockIdx.x * kBlurTile;
#pragma unroll 4
  for (int e = threadIdx.y * kBlurTile + threadIdx.x; e < WN * WN; e += kBlurTile * kBlurThreadsY) {
    const int i = e / WN, c = e - (e / WN) * WN;
    win[e] = in[static_cast<long>(min(max(y0 - R + i, 0), H - 1)) * W + min(max(x0 - R + c, 0), W - 1)];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < WN; i += kBlurThreadsY) {
    const float* p = win + i * WN + threadIdx.x;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 2 * R + 1; ++k) acc += taps.w[k] * p[k];
    mid[i * kBlurTile + threadIdx.x] = acc;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  for (int i = threadIdx.y; i < kBlurTile && y0 + i < H; i += kBlurThreadsY) {
    const float* p = mid + i * kBlurTile + threadIdx.x;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 2 * R + 1; ++k) acc += taps.w[k] * p[k * kBlurTile];
    out[static_cast<long>(y0 + i) * W + x] = acc;
  }
}

template <int R>
void launch_blur(const float* img, float* out, int H, int W, const Taps& t, cudaStream_t s) {
  const dim3 block(kBlurTile, kBlurThreadsY);
  const dim3 grid((W + kBlurTile - 1) / kBlurTile, (H + kBlurTile - 1) / kBlurTile);
  blur_tile_kernel<R><<<grid, block, 0, s>>>(img, out, H, W, t);
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

bool make_taps(const float* taps, int ntaps, Taps* t) {
  if (ntaps < 1 || ntaps > kMaxTaps || ntaps % 2 == 0) return false;
  t->n = ntaps;
  for (int k = 0; k < ntaps; ++k) t->w[k] = taps[k];
  return true;
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

// Separable blur of `img` into `out` in one launch. `taps` is a host array
// of `ntaps` (odd, <= 32) float32 weights; *n_launches is increased by the
// kernel launches made (1).
int tpuslam_blur(const float* img, float* out, int H, int W, const float* taps, int ntaps,
                 int* n_launches, void* stream) {
  Taps t;
  if (!make_taps(taps, ntaps, &t)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ntaps / 2) {
    case 1: launch_blur<1>(img, out, H, W, t, s); break;
    case 2: launch_blur<2>(img, out, H, W, t, s); break;
    case 3: launch_blur<3>(img, out, H, W, t, s); break;
    case 4: launch_blur<4>(img, out, H, W, t, s); break;
    case 5: launch_blur<5>(img, out, H, W, t, s); break;
    case 6: launch_blur<6>(img, out, H, W, t, s); break;
    case 7: launch_blur<7>(img, out, H, W, t, s); break;
    case 8: launch_blur<8>(img, out, H, W, t, s); break;
    case 9: launch_blur<9>(img, out, H, W, t, s); break;
    case 10: launch_blur<10>(img, out, H, W, t, s); break;
    case 11: launch_blur<11>(img, out, H, W, t, s); break;
    case 12: launch_blur<12>(img, out, H, W, t, s); break;
    case 13: launch_blur<13>(img, out, H, W, t, s); break;
    case 14: launch_blur<14>(img, out, H, W, t, s); break;
    case 15: launch_blur<15>(img, out, H, W, t, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);  // radius 0: not a blur the port makes
  }
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*n_launches;
  return static_cast<int>(err);
}

// The two-pass form: rows of `img` into `tmp`, then columns of `tmp` into `out`,
// two launches; same taps and result as tpuslam_blur.
int tpuslam_blur_two_pass(const float* img, float* tmp, float* out, int H, int W,
                          const float* taps, int ntaps, void* stream) {
  Taps t;
  if (!make_taps(taps, ntaps, &t)) return static_cast<int>(cudaErrorInvalidValue);
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
