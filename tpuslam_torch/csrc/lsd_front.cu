// The line detector's front in one launch, for Hopper (sm_90a): prefilter
// blur, gradients on the 0..255 scale, support mask, the bit-packed
// neighbour-compatibility plane and the seeds of the connected-component
// labelling, from the raw level image.
//
// Replaces, in the JAX package:
//   tpuslam/kernels/pallas_image.py  _grad_kernel / gradients_pallas (the detector's call)
//   tpuslam/kernels/pallas_image.py  _blur_kernel / blur_pallas (the prefilter)
// and the support / compat / seed planes that XLA fuses around them in
// tpuslam/kernels/lsd.py detect_lines. The port's plain version is
// kernels/lsd.py ccl_inputs_torch; the kernel is bit for bit the chain it
// replaces on the card (blur_tile_kernel, `* 255`, gradients_kernel, then the
// eager compat loop, kept as lsd._ccl_inputs_chain_cuda): the same taps in
// tap order with a separate multiply and add (--fmad=false), the samples
// scaled before differencing, `dot = gx*gx' + gy*gy'` and
// `thr = (cos_tol * mag) * mag'` rounded as PyTorch rounds them, and `rho`,
// `cos_tol` as float32 (PyTorch rounds a Python scalar against a float32
// tensor the same way).
//
// Each block owns a kTile x kTile output tile and works in shared memory:
//   1. the (kTile + 2h)^2 window of the raw image, h = R + 2 (R for the blur,
//      1 for the central differences, 1 for the compat neighbours), read with
//      edge-clamped indices (the prefilter pads by replication), every load
//      issued by cp.async before the first wait;
//   2. the row pass over the window's rows and the tile's columns plus a 2-px
//      ring, then the column pass, times 255 (the (kTile + 4)^2 blurred plane);
//   3. gx, gy and mag over the tile plus a 1-px ring, zero where the image's
//      1-px border zeroes them (and at ring cells outside the image);
//   4. per tile pixel: support = mag > rho, the 8 compat bits in lsd._OFFSETS
//      order, labels0 (pixel index, N off the support), maxlab0 (index, -1).
// It writes mag (f32), support (bool), labels0, maxlab0 and compat (int32):
// what detect_lines reads, and no gx, gy or angle plane.
//
// A batch of B images of one shape runs in one launch (grid z over the
// images, tpuslam_lsd_front_batch): each block offsets its planes by its
// image's and does what it does for one image, so each image is bit for bit
// its single-image launch (the single-image entry point is the batch of one).
//
// The compat plane of the plain version reads neighbours through torch.roll,
// so the image's first row sees its last. That wrap is never observable:
// every image-border pixel has mag 0, so with rho >= 0 (the wrapper refuses
// less) it is never in the support and carries no bit, and neither does the
// pixel that would read it across the wrap. The kernel reads no wrapped
// neighbour; tests/test_torch_lsd_front.py holds that premise on the CPU.
//
// What bounds it: bytes. It reads 4 B and writes 17 B per pixel (mag 4,
// support 1, labels0 4, maxlab0 4, compat 4): 21 B/pixel, 6.45 MB at 480x640,
// 1.93 us at 3.35 TB/s (1.23 us at 384x512). Its 4 (2R + 1) + 10 flops per
// pixel for blur and gradients and 6 per compat direction of a supported
// pixel are at most 86 per pixel at R = 3: 0.39 us at 67 TFLOP/s.
//
// The launch floor: one kernel over a VGA plane costs about 4 us on this card
// whatever it does (blur_tile_kernel and gradients_kernel each sit there,
// image.cu). The chain this kernel replaces is 162 launches per detector
// level (blur, scale, gradients, ~19 full-plane passes for each of the 8
// compat directions, then the seeds; torch.profiler, chip_smoke.py); here
// all of it is one launch,
// the raw image is read once and no intermediate plane goes through device
// memory. The halo work (a 42^2 window and a 36^2 blurred plane for a 32^2
// tile at R = 3) is ~1.7x the tile's, spent in shared memory.
//
// Shared memory (static): 4 ((kTile + 2h)^2 + (kTile + 2h)(kTile + 4) +
// (kTile + 4)^2 + 3 (kTile + 2)^2) B: 32,160 B at R = 3, 30,304 B at R = 1,
// 45,984 B at R = 15, under the 48 KB static limit. ptxas -v (sm_90a, nvcc
// of CUDA 12.8): 32 registers at R = 1..3, 40 at R = 4..8, up to 62 at
// R = 15, no spills. At 480x640, R = 3: 8.17 us per call against 486.94 us
// for the chain it replaces (162 launches), 23.6% of the byte bound
// (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): twice the one-pass
// floor above, spent on the four phases in sequence behind their barriers
// with ~2.3 blocks of 256 threads per SM.

#include <cuda_runtime.h>

#include "taps.cuh"

namespace {

using tpuslam::make_taps;
using tpuslam::Taps;

constexpr int kTile = 32;  // output tile side; kernels/lsd.py FRONT_TILE
constexpr int kThreadsY = 8;
constexpr int kThreads = kTile * kThreadsY;

// lsd._OFFSETS: neighbour d of pixel (y, x) is (y - dy, x - dx), as
// torch.roll(x, (dy, dx)) reads it
__constant__ int kDy[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
__constant__ int kDx[8] = {-1, 0, 1, -1, 1, -1, 0, 1};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    lsd_front_kernel(const float* __restrict__ img, float* __restrict__ mag_out,
                     bool* __restrict__ support_out, int* __restrict__ labels0,
                     int* __restrict__ maxlab0, int* __restrict__ compat, int H, int W,
                     Taps taps, float rho, float cos_tol) {
  constexpr int HALO = R + 2;
  constexpr int WN = kTile + 2 * HALO;  // input window side
  constexpr int BN = kTile + 4;         // blurred plane side: tile + 2-px ring
  constexpr int GN = kTile + 2;         // gradient planes side: tile + 1-px ring
  __shared__ float win[WN * WN];
  __shared__ float mid[WN * BN];  // after the row pass
  __shared__ float blr[BN * BN];  // after the column pass, times 255
  __shared__ float sgx[GN * GN];
  __shared__ float sgy[GN * GN];
  __shared__ float smag[GN * GN];
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  // image blockIdx.z of the batch: its planes, its own pixel indices
  const long plane = static_cast<long>(blockIdx.z) * H * W;
  img += plane;
  mag_out += plane;
  support_out += plane;
  labels0 += plane;
  maxlab0 += plane;
  compat += plane;

  // 1. window cell (i, c) holds pixel (y0 - HALO + i, x0 - HALO + c), clamped
  for (int e = tid; e < WN * WN; e += kThreads) {
    const int i = e / WN, c = e - (e / WN) * WN;
    const int y = min(max(y0 - HALO + i, 0), H - 1);
    const int x = min(max(x0 - HALO + c, 0), W - 1);
    cp_async4(win + e, img + static_cast<long>(y) * W + x);
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. blurred cell (i, c) is pixel (y0 - 2 + i, x0 - 2 + c); its taps are
  // window columns c .. c + 2R, then mid rows i .. i + 2R
  for (int e = tid; e < WN * BN; e += kThreads) {
    const int i = e / BN, c = e - (e / BN) * BN;
    const float* p = win + i * WN + c;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 2 * R + 1; ++k) acc += taps.w[k] * p[k];
    mid[e] = acc;
  }
  __syncthreads();
  for (int e = tid; e < BN * BN; e += kThreads) {
    const int i = e / BN, c = e - (e / BN) * BN;
    const float* p = mid + i * BN + c;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 2 * R + 1; ++k) acc += taps.w[k] * p[k * BN];
    blr[e] = acc * 255.0f;
  }
  __syncthreads();

  // 3. gradient cell (i, c) is pixel (y0 - 1 + i, x0 - 1 + c)
  for (int e = tid; e < GN * GN; e += kThreads) {
    const int i = e / GN, c = e - (e / GN) * GN;
    const int y = y0 - 1 + i, x = x0 - 1 + c;
    const float* b = blr + (i + 1) * BN + (c + 1);
    const bool col_in = x > 0 && x < W - 1;
    const bool row_in = y > 0 && y < H - 1;
    const float gxv = col_in ? (b[1] - b[-1]) * 0.5f : 0.0f;
    const float gyv = row_in ? (b[BN] - b[-BN]) * 0.5f : 0.0f;
    sgx[e] = gxv;
    sgy[e] = gyv;
    smag[e] = (col_in && row_in) ? sqrtf(gxv * gxv + gyv * gyv) : 0.0f;
  }
  __syncthreads();

  // 4. the tile, one column per thread (coalesced rows of output)
  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  const int N = H * W;
  for (int i = threadIdx.y; i < kTile && y0 + i < H; i += kThreadsY) {
    const int g = (i + 1) * GN + threadIdx.x + 1;
    const float m = smag[g];
    const bool sup = m > rho;
    int bits = 0;
    if (sup) {
      const float gxv = sgx[g], gyv = sgy[g], cm = cos_tol * m;
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        const int q = g - kDy[d] * GN - kDx[d];
        const float mq = smag[q];
        const float dot = gxv * sgx[q] + gyv * sgy[q];
        bits |= static_cast<int>(mq > rho && dot > cm * mq) << d;
      }
    }
    const int idx = (y0 + i) * W + x;
    mag_out[idx] = m;
    support_out[idx] = sup;
    labels0[idx] = sup ? idx : N;
    maxlab0[idx] = sup ? idx : -1;
    compat[idx] = bits;
  }
}

}  // namespace

extern "C" {

// (B, H, W) float32 level images -> mag (f32), support (bool), labels0,
// maxlab0 and compat bits (int32), each (B, H, W), in one launch (grid z
// over the images; labels are pixel indices within each image). `taps` is
// a host array of `ntaps` float32 prefilter weights (radius 1..15); `tile`
// and `halo` must be the built tile and ntaps / 2 + 2 (the wrapper passes
// kernels/lsd.py FRONT_TILE and front_halo). *n_launches is increased by the
// kernel launches made (1).
int tpuslam_lsd_front_batch(const float* img, float* mag, bool* support, int* labels0, int* maxlab0,
                            int* compat, int B, int H, int W, const float* taps, int ntaps, float rho,
                            float cos_tol, int tile, int halo, int* n_launches, void* stream) {
  Taps t;
  if (!make_taps(taps, ntaps, &t) || tile != kTile || halo != ntaps / 2 + 2 || B < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kTile, kThreadsY);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = tpuslam::with_radius(ntaps / 2, [&](auto r) {
    lsd_front_kernel<decltype(r)::value><<<grid, block, 0, s>>>(
        img, mag, support, labels0, maxlab0, compat, H, W, t, rho, cos_tol);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*n_launches;
  return static_cast<int>(err);
}

// One (H, W) image: the batch of one.
int tpuslam_lsd_front(const float* img, float* mag, bool* support, int* labels0, int* maxlab0,
                      int* compat, int H, int W, const float* taps, int ntaps, float rho,
                      float cos_tol, int tile, int halo, int* n_launches, void* stream) {
  return tpuslam_lsd_front_batch(img, mag, support, labels0, maxlab0, compat, 1, H, W, taps, ntaps, rho,
                                 cos_tol, tile, halo, n_launches, stream);
}

}  // extern "C"
