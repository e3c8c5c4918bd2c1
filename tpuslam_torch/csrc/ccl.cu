// Connected-component label propagation of the line detector, for Hopper
// (sm_90a).
//
// Replaces, in the JAX package:
//   tpuslam/kernels/pallas_ccl.py  _ccl_kernel / ccl_propagate_pallas
// and is bit-equal to the main path's form, tpuslam/kernels/lsd.py
// _ccl_xla: R synchronous rounds of masked 8-neighbour min-label and
// max-label propagation. Neighbour d of pixel (y, x) is the pixel
// ((y - dy) mod H, (x - dx) mod W), as jnp.roll gives it, and counts only
// where bit d of the pixel's compat word is set.
//
// The rounds must stay synchronous (Jacobi): each round reads only the
// previous round's planes. An in-place or tile-local update converges
// faster and changes the labels; components longer than the propagation
// reach are meant to fragment (lsd.py), so a faster-converging variant is a
// different detector.
//
// What bounds it: each round reads three int32 planes (labels, max labels,
// compat) and writes two: 20 B/pixel, about 6 MB per round at 480x640, so
// a round is a few microseconds of device-memory time and about as long as
// its launch. R = 64 rounds are 64 launches per call.
//
// Design: one launch per round, both channels in the same launch, ping-pong
// between two pairs of buffers arranged so the last round writes the
// caller's outputs. One thread per pixel, 32x8 blocks for coalesced rows.
// Later work: run k rounds per launch on a shared-memory tile with a k-pixel
// halo (still exactly synchronous: the halo carries the rounds' reach).

#include <cuda_runtime.h>

namespace {

__constant__ int kDy[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
__constant__ int kDx[8] = {-1, 0, 1, -1, 1, -1, 0, 1};

__global__ void ccl_round_kernel(const int* __restrict__ lab, const int* __restrict__ mx,
                                 const int* __restrict__ compat, int* __restrict__ lab_out,
                                 int* __restrict__ mx_out, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const long i = static_cast<long>(y) * W + x;
  const int bits = compat[i];
  int lm = lab[i];
  int mm = mx[i];
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    if ((bits >> d) & 1) {
      int yy = y - kDy[d];
      int xx = x - kDx[d];
      yy = yy < 0 ? yy + H : (yy >= H ? yy - H : yy);
      xx = xx < 0 ? xx + W : (xx >= W ? xx - W : xx);
      const long j = static_cast<long>(yy) * W + xx;
      lm = min(lm, lab[j]);
      mm = max(mm, mx[j]);
    }
  }
  lab_out[i] = lm;
  mx_out[i] = mm;
}

}  // namespace

extern "C" {

// `rounds` synchronous rounds from (lab0, mx0) under `compat`; the result
// lands in (lab_out, mx_out). (lab_tmp, mx_tmp) are scratch planes of the
// same (H, W) int32 shape. The inputs are not modified.
int tpuslam_ccl(const int* lab0, const int* mx0, const int* compat, int* lab_out, int* mx_out,
                int* lab_tmp, int* mx_tmp, int H, int W, int rounds, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rounds < 0 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(H) * W * sizeof(int);
  if (rounds == 0) {
    cudaError_t err = cudaMemcpyAsync(lab_out, lab0, bytes, cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaMemcpyAsync(mx_out, mx0, bytes, cudaMemcpyDeviceToDevice, s));
  }
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  // Round r (1-based) writes `out` when rounds - r is even, so the last
  // round always writes `out`.
  const int* src_l = lab0;
  const int* src_m = mx0;
  for (int r = 1; r <= rounds; ++r) {
    const bool to_out = ((rounds - r) % 2) == 0;
    int* dst_l = to_out ? lab_out : lab_tmp;
    int* dst_m = to_out ? mx_out : mx_tmp;
    ccl_round_kernel<<<grid, block, 0, s>>>(src_l, src_m, compat, dst_l, dst_m, H, W);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src_l = dst_l;
    src_m = dst_m;
  }
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
