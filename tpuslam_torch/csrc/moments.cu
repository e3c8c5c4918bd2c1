// Fixed-order segment sums: V float32 value columns of N items summed into S
// slots by an int32 slot id, without float atomics, for Hopper (sm_90a).
//
// The JAX package reduces the detector's per-component moments over a
// virtual (K, N) one-hot that XLA fuses into its reductions
// (tpuslam/kernels/lsd.py detect_lines, `red`; merge_collinear's
// segment_sum); there is no Pallas kernel behind it. The port's first form
// summed with index_add_, which on a CUDA tensor adds by atomics in no fixed
// order, so two runs of the detector on one image could differ in the last
// bits of a moment and, through the keyframe decisions, in the trajectory.
// This kernel adds every sum in one fixed order, the same on every run:
//
//   out[v][s] = sum over blocks b = 0, 1, ... (in order) of
//               sum over the block's warps j = 0, 1, ... (in order) of
//               sum over the warp's 32-item steps (in item order) of
//               sum over the step's items of slot s (in item order),
//
// each sum starting from +0.0f and adding left to right in float32. Block
// b's warp j covers items [(b * WPB + j) * ipw, (b * WPB + j + 1) * ipw), a
// contiguous range; WPB (warps per block) and ipw (items per warp) depend on
// N, V and S only, so the order depends on nothing but the shapes.
//
// Two launches:
//   1. moments_block_kernel: each warp keeps (V, S) accumulators in shared
//      memory. Per step of 32 items the lanes with one slot find each other
//      (__match_any_sync) and stage their values in shared memory; then the
//      warp takes the step's slot groups one after another (by their lowest
//      lane), and lane v < V adds column v of the group's values in lane
//      order and adds that step sum into its accumulator. Lane v alone ever
//      writes column v, so nothing races. After the block's warps finish,
//      its threads sum the warps' accumulators in warp order into the
//      block's partial row (B, V, S) in device memory.
//   2. moments_combine_kernel: one thread per (v, s) sums the B partial rows
//      in block order.
// Items whose slot lies outside [0, S) are skipped. The values are (V, N)
// row-major, so each step's loads are coalesced.
//
// What bounds it: the bytes, N (4 V + 4) read and V S 4 written (2.46 MB
// for the detector's 7 columns at 240x320, 0.73 us at 3.35 TB/s); the adds
// (N V) are far below that. A step's group loop is serial: the dump slot
// (the detector's non-support pixels, most of a step) costs up to 32
// dependent adds per column: a simple form, not a fast one. On an NVIDIA H100
// 80GB HBM3 at 700.00 W (chip_smoke.py, the detector's 7 columns into 257
// slots): 43.4 us at 480x640, 30.2 us at 240x320, 29.8 us at 192x256, where
// index_add_ in torch's deterministic mode takes 48.0 / 9.8 / 5.6 ms. The
// first form, where the group's lowest lane summed all V columns itself,
// took 145.4 us at 480x640.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxColumns = 8;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kSharedBytes = 48 * 1024;  // dynamic shared memory without opt-in
constexpr int kTargetBlocks = 132;       // one wave on an H100 SXM (132 SMs)

constexpr int kStage = kWarp + 1;  // staging row stride: lane v's reads of column v fall in distinct banks

// shared floats per warp: (V, S) accumulators and a (V, 33) staging block
__host__ __device__ inline int warp_floats(int V, int S) { return V * (S + kStage); }

__global__ void moments_block_kernel(const float* __restrict__ values, const int* __restrict__ slot,
                                     float* __restrict__ partial, int N, int V, int S, int ipw) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kWarp;
  const int j = threadIdx.x / kWarp;
  const int wpb = blockDim.x / kWarp;
  float* acc = smem + j * warp_floats(V, S);  // (V, S)
  float* stage = acc + V * S;                 // (V, kStage)
  for (int e = lane; e < V * S; e += kWarp) acc[e] = 0.0f;
  __syncwarp();

  const long begin = (static_cast<long>(blockIdx.x) * wpb + j) * ipw;
  const long end = min(static_cast<long>(N), begin + ipw);
  for (long base = begin; base < end; base += kWarp) {
    const long i = base + lane;
    const bool live = i < end;
    int s = live ? slot[i] : -1;
    if (s >= S) s = -1;
    for (int v = 0; v < V; ++v) stage[v * kStage + lane] = live ? values[static_cast<long>(v) * N + i] : 0.0f;
    const unsigned peers = __match_any_sync(0xffffffffu, s);
    __syncwarp();
    for (unsigned todo = __ballot_sync(0xffffffffu, s >= 0); todo;) {  // warp-uniform
      const int leader = __ffs(todo) - 1;
      const unsigned group = __shfl_sync(0xffffffffu, peers, leader);
      const int gs = __shfl_sync(0xffffffffu, s, leader);
      if (lane < V) {
        float sum = 0.0f;
        for (unsigned m = group; m; m &= m - 1) sum += stage[lane * kStage + __ffs(m) - 1];
        acc[lane * S + gs] += sum;
      }
      todo &= ~group;
    }
    __syncwarp();
  }
  __syncthreads();
  float* row = partial + static_cast<long>(blockIdx.x) * V * S;
  for (int e = threadIdx.x; e < V * S; e += blockDim.x) {
    float sum = 0.0f;
    for (int w = 0; w < wpb; ++w) sum += smem[w * warp_floats(V, S) + e];
    row[e] = sum;
  }
}

__global__ void moments_combine_kernel(const float* __restrict__ partial, float* __restrict__ out, int B, int VS) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= VS) return;
  float sum = 0.0f;
  for (int b = 0; b < B; ++b) sum += partial[static_cast<long>(b) * VS + e];
  out[e] = sum;
}

// The launch shape for (N, V, S): warps per block, items per warp and
// blocks (at most kTargetBlocks), or false when V or S is out of range.
bool launch_shape(int N, int V, int S, int* wpb, int* ipw, int* blocks) {
  if (N < 1 || V < 1 || V > kMaxColumns || S < 1) return false;
  const int per_warp = warp_floats(V, S) * static_cast<int>(sizeof(float));
  int w = kSharedBytes / per_warp;
  if (w < 1) return false;
  if (w > kMaxWarpsPerBlock) w = kMaxWarpsPerBlock;
  // blocks: about one wave, fewer where that leaves a warp under 256 items
  long b = (static_cast<long>(N) + 256L * w - 1) / (256L * w);
  if (b > kTargetBlocks) b = kTargetBlocks;
  long items = (static_cast<long>(N) + b * w - 1) / (b * w);
  items = (items + kWarp - 1) / kWarp * kWarp;
  *wpb = w;
  *ipw = static_cast<int>(items);
  *blocks = static_cast<int>((static_cast<long>(N) + items * w - 1) / (items * w));
  return true;
}

}  // namespace

extern "C" {

// values (V, N) float32, slot (N,) int32 -> out (V, S) float32 (every entry
// written), through partial, which must hold kTargetBlocks * V * S floats
// (kernels/lsd.py MOMENTS_BLOCKS); *n_launches is increased by the kernel
// launches made (2). Refuses V outside [1, 8] and S whose (V, S + 33) warp
// block does not fit 48 KB of shared memory.
int tpuslam_moments(const float* values, const int* slot, float* partial, float* out, int N, int V, int S,
                    int* n_launches, void* stream) {
  int wpb, ipw, blocks;
  if (!launch_shape(N, V, S, &wpb, &ipw, &blocks)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t shared = static_cast<size_t>(wpb) * warp_floats(V, S) * sizeof(float);
  moments_block_kernel<<<blocks, wpb * kWarp, shared, s>>>(values, slot, partial, N, V, S, ipw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*n_launches;
  const int VS = V * S;
  moments_combine_kernel<<<(VS + 255) / 256, 256, 0, s>>>(partial, out, blocks, VS);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*n_launches;
  return static_cast<int>(err);
}

}  // extern "C"
