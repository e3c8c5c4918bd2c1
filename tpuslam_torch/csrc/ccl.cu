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
// previous round's planes. An in-place (Gauss-Seidel) update converges
// faster and changes the labels; components longer than the propagation
// reach are meant to fragment (lsd.py), so a faster-converging variant is a
// different detector.
//
// What bounds it: the planes are 20 B/pixel (labels, max labels and compat
// in, labels and max labels out), 6.1 MB at 480x640, 1.8 us at 3.35 TB/s.
// The work is R rounds of a masked min and max per compat bit set: at most
// R x H x W x 16 integer operations (315 M at R = 64, 4.7 us at 67 T/s);
// the detector's planes set bits on ~21% of the pixels (5.6 bits each), so
// the operations these inputs need are ~47 M and the bytes bound the call.
// A kernel that sends the planes through L2/HBM on every round (the
// per-round form below: 64 launches of ~5 us, each under 0.2 us of work) is
// far from either.
//
// Design (ccl_tile_kernel): each block owns a TY x TX output tile and loads
// the (TY + 2k) x (TX + 2k) window around it into shared memory, reading the
// planes wrap-indexed ((y mod H), (x mod W)), as jnp.roll does. It then runs
// k synchronous rounds inside the window, ping-ponging between two buffers
// per channel, with __syncthreads() between rounds, and writes the centre
// tile. Round j updates only the cells at Chebyshev distance >= j from the
// window's edge (ring >= j): their inputs are exact after round j - 1, so
// after k rounds the centre (ring >= k) equals the full-torus iteration,
// for every input. The wrapped window is a faithful piece of the torus, also
// when it is larger than the image (several window cells then hold one
// pixel) and when the compat plane is non-zero on the border. (The Pallas
// kernel fills its halo with 0 compat instead, which is exact only for
// compat planes that are zero on the border.) The host runs ceil(R / k)
// launches per call, the last one with the remaining R - k (ceil(R / k) - 1)
// rounds, ping-ponging between global buffer pairs so the last launch writes
// the caller's outputs.
//
// A cell without compat bits never changes, so each round visits only the
// live cells (bits set, ring >= 1). At the start of a launch every thread
// issues its window loads into registers before storing any (the loads
// would otherwise wait on each other), both buffers are filled, and the
// block lists the live cells in shared memory, one word (bits << 24 | cell)
// each, bucketed by ring with the outer rings last (warp-aggregated shared
// atomics); round j then walks the first start[j - 1] words, the live cells
// at ring >= j, two per thread and step. The list's order within a ring
// varies from run to run; the result does not (integer min and max,
// Jacobi). The window's row stride is odd (WP = WW + 1 when WW is even), so
// the runs of a ring's side columns in the list fall in different banks.
//
// What holds it back: the rounds read scattered cells, ~19 shared-memory
// accesses per live cell and round with bank conflicts among the lanes of a
// warp, and the 64 rounds run one after another with a __syncthreads()
// between them; the heaviest tiles set each launch's time. More threads per
// block (512, 1024) and other tile shapes measured no faster.
//
// Shared memory per block: four int32 window planes (labels and max labels,
// two ping-pong buffers each) and the list, 20 B per window cell, dynamic
// (cudaFuncSetAttribute above 48 KB), plus the per-ring counters and the
// wrapped row and column indices in static shared memory. ptxas -v
// (sm_90a, nvcc of CUDA 12.8) and the 64-round call at 480x640 on the
// detector's planes, timed in two passes by a build of this file that held
// all four instances (chip_smoke.py of that build, NVIDIA H100 80GB HBM3,
// 700.00 W):
//
//   TY x TX, k    window (stride)   dynamic smem   registers, spills   blocks/SM   grid   launches   us per call
//   32 x 32, 8     48 x 48 (49)       47,040 B      45, none              4         300       8       159.7, 161.9
//   32 x 32, 16    64 x 64 (65)       83,200 B      64, 12 B spilled      2         300       4       185.2, 185.1
//   32 x 32, 32    96 x 96 (97)      186,240 B     128, none              1         300       2       270.5, 270.5
//   32 x 64, 16    64 x 96 (97)      124,160 B      94, none              1         150       4       175.7, 175.7
//
// The fastest, 32 x 32 with k = 8, is the only instance built
// (kernels/lsd.py CCL_TILE); fewer launches cost more halo work than they
// save in launches. (The per-round form: 360.6 us per call in the same run.)
// A change of tile measures the candidates again by adding their instances.
//
// The first form, one launch of ccl_round_kernel per round with all planes
// in device memory, stays as tpuslam_ccl_per_round: chip_smoke.py times it
// beside the tiled kernel and the card tests hold the two bit-equal. The
// detector never calls it.

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

constexpr int kThreads = 256;  // 512 and 1024 measured slower

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

template <int TY, int TX, int K>
struct Tile {
  static constexpr int WH = TY + 2 * K;
  static constexpr int WW = TX + 2 * K;
  // row stride in shared memory: odd, so the cells of a column fall in
  // different banks (a ring's side columns are runs of the list)
  static constexpr int WP = WW % 2 ? WW : WW + 1;
  static constexpr int N = WH * WP;
  // four int32 planes (two ping-pong buffers per channel) and the list of
  // live cells; plus small per-ring and per-row arrays in static shared memory
  static constexpr size_t kSmemBytes = static_cast<size_t>(N) * 5 * sizeof(int);
  static_assert(N < (1 << 16), "list words hold the cell in 16 bits");
};

// Distance of window cell w (row stride WP) from the window's edge, capped
// at K; -1 for the padding column.
template <int WH, int WW, int WP, int K>
__device__ __forceinline__ int ring_of(int w) {
  const int i = w / WP, c = w - (w / WP) * WP;
  return c >= WW ? -1 : min(min(min(i, WH - 1 - i), min(c, WW - 1 - c)), K);
}

// Claims consecutive slots of counter[key] for the lanes of the warp that
// share `key` (one shared atomic per key); returns this lane's slot. Every
// lane of the warp calls it; `live` lanes take part.
__device__ __forceinline__ int warp_claim(int* counter, bool live, int key) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned peers = __match_any_sync(0xffffffffu, live ? key : -1);
  int base = 0;
  if (live) {
    const int leader = __ffs(peers) - 1;
    if (static_cast<int>(lane) == leader) base = atomicAdd(&counter[key], __popc(peers));
    base = __shfl_sync(peers, base, leader);
  }
  return base + __popc(peers & ((1u << lane) - 1u));
}

// One live cell's update from list word v (bits << 24 | cell): the min of
// its label and its compatible neighbours' labels, the max of the max
// labels. Bit d reads the cell (r - dy[d], c - dx[d]) = i - dy[d] WP - dx[d].
template <int WP>
__device__ __forceinline__ void relax(unsigned v, const int* sl, const int* sm, int* lm, int* mm) {
  const int i = static_cast<int>(v & 0xffffu);
  const unsigned bits = v >> 24;
  int l = sl[i], m = sm[i];
  if (bits & 0x01u) { l = min(l, sl[i + WP + 1]); m = max(m, sm[i + WP + 1]); }  // (-1, -1)
  if (bits & 0x02u) { l = min(l, sl[i + WP]);     m = max(m, sm[i + WP]); }      // (-1,  0)
  if (bits & 0x04u) { l = min(l, sl[i + WP - 1]); m = max(m, sm[i + WP - 1]); }  // (-1,  1)
  if (bits & 0x08u) { l = min(l, sl[i + 1]);      m = max(m, sm[i + 1]); }       // ( 0, -1)
  if (bits & 0x10u) { l = min(l, sl[i - 1]);      m = max(m, sm[i - 1]); }       // ( 0,  1)
  if (bits & 0x20u) { l = min(l, sl[i - WP + 1]); m = max(m, sm[i - WP + 1]); }  // ( 1, -1)
  if (bits & 0x40u) { l = min(l, sl[i - WP]);     m = max(m, sm[i - WP]); }      // ( 1,  0)
  if (bits & 0x80u) { l = min(l, sl[i - WP - 1]); m = max(m, sm[i - WP - 1]); }  // ( 1,  1)
  *lm = l;
  *mm = m;
}

// `rounds` (1..K) synchronous rounds on the block's window; writes the
// centre tile of (lab_out, mx_out).
template <int TY, int TX, int K>
__global__ void __launch_bounds__(kThreads)
    ccl_tile_kernel(const int* __restrict__ lab_in, const int* __restrict__ mx_in,
                    const int* __restrict__ compat, int* __restrict__ lab_out,
                    int* __restrict__ mx_out, int H, int W, int rounds) {
  using T = Tile<TY, TX, K>;
  constexpr int WH = T::WH, WW = T::WW, WP = T::WP, N = T::N;
  extern __shared__ int smem[];
  int* const lab0 = smem;  // buffer 0 and 1 both start as the loaded window
  int* const lab1 = smem + N;
  int* const mx0 = smem + 2 * N;
  int* const mx1 = smem + 3 * N;
  unsigned* const list = reinterpret_cast<unsigned*>(smem + 4 * N);
  __shared__ int count[K + 1];  // live cells per ring
  __shared__ int start[K + 1];  // start[d - 1] = live cells at ring >= d
  __shared__ int cursor[K + 1];
  __shared__ long row_at[WH];  // wrapped image row of each window row, times W
  __shared__ int col_at[WW];   // wrapped image column of each window column

  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int ty0 = blockIdx.y * TY;
  const int tx0 = blockIdx.x * TX;
  for (int d = tid; d <= K; d += kThreads) count[d] = 0;
  for (int i = tid; i < WH; i += kThreads) row_at[i] = static_cast<long>(wrap(ty0 - K + i, H)) * W;
  for (int c = tid; c < WW; c += kThreads) col_at[c] = wrap(tx0 - K + c, W);
  __syncthreads();

  // 1: the window into registers, every load issued before the first use
  // (cell w = tid + t kThreads; the padding column reads column WW - 1)
  constexpr int kIter = (N + kThreads - 1) / kThreads;
  int vl[kIter], vm[kIter], vc[kIter];
#pragma unroll
  for (int t = 0; t < kIter; ++t) {
    const int w = min(tid + t * kThreads, N - 1);
    const int i = w / WP;
    const long g = row_at[i] + col_at[min(w - i * WP, WW - 1)];
    vl[t] = lab_in[g];
    vm[t] = mx_in[g];
    vc[t] = compat[g] & 0xff;  // only bits 0-7 are read
  }
  // 2: both buffers start as the window; count the live cells (compat
  // bits set, ring >= 1) by ring
#pragma unroll
  for (int t = 0; t < kIter; ++t) {
    const int w = tid + t * kThreads;
    const int d = w < N ? ring_of<WH, WW, WP, K>(w) : -1;
    if (w < N) {
      lab0[w] = lab1[w] = vl[t];
      mx0[w] = mx1[w] = vm[t];
    }
    warp_claim(count, d >= 1 && vc[t] != 0, d);
  }
  __syncthreads();
  if (tid == 0) {  // rings K, K - 1, ..., 1 in that order
    int s = 0;
    for (int d = K; d >= 1; --d) {
      cursor[d] = s;
      s += count[d];
      start[d - 1] = s;
    }
  }
  __syncthreads();
  // 3: the list, one word (bits << 24 | cell) per live cell, outer rings last
#pragma unroll
  for (int t = 0; t < kIter; ++t) {
    const int w = tid + t * kThreads;
    const int d = w < N ? ring_of<WH, WW, WP, K>(w) : -1;
    const bool live = d >= 1 && vc[t] != 0;
    const int slot = warp_claim(cursor, live, d);
    if (live) list[slot] = static_cast<unsigned>(vc[t]) << 24 | static_cast<unsigned>(w);
  }
  __syncthreads();

  for (int j = 1; j <= rounds; ++j) {
    const bool odd = j & 1;  // round j reads buffer (j - 1) & 1, writes j & 1
    const int* const sl = odd ? lab0 : lab1;
    const int* const sm = odd ? mx0 : mx1;
    int* const dl = odd ? lab1 : lab0;
    int* const dm = odd ? mx1 : mx0;
    const int n = start[j - 1];  // the live cells at ring >= j
    // two words per thread and step, both read before either is written
    for (int e = tid; e < n; e += 2 * kThreads) {
      const unsigned v1 = list[e];
      const unsigned v2 = e + kThreads < n ? list[e + kThreads] : v1;
      int l1, m1, l2, m2;
      relax<WP>(v1, sl, sm, &l1, &m1);
      relax<WP>(v2, sl, sm, &l2, &m2);
      dl[v1 & 0xffffu] = l1;
      dm[v1 & 0xffffu] = m1;
      dl[v2 & 0xffffu] = l2;  // v2 == v1 writes the same values again
      dm[v2 & 0xffffu] = m2;
    }
    __syncthreads();
  }

  const int* const fl = (rounds & 1) ? lab1 : lab0;
  const int* const fm = (rounds & 1) ? mx1 : mx0;
  for (int e = tid; e < TY * TX; e += kThreads) {
    const int i = e / TX, c = e - (e / TX) * TX;
    if (ty0 + i < H && tx0 + c < W) {
      const long g = static_cast<long>(ty0 + i) * W + tx0 + c;
      lab_out[g] = fl[(i + K) * WP + c + K];
      mx_out[g] = fm[(i + K) * WP + c + K];
    }
  }
}

template <int TY, int TX, int K>
cudaError_t run_tiles(const int* lab0, const int* mx0, const int* compat, int* lab_out,
                      int* mx_out, int* lab_tmp, int* mx_tmp, int H, int W, int rounds,
                      cudaStream_t s, int* n_launches) {
  using T = Tile<TY, TX, K>;
  auto kernel = ccl_tile_kernel<TY, TX, K>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(T::kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 block(32, kThreads / 32);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  const int n = (rounds + K - 1) / K;
  // launch t writes `out` when n - 1 - t is even, so the last one does
  const int* src_l = lab0;
  const int* src_m = mx0;
  for (int t = 0; t < n; ++t) {
    const int kr = t == n - 1 ? rounds - K * (n - 1) : K;
    const bool to_out = ((n - 1 - t) % 2) == 0;
    int* dst_l = to_out ? lab_out : lab_tmp;
    int* dst_m = to_out ? mx_out : mx_tmp;
    kernel<<<grid, block, T::kSmemBytes, s>>>(src_l, src_m, compat, dst_l, dst_m, H, W, kr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*n_launches;
    src_l = dst_l;
    src_m = dst_m;
  }
  return cudaSuccess;
}

cudaError_t copy_inputs(const int* lab0, const int* mx0, int* lab_out, int* mx_out, int H, int W,
                        cudaStream_t s) {
  const size_t bytes = static_cast<size_t>(H) * W * sizeof(int);
  cudaError_t err = cudaMemcpyAsync(lab_out, lab0, bytes, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return err;
  return cudaMemcpyAsync(mx_out, mx0, bytes, cudaMemcpyDeviceToDevice, s);
}

}  // namespace

extern "C" {

// `rounds` synchronous rounds from (lab0, mx0) under `compat`; the result
// lands in (lab_out, mx_out). (lab_tmp, mx_tmp) are scratch planes of the
// same (H, W) int32 shape. The inputs are not modified. (tile_y, tile_x, k)
// must be the built instance, (32, 32, 8) (others: cudaErrorInvalidValue);
// *n_launches is increased by the kernel launches made (ceil(rounds / k)).
int tpuslam_ccl(const int* lab0, const int* mx0, const int* compat, int* lab_out, int* mx_out,
                int* lab_tmp, int* mx_tmp, int H, int W, int rounds, int tile_y, int tile_x, int k,
                int* n_launches, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rounds < 0 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (tile_y != 32 || tile_x != 32 || k != 8) return static_cast<int>(cudaErrorInvalidValue);
  if (rounds == 0) return static_cast<int>(copy_inputs(lab0, mx0, lab_out, mx_out, H, W, s));
  return run_tiles<32, 32, 8>(lab0, mx0, compat, lab_out, mx_out, lab_tmp, mx_tmp, H, W, rounds,
                              s, n_launches);
}

// The per-round form: one launch of ccl_round_kernel per round, same arguments
// and result as tpuslam_ccl without the tile.
int tpuslam_ccl_per_round(const int* lab0, const int* mx0, const int* compat, int* lab_out,
                          int* mx_out, int* lab_tmp, int* mx_tmp, int H, int W, int rounds,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rounds < 0 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rounds == 0) return static_cast<int>(copy_inputs(lab0, mx0, lab_out, mx_out, H, W, s));
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
