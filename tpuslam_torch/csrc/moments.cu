// The detector's component statistics for Hopper (sm_90a): fixed-order sums
// without float atomics, one launch per call.
//
// The JAX package reduces the detector's per-component statistics over a
// virtual (K, N) one-hot that XLA fuses into its reductions (tpuslam/kernels/
// lsd.py detect_lines: the seven moments, `red`, then the extents and the
// normal moment, t_min / t_max / sn2) and merge_collinear's segment_sum; there
// is no Pallas kernel behind them. Three kernels take their place:
//
//   component_moments_kernel: labels (N,) int32, mag (N,) float32, support
//     (N,) uint8 and K root ids -> (7, K): per component k the sums over its
//     members (the pixels whose label is roots[k]) of 1 if supported, w, w x,
//     w y, (w x) x, (w y) y, (w x) y with w = support ? mag : 0, x and y the
//     pixel's column and row, each product rounded as the plain version
//     rounds it (the library builds with --fmad=false).
//   component_extents_kernel: the same planes and roots plus each
//     component's centroid (cx, cy) and direction ev -> (3, K): t_min and
//     t_max of t = (x - cx) ev.x + (y - cy) ev.y over the members (+inf and
//     -inf for a component without one), and sn2, the sum of (w tn) tn with
//     tn = -(x - cx) ev.y + (y - cy) ev.x.
//   segment_sums_kernel<V>: values (V, N) float32 by an int32 slot into
//     (V, S), one block: merge_collinear's 7 columns over 256 segments.
//
// Membership. Each block puts the K roots into a hash table in shared memory
// (open addressing, 4K or more cells, inserted by atomicCAS; the roots are
// distinct and in [0, N), as the detector's are, so whichever cell a root
// lands in, a lookup finds it, and a label outside [0, N), the non-support
// label N, needs no lookup). Nothing is summed for the pixels that belong to
// no chosen component, which the replaced form summed into a dump slot that
// both callers threw away, and no (7, N) column stack is written first.
//
// Order. The wrapper (kernels/lsd.py sum_partition) gives block b's warp j
// (16 warps a block) the contiguous items [(16 b + j) ipw, (16 b + j + 1)
// ipw); blocks and ipw depend on N alone. Every sum is
//
//   out[c][k] = sum over the groups of 8 blocks, in order, of
//               sum over the group's blocks, in order, of
//               sum over the block's warps, in order, of
//               sum over the warp's 32-item steps, in order, of
//               a pairwise tree over the step's members of k by their rank
//               in item order (rank r takes rank r + d for d = 1, 2, 4, ...
//               where r is a multiple of 2 d),
//
// each sum but the tree from +0.0f, left to right in float32 (a block or a
// warp without members of k adds +0.0, which changes nothing: no such sum is
// -0.0). Within a step the members of one component find each other by
// __match_any_sync, the tree runs on shuffles (__fns finds the lane d ranks
// on), and the group's first lane adds the sums into the warp's (C, K) row in
// shared memory; groups have distinct slots, so no two lanes write one
// entry. The order depends on the shapes and the data only, never on
// timing; tests/torch_sum_model.py models it in numpy, and a card test holds
// the kernels to the model bit for bit.
//
// Extents. t_min and t_max are exact in any order. Each member forms two
// 64-bit keys: the high word an order-preserving encoding of t with -0.0
// taken as +0.0, the low word the item index (its complement for the
// maximum); the step's tree takes their least and greatest beside the sums,
// and the group's first lane puts them into the block's shared-memory
// atomicMin / atomicMax. So among equal values the first item in item order
// wins, and the last block recomputes t of the winning item: -0.0 against
// +0.0 is settled as torch.scatter_reduce's amin and amax settle it on the
// CPU (the first in item order is kept), bit for bit. Inputs are finite (the
// detector's are).
//
// Batches: the _batch entry points take B images of one shape in one launch,
// grid (blocks, B) for the component kernels (blockIdx.y the image) and B
// blocks for the merge's. Each image has its own roots, scratch rows,
// output and set of 17 ticket counters, so one image's last-block combine
// counts only its own blocks, and every image is summed in the order of its
// single-image call: bit for bit the same result. The single-image entry
// points are the batch of one.
//
// One launch per call. Each block writes its row (every entry); the last
// block of each group of 8 to draw a ticket (__threadfence(), atomicAdd on a
// device counter) sums the group's rows in block order into a group row,
// and the last group to draw sums the group rows in group order into the
// output. Each counter is set back to 0 by the block that draws its last
// ticket, so the next call (or a replayed CUDA graph) finds it at 0. The
// wrapper keeps one set of counters per device; calls on one stream run one
// after another. The merge's block gives each warp 32 slots; 32 items at a
// time, in item order, each item of the warp's slots goes by shuffle to its
// slot's lane, which adds it: the order of the plain version (index_add_ on
// the CPU), so the two are bit-equal.
//
// What bounds it: the bytes, N (4 + 4 + 1) read for the planes at 240x320
// (0.69 MB, 0.21 us at 3.35 TB/s); the arithmetic is a few operations per
// member. What holds it far from that bound on this card: a step costs the
// SM a few hundred instructions (the lookup, the columns, the match, the
// tree's shuffles), and the combine waits on L2 latency. What the design
// does about it: one pass over the planes, every load of a chunk in flight
// under the table's build and the previous chunk's work, members only, up
// to 128 blocks so that the steps spread over the SMs, and a two-level
// combine so that no block reads more than 16 rows.
//
// The replaced form, tpuslam_moments (two launches: warp-grouped sums into
// (B, V, S) partial rows, then a combine kernel; V value columns that the
// caller stacked, every item summed, the dump slot included), stays for
// timing beside the new kernels; the detector no longer calls it. On an
// NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py) it took 47.4 / 30.6 /
// 29.7 us for the detector's 7 columns at 480x640 / 240x320 / 192x256.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// ---- component sums -------------------------------------------------------

constexpr int kSumWarps = 16;  // warps per block (kernels/lsd.py SUM_WARPS)
constexpr int kSumThreads = kSumWarps * kWarp;
constexpr int kMaxBlocks = 128;  // kernels/lsd.py SUM_MAX_BLOCKS
constexpr int kGroup = 8;        // blocks whose rows the last of them combines (kernels/lsd.py SUM_GROUP)
constexpr int kUnroll = 4;       // 32-item steps of one chunk of loads
constexpr int kMaxRoots = 1024;
constexpr int kMaxShared = 226 * 1024;  // dynamic shared memory, below the 227 KB a block may opt in to
constexpr int kEmpty = -1;
constexpr int kMomentColumns = 7;
constexpr int kCounters = 1 + kMaxBlocks / kGroup;  // ticket counters per image: the groups', then each group's

// log2 of the hash table's cells: the least power of two >= 4 K (at least 32)
__host__ __device__ inline int table_bits(int K) {
  int b = 5;
  while ((1 << b) < 4 * K) ++b;
  return b;
}

__device__ inline unsigned hash_of(int label, int tbits) {
  return (static_cast<unsigned>(label) * 2654435761u) >> (32 - tbits);
}

// roots -> (key, slot) cells; every thread of the block calls it
__device__ void build_table(const long long* __restrict__ roots, int K, int* key, int* val, int tbits) {
  const int T = 1 << tbits;
  for (int e = threadIdx.x; e < T; e += blockDim.x) key[e] = kEmpty;
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int r = static_cast<int>(roots[k]);
    unsigned h = hash_of(r, tbits);
    while (atomicCAS(&key[h], kEmpty, r) != kEmpty) h = (h + 1) & (T - 1);
    val[h] = k;
  }
  __syncthreads();
}

// the slot of a label, or -1 when it is no root
__device__ inline int slot_of(const int* key, const int* val, int tbits, int label) {
  const unsigned m = (1u << tbits) - 1;
  for (unsigned h = hash_of(label, tbits);; h = (h + 1) & m) {
    const int k = key[h];
    if (k == kEmpty) return -1;
    if (k == label) return val[h];
  }
}

// One chunk of a warp's items: kUnroll steps of 32, every load issued at
// once (the label, magnitude and support of each item; a warp waits on
// memory, not on bandwidth, so the 5 bytes a non-member did not need are
// cheaper than a second round trip).
struct Chunk {
  int label[kUnroll];
  float mag[kUnroll];
  bool sup[kUnroll];
};

__device__ inline void load_chunk(Chunk& ch, const int* __restrict__ labels, const float* __restrict__ mag,
                                  const unsigned char* __restrict__ support, long base, long end, int lane) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long i = base + u * kWarp + lane;
    const bool live = i < end;
    ch.label[u] = live ? labels[i] : kEmpty;
    ch.mag[u] = live ? mag[i] : 0.0f;
    ch.sup[u] = live && support[i] != 0;
  }
}

// A member's 64-bit extreme keys (the extents kernel's; the moments kernel
// passes none): the least and the greatest of a group's, then of a block's.
struct Keys {
  unsigned long long lo = ~0ull, hi = 0ull;
};

// One 32-item step: the lanes with one slot (s >= 0) sum their C columns in
// a fixed tree over their ranks in item order (rank r takes rank r + d for
// d = 1, 2, 4, ... where r is a multiple of 2 d), taking the least and the
// greatest of their keys in the same tree, and the group's first lane adds
// the sums into the warp's zeroed (C, K) row (and its keys into the block's
// kmin / kmax by shared-memory atomicMin / atomicMax, exact in any order).
// Groups have distinct slots, so no two lanes write one entry of a row.
// Warp-uniform.
template <int C, bool kKeys>
__device__ void add_step(float* acc, int K, int lane, int s, float (&v)[C], Keys& key, unsigned long long* kmin,
                         unsigned long long* kmax) {
  const unsigned peers = __match_any_sync(kFull, s);
  const int rank = __popc(peers & ((1u << lane) - 1));
  const int most = __reduce_max_sync(kFull, s >= 0 ? static_cast<unsigned>(__popc(peers)) : 0u);
  for (int d = 1; d < most; d <<= 1) {
    const unsigned src = __fns(peers, lane, d + 1);  // the group's lane d ranks on (this lane is its first), or ~0u
    const bool take = (rank & (2 * d - 1)) == 0 && src != 0xffffffffu;
    const int from = take ? static_cast<int>(src) : lane;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float got = __shfl_sync(kFull, v[c], from);
      if (take) v[c] += got;
    }
    if (kKeys) {
      const unsigned long long lo = __shfl_sync(kFull, key.lo, from), hi = __shfl_sync(kFull, key.hi, from);
      if (take) {
        key.lo = lo < key.lo ? lo : key.lo;
        key.hi = hi > key.hi ? hi : key.hi;
      }
    }
  }
  if (rank == 0 && s >= 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c * K + s] += v[c];
    if (kKeys) {
      atomicMin(&kmin[s], key.lo);
      atomicMax(&kmax[s], key.hi);
    }
  }
}

// Shared memory of a component kernel, in 4-byte words: the table (2 T),
// then the warps' (C, K) rows.
__host__ __device__ inline int acc_offset(int K) { return 2 << table_bits(K); }
__host__ __device__ inline int shared_words(int K, int C) { return acc_offset(K) + kSumWarps * C * K; }

// The block's row: its warps' rows summed in warp order, every entry.
template <int C>
__device__ void write_block_row(const float* acc_all, int K, float* __restrict__ row) {
  __syncthreads();
  for (int e = threadIdx.x; e < C * K; e += blockDim.x) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) sum += acc_all[w * C * K + e];
    row[e] = sum;
  }
}

// One ticket of a counter that `count` blocks draw: true in the block that
// draws the last, which sets the counter back to 0 (every other block has
// drawn by then) and then sees every row the others wrote before drawing.
// Every thread of the block calls it.
__device__ bool last_to_arrive(unsigned* counter, unsigned count) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1u) == count - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

constexpr int kRowBatch = 8;  // rows of a combine whose loads are in flight at once
constexpr int kPerThread = 4;  // entries of one row a thread combines at once

// out[e] = rows 0 .. count - 1 (n floats each) summed in order, the loads of
// kRowBatch rows x kPerThread entries in flight per thread (a combine waits
// on L2 latency, not bandwidth; the loads take clamped indices, so none
// waits on a condition).
__device__ void combine_rows(const float* __restrict__ rows, int count, float* __restrict__ out, int n) {
  for (int e0 = threadIdx.x; e0 < n; e0 += blockDim.x * kPerThread) {
    float sum[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) sum[q] = 0.0f;
    for (int b0 = 0; b0 < count; b0 += kRowBatch) {
      float r[kPerThread][kRowBatch];
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const int e = min(e0 + q * static_cast<int>(blockDim.x), n - 1);
#pragma unroll
        for (int j = 0; j < kRowBatch; ++j) r[q][j] = __ldcg(rows + static_cast<long>(min(b0 + j, count - 1)) * n + e);
      }
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
#pragma unroll
        for (int j = 0; j < kRowBatch; ++j)
          if (b0 + j < count) sum[q] += r[q][j];
      }
    }
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int e = e0 + q * blockDim.x;
      if (e < n) out[e] = sum[q];
    }
  }
}

// The same for (2, K) rows of extreme keys: the least of the first halves
// and the greatest of the second (exact in any order).
__device__ void combine_keys(const unsigned long long* __restrict__ rows, int count, unsigned long long* out, int K) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    unsigned long long lo = ~0ull, hi = 0ull;
    for (int b0 = 0; b0 < count; b0 += kRowBatch) {
      unsigned long long bl[kRowBatch], bh[kRowBatch];
#pragma unroll
      for (int j = 0; j < kRowBatch; ++j) {
        const long row = static_cast<long>(min(b0 + j, count - 1)) * 2;
        bl[j] = __ldcg(rows + row * K + k);
        bh[j] = __ldcg(rows + (row + 1) * K + k);
      }
#pragma unroll
      for (int j = 0; j < kRowBatch; ++j) {
        lo = bl[j] < lo ? bl[j] : lo;
        hi = bh[j] > hi ? bh[j] : hi;
      }
    }
    out[k] = lo;
    out[K + k] = hi;
  }
}

// Blocks [g kGroup, (g + 1) kGroup) form group g; counters[0] is the groups'
// ticket, counters[1 + g] group g's.
__device__ inline int group_size(int g) { return min(kGroup, static_cast<int>(gridDim.x) - g * kGroup); }
__device__ inline int group_count() { return (gridDim.x + kGroup - 1) / kGroup; }
// An image's (blocks + groups) scratch rows: blockIdx.y picks the image of a batch.
__device__ inline long image_rows() { return static_cast<long>(gridDim.x) + group_count(); }

// order-preserving 32 bits of a finite float, -0.0 taken as +0.0
__device__ inline unsigned long long order_bits(float t) {
  const int b = t == 0.0f ? 0 : __float_as_int(t);
  return static_cast<unsigned long long>(static_cast<unsigned>(b >= 0 ? b : b ^ 0x7fffffff) ^ 0x80000000u);
}

// t and tn of item i in component (cx, cy, ex, ey), rounded as the plain version rounds them
__device__ inline void along(int i, int W, float cx, float cy, float ex, float ey, float* t, float* tn) {
  const float relx = static_cast<float>(i % W) - cx, rely = static_cast<float>(i / W) - cy;
  *t = relx * ex + rely * ey;
  *tn = -relx * ey + rely * ex;
}

// The per-item loop of both component kernels: the table built, then each
// warp's chunks, the next one's loads in flight while this one is summed;
// item(i, slot, mag, sup, v, keys) fills the C columns (and the keys) of a
// member.
template <int C, bool kKeys, typename Item>
__device__ void sum_items(const int* __restrict__ labels, const float* __restrict__ mag,
                          const unsigned char* __restrict__ support, const long long* __restrict__ roots, int* smem,
                          int N, int K, int ipw, Item item, unsigned long long* kmin = nullptr,
                          unsigned long long* kmax = nullptr) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int tbits = table_bits(K);
  int* key = smem;
  int* val = key + (1 << tbits);
  float* acc = reinterpret_cast<float*>(smem + acc_offset(K)) + warp * C * K;
  const long begin = (static_cast<long>(blockIdx.x) * kSumWarps + warp) * ipw;
  const long end = min(static_cast<long>(N), begin + ipw);
  constexpr int kStride = kWarp * kUnroll;
  Chunk next;
  load_chunk(next, labels, mag, support, begin, end, lane);  // in flight while the table is built
  for (int e = lane; e < C * K; e += kWarp) acc[e] = 0.0f;
  build_table(roots, K, key, val, tbits);
  for (long base = begin; base < end; base += kStride) {
    const Chunk cur = next;
    if (base + kStride < end) load_chunk(next, labels, mag, support, base + kStride, end, lane);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // a label outside [0, N) (the non-support label N) is no root: no lookup
      const int label = cur.label[u];
      const int s = static_cast<unsigned>(label) >= static_cast<unsigned>(N) ? -1 : slot_of(key, val, tbits, label);
      if (!__any_sync(kFull, s >= 0)) continue;
      float v[C];
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = 0.0f;
      Keys keys;
      if (s >= 0) item(static_cast<int>(base) + u * kWarp + lane, s, cur.mag[u], cur.sup[u], v, keys);
      add_step<C, kKeys>(acc, K, lane, s, v, keys, kmin, kmax);
    }
  }
}

__global__ void __launch_bounds__(kSumThreads)
component_moments_kernel(const int* __restrict__ labels, const float* __restrict__ mag,
                         const unsigned char* __restrict__ support, const long long* __restrict__ roots,
                         float* __restrict__ partial, unsigned* counters, float* __restrict__ out, int N, int W, int K,
                         int ipw) {
  constexpr int C = kMomentColumns;
  extern __shared__ __align__(16) int smem[];
  // image blockIdx.y of the batch: its planes, roots, scratch rows, counters and output
  const long z = blockIdx.y;
  labels += z * N;
  mag += z * N;
  support += z * N;
  roots += z * K;
  partial += z * image_rows() * C * K;
  counters += z * kCounters;
  out += z * C * K;
  sum_items<C, false>(labels, mag, support, roots, smem, N, K, ipw, [W](int i, int, float m, bool sp, float (&v)[C], Keys&) {
    const float x = static_cast<float>(i % W), y = static_cast<float>(i / W);
    const float w = sp ? m : 0.0f;
    const float wx = w * x, wy = w * y;
    v[0] = sp ? 1.0f : 0.0f;
    v[1] = w;
    v[2] = wx;
    v[3] = wy;
    v[4] = wx * x;
    v[5] = wy * y;
    v[6] = wx * y;
  });
  // rows: the blocks' (B, C, K), then the groups' (G, C, K)
  const int B = gridDim.x, g = blockIdx.x / kGroup, n = C * K;
  float* group_rows = partial + static_cast<long>(B) * n;
  write_block_row<C>(reinterpret_cast<float*>(smem + acc_offset(K)), K, partial + static_cast<long>(blockIdx.x) * n);
  if (!last_to_arrive(counters + 1 + g, group_size(g))) return;
  combine_rows(partial + static_cast<long>(g) * kGroup * n, group_size(g), group_rows + static_cast<long>(g) * n, n);
  if (!last_to_arrive(counters, group_count())) return;
  combine_rows(group_rows, group_count(), out, n);
}

__global__ void __launch_bounds__(kSumThreads)
component_extents_kernel(const int* __restrict__ labels, const float* __restrict__ mag,
                         const unsigned char* __restrict__ support, const long long* __restrict__ roots,
                         const float* __restrict__ cx, const float* __restrict__ cy, const float* __restrict__ ev,
                         float* __restrict__ partial, unsigned long long* __restrict__ keys, unsigned* counters,
                         float* __restrict__ out, int N, int W, int K, int ipw) {
  extern __shared__ __align__(16) int smem[];
  // image blockIdx.y of the batch, as in component_moments_kernel
  const long z = blockIdx.y;
  labels += z * N;
  mag += z * N;
  support += z * N;
  roots += z * K;
  cx += z * K;
  cy += z * K;
  ev += z * 2 * K;
  partial += z * image_rows() * K;
  keys += z * image_rows() * 2 * K;
  counters += z * kCounters;
  out += z * 3 * K;
  // 8-byte arrays first: the block's min and max keys (K each), then the
  // components' cx, cy, ev.x, ev.y (K each), then the common layout
  unsigned long long* kmin = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* kmax = kmin + K;
  float* cen = reinterpret_cast<float*>(kmax + K);
  int* rest = reinterpret_cast<int*>(cen + 4 * K);
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    kmin[k] = ~0ull;
    kmax[k] = 0ull;
    cen[k] = cx[k];
    cen[K + k] = cy[k];
    cen[2 * K + k] = ev[2 * k];
    cen[3 * K + k] = ev[2 * k + 1];
  }  // the table's first __syncthreads orders these before any use
  sum_items<1, true>(
      labels, mag, support, roots, rest, N, K, ipw,
      [W, K, cen](int i, int k, float m, bool sp, float (&v)[1], Keys& key) {
        float t, tn;
        along(i, W, cen[k], cen[K + k], cen[2 * K + k], cen[3 * K + k], &t, &tn);
        const unsigned long long hi = order_bits(t) << 32;
        key.lo = hi | static_cast<unsigned>(i);
        key.hi = hi | (0xffffffffu - static_cast<unsigned>(i));
        const float w = sp ? m : 0.0f;
        v[0] = w * tn * tn;
      },
      kmin, kmax);
  // rows: the blocks' sn2 (B, K) and keys (B, 2, K), then the groups'
  const int B = gridDim.x, g = blockIdx.x / kGroup;
  float* group_rows = partial + static_cast<long>(B) * K;
  unsigned long long* group_keys = keys + static_cast<long>(B) * 2 * K;
  write_block_row<1>(reinterpret_cast<float*>(rest + acc_offset(K)), K, partial + static_cast<long>(blockIdx.x) * K);
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    keys[(static_cast<long>(blockIdx.x) * 2) * K + k] = kmin[k];
    keys[(static_cast<long>(blockIdx.x) * 2 + 1) * K + k] = kmax[k];
  }
  if (!last_to_arrive(counters + 1 + g, group_size(g))) return;
  combine_rows(partial + static_cast<long>(g) * kGroup * K, group_size(g), group_rows + static_cast<long>(g) * K, K);
  combine_keys(keys + static_cast<long>(g) * kGroup * 2 * K, group_size(g), group_keys + static_cast<long>(g) * 2 * K, K);
  if (!last_to_arrive(counters, group_count())) return;
  combine_rows(group_rows, group_count(), out + 2 * K, K);  // sn2
  combine_keys(group_keys, group_count(), kmin, K);  // into the block's own kmin, kmax (kmax = kmin + K)
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const unsigned long long lo = kmin[k], hi = kmax[k];
    float t_min = __int_as_float(0x7f800000), t_max = -__int_as_float(0x7f800000), tn;
    if (lo != ~0ull) {  // the component has a member: recompute t of the winning items
      along(static_cast<int>(lo & 0xffffffffu), W, cen[k], cen[K + k], cen[2 * K + k], cen[3 * K + k], &t_min, &tn);
      along(static_cast<int>(0xffffffffu - (hi & 0xffffffffu)), W, cen[k], cen[K + k], cen[2 * K + k], cen[3 * K + k],
            &t_max, &tn);
    }
    out[k] = t_min;
    out[K + k] = t_max;
  }
}

// ---- the merge's sum: one block -------------------------------------------

constexpr int kMaxColumns = 8;
constexpr int kChunk = 256;  // items staged in shared memory at a time

template <int V>
__global__ void segment_sums_kernel(const float* __restrict__ values, const int* __restrict__ slot,
                                    float* __restrict__ out, int N, int S) {
  __shared__ float vals[V * kChunk];
  __shared__ int slots[kChunk];
  // one block per image of the batch
  values += static_cast<long>(blockIdx.x) * V * N;
  slot += static_cast<long>(blockIdx.x) * N;
  out += static_cast<long>(blockIdx.x) * V * S;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  for (int s0 = 0; s0 < S; s0 += blockDim.x) {
    const int first = s0 + warp * kWarp;  // this warp's slots: first + lane
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    for (int base = 0; base < N; base += kChunk) {
      const int n = min(kChunk, N - base);
      __syncthreads();
      for (int e = threadIdx.x; e < n; e += blockDim.x) {  // every load of the chunk in flight at once
        slots[e] = slot[base + e];
#pragma unroll
        for (int v = 0; v < V; ++v) vals[v * kChunk + e] = values[static_cast<long>(v) * N + base + e];
      }
      __syncthreads();
      // 32 items at a time, in item order: each item of this warp's slots
      // goes to its slot's lane, which adds it
      for (int e0 = 0; e0 < n; e0 += kWarp) {
        const int e = e0 + lane;
        const int q = e < n ? slots[e] - first : -1;
        float x[V];
#pragma unroll
        for (int v = 0; v < V; ++v) x[v] = e < n ? vals[v * kChunk + e] : 0.0f;
        for (unsigned todo = __ballot_sync(kFull, q >= 0 && q < kWarp && first + q < S); todo; todo &= todo - 1) {
          const int src = __ffs(todo) - 1;
          const int target = __shfl_sync(kFull, q, src);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float got = __shfl_sync(kFull, x[v], src);
            if (lane == target) acc[v] += got;
          }
        }
      }
    }
    if (first + lane < S) {
#pragma unroll
      for (int v = 0; v < V; ++v) out[static_cast<long>(v) * S + first + lane] = acc[v];
    }
  }
}

// The component kernels' launch checks: the partition covers [0, N) with
// whole steps, and the shared memory fits.
bool component_shape(int H, int W, int K, int blocks, int ipw, size_t shared) {
  const long N = static_cast<long>(H) * W;
  return H >= 1 && W >= 1 && K >= 1 && K <= kMaxRoots && blocks >= 1 && blocks <= kMaxBlocks && ipw >= kWarp &&
         ipw % kWarp == 0 && static_cast<long>(blocks) * kSumWarps * ipw >= N &&
         static_cast<long>(blocks - 1) * kSumWarps * ipw < N && shared <= static_cast<size_t>(kMaxShared);
}

// ---- the replaced form: two launches over stacked columns ------------------

constexpr int kStage = kWarp + 1;  // staging row stride: lane c's reads of column c fall in distinct banks

// shared floats per warp: (V, S) accumulators and a (V, 33) staging block
__host__ __device__ inline int warp_floats(int V, int S) { return V * (S + kStage); }

constexpr int kTwoLaunchWarps = 8;
constexpr int kSharedBytes = 48 * 1024;  // dynamic shared memory without opt-in

__global__ void moments_block_kernel(const float* __restrict__ values, const int* __restrict__ slot,
                                     float* __restrict__ partial, int N, int V, int S, int ipw) {
  extern __shared__ float fmem[];
  const int lane = threadIdx.x % kWarp;
  const int j = threadIdx.x / kWarp;
  const int wpb = blockDim.x / kWarp;
  float* acc = fmem + j * warp_floats(V, S);  // (V, S)
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
    const unsigned peers = __match_any_sync(kFull, s);
    __syncwarp();
    for (unsigned todo = __ballot_sync(kFull, s >= 0); todo;) {  // warp-uniform
      const int leader = __ffs(todo) - 1;
      const unsigned group = __shfl_sync(kFull, peers, leader);
      const int gs = __shfl_sync(kFull, s, leader);
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
    for (int w = 0; w < wpb; ++w) sum += fmem[w * warp_floats(V, S) + e];
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

// The replaced form's launch shape for (N, V, S): warps per block, items per
// warp and blocks (at most kMaxBlocks), or false when V or S is out of range.
bool two_launch_shape(int N, int V, int S, int* wpb, int* ipw, int* blocks) {
  if (N < 1 || V < 1 || V > kMaxColumns || S < 1) return false;
  const int per_warp = warp_floats(V, S) * static_cast<int>(sizeof(float));
  int w = kSharedBytes / per_warp;
  if (w < 1) return false;
  if (w > kTwoLaunchWarps) w = kTwoLaunchWarps;
  // blocks: about one wave, fewer where that leaves a warp under 256 items
  long b = (static_cast<long>(N) + 256L * w - 1) / (256L * w);
  if (b > kMaxBlocks) b = kMaxBlocks;
  long items = (static_cast<long>(N) + b * w - 1) / (b * w);
  items = (items + kWarp - 1) / kWarp * kWarp;
  *wpb = w;
  *ipw = static_cast<int>(items);
  *blocks = static_cast<int>((static_cast<long>(N) + items * w - 1) / (items * w));
  return true;
}

}  // namespace

extern "C" {

// labels (B, H, W) int32, mag (B, H, W) float32, support (B, H, W) uint8
// (bool), roots (B, K) int64 (distinct within an image, in [0, H W)) -> out
// (B, 7, K) float32, in one launch: grid (blocks, B), blockIdx.y the image,
// each image summed in its single-image order (bit for bit its call alone).
// partial holds B (blocks + groups) * 7 * K floats, groups = ceil(blocks /
// 8); counters are B sets of 17 ticket counters (0 between calls; each
// image's blocks draw their own set). blocks and ipw come from
// kernels/lsd.py sum_partition; the function refuses any partition that
// does not cover the plane in whole steps with at most 128 blocks, K outside
// [1, 1024] or whose shared memory exceeds 226 KB (K > 480 here), and B
// outside [1, 65535]. *n_launches is increased by the launches made (1).
int tpuslam_component_moments_batch(const int* labels, const float* mag, const unsigned char* support,
                                    const long long* roots, float* partial, unsigned* counters, float* out, int B,
                                    int H, int W, int K, int blocks, int ipw, int* n_launches, void* stream) {
  const size_t shared = static_cast<size_t>(shared_words(K, kMomentColumns)) * 4;
  if (!component_shape(H, W, K, blocks, ipw, shared) || B < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(component_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  component_moments_kernel<<<dim3(blocks, B), kSumThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      labels, mag, support, roots, partial, counters, out, H * W, W, K, ipw);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*n_launches;
  return static_cast<int>(err);
}

// One image: the batch of one.
int tpuslam_component_moments(const int* labels, const float* mag, const unsigned char* support,
                              const long long* roots, float* partial, unsigned* counters, float* out, int H, int W,
                              int K, int blocks, int ipw, int* n_launches, void* stream) {
  return tpuslam_component_moments_batch(labels, mag, support, roots, partial, counters, out, 1, H, W, K, blocks,
                                         ipw, n_launches, stream);
}

// The same planes and roots, cx (B, K), cy (B, K), ev (B, K, 2) float32 ->
// out (B, 3, K): t_min, t_max, sn2. partial holds B (blocks + groups) * K
// floats, keys B (blocks + groups) * 2 * K 64-bit words; the rest as
// tpuslam_component_moments_batch.
int tpuslam_component_extents_batch(const int* labels, const float* mag, const unsigned char* support,
                                    const long long* roots, const float* cx, const float* cy, const float* ev,
                                    float* partial, unsigned long long* keys, unsigned* counters, float* out, int B,
                                    int H, int W, int K, int blocks, int ipw, int* n_launches, void* stream) {
  const size_t shared = static_cast<size_t>(K) * (2 * 8 + 4 * 4) + static_cast<size_t>(shared_words(K, 1)) * 4;
  if (!component_shape(H, W, K, blocks, ipw, shared) || B < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(component_extents_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  component_extents_kernel<<<dim3(blocks, B), kSumThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      labels, mag, support, roots, cx, cy, ev, partial, keys, counters, out, H * W, W, K, ipw);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*n_launches;
  return static_cast<int>(err);
}

// One image: the batch of one.
int tpuslam_component_extents(const int* labels, const float* mag, const unsigned char* support,
                              const long long* roots, const float* cx, const float* cy, const float* ev,
                              float* partial, unsigned long long* keys, unsigned* counters, float* out, int H, int W,
                              int K, int blocks, int ipw, int* n_launches, void* stream) {
  return tpuslam_component_extents_batch(labels, mag, support, roots, cx, cy, ev, partial, keys, counters, out, 1,
                                         H, W, K, blocks, ipw, n_launches, stream);
}

// values (B, V, N) float32, slot (B, N) int32 -> out (B, V, S) float32
// (every entry written; items whose slot lies outside [0, S) are skipped),
// in one launch of B blocks, one per batch entry, each summing as the
// single call's one block does. Refuses V outside [1, 8] and B outside
// [1, 65535]. *n_launches is increased by the launches made (1).
int tpuslam_segment_sums_batch(const float* values, const int* slot, float* out, int B, int N, int V, int S,
                               int* n_launches, void* stream) {
  if (N < 1 || V < 1 || V > kMaxColumns || S < 1 || B < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = S < 1024 ? (S + kWarp - 1) / kWarp * kWarp : 1024;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (V) {  // the columns as a template argument: the sums stay in registers
    case 1: segment_sums_kernel<1><<<B, threads, 0, st>>>(values, slot, out, N, S); break;
    case 2: segment_sums_kernel<2><<<B, threads, 0, st>>>(values, slot, out, N, S); break;
    case 3: segment_sums_kernel<3><<<B, threads, 0, st>>>(values, slot, out, N, S); break;
    case 4: segment_sums_kernel<4><<<B, threads, 0, st>>>(values, slot, out, N, S); break;
    case 5: segment_sums_kernel<5><<<B, threads, 0, st>>>(values, slot, out, N, S); break;
    case 6: segment_sums_kernel<6><<<B, threads, 0, st>>>(values, slot, out, N, S); break;
    case 7: segment_sums_kernel<7><<<B, threads, 0, st>>>(values, slot, out, N, S); break;
    default: segment_sums_kernel<8><<<B, threads, 0, st>>>(values, slot, out, N, S); break;
  }
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*n_launches;
  return static_cast<int>(err);
}

// values (V, N) float32, slot (N,) int32 -> out (V, S): the batch of one.
int tpuslam_segment_sums(const float* values, const int* slot, float* out, int N, int V, int S, int* n_launches,
                         void* stream) {
  return tpuslam_segment_sums_batch(values, slot, out, 1, N, V, S, n_launches, stream);
}

// The replaced form: values (V, N) float32, slot (N,) int32 -> out (V, S)
// float32 (every entry written), through partial, which must hold 132 * V * S
// floats; *n_launches is increased by the kernel launches made (2). Refuses
// V outside [1, 8] and S whose (V, S + 33) warp block does not fit 48 KB of
// shared memory.
int tpuslam_moments(const float* values, const int* slot, float* partial, float* out, int N, int V, int S,
                    int* n_launches, void* stream) {
  int wpb, ipw, blocks;
  if (!two_launch_shape(N, V, S, &wpb, &ipw, &blocks)) return static_cast<int>(cudaErrorInvalidValue);
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
