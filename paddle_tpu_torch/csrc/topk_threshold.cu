// K10: the DGC top-k threshold's cumulative histogram, for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/topk_threshold.py `_count_ge_kernel` (driven
// by `count_ge_histogram`).  Over a flat tensor x of n elements (float32 or
// bfloat16) and 256 float32 edges it writes
//   counts[j] = #{ i : |float(x[i])| >= edges[j] }
// as 32-bit integers.  |x| is taken after the cast to float32, which gives
// the reference's value for |x| cast to float32.  A NaN element or a NaN
// edge never counts (the comparison is false), -0 counts at edge 0, and the
// edges need not be sorted; duplicates and infinities count as compared.
//
// Bound on the H100: one read of x.  At ResNet-50's largest tensor
// (2,359,296 bf16 elements, 4.72 MB) that is 1.41 us at 3.35 TB/s; the
// operations the function needs are a binary search over the 256 sorted
// edges, 8 compares per element, far below the byte time.
//
// Design: one element, one search, one bin.
// - Each block brings the edges into shared memory in ascending order with
//   their original indices, NaN edges last.  When they are sorted already
//   and free of NaN (the DGC path's linear edges) one __syncthreads_and
//   says so; otherwise a 256-key bitonic sort orders them.  The sorted
//   edges are laid out as a perfect search tree of depth 8 in breadth-first
//   order (the 256th kept apart), so the threads of a warp that search at
//   one depth read neighbouring words.
// - A thread takes 16 bytes of x at a time (grid-strided; the unaligned
//   head and tail go to one warp), and for each element finds m, the number
//   of sorted edges <= |x|, by 8 branchless steps down the tree plus one
//   compare with the last edge.  A NaN element finds m = 0.
// - m goes into bin m of the warp's own histogram in shared memory, one
//   shared atomicAdd per element.  DGC's |v| piles into the lowest bins, so
//   the lanes of a warp often hit one bin; aggregating them first (lane
//   0's bin by a ballot, or __match_any_sync groups) ran no faster on the
//   H100 at normal, piled-up and 99%-zero data, so there is none.  Bin 0
//   counts for no edge and is not kept.
// - At the end the block sums the warp histograms and takes suffix sums
//   (the count of sorted edge r is the number of elements in bins m > r,
//   so equal edges get equal counts and NaN edges, sorted after every bin,
//   get 0).  A grid of one block writes them as float32 counts at their
//   original indices.  Otherwise each block adds its non-zero counts to an
//   integer workspace with atomicAdd, and the last block to arrive (an
//   atomic counter) writes the float32 counts and zeroes the workspace and
//   the counter, so the next launch finds them 0 without a memset: one
//   launch per call.  Integer sums do not depend on their order, so the
//   counts are exact and the same on every run.
// The grid is sized from n (a vector per thread, at most four blocks per
// SM; two to eight vectors a thread and eight blocks per SM ran no faster
// on the H100), so a small tensor takes one or a few blocks.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kEdges = 256;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = kEdges + 1;   // bin m: m sorted edges are <= |x|
constexpr int kVecsPerThread = 1;   // the grid's target
constexpr int kBlocksPerSm = 4;     // the grid's cap

// the sort's order: ascending, NaN last
__device__ __forceinline__ bool before(float a, float b) {
  return !isnan(a) && (isnan(b) || a < b);
}

// in-order (sorted) position of node k in 1..255 of the perfect search
// tree of depth 8 stored breadth-first (children of k at 2k, 2k + 1)
__device__ __forceinline__ int inorder(int k) {
  const int l = 31 - __clz(k);
  return ((2 * (k - (1 << l)) + 1) << (7 - l)) - 1;
}

// the number of sorted edges <= a: 8 steps down the tree over the first
// 255, then the last edge; 0 for a NaN a (every compare is false)
__device__ __forceinline__ int rank_of(const float* tree, float last,
                                       float a) {
  int k = 1;
#pragma unroll
  for (int l = 0; l < 8; ++l) k = 2 * k + (tree[k] <= a ? 1 : 0);
  return last <= a ? kEdges : k - kEdges;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
count_ge_kernel(const T* __restrict__ x, long long n,
                const float* __restrict__ edges, float* __restrict__ counts,
                unsigned* __restrict__ work) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float key[kEdges];
  __shared__ int order[kEdges];
  __shared__ float tree[kEdges];
  __shared__ unsigned hist[kWarps][kBins];
  __shared__ unsigned wsum[kWarps];
  __shared__ bool s_last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  const long long head = static_cast<long long>(
      (16 - reinterpret_cast<uintptr_t>(x) % 16) % 16 / sizeof(T));
  const long long lead = head < n ? head : n;
  const long long nvec = (n - lead) / V;
  const uint4* xv = reinterpret_cast<const uint4*>(x + lead);

  // the edges in ascending order, NaN last, with their indices
  const float e = edges[t];
  key[t] = e;
  order[t] = t;
  for (int i = t; i < kWarps * kBins; i += kThreads) (&hist[0][0])[i] = 0u;
  const bool sorted = !isnan(e) && (t == 0 || edges[t - 1] <= e);
  if (!__syncthreads_and(sorted)) {
    for (int k = 2; k <= kEdges; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        const int p = t ^ j;
        if (p > t) {
          const float a = key[t], b = key[p];
          if ((t & k) == 0 ? before(b, a) : before(a, b)) {
            key[t] = b;
            key[p] = a;
            const int o = order[t];
            order[t] = order[p];
            order[p] = o;
          }
        }
        __syncthreads();
      }
    }
  }
  if (t > 0) tree[t] = key[inorder(t)];
  const float last = key[kEdges - 1];
  __syncthreads();

  // bins of the 16-byte vectors, grid-strided, a warp's lanes on
  // neighbouring vectors; each load is issued one step ahead (the first
  // before the edges are sorted)
  unsigned* h = hist[warp];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long start = static_cast<long long>(blockIdx.x) * kThreads +
                          warp * 32;
  uint4 next = start + lane < nvec ? xv[start + lane] : make_uint4(0, 0, 0, 0);
  for (long long v0 = start; v0 < nvec; v0 += stride) {
    const long long v = v0 + lane;
    union {
      uint4 u;
      T e[V];
    } w;
    w.u = next;
    next = v + stride < nvec ? xv[v + stride] : make_uint4(0, 0, 0, 0);
    // all the searches first: they are independent of each other and of
    // the histogram's atomics
    int m[V];
#pragma unroll
    for (int i = 0; i < V; ++i)
      m[i] = v < nvec ? rank_of(tree, last, fabsf(pt::to_f32(w.e[i]))) : 0;
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (m[i]) atomicAdd(h + m[i], 1u);
  }
  // the unaligned head and the tail (fewer than 2V elements): one warp
  if (blockIdx.x == 0 && warp == 0) {
    const long long tail = lead + nvec * V, rest = lead + (n - tail);
    const long long i = lane < lead ? lane : tail + (lane - lead);
    const int m = lane < rest ? rank_of(tree, last, fabsf(pt::to_f32(x[i])))
                              : 0;
    if (m) atomicAdd(h + m, 1u);
  }
  __syncthreads();

  // thread t: bin t + 1 over the warps, then the suffix sum over bins > t,
  // the count of sorted edge t
  unsigned s = 0;
#pragma unroll
  for (int wp = 0; wp < kWarps; ++wp) s += hist[wp][t + 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_down_sync(pt::kFullMask, s, o);
    if (lane + o < 32) s += y;
  }
  if (lane == 0) wsum[warp] = s;
  __syncthreads();
  for (int wp = warp + 1; wp < kWarps; ++wp) s += wsum[wp];
  if (gridDim.x == 1) {
    counts[order[t]] = static_cast<float>(s);
    return;
  }
  if (s) atomicAdd(work + order[t], s);
  // arrive; the last block writes the float counts and leaves the
  // workspace and the counter 0
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(work + kEdges, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  counts[t] = static_cast<float>(__ldcg(work + t));
  work[t] = 0u;
  if (t == 0) work[kEdges] = 0u;
}

template <typename T>
cudaError_t launch(const void* x, long long n, const float* edges,
                   float* counts, unsigned* work, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long vecs = n / (16 / sizeof(T)) + 1;
  const long long per_block = static_cast<long long>(kThreads) *
                              kVecsPerThread;
  const long long want = (vecs + per_block - 1) / per_block;
  const long long most = static_cast<long long>(sms) * kBlocksPerSm;
  const int grid = static_cast<int>(want < most ? want : most);
  count_ge_kernel<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(x), n,
                                                edges, counts, work);
  return cudaGetLastError();
}

}  // namespace

// x: n contiguous elements of `dtype` (0 float32, 1 bfloat16), 0 < n <
// 2^31, aligned to its element size; edges: 256 float32 (any values);
// counts: 256 float32, written; work: 257 unsigned ints (the blocks' sums
// and their arrival counter), 0 on entry and left 0.  One launch on
// `stream`; returns cudaGetLastError() after it.
extern "C" int pt_count_ge_histogram(const void* x, long long n,
                                     const void* edges, void* counts,
                                     void* work, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n >= (1LL << 31) || work == nullptr)
    return int(cudaErrorInvalidValue);
  const float* e = static_cast<const float*>(edges);
  float* c = static_cast<float*>(counts);
  unsigned* w = static_cast<unsigned*>(work);
  if (dtype == pt::kFloat32) return int(launch<float>(x, n, e, c, w, st));
  if (dtype == pt::kBFloat16)
    return int(launch<__nv_bfloat16>(x, n, e, c, w, st));
  return int(cudaErrorInvalidValue);
}
