// K10: the DGC top-k threshold's cumulative histogram, for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/topk_threshold.py `_count_ge_kernel` (driven
// by `count_ge_histogram`).  Over a flat tensor x of n elements (float32 or
// bfloat16) and 256 float32 edges it writes
//   counts[j] = #{ i : |float(x[i])| >= edges[j] }
// as 32-bit integers.  |x| is taken after the cast to float32, which gives
// the reference's value for |x| cast to float32.  A NaN element or a NaN
// edge never counts (the comparison is false), -0 counts at edge 0, and the
// edges need not be sorted.
//
// Bound on the H100: one read of x.  At ResNet-50's largest tensor
// (2,359,296 bf16 elements, 4.72 MB) that is 1.41 us at 3.35 TB/s; the
// operations the function needs are a binary search over the 256 sorted
// edges, 8 compares per element, far below the byte time.
//
// Design (the simple one; a binary search or a fused max-and-count pass is
// for a later change).  A block of 256 threads walks tiles of kTile
// elements, grid-strided; it stages each tile in shared memory as float32
// |x|, and thread j, which owns edge j, sweeps the tile with broadcast
// reads (every thread of a warp reads the same word) and counts a >= edge
// in a 32-bit register.  At the end each block adds its 256 counts to the
// output with one integer atomicAdd per edge.  Integer sums do not depend
// on their order, so the counts are exact and the same on every run.  The
// sweep costs 256 compares per element, so the kernel is bound by those
// instructions, not by the bytes.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kEdges = 256;       // one thread per edge
constexpr int kTile = 4096;       // float32 elements staged per sweep

template <typename T>
__global__ void __launch_bounds__(kEdges)
count_ge_kernel(const T* __restrict__ x, long long n,
                const float* __restrict__ edges,
                unsigned int* __restrict__ counts) {
  __shared__ float4 tile[kTile / 4];
  float* a = reinterpret_cast<float*>(tile);
  const float edge = edges[threadIdx.x];
  unsigned int c = 0;
  for (long long base = static_cast<long long>(blockIdx.x) * kTile;
       base < n; base += static_cast<long long>(gridDim.x) * kTile) {
    const long long rest = n - base;
    const int len = rest < kTile ? static_cast<int>(rest) : kTile;
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kEdges)
      a[i] = fabsf(pt::to_f32(x[base + i]));
    __syncthreads();
    const int quads = len / 4;
    for (int q = 0; q < quads; ++q) {
      const float4 v = tile[q];
      c += (v.x >= edge) + (v.y >= edge) + (v.z >= edge) + (v.w >= edge);
    }
    for (int i = quads * 4; i < len; ++i) c += (a[i] >= edge);
  }
  if (c) atomicAdd(&counts[threadIdx.x], c);
}

template <typename T>
cudaError_t launch(const void* x, long long n, const float* edges,
                   unsigned int* counts, cudaStream_t st) {
  const long long tiles = (n + kTile - 1) / kTile;
  // 8 blocks of 256 threads fill an SM's 2048 threads
  const long long most = 132LL * 8;
  const int grid = static_cast<int>(tiles < most ? tiles : most);
  count_ge_kernel<T><<<grid, kEdges, 0, st>>>(static_cast<const T*>(x), n,
                                              edges, counts);
  return cudaGetLastError();
}

}  // namespace

// x: n contiguous elements of `dtype` (0 float32, 1 bfloat16), 0 < n <
// 2^31; edges: 256 float32; counts: 256 int32, zeroed by the caller, to
// which the kernel adds.  Returns cudaGetLastError() after the launch.
extern "C" int pt_count_ge_histogram(const void* x, long long n,
                                     const void* edges, void* counts,
                                     int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n >= (1LL << 31)) return int(cudaErrorInvalidValue);
  const float* e = static_cast<const float*>(edges);
  unsigned int* c = static_cast<unsigned int*>(counts);
  if (dtype == pt::kFloat32) return int(launch<float>(x, n, e, c, st));
  if (dtype == pt::kBFloat16)
    return int(launch<__nv_bfloat16>(x, n, e, c, st));
  return int(cudaErrorInvalidValue);
}
