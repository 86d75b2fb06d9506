// Tensor-core pieces shared by the bf16 flash-attention kernels, K1
// (csrc/flash_attention.cu) and K3 (csrc/flash_attention_bwd.cu), on top
// of the primitives of csrc/mma.cuh (cp.async, ldmatrix, mma.sync).
//
// Both kernels hold one side of the attention matrix resident as a tile
// of kTile rows and stream the other side through a 2-slot cp.async ring
// of kTile-row tiles.  Tiles stay bf16 in shared memory with rows padded
// by 16 bytes (kPad elements), so the 8 rows an ldmatrix reads fall in
// different banks.  Each warp owns 16 rows of the resident side.
//
// Fragments of mma.sync.aligned.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16: a0 (row g, k 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//            a3 (g+8, 2t+8..);
//   B 16x8:  b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g);
//   C 16x8:  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols).
// So the C fragments of two neighbouring n-tiles (columns 16j .. 16j+15)
// are, rounded to bf16 and packed in pairs, the A fragment of a product
// whose K runs over those 16 columns: a0 = (C[2j].c0, c1), a1 = (C[2j].c2,
// c3), a2 = (C[2j+1].c0, c1), a3 = (C[2j+1].c2, c3).  That is how P (K1)
// and P^T, dS^T (K3) go from one product to the next without leaving the
// registers.
#pragma once

#include <cstdint>

#include "mma.cuh"

// The long sums (K1's O over the keys, K3's dV and dK over the queries)
// accumulate in the mma itself (the tensor core's own rounding), not by
// mma.cuh's rule of starting each 16-deep mma from zero and adding in
// f32: on an H100 80GB HBM3 (700 W) at the train shape the two rules gave
// the same error against float64 products to four digits (the bf16
// rounding of the outputs dominates) and the mma's own was up to 2% (K1)
// and 5% (K3) faster (PERF.md).

namespace pt {
namespace flash {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // rows of a resident or a streamed tile
constexpr int kPad = 8;    // bf16 elements (16 bytes) of row padding

// kTile rows of D bf16 from device memory (row stride D) into a tile of
// row stride D + kPad, 16 bytes a cp.async, spread over the block
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src) {
  constexpr int kGroups = D / 8;
  for (int i = threadIdx.x; i < kTile * kGroups; i += blockDim.x) {
    const int r = i / kGroups, c = (i % kGroups) * 8;
    tc::cp_async16(dst + r * (D + kPad) + c, src + size_t(r) * D + c);
  }
}

// kTile f32 values (a row statistic of the streamed tile) by 16 threads
// starting at thread `first`
__device__ __forceinline__ void load_row_stat(float* dst, const float* src,
                                              int first) {
  const int i = int(threadIdx.x) - first;
  if (i >= 0 && i < kTile / 4) tc::cp_async16(dst + 4 * i, src + 4 * i);
}

// A fragment of rows r0 .. r0+15, columns c0 .. c0+15 of a row-major tile
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int r0, int c0) {
  const int lane = threadIdx.x & 31, li = lane & 7, lm = lane >> 3;
  tc::ldsm_x4<false>(a, tile + (r0 + li + (lm & 1) * 8) * ld + c0 +
                            (lm >> 1) * 8);
}

// B fragments of two n-tiles, B(k, n) = tile[n][k] (the tile's rows are
// the n index): b[0], b[1] for n0 .. n0+7, b[2], b[3] for n0+8 .. n0+15
__device__ __forceinline__ void ldsm_b_rows(uint32_t (&b)[4], const bf16* tile,
                                            int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31, li = lane & 7, lm = lane >> 3;
  tc::ldsm_x4<false>(b, tile + (n0 + li + (lm >> 1) * 8) * ld + k0 +
                            (lm & 1) * 8);
}

// B fragments of two n-tiles, B(k, n) = tile[k][n] (the tile's rows are
// the k index; ldmatrix.trans)
__device__ __forceinline__ void ldsm_b_cols(uint32_t (&b)[4], const bf16* tile,
                                            int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, li = lane & 7, lm = lane >> 3;
  tc::ldsm_x4<true>(b, tile + (k0 + li + (lm & 1) * 8) * ld + n0 +
                           (lm >> 1) * 8);
}

// two f32 values rounded to bf16 (to nearest) in one register, `lo` in
// the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// the A fragment of columns 16j .. 16j+15 from the C fragments of n-tiles
// 2j and 2j+1 (see the map above)
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

// max / sum over the 4 lanes of a quad (the lanes that share a row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFullMask, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFullMask, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFullMask, v, 1);
  return v + __shfl_xor_sync(kFullMask, v, 2);
}

}  // namespace flash
}  // namespace pt
