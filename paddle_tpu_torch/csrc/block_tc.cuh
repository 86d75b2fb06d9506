// The tensor-core pieces of the fused ResNet bottleneck blocks, shared by
// K7 (csrc/fused_block.cu, the stride-1 block) and K8 (csrc/fused_down.cu,
// the stride-2 transition block), each templated on the stride kS of the
// 3x3 conv and the shortcut: the tile geometry and shared-memory layouts,
// the forward kernel, the backward's first kernel (B1), the batch-wide
// weight-gradient GEMM (W) and its slice-order sum (R), the launch plan
// and the launchers.  Each block's own B2 (the 3x3 conv transposed and
// dx) stays in its source; its launcher passes it to `launch_bwd`.
//
// Over NHWC rows, f32 accumulation, "round" the cast to the activation
// dtype T (bf16 or f32), Ho = H / kS, Wo = W / kS:
//   h0  = round(relu(a1 * (x @ w1) + b1))                       at H x W
//   h1  = round(relu(a2 * conv3x3_s(h0, w2) + b2))              at Ho x Wo
//   y   = round(relu(a3 * (h1 @ w3) + b3 + s))
//   s   = x (identity, kS = 1)  or  a4 * (x[:, ::kS, ::kS] @ w4) + b4
// The backward recomputes the forward and returns dx (T), dW1..dW4 and the
// affine-grad rows (f32), rounding c0, c1, c2, c4 to T before the
// affine-grad sums and dc2, dc1, dc0, dc4 to T before their products, as
// the Pallas kernels do; the relu masks compare the f32 pre-activations
// with > 0.  Every product is `pt::tc::product` (csrc/mma.cuh).
//
// Forward (`block_fwd_kernel`).  A block takes th output rows of one
// image (P = th Wo pixels) and recomputes h0 on its input rows kS r0 - 1
// .. kS (r0 + th - 1) + 1 (P2 pixels, zero outside the image: the conv's
// padding), kept in shared memory as bf16 rows padded by 16 bytes.  The
// 3x3 conv is an implicit GEMM read straight from that tile: each ldmatrix
// lane points at h0 row (kS r + dy, kS c + dx - 1) of its pixel, a zero
// row standing for the left and right padding.  h1 stays in shared
// memory; per 128-channel chunk of Cout the projection's c4 lands in an
// f32 tile (the identity block reads x in the epilogue) and the epilogue
// of h1 @ w3 writes y.
//
// Backward: two activation-gradient kernels, then one batch-wide
// weight-gradient GEMM kernel and its reduction.  No kernel adds a whole
// weight gradient per tile.
//   B1 (`block_bwd1_kernel`, tiles as the forward): recompute h0 (halo;
//      its own rows to the h0 scratch [R_in, Cm]), c1, h1 (to the h1
//      scratch [R_out, Cm]); per Cout chunk c4, c2, pre, dz3 and the
//      affine grads a3/b3, a4/b4 (shared-memory partials, one atomic per
//      channel per block); dc2 and dc4 to their scratches [R_out, Cout]
//      (the identity block writes dz3 where dc4 would go: B2 adds it to
//      dx); then dh1 = dc2 w3^T (K = Cout, dc2 read back), du1, the
//      a2/b2 grads, dc1 to its scratch [R_out, Cm].
//   B2 (the block's own): dh0 = the 3x3 conv transposed over dc1, du0,
//      the a1/b1 grads, dc0 to its scratch [R_in, Cm]; dx.
//   W  (`wgrad_kernel`): all weight gradients over all pixels,
//        dW1 = x^T dc0, dW2 = patches_s(h0)^T dc1 (the stride-kS im2col
//        gather in the loader), dW3 = h1^T dc2, dW4 = x[:, ::kS, ::kS]^T
//        dc4,
//      as 64 x 128 output tiles times a fixed number of K (pixel) slices
//      per GEMM, chosen so the items fill the card about four times over;
//      each item stores its partial tile (no atomics), and
//   R  (`wsum_kernel`) sums the slices in slice order: the weight
//      gradients are bitwise repeatable.  The affine grads use atomics
//      and are not.
//
// Tiles.  `make_plan` picks each kernel's tile height th <= 8 among those
// whose shared memory fits one block: the one whose tiles cost the least
// tensor-core work, M padded to 16 (the halo's h0 product and the own
// products), summed over the image's tiles (the last may be ragged).
#pragma once

#include <cstdint>
#include <initializer_list>

#include "common.cuh"
#include "mma.cuh"

namespace {

using pt::tc::kBN;
using pt::tc::kThreads;
using pt::tc::product;
constexpr int kMaxTH = 8;
constexpr int kWaves = 4;  // weight-gradient items per SM

// Every kernel here and each block's B2 declare __launch_bounds__(kThreads,
// 1): their shared memory fits one block per SM at ResNet-50's widths, so
// ptxas may give a thread up to 255 registers, where its own cap of 128
// made the bf16 B1 spill.

// h, w: the input's sides; th the output rows of a tile; vec: 16-byte
// loads (every channel count a multiple of the group, pointers aligned).
struct Geo {
  int h, w, cin, cm, lgcm, cout, aw, ho, wo, th, tiles;
  bool vec;
};

// A tile: output rows [r0, r0 + rows) of image img, P = rows * Wo own
// pixels, `own` the first of them in the [N Ho Wo] order.  Its h0 halo is
// input rows kS r0 - 1 .. kS (r0 + rows - 1) + 1: P2 pixels, halo pixel
// hp inside the image iff lo <= hp < hi; `xb` is the input pixel of halo
// pixel 0, `xin` that of the first own input pixel (input row kS r0), and
// the tile owns the pin = kS rows W input pixels from there (halo pixels
// W .. W + pin - 1).
struct Tile {
  int img, r0, rows, P, P2, lo, hi, pin;
  long long own, xb, xin;
};

template <int kS>
__device__ __forceinline__ Tile tile_of(const Geo& g) {
  Tile t;
  t.img = blockIdx.x / g.tiles;
  t.r0 = (blockIdx.x % g.tiles) * g.th;
  t.rows = min(g.th, g.ho - t.r0);
  t.P = t.rows * g.wo;
  t.P2 = (kS * t.rows + 3 - kS) * g.w;
  t.lo = t.r0 == 0 ? g.w : 0;
  // the lower halo row is inside unless it lies below the image (the
  // last stride-1 tile; a stride-2 tile's is at most row H - 1)
  t.hi = kS * (t.r0 + t.rows - 1) + 1 < g.h ? t.P2 : t.P2 - g.w;
  t.pin = kS * t.rows * g.w;
  t.own = (static_cast<long long>(t.img) * g.ho + t.r0) * g.wo;
  t.xin = (static_cast<long long>(t.img) * g.h + kS * t.r0) * g.w;
  t.xb = t.xin - g.w;
  return t;
}

// Shared-memory layout: the same code sizes it on the host and carves it
// on the device.
__host__ __device__ inline size_t up16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

struct Carve {
  size_t off = 0;
  __host__ __device__ size_t take(size_t bytes) {
    const size_t o = off;
    off += up16(bytes);
    return o;
  }
};

// Row stride (elements) of the resident h0 / h1 tiles: Cm plus 16 bytes,
// so the rows one ldmatrix reads start in different banks.
template <typename T>
__host__ __device__ inline int res_ld(int cm) {
  return cm + 16 / int(sizeof(T));
}

// own output pixels and h0 halo pixels of a tile of th output rows
template <int kS>
__host__ __device__ inline size_t own_px(int th, int w) {
  return size_t(th) * (w / kS);
}
template <int kS>
__host__ __device__ inline size_t halo_px(int th, int w) {
  return size_t(kS * th + 3 - kS) * w;
}

struct FwdLayout {
  size_t ring, row, col, h0, h1, s, total;
};

template <typename T, int kS>
__host__ __device__ inline FwdLayout fwd_layout(int th, int w, int cm,
                                                bool proj) {
  Carve c;
  FwdLayout l;
  const size_t p = own_px<kS>(th, w), p2 = halo_px<kS>(th, w);
  const size_t ld = res_ld<T>(cm);
  l.ring = c.take(pt::tc::Cfg<T>::kRingBytes);
  l.row = c.take(sizeof(short) * p);
  l.col = c.take(sizeof(short) * p);
  l.h0 = c.take(sizeof(T) * p2 * ld);
  l.h1 = c.take(sizeof(T) * p * ld);
  l.s = c.take(proj ? sizeof(float) * p * kBN : 0);  // c4 of one chunk
  l.total = c.off;
  return l;
}

struct B1Layout {
  size_t ring, row, col, h0, h1, c1r, m1, c4, daff, total;
};

template <typename T, int kS>
__host__ __device__ inline B1Layout b1_layout(int th, int w, int cm,
                                              bool proj) {
  Carve c;
  B1Layout l;
  const size_t p = own_px<kS>(th, w), p2 = halo_px<kS>(th, w);
  const size_t ld = res_ld<T>(cm);
  l.ring = c.take(pt::tc::Cfg<T>::kRingBytes);
  l.row = c.take(sizeof(short) * p);
  l.col = c.take(sizeof(short) * p);
  l.h0 = c.take(sizeof(T) * p2 * ld);
  l.h1 = c.take(sizeof(T) * p * ld);
  l.c1r = c.take(sizeof(T) * p * cm);                    // round(c1)
  l.m1 = c.take(p * cm);                                 // u1 > 0
  l.c4 = c.take(proj ? sizeof(float) * p * kBN : 0);     // c4 of one chunk
  l.daff = c.take(sizeof(float) * (2 * cm + 4 * kBN));
  l.total = c.off;
  return l;
}

// B2 keeps round(c0) and the u0 mask of the tile's own input pixels.
struct B2Layout {
  size_t ring, row, col, c0r, m0, daff, total;
};

template <typename T, int kS>
__host__ __device__ inline B2Layout b2_layout(int th, int w, int cm) {
  Carve c;
  B2Layout l;
  const size_t p = own_px<kS>(th, w), pin = size_t(kS * th) * w;
  l.ring = c.take(pt::tc::Cfg<T>::kRingBytes);
  l.row = c.take(sizeof(short) * p);
  l.col = c.take(sizeof(short) * p);
  l.c0r = c.take(sizeof(T) * pin * cm);
  l.m0 = c.take(pin * cm);
  l.daff = c.take(sizeof(float) * 2 * cm);
  l.total = c.off;
  return l;
}

// c * a + b as the plain version rounds it: the product, then the sum
// (no fused multiply-add), so a relu mask compares the same f32 value.
__device__ __forceinline__ float affine(float c, float a, float b) {
  return __fadd_rn(__fmul_rn(c, a), b);
}

template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return pt::to_f32(pt::from_f32<T>(v));
}

// Row and column of each own output pixel, so no loader divides.
__device__ __forceinline__ void fill_tables(const Geo& g, const Tile& t,
                                            short* rowt, short* colt) {
  for (int p = threadIdx.x; p < t.P; p += kThreads) {
    rowt[p] = static_cast<short>(p / g.wo);
    colt[p] = static_cast<short>(p % g.wo);
  }
}

// h0 over the tile's halo rows, zero outside the image; with h0g, the own
// input rows also go to the h0 scratch.
template <typename T>
__device__ void halo_h0(const Geo& g, const Tile& t, const T* x, const T* w1,
                        const float* aff, T* h0s, T* h0g, T* ring) {
  const int ld = res_ld<T>(g.cm);
  const float* a1 = aff;
  const float* b1 = aff + g.aw;
  product<T, false, true, false>(
      t.P2, g.cm, g.cin, g.vec,
      [&](int m, int k) -> const T* {
        return m >= t.lo && m < t.hi ? x + (t.xb + m) * g.cin + k : nullptr;
      },
      [&](int k, int n) -> const T* { return w1 + size_t(k) * g.cm + n; },
      [&](int m, int n, float v) {
        const bool in = m >= t.lo && m < t.hi;
        const T h =
            pt::from_f32<T>(in ? fmaxf(affine(v, a1[n], b1[n]), 0.f) : 0.f);
        h0s[m * ld + n] = h;
        if (h0g != nullptr && m >= g.w && m < g.w + t.pin)
          h0g[(t.xb + m) * g.cm + n] = h;
      },
      ring);
}

// c1 = conv3x3_s(h0, w2) over the tile's own pixels, read from the
// resident h0 rows: k = tap * Cm + c, tap = dy * 3 + dx; output row r
// reads halo row kS r + dy, column kS col + dx - 1 (the zero row where
// that lies left or right of the image).
template <typename T, int kS, class Epi>
__device__ void conv3x3(const Geo& g, const Tile& t, const short* rowt,
                        const short* colt, const T* h0s, const T* w2,
                        const Epi& epi, T* ring) {
  const int ld = res_ld<T>(g.cm);
  product<T, false, true, true>(
      t.P, g.cm, 9 * g.cm, g.vec,
      [&](int m, int k) -> const T* {
        const int tap = k >> g.lgcm, c = k & (g.cm - 1);
        const int dy = tap / 3, dx = tap - 3 * dy;
        const int col = kS * colt[m] + dx - 1;
        if (col < 0 || col >= g.w) return nullptr;
        return h0s + ((kS * rowt[m] + dy) * g.w + col) * ld + c;
      },
      [&](int k, int n) -> const T* { return w2 + size_t(k) * g.cm + n; },
      epi, ring);
}

// The input pixel own output pixel p's shortcut reads: x[:, ::kS, ::kS].
template <int kS>
__device__ __forceinline__ long long in_pixel(const Geo& g, const Tile& t,
                                              const short* rowt,
                                              const short* colt, int p) {
  return t.xin + kS * rowt[p] * g.w + kS * colt[p];
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int kS, bool kProj>
__global__ void __launch_bounds__(kThreads, 1)
block_fwd_kernel(Geo g, const T* __restrict__ x, const T* __restrict__ w1,
                 const T* __restrict__ w2, const T* __restrict__ w3,
                 const T* __restrict__ w4, const float* __restrict__ aff,
                 T* __restrict__ y) {
  static_assert(kProj || kS == 1, "the identity shortcut is stride 1");
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const FwdLayout L = fwd_layout<T, kS>(g.th, g.w, g.cm, kProj);
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  short* rowt = reinterpret_cast<short*>(smem + L.row);
  short* colt = reinterpret_cast<short*>(smem + L.col);
  T* h0s = reinterpret_cast<T*>(smem + L.h0);
  T* h1s = reinterpret_cast<T*>(smem + L.h1);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  const Tile t = tile_of<kS>(g);
  const int ld = res_ld<T>(g.cm);
  const float* a2 = aff + 2 * g.aw;
  const float* b2 = aff + 3 * g.aw;
  const float* a3 = aff + 4 * g.aw;
  const float* b3 = aff + 5 * g.aw;
  const float* a4 = aff + 6 * g.aw;
  const float* b4 = aff + 7 * g.aw;

  fill_tables(g, t, rowt, colt);
  pt::tc::zero_row(ring);
  halo_h0<T>(g, t, x, w1, aff, h0s, nullptr, ring);
  conv3x3<T, kS>(
      g, t, rowt, colt, h0s, w2,
      [&](int m, int n, float v) {
        h1s[m * ld + n] = pt::from_f32<T>(fmaxf(affine(v, a2[n], b2[n]), 0.f));
      },
      ring);
  for (int j0 = 0; j0 < g.cout; j0 += kBN) {
    const int nc = min(kBN, g.cout - j0);
    if (kProj) {
      product<T, false, true, false>(
          t.P, nc, g.cin, g.vec,
          [&](int m, int k) -> const T* {
            return x + in_pixel<kS>(g, t, rowt, colt, m) * g.cin + k;
          },
          [&](int k, int n) -> const T* {
            return w4 + size_t(k) * g.cout + j0 + n;
          },
          [&](int m, int n, float v) {
            ss[m * kBN + n] = affine(v, a4[j0 + n], b4[j0 + n]);
          },
          ring);
    }
    product<T, false, true, true>(
        t.P, nc, g.cm, g.vec,
        [&](int m, int k) -> const T* { return h1s + m * ld + k; },
        [&](int k, int n) -> const T* {
          return w3 + size_t(k) * g.cout + j0 + n;
        },
        [&](int m, int n, float v) {
          const int col = j0 + n;
          const float s = kProj ? ss[m * kBN + n]
                                : pt::to_f32(x[(t.own + m) * g.cin + col]);
          const float pre = affine(v, a3[col], b3[col]) + s;
          y[(t.own + m) * g.cout + col] = pt::from_f32<T>(fmaxf(pre, 0.f));
        },
        ring);
  }
}

// ---------------------------------------------------------------------------
// backward, B1: recompute; the Cout-wide chain; dc2, dc4, dc1, h0, h1 out
// ---------------------------------------------------------------------------

template <typename T, int kS, bool kProj>
__global__ void __launch_bounds__(kThreads, 1)
block_bwd1_kernel(Geo g, const T* __restrict__ x, const T* __restrict__ dy,
                  const T* __restrict__ w1, const T* __restrict__ w2,
                  const T* __restrict__ w3, const T* __restrict__ w4,
                  const float* __restrict__ aff, float* __restrict__ daff,
                  T* __restrict__ h0g, T* __restrict__ h1g,
                  T* __restrict__ dc1g, T* __restrict__ dc2g,
                  T* __restrict__ dc4g) {
  static_assert(kProj || kS == 1, "the identity shortcut is stride 1");
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const B1Layout L = b1_layout<T, kS>(g.th, g.w, g.cm, kProj);
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  short* rowt = reinterpret_cast<short*>(smem + L.row);
  short* colt = reinterpret_cast<short*>(smem + L.col);
  T* h0s = reinterpret_cast<T*>(smem + L.h0);
  T* h1s = reinterpret_cast<T*>(smem + L.h1);
  T* c1r = reinterpret_cast<T*>(smem + L.c1r);
  uint8_t* m1 = reinterpret_cast<uint8_t*>(smem + L.m1);
  float* c4s = reinterpret_cast<float*>(smem + L.c4);
  float* dA = reinterpret_cast<float*>(smem + L.daff);  // rows 2, 3: [2][Cm]
  float* dC = dA + 2 * g.cm;                            // rows 4-7: [4][kBN]
  const Tile t = tile_of<kS>(g);
  const int tid = threadIdx.x;
  const int ld = res_ld<T>(g.cm);
  const float* a2 = aff + 2 * g.aw;
  const float* b2 = aff + 3 * g.aw;
  const float* a3 = aff + 4 * g.aw;
  const float* b3 = aff + 5 * g.aw;
  const float* a4 = aff + 6 * g.aw;
  const float* b4 = aff + 7 * g.aw;

  fill_tables(g, t, rowt, colt);
  pt::tc::zero_row(ring);
  for (int i = tid; i < 2 * g.cm + 4 * kBN; i += kThreads) dA[i] = 0.f;
  halo_h0<T>(g, t, x, w1, aff, h0s, h0g, ring);
  conv3x3<T, kS>(
      g, t, rowt, colt, h0s, w2,
      [&](int m, int n, float v) {
        const float u1 = affine(v, a2[n], b2[n]);
        const T h = pt::from_f32<T>(fmaxf(u1, 0.f));
        h1s[m * ld + n] = h;
        h1g[(t.own + m) * g.cm + n] = h;
        c1r[m * g.cm + n] = pt::from_f32<T>(v);
        m1[m * g.cm + n] = u1 > 0.f;
      },
      ring);

  for (int j0 = 0; j0 < g.cout; j0 += kBN) {
    const int nc = min(kBN, g.cout - j0);
    if (kProj) {
      product<T, false, true, false>(
          t.P, nc, g.cin, g.vec,
          [&](int m, int k) -> const T* {
            return x + in_pixel<kS>(g, t, rowt, colt, m) * g.cin + k;
          },
          [&](int k, int n) -> const T* {
            return w4 + size_t(k) * g.cout + j0 + n;
          },
          [&](int m, int n, float v) { c4s[m * kBN + n] = v; }, ring);
    }
    product<T, false, true, true>(
        t.P, nc, g.cm, g.vec,
        [&](int m, int k) -> const T* { return h1s + m * ld + k; },
        [&](int k, int n) -> const T* {
          return w3 + size_t(k) * g.cout + j0 + n;
        },
        [&](int m, int n, float v) {
          const int col = j0 + n;
          const long long at = (t.own + m) * g.cout + col;
          const float c4 = kProj ? c4s[m * kBN + n] : 0.f;
          const float s = kProj ? affine(c4, a4[col], b4[col])
                                : pt::to_f32(x[(t.own + m) * g.cin + col]);
          const bool keep = affine(v, a3[col], b3[col]) + s > 0.f;
          const float dz3 = keep ? pt::to_f32(dy[at]) : 0.f;
          atomicAdd(dC + n, dz3 * rnd<T>(v));
          atomicAdd(dC + kBN + n, dz3);
          if (kProj) atomicAdd(dC + 2 * kBN + n, dz3 * rnd<T>(c4));
          dc2g[at] = pt::from_f32<T>(dz3 * a3[col]);
          // dc4, or for the identity block dz3 itself (a value of T)
          dc4g[at] = pt::from_f32<T>(kProj ? dz3 * a4[col] : dz3);
        },
        ring);
    __syncthreads();
    for (int n = tid; n < nc; n += kThreads) {
      atomicAdd(daff + 4 * g.aw + j0 + n, dC[n]);
      atomicAdd(daff + 5 * g.aw + j0 + n, dC[kBN + n]);
      if (kProj) {
        atomicAdd(daff + 6 * g.aw + j0 + n, dC[2 * kBN + n]);
        atomicAdd(daff + 7 * g.aw + j0 + n, dC[kBN + n]);
      }
      dC[n] = dC[kBN + n] = dC[2 * kBN + n] = 0.f;
    }
  }

  // dh1 = dc2 w3^T over K = Cout, dc2 read back from its scratch
  product<T, false, false, false>(
      t.P, g.cm, g.cout, g.vec,
      [&](int m, int k) -> const T* {
        return dc2g + (t.own + m) * g.cout + k;
      },
      [&](int k, int n) -> const T* { return w3 + size_t(n) * g.cout + k; },
      [&](int m, int n, float v) {
        const int i = m * g.cm + n;
        const float du1 = m1[i] ? v : 0.f;
        atomicAdd(dA + n, du1 * pt::to_f32(c1r[i]));
        atomicAdd(dA + g.cm + n, du1);
        dc1g[(t.own + m) * g.cm + n] = pt::from_f32<T>(du1 * a2[n]);
      },
      ring);
  __syncthreads();
  for (int c = tid; c < g.cm; c += kThreads) {
    atomicAdd(daff + 2 * g.aw + c, dA[c]);
    atomicAdd(daff + 3 * g.aw + c, dA[g.cm + c]);
  }
}

// ---------------------------------------------------------------------------
// backward, W: the weight gradients over all pixels, in K slices
// ---------------------------------------------------------------------------

// GEMM q (0: dW1, 1: dW2, 2: dW3, 3: dW4, which the identity block lacks:
// M = 0) is [M, N] over K pixels, cut in ceil(M / 64) x ceil(N / 128)
// output tiles (tn across) times S slices of L pixels; its items are
// blockIdx.x in [first, first + tiles * S), and slice s of it lands at
// ws + off + s * M * N.
struct WPlan {
  int h, w, cin, cm, lgcm, cout, ho, wo;
  bool vec;
  int M[4], N[4], K[4], L[4], S[4], tn[4], first[5];
  long long off[5];
};

template <typename T, int kS>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_kernel(WPlan p, const T* __restrict__ x, const T* __restrict__ h0g,
             const T* __restrict__ h1g, const T* __restrict__ dc0g,
             const T* __restrict__ dc1g, const T* __restrict__ dc2g,
             const T* __restrict__ dc4g, float* __restrict__ ws) {
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);
  pt::tc::zero_row(ring);
  int q = 0;
  while (blockIdx.x >= p.first[q + 1]) ++q;
  const int item = blockIdx.x - p.first[q];
  const int s = item % p.S[q], tile = item / p.S[q];
  const int m0 = (tile / p.tn[q]) * pt::tc::kBM, n0 = (tile % p.tn[q]) * kBN;
  const int k0 = s * p.L[q];
  const int M = min(pt::tc::kBM, p.M[q] - m0), N = min(kBN, p.N[q] - n0);
  const int K = min(p.L[q], p.K[q] - k0);
  float* out = ws + p.off[q] + static_cast<long long>(s) * p.M[q] * p.N[q];
  const int ldo = p.N[q];
  auto epi = [&](int m, int n, float v) {
    out[static_cast<long long>(m0 + m) * ldo + n0 + n] = v;
  };
  // output pixel k -> its image, row and column
  auto split = [&](long long k, int& img, int& i, int& j) {
    const int hw = p.ho * p.wo;
    img = static_cast<int>(k / hw);
    const int r = static_cast<int>(k - static_cast<long long>(img) * hw);
    i = r / p.wo;
    j = r - i * p.wo;
  };
  switch (q) {
    case 0:  // dW1 = x^T dc0 over the input pixels
      product<T, true, true, false>(
          M, N, K, p.vec,
          [&](int m, int k) -> const T* {
            return x + (static_cast<long long>(k0) + k) * p.cin + m0 + m;
          },
          [&](int k, int n) -> const T* {
            return dc0g + (static_cast<long long>(k0) + k) * p.cm + n0 + n;
          },
          epi, ring);
      break;
    case 1:  // dW2 = patches_s(h0)^T dc1: rows tap * Cm + c
      product<T, true, true, false>(
          M, N, K, p.vec,
          [&](int m, int k) -> const T* {
            int img, i, j;
            split(static_cast<long long>(k0) + k, img, i, j);
            const int mm = m0 + m, tap = mm >> p.lgcm;
            const int dy = tap / 3, dx = tap - 3 * dy;
            const int r = kS * i + dy - 1, c = kS * j + dx - 1;
            if (r < 0 || c < 0 || r >= p.h || c >= p.w) return nullptr;
            return h0g +
                   ((static_cast<long long>(img) * p.h + r) * p.w + c) * p.cm +
                   (mm & (p.cm - 1));
          },
          [&](int k, int n) -> const T* {
            return dc1g + (static_cast<long long>(k0) + k) * p.cm + n0 + n;
          },
          epi, ring);
      break;
    case 2:  // dW3 = h1^T dc2
      product<T, true, true, false>(
          M, N, K, p.vec,
          [&](int m, int k) -> const T* {
            return h1g + (static_cast<long long>(k0) + k) * p.cm + m0 + m;
          },
          [&](int k, int n) -> const T* {
            return dc2g + (static_cast<long long>(k0) + k) * p.cout + n0 + n;
          },
          epi, ring);
      break;
    default:  // dW4 = x[:, ::kS, ::kS]^T dc4
      product<T, true, true, false>(
          M, N, K, p.vec,
          [&](int m, int k) -> const T* {
            int img, i, j;
            split(static_cast<long long>(k0) + k, img, i, j);
            return x +
                   ((static_cast<long long>(img) * p.h + kS * i) * p.w +
                    kS * j) * p.cin +
                   m0 + m;
          },
          [&](int k, int n) -> const T* {
            return dc4g + (static_cast<long long>(k0) + k) * p.cout + n0 + n;
          },
          epi, ring);
  }
}

// R: dW_q = sum over its slices, in slice order.
__global__ void __launch_bounds__(kThreads, 1)
wsum_kernel(WPlan p, const float* __restrict__ ws, float* __restrict__ dw1,
            float* __restrict__ dw2, float* __restrict__ dw3,
            float* __restrict__ dw4) {
  float* const outs[4] = {dw1, dw2, dw3, dw4};
  long long total = 0;
  for (int q = 0; q < 4; ++q) total += static_cast<long long>(p.M[q]) * p.N[q];
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kThreads) {
    int q = 0;
    long long i = e;
    while (i >= static_cast<long long>(p.M[q]) * p.N[q]) {
      i -= static_cast<long long>(p.M[q]) * p.N[q];
      ++q;
    }
    const long long size = static_cast<long long>(p.M[q]) * p.N[q];
    const float* src = ws + p.off[q] + i;
    float acc = 0.f;
    for (int s = 0; s < p.S[q]; ++s) acc += src[s * size];
    outs[q][i] = acc;
  }
}

// ---------------------------------------------------------------------------
// the plan and the launchers
// ---------------------------------------------------------------------------

inline int device_attr(cudaDeviceAttr a) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, a, dev);
  return v;
}

inline long long up_to(long long v, long long m) { return (v + m - 1) / m * m; }

// Over the tile heights th <= 8 whose shared memory fits, the one whose
// tiles cost the least tensor-core work, M padded to 16: `cost(rows)` of a
// tile of `rows` output rows, summed over the tiles (the last may be
// ragged); ties go to the larger th (fewer weight reads).  0 if none fits.
template <class Bytes, class Cost>
int pick_th(int ho, const Bytes& bytes, const Cost& cost) {
  const size_t limit =
      static_cast<size_t>(device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin));
  int best = 0;
  double best_cost = 0;
  for (int th = 1; th <= (ho < kMaxTH ? ho : kMaxTH); ++th) {
    if (bytes(th) > limit) continue;
    double c = 0;
    for (int r0 = 0; r0 < ho; r0 += th) c += cost(ho - r0 < th ? ho - r0 : th);
    if (best == 0 || c <= best_cost) {
      best = th;
      best_cost = c;
    }
  }
  return best;
}

struct Plan {
  int th_f, th_1, th_2;
  size_t sm_f, sm_1, sm_2, sm_w;
  int items;
  WPlan wp;
};

template <typename T, int kS>
Plan make_plan(int n, int h, int w, int cin, int cm, int cout, bool proj) {
  Plan pl{};
  const int ho = h / kS, wo = w / kS;
  const double cc = double(cin) * cm;
  const double own = 9.0 * cm * cm + double(cout) * (cm + (proj ? cin : 0));
  auto halo_cost = [&](int rows) {
    return up_to(halo_px<kS>(rows, w), 16) * cc +
           up_to(own_px<kS>(rows, w), 16) * own;
  };
  pl.th_f = pick_th(
      ho, [&](int t) { return fwd_layout<T, kS>(t, w, cm, proj).total; },
      halo_cost);
  pl.th_1 = pick_th(
      ho, [&](int t) { return b1_layout<T, kS>(t, w, cm, proj).total; },
      halo_cost);
  pl.th_2 = pick_th(
      ho, [&](int t) { return b2_layout<T, kS>(t, w, cm).total; },
      [&](int rows) {
        return up_to(kS * rows * w, 16) * cc +
               up_to(own_px<kS>(rows, w), 16) *
                   (9.0 * cm * cm + kS * kS * double(cm) * cin +
                    (proj ? double(cout) * cin : 0.0));
      });
  pl.sm_f = pl.th_f ? fwd_layout<T, kS>(pl.th_f, w, cm, proj).total : 0;
  pl.sm_1 = pl.th_1 ? b1_layout<T, kS>(pl.th_1, w, cm, proj).total : 0;
  pl.sm_2 = pl.th_2 ? b2_layout<T, kS>(pl.th_2, w, cm).total : 0;
  pl.sm_w = pt::tc::Cfg<T>::kRingBytes;

  WPlan& p = pl.wp;
  int lg = 0;
  while ((1 << lg) < cm) ++lg;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.cm = cm;
  p.lgcm = lg;
  p.cout = cout;
  p.ho = ho;
  p.wo = wo;
  const long long r_in = static_cast<long long>(n) * h * w;
  const long long r_out = static_cast<long long>(n) * ho * wo;
  const int Ms[4] = {cin, 9 * cm, cm, proj ? cin : 0};
  const int Ns[4] = {cm, cm, cout, cout};
  const long long Ks[4] = {r_in, r_out, r_out, r_out};
  // one slice length for all: the items fill the SMs kWaves times
  double work = 0;
  long long tiles[4];
  for (int q = 0; q < 4; ++q) {
    tiles[q] = up_to(Ms[q], pt::tc::kBM) / pt::tc::kBM *
               (up_to(Ns[q], kBN) / kBN);
    work += double(tiles[q]) * Ks[q];
  }
  const long long target =
      static_cast<long long>(kWaves) * device_attr(cudaDevAttrMultiProcessorCount);
  long long L = up_to(static_cast<long long>(work / target) + 1, pt::tc::kBK);
  if (L < 8 * pt::tc::kBK) L = 8 * pt::tc::kBK;
  p.first[0] = 0;
  p.off[0] = 0;
  for (int q = 0; q < 4; ++q) {
    p.M[q] = Ms[q];
    p.N[q] = Ns[q];
    p.K[q] = static_cast<int>(Ks[q]);
    p.L[q] = static_cast<int>(L < Ks[q] ? L : Ks[q]);
    p.S[q] = static_cast<int>((Ks[q] + p.L[q] - 1) / p.L[q]);
    p.tn[q] = static_cast<int>(up_to(Ns[q], kBN) / kBN);
    p.first[q + 1] = p.first[q] + static_cast<int>(tiles[q]) * p.S[q];
    p.off[q + 1] = p.off[q] + static_cast<long long>(p.S[q]) * Ms[q] * Ns[q];
  }
  pl.items = p.first[4];
  return pl;
}

// The envelope both blocks share: positive sides and channels, Cm a power
// of two, affine rows at least Cm and Cout wide, short pixel tables and
// int pixel counts.
inline bool geo_ok(int n, int h, int w, int cin, int cm, int cout, int aw) {
  if (n < 1 || h < 1 || w < 1 || cin < 1 || cm < 1 || cout < 1) return false;
  if (cm & (cm - 1)) return false;
  if (aw < cm || aw < cout) return false;
  if (w * kMaxTH > 32767) return false;
  if (static_cast<long long>(n) * h * w >= (1LL << 31)) return false;
  return true;
}

// 16-byte groups: every channel count a multiple of the group and every
// pointer 16-byte aligned.
template <typename T>
bool vec_ok(int cin, int cm, int cout, std::initializer_list<const void*> ps) {
  constexpr int V = pt::tc::Cfg<T>::kVec;
  if (cin % V || cm % V || cout % V) return false;
  for (const void* q : ps)
    if (reinterpret_cast<uintptr_t>(q) % 16) return false;
  return true;
}

template <int kS>
Geo make_geo(int h, int w, int cin, int cm, int cout, int aw, int th,
             bool vec) {
  int lg = 0;
  while ((1 << lg) < cm) ++lg;
  const int ho = h / kS;
  return Geo{h, w, cin, cm, lg, cout, aw, ho, w / kS, th, (ho + th - 1) / th,
             vec};
}

template <class Kernel>
cudaError_t set_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// blocks of kernel k that fit on one SM at `smem` bytes (shared memory,
// registers, threads), 0 if it does not launch
template <class Kernel>
int blocks_per_sm(Kernel k, size_t smem) {
  int b = 0;
  if (smem == 0 || set_smem(k, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, k, kThreads, smem) !=
          cudaSuccess)
    return 0;
  return b;
}

// B2: (g, x, w1, w2, w4, aff, dc1, dc4, daff, dc0, dx); dc4 holds dz3
// for the identity block
template <typename T>
using B2Kernel = void (*)(Geo, const T*, const T*, const T*, const T*,
                          const float*, const T*, const T*, float*, T*, T*);

// The plan of one geometry: out[0..2] the tile heights (output rows) of
// the forward, B1 and B2 (0 where none fits), out[3..5] their blocks,
// out[6..8] their shared memory (bytes), out[9..12] the K slices of
// dW1..dW4, out[13] the float32 partials (ws elements), out[14] the
// weight-gradient items (blocks), out[15..17] the blocks of the forward,
// B1 and B2 that fit on one SM.
template <typename T, int kS, bool kProj>
void plan_out(int n, int h, int w, int cin, int cm, int cout, B2Kernel<T> b2,
              long long* out) {
  const Plan pl = make_plan<T, kS>(n, h, w, cin, cm, cout, kProj);
  const int ho = h / kS;
  const int ths[3] = {pl.th_f, pl.th_1, pl.th_2};
  const size_t sms[3] = {pl.sm_f, pl.sm_1, pl.sm_2};
  for (int i = 0; i < 3; ++i) {
    out[i] = ths[i];
    out[3 + i] = ths[i] ? static_cast<long long>(n) * ((ho + ths[i] - 1) / ths[i])
                        : 0;
    out[6 + i] = static_cast<long long>(sms[i]);
  }
  for (int q = 0; q < 4; ++q) out[9 + q] = pl.wp.S[q];
  out[13] = pl.wp.off[4];
  out[14] = pl.items;
  out[15] = blocks_per_sm(block_fwd_kernel<T, kS, kProj>, pl.sm_f);
  out[16] = blocks_per_sm(block_bwd1_kernel<T, kS, kProj>, pl.sm_1);
  out[17] = blocks_per_sm(b2, pl.sm_2);
}

template <typename T, int kS, bool kProj>
cudaError_t launch_fwd(const void* x, const void* w1, const void* w2,
                       const void* w3, const void* w4, const void* aff,
                       void* y, int n, int h, int w, int cin, int cm,
                       int cout, int aw, cudaStream_t st) {
  const Plan pl = make_plan<T, kS>(n, h, w, cin, cm, cout, kProj);
  if (pl.th_f == 0) return cudaErrorInvalidValue;
  const Geo g = make_geo<kS>(h, w, cin, cm, cout, aw, pl.th_f,
                             vec_ok<T>(cin, cm, cout, {x, w1, w2, w3, w4, y}));
  cudaError_t err = set_smem(block_fwd_kernel<T, kS, kProj>, pl.sm_f);
  if (err != cudaSuccess) return err;
  block_fwd_kernel<T, kS, kProj><<<n * g.tiles, kThreads, pl.sm_f, st>>>(
      g, static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(w2), static_cast<const T*>(w3),
      static_cast<const T*>(w4), static_cast<const float*>(aff),
      static_cast<T*>(y));
  return cudaGetLastError();
}

// B1, B2 (the block's own), W and R on `st`; scratch h0, dc0 [R_in, Cm],
// h1, dc1 [R_out, Cm], dc2, dc4 [R_out, Cout] in T and ws (out[13]
// floats of the plan).
template <typename T, int kS, bool kProj>
cudaError_t launch_bwd(B2Kernel<T> b2, const void* x, const void* dy,
                       const void* w1, const void* w2, const void* w3,
                       const void* w4, const void* aff, void* dx, void* dw1,
                       void* dw2, void* dw3, void* dw4, void* daff, void* h0,
                       void* h1, void* dc0, void* dc1, void* dc2, void* dc4,
                       void* ws, int n, int h, int w, int cin, int cm,
                       int cout, int aw, cudaStream_t st) {
  Plan pl = make_plan<T, kS>(n, h, w, cin, cm, cout, kProj);
  if (pl.th_1 == 0 || pl.th_2 == 0) return cudaErrorInvalidValue;
  const bool vec = vec_ok<T>(cin, cm, cout, {x, dy, w1, w2, w3, w4, dx, h0,
                                             h1, dc0, dc1, dc2, dc4});
  pl.wp.vec = vec;
  const Geo g1 = make_geo<kS>(h, w, cin, cm, cout, aw, pl.th_1, vec);
  const Geo g2 = make_geo<kS>(h, w, cin, cm, cout, aw, pl.th_2, vec);
  const T* tx = static_cast<const T*>(x);
  const T* tw1 = static_cast<const T*>(w1);
  const T* tw2 = static_cast<const T*>(w2);
  const T* tw4 = static_cast<const T*>(w4);
  const float* faff = static_cast<const float*>(aff);
  float* fdaff = static_cast<float*>(daff);
  cudaError_t err = set_smem(block_bwd1_kernel<T, kS, kProj>, pl.sm_1);
  if (err != cudaSuccess) return err;
  block_bwd1_kernel<T, kS, kProj><<<n * g1.tiles, kThreads, pl.sm_1, st>>>(
      g1, tx, static_cast<const T*>(dy), tw1, tw2, static_cast<const T*>(w3),
      tw4, faff, fdaff, static_cast<T*>(h0), static_cast<T*>(h1),
      static_cast<T*>(dc1), static_cast<T*>(dc2), static_cast<T*>(dc4));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(b2, pl.sm_2)) != cudaSuccess) return err;
  b2<<<n * g2.tiles, kThreads, pl.sm_2, st>>>(
      g2, tx, tw1, tw2, tw4, faff, static_cast<const T*>(dc1),
      static_cast<const T*>(dc4), fdaff, static_cast<T*>(dc0),
      static_cast<T*>(dx));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(wgrad_kernel<T, kS>, pl.sm_w)) != cudaSuccess)
    return err;
  wgrad_kernel<T, kS><<<pl.items, kThreads, pl.sm_w, st>>>(
      pl.wp, tx, static_cast<const T*>(h0), static_cast<const T*>(h1),
      static_cast<const T*>(dc0), static_cast<const T*>(dc1),
      static_cast<const T*>(dc2), static_cast<const T*>(dc4),
      static_cast<float*>(ws));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wsum_kernel<<<4 * device_attr(cudaDevAttrMultiProcessorCount), kThreads, 0,
                st>>>(pl.wp, static_cast<const float*>(ws),
                      static_cast<float*>(dw1), static_cast<float*>(dw2),
                      static_cast<float*>(dw3), static_cast<float*>(dw4));
  return cudaGetLastError();
}

}  // namespace
