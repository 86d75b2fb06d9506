// K8: the stride-2 ResNet transition block, forward and backward, on the
// tensor cores of Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/fused_bottleneck.py `_fwd_kernel_down` (:499,
// driven by `_fwd_down` :649) and `_bwd_kernel_down` (:526, `_bwd_down`
// :677), public there as `fused_bottleneck_down`.  Over NHWC rows, f32
// accumulation, "round" the cast to the activation dtype T (bf16 or f32):
//   h0  = round(relu(a1 * (x @ w1) + b1))                    at H x W
//   h1  = round(relu(a2 * conv3x3_s2(h0, w2) + b2))          at H/2 x W/2
//   y   = round(relu(a3 * (h1 @ w3) + b3 + a4 * (x[:, ::2, ::2] @ w4) + b4))
// The backward recomputes the forward and returns dx (T), dW1..dW4 and the
// eight affine-grad rows (f32), rounding c0, c1, c2, c4 to T before the
// affine-grad sums and dc2, dc1, dc0, dc4 to T before their products, as
// the Pallas kernel does; the relu masks compare the f32 pre-activations
// with > 0.
//
// Every product is `pt::tc::product` (csrc/mma.cuh): bf16 operands in
// shared memory, mma.sync m16n8k16 fed by ldmatrix, K chunks by cp.async
// into a 3-slot ring; in f32 the same tiles with exact CUDA-core FMAs.
//
// Forward (`down_fwd_kernel`).  A block takes th output rows of one image
// (P = th Wo pixels) and recomputes h0 on its input rows 2 r0 - 1 .. 2 (r0
// + th) - 1 (P2 = (2 th + 1) W pixels, zero above the image: the conv's
// padding), kept in shared memory as bf16 rows padded by 16 bytes.  The
// stride-2 3x3 conv is an implicit GEMM read straight from that tile: each
// ldmatrix lane points at h0 row (2 r + dy, 2 c + dx - 1) of its pixel, a
// zero row standing for the left padding.  h1 stays in shared memory; per
// 128-channel chunk of Cout the shortcut c4 (x at phase (0, 0)) lands in
// an f32 tile and the epilogue of h1 @ w3 writes y.
//
// Backward: three activation-gradient kernels' worth of work in two
// kernels, then one batch-wide weight-gradient GEMM kernel and its
// reduction.  Nothing adds a whole weight gradient per tile.
//   B1 (`down_bwd1_kernel`, tiles as the forward): recompute h0 (halo; its
//      own rows to the h0 scratch [R_in, Cm]), c1, h1 (to the h1 scratch
//      [R_out, Cm]); per Cout chunk c4, c2, pre, dz3 and the affine grads
//      a3/b3, a4/b4 (shared-memory partials, one atomic per channel per
//      block); dc2 and dc4 to their scratches [R_out, Cout]; then dh1 =
//      dc2 w3^T (K = Cout, dc2 read back), du1, the a2/b2 grads, dc1 to its
//      scratch [R_out, Cm].
//   B2 (`down_bwd2_kernel`, th output rows, owning input rows 2 r0 .. 2 (r0
//      + th) - 1): recompute c0 on its rows; dh0 is the stride-2 conv
//      transposed, one GEMM per input phase (py, px) over the tile's output
//      cells (input pixel (2 i + py, 2 j + px) takes tap ky = 1 for py = 0,
//      ky in {0, 2} from output rows i + 1 and i for py = 1; the same for
//      the columns: nine taps over the four phases), dc1 gathered from its
//      scratch; du0, the a1/b1 grads, dc0 to its scratch [R_in, Cm]; then
//      dx per phase = dc0 w1^T, plus dc4 w4^T at phase (0, 0), one f32
//      sum rounded once.
//   W  (`down_wgrad_kernel`): all four weight gradients over all pixels,
//        dW1 = x^T dc0, dW2 = patches_s2(h0)^T dc1 (the stride-2 im2col
//        gather in the loader), dW3 = h1^T dc2, dW4 = x[:, ::2, ::2]^T dc4,
//      as 64 x 128 output tiles times a fixed number of K (pixel) slices
//      per GEMM, chosen so the items fill the card about four times over;
//      each item stores its partial tile (no atomics), and
//   R  (`down_wsum_kernel`) sums the slices in slice order: the weight
//      gradients are bitwise repeatable.  The affine grads still use
//      atomics and are not.
// At ResNet-50's three transitions, batch 128 bf16 on 132 SMs, that is
// 4.65 M / 5.44 M / 7.08 M f32 partials stored per backward (K slices
// (37, 10, 10, 10) / (10, 3, 3, 3) / (3, 1, 1, 1) of dW1..dW4 times
// their sizes; `pt_fused_down_plan` out[13]), where adding whole weight
// gradients per tile took 0.68 / 1.35 / 3.09 G atomic adds.
//
// Bound on the H100 at batch 128, for each of ResNet-50's transitions
// (56^2 256 -> 512 Cm 128; 28^2 512 -> 1024 Cm 256; 14^2 1024 -> 2048 Cm
// 512): 2 R_out (4 Cin Cm + 9 Cm^2 + Cm Cout + Cin Cout) = 95.4 GFLOP per
// forward, 0.096 ms at 989 TFLOP/s bf16, against 0.092 / 0.046 / 0.023 ms
// for x + y at 3.35 TB/s: operation-bound; the backward does 3x the
// operations.  mma.sync reaches a fraction of the wgmma peak; the tiles'
// halo (the forward and B1 recompute h0 on 2 th + 1 rows for 2 th) and
// the 16-row M granularity add ~10-25% to the products.

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

// h, w: the input's sides; th the output rows of a tile; vec: 16-byte
// loads (every channel count a multiple of the group, pointers aligned).
struct Geo {
  int h, w, cin, cm, lgcm, cout, aw, ho, wo, th, tiles;
  bool vec;
};

// A tile: output rows [r0, r0 + rows) of image img, P = rows * Wo own
// pixels, `own` the first of them in the [N Ho Wo] order.  Its h0 halo is
// input rows 2 r0 - 1 .. 2 (r0 + rows) - 1: P2 pixels, halo pixel hp
// inside the image iff hp >= lo; `xb` is the input pixel of halo pixel 0,
// `xin` that of the first own input pixel (input row 2 r0).
struct Tile {
  int img, r0, rows, P, P2, lo;
  long long own, xb, xin;
};

__device__ __forceinline__ Tile tile_of(const Geo& g) {
  Tile t;
  t.img = blockIdx.x / g.tiles;
  t.r0 = (blockIdx.x % g.tiles) * g.th;
  t.rows = min(g.th, g.ho - t.r0);
  t.P = t.rows * g.wo;
  t.P2 = (2 * t.rows + 1) * g.w;
  t.lo = t.r0 == 0 ? g.w : 0;
  t.own = (static_cast<long long>(t.img) * g.ho + t.r0) * g.wo;
  t.xin = (static_cast<long long>(t.img) * g.h + 2 * t.r0) * g.w;
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

struct FwdLayout {
  size_t ring, row, col, h0, h1, s, total;
};

template <typename T>
__host__ __device__ inline FwdLayout fwd_layout(int th, int w, int cm) {
  Carve c;
  FwdLayout l;
  const size_t p = size_t(th) * (w / 2), p2 = size_t(2 * th + 1) * w;
  const size_t ld = res_ld<T>(cm);
  l.ring = c.take(pt::tc::Cfg<T>::kRingBytes);
  l.row = c.take(sizeof(short) * p);
  l.col = c.take(sizeof(short) * p);
  l.h0 = c.take(sizeof(T) * p2 * ld);
  l.h1 = c.take(sizeof(T) * p * ld);
  l.s = c.take(sizeof(float) * p * kBN);
  l.total = c.off;
  return l;
}

struct B1Layout {
  size_t ring, row, col, h0, h1, c1r, m1, c4, daff, total;
};

template <typename T>
__host__ __device__ inline B1Layout b1_layout(int th, int w, int cm) {
  Carve c;
  B1Layout l;
  const size_t p = size_t(th) * (w / 2), p2 = size_t(2 * th + 1) * w;
  const size_t ld = res_ld<T>(cm);
  l.ring = c.take(pt::tc::Cfg<T>::kRingBytes);
  l.row = c.take(sizeof(short) * p);
  l.col = c.take(sizeof(short) * p);
  l.h0 = c.take(sizeof(T) * p2 * ld);
  l.h1 = c.take(sizeof(T) * p * ld);
  l.c1r = c.take(sizeof(T) * p * cm);       // round(c1)
  l.m1 = c.take(p * cm);                    // u1 > 0
  l.c4 = c.take(sizeof(float) * p * kBN);   // c4 of one Cout chunk
  l.daff = c.take(sizeof(float) * (2 * cm + 4 * kBN));
  l.total = c.off;
  return l;
}

struct B2Layout {
  size_t ring, row, col, c0r, m0, daff, total;
};

template <typename T>
__host__ __device__ inline B2Layout b2_layout(int th, int w, int cm) {
  Carve c;
  B2Layout l;
  const size_t p = size_t(th) * (w / 2), pin = size_t(2 * th) * w;
  l.ring = c.take(pt::tc::Cfg<T>::kRingBytes);
  l.row = c.take(sizeof(short) * p);
  l.col = c.take(sizeof(short) * p);
  l.c0r = c.take(sizeof(T) * pin * cm);     // round(c0) of the own rows
  l.m0 = c.take(pin * cm);                  // u0 > 0
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

// h0 over the tile's halo rows, zero above the image; with h0g, the own
// rows (halo rows 1 .. 2 rows) also go to the h0 scratch.
template <typename T>
__device__ void halo_h0(const Geo& g, const Tile& t, const T* x, const T* w1,
                        const float* aff, T* h0s, T* h0g, T* ring) {
  const int ld = res_ld<T>(g.cm);
  const float* a1 = aff;
  const float* b1 = aff + g.aw;
  product<T, false, true, false>(
      t.P2, g.cm, g.cin, g.vec,
      [&](int m, int k) -> const T* {
        return m >= t.lo ? x + (t.xb + m) * g.cin + k : nullptr;
      },
      [&](int k, int n) -> const T* { return w1 + size_t(k) * g.cm + n; },
      [&](int m, int n, float v) {
        const T h = pt::from_f32<T>(
            m >= t.lo ? fmaxf(affine(v, a1[n], b1[n]), 0.f) : 0.f);
        h0s[m * ld + n] = h;
        if (h0g != nullptr && m >= g.w) h0g[(t.xb + m) * g.cm + n] = h;
      },
      ring);
}

// c1 = conv3x3_s2(h0, w2) over the tile's own pixels, read from the
// resident h0 rows: k = tap * Cm + c, tap = dy * 3 + dx; output row r
// reads halo row 2 r + dy, column 2 col + dx - 1 (never past the right
// edge: 2 (Wo - 1) + 1 = W - 1).
template <typename T, class Epi>
__device__ void conv_s2(const Geo& g, const Tile& t, const short* rowt,
                        const short* colt, const T* h0s, const T* w2,
                        const Epi& epi, T* ring) {
  const int ld = res_ld<T>(g.cm);
  product<T, false, true, true>(
      t.P, g.cm, 9 * g.cm, g.vec,
      [&](int m, int k) -> const T* {
        const int tap = k >> g.lgcm, c = k & (g.cm - 1);
        const int dy = tap / 3, dx = tap - 3 * dy;
        const int col = 2 * colt[m] + dx - 1;
        if (col < 0) return nullptr;
        return h0s + ((2 * rowt[m] + dy) * g.w + col) * ld + c;
      },
      [&](int k, int n) -> const T* { return w2 + size_t(k) * g.cm + n; },
      epi, ring);
}

// The input pixel own output pixel p's shortcut reads: phase (0, 0) of
// its 2 x 2 cell, x[:, ::2, ::2].
__device__ __forceinline__ long long in_pixel(const Geo& g, const Tile& t,
                                              const short* rowt,
                                              const short* colt, int p) {
  return t.xin + 2 * rowt[p] * g.w + 2 * colt[p];
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
down_fwd_kernel(Geo g, const T* __restrict__ x, const T* __restrict__ w1,
                const T* __restrict__ w2, const T* __restrict__ w3,
                const T* __restrict__ w4, const float* __restrict__ aff,
                T* __restrict__ y) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const FwdLayout L = fwd_layout<T>(g.th, g.w, g.cm);
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  short* rowt = reinterpret_cast<short*>(smem + L.row);
  short* colt = reinterpret_cast<short*>(smem + L.col);
  T* h0s = reinterpret_cast<T*>(smem + L.h0);
  T* h1s = reinterpret_cast<T*>(smem + L.h1);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  const Tile t = tile_of(g);
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
  conv_s2<T>(
      g, t, rowt, colt, h0s, w2,
      [&](int m, int n, float v) {
        h1s[m * ld + n] = pt::from_f32<T>(fmaxf(affine(v, a2[n], b2[n]), 0.f));
      },
      ring);
  for (int j0 = 0; j0 < g.cout; j0 += kBN) {
    const int nc = min(kBN, g.cout - j0);
    product<T, false, true, false>(
        t.P, nc, g.cin, g.vec,
        [&](int m, int k) -> const T* {
          return x + in_pixel(g, t, rowt, colt, m) * g.cin + k;
        },
        [&](int k, int n) -> const T* {
          return w4 + size_t(k) * g.cout + j0 + n;
        },
        [&](int m, int n, float v) {
          ss[m * kBN + n] = affine(v, a4[j0 + n], b4[j0 + n]);
        },
        ring);
    product<T, false, true, true>(
        t.P, nc, g.cm, g.vec,
        [&](int m, int k) -> const T* { return h1s + m * ld + k; },
        [&](int k, int n) -> const T* {
          return w3 + size_t(k) * g.cout + j0 + n;
        },
        [&](int m, int n, float v) {
          const int col = j0 + n;
          const float pre = affine(v, a3[col], b3[col]) + ss[m * kBN + n];
          y[(t.own + m) * g.cout + col] = pt::from_f32<T>(fmaxf(pre, 0.f));
        },
        ring);
  }
}

// ---------------------------------------------------------------------------
// backward, B1: recompute; the Cout-wide chain; dc2, dc4, dc1, h0, h1 out
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
down_bwd1_kernel(Geo g, const T* __restrict__ x, const T* __restrict__ dy,
                 const T* __restrict__ w1, const T* __restrict__ w2,
                 const T* __restrict__ w3, const T* __restrict__ w4,
                 const float* __restrict__ aff, float* __restrict__ daff,
                 T* __restrict__ h0g, T* __restrict__ h1g,
                 T* __restrict__ dc1g, T* __restrict__ dc2g,
                 T* __restrict__ dc4g) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const B1Layout L = b1_layout<T>(g.th, g.w, g.cm);
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
  const Tile t = tile_of(g);
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
  conv_s2<T>(
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
    product<T, false, true, false>(
        t.P, nc, g.cin, g.vec,
        [&](int m, int k) -> const T* {
          return x + in_pixel(g, t, rowt, colt, m) * g.cin + k;
        },
        [&](int k, int n) -> const T* {
          return w4 + size_t(k) * g.cout + j0 + n;
        },
        [&](int m, int n, float v) { c4s[m * kBN + n] = v; }, ring);
    product<T, false, true, true>(
        t.P, nc, g.cm, g.vec,
        [&](int m, int k) -> const T* { return h1s + m * ld + k; },
        [&](int k, int n) -> const T* {
          return w3 + size_t(k) * g.cout + j0 + n;
        },
        [&](int m, int n, float v) {
          const int col = j0 + n;
          const long long at = (t.own + m) * g.cout + col;
          const float c4 = c4s[m * kBN + n];
          const bool keep =
              affine(v, a3[col], b3[col]) + affine(c4, a4[col], b4[col]) > 0.f;
          const float dz3 = keep ? pt::to_f32(dy[at]) : 0.f;
          atomicAdd(dC + n, dz3 * rnd<T>(v));
          atomicAdd(dC + kBN + n, dz3);
          atomicAdd(dC + 2 * kBN + n, dz3 * rnd<T>(c4));
          dc2g[at] = pt::from_f32<T>(dz3 * a3[col]);
          dc4g[at] = pt::from_f32<T>(dz3 * a4[col]);
        },
        ring);
    __syncthreads();
    for (int n = tid; n < nc; n += kThreads) {
      atomicAdd(daff + 4 * g.aw + j0 + n, dC[n]);
      atomicAdd(daff + 5 * g.aw + j0 + n, dC[kBN + n]);
      atomicAdd(daff + 6 * g.aw + j0 + n, dC[2 * kBN + n]);
      atomicAdd(daff + 7 * g.aw + j0 + n, dC[kBN + n]);
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
// backward, B2: dh0 (the stride-2 3x3 conv transposed, by input phase),
// dc0, dx
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
down_bwd2_kernel(Geo g, const T* __restrict__ x, const T* __restrict__ w1,
                 const T* __restrict__ w2, const T* __restrict__ w4,
                 const float* __restrict__ aff, const T* __restrict__ dc1g,
                 const T* __restrict__ dc4g, float* __restrict__ daff,
                 T* __restrict__ dc0g, T* __restrict__ dx) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const B2Layout L = b2_layout<T>(g.th, g.w, g.cm);
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  short* rowt = reinterpret_cast<short*>(smem + L.row);
  short* colt = reinterpret_cast<short*>(smem + L.col);
  T* c0r = reinterpret_cast<T*>(smem + L.c0r);
  uint8_t* m0 = reinterpret_cast<uint8_t*>(smem + L.m0);
  float* dA = reinterpret_cast<float*>(smem + L.daff);  // rows 0, 1: [2][Cm]
  const Tile t = tile_of(g);
  const int tid = threadIdx.x;
  const int pin = 2 * t.rows * g.w;  // own input pixels
  const float* a1 = aff;
  const float* b1 = aff + g.aw;
  // own input pixel (local index) of phase (py, px) of output cell m
  auto qof = [&](int m, int py, int px) {
    return (2 * rowt[m] + py) * g.w + 2 * colt[m] + px;
  };

  fill_tables(g, t, rowt, colt);
  pt::tc::zero_row(ring);
  for (int i = tid; i < 2 * g.cm; i += kThreads) dA[i] = 0.f;
  product<T, false, true, false>(
      pin, g.cm, g.cin, g.vec,
      [&](int m, int k) -> const T* { return x + (t.xin + m) * g.cin + k; },
      [&](int k, int n) -> const T* { return w1 + size_t(k) * g.cm + n; },
      [&](int m, int n, float v) {
        c0r[m * g.cm + n] = pt::from_f32<T>(v);
        m0[m * g.cm + n] = affine(v, a1[n], b1[n]) > 0.f;
      },
      ring);
  for (int ph = 0; ph < 4; ++ph) {
    const int py = ph >> 1, px = ph & 1;
    const int nx = px ? 2 : 1;
    const int ntaps = (py ? 2 : 1) * nx;
    // k = tap * Cm + o over this phase's taps; (ky, kx) of the tap
    auto tap_of = [&](int k, int& ky, int& kx) {
      const int tp = k >> g.lgcm, iy = tp / nx, ix = tp - nx * iy;
      ky = py ? 2 * iy : 1;
      kx = px ? 2 * ix : 1;
    };
    product<T, false, false, false>(
        t.P, g.cm, ntaps * g.cm, g.vec,
        [&](int m, int k) -> const T* {
          int ky, kx;
          tap_of(k, ky, kx);
          const int i = t.r0 + rowt[m] + ((py + 1 - ky) >> 1);
          const int j = colt[m] + ((px + 1 - kx) >> 1);
          if (i >= g.ho || j >= g.wo) return nullptr;
          return dc1g +
                 ((static_cast<long long>(t.img) * g.ho + i) * g.wo + j) *
                     g.cm +
                 (k & (g.cm - 1));
        },
        [&](int k, int n) -> const T* {
          int ky, kx;
          tap_of(k, ky, kx);
          return w2 + (size_t(ky * 3 + kx) * g.cm + n) * g.cm +
                 (k & (g.cm - 1));
        },
        [&](int m, int n, float v) {
          const int q = qof(m, py, px);
          const float du0 = m0[q * g.cm + n] ? v : 0.f;
          atomicAdd(dA + n, du0 * pt::to_f32(c0r[q * g.cm + n]));
          atomicAdd(dA + g.cm + n, du0);
          dc0g[(t.xin + q) * g.cm + n] = pt::from_f32<T>(du0 * a1[n]);
        },
        ring);
  }
  __syncthreads();
  for (int c = tid; c < g.cm; c += kThreads) {
    atomicAdd(daff + c, dA[c]);
    atomicAdd(daff + g.aw + c, dA[g.cm + c]);
  }
  // dx = dc0 w1^T, plus dc4 w4^T at phase (0, 0): one f32 sum, rounded
  // once; dc0 read back from its scratch
  for (int ph = 0; ph < 4; ++ph) {
    const int py = ph >> 1, px = ph & 1;
    product<T, false, false, false>(
        t.P, g.cin, g.cm + (ph == 0 ? g.cout : 0), g.vec,
        [&](int m, int k) -> const T* {
          return k < g.cm ? dc0g + (t.xin + qof(m, py, px)) * g.cm + k
                          : dc4g + (t.own + m) * g.cout + (k - g.cm);
        },
        [&](int k, int n) -> const T* {
          return k < g.cm ? w1 + size_t(n) * g.cm + k
                          : w4 + size_t(n) * g.cout + (k - g.cm);
        },
        [&](int m, int n, float v) {
          dx[(t.xin + qof(m, py, px)) * g.cin + n] = pt::from_f32<T>(v);
        },
        ring);
  }
}

// ---------------------------------------------------------------------------
// backward, W: the four weight gradients over all pixels, in K slices
// ---------------------------------------------------------------------------

// GEMM q (0: dW1, 1: dW2, 2: dW3, 3: dW4) is [M, N] over K pixels, cut in
// ceil(M / 64) x ceil(N / 128) output tiles (tn across) times S slices of
// L pixels; its items are blockIdx.x in [first, first + tiles * S), and
// slice s of it lands at ws + off + s * M * N.
struct WPlan {
  int h, w, cin, cm, lgcm, cout, ho, wo;
  bool vec;
  int M[4], N[4], K[4], L[4], S[4], tn[4], first[5];
  long long off[5];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
down_wgrad_kernel(WPlan p, const T* __restrict__ x, const T* __restrict__ h0g,
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
    case 1:  // dW2 = patches_s2(h0)^T dc1: rows tap * Cm + c
      product<T, true, true, false>(
          M, N, K, p.vec,
          [&](int m, int k) -> const T* {
            int img, i, j;
            split(static_cast<long long>(k0) + k, img, i, j);
            const int mm = m0 + m, tap = mm >> p.lgcm;
            const int dy = tap / 3, dx = tap - 3 * dy;
            const int r = 2 * i + dy - 1, c = 2 * j + dx - 1;
            if (r < 0 || c < 0) return nullptr;
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
    default:  // dW4 = x[:, ::2, ::2]^T dc4
      product<T, true, true, false>(
          M, N, K, p.vec,
          [&](int m, int k) -> const T* {
            int img, i, j;
            split(static_cast<long long>(k0) + k, img, i, j);
            return x +
                   ((static_cast<long long>(img) * p.h + 2 * i) * p.w + 2 * j) *
                       p.cin +
                   m0 + m;
          },
          [&](int k, int n) -> const T* {
            return dc4g + (static_cast<long long>(k0) + k) * p.cout + n0 + n;
          },
          epi, ring);
  }
}

// R: dW_q = sum over its slices, in slice order.
__global__ void __launch_bounds__(kThreads)
down_wsum_kernel(WPlan p, const float* __restrict__ ws,
                 float* __restrict__ dw1, float* __restrict__ dw2,
                 float* __restrict__ dw3, float* __restrict__ dw4) {
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

int device_attr(cudaDeviceAttr a) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, a, dev);
  return v;
}

long long up_to(long long v, long long m) { return (v + m - 1) / m * m; }

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

template <typename T>
Plan make_plan(int n, int h, int w, int cin, int cm, int cout) {
  Plan pl{};
  const int ho = h / 2, wo = w / 2;
  const double cc = double(cin) * cm;
  const double own = 9.0 * cm * cm + double(cout) * (cm + cin);
  auto halo_cost = [&](int rows) {
    return up_to((2 * rows + 1) * w, 16) * cc + up_to(rows * wo, 16) * own;
  };
  pl.th_f = pick_th(ho, [&](int t) { return fwd_layout<T>(t, w, cm).total; },
                    halo_cost);
  pl.th_1 = pick_th(ho, [&](int t) { return b1_layout<T>(t, w, cm).total; },
                    halo_cost);
  pl.th_2 = pick_th(
      ho, [&](int t) { return b2_layout<T>(t, w, cm).total; },
      [&](int rows) {
        return up_to(2 * rows * w, 16) * cc +
               up_to(rows * wo, 16) *
                   (9.0 * cm * cm + 4.0 * cm * cin + double(cout) * cin);
      });
  pl.sm_f = pl.th_f ? fwd_layout<T>(pl.th_f, w, cm).total : 0;
  pl.sm_1 = pl.th_1 ? b1_layout<T>(pl.th_1, w, cm).total : 0;
  pl.sm_2 = pl.th_2 ? b2_layout<T>(pl.th_2, w, cm).total : 0;
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
  const int Ms[4] = {cin, 9 * cm, cm, cin}, Ns[4] = {cm, cm, cout, cout};
  const long long Ks[4] = {r_in, r_out, r_out, r_out};
  // one slice length for all four: the items fill the SMs kWaves times
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

bool geo_ok(int n, int h, int w, int cin, int cm, int cout, int aw) {
  if (n < 1 || h < 2 || w < 2 || cin < 1 || cm < 1 || cout < 1) return false;
  if (cm & (cm - 1)) return false;             // Cm a power of two
  if (h % 2 || w % 2) return false;            // even sides
  if (aw < cm || aw < cout) return false;
  if (w * kMaxTH > 32767) return false;        // short pixel tables
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

Geo make_geo(int h, int w, int cin, int cm, int cout, int aw, int th,
             bool vec) {
  int lg = 0;
  while ((1 << lg) < cm) ++lg;
  const int ho = h / 2;
  return Geo{h, w, cin, cm, lg, cout, aw, ho, w / 2, th, (ho + th - 1) / th,
             vec};
}

template <class Kernel>
cudaError_t set_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w1, const void* w2,
                       const void* w3, const void* w4, const void* aff,
                       void* y, int n, int h, int w, int cin, int cm,
                       int cout, int aw, cudaStream_t st) {
  const Plan pl = make_plan<T>(n, h, w, cin, cm, cout);
  if (pl.th_f == 0) return cudaErrorInvalidValue;
  const Geo g = make_geo(h, w, cin, cm, cout, aw, pl.th_f,
                         vec_ok<T>(cin, cm, cout, {x, w1, w2, w3, w4, y}));
  cudaError_t err = set_smem(down_fwd_kernel<T>, pl.sm_f);
  if (err != cudaSuccess) return err;
  down_fwd_kernel<T><<<n * g.tiles, kThreads, pl.sm_f, st>>>(
      g, static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(w2), static_cast<const T*>(w3),
      static_cast<const T*>(w4), static_cast<const float*>(aff),
      static_cast<T*>(y));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, const void* w1,
                       const void* w2, const void* w3, const void* w4,
                       const void* aff, void* dx, void* dw1, void* dw2,
                       void* dw3, void* dw4, void* daff, void* h0, void* h1,
                       void* dc0, void* dc1, void* dc2, void* dc4, void* ws,
                       int n, int h, int w, int cin, int cm, int cout, int aw,
                       cudaStream_t st) {
  Plan pl = make_plan<T>(n, h, w, cin, cm, cout);
  if (pl.th_1 == 0 || pl.th_2 == 0) return cudaErrorInvalidValue;
  const bool vec = vec_ok<T>(cin, cm, cout, {x, dy, w1, w2, w3, w4, dx, h0,
                                             h1, dc0, dc1, dc2, dc4});
  pl.wp.vec = vec;
  const Geo g1 = make_geo(h, w, cin, cm, cout, aw, pl.th_1, vec);
  const Geo g2 = make_geo(h, w, cin, cm, cout, aw, pl.th_2, vec);
  const T* tx = static_cast<const T*>(x);
  const T* tw1 = static_cast<const T*>(w1);
  const T* tw2 = static_cast<const T*>(w2);
  const T* tw4 = static_cast<const T*>(w4);
  const float* faff = static_cast<const float*>(aff);
  float* fdaff = static_cast<float*>(daff);
  cudaError_t err = set_smem(down_bwd1_kernel<T>, pl.sm_1);
  if (err != cudaSuccess) return err;
  down_bwd1_kernel<T><<<n * g1.tiles, kThreads, pl.sm_1, st>>>(
      g1, tx, static_cast<const T*>(dy), tw1, tw2, static_cast<const T*>(w3),
      tw4, faff, fdaff, static_cast<T*>(h0), static_cast<T*>(h1),
      static_cast<T*>(dc1), static_cast<T*>(dc2), static_cast<T*>(dc4));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(down_bwd2_kernel<T>, pl.sm_2)) != cudaSuccess)
    return err;
  down_bwd2_kernel<T><<<n * g2.tiles, kThreads, pl.sm_2, st>>>(
      g2, tx, tw1, tw2, tw4, faff, static_cast<const T*>(dc1),
      static_cast<const T*>(dc4), fdaff, static_cast<T*>(dc0),
      static_cast<T*>(dx));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(down_wgrad_kernel<T>, pl.sm_w)) != cudaSuccess)
    return err;
  down_wgrad_kernel<T><<<pl.items, kThreads, pl.sm_w, st>>>(
      pl.wp, tx, static_cast<const T*>(h0), static_cast<const T*>(h1),
      static_cast<const T*>(dc0), static_cast<const T*>(dc1),
      static_cast<const T*>(dc2), static_cast<const T*>(dc4),
      static_cast<float*>(ws));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  down_wsum_kernel<<<4 * device_attr(cudaDevAttrMultiProcessorCount),
                     kThreads, 0, st>>>(
      pl.wp, static_cast<const float*>(ws), static_cast<float*>(dw1),
      static_cast<float*>(dw2), static_cast<float*>(dw3),
      static_cast<float*>(dw4));
  return cudaGetLastError();
}

}  // namespace

// x: [n, h, w, cin] with h and w even, w1: [cin, cm], w2: [3, 3, cm, cm]
// (HWIO), w3: [cm, cout], w4: [cin, cout], y: [n, h/2, w/2, cout], all
// contiguous in `dtype`; aff: [8, aw] float32 rows a1, b1, a2, b2, a3, b3,
// a4, b4; cm a power of two.  Returns cudaGetLastError() after the launch.
extern "C" int pt_fused_down_fwd(const void* x, const void* w1,
                                 const void* w2, const void* w3,
                                 const void* w4, const void* aff, void* y,
                                 int n, int h, int w, int cin, int cm,
                                 int cout, int aw, int dtype, void* stream) {
  if (!geo_ok(n, h, w, cin, cm, cout, aw)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kFloat32)
    return int(launch_fwd<float>(x, w1, w2, w3, w4, aff, y, n, h, w, cin, cm,
                                 cout, aw, st));
  if (dtype == pt::kBFloat16)
    return int(launch_fwd<__nv_bfloat16>(x, w1, w2, w3, w4, aff, y, n, h, w,
                                         cin, cm, cout, aw, st));
  return int(cudaErrorInvalidValue);
}

// As pt_fused_down_fwd, plus dy: [n, h/2, w/2, cout].  Writes dx ([n, h,
// w, cin], `dtype`), dw1..dw4 (float32, shaped as the weights) and ADDS
// into daff ([8, aw] float32), which the caller zeroes.  Scratch, sized by
// pt_fused_down_plan: h0, dc0 [n h w, cm], h1, dc1 [n h/2 w/2, cm], dc2,
// dc4 [n h/2 w/2, cout] in `dtype`, ws (float32, out[13] elements).
// Launches B1, B2, W and R on `stream`; returns cudaGetLastError().
extern "C" int pt_fused_down_bwd(
    const void* x, const void* dy, const void* w1, const void* w2,
    const void* w3, const void* w4, const void* aff, void* dx, void* dw1,
    void* dw2, void* dw3, void* dw4, void* daff, void* h0, void* h1,
    void* dc0, void* dc1, void* dc2, void* dc4, void* ws, int n, int h, int w,
    int cin, int cm, int cout, int aw, int dtype, void* stream) {
  if (!geo_ok(n, h, w, cin, cm, cout, aw)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_BWD(T)                                                           \
  launch_bwd<T>(x, dy, w1, w2, w3, w4, aff, dx, dw1, dw2, dw3, dw4, daff,   \
                h0, h1, dc0, dc1, dc2, dc4, ws, n, h, w, cin, cm, cout, aw, \
                st)
  if (dtype == pt::kFloat32) return int(PT_BWD(float));
  if (dtype == pt::kBFloat16) return int(PT_BWD(__nv_bfloat16));
#undef PT_BWD
  return int(cudaErrorInvalidValue);
}

// The plan of one geometry on the current device: out[0..2] the tile
// heights (output rows) of the forward, B1 and B2 (0 where none fits),
// out[3..5] their blocks, out[6..8] their shared memory (bytes), out[9..12]
// the K slices of dW1..dW4, out[13] the float32 partials (ws elements),
// out[14] the weight-gradient items (blocks).  Returns 0, or
// cudaErrorInvalidValue outside the envelope.
extern "C" int pt_fused_down_plan(int n, int h, int w, int cin, int cm,
                                  int cout, int dtype, long long* out) {
  if (!geo_ok(n, h, w, cin, cm, cout, cout > cm ? cout : cm))
    return int(cudaErrorInvalidValue);
  const Plan pl = dtype == pt::kFloat32
                      ? make_plan<float>(n, h, w, cin, cm, cout)
                      : make_plan<__nv_bfloat16>(n, h, w, cin, cm, cout);
  const int ho = h / 2;
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
  return 0;
}
