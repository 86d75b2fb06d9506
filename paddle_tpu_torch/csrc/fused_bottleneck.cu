// K7: fused stride-1 ResNet bottleneck block, forward and backward, for
// Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/fused_bottleneck.py `_fwd_kernel` (driven by
// `_fwd`) and `_bwd_kernel` (driven by `_bwd`), public there as
// `fused_bottleneck` (identity shortcut) and `fused_bottleneck_proj`
// (projection shortcut).  Over NHWC rows, with f32 accumulation:
//   h0  = round(relu(a1 * (x @ w1) + b1))
//   h1  = round(relu(a2 * conv3x3(h0, w2) + b2))        (zero padding)
//   y   = round(relu(a3 * (h1 @ w3) + b3 + s)),  s = x | a4 * (x @ w4) + b4
// "round" is the cast to the activation dtype T (bf16 or f32).  The
// backward recomputes the forward and returns dx (T), dW1..dW4 and the
// eight affine-grad rows (f32), rounding c0, c1, c2, c4 to T before the
// affine-grad sums and dc2, dc1, dc0 (dc4) to T before their products, as
// the Pallas `_bwd_kernel` does; the relu masks compare the f32 pre-
// activations with > 0.
//
// Tiles.  The TPU kernel holds a batch tile of full H x W planes in VMEM
// (tens of MB).  A Hopper block has at most 227 KB of shared memory, so a
// block takes TH full rows of one image and recomputes h0 on its one-row
// halo: (TH+2) x W pixels of h0 live in shared memory (zero outside the
// image, which is the 3x3 conv's zero padding), then TH x W pixels of h1.
// Weights stream through shared memory in 32-deep K chunks, so each weight
// element serves the whole tile.  `pick_th` chooses TH per kernel and
// launch: among TH <= 8 whose shared memory fits the card, the one whose
// tiles compute the fewest rows, ceil(H/TH) * (TH + 2) (ties to the
// larger TH).  ResNet-50's identity blocks have W * Cm = 3584 at every
// stage, so in bf16 the forward gets TH 8 at stage 1 (56 rows: 7 tiles of
// 10 rows) and TH 7 at stages 2-4; the backward's B1, which keeps more
// per pixel (h1, round(c1), the u1 mask, f32 dh1, a dc2 chunk), gets TH
// 4-5; B2 has no halo and takes the largest TH that fits.  f32 tiles are
// smaller.  The last tile of an image may be ragged (H % TH != 0).
//
// The products.  Every product is one routine, `gemm`: a 256-thread block
// computes a [M, N] result in 64 x 64 output tiles, each thread a 4 x 4
// patch of f32 accumulators on the CUDA cores (fmaf), over K in 32-deep
// chunks staged in shared memory as f32 by loader functions that gather
// the operand from wherever it lives (device memory, the h0/h1 tiles, an
// im2col view of h0, the transposed weights).  An epilogue function gets
// each finished element.  Tensor cores (mma.sync / wgmma), TMA and
// pipelining are later work; this version is the simple, exact one (f32
// products and sums, no TF32).
//
// The backward as two kernels.  dh0 is the 3x3 conv transposed, so a tile
// needs dc1 on its one-row halo, and dc1 there depends on the whole chain
// below it (c2, dy, dh1) on those rows.  Rather than recompute that chain
// on a second halo, the backward entry runs two kernels in a row:
//   B1  recompute h0 (halo), c1/h1, then per 64-channel chunk of Cout: c2
//       (and c4), pre, dz3, the affine grads a3/b3 (a4/b4), dc2, dW3 +=
//       h1^T dc2 and dh1 += dc2 w3^T; then du1, the a2/b2 grads, dc1
//       (written to a [R, Cm] scratch in T) and dW2 += patches(h0)^T dc1;
//       the relu mask of pre goes to a [R, Cout] byte scratch;
//   B2  recompute c0 on its own rows, dh0 = im2col(dc1) against the flipped
//       transposed w2 (dc1 read from the scratch, halo included), du0, the
//       a1/b1 grads, dc0, dW1 += x^T dc0, (dc4 from the mask and dy, dW4 +=
//       x^T dc4), dx = round(dc0 w1^T [+ dc4 w4^T] [+ dz3]).
// Device memory sees x and dy read twice, dx written once, and the two
// scratches (Cm + Cout bytes-per-pixel-ish: at stage 1 bf16 about 1/3 of
// x + dy + dx).
//
// Sums across blocks.  The TPU kernel carries dW and the affine grads in
// output blocks revisited by every sequential grid step.  Hopper blocks
// run in parallel, so each block reduces its tile's contribution in
// registers (dW: one 64 x 64 GEMM tile per thread block) or in shared
// memory (affine grads) and adds it to one f32 buffer with atomicAdd.
// The order of those additions changes from run to run, so the weight
// and affine grads are NOT bitwise deterministic (f32 sums in another
// order; the forward and dx are deterministic).  A per-block partial plus
// a second pass would be deterministic but needs 17.8 MB per partial at
// stage 4 (dW1+dW2+dW3 = 4.46 M floats).
//
// Bound on the H100 at batch 128: 2 R (Cin Cm + 9 Cm^2 + Cm Cout) = 55.9
// GFLOP per forward at every identity stage; against 989 TFLOP/s bf16
// that is 0.057 ms, under the 0.123 ms that x + y take at stage 1 (411
// MB at 3.35 TB/s), so stage 1 is byte-bound and stage 4 (60 MB)
// operation-bound.  This kernel runs those operations as scalar f32 FMAs
// on the CUDA cores (67 TFLOP/s peak), so it is bound by them, far above
// either bound; the backward does about 3x the forward's operations.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 64;             // output tile rows of `gemm`
constexpr int kTN = 64;             // output tile columns
constexpr int kTK = 32;             // K chunk staged in shared memory
constexpr int kAStride = kTM + 1;   // As [kTK][kTM+1]: conflict-free fills
constexpr int kBStride = kTN + 4;   // Bs [kTK][kTN+4]: float4-aligned rows
constexpr int kChunk = 64;          // Cout channels per chunk (B1, forward)
constexpr int kMaxTH = 8;

struct Geo {
  int n, h, w, cin, cm, lgcm, cout, aw, th, tiles_per_img;
};

// A tile: rows [r0, r0 + rows) of image img; `own` is the index of its
// first pixel in the [N*H*W] pixel order.  Halo pixel hp (0 <= hp < P2)
// is row r0 - 1 + hp / W; it lies in the image iff lo <= hp < hi.
struct Tile {
  int img, r0, rows, P, P2, lo, hi;
  long long own;
};

__device__ __forceinline__ Tile tile_of(const Geo& g) {
  Tile t;
  t.img = blockIdx.x / g.tiles_per_img;
  t.r0 = (blockIdx.x % g.tiles_per_img) * g.th;
  t.rows = min(g.th, g.h - t.r0);
  t.P = t.rows * g.w;
  t.P2 = (t.rows + 2) * g.w;
  t.lo = t.r0 == 0 ? g.w : 0;
  t.hi = t.r0 + t.rows >= g.h ? (t.rows + 1) * g.w : t.P2;
  t.own = (static_cast<long long>(t.img) * g.h + t.r0) * g.w;
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

struct FwdLayout {
  size_t as, bs, row, col, h0, h1, s, total;
};

__host__ __device__ inline FwdLayout fwd_layout(int th, int w, int cm,
                                                int tsz, bool proj) {
  Carve c;
  FwdLayout l;
  const size_t p = size_t(th) * w, p2 = size_t(th + 2) * w;
  l.as = c.take(sizeof(float) * kTK * kAStride);
  l.bs = c.take(sizeof(float) * kTK * kBStride);
  l.row = c.take(sizeof(short) * p);
  l.col = c.take(sizeof(short) * p);
  l.h0 = c.take(tsz * p2 * cm);
  l.h1 = c.take(tsz * p * cm);
  l.s = c.take(proj ? sizeof(float) * p * kChunk : 0);
  l.total = c.off;
  return l;
}

struct B1Layout {
  size_t as, bs, row, col, h0, h1, c1r, m1, dh1, dc2, c4, daff, total;
};

__host__ __device__ inline B1Layout b1_layout(int th, int w, int cm, int tsz,
                                              bool proj) {
  Carve c;
  B1Layout l;
  const size_t p = size_t(th) * w, p2 = size_t(th + 2) * w;
  l.as = c.take(sizeof(float) * kTK * kAStride);
  l.bs = c.take(sizeof(float) * kTK * kBStride);
  l.row = c.take(sizeof(short) * p);
  l.col = c.take(sizeof(short) * p);
  l.h0 = c.take(tsz * p2 * cm);
  l.h1 = c.take(tsz * p * cm);
  l.c1r = c.take(tsz * p * cm);           // round(c1), then dc1
  l.m1 = c.take(p * cm);                  // u1 > 0
  l.dh1 = c.take(sizeof(float) * p * cm);
  l.dc2 = c.take(tsz * p * kChunk);
  l.c4 = c.take(proj ? sizeof(float) * p * kChunk : 0);
  l.daff = c.take(sizeof(float) * (2 * cm + 4 * kChunk));
  l.total = c.off;
  return l;
}

struct B2Layout {
  size_t as, bs, row, col, c0, dc0, daff, total;
};

__host__ __device__ inline B2Layout b2_layout(int th, int w, int cm,
                                              int tsz) {
  Carve c;
  B2Layout l;
  const size_t p = size_t(th) * w;
  l.as = c.take(sizeof(float) * kTK * kAStride);
  l.bs = c.take(sizeof(float) * kTK * kBStride);
  l.row = c.take(sizeof(short) * p);
  l.col = c.take(sizeof(short) * p);
  l.c0 = c.take(sizeof(float) * p * cm);  // f32 c0 of the own rows
  l.dc0 = c.take(tsz * p * cm);
  l.daff = c.take(sizeof(float) * 2 * cm);
  l.total = c.off;
  return l;
}

// C[m, n] = sum_k A(m, k) B(k, n) for m < M, n < N, in f32; epi(m, n, v)
// receives each element.  kAFastM / kBFastK say which index of each
// operand is contiguous where the loader reads it, so the fill walks it
// with neighbouring threads.  Starts with a barrier, so the loaders may
// read what an earlier epilogue wrote to shared memory; an epilogue must
// not write what its own loaders read.
template <bool kAFastM, bool kBFastK, class ALoad, class BLoad, class Epi>
__device__ void gemm(int M, int N, int K, const ALoad& a, const BLoad& b,
                     const Epi& epi, float* As, float* Bs) {
  const int tid = threadIdx.x;
  const int tm = tid >> 4, tn = tid & 15;
  for (int m0 = 0; m0 < M; m0 += kTM) {
    for (int n0 = 0; n0 < N; n0 += kTN) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += kTK) {
        __syncthreads();
        for (int i = tid; i < kTM * kTK; i += kThreads) {
          const int mm = kAFastM ? i % kTM : i / kTK;
          const int kk = kAFastM ? i / kTM : i % kTK;
          const int m = m0 + mm, k = k0 + kk;
          As[kk * kAStride + mm] = (m < M && k < K) ? a(m, k) : 0.f;
        }
        for (int i = tid; i < kTK * kTN; i += kThreads) {
          const int nn = kBFastK ? i / kTK : i % kTN;
          const int kk = kBFastK ? i % kTK : i / kTN;
          const int n = n0 + nn, k = k0 + kk;
          Bs[kk * kBStride + nn] = (n < N && k < K) ? b(k, n) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kTK; ++kk) {
          const float4 bv =
              *reinterpret_cast<const float4*>(Bs + kk * kBStride + tn * 4);
          const float* ar = As + kk * kAStride + tm * 4;
          const float av[4] = {ar[0], ar[1], ar[2], ar[3]};
          const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + tm * 4 + i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tn * 4 + j;
          if (n < N) epi(m, n, acc[i][j]);
        }
      }
    }
  }
}

// c * a + b as the plain version rounds it: the product, then the sum
// (no fused multiply-add), so a relu mask compares the same f32 value.
__device__ __forceinline__ float affine(float c, float a, float b) {
  return __fadd_rn(__fmul_rn(c, a), b);
}

__device__ __forceinline__ void fill_tables(const Geo& g, const Tile& t,
                                            short* rowt, short* colt) {
  for (int p = threadIdx.x; p < t.P; p += kThreads) {
    rowt[p] = static_cast<short>(p / g.w);
    colt[p] = static_cast<short>(p % g.w);
  }
}

// h0 over the tile's halo rows, zero outside the image.
template <typename T>
__device__ void halo_h0(const Geo& g, const Tile& t, const T* __restrict__ x,
                        const T* __restrict__ w1,
                        const float* __restrict__ aff, T* h0s, float* As,
                        float* Bs) {
  const long long xb = t.own - g.w;  // pixel index of halo pixel 0
  const float* a1 = aff;
  const float* b1 = aff + g.aw;
  gemm<false, false>(
      t.P2, g.cm, g.cin,
      [&](int m, int k) {
        return (m >= t.lo && m < t.hi) ? pt::to_f32(x[(xb + m) * g.cin + k])
                                       : 0.f;
      },
      [&](int k, int n) { return pt::to_f32(w1[size_t(k) * g.cm + n]); },
      [&](int m, int n, float v) {
        const bool in = m >= t.lo && m < t.hi;
        h0s[m * g.cm + n] =
            pt::from_f32<T>(in ? fmaxf(affine(v, a1[n], b1[n]), 0.f) : 0.f);
      },
      As, Bs);
}

// im2col view of h0: own pixel p, k = tap * Cm + c with tap = dy * 3 + dx.
template <typename T>
__device__ __forceinline__ float patch(const Geo& g, const short* rowt,
                                       const short* colt, const T* h0s, int p,
                                       int k) {
  const int tap = k >> g.lgcm, c = k & (g.cm - 1);
  const int dy = tap / 3, dx = tap - 3 * dy;
  const int cc = colt[p] + dx - 1;
  if (cc < 0 || cc >= g.w) return 0.f;
  return pt::to_f32(h0s[((rowt[p] + dy) * g.w + cc) * g.cm + c]);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, bool kProj>
__global__ void __launch_bounds__(kThreads)
bottleneck_fwd_kernel(Geo g, const T* __restrict__ x,
                      const T* __restrict__ w1, const T* __restrict__ w2,
                      const T* __restrict__ w3, const T* __restrict__ w4,
                      const float* __restrict__ aff, T* __restrict__ y) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const FwdLayout L = fwd_layout(g.th, g.w, g.cm, sizeof(T), kProj);
  float* As = reinterpret_cast<float*>(smem + L.as);
  float* Bs = reinterpret_cast<float*>(smem + L.bs);
  short* rowt = reinterpret_cast<short*>(smem + L.row);
  short* colt = reinterpret_cast<short*>(smem + L.col);
  T* h0s = reinterpret_cast<T*>(smem + L.h0);
  T* h1s = reinterpret_cast<T*>(smem + L.h1);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  const Tile t = tile_of(g);
  const float* a2 = aff + 2 * g.aw;
  const float* b2 = aff + 3 * g.aw;
  const float* a3 = aff + 4 * g.aw;
  const float* b3 = aff + 5 * g.aw;
  const float* a4 = aff + 6 * g.aw;
  const float* b4 = aff + 7 * g.aw;

  fill_tables(g, t, rowt, colt);
  halo_h0(g, t, x, w1, aff, h0s, As, Bs);
  gemm<false, false>(
      t.P, g.cm, 9 * g.cm,
      [&](int m, int k) { return patch(g, rowt, colt, h0s, m, k); },
      [&](int k, int n) { return pt::to_f32(w2[size_t(k) * g.cm + n]); },
      [&](int m, int n, float v) {
        h1s[m * g.cm + n] =
            pt::from_f32<T>(fmaxf(affine(v, a2[n], b2[n]), 0.f));
      },
      As, Bs);
  for (int j0 = 0; j0 < g.cout; j0 += kChunk) {
    const int nc = min(kChunk, g.cout - j0);
    if (kProj) {
      gemm<false, false>(
          t.P, nc, g.cin,
          [&](int m, int k) { return pt::to_f32(x[(t.own + m) * g.cin + k]); },
          [&](int k, int n) {
            return pt::to_f32(w4[size_t(k) * g.cout + j0 + n]);
          },
          [&](int m, int n, float v) {
            ss[m * kChunk + n] = affine(v, a4[j0 + n], b4[j0 + n]);
          },
          As, Bs);
    }
    gemm<false, false>(
        t.P, nc, g.cm,
        [&](int m, int k) { return pt::to_f32(h1s[m * g.cm + k]); },
        [&](int k, int n) {
          return pt::to_f32(w3[size_t(k) * g.cout + j0 + n]);
        },
        [&](int m, int n, float v) {
          const int col = j0 + n;
          const float s = kProj ? ss[m * kChunk + n]
                                : pt::to_f32(x[(t.own + m) * g.cin + col]);
          const float pre = affine(v, a3[col], b3[col]) + s;
          y[(t.own + m) * g.cout + col] = pt::from_f32<T>(fmaxf(pre, 0.f));
        },
        As, Bs);
  }
}

// ---------------------------------------------------------------------------
// backward, kernel B1: recompute, the Cout-wide chain, dc1, dW2, dW3
// ---------------------------------------------------------------------------

template <typename T, bool kProj>
__global__ void __launch_bounds__(kThreads)
bottleneck_bwd1_kernel(Geo g, const T* __restrict__ x,
                       const T* __restrict__ dy, const T* __restrict__ w1,
                       const T* __restrict__ w2, const T* __restrict__ w3,
                       const T* __restrict__ w4,
                       const float* __restrict__ aff, float* __restrict__ dw2,
                       float* __restrict__ dw3, float* __restrict__ daff,
                       T* __restrict__ dc1g, uint8_t* __restrict__ mask) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const B1Layout L = b1_layout(g.th, g.w, g.cm, sizeof(T), kProj);
  float* As = reinterpret_cast<float*>(smem + L.as);
  float* Bs = reinterpret_cast<float*>(smem + L.bs);
  short* rowt = reinterpret_cast<short*>(smem + L.row);
  short* colt = reinterpret_cast<short*>(smem + L.col);
  T* h0s = reinterpret_cast<T*>(smem + L.h0);
  T* h1s = reinterpret_cast<T*>(smem + L.h1);
  T* c1r = reinterpret_cast<T*>(smem + L.c1r);
  uint8_t* m1 = reinterpret_cast<uint8_t*>(smem + L.m1);
  float* dh1 = reinterpret_cast<float*>(smem + L.dh1);
  T* dc2s = reinterpret_cast<T*>(smem + L.dc2);
  float* c4s = reinterpret_cast<float*>(smem + L.c4);
  float* dA = reinterpret_cast<float*>(smem + L.daff);  // rows 2, 3: [2][Cm]
  float* dC = dA + 2 * g.cm;                            // rows 4-7: [4][64]
  const Tile t = tile_of(g);
  const int tid = threadIdx.x;
  const float* a2 = aff + 2 * g.aw;
  const float* b2 = aff + 3 * g.aw;
  const float* a3 = aff + 4 * g.aw;
  const float* b3 = aff + 5 * g.aw;
  const float* a4 = aff + 6 * g.aw;
  const float* b4 = aff + 7 * g.aw;
  const int pcm = t.P * g.cm;

  fill_tables(g, t, rowt, colt);
  for (int i = tid; i < pcm; i += kThreads) dh1[i] = 0.f;
  for (int i = tid; i < 2 * g.cm + 4 * kChunk; i += kThreads) dA[i] = 0.f;
  halo_h0(g, t, x, w1, aff, h0s, As, Bs);
  gemm<false, false>(
      t.P, g.cm, 9 * g.cm,
      [&](int m, int k) { return patch(g, rowt, colt, h0s, m, k); },
      [&](int k, int n) { return pt::to_f32(w2[size_t(k) * g.cm + n]); },
      [&](int m, int n, float v) {
        const float u1 = affine(v, a2[n], b2[n]);
        h1s[m * g.cm + n] = pt::from_f32<T>(fmaxf(u1, 0.f));
        c1r[m * g.cm + n] = pt::from_f32<T>(v);
        m1[m * g.cm + n] = u1 > 0.f;
      },
      As, Bs);

  for (int j0 = 0; j0 < g.cout; j0 += kChunk) {
    const int nc = min(kChunk, g.cout - j0);
    if (kProj) {
      gemm<false, false>(
          t.P, nc, g.cin,
          [&](int m, int k) { return pt::to_f32(x[(t.own + m) * g.cin + k]); },
          [&](int k, int n) {
            return pt::to_f32(w4[size_t(k) * g.cout + j0 + n]);
          },
          [&](int m, int n, float v) { c4s[m * kChunk + n] = v; }, As, Bs);
    }
    gemm<false, false>(
        t.P, nc, g.cm,
        [&](int m, int k) { return pt::to_f32(h1s[m * g.cm + k]); },
        [&](int k, int n) {
          return pt::to_f32(w3[size_t(k) * g.cout + j0 + n]);
        },
        [&](int m, int n, float v) {
          const int col = j0 + n;
          const long long at = (t.own + m) * g.cout + col;
          float s;
          if (kProj) {
            s = affine(c4s[m * kChunk + n], a4[col], b4[col]);
          } else {
            s = pt::to_f32(x[(t.own + m) * g.cin + col]);
          }
          const bool keep = affine(v, a3[col], b3[col]) + s > 0.f;
          mask[at] = keep;
          const float dz3 = keep ? pt::to_f32(dy[at]) : 0.f;
          atomicAdd(dC + n, dz3 * pt::to_f32(pt::from_f32<T>(v)));
          atomicAdd(dC + kChunk + n, dz3);
          if (kProj) {
            atomicAdd(dC + 2 * kChunk + n,
                      dz3 * pt::to_f32(pt::from_f32<T>(c4s[m * kChunk + n])));
            atomicAdd(dC + 3 * kChunk + n, dz3);
          }
          dc2s[m * kChunk + n] = pt::from_f32<T>(dz3 * a3[col]);
        },
        As, Bs);
    __syncthreads();
    for (int n = tid; n < nc; n += kThreads) {
      atomicAdd(daff + 4 * g.aw + j0 + n, dC[n]);
      atomicAdd(daff + 5 * g.aw + j0 + n, dC[kChunk + n]);
      if (kProj) {
        atomicAdd(daff + 6 * g.aw + j0 + n, dC[2 * kChunk + n]);
        atomicAdd(daff + 7 * g.aw + j0 + n, dC[3 * kChunk + n]);
      }
      dC[n] = dC[kChunk + n] = dC[2 * kChunk + n] = dC[3 * kChunk + n] = 0.f;
    }
    // dW3[:, chunk] += h1^T dc2
    gemm<true, false>(
        g.cm, nc, t.P,
        [&](int m, int k) { return pt::to_f32(h1s[k * g.cm + m]); },
        [&](int k, int n) { return pt::to_f32(dc2s[k * kChunk + n]); },
        [&](int m, int n, float v) {
          atomicAdd(dw3 + size_t(m) * g.cout + j0 + n, v);
        },
        As, Bs);
    // dh1 += dc2 w3[:, chunk]^T
    gemm<false, true>(
        t.P, g.cm, nc,
        [&](int m, int k) { return pt::to_f32(dc2s[m * kChunk + k]); },
        [&](int k, int n) {
          return pt::to_f32(w3[size_t(n) * g.cout + j0 + k]);
        },
        [&](int m, int n, float v) { dh1[m * g.cm + n] += v; }, As, Bs);
  }

  __syncthreads();
  for (int i = tid; i < pcm; i += kThreads) {
    const int c = i & (g.cm - 1);
    const float du1 = m1[i] ? dh1[i] : 0.f;
    atomicAdd(dA + c, du1 * pt::to_f32(c1r[i]));
    atomicAdd(dA + g.cm + c, du1);
    const T dc1 = pt::from_f32<T>(du1 * a2[c]);
    c1r[i] = dc1;  // the c1r tile now holds dc1
    dc1g[t.own * g.cm + i] = dc1;
  }
  __syncthreads();
  for (int c = tid; c < g.cm; c += kThreads) {
    atomicAdd(daff + 2 * g.aw + c, dA[c]);
    atomicAdd(daff + 3 * g.aw + c, dA[g.cm + c]);
  }
  // dW2 += patches(h0)^T dc1: rows tap * Cm + c
  gemm<true, false>(
      9 * g.cm, g.cm, t.P,
      [&](int m, int k) { return patch(g, rowt, colt, h0s, k, m); },
      [&](int k, int n) { return pt::to_f32(c1r[k * g.cm + n]); },
      [&](int m, int n, float v) { atomicAdd(dw2 + size_t(m) * g.cm + n, v); },
      As, Bs);
}

// ---------------------------------------------------------------------------
// backward, kernel B2: dh0 (transposed 3x3 conv of dc1), dc0, dW1, dW4, dx
// ---------------------------------------------------------------------------

template <typename T, bool kProj>
__global__ void __launch_bounds__(kThreads)
bottleneck_bwd2_kernel(Geo g, const T* __restrict__ x,
                       const T* __restrict__ dy, const T* __restrict__ w1,
                       const T* __restrict__ w2, const T* __restrict__ w4,
                       const float* __restrict__ aff,
                       const T* __restrict__ dc1g,
                       const uint8_t* __restrict__ mask, T* __restrict__ dx,
                       float* __restrict__ dw1, float* __restrict__ dw4,
                       float* __restrict__ daff) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const B2Layout L = b2_layout(g.th, g.w, g.cm, sizeof(T));
  float* As = reinterpret_cast<float*>(smem + L.as);
  float* Bs = reinterpret_cast<float*>(smem + L.bs);
  short* rowt = reinterpret_cast<short*>(smem + L.row);
  short* colt = reinterpret_cast<short*>(smem + L.col);
  float* c0f = reinterpret_cast<float*>(smem + L.c0);
  T* dc0s = reinterpret_cast<T*>(smem + L.dc0);
  float* dA = reinterpret_cast<float*>(smem + L.daff);  // rows 0, 1: [2][Cm]
  const Tile t = tile_of(g);
  const int tid = threadIdx.x;
  const float* a1 = aff;
  const float* b1 = aff + g.aw;
  const float* a4 = aff + 6 * g.aw;

  fill_tables(g, t, rowt, colt);
  for (int i = tid; i < 2 * g.cm; i += kThreads) dA[i] = 0.f;
  gemm<false, false>(
      t.P, g.cm, g.cin,
      [&](int m, int k) { return pt::to_f32(x[(t.own + m) * g.cin + k]); },
      [&](int k, int n) { return pt::to_f32(w1[size_t(k) * g.cm + n]); },
      [&](int m, int n, float v) { c0f[m * g.cm + n] = v; }, As, Bs);
  // dh0[q, c] = sum_{dy, dx, o} dc1[qy + 1 - dy, qx + 1 - dx, o] w2[dy, dx, c, o]
  gemm<false, true>(
      t.P, g.cm, 9 * g.cm,
      [&](int m, int k) {
        const int tap = k >> g.lgcm, o = k & (g.cm - 1);
        const int ky = tap / 3, kx = tap - 3 * ky;
        const int ry = t.r0 + rowt[m] + 1 - ky, cx = colt[m] + 1 - kx;
        if (ry < 0 || ry >= g.h || cx < 0 || cx >= g.w) return 0.f;
        return pt::to_f32(
            dc1g[((static_cast<long long>(t.img) * g.h + ry) * g.w + cx) *
                     g.cm + o]);
      },
      [&](int k, int n) {
        const int tap = k >> g.lgcm, o = k & (g.cm - 1);
        return pt::to_f32(w2[(size_t(tap) * g.cm + n) * g.cm + o]);
      },
      [&](int m, int n, float v) {
        const float c0 = c0f[m * g.cm + n];
        const float du0 = affine(c0, a1[n], b1[n]) > 0.f ? v : 0.f;
        atomicAdd(dA + n, du0 * pt::to_f32(pt::from_f32<T>(c0)));
        atomicAdd(dA + g.cm + n, du0);
        dc0s[m * g.cm + n] = pt::from_f32<T>(du0 * a1[n]);
      },
      As, Bs);
  __syncthreads();
  for (int c = tid; c < g.cm; c += kThreads) {
    atomicAdd(daff + c, dA[c]);
    atomicAdd(daff + g.aw + c, dA[g.cm + c]);
  }
  // dz3 from the forward's relu mask and dy; dc4 = round(dz3 * a4)
  auto dz3 = [&](int m, int col) {
    const long long at = (t.own + m) * g.cout + col;
    return mask[at] ? pt::to_f32(dy[at]) : 0.f;
  };
  auto dc4 = [&](int m, int col) {
    return pt::to_f32(pt::from_f32<T>(dz3(m, col) * a4[col]));
  };
  // dW1 += x^T dc0
  gemm<true, false>(
      g.cin, g.cm, t.P,
      [&](int m, int k) { return pt::to_f32(x[(t.own + k) * g.cin + m]); },
      [&](int k, int n) { return pt::to_f32(dc0s[k * g.cm + n]); },
      [&](int m, int n, float v) { atomicAdd(dw1 + size_t(m) * g.cm + n, v); },
      As, Bs);
  if (kProj) {
    // dW4 += x^T dc4
    gemm<true, false>(
        g.cin, g.cout, t.P,
        [&](int m, int k) { return pt::to_f32(x[(t.own + k) * g.cin + m]); },
        [&](int k, int n) { return dc4(k, n); },
        [&](int m, int n, float v) {
          atomicAdd(dw4 + size_t(m) * g.cout + n, v);
        },
        As, Bs);
  }
  // dx = dc0 w1^T (+ dc4 w4^T | + dz3), one f32 sum, rounded once
  const int kdx = g.cm + (kProj ? g.cout : 0);
  gemm<false, true>(
      t.P, g.cin, kdx,
      [&](int m, int k) {
        return k < g.cm ? pt::to_f32(dc0s[m * g.cm + k]) : dc4(m, k - g.cm);
      },
      [&](int k, int n) {
        return k < g.cm ? pt::to_f32(w1[size_t(n) * g.cm + k])
                        : pt::to_f32(w4[size_t(n) * g.cout + (k - g.cm)]);
      },
      [&](int m, int n, float v) {
        const float res = kProj ? 0.f : dz3(m, n);
        dx[(t.own + m) * g.cin + n] = pt::from_f32<T>(v + res);
      },
      As, Bs);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

int max_smem() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

// The TH <= 8 whose shared memory fits and whose tiles compute the fewest
// rows (own rows plus `halo` recomputed rows per tile); ties go to the
// larger TH.  0 when none fits.
template <class Bytes>
int pick_th(int h, int halo, const Bytes& bytes) {
  const size_t limit = static_cast<size_t>(max_smem());
  int best = 0;
  long long best_cost = 0;
  for (int th = 1; th <= (h < kMaxTH ? h : kMaxTH); ++th) {
    if (bytes(th) > limit) continue;
    const long long cost = static_cast<long long>((h + th - 1) / th) *
                           (th + halo);
    if (best == 0 || cost <= best_cost) {
      best = th;
      best_cost = cost;
    }
  }
  return best;
}

Geo make_geo(int n, int h, int w, int cin, int cm, int cout, int aw, int th) {
  int lg = 0;
  while ((1 << lg) < cm) ++lg;
  return Geo{n, h, w, cin, cm, lg, cout, aw, th, (h + th - 1) / th};
}

bool geo_ok(int n, int h, int w, int cin, int cm, int cout, int aw,
            bool proj) {
  if (n < 1 || h < 1 || w < 1 || cin < 1 || cm < 1 || cout < 1) return false;
  if (cm & (cm - 1)) return false;                 // Cm a power of two
  if (!proj && cin != cout) return false;          // identity shortcut
  if (aw < cm || aw < cout) return false;
  if (w * kMaxTH > 32767) return false;            // short pixel tables
  return true;
}

template <typename T, bool kProj>
cudaError_t launch_fwd(const void* x, const void* w1, const void* w2,
                       const void* w3, const void* w4, const void* aff,
                       void* y, int n, int h, int w, int cin, int cm,
                       int cout, int aw, cudaStream_t st) {
  const int th = pick_th(h, 2, [&](int t) {
    return fwd_layout(t, w, cm, sizeof(T), kProj).total;
  });
  if (th == 0) return cudaErrorInvalidValue;
  const Geo g = make_geo(n, h, w, cin, cm, cout, aw, th);
  const size_t smem = fwd_layout(th, w, cm, sizeof(T), kProj).total;
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_fwd_kernel<T, kProj>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bottleneck_fwd_kernel<T, kProj><<<n * g.tiles_per_img, kThreads, smem, st>>>(
      g, static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(w2), static_cast<const T*>(w3),
      static_cast<const T*>(w4), static_cast<const float*>(aff),
      static_cast<T*>(y));
  return cudaGetLastError();
}

template <typename T, bool kProj>
cudaError_t launch_bwd(const void* x, const void* dy, const void* w1,
                       const void* w2, const void* w3, const void* w4,
                       const void* aff, void* dx, void* dw1, void* dw2,
                       void* dw3, void* dw4, void* daff, void* dc1,
                       void* mask, int n, int h, int w, int cin, int cm,
                       int cout, int aw, cudaStream_t st) {
  const int th1 = pick_th(h, 2, [&](int t) {
    return b1_layout(t, w, cm, sizeof(T), kProj).total;
  });
  const int th2 = pick_th(h, 0, [&](int t) {
    return b2_layout(t, w, cm, sizeof(T)).total;
  });
  if (th1 == 0 || th2 == 0) return cudaErrorInvalidValue;
  const Geo g1 = make_geo(n, h, w, cin, cm, cout, aw, th1);
  const Geo g2 = make_geo(n, h, w, cin, cm, cout, aw, th2);
  const size_t s1 = b1_layout(th1, w, cm, sizeof(T), kProj).total;
  const size_t s2 = b2_layout(th2, w, cm, sizeof(T)).total;
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_bwd1_kernel<T, kProj>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(s1));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bottleneck_bwd2_kernel<T, kProj>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s2));
  if (err != cudaSuccess) return err;
  bottleneck_bwd1_kernel<T, kProj><<<n * g1.tiles_per_img, kThreads, s1, st>>>(
      g1, static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const T*>(w3), static_cast<const T*>(w4),
      static_cast<const float*>(aff), static_cast<float*>(dw2),
      static_cast<float*>(dw3), static_cast<float*>(daff),
      static_cast<T*>(dc1), static_cast<uint8_t*>(mask));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bottleneck_bwd2_kernel<T, kProj><<<n * g2.tiles_per_img, kThreads, s2, st>>>(
      g2, static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const T*>(w4), static_cast<const float*>(aff),
      static_cast<const T*>(dc1), static_cast<const uint8_t*>(mask),
      static_cast<T*>(dx), static_cast<float*>(dw1), static_cast<float*>(dw4),
      static_cast<float*>(daff));
  return cudaGetLastError();
}

}  // namespace

// x: [n, h, w, cin], w1: [cin, cm], w2: [3, 3, cm, cm] (HWIO), w3: [cm,
// cout], w4: [cin, cout] (read only when proj), y: [n, h, w, cout], all
// contiguous in `dtype`; aff: [8, aw] float32 rows a1, b1, a2, b2, a3, b3,
// a4, b4.  Identity (proj == 0) needs cin == cout; cm must be a power of
// two.  Returns cudaGetLastError() after the launch.
extern "C" int pt_fused_bottleneck_fwd(const void* x, const void* w1,
                                       const void* w2, const void* w3,
                                       const void* w4, const void* aff,
                                       void* y, int n, int h, int w, int cin,
                                       int cm, int cout, int aw, int dtype,
                                       int proj, void* stream) {
  if (!geo_ok(n, h, w, cin, cm, cout, aw, proj != 0))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kFloat32)
    return int(proj ? launch_fwd<float, true>(x, w1, w2, w3, w4, aff, y, n, h,
                                              w, cin, cm, cout, aw, st)
                    : launch_fwd<float, false>(x, w1, w2, w3, w4, aff, y, n,
                                               h, w, cin, cm, cout, aw, st));
  if (dtype == pt::kBFloat16)
    return int(proj ? launch_fwd<__nv_bfloat16, true>(
                          x, w1, w2, w3, w4, aff, y, n, h, w, cin, cm, cout,
                          aw, st)
                    : launch_fwd<__nv_bfloat16, false>(
                          x, w1, w2, w3, w4, aff, y, n, h, w, cin, cm, cout,
                          aw, st));
  return int(cudaErrorInvalidValue);
}

// As pt_fused_bottleneck_fwd, plus dy: [n, h, w, cout] in `dtype`.  Writes
// dx ([n, h, w, cin], `dtype`) and ADDS into dw1..dw4 (float32, shaped as
// the weights) and daff ([8, aw] float32), which the caller zeroes.
// Scratch: dc1 [n*h*w, cm] in `dtype` and mask [n*h*w, cout] bytes.
// Launches kernel B1 then B2 on `stream`; returns cudaGetLastError().
extern "C" int pt_fused_bottleneck_bwd(
    const void* x, const void* dy, const void* w1, const void* w2,
    const void* w3, const void* w4, const void* aff, void* dx, void* dw1,
    void* dw2, void* dw3, void* dw4, void* daff, void* dc1, void* mask, int n,
    int h, int w, int cin, int cm, int cout, int aw, int dtype, int proj,
    void* stream) {
  if (!geo_ok(n, h, w, cin, cm, cout, aw, proj != 0))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_BWD(T, P)                                                        \
  launch_bwd<T, P>(x, dy, w1, w2, w3, w4, aff, dx, dw1, dw2, dw3, dw4, daff, \
                   dc1, mask, n, h, w, cin, cm, cout, aw, st)
  if (dtype == pt::kFloat32)
    return int(proj ? PT_BWD(float, true) : PT_BWD(float, false));
  if (dtype == pt::kBFloat16)
    return int(proj ? PT_BWD(__nv_bfloat16, true)
                    : PT_BWD(__nv_bfloat16, false));
#undef PT_BWD
  return int(cudaErrorInvalidValue);
}
