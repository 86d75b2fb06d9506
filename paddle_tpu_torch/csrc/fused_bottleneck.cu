// P1 and P2: the two stripped kernels of the fused-block probe tool, for
// Hopper (sm_90a), on the CUDA-core `gemm` below.
//
// They replace the two Pallas probes of tools/fused_probe.py
// (`p4_conv_only`, pallas_call :88; `p5_matmuls`, pallas_call :114), which
// cut the stride-1 fused bottleneck block's forward in two, so that its
// time splits between the 3x3 product and the 1x1 chain:
//   P1  y = round(conv3x3(zero_pad(x), w2))     x, y [N, H, W, Cm]
//       a block stages TH rows of x and their one-row halo (zero outside
//       the image) in shared memory and runs the im2col `gemm` against w2
//       viewed as [9 Cm, Cm]; TH by the rule of `pick_th` with a halo;
//   P2  h0 = round(relu(x @ w1)); y = round(h0 @ w3 + x)
//       x, y [N, H, W, Cin], w1 [Cin, Cm], w3 [Cm, Cin]; a block takes TH
//       rows (no halo), writes h0 to shared memory in the first `gemm`'s
//       epilogue and adds x from device memory in the second's.
// No affines and no relu in P1, none but the one relu in P2, as in the
// Pallas probes.  "round" is the cast to the dtype T (bf16 or f32).
//
// The products.  Every product is one routine, `gemm`: a 256-thread block
// computes a [M, N] result in 64 x 64 output tiles, each thread a 4 x 4
// patch of f32 accumulators on the CUDA cores (fmaf), over K in 32-deep
// chunks staged in shared memory as f32 by loader functions that gather
// the operand from wherever it lives (device memory, the staged x tile,
// an im2col view of it, the weights).  An epilogue function gets each
// finished element.  This is the routine K7 ran before it moved to the
// tensor cores (csrc/fused_block.cu on csrc/mma.cuh); the probes time it
// no more against K7's own products until they move onto K7's tiles.
//
// Bound at ResNet-50's stage 1, batch 128 bf16: P1 moves 102.8 MB (0.0307
// ms at 3.35 TB/s) for 29.6 GFLOP; P2 411.0 MB (0.1227 ms) for 26.3
// GFLOP: both byte-bound, and both run far above that on the CUDA cores.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 64;             // output tile rows of `gemm`
constexpr int kTN = 64;             // output tile columns
constexpr int kTK = 32;             // K chunk staged in shared memory
constexpr int kAStride = kTM + 1;   // As [kTK][kTM+1]: conflict-free fills
constexpr int kBStride = kTN + 4;   // Bs [kTK][kTN+4]: float4-aligned rows
constexpr int kMaxTH = 8;

struct Geo {
  int n, h, w, cin, cm, lgcm, cout, aw, th, tiles_per_img;
};

// A tile: rows [r0, r0 + rows) of image img, P = rows * w pixels; `own` is
// the index of its first pixel in the [N*H*W] pixel order.  Its halo is
// rows r0 - 1 .. r0 + rows: halo pixel hp (0 <= hp < P2) lies in the image
// iff lo <= hp < hi, and `xb` is the pixel index of halo pixel 0.
struct Tile {
  int img, r0, rows, wo, P, P2, lo, hi;
  long long own, xb;
};

__device__ __forceinline__ Tile tile_of(const Geo& g) {
  Tile t;
  t.wo = g.w;
  t.img = blockIdx.x / g.tiles_per_img;
  t.r0 = (blockIdx.x % g.tiles_per_img) * g.th;
  t.rows = min(g.th, g.h - t.r0);
  t.P = t.rows * t.wo;
  t.P2 = (t.rows + 2) * g.w;
  t.lo = t.r0 == 0 ? g.w : 0;
  t.hi = t.r0 + t.rows >= g.h ? (t.rows + 1) * g.w : t.P2;
  t.own = (static_cast<long long>(t.img) * g.h + t.r0) * t.wo;
  t.xb = (static_cast<long long>(t.img) * g.h + t.r0 - 1) * g.w;
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

// P1 stages the tile's x over its halo rows; P2 keeps h0 of its own rows.
struct ProbeLayout {
  size_t as, bs, row, col, t, total;
};

__host__ __device__ inline ProbeLayout probe_layout(int th, int w, int cm,
                                                    int tsz, bool conv) {
  Carve c;
  ProbeLayout l;
  const size_t own = size_t(th) * w, halo = size_t(th + 2) * w;
  l.as = c.take(sizeof(float) * kTK * kAStride);
  l.bs = c.take(sizeof(float) * kTK * kBStride);
  l.row = c.take(conv ? sizeof(short) * own : 0);
  l.col = c.take(conv ? sizeof(short) * own : 0);
  l.t = c.take(tsz * (conv ? halo : own) * cm);
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

// Row and column of each own pixel, so the loaders divide by no runtime
// width.
__device__ __forceinline__ void fill_tables(const Tile& t, short* rowt,
                                            short* colt) {
  for (int p = threadIdx.x; p < t.P; p += kThreads) {
    rowt[p] = static_cast<short>(p / t.wo);
    colt[p] = static_cast<short>(p % t.wo);
  }
}

// im2col view of the staged tile: own pixel p, k = tap * Cm + c with tap =
// dy * 3 + dx; row r of the tile reads halo row r + dy, column col + dx - 1.
template <typename T>
__device__ __forceinline__ float patch(const Geo& g, const short* rowt,
                                       const short* colt, const T* xs, int p,
                                       int k) {
  const int tap = k >> g.lgcm, c = k & (g.cm - 1);
  const int dy = tap / 3, dx = tap - 3 * dy;
  const int cc = colt[p] + dx - 1;
  if (cc < 0 || cc >= g.w) return 0.f;
  return pt::to_f32(xs[((rowt[p] + dy) * g.w + cc) * g.cm + c]);
}

// ---------------------------------------------------------------------------
// the probes: K7's 3x3 product alone (P1) and its 1x1 chain alone (P2)
// ---------------------------------------------------------------------------

// P1: y = round(conv3x3(zero_pad(x), w2)), g.cin == g.cm == g.cout.
template <typename T>
__global__ void __launch_bounds__(kThreads)
probe_conv3x3_kernel(Geo g, const T* __restrict__ x, const T* __restrict__ w2,
                     T* __restrict__ y) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const ProbeLayout L = probe_layout(g.th, g.w, g.cm, sizeof(T), true);
  float* As = reinterpret_cast<float*>(smem + L.as);
  float* Bs = reinterpret_cast<float*>(smem + L.bs);
  short* rowt = reinterpret_cast<short*>(smem + L.row);
  short* colt = reinterpret_cast<short*>(smem + L.col);
  T* xs = reinterpret_cast<T*>(smem + L.t);
  const Tile t = tile_of(g);

  fill_tables(t, rowt, colt);
  // x over the halo rows, zero outside the image (the conv's padding);
  // gemm's leading barrier orders these stores before the patch loads
  for (int i = threadIdx.x; i < t.P2 * g.cm; i += kThreads) {
    const int m = i >> g.lgcm;
    xs[i] = (m >= t.lo && m < t.hi) ? x[t.xb * g.cm + i] : pt::from_f32<T>(0.f);
  }
  gemm<false, false>(
      t.P, g.cm, 9 * g.cm,
      [&](int m, int k) { return patch(g, rowt, colt, xs, m, k); },
      [&](int k, int n) { return pt::to_f32(w2[size_t(k) * g.cm + n]); },
      [&](int m, int n, float v) {
        y[(t.own + m) * g.cm + n] = pt::from_f32<T>(v);
      },
      As, Bs);
}

// P2: h0 = round(relu(x @ w1)); y = round(h0 @ w3 + x), g.cout == g.cin.
template <typename T>
__global__ void __launch_bounds__(kThreads)
probe_matmuls_kernel(Geo g, const T* __restrict__ x, const T* __restrict__ w1,
                     const T* __restrict__ w3, T* __restrict__ y) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const ProbeLayout L = probe_layout(g.th, g.w, g.cm, sizeof(T), false);
  float* As = reinterpret_cast<float*>(smem + L.as);
  float* Bs = reinterpret_cast<float*>(smem + L.bs);
  T* h0s = reinterpret_cast<T*>(smem + L.t);
  const Tile t = tile_of(g);

  gemm<false, false>(
      t.P, g.cm, g.cin,
      [&](int m, int k) { return pt::to_f32(x[(t.own + m) * g.cin + k]); },
      [&](int k, int n) { return pt::to_f32(w1[size_t(k) * g.cm + n]); },
      [&](int m, int n, float v) {
        h0s[m * g.cm + n] = pt::from_f32<T>(fmaxf(v, 0.f));
      },
      As, Bs);
  gemm<false, false>(
      t.P, g.cout, g.cm,
      [&](int m, int k) { return pt::to_f32(h0s[m * g.cm + k]); },
      [&](int k, int n) { return pt::to_f32(w3[size_t(k) * g.cout + n]); },
      [&](int m, int n, float v) {
        const long long at = (t.own + m) * g.cout + n;
        y[at] = pt::from_f32<T>(v + pt::to_f32(x[at]));
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

// Over `rows` image rows, the TH <= 8 whose shared memory fits and whose
// tiles compute the fewest rows, ceil(rows / TH) (TH + halo) (P1: TH + 2
// staged rows); ties go to the larger TH.  Without a halo (P2) the
// fewest tiles come first.  0 when none fits.
template <class Bytes>
int pick_th(int rows, int halo, const Bytes& bytes) {
  const size_t limit = static_cast<size_t>(max_smem());
  int best = 0;
  long long best_cost = 0;
  for (int th = 1; th <= (rows < kMaxTH ? rows : kMaxTH); ++th) {
    if (bytes(th) > limit) continue;
    const long long tiles = (rows + th - 1) / th;
    const long long cost = tiles * (th + halo) +
                           (halo == 0 ? tiles * kMaxTH * rows : 0);
    if (best == 0 || cost <= best_cost) {
      best = th;
      best_cost = cost;
    }
  }
  return best;
}

Geo make_geo(int n, int h, int w, int cin, int cm, int cout, int aw,
             int th) {
  int lg = 0;
  while ((1 << lg) < cm) ++lg;
  return Geo{n, h, w, cin, cm, lg, cout, aw, th, (h + th - 1) / th};
}

bool geo_ok(int n, int h, int w, int cin, int cm) {
  if (n < 1 || h < 1 || w < 1 || cin < 1 || cm < 1) return false;
  if (cm & (cm - 1)) return false;                 // Cm a power of two
  if (w * kMaxTH > 32767) return false;            // short pixel tables
  return true;
}

template <class Kernel>
cudaError_t set_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The probes' tile heights: P1 by the halo rule (halo 2), P2 by the
// no-halo rule (fewest tiles).
struct ProbeThs {
  int conv, mm;
};

template <typename T>
ProbeThs pick_probe_ths(int h, int w, int cm) {
  ProbeThs r;
  r.conv = pick_th(h, 2, [&](int t) {
    return probe_layout(t, w, cm, sizeof(T), true).total;
  });
  r.mm = pick_th(h, 0, [&](int t) {
    return probe_layout(t, w, cm, sizeof(T), false).total;
  });
  return r;
}

template <typename T>
cudaError_t launch_probe_conv(const void* x, const void* w2, void* y, int n,
                              int h, int w, int cm, cudaStream_t st) {
  const int th = pick_probe_ths<T>(h, w, cm).conv;
  if (th == 0) return cudaErrorInvalidValue;
  const Geo g = make_geo(n, h, w, cm, cm, cm, cm, th);
  const size_t smem = probe_layout(th, w, cm, sizeof(T), true).total;
  cudaError_t err = set_smem(probe_conv3x3_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  probe_conv3x3_kernel<T><<<n * g.tiles_per_img, kThreads, smem, st>>>(
      g, static_cast<const T*>(x), static_cast<const T*>(w2),
      static_cast<T*>(y));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_probe_mm(const void* x, const void* w1, const void* w3,
                            void* y, int n, int h, int w, int cin, int cm,
                            cudaStream_t st) {
  const int th = pick_probe_ths<T>(h, w, cm).mm;
  if (th == 0) return cudaErrorInvalidValue;
  const Geo g = make_geo(n, h, w, cin, cm, cin, cin, th);
  const size_t smem = probe_layout(th, w, cm, sizeof(T), false).total;
  cudaError_t err = set_smem(probe_matmuls_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  probe_matmuls_kernel<T><<<n * g.tiles_per_img, kThreads, smem, st>>>(
      g, static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(w3), static_cast<T*>(y));
  return cudaGetLastError();
}

template <class Kernel>
int blocks_per_sm(Kernel k, size_t smem) {
  int b = 0;
  if (set_smem(k, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, k, kThreads, smem) !=
          cudaSuccess)
    return 0;
  return b;
}

template <typename T>
int probe_tiles(int h, int w, int cm, int* out) {
  const ProbeThs r = pick_probe_ths<T>(h, w, cm);
  out[0] = r.conv;
  out[1] = r.mm;
  out[2] = r.conv ? blocks_per_sm(probe_conv3x3_kernel<T>,
                                  probe_layout(r.conv, w, cm, sizeof(T), true)
                                      .total)
                  : 0;
  out[3] = r.mm ? blocks_per_sm(probe_matmuls_kernel<T>,
                                probe_layout(r.mm, w, cm, sizeof(T), false)
                                    .total)
                : 0;
  return int(cudaGetLastError());
}

}  // namespace

// P1.  x, y: [n, h, w, cm]; w2: [3, 3, cm, cm] (HWIO); all contiguous in
// `dtype`; cm a power of two.  Returns cudaGetLastError() after the launch.
extern "C" int pt_probe_conv3x3(const void* x, const void* w2, void* y, int n,
                                int h, int w, int cm, int dtype,
                                void* stream) {
  if (!geo_ok(n, h, w, cm, cm))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kFloat32)
    return int(launch_probe_conv<float>(x, w2, y, n, h, w, cm, st));
  if (dtype == pt::kBFloat16)
    return int(launch_probe_conv<__nv_bfloat16>(x, w2, y, n, h, w, cm, st));
  return int(cudaErrorInvalidValue);
}

// P2.  x, y: [n, h, w, cin]; w1: [cin, cm]; w3: [cm, cin]; all contiguous
// in `dtype`; cm a power of two.  Returns cudaGetLastError().
extern "C" int pt_probe_matmuls(const void* x, const void* w1, const void* w3,
                                void* y, int n, int h, int w, int cin, int cm,
                                int dtype, void* stream) {
  if (!geo_ok(n, h, w, cin, cm))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kFloat32)
    return int(launch_probe_mm<float>(x, w1, w3, y, n, h, w, cin, cm, st));
  if (dtype == pt::kBFloat16)
    return int(
        launch_probe_mm<__nv_bfloat16>(x, w1, w3, y, n, h, w, cin, cm, st));
  return int(cudaErrorInvalidValue);
}

// The probes' tile heights on the current device, out[0] P1 and out[1]
// P2, and the blocks that fit on one SM (shared memory, registers,
// threads) for P1 and P2 at those tiles: out[2..3].
extern "C" int pt_probe_tiles(int h, int w, int cm, int dtype, int* out) {
  if (dtype == pt::kFloat32) return probe_tiles<float>(h, w, cm, out);
  if (dtype == pt::kBFloat16) return probe_tiles<__nv_bfloat16>(h, w, cm, out);
  return int(cudaErrorInvalidValue);
}
