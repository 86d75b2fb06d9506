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
//
// The forward, the backward's B1, the weight-gradient GEMM W, its slice
// sum R, the plan and the launchers are the stride-2 instances of the
// pieces K7 shares (csrc/block_tc.cuh: `block_fwd_kernel<T, 2, true>`,
// `block_bwd1_kernel<T, 2, true>`, `wgrad_kernel<T, 2>`, `wsum_kernel`),
// every product `pt::tc::product` (csrc/mma.cuh).  A forward tile of th
// output rows recomputes h0 on its input rows 2 r0 - 1 .. 2 (r0 + th) - 1
// (zero above the image); the stride-2 3x3 conv reads that resident tile
// through ldmatrix lanes that point at h0 row (2 r + dy, 2 c + dx - 1).
// This file holds K8's own B2:
//   B2 (`down_bwd2_kernel`, th output rows, owning input rows 2 r0 .. 2 (r0
//      + th) - 1): recompute c0 on its rows; dh0 is the stride-2 conv
//      transposed, one GEMM per input phase (py, px) over the tile's output
//      cells (input pixel (2 i + py, 2 j + px) takes tap ky = 1 for py = 0,
//      ky in {0, 2} from output rows i + 1 and i for py = 1; the same for
//      the columns: nine taps over the four phases), dc1 gathered from its
//      scratch; du0, the a1/b1 grads, dc0 to its scratch [R_in, Cm]; then
//      dx per phase = dc0 w1^T, plus dc4 w4^T at phase (0, 0), one f32
//      sum rounded once.
// At ResNet-50's three transitions, batch 128 bf16 on 132 SMs, the weight
// gradients store 4.65 M / 5.44 M / 7.08 M f32 partials per backward (K
// slices (37, 10, 10, 10) / (10, 3, 3, 3) / (3, 1, 1, 1) of dW1..dW4 times
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

#include "block_tc.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// backward, B2: dh0 (the stride-2 3x3 conv transposed, by input phase),
// dc0, dx
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
down_bwd2_kernel(Geo g, const T* __restrict__ x, const T* __restrict__ w1,
                 const T* __restrict__ w2, const T* __restrict__ w4,
                 const float* __restrict__ aff, const T* __restrict__ dc1g,
                 const T* __restrict__ dc4g, float* __restrict__ daff,
                 T* __restrict__ dc0g, T* __restrict__ dx) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const B2Layout L = b2_layout<T, 2>(g.th, g.w, g.cm);
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  short* rowt = reinterpret_cast<short*>(smem + L.row);
  short* colt = reinterpret_cast<short*>(smem + L.col);
  T* c0r = reinterpret_cast<T*>(smem + L.c0r);
  uint8_t* m0 = reinterpret_cast<uint8_t*>(smem + L.m0);
  float* dA = reinterpret_cast<float*>(smem + L.daff);  // rows 0, 1: [2][Cm]
  const Tile t = tile_of<2>(g);
  const int tid = threadIdx.x;
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
      t.pin, g.cm, g.cin, g.vec,
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

// K8's envelope: the shared one, with even sides of at least 2.
bool down_ok(int n, int h, int w, int cin, int cm, int cout, int aw) {
  return geo_ok(n, h, w, cin, cm, cout, aw) && h >= 2 && w >= 2 &&
         h % 2 == 0 && w % 2 == 0;
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
  if (!down_ok(n, h, w, cin, cm, cout, aw)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kFloat32)
    return int(launch_fwd<float, 2, true>(x, w1, w2, w3, w4, aff, y, n, h, w,
                                          cin, cm, cout, aw, st));
  if (dtype == pt::kBFloat16)
    return int(launch_fwd<__nv_bfloat16, 2, true>(x, w1, w2, w3, w4, aff, y,
                                                  n, h, w, cin, cm, cout, aw,
                                                  st));
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
  if (!down_ok(n, h, w, cin, cm, cout, aw)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_BWD(T)                                                            \
  launch_bwd<T, 2, true>(down_bwd2_kernel<T>, x, dy, w1, w2, w3, w4, aff, dx, \
                         dw1, dw2, dw3, dw4, daff, h0, h1, dc0, dc1, dc2,    \
                         dc4, ws, n, h, w, cin, cm, cout, aw, st)
  if (dtype == pt::kFloat32) return int(PT_BWD(float));
  if (dtype == pt::kBFloat16) return int(PT_BWD(__nv_bfloat16));
#undef PT_BWD
  return int(cudaErrorInvalidValue);
}

// The plan of one geometry on the current device (`plan_out`,
// csrc/block_tc.cuh: tile heights, blocks, shared memory, K slices,
// partials, weight-gradient items, blocks per SM; 18 values).  Returns 0,
// or cudaErrorInvalidValue outside the envelope.
extern "C" int pt_fused_down_plan(int n, int h, int w, int cin, int cm,
                                  int cout, int dtype, long long* out) {
  if (!down_ok(n, h, w, cin, cm, cout, cout > cm ? cout : cm))
    return int(cudaErrorInvalidValue);
  if (dtype == pt::kFloat32)
    plan_out<float, 2, true>(n, h, w, cin, cm, cout, down_bwd2_kernel<float>,
                             out);
  else
    plan_out<__nv_bfloat16, 2, true>(n, h, w, cin, cm, cout,
                                     down_bwd2_kernel<__nv_bfloat16>, out);
  return int(cudaGetLastError());
}
