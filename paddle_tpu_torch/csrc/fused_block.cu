// K7: the fused stride-1 ResNet bottleneck block, forward and backward, on
// the tensor cores of Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/fused_bottleneck.py `_fwd_kernel` (:180,
// driven by `_fwd` :345) and `_bwd_kernel` (:205, `_bwd` :372), public
// there as `fused_bottleneck` (identity shortcut) and
// `fused_bottleneck_proj` (projection shortcut).  Over NHWC rows, f32
// accumulation, "round" the cast to the activation dtype T (bf16 or f32):
//   h0  = round(relu(a1 * (x @ w1) + b1))
//   h1  = round(relu(a2 * conv3x3(h0, w2) + b2))        (zero padding)
//   y   = round(relu(a3 * (h1 @ w3) + b3 + s)),  s = x | a4 * (x @ w4) + b4
// The backward recomputes the forward and returns dx (T), dW1..dW4 and the
// affine-grad rows (f32), rounding c0, c1, c2, c4 to T before the
// affine-grad sums and dc2, dc1, dc0 (dc4) to T before their products, as
// the Pallas `_bwd_kernel` does; the relu masks compare the f32
// pre-activations with > 0.
//
// The design is K8's (csrc/fused_down.cu) at stride 1, and the forward,
// B1, the weight-gradient GEMM W, its slice sum R, the plan and the
// launchers are the stride-1 instances of the pieces both share
// (csrc/block_tc.cuh: `block_fwd_kernel<T, 1, proj>`,
// `block_bwd1_kernel<T, 1, proj>`, `wgrad_kernel<T, 1>`, `wsum_kernel`),
// every product `pt::tc::product` (csrc/mma.cuh: bf16 mma.sync m16n8k16
// fed by ldmatrix and a cp.async ring; f32 the same tiles with exact
// CUDA-core FMAs, never TF32):
//   forward  a block takes th rows of one image, recomputes h0 on its
//            th + 2 halo rows (zero rows outside the image: the conv's
//            padding) into shared memory, bf16 rows padded by 16 bytes;
//            the 3x3 conv is an implicit GEMM whose ldmatrix lanes point
//            at h0 row (r + dy, c + dx - 1) of their pixel, the 16-byte
//            zero row standing for the left and right padding; h1 stays
//            resident, and per 128-channel chunk of Cout the epilogue of
//            h1 @ w3 adds the shortcut (x from device memory, or the f32
//            c4 tile of x @ w4) and writes y;
//   B1       the same tiles: h0 (own rows to a scratch), c1, h1 (to a
//            scratch), per Cout chunk c2 (c4), dz3 and the a3/b3 (a4/b4)
//            grads, dc2 (dc4) to scratch, where the identity block writes
//            dz3 itself in dc4's place; then dh1 = dc2 w3^T with dc2 read
//            back (K = Cout), du1, the a2/b2 grads, dc1 to a scratch;
//   B2       (`block_bwd2_kernel`, this file) th rows, no halo: c0 on its
//            own rows, dh0 = the 3x3 conv transposed over dc1 (read from
//            the scratch with its one-row halo, zero outside the image),
//            du0, the a1/b1 grads, dc0 to a scratch; then dx = round(dc0
//            w1^T [+ dc4 w4^T] [+ dz3]), one f32 sum rounded once;
//   W, R     dW1 = x^T dc0, dW2 = patches(h0)^T dc1 (the stride-1 im2col
//            gather in the loader), dW3 = h1^T dc2, dW4 = x^T dc4 as one
//            GEMM kernel over all pixels in K slices, then the slices
//            summed in slice order: dW1..dW4 are bitwise repeatable, and
//            no kernel adds a weight gradient per tile.  The affine grads
//            keep one atomic per channel per block.
// Scratch (`pt_fused_block_plan`, allocated by the caller): h0, h1, dc0,
// dc1 [R, Cm] and dc2, dc4 [R, Cout] in T, the f32 slice partials.  At
// ResNet-50's stage 1, batch 128 bf16, that is 4 x 51.4 + 2 x 205.5 MB
// and the partials.
//
// Bound on the H100 at batch 128: 2 R (Cin Cm + 9 Cm^2 + Cm Cout) = 55.9
// GFLOP per forward at every identity stage; against 989 TFLOP/s bf16
// that is 0.057 ms, under the 0.123 ms that x + y take at stage 1 (411
// MB at 3.35 TB/s), so stage 1 is byte-bound and stages 3-4 operation-
// bound; the backward does 3x the forward's operations.  mma.sync from
// one ~200 KB block per SM reaches a fraction of the wgmma peak; the
// halo's h0 recompute (th + 2 rows for th) and the 16-row M granularity
// add to the products.  At Cm 64 (stage 1) the h0, 3x3, dh1, c0, dh0,
// dW1 and dW2 products are 64 columns wide, where `product` splits its
// 8 warps over 4 column groups and 2 row halves.

#include <cstdint>

#include "block_tc.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// backward, B2: dh0 (the 3x3 conv transposed), dc0, dx
// ---------------------------------------------------------------------------

// dc4g holds dc4 (projection) or dz3 (identity), [R, Cout].
template <typename T, bool kProj>
__global__ void __launch_bounds__(kThreads, 1)
block_bwd2_kernel(Geo g, const T* __restrict__ x, const T* __restrict__ w1,
                  const T* __restrict__ w2, const T* __restrict__ w4,
                  const float* __restrict__ aff, const T* __restrict__ dc1g,
                  const T* __restrict__ dc4g, float* __restrict__ daff,
                  T* __restrict__ dc0g, T* __restrict__ dx) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const B2Layout L = b2_layout<T, 1>(g.th, g.w, g.cm);
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  short* rowt = reinterpret_cast<short*>(smem + L.row);
  short* colt = reinterpret_cast<short*>(smem + L.col);
  T* c0r = reinterpret_cast<T*>(smem + L.c0r);
  uint8_t* m0 = reinterpret_cast<uint8_t*>(smem + L.m0);
  float* dA = reinterpret_cast<float*>(smem + L.daff);  // rows 0, 1: [2][Cm]
  const Tile t = tile_of<1>(g);
  const int tid = threadIdx.x;
  const float* a1 = aff;
  const float* b1 = aff + g.aw;

  fill_tables(g, t, rowt, colt);
  pt::tc::zero_row(ring);
  for (int i = tid; i < 2 * g.cm; i += kThreads) dA[i] = 0.f;
  product<T, false, true, false>(
      t.P, g.cm, g.cin, g.vec,
      [&](int m, int k) -> const T* { return x + (t.own + m) * g.cin + k; },
      [&](int k, int n) -> const T* { return w1 + size_t(k) * g.cm + n; },
      [&](int m, int n, float v) {
        c0r[m * g.cm + n] = pt::from_f32<T>(v);
        m0[m * g.cm + n] = affine(v, a1[n], b1[n]) > 0.f;
      },
      ring);
  // dh0[q, c] = sum over (ky, kx, o) of dc1[qy + 1 - ky, qx + 1 - kx, o]
  // w2[ky, kx, c, o]: k = tap * Cm + o, tap = ky * 3 + kx
  product<T, false, false, false>(
      t.P, g.cm, 9 * g.cm, g.vec,
      [&](int m, int k) -> const T* {
        const int tap = k >> g.lgcm, ky = tap / 3, kx = tap - 3 * ky;
        const int i = t.r0 + rowt[m] + 1 - ky, j = colt[m] + 1 - kx;
        if (i < 0 || i >= g.h || j < 0 || j >= g.w) return nullptr;
        return dc1g +
               ((static_cast<long long>(t.img) * g.h + i) * g.w + j) * g.cm +
               (k & (g.cm - 1));
      },
      [&](int k, int n) -> const T* {
        return w2 + (size_t(k >> g.lgcm) * g.cm + n) * g.cm + (k & (g.cm - 1));
      },
      [&](int m, int n, float v) {
        const int i = m * g.cm + n;
        const float du0 = m0[i] ? v : 0.f;
        atomicAdd(dA + n, du0 * pt::to_f32(c0r[i]));
        atomicAdd(dA + g.cm + n, du0);
        dc0g[(t.own + m) * g.cm + n] = pt::from_f32<T>(du0 * a1[n]);
      },
      ring);
  __syncthreads();
  for (int c = tid; c < g.cm; c += kThreads) {
    atomicAdd(daff + c, dA[c]);
    atomicAdd(daff + g.aw + c, dA[g.cm + c]);
  }
  // dx = dc0 w1^T [+ dc4 w4^T] [+ dz3]: one f32 sum, rounded once; dc0
  // read back from its scratch
  product<T, false, false, false>(
      t.P, g.cin, g.cm + (kProj ? g.cout : 0), g.vec,
      [&](int m, int k) -> const T* {
        return k < g.cm ? dc0g + (t.own + m) * g.cm + k
                        : dc4g + (t.own + m) * g.cout + (k - g.cm);
      },
      [&](int k, int n) -> const T* {
        return k < g.cm ? w1 + size_t(n) * g.cm + k
                        : w4 + size_t(n) * g.cout + (k - g.cm);
      },
      [&](int m, int n, float v) {
        const long long at = (t.own + m) * g.cin + n;
        const float res = kProj ? 0.f : pt::to_f32(dc4g[at]);
        dx[at] = pt::from_f32<T>(v + res);
      },
      ring);
}

// K7's envelope: the shared one, and Cout == Cin for the identity block.
bool block_ok(int n, int h, int w, int cin, int cm, int cout, int aw,
              bool proj) {
  return geo_ok(n, h, w, cin, cm, cout, aw) && (proj || cin == cout);
}

}  // namespace

// x: [n, h, w, cin], w1: [cin, cm], w2: [3, 3, cm, cm] (HWIO), w3: [cm,
// cout], w4: [cin, cout] (read only when proj), y: [n, h, w, cout], all
// contiguous in `dtype`; aff: [8, aw] float32 rows a1, b1, a2, b2, a3, b3,
// a4, b4.  Identity (proj == 0) needs cin == cout; cm must be a power of
// two.  Returns cudaGetLastError() after the launch.
extern "C" int pt_fused_block_fwd(const void* x, const void* w1,
                                  const void* w2, const void* w3,
                                  const void* w4, const void* aff, void* y,
                                  int n, int h, int w, int cin, int cm,
                                  int cout, int aw, int dtype, int proj,
                                  void* stream) {
  if (!block_ok(n, h, w, cin, cm, cout, aw, proj != 0))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_FWD(T, P)                                                          \
  launch_fwd<T, 1, P>(x, w1, w2, w3, w4, aff, y, n, h, w, cin, cm, cout, aw, \
                      st)
  if (dtype == pt::kFloat32)
    return int(proj ? PT_FWD(float, true) : PT_FWD(float, false));
  if (dtype == pt::kBFloat16)
    return int(proj ? PT_FWD(__nv_bfloat16, true)
                    : PT_FWD(__nv_bfloat16, false));
#undef PT_FWD
  return int(cudaErrorInvalidValue);
}

// As pt_fused_block_fwd, plus dy: [n, h, w, cout] in `dtype`.  Writes dx
// ([n, h, w, cin], `dtype`), dw1..dw3 and, when proj, dw4 (float32, shaped
// as the weights) and ADDS into daff ([8, aw] float32), which the caller
// zeroes.  Scratch, sized by pt_fused_block_plan: h0, h1, dc0, dc1 [n h w,
// cm] and dc2, dc4 [n h w, cout] in `dtype`, ws (float32, out[13]
// elements).  Launches B1, B2, W and R on `stream`; returns
// cudaGetLastError().
extern "C" int pt_fused_block_bwd(
    const void* x, const void* dy, const void* w1, const void* w2,
    const void* w3, const void* w4, const void* aff, void* dx, void* dw1,
    void* dw2, void* dw3, void* dw4, void* daff, void* h0, void* h1,
    void* dc0, void* dc1, void* dc2, void* dc4, void* ws, int n, int h, int w,
    int cin, int cm, int cout, int aw, int dtype, int proj, void* stream) {
  if (!block_ok(n, h, w, cin, cm, cout, aw, proj != 0))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_BWD(T, P)                                                         \
  launch_bwd<T, 1, P>(block_bwd2_kernel<T, P>, x, dy, w1, w2, w3, w4, aff,   \
                      dx, dw1, dw2, dw3, dw4, daff, h0, h1, dc0, dc1, dc2,   \
                      dc4, ws, n, h, w, cin, cm, cout, aw, st)
  if (dtype == pt::kFloat32)
    return int(proj ? PT_BWD(float, true) : PT_BWD(float, false));
  if (dtype == pt::kBFloat16)
    return int(proj ? PT_BWD(__nv_bfloat16, true)
                    : PT_BWD(__nv_bfloat16, false));
#undef PT_BWD
  return int(cudaErrorInvalidValue);
}

// The plan of one geometry on the current device (`plan_out`,
// csrc/block_tc.cuh: tile heights, blocks, shared memory, K slices,
// partials, weight-gradient items, blocks per SM; 18 values).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue outside the envelope.
extern "C" int pt_fused_block_plan(int n, int h, int w, int cin, int cm,
                                   int cout, int dtype, int proj,
                                   long long* out) {
  const int aw = cout > cm ? cout : cm;
  if (!block_ok(n, h, w, cin, cm, cout, aw, proj != 0))
    return int(cudaErrorInvalidValue);
#define PT_PLAN(T, P) \
  plan_out<T, 1, P>(n, h, w, cin, cm, cout, block_bwd2_kernel<T, P>, out)
  if (dtype == pt::kFloat32) {
    if (proj) PT_PLAN(float, true); else PT_PLAN(float, false);
  } else {
    if (proj) PT_PLAN(__nv_bfloat16, true); else PT_PLAN(__nv_bfloat16, false);
  }
#undef PT_PLAN
  return int(cudaGetLastError());
}
