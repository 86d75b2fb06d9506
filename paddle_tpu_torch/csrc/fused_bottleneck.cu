// P1 and P2: the two stripped kernels of the fused-block probe tool, for
// Hopper (sm_90a).
//
// They replace the two Pallas probes of tools/fused_probe.py
// (`p4_conv_only`, pallas_call :88; `p5_matmuls`, pallas_call :114), which
// cut the stride-1 fused bottleneck block's forward in two, so that its
// time splits between the 3x3 product and the 1x1 chain:
//   P1  y = round(conv3x3(zero_pad(x), w2))     x, y [N, H, W, Cm]
//   P2  h0 = round(relu(x @ w1)); y = round(h0 @ w3 + x)
//       x, y [N, H, W, Cin], w1 [Cin, Cm], w3 [Cm, Cin]
// No affines and no relu in P1, none but the one relu in P2, as in the
// Pallas probes.  "round" is the cast to the dtype T (bf16 or f32).
//
// P1 (`probe_conv3x3_kernel`) runs K7's forward code path for its 3x3
// (csrc/block_tc.cuh, the stride-1 pieces): a block takes th rows of one
// image (`tile_of<1>`, `fill_tables`), stages x over its th + 2 halo rows
// into a resident tile in the layout K7 keeps h0 in (rows of Cm padded by
// 16 bytes, `res_ld`; zero rows outside the image; 16 bytes a cp.async
// where `vec` holds), then runs K7's `conv3x3<T, 1>`, the implicit GEMM on
// `pt::tc::product` (csrc/mma.cuh: bf16 mma.sync m16n8k16 fed by
// ldmatrix straight from the halo tile, w2 through a cp.async ring; f32
// the same tiles with exact CUDA-core FMAs), whose epilogue writes
// round(v).  Its tile height follows `make_plan`'s rule (block_tc.cuh
// `pick_th`: the least tensor-core work, M padded to 16, among the heights
// whose shared memory fits, ties to the larger height), with the own
// pixels' cost alone, since P1 has no halo product.  At ResNet-50's stage
// 1 in bf16 that is K7's forward tiling, 8 rows at one block per SM
// (`pt_probe_tiles` reports the heights and blocks per SM).
//
// P2 (`probe_matmuls_kernel`) runs K7's identity forward without the
// halo, the 3x3 and the affines, on the same pieces: a block takes th rows
// of one image (`tile_of<1>`); h0 = round(relu(x @ w1)) over the tile's
// own pixels on `pt::tc::product` (A read from x in device memory, as
// K7's `halo_h0` reads it) into a resident tile where K7 keeps h1 (rows
// of Cm padded by 16 bytes); then per 128-column chunk of Cout the
// product h0 @ w3, whose epilogue adds x from device memory in f32 and
// rounds once (K7's identity epilogue without the affine and the relu).
// f32 takes the same tiles with `product`'s exact CUDA-core FMAs.  Its
// shared memory is K7's forward layout (`fwd_layout<T, 1>`, the halo
// region unused), so it runs at K7's tiling and occupancy; its tile
// height follows the same rule as P1's.  At ResNet-50's stage 1 in bf16
// both probes run K7's forward tiling, 8 rows at one block per SM, so
// K7's stage-1 forward splits three ways on the same inputs: P1 (the
// 3x3), P2 (the 1x1 chain and the residual on the own pixels) and K7 -
// P1 - P2 (the halo's h0 product, the affines and the rest).
//
// Bound at ResNet-50's stage 1, batch 128 bf16: P1 moves 102.8 MB (0.0307
// ms at 3.35 TB/s) for 29.6 GFLOP (0.0299 ms at 989 TFLOP/s); P2 411.0 MB
// (0.1227 ms) for 26.3 GFLOP: both byte-bound.  P1's halo rows are read
// (th + 2) / th times, from L2 where its neighbours fetched them, and each
// 64-pixel M tile streams all of w2 (73.7 KB) through the ring.

#include <cstdint>

#include "block_tc.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace {

// P1: the ring of `product`, the pixel tables and the x halo tile.
struct ConvLayout {
  size_t ring, row, col, x, total;
};

template <typename T>
__host__ __device__ inline ConvLayout conv_layout(int th, int w, int cm) {
  Carve c;
  ConvLayout l;
  l.ring = c.take(pt::tc::Cfg<T>::kRingBytes);
  l.row = c.take(sizeof(short) * own_px<1>(th, w));
  l.col = c.take(sizeof(short) * own_px<1>(th, w));
  l.x = c.take(sizeof(T) * halo_px<1>(th, w) * res_ld<T>(cm));
  l.total = c.off;
  return l;
}

// ---------------------------------------------------------------------------
// the probes: K7's 3x3 product alone (P1) and its 1x1 chain alone (P2)
// ---------------------------------------------------------------------------

// x over the tile's halo rows into the resident tile xs (row stride
// res_ld), zero rows outside the image (the conv's padding); with vec 16
// bytes a cp.async, waited for here, so the product's leading barrier
// publishes them.
template <typename T>
__device__ void stage_halo(const Geo& g, const Tile& t, const T* x, T* xs) {
  const int ld = res_ld<T>(g.cm);
  if (g.vec) {
    constexpr int kLgV = sizeof(T) == 2 ? 3 : 2;  // log2 of a group
    const int lgg = g.lgcm - kLgV;                // groups per pixel
    for (int i = threadIdx.x; i < (t.P2 << lgg); i += kThreads) {
      const int m = i >> lgg, c = (i & ((1 << lgg) - 1)) << kLgV;
      T* dst = xs + m * ld + c;
      if (m >= t.lo && m < t.hi)
        pt::tc::cp_async16(dst, x + (t.xb + m) * g.cm + c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    pt::tc::cp_async_commit();
    pt::tc::cp_async_wait<0>();
  } else {
    for (int i = threadIdx.x; i < (t.P2 << g.lgcm); i += kThreads) {
      const int m = i >> g.lgcm, c = i & (g.cm - 1);
      xs[m * ld + c] = m >= t.lo && m < t.hi ? x[(t.xb + m) * g.cm + c]
                                             : pt::from_f32<T>(0.f);
    }
  }
}

// P1: y = round(conv3x3(zero_pad(x), w2)), g.cin == g.cm == g.cout; K7's
// forward path for its 3x3, the halo tile holding x where K7's holds h0.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
probe_conv3x3_kernel(Geo g, const T* __restrict__ x, const T* __restrict__ w2,
                     T* __restrict__ y) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const ConvLayout L = conv_layout<T>(g.th, g.w, g.cm);
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  short* rowt = reinterpret_cast<short*>(smem + L.row);
  short* colt = reinterpret_cast<short*>(smem + L.col);
  T* xs = reinterpret_cast<T*>(smem + L.x);
  const Tile t = tile_of<1>(g);

  fill_tables(g, t, rowt, colt);
  pt::tc::zero_row(ring);
  stage_halo(g, t, x, xs);
  conv3x3<T, 1>(
      g, t, rowt, colt, xs, w2,
      [&](int m, int n, float v) {
        y[(t.own + m) * g.cm + n] = pt::from_f32<T>(v);
      },
      ring);
}

// P2: h0 = round(relu(x @ w1)); y = round(h0 @ w3 + x), g.cout == g.cin;
// K7's identity forward without the halo, the 3x3 and the affines, h0
// kept where K7 keeps h1.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
probe_matmuls_kernel(Geo g, const T* __restrict__ x, const T* __restrict__ w1,
                     const T* __restrict__ w3, T* __restrict__ y) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const FwdLayout L = fwd_layout<T, 1>(g.th, g.w, g.cm, false);
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  T* h0s = reinterpret_cast<T*>(smem + L.h1);
  const Tile t = tile_of<1>(g);
  const int ld = res_ld<T>(g.cm);

  pt::tc::zero_row(ring);
  product<T, false, true, false>(
      t.P, g.cm, g.cin, g.vec,
      [&](int m, int k) -> const T* { return x + (t.own + m) * g.cin + k; },
      [&](int k, int n) -> const T* { return w1 + size_t(k) * g.cm + n; },
      [&](int m, int n, float v) {
        h0s[m * ld + n] = pt::from_f32<T>(fmaxf(v, 0.f));
      },
      ring);
  for (int j0 = 0; j0 < g.cout; j0 += kBN) {
    const int nc = min(kBN, g.cout - j0);
    product<T, false, true, true>(
        t.P, nc, g.cm, g.vec,
        [&](int m, int k) -> const T* { return h0s + m * ld + k; },
        [&](int k, int n) -> const T* {
          return w3 + size_t(k) * g.cout + j0 + n;
        },
        [&](int m, int n, float v) {
          const long long at = (t.own + m) * g.cout + j0 + n;
          y[at] = pt::from_f32<T>(v + pt::to_f32(x[at]));
        },
        ring);
  }
}

// ---------------------------------------------------------------------------
// plans and launchers
// ---------------------------------------------------------------------------

// A probe's tile height (0 when none fits): the heights <= 8 whose shared
// memory (`bytes(th)`) fits one block, the least tensor-core work (each
// tile's own pixels padded to 16 rows), ties to the larger height.
template <class Bytes>
int probe_th(int h, int w, const Bytes& bytes) {
  return pick_th(h, bytes,
                 [&](int rows) { return up_to(own_px<1>(rows, w), 16); });
}

template <typename T>
int conv_th(int h, int w, int cm) {
  return probe_th(h, w, [&](int t) { return conv_layout<T>(t, w, cm).total; });
}

template <typename T>
int mm_th(int h, int w, int cm) {
  return probe_th(
      h, w, [&](int t) { return fwd_layout<T, 1>(t, w, cm, false).total; });
}

template <typename T>
cudaError_t launch_probe_conv(const void* x, const void* w2, void* y, int n,
                              int h, int w, int cm, cudaStream_t st) {
  const int th = conv_th<T>(h, w, cm);
  if (th == 0) return cudaErrorInvalidValue;
  const Geo g = make_geo<1>(h, w, cm, cm, cm, cm, th,
                            vec_ok<T>(cm, cm, cm, {x, w2, y}));
  const size_t smem = conv_layout<T>(th, w, cm).total;
  cudaError_t err = set_smem(probe_conv3x3_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  probe_conv3x3_kernel<T><<<n * g.tiles, kThreads, smem, st>>>(
      g, static_cast<const T*>(x), static_cast<const T*>(w2),
      static_cast<T*>(y));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_probe_mm(const void* x, const void* w1, const void* w3,
                            void* y, int n, int h, int w, int cin, int cm,
                            cudaStream_t st) {
  const int th = mm_th<T>(h, w, cm);
  if (th == 0) return cudaErrorInvalidValue;
  const Geo g = make_geo<1>(h, w, cin, cm, cin, cin, th,
                            vec_ok<T>(cin, cm, cin, {x, w1, w3, y}));
  const size_t smem = fwd_layout<T, 1>(th, w, cm, false).total;
  cudaError_t err = set_smem(probe_matmuls_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  probe_matmuls_kernel<T><<<n * g.tiles, kThreads, smem, st>>>(
      g, static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(w3), static_cast<T*>(y));
  return cudaGetLastError();
}

template <typename T>
int probe_tiles(int h, int w, int cm, int* out) {
  out[0] = conv_th<T>(h, w, cm);
  out[1] = mm_th<T>(h, w, cm);
  out[2] = out[0] ? blocks_per_sm(probe_conv3x3_kernel<T>,
                                  conv_layout<T>(out[0], w, cm).total)
                  : 0;
  out[3] = out[1] ? blocks_per_sm(probe_matmuls_kernel<T>,
                                  fwd_layout<T, 1>(out[1], w, cm, false).total)
                  : 0;
  return int(cudaGetLastError());
}

}  // namespace

// P1.  x, y: [n, h, w, cm]; w2: [3, 3, cm, cm] (HWIO); all contiguous in
// `dtype`; cm a power of two.  Returns cudaGetLastError() after the launch.
extern "C" int pt_probe_conv3x3(const void* x, const void* w2, void* y, int n,
                                int h, int w, int cm, int dtype,
                                void* stream) {
  if (!geo_ok(n, h, w, cm, cm, cm, cm)) return int(cudaErrorInvalidValue);
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
  if (!geo_ok(n, h, w, cin, cm, cin, cin)) return int(cudaErrorInvalidValue);
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
