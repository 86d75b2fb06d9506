// K9: the ResNet stem's tail -- batch-norm affine, relu and a 3x3 stride-2
// max-pool with pad 1 -- forward and backward, for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/fused_bottleneck.py `_stem_fwd_kernel` (driven
// by `_stem_fwd`) and `_stem_bwd_kernel` (`_stem_bwd`), public there as
// `fused_stem_tail`.  Over NHWC c [N, H, W, C] (H, W even) with per-channel
// f32 affines a, b:
//   h  = round(relu(f32(c) * a + b))                     in c's dtype T
//   y  = max over the 3x3 stride-2 window of h, zero padding (h >= 0, so
//        the pad never wins)
// and the backward recomputes h and y and routes each window's gradient
// to EVERY element equal to the window's max (compared in T), summed in f32
// over the <= 4 windows that cover an element in the Pallas kernel's order
// (for an odd row the window below first, then the one above; the same in
// the columns), then du = dh where u > 0, dc = round(du * a), da = sum du *
// f32(c), db = sum du.  The affine is a product then a sum (__fmul_rn,
// __fadd_rn), never a fused multiply-add: a one-ulp difference in h decides
// which elements tie with the window max in bf16.
//
// Bound on the H100 at ResNet-50's stem (c [128, 112, 112, 64] bf16): the
// forward moves c + y = 206 + 51 MB, 0.077 ms at 3.35 TB/s; the backward c +
// dy + dc = 462 MB, 0.138 ms.  Byte-bound, with a few operations per byte.
//
// Design.  A thread takes 16 bytes of channels (8 bf16 or 4 f32) of one
// pixel, neighbouring threads the neighbouring channels and then pixels, so
// a warp reads whole lines.  The forward thread computes h at its output
// pixel's nine window taps and takes the max; the backward thread
// recomputes the window max of each window that covers its input pixel
// from c (up to 4 x 9 taps, from L1 and L2: each element of c is read from
// device memory about once).  No shared-memory tile: the redundant taps
// cost instructions, not bytes.  The da/db sums are deterministic: a fixed
// grid of blocks, each walking a fixed set of pixels, writes its per-channel
// partials to a [blocks, 2, C] buffer (512 KB at C = 64) and a second short
// kernel sums them over the blocks in order.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float affine(float c, float a, float b) {
  return __fadd_rn(__fmul_rn(c, a), b);
}

// 16 bytes of T, moved as one vector load or store.
template <typename T>
struct Vec {
  static constexpr int V = 16 / sizeof(T);
  union {
    uint4 u;
    T v[V];
  };
  __device__ __forceinline__ void load(const T* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void store(T* p) const {
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// h = round(relu(c * a + b)) of V channels, as f32 values of T.
template <typename T>
__device__ __forceinline__ void relu_affine(const Vec<T>& c, const float* a,
                                            const float* b, float* h) {
#pragma unroll
  for (int i = 0; i < Vec<T>::V; ++i)
    h[i] = pt::to_f32(pt::from_f32<T>(
        fmaxf(affine(pt::to_f32(c.v[i]), a[i], b[i]), 0.f)));
}

// The max of h over window (i, j) of image img, V channels from ch.
template <typename T>
__device__ __forceinline__ void window_max(const T* __restrict__ c, int h,
                                           int w, int cm, long long img,
                                           int i, int j, int ch,
                                           const float* a, const float* b,
                                           float* m) {
  constexpr int V = Vec<T>::V;
#pragma unroll
  for (int v = 0; v < V; ++v) m[v] = 0.f;
  for (int dy = 0; dy < 3; ++dy) {
    const int yy = 2 * i + dy - 1;
    if (yy < 0 || yy >= h) continue;
    for (int dx = 0; dx < 3; ++dx) {
      const int xx = 2 * j + dx - 1;
      if (xx < 0 || xx >= w) continue;
      Vec<T> cv;
      cv.load(c + ((img * h + yy) * w + xx) * cm + ch);
      float hv[V];
      relu_affine(cv, a, b, hv);
#pragma unroll
      for (int v = 0; v < V; ++v) m[v] = fmaxf(m[v], hv[v]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_fwd_kernel(const T* __restrict__ c, const float* __restrict__ aff,
                T* __restrict__ y, int n, int h, int w, int cm) {
  constexpr int V = Vec<T>::V;
  const int groups = cm / V, ho = h / 2, wo = w / 2;
  const long long items = static_cast<long long>(n) * ho * wo * groups;
  for (long long it = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
       it < items; it += static_cast<long long>(gridDim.x) * kThreads) {
    const int ch = static_cast<int>(it % groups) * V;
    const long long pix = it / groups;
    const int j = static_cast<int>(pix % wo);
    const long long r = pix / wo;
    const int i = static_cast<int>(r % ho);
    float a[V], b[V], m[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      a[v] = aff[ch + v];
      b[v] = aff[cm + ch + v];
    }
    window_max(c, h, w, cm, r / ho, i, j, ch, a, b, m);
    Vec<T> out;
#pragma unroll
    for (int v = 0; v < V; ++v) out.v[v] = pt::from_f32<T>(m[v]);
    out.store(y + pix * cm + ch);
  }
}

// Each block walks pixels blockIdx * P + q, (blockIdx + gridDim) * P + q,
// ... (P = pixels per block step), so its partial sums are the same on
// every run.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_bwd_kernel(const T* __restrict__ c, const T* __restrict__ dy,
                const float* __restrict__ aff, T* __restrict__ dc,
                float* __restrict__ part, int n, int h, int w, int cm) {
  constexpr int V = Vec<T>::V;
  __shared__ float red[kThreads * 2 * 8];
  const int groups = cm / V, step = kThreads / groups;
  const int ch = (threadIdx.x % groups) * V, q = threadIdx.x / groups;
  const int ho = h / 2, wo = w / 2;
  const long long npix = static_cast<long long>(n) * h * w;
  float a[V], b[V], sa[V], sb[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    a[v] = aff[ch + v];
    b[v] = aff[cm + ch + v];
    sa[v] = sb[v] = 0.f;
  }
  for (long long p = static_cast<long long>(blockIdx.x) * step + q; p < npix;
       p += static_cast<long long>(gridDim.x) * step) {
    const int xx = static_cast<int>(p % w);
    const long long r = p / w;
    const int yy = static_cast<int>(r % h);
    const long long img = r / h;
    Vec<T> cv;
    cv.load(c + p * cm + ch);
    float u[V], hv[V], dh[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      u[v] = affine(pt::to_f32(cv.v[v]), a[v], b[v]);
      hv[v] = pt::to_f32(pt::from_f32<T>(fmaxf(u[v], 0.f)));
      dh[v] = 0.f;
    }
    // covering windows in the reference's order: an even row 2k is in
    // window row k; an odd row 2k + 1 in k + 1, then k
    const int nr = (yy & 1) ? 2 : 1, nc = (xx & 1) ? 2 : 1;
    for (int ir = 0; ir < nr; ++ir) {
      const int i = (yy + 1) / 2 - ir;
      if (i >= ho) continue;
      for (int jc = 0; jc < nc; ++jc) {
        const int j = (xx + 1) / 2 - jc;
        if (j >= wo) continue;
        float m[V];
        window_max(c, h, w, cm, img, i, j, ch, a, b, m);
        Vec<T> dv;
        dv.load(dy + ((img * ho + i) * wo + j) * cm + ch);
#pragma unroll
        for (int v = 0; v < V; ++v)
          dh[v] += hv[v] == m[v] ? pt::to_f32(dv.v[v]) : 0.f;
      }
    }
    Vec<T> out;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float du = u[v] > 0.f ? dh[v] : 0.f;
      out.v[v] = pt::from_f32<T>(__fmul_rn(du, a[v]));
      sa[v] = __fadd_rn(sa[v], __fmul_rn(du, pt::to_f32(cv.v[v])));
      sb[v] = __fadd_rn(sb[v], du);
    }
    out.store(dc + p * cm + ch);
  }
  // the block's partials: thread (q, group) holds V channels of each sum
#pragma unroll
  for (int v = 0; v < V; ++v) {
    red[threadIdx.x * 2 * V + v] = sa[v];
    red[threadIdx.x * 2 * V + V + v] = sb[v];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < 2 * cm; o += kThreads) {
    const int s = o / cm, chn = o - s * cm, g = chn / V, v = chn - g * V;
    float acc = 0.f;
    for (int qq = 0; qq < step; ++qq)
      acc += red[(qq * groups + g) * 2 * V + s * V + v];
    part[(static_cast<long long>(blockIdx.x) * 2 + s) * cm + chn] = acc;
  }
}

// daff[o] = sum over blocks of part[block, o], o < 2 C, in block order.
__global__ void __launch_bounds__(kThreads)
stem_sum_kernel(const float* __restrict__ part, float* __restrict__ daff,
                int blocks, int width) {
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= width) return;
  float acc = 0.f;
  for (int b = 0; b < blocks; ++b) acc += part[static_cast<long long>(b) *
                                               width + o];
  daff[o] = acc;
}

bool geo_ok(int n, int h, int w, int cm, int tsz) {
  const int v = 16 / tsz;
  return n > 0 && h > 0 && w > 0 && h % 2 == 0 && w % 2 == 0 && cm > 0 &&
         cm % v == 0 && kThreads % (cm / v) == 0;
}

template <typename T>
cudaError_t launch_fwd(const void* c, const void* aff, void* y, int n, int h,
                       int w, int cm, cudaStream_t st) {
  const long long items =
      static_cast<long long>(n) * (h / 2) * (w / 2) * (cm / Vec<T>::V);
  const long long want = (items + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  stem_fwd_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(c), static_cast<const float*>(aff),
      static_cast<T*>(y), n, h, w, cm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* c, const void* dy, const void* aff,
                       void* dc, void* daff, void* part, int n, int h, int w,
                       int cm, int blocks, cudaStream_t st) {
  stem_bwd_kernel<T><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(c), static_cast<const T*>(dy),
      static_cast<const float*>(aff), static_cast<T*>(dc),
      static_cast<float*>(part), n, h, w, cm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stem_sum_kernel<<<(2 * cm + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(daff), blocks,
      2 * cm);
  return cudaGetLastError();
}

}  // namespace

// c: [n, h, w, cm] contiguous and 16-byte aligned in `dtype` (h, w even;
// cm a multiple of 16 bytes' worth of channels, cm / that dividing 256);
// aff: [2, cm] float32 rows a, b; y: [n, h/2, w/2, cm].  Returns
// cudaGetLastError() after the launch.
extern "C" int pt_fused_stem_tail_fwd(const void* c, const void* aff, void* y,
                                      int n, int h, int w, int cm, int dtype,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kFloat32 && geo_ok(n, h, w, cm, 4))
    return int(launch_fwd<float>(c, aff, y, n, h, w, cm, st));
  if (dtype == pt::kBFloat16 && geo_ok(n, h, w, cm, 2))
    return int(launch_fwd<__nv_bfloat16>(c, aff, y, n, h, w, cm, st));
  return int(cudaErrorInvalidValue);
}

// As pt_fused_stem_tail_fwd, plus dy: [n, h/2, w/2, cm].  Writes dc ([n, h,
// w, cm], `dtype`) and daff ([2, cm] float32: da, db); part is a [blocks, 2,
// cm] float32 scratch, `blocks` the backward's fixed grid.  Launches the
// backward and the partials' sum on `stream`.
extern "C" int pt_fused_stem_tail_bwd(const void* c, const void* dy,
                                      const void* aff, void* dc, void* daff,
                                      void* part, int n, int h, int w, int cm,
                                      int blocks, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks < 1) return int(cudaErrorInvalidValue);
  if (dtype == pt::kFloat32 && geo_ok(n, h, w, cm, 4))
    return int(launch_bwd<float>(c, dy, aff, dc, daff, part, n, h, w, cm,
                                 blocks, st));
  if (dtype == pt::kBFloat16 && geo_ok(n, h, w, cm, 2))
    return int(launch_bwd<__nv_bfloat16>(c, dy, aff, dc, daff, part, n, h, w,
                                         cm, blocks, st));
  return int(cudaErrorInvalidValue);
}
