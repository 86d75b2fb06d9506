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
// Forward.  A thread takes 16 bytes of channels (8 bf16 or 4 f32) of one
// output pixel, neighbouring threads the neighbouring channels and then
// pixels, so a warp reads whole lines; it computes h at the nine window taps
// and takes the max (each element of c is read from device memory about
// once, the taps' repeats from L1 and L2).
//
// Backward: one pass over c through shared memory.  A block takes tiles of
// R window rows x Q window columns x G = gv 16-byte vectors of channels of
// one image (the plan: `pt_fused_stem_tail_plan`).  For a tile it
//   1. copies dy of the (R + 1) x (Q + 1) windows that cover its own pixels
//      into shared memory by cp.async (0 for a window outside the image: it
//      adds +0, as the reference's padded dy does), and loads its own input
//      pixels (rows 2 i0 .. 2 (i0 + R) - 1, columns likewise) into
//      registers and the halo around them (the row above, the two rows
//      below, the column left, the two right: 2R + 3 rows x 2Q + 3 columns
//      in all), all with 16-byte loads issued before any is used;
//   2. writes h of every staged pixel to shared memory in T, computed once
//      per pixel (0 outside the image: the pad);
//   3. computes y of its windows once each (packed bf16 maxima) into shared
//      memory in f32 (h's columns are split by parity, so the nine taps of
//      neighbouring windows lie in neighbouring words);
//   4. routes dy to each own pixel from shared memory in the reference's
//      order, applies the relu mask, writes dc with 16-byte stores and adds
//      du * c and du to the thread's da/db in registers.
// Divisions by the tiling's sizes are a multiply-high and a shift (`Div`).
// A thread keeps one channel vector for all its items, so its da/db cover
// V channels.  The blocks are persistent: worker w of a channel group takes
// spatial tiles w, w + workers, ...; at the end a block sums its threads'
// da/db in a fixed order into its partial (part [grid, 2, G]), and the last
// block to arrive (an atomic counter, reset by that block, so it reads 0 on
// every launch without a memset) sums the partials over the workers in
// order, split into fixed slices over its threads.  da and db are the same
// on every run; dc and y are bitwise the plain version's.

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOwn = 8;   // own 16-byte vectors per thread per tile
constexpr int kChunk = 4;    // halo vectors per thread per round

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
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
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

// n / d for 0 <= n < 2^31 by a multiply-high, an add and a shift;
// `make_div` (host) makes the divisor's magic number
struct Div {
  unsigned d, m, s;
  __device__ __forceinline__ int div(int n) const {
    const unsigned u = static_cast<unsigned>(n);
    return static_cast<int>((__umulhi(u, m) + u) >> s);
  }
};

// h of V channels, in T (the pad is 0, not relu(b): `inside` false).
template <typename T>
__device__ __forceinline__ Vec<T> relu_round(const Vec<T>& c, bool inside,
                                             const float* a, const float* b) {
  Vec<T> h;
  h.zero();
  if (inside) {
#pragma unroll
    for (int i = 0; i < Vec<T>::V; ++i)
      h.v[i] = pt::from_f32<T>(
          fmaxf(affine(pt::to_f32(c.v[i]), a[i], b[i]), 0.f));
  }
  return h;
}

// m = max(m, x) elementwise (exact: the result is one of the values; the
// sign of a zero may differ, which no comparison sees)
__device__ __forceinline__ void vmax(Vec<float>& m, const Vec<float>& x) {
#pragma unroll
  for (int i = 0; i < 4; ++i) m.v[i] = fmaxf(m.v[i], x.v[i]);
}
__device__ __forceinline__ void vmax(Vec<__nv_bfloat16>& m,
                                     const Vec<__nv_bfloat16>& x) {
  __nv_bfloat162* mp = reinterpret_cast<__nv_bfloat162*>(m.v);
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(x.v);
#pragma unroll
  for (int i = 0; i < 4; ++i) mp[i] = __hmax2(mp[i], xp[i]);
}

// The backward's tiling (see the header).  Counts in 16-byte vectors.
struct StemGeo {
  int n, h, w, cm, ho, wo;
  int R, Q, gv, gshift, groups;  // window rows and columns, vectors per
                                 // pixel (2^gshift), channel groups
  int tr, tc, tiles;             // tiles down and across an image, all
  int own, halo, wins;           // per tile: own pixels', halo's and
                                 // windows' vectors
  Div per_img, per_row;          // tr * tc, tc: a tile's image and row
  Div own_cols, win_cols;        // 2Q, Q + 1
};

// staged pixel (row sr, column sc; (0, 0) is input pixel (2 i0 - 1, 2 j0 -
// 1)) -> its h vector in shared memory: [2R + 3][parity of sc][Q + 2][gv]
__device__ __forceinline__ int h_at(const StemGeo& g, int sr, int sc,
                                    int vg) {
  return ((sr * 2 + (sc & 1)) * (g.Q + 2) + (sc >> 1)) * g.gv + vg;
}

// halo pixel p of a tile -> (sr, sc): the row above the own rows, the two
// below them, then per own row the column left of them and the two right
__device__ __forceinline__ void halo_pos(const StemGeo& g, int p, int& sr,
                                         int& sc) {
  const int sw = 2 * g.Q + 3;
  if (p < 3 * sw) {
    const int band = p < sw ? 0 : (p < 2 * sw ? 1 : 2);
    sr = band == 0 ? 0 : 2 * g.R + band;
    sc = p - band * sw;
  } else {
    p -= 3 * sw;
    sr = 1 + p / 3;
    const int k = p - (sr - 1) * 3;
    sc = k == 0 ? 0 : 2 * g.Q + k;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_bwd_kernel(const StemGeo g, const T* __restrict__ c,
                const T* __restrict__ dy, const float* __restrict__ aff,
                T* __restrict__ dc, float* __restrict__ part,
                unsigned* __restrict__ counter, float* __restrict__ daff) {
  using pt::tc::cp_async16;
  constexpr int V = Vec<T>::V;
  extern __shared__ uint4 smem[];
  // h [2R + 3][2][Q + 2][gv] in T, dy [wins] in T, y [wins][V] in f32,
  // then the reductions' floats
  Vec<T>* hs = reinterpret_cast<Vec<T>*>(smem);
  Vec<T>* ds = hs + (2 * g.R + 3) * 2 * (g.Q + 2) * g.gv;
  float* ys = reinterpret_cast<float*>(ds + g.wins);
  float* red = ys + g.wins * V;
  __shared__ bool s_last;

  const int tid = threadIdx.x, gv = g.gv, G = gv * V;
  const int cg = blockIdx.x % g.groups, workers = gridDim.x / g.groups;
  const int vg = tid & (gv - 1), ch = cg * G + vg * V;
  float a[V], b[V], sa[V], sb[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    a[v] = aff[ch + v];
    b[v] = aff[g.cm + ch + v];
    sa[v] = sb[v] = 0.f;
  }
  const int ow = 2 * g.Q;   // own columns
  for (int s = blockIdx.x / g.groups; s < g.tiles; s += workers) {
    const int img = g.per_img.div(s), rem = s - img * (g.tr * g.tc);
    const int ti = g.per_row.div(rem);
    const int i0 = ti * g.R, j0 = (rem - ti * g.tc) * g.Q;
    const long long row0 = static_cast<long long>(img) * g.h;
    auto pix = [&](int yy, int xx) {
      return ((row0 + yy) * g.w + xx) * g.cm + ch;
    };
    // 1. loads: dy of the windows by cp.async (zero outside the image),
    // the own pixels into registers, a first round of the halo
    for (int idx = tid; idx < g.wins; idx += kThreads) {
      const int p = idx >> g.gshift, wr = g.win_cols.div(p);
      const int i = i0 + wr, j = j0 + p - wr * (g.Q + 1);
      if (i < g.ho && j < g.wo)
        cp_async16(ds + idx, dy + ((static_cast<long long>(img) * g.ho + i) *
                                       g.wo + j) * g.cm + ch);
      else
        ds[idx].zero();
    }
    pt::tc::cp_async_commit();
    Vec<T> own[kMaxOwn];
#pragma unroll
    for (int k = 0; k < kMaxOwn; ++k) {
      const int idx = k * kThreads + tid;
      own[k].zero();
      if (idx < g.own) {
        const int p = idx >> g.gshift, orow = g.own_cols.div(p);
        const int yy = 2 * i0 + orow, xx = 2 * j0 + p - orow * ow;
        if (yy < g.h && xx < g.w) own[k].load(c + pix(yy, xx));
      }
    }
    for (int r0 = 0; r0 < g.halo; r0 += kChunk * kThreads) {
      Vec<T> hv[kChunk];
      int at[kChunk];
      bool in[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int idx = r0 + k * kThreads + tid;
        hv[k].zero();
        at[k] = -1;
        in[k] = false;
        if (idx < g.halo) {
          int sr, sc;
          halo_pos(g, idx >> g.gshift, sr, sc);
          const int yy = 2 * i0 - 1 + sr, xx = 2 * j0 - 1 + sc;
          at[k] = h_at(g, sr, sc, vg);
          in[k] = yy >= 0 && yy < g.h && xx >= 0 && xx < g.w;
          if (in[k]) hv[k].load(c + pix(yy, xx));
        }
      }
      // 2. h of the halo into shared memory
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        if (at[k] >= 0) hs[at[k]] = relu_round(hv[k], in[k], a, b);
    }
    // 2. h of the own pixels
#pragma unroll
    for (int k = 0; k < kMaxOwn; ++k) {
      const int idx = k * kThreads + tid;
      if (idx < g.own) {
        const int p = idx >> g.gshift, orow = g.own_cols.div(p);
        const int oc = p - orow * ow;
        hs[h_at(g, orow + 1, oc + 1, vg)] = relu_round(
            own[k], 2 * i0 + orow < g.h && 2 * j0 + oc < g.w, a, b);
      }
    }
    pt::tc::cp_async_wait<0>();
    __syncthreads();
    // 3. y of the (R + 1) x (Q + 1) windows, in f32
    for (int idx = tid; idx < g.wins; idx += kThreads) {
      const int p = idx >> g.gshift, wr = g.win_cols.div(p);
      const int wc = p - wr * (g.Q + 1);
      Vec<T> m = hs[h_at(g, 2 * wr, 2 * wc, vg)];
#pragma unroll
      for (int t = 1; t < 9; ++t)
        vmax(m, hs[h_at(g, 2 * wr + t / 3, 2 * wc + t % 3, vg)]);
      float4* out = reinterpret_cast<float4*>(ys + idx * V);
#pragma unroll
      for (int q = 0; q < V / 4; ++q)
        out[q] = make_float4(pt::to_f32(m.v[4 * q]), pt::to_f32(m.v[4 * q + 1]),
                             pt::to_f32(m.v[4 * q + 2]),
                             pt::to_f32(m.v[4 * q + 3]));
    }
    __syncthreads();
    // 4. dh, du, dc of the own pixels; da, db
#pragma unroll
    for (int k = 0; k < kMaxOwn; ++k) {
      const int idx = k * kThreads + tid;
      if (idx >= g.own) continue;
      const int p = idx >> g.gshift, orow = g.own_cols.div(p);
      const int oc = p - orow * ow;
      const int yy = 2 * i0 + orow, xx = 2 * j0 + oc;
      if (yy >= g.h || xx >= g.w) continue;
      float u[V], hv[V], dh[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        u[v] = affine(pt::to_f32(own[k].v[v]), a[v], b[v]);
        hv[v] = pt::to_f32(pt::from_f32<T>(fmaxf(u[v], 0.f)));
        dh[v] = 0.f;
      }
      // the covering windows in the reference's order: an even row 2k is
      // in window row k only; an odd row 2k + 1 in k + 1, then k (local
      // window rows (orow + 1) / 2, then orow / 2); the same in columns
      const int r_hi = (orow + 1) >> 1, r_lo = orow >> 1;
      const int c_hi = (oc + 1) >> 1, c_lo = oc >> 1;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int wr = t < 2 ? r_hi : r_lo, wc = (t & 1) ? c_lo : c_hi;
        if ((t >= 2 && r_lo == r_hi) || ((t & 1) && c_lo == c_hi)) continue;
        const int wi = (wr * (g.Q + 1) + wc) * gv + vg;
        const Vec<T> dm = ds[wi];
        const float4* yq = reinterpret_cast<const float4*>(ys + wi * V);
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          const float4 y4 = yq[q];
          const float ym[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dh[4 * q + e] += hv[4 * q + e] == ym[e]
                                 ? pt::to_f32(dm.v[4 * q + e])
                                 : 0.f;
        }
      }
      Vec<T> out;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float du = u[v] > 0.f ? dh[v] : 0.f;
        out.v[v] = pt::from_f32<T>(__fmul_rn(du, a[v]));
        sa[v] = fmaf(du, pt::to_f32(own[k].v[v]), sa[v]);
        sb[v] += du;
      }
      out.store(dc + pix(yy, xx));
    }
    __syncthreads();
  }

  // the block's partial: the lanes of one channel vector summed by a
  // butterfly, then the 8 warps in order
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    for (int o = 16; o >= gv; o >>= 1) {
      sa[v] += __shfl_xor_sync(pt::kFullMask, sa[v], o);
      sb[v] += __shfl_xor_sync(pt::kFullMask, sb[v], o);
    }
  }
  if (lane < gv) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      red[((warp * gv + lane) * 2) * V + v] = sa[v];
      red[((warp * gv + lane) * 2 + 1) * V + v] = sb[v];
    }
  }
  __syncthreads();
  for (int o = tid; o < 2 * G; o += kThreads) {
    const int sm = o / G, cc = o - sm * G, vi = cc / V, v = cc - vi * V;
    float acc = 0.f;
    for (int wp = 0; wp < kThreads / 32; ++wp)
      acc += red[((wp * gv + vi) * 2 + sm) * V + v];
    part[(static_cast<long long>(blockIdx.x) * 2 + sm) * G + cc] = acc;
  }

  // arrive; the last block merges the partials over the workers in order
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (tid == 0) *counter = 0u;
  const int outs = 2 * g.cm;
  const int slices = outs < kThreads ? kThreads / outs : 1;
  const int span = (workers + slices - 1) / slices;
  for (int t = tid; t < outs * slices; t += kThreads) {
    const int o = t % outs, sl = t / outs;
    const int sm = o / g.cm, chn = o - sm * g.cm, grp = chn / G;
    const int cc = chn - grp * G;
    const int w_end = (sl + 1) * span < workers ? (sl + 1) * span : workers;
    float acc = 0.f;
#pragma unroll 8
    for (int wk = sl * span; wk < w_end; ++wk)
      acc += __ldcg(part + (static_cast<long long>(wk * g.groups + grp) * 2 +
                            sm) * G + cc);
    if (slices == 1)
      daff[o] = acc;
    else
      red[t] = acc;
  }
  if (slices > 1) {
    __syncthreads();
    for (int o = tid; o < outs; o += kThreads) {
      float acc = red[o];
      for (int sl = 1; sl < slices; ++sl) acc += red[sl * outs + o];
      daff[o] = acc;
    }
  }
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

// Div for divisor d in [1, 2^31): m = 2^32 (2^s - d) / d + 1 with 2^s the
// least power of two >= d (fits in 32 bits)
Div make_div(unsigned d) {
  unsigned s = 0;
  while ((1u << s) < d) ++s;
  const unsigned long long one = 1;
  return {d, static_cast<unsigned>((one << 32) * ((one << s) - d) / d + 1),
          s};
}

// The backward's geometry for plan (R, Q, gv) and element size tsz; false
// where the plan or the shape is outside the envelope.
bool make_geo(int n, int h, int w, int cm, int tsz, int R, int Q, int gv,
              StemGeo& g) {
  const int v = 16 / tsz;
  if (!geo_ok(n, h, w, cm, tsz) || R < 1 || Q < 1 || gv < 1 || gv > 32 ||
      32 % gv || (cm / v) % gv)
    return false;
  g.n = n;
  g.h = h;
  g.w = w;
  g.cm = cm;
  g.ho = h / 2;
  g.wo = w / 2;
  g.R = R;
  g.Q = Q;
  g.gv = gv;
  g.gshift = __builtin_ctz(static_cast<unsigned>(gv));
  g.groups = cm / (v * gv);
  g.tr = (g.ho + R - 1) / R;
  g.tc = (g.wo + Q - 1) / Q;
  const long long tiles = static_cast<long long>(n) * g.tr * g.tc;
  const long long own = 4LL * R * Q * gv;
  if (tiles >= (1LL << 31) || own > kMaxOwn * kThreads) return false;
  g.tiles = static_cast<int>(tiles);
  g.own = static_cast<int>(own);
  g.halo = (3 * (2 * Q + 3) + 6 * R) * gv;
  g.wins = (R + 1) * (Q + 1) * gv;
  g.per_img = make_div(g.tr * g.tc);
  g.per_row = make_div(g.tc);
  g.own_cols = make_div(2 * Q);
  g.win_cols = make_div(Q + 1);
  return true;
}

// dynamic shared memory of the backward: h and dy in T, y in f32, then the
// reductions' floats (8 warps x 2 x G, at least 256 for the merge's slices)
size_t bwd_smem(const StemGeo& g, int tsz) {
  const int v = 16 / tsz, G = g.gv * v;
  const int red = 16 * G > kThreads ? 16 * G : kThreads;
  return 16 * (static_cast<size_t>(2 * g.R + 3) * 2 * (g.Q + 2) * g.gv +
               static_cast<size_t>(g.wins)) +
         4 * (static_cast<size_t>(g.wins) * v + red);
}

template <typename T>
cudaError_t set_bwd_smem(size_t smem) {
  return cudaFuncSetAttribute(stem_bwd_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// out: [grid, blocks per SM, shared memory bytes, spatial tiles, channel
// groups]: the grid fills the card (blocks per SM x SMs, a multiple of the
// groups) or takes every tile once
template <typename T>
cudaError_t plan_bwd(const StemGeo& g, int* out) {
  const size_t smem = bwd_smem(g, sizeof(T));
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = set_bwd_smem<T>(smem);
  if (err != cudaSuccess) return err;
  int bps = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, stem_bwd_kernel<T>,
                                                      kThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (bps < 1) return cudaErrorInvalidConfiguration;
  const long long want = static_cast<long long>(g.tiles) * g.groups;
  const long long fill = static_cast<long long>(bps) * sms / g.groups *
                         g.groups;
  long long grid = want < fill ? want : fill;
  if (grid < g.groups) grid = g.groups;
  out[0] = static_cast<int>(grid);
  out[1] = bps;
  out[2] = static_cast<int>(smem);
  out[3] = g.tiles;
  out[4] = g.groups;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_bwd(const StemGeo& g, const void* c, const void* dy,
                       const void* aff, void* dc, void* daff, void* part,
                       void* counter, int grid, cudaStream_t st) {
  if (grid < g.groups || grid % g.groups || part == nullptr ||
      counter == nullptr)
    return cudaErrorInvalidValue;
  const size_t smem = bwd_smem(g, sizeof(T));
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = set_bwd_smem<T>(smem);
  if (err != cudaSuccess) return err;
  stem_bwd_kernel<T><<<grid, kThreads, smem, st>>>(
      g, static_cast<const T*>(c), static_cast<const T*>(dy),
      static_cast<const float*>(aff), static_cast<T*>(dc),
      static_cast<float*>(part), static_cast<unsigned*>(counter),
      static_cast<float*>(daff));
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

// The backward's plan for the geometry of pt_fused_stem_tail_fwd and the
// tiling (rows R, cols Q window rows and columns, vecs gv 16-byte vectors of
// channels per pixel: 4 R Q gv <= 2048, gv dividing 32 and cm's vectors):
// out [5] = grid, blocks per SM, shared memory bytes, spatial tiles, channel
// groups.  Returns a CUDA error code, cudaErrorInvalidValue outside the
// envelope.
extern "C" int pt_fused_stem_tail_plan(int n, int h, int w, int cm, int rows,
                                       int cols, int vecs, int dtype,
                                       int* out) {
  StemGeo g;
  if (dtype == pt::kFloat32 && make_geo(n, h, w, cm, 4, rows, cols, vecs, g))
    return int(plan_bwd<float>(g, out));
  if (dtype == pt::kBFloat16 &&
      make_geo(n, h, w, cm, 2, rows, cols, vecs, g))
    return int(plan_bwd<__nv_bfloat16>(g, out));
  return int(cudaErrorInvalidValue);
}

// As pt_fused_stem_tail_fwd, plus dy: [n, h/2, w/2, cm], the tiling (rows,
// cols, vecs) and the grid of pt_fused_stem_tail_plan.  Writes dc ([n, h, w,
// cm], `dtype`) and daff ([2, cm] float32: da, db); part is a [grid, 2, G]
// float32 scratch (G = vecs * 16 bytes' worth of channels), counter one
// unsigned int that is 0 on entry and is left 0.  One launch on `stream`.
extern "C" int pt_fused_stem_tail_bwd(const void* c, const void* dy,
                                      const void* aff, void* dc, void* daff,
                                      void* part, void* counter, int n, int h,
                                      int w, int cm, int rows, int cols,
                                      int vecs, int grid, int dtype,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  StemGeo g;
  if (dtype == pt::kFloat32 && make_geo(n, h, w, cm, 4, rows, cols, vecs, g))
    return int(launch_bwd<float>(g, c, dy, aff, dc, daff, part, counter, grid,
                                 st));
  if (dtype == pt::kBFloat16 &&
      make_geo(n, h, w, cm, 2, rows, cols, vecs, g))
    return int(launch_bwd<__nv_bfloat16>(g, c, dy, aff, dc, daff, part,
                                         counter, grid, st));
  return int(cudaErrorInvalidValue);
}
