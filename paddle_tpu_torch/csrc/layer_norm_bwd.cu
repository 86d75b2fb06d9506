// K5: LayerNorm backward for Hopper (sm_90a), one launch per call.
//
// Replaces paddle_tpu/kernels/layer_norm.py `_bwd_kernel` (driven by
// `_bwd`).  For x, dy [rows, D] (float32, bfloat16 or float16, D % 128 ==
// 0) and gamma [D] (float32, bfloat16 or float16) it recomputes each row's
// mean and biased
// variance from x in f32 (two passes: the mean, then the mean of xc^2),
// and writes
//   dx = rstd * (wdy - mean(wdy) - xhat * mean(wdy * xhat))   in x's dtype,
//   xhat = (x - mean) * rstd,  wdy = dy * gamma,
//   dgamma = sum over rows of dy * xhat,  dbeta = sum over rows of dy,
// the two sums taken in f32 and written in the requested dtype (f32 for the
// raw launch, gamma's from the autograd Function).
//
// Bound on the H100: device-memory bytes, x and dy read once and dx written
// once, 3 * rows * D * bytes: 113 MB, 33.8 us, at the GPT train step's
// [24576, 768] bf16; about 12 operations per element, far below that.
//
// Design: a warp per row, the row in registers, dgamma/dbeta merged inside
// the launch in one fixed order.
// - A team of W warps (W = 1 up to D = NV_max * 32 * 16 / bytes, the
//   plan's `warps_per_row` beyond) owns a row: thread t of the team holds
//   the 16-byte vectors t, t + 32 W, ... (NV of them, a template
//   parameter, so the row lives in registers: x and dy packed as loaded),
//   lanes past the row's end hold zeros.  The three row reductions (sum x;
//   sum xc^2; the pair sum wdy, sum wdy * xhat) are __shfl_xor_sync
//   butterflies, which leave the same value in every lane; with W > 1 the
//   warps' sums meet in shared memory, added in warp order behind a named
//   barrier of the team's threads.  With W = 1 a row takes no barrier.
// - Persistent blocks of 8 warps, 8 / W teams each; team g of the grid
//   takes rows g, g + teams in the grid, ...  The next row's x and dy are
//   loaded before the current row's math (a register double buffer), so
//   each warp keeps a row in flight while it computes; no warp reads a row
//   >= rows.  The plan (kernels/layer_norm.py `ln_bwd_plan`) sizes the
//   grid from the SM count and the blocks per SM that __launch_bounds__
//   holds each instantiation to.
// - gamma is staged once per block into shared memory as f32, while the
//   block's first rows are in flight.
// - dgamma/dbeta: each thread sums dy * xhat and dy of its columns over
//   its team's rows in f32 registers; the block adds its teams' sums in
//   team order through shared memory and writes one partial row [2, D] to
//   the workspace.  Then a two-level merge with atomic tickets: blocks form
//   groups of G (the plan's `group`, about sqrt(blocks)); the last block of
//   a group to arrive sums its group's partial rows in block order into a
//   group row; the last group merger sums the group rows in group order and
//   writes dgamma, dbeta; each merger resets its ticket, so the workspace's
//   tickets are 0 again for the next launch.  Every sum has a fixed order
//   per plan, so two calls give bitwise-equal results; only which block
//   merges depends on timing.  Blocks that got no rows write zero partials
//   and take their ticket all the same.
// - Rows too wide for 8 warps' registers (D > 8192 bf16, > 6144 f32) go to
//   `ln_bwd_wide_kernel`: one team of 8 warps per block reads the row from
//   device memory in each of its four passes (L1 and L2 hold it between
//   them) and sums dgamma/dbeta in the block's partial row itself; the
//   merge is the same.
// Measured on the H100 at [24576, 768] bf16 (0.054 ms, 63% of the bound;
// the same traffic as torch.add of two such tensors, 0.039 ms): a launch
// costs ~10 us whatever its rows (the first rows' latency, the merge's
// fences and tickets), and the rows stream at 2.2-2.6 TB/s.  Tried and not
// kept: a cp.async ring of 2, 3 or 4 rows per warp in shared memory
// (0.060-0.064 ms), x held as f32 across the passes (no faster where it
// did not spill), per-vector partial sums in the row reductions (no
// faster), 2 to 8 warps per row (as fast at 2, slower beyond).

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// vectors of 16 bytes per thread held in registers, at most
constexpr int kMaxVecsF32 = 6;
constexpr int kMaxVecsBF16 = 4;
// blocks of kThreads per SM that the plan counts on (kernels/layer_norm.py
// LN_BWD_BLOCKS_PER_SM), by vectors per thread; entry 0 is the wide kernel.
// __launch_bounds__ holds each instantiation's registers to it.
constexpr int kBlocksF32[kMaxVecsF32 + 1] = {2, 4, 3, 2, 2, 1, 1};
constexpr int kBlocksBF16[kMaxVecsBF16 + 1] = {2, 4, 2, 2, 1};

template <typename T>
constexpr int blocks_per_sm(int nv) {
  return sizeof(T) == 4 ? kBlocksF32[nv] : kBlocksBF16[nv];
}

struct Args {
  const void* x;
  const void* gamma;
  const void* dy;
  void* dx;
  void* dg;
  void* db;
  float* ws;          // [blocks + groups, 2, d] f32: partial and group rows
  unsigned* tickets;  // [groups + 1], 0 on entry and left 0
  long long rows;
  int d;
  float eps;
  int gdtype;     // gamma's dtype code
  int out_dtype;  // dgamma / dbeta's dtype code
  int wpr;        // warps per row (the wide kernel: kWarps)
  int group;      // blocks per merge group
};

// the V values of a 16-byte vector as f32
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f);

template <>
__device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u,
                                                      float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <>
__device__ __forceinline__ void unpack<__half>(const uint4& u, float* f) {
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __half22float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

__device__ __forceinline__ unsigned f16x2(float lo, float hi) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// V f32 values rounded to T, as one 16-byte vector
template <typename T>
__device__ __forceinline__ uint4 pack(const float* f);

template <>
__device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

template <>
__device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* f) {
  return make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]),
                    bf16x2(f[4], f[5]), bf16x2(f[6], f[7]));
}

template <>
__device__ __forceinline__ uint4 pack<__half>(const float* f) {
  return make_uint4(f16x2(f[0], f[1]), f16x2(f[2], f[3]),
                    f16x2(f[4], f[5]), f16x2(f[6], f[7]));
}

// gamma's columns [k V, (k + 1) V) as f32, from device memory
template <int V>
__device__ __forceinline__ void gamma_vec(const void* gamma, int gdtype,
                                          int k, float* g) {
  if (gdtype == pt::kFloat32) {
    const float4* p = reinterpret_cast<const float4*>(gamma) + k * (V / 4);
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 v = __ldg(p + i);
      g[4 * i] = v.x;
      g[4 * i + 1] = v.y;
      g[4 * i + 2] = v.z;
      g[4 * i + 3] = v.w;
    }
  } else if (gdtype == pt::kFloat16) {
    if constexpr (V == 8) {
      unpack<__half>(__ldg(reinterpret_cast<const uint4*>(gamma) + k), g);
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(gamma) + k);
      const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&v.x));
      const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&v.y));
      g[0] = lo.x;
      g[1] = lo.y;
      g[2] = hi.x;
      g[3] = hi.y;
    }
  } else if constexpr (V == 8) {
    unpack<__nv_bfloat16>(__ldg(reinterpret_cast<const uint4*>(gamma) + k),
                          g);
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(gamma) + k);
    g[0] = __uint_as_float(v.x << 16);
    g[1] = __uint_as_float(v.x & 0xffff0000u);
    g[2] = __uint_as_float(v.y << 16);
    g[3] = __uint_as_float(v.y & 0xffff0000u);
  }
}

__device__ __forceinline__ void team_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Sums v[0..N) over the team's warps: a butterfly in each warp, then (W >
// 1) the warps' sums in warp order through `slot` [kWarps][2], behind the
// team's named barrier.  Every thread of the team gets the same values.
template <int N>
__device__ __forceinline__ void team_sum(float* v, float (*slot)[2],
                                         int warp, int lane, int team,
                                         int wpr) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = pt::warp_sum(v[i]);
  if (wpr == 1) return;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) slot[warp][i] = v[i];
  }
  team_barrier(1 + team, 32 * wpr);
  const int first = team * wpr;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = slot[first][i];
    for (int q = 1; q < wpr; ++q) s += slot[first + q][i];
    v[i] = s;
  }
}

// a row's vectors base + j tpr of x and dy (zeros where !ok[j])
template <int NV>
__device__ __forceinline__ void load_row(const uint4* xv, const uint4* dyv,
                                         long long base, int tpr,
                                         const bool (&ok)[NV],
                                         uint4 (&x)[NV], uint4 (&dy)[NV]) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    x[j] = ok[j] ? xv[base + j * tpr] : zero;
    dy[j] = ok[j] ? dyv[base + j * tpr] : zero;
  }
}

__device__ __forceinline__ void add4(float4& s, const float4& p) {
  s.x += p.x;
  s.y += p.y;
  s.z += p.z;
  s.w += p.w;
}

__device__ __forceinline__ void store4(void* out, int c, const float4& s,
                                       int dtype) {
  if (dtype == pt::kFloat32) {
    reinterpret_cast<float4*>(out)[c / 4] = s;
  } else if (dtype == pt::kFloat16) {
    reinterpret_cast<uint2*>(out)[c / 4] =
        make_uint2(f16x2(s.x, s.y), f16x2(s.z, s.w));
  } else {
    reinterpret_cast<uint2*>(out)[c / 4] =
        make_uint2(bf16x2(s.x, s.y), bf16x2(s.z, s.w));
  }
}

// After the block wrote its partial row ws[blockIdx.x]: the two-level merge.
// The last block of group g (blocks [g G, g G + n)) sums their partial rows
// in block order into group row g; the last group merger sums the group
// rows in group order and writes dgamma, dbeta.
__device__ void merge_tail(const Args& a) {
  __shared__ bool s_last;
  const int t = threadIdx.x;
  const int n4 = a.d / 2;  // float4s in a [2, d] row
  const int blocks = gridDim.x;
  const int groups = (blocks + a.group - 1) / a.group;
  const int g = blockIdx.x / a.group, first = g * a.group;
  const int n = min(a.group, blocks - first);
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(a.tickets + g, 1u) == unsigned(n - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float4* part = reinterpret_cast<const float4*>(a.ws);
  float4* grow = reinterpret_cast<float4*>(a.ws) + size_t(blocks + g) * n4;
  for (int i = t; i < n4; i += kThreads) {
    float4 s = __ldcg(part + size_t(first) * n4 + i);
#pragma unroll 4
    for (int b = 1; b < n; ++b)
      add4(s, __ldcg(part + size_t(first + b) * n4 + i));
    grow[i] = s;
  }
  if (t == 0) a.tickets[g] = 0u;
  __threadfence();
  __syncthreads();
  if (t == 0)
    s_last = atomicAdd(a.tickets + groups, 1u) == unsigned(groups - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float4* rows = reinterpret_cast<const float4*>(a.ws) +
                       size_t(blocks) * n4;
  for (int i = t; i < n4; i += kThreads) {
    float4 s = __ldcg(rows + i);
#pragma unroll 4
    for (int q = 1; q < groups; ++q)
      add4(s, __ldcg(rows + size_t(q) * n4 + i));
    const int c = 4 * i;
    if (c < a.d) store4(a.dg, c, s, a.out_dtype);
    else store4(a.db, c - a.d, s, a.out_dtype);
  }
  if (t == 0) a.tickets[groups] = 0u;
}

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<T>(NV))
ln_bwd_kernel(const Args a) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ float4 smem4[];  // gamma [d]; then the teams' sums [2, d]
  __shared__ float red[3][kWarps][2];
  float* smem = reinterpret_cast<float*>(smem4);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wpr = a.wpr, tpr = 32 * wpr;
  const int team = warp / wpr, tt = t - team * tpr, teams = kWarps / wpr;
  const int d = a.d, nvec = d / V;

  bool ok[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) ok[j] = j * tpr + tt < nvec;
  const uint4* xv = static_cast<const uint4*>(a.x);
  const uint4* dyv = static_cast<const uint4*>(a.dy);
  uint4* dxv = static_cast<uint4*>(a.dx);
  const long long total = static_cast<long long>(gridDim.x) * teams;
  long long r = static_cast<long long>(blockIdx.x) * teams + team;
  // the first row in flight while gamma is staged
  uint4 nx[NV], ndy[NV];
  if (r < a.rows) load_row(xv, dyv, r * nvec + tt, tpr, ok, nx, ndy);
  for (int k = t; k < nvec; k += kThreads) {
    float g[V];
    gamma_vec<V>(a.gamma, a.gdtype, k, g);
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      smem4[k * (V / 4) + i] = make_float4(g[4 * i], g[4 * i + 1],
                                           g[4 * i + 2], g[4 * i + 3]);
  }
  __syncthreads();

  float ag[NV][V], ab[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) ag[j][e] = ab[j][e] = 0.f;
  for (; r < a.rows; r += total) {
    uint4 cx[NV], cdy[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      cx[j] = nx[j];
      cdy[j] = ndy[j];
    }
    if (r + total < a.rows)
      load_row(xv, dyv, (r + total) * nvec + tt, tpr, ok, nx, ndy);

    float s[2];
    s[0] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float f[V];
      unpack<T>(cx[j], f);
#pragma unroll
      for (int e = 0; e < V; ++e) s[0] += f[e];
    }
    team_sum<1>(s, red[0], warp, lane, team, wpr);
    const float mean = s[0] / static_cast<float>(d);

    s[0] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!ok[j]) continue;
      float f[V];
      unpack<T>(cx[j], f);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xc = f[e] - mean;
        s[0] += xc * xc;
      }
    }
    team_sum<1>(s, red[1], warp, lane, team, wpr);
    const float rstd = rsqrtf(s[0] / static_cast<float>(d) + a.eps);

    s[0] = s[1] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!ok[j]) continue;
      float f[V], gy[V];
      unpack<T>(cx[j], f);
      unpack<T>(cdy[j], gy);
      const float* g = smem + (j * tpr + tt) * V;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = (f[e] - mean) * rstd;
        const float w = gy[e] * g[e];
        s[0] += w;
        s[1] += w * xhat;
      }
    }
    team_sum<2>(s, red[2], warp, lane, team, wpr);
    const float c1 = s[0] / static_cast<float>(d);
    const float c2 = s[1] / static_cast<float>(d);

    const long long base = r * nvec + tt;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!ok[j]) continue;
      float f[V], gy[V], o[V];
      unpack<T>(cx[j], f);
      unpack<T>(cdy[j], gy);
      const float* g = smem + (j * tpr + tt) * V;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = (f[e] - mean) * rstd;
        o[e] = rstd * (gy[e] * g[e] - c1 - xhat * c2);
        ag[j][e] += gy[e] * xhat;
        ab[j][e] += gy[e];
      }
      dxv[base + j * tpr] = pack<T>(o);
    }
  }

  // the teams' sums in team order (through shared memory, gamma's no
  // longer needed), the last team's into the block's partial row
  __syncthreads();
  float4* part = reinterpret_cast<float4*>(a.ws + size_t(blockIdx.x) * 2 * d);
  const int d4 = d / 4;
  for (int q = 0; q < teams; ++q) {
    if (team == q) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (!ok[j]) continue;
        const int c4 = (j * tpr + tt) * (V / 4);
#pragma unroll
        for (int i = 0; i < V / 4; ++i) {
          float4 g4 = make_float4(ag[j][4 * i], ag[j][4 * i + 1],
                                  ag[j][4 * i + 2], ag[j][4 * i + 3]);
          float4 b4 = make_float4(ab[j][4 * i], ab[j][4 * i + 1],
                                  ab[j][4 * i + 2], ab[j][4 * i + 3]);
          if (q > 0) {
            float4 pg = smem4[c4 + i], pb = smem4[d4 + c4 + i];
            add4(pg, g4);
            add4(pb, b4);
            g4 = pg;
            b4 = pb;
          }
          float4* dst = q + 1 < teams ? smem4 : part;
          dst[c4 + i] = g4;
          dst[d4 + c4 + i] = b4;
        }
      }
    }
    if (q + 1 < teams) __syncthreads();
  }
  merge_tail(a);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<T>(0))
ln_bwd_wide_kernel(const Args a) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[3][kWarps][2];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int d = a.d, nvec = d / V;
  const uint4* xv = static_cast<const uint4*>(a.x);
  const uint4* dyv = static_cast<const uint4*>(a.dy);
  uint4* dxv = static_cast<uint4*>(a.dx);
  float4* part = reinterpret_cast<float4*>(a.ws + size_t(blockIdx.x) * 2 * d);
  const int d4 = d / 4;
  bool first = true;
  for (long long r = blockIdx.x; r < a.rows; r += gridDim.x) {
    const long long base = r * nvec;
    float s[2];
    s[0] = 0.f;
    for (int k = t; k < nvec; k += kThreads) {
      float f[V];
      unpack<T>(xv[base + k], f);
#pragma unroll
      for (int e = 0; e < V; ++e) s[0] += f[e];
    }
    team_sum<1>(s, red[0], warp, lane, 0, kWarps);
    const float mean = s[0] / static_cast<float>(d);
    s[0] = 0.f;
    for (int k = t; k < nvec; k += kThreads) {
      float f[V];
      unpack<T>(xv[base + k], f);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xc = f[e] - mean;
        s[0] += xc * xc;
      }
    }
    team_sum<1>(s, red[1], warp, lane, 0, kWarps);
    const float rstd = rsqrtf(s[0] / static_cast<float>(d) + a.eps);
    s[0] = s[1] = 0.f;
    for (int k = t; k < nvec; k += kThreads) {
      float f[V], gy[V], g[V];
      unpack<T>(xv[base + k], f);
      unpack<T>(dyv[base + k], gy);
      gamma_vec<V>(a.gamma, a.gdtype, k, g);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = (f[e] - mean) * rstd;
        const float w = gy[e] * g[e];
        s[0] += w;
        s[1] += w * xhat;
      }
    }
    team_sum<2>(s, red[2], warp, lane, 0, kWarps);
    const float c1 = s[0] / static_cast<float>(d);
    const float c2 = s[1] / static_cast<float>(d);
    for (int k = t; k < nvec; k += kThreads) {
      float f[V], gy[V], g[V], o[V], pg[V], pb[V];
      unpack<T>(xv[base + k], f);
      unpack<T>(dyv[base + k], gy);
      gamma_vec<V>(a.gamma, a.gdtype, k, g);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = (f[e] - mean) * rstd;
        o[e] = rstd * (gy[e] * g[e] - c1 - xhat * c2);
        pg[e] = gy[e] * xhat;
        pb[e] = gy[e];
      }
      dxv[base + k] = pack<T>(o);
#pragma unroll
      for (int i = 0; i < V / 4; ++i) {
        const int c4 = k * (V / 4) + i;
        float4 g4 = make_float4(pg[4 * i], pg[4 * i + 1], pg[4 * i + 2],
                                pg[4 * i + 3]);
        float4 b4 = make_float4(pb[4 * i], pb[4 * i + 1], pb[4 * i + 2],
                                pb[4 * i + 3]);
        if (!first) {
          float4 ug = part[c4], ub = part[d4 + c4];
          add4(ug, g4);
          add4(ub, b4);
          g4 = ug;
          b4 = ub;
        }
        part[c4] = g4;
        part[d4 + c4] = b4;
      }
    }
    first = false;
  }
  if (first) {  // no rows: a zero partial
    for (int c4 = t; c4 < 2 * d4; c4 += kThreads)
      part[c4] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  merge_tail(a);
}

template <typename T, int NV>
cudaError_t launch_rows(const Args& a, int blocks, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int nvec = a.d / V;
  if (nvec > NV * 32 * a.wpr) return cudaErrorInvalidValue;
  const size_t smem = size_t(a.wpr < kWarps ? 8 : 4) * a.d;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  ln_bwd_kernel<T, NV><<<blocks, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, int nv, int blocks, cudaStream_t st) {
  if (nv == 0) {
    if (a.wpr != kWarps) return cudaErrorInvalidValue;
    ln_bwd_wide_kernel<T><<<blocks, kThreads, 0, st>>>(a);
    return cudaGetLastError();
  }
  if constexpr (sizeof(T) == 4) {
    switch (nv) {
      case 1: return launch_rows<T, 1>(a, blocks, st);
      case 2: return launch_rows<T, 2>(a, blocks, st);
      case 3: return launch_rows<T, 3>(a, blocks, st);
      case 4: return launch_rows<T, 4>(a, blocks, st);
      case 5: return launch_rows<T, 5>(a, blocks, st);
      case 6: return launch_rows<T, 6>(a, blocks, st);
    }
  } else {
    switch (nv) {
      case 1: return launch_rows<T, 1>(a, blocks, st);
      case 2: return launch_rows<T, 2>(a, blocks, st);
      case 3: return launch_rows<T, 3>(a, blocks, st);
      case 4: return launch_rows<T, 4>(a, blocks, st);
    }
  }
  return cudaErrorInvalidValue;
}

template <typename B>
const void* kernel_of16(int nv) {
  const void* f[kMaxVecsBF16 + 1] = {
      reinterpret_cast<const void*>(ln_bwd_wide_kernel<B>),
      reinterpret_cast<const void*>(ln_bwd_kernel<B, 1>),
      reinterpret_cast<const void*>(ln_bwd_kernel<B, 2>),
      reinterpret_cast<const void*>(ln_bwd_kernel<B, 3>),
      reinterpret_cast<const void*>(ln_bwd_kernel<B, 4>)};
  return f[nv];
}

const void* kernel_of(int dtype, int nv) {
  if (dtype == pt::kFloat32) {
    const void* f[kMaxVecsF32 + 1] = {
        reinterpret_cast<const void*>(ln_bwd_wide_kernel<float>),
        reinterpret_cast<const void*>(ln_bwd_kernel<float, 1>),
        reinterpret_cast<const void*>(ln_bwd_kernel<float, 2>),
        reinterpret_cast<const void*>(ln_bwd_kernel<float, 3>),
        reinterpret_cast<const void*>(ln_bwd_kernel<float, 4>),
        reinterpret_cast<const void*>(ln_bwd_kernel<float, 5>),
        reinterpret_cast<const void*>(ln_bwd_kernel<float, 6>)};
    return f[nv];
  }
  if (dtype == pt::kFloat16) return kernel_of16<__half>(nv);
  return kernel_of16<__nv_bfloat16>(nv);
}

bool valid_dtype(int code) {
  return code == pt::kFloat32 || code == pt::kBFloat16 ||
         code == pt::kFloat16;
}

int max_vecs(int dtype) {
  return dtype == pt::kFloat32 ? kMaxVecsF32 : kMaxVecsBF16;
}

}  // namespace

// x, dy, dx: [rows, d] contiguous of `dtype` (0 float32, 1 bfloat16, 2
// float16; the 16-bit types share the bf16 plan tables),
// 16-byte aligned, d % 128 == 0; gamma: [d] of `gdtype`; dg, db: [d] of
// `out_dtype`, written; ws: (blocks + groups) * 2 * d float32 (no need to
// be initialised); tickets: groups + 1 unsigned ints, 0 on entry and left
// 0, with groups = ceil(blocks / group).  `nv` vectors per thread (0: the
// wide kernel) and `wpr` warps per row (1, 2, 4 or 8) come from the plan
// (kernels/layer_norm.py `ln_bwd_plan`).  One launch of `blocks` blocks on
// `stream`; returns cudaGetLastError() after it.
extern "C" int pt_layer_norm_bwd(const void* x, const void* gamma,
                                 const void* dy, void* dx, void* dg, void* db,
                                 void* ws, void* tickets, long long rows,
                                 int d, float eps, int dtype, int gdtype,
                                 int out_dtype, int nv, int wpr, int blocks,
                                 int group, void* stream) {
  if (!valid_dtype(dtype) || !valid_dtype(gdtype) || !valid_dtype(out_dtype) ||
      d <= 0 || d % 128 || rows < 0 || nv < 0 || nv > max_vecs(dtype) ||
      (wpr != 1 && wpr != 2 && wpr != 4 && wpr != 8) || blocks < 1 ||
      group < 1 || ws == nullptr || tickets == nullptr)
    return int(cudaErrorInvalidValue);
  const Args a{x, gamma, dy, dx, dg, db, static_cast<float*>(ws),
               static_cast<unsigned*>(tickets), rows, d, eps, gdtype,
               out_dtype, wpr, group};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kFloat32) return int(launch<float>(a, nv, blocks, st));
  if (dtype == pt::kFloat16) return int(launch<__half>(a, nv, blocks, st));
  return int(launch<__nv_bfloat16>(a, nv, blocks, st));
}

// Blocks of 256 threads per SM that the kernel of (dtype, nv) can keep
// resident with `smem` bytes of dynamic shared memory, into *blocks.
extern "C" int pt_layer_norm_bwd_occupancy(int dtype, int nv, int smem,
                                           int* blocks) {
  if (!valid_dtype(dtype) || nv < 0 || nv > max_vecs(dtype) ||
      blocks == nullptr)
    return int(cudaErrorInvalidValue);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel_of(dtype, nv), kThreads, size_t(smem)));
}
