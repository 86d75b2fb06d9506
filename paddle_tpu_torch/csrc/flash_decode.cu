// K6: single-query flash decode for Hopper (sm_90a), split over the cache.
//
// Replaces paddle_tpu/kernels/flash_attention.py `_decode_kernel`
// (public as `flash_decode`).
//
// Computes, per (batch, head), attention of one query row q [D] over the
// live prefix of a KV cache k, v [T, D]: keys at positions >= lengths[b]
// (clamped to [0, T]) are masked and never read, the softmax runs online
// in f32, and a row with no live key gets the `l == 0` guard (output 0).
// O is written in the input dtype.
//
// Bound on the H100: device-memory bytes.  Each live K and V row is read
// once, 2 * len * D * bytes per (b, h); a score costs 2 D operations.  At
// the decode shapes of the serving path ([4, 12, 1, 64] over a 384-deep
// cache, [8, 12, 1, 64] over 1024) that is a few MB, so what holds the
// kernel back is latency: enough blocks to fill the card and enough bytes
// in flight per block.
//
// Design.
// - Split over the cache.  The grid is (b*h, S): block (bh, s) takes the
//   `chunk` keys [s chunk, (s + 1) chunk) of row bh.  The host cannot read
//   `lengths` without a sync, so the wrapper picks the chunk from T and
//   b*h alone (flash_attention.py `decode_plan`: about two blocks per SM,
//   at least 64 keys, a multiple of 64).  A block whose chunk starts at
//   or past the live length writes an empty partial (m = -inf, l = 0) and
//   leaves, so the cost follows the ragged lengths.
// - Wide loads, many rows in flight.  A chunk streams through shared
//   memory in sub-tiles of kKT keys (at most 16 KB of K and 16 KB of V)
//   by cp.async, 16 bytes a thread, through a ring of up to kStages
//   sub-tiles: the K and V bytes of the next sub-tiles are in flight while
//   the current one is scored and summed.  Rows past the live length are
//   not loaded.
// - Scores.  A group of kG lanes takes one key: each lane reads 16-byte
//   vectors of the K row (8 lanes a key at D 64 bf16, so a warp scores 4
//   keys a step), dots them with its slice of q (f32 registers), and the
//   group reduces by shuffles.  The sub-tile's scores go to shared memory
//   once, with each warp's max of them.
// - P.V.  Each thread owns one 16-byte column slice of D over a subset of
//   the sub-tile's keys (key groups), keeps p in f32 and an f32
//   accumulator of its slice; the running max rescales it per sub-tile.
//   The key groups' accumulators and sums are reduced through shared
//   memory once, at the end of the chunk, in key-group order.
// - One launch, fixed merge order.  With S = 1 the block writes O.  Else
//   each block writes its (m, l, acc[D]) partial in f32 to the workspace
//   ws [b*h, S, D + 2] the wrapper owns, then __threadfence and an
//   atomicAdd on the row's arrival counter; the last block to arrive
//   merges the S partials in split order (their m and l through shared
//   memory, then each column's acc loads issued together), writes O and
//   resets the counter to 0.  So K6 stays one launch per layer per decode step, with no
//   second kernel and no per-call memset (the wrapper zeroes the counters
//   once per device and stream), and its output is bitwise repeatable:
//   every partial and the merge are sums in a fixed order, and only which
//   block merges depends on timing.  An empty partial contributes 0 to
//   the merge and never reaches exp(-inf - (-inf)).

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;      // sub-tiles in flight in the ring
constexpr int kMinChunk = 64;   // keys; a multiple of every kKT

template <typename T, int D>
struct Cfg {
  static constexpr int kVec = 16 / int(sizeof(T));  // elements per vector
  static constexpr int kNV = D / kVec;              // vectors per row
  static constexpr int kG = kNV < 32 ? kNV : 32;    // lanes per key (scores)
  static constexpr int kR = kNV / kG;               // vectors per lane, key
  static constexpr int kKeysPerStep = kThreads / kG;
  static constexpr int kKT0 = 16384 / (D * int(sizeof(T)));
  static constexpr int kKT = kKT0 < 64 ? kKT0 : 64;  // keys per sub-tile
  static constexpr int kKG = kThreads / kNV;         // key groups in P.V
  static constexpr int kTileElems = kKT * D;         // one of K, V
  static_assert(kKT % kKeysPerStep == 0 && kMinChunk % kKT == 0,
                "sub-tiles split evenly");
  static_assert(D <= kThreads, "one thread per output column");
};

// 16 bytes of shared memory as f32
__device__ __forceinline__ void unpack(const float* p, float (&f)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}

__device__ __forceinline__ void unpack(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ o, float* __restrict__ ws,
                    unsigned* __restrict__ counters, int H, int T_, int chunk,
                    float scale) {
  using C = Cfg<T, D>;
  constexpr int V = C::kVec;
  extern __shared__ float4 smem4[];
  T* const ring = reinterpret_cast<T*>(smem4);
  __shared__ float s_sc[C::kKT];   // the sub-tile's scores
  __shared__ float s_wm[kWarps];   // each warp's max of them
  __shared__ float s_l[C::kKG];    // the key groups' sums
  __shared__ bool s_last;

  const int bh = blockIdx.x, split = blockIdx.y, S = gridDim.y;
  const int tid = threadIdx.x;
  const int len = min(max(lengths[bh / H], 0), T_);
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  float* const part = ws + (size_t(bh) * S + split) * (D + 2);

  if (start < end) {
    const size_t base = size_t(bh) * T_ * D;
    const int gl = tid % C::kG, grp = tid / C::kG;   // scores
    const int sl = tid % C::kNV, kg = tid / C::kNV;  // P.V
    float qf[C::kR][V];
#pragma unroll
    for (int r = 0; r < C::kR; ++r)
#pragma unroll
      for (int e = 0; e < V; ++e)
        qf[r][e] = pt::to_f32(q[size_t(bh) * D + (gl + r * C::kG) * V + e]);

    const int n_sub = (end - start + C::kKT - 1) / C::kKT;
    auto load = [&](int i) {
      const int key0 = start + i * C::kKT;
      const int rows = min(C::kKT, end - key0);
      T* ks = ring + (i % kStages) * 2 * C::kTileElems;
      T* vs = ks + C::kTileElems;
      for (int e = tid; e < rows * C::kNV; e += kThreads) {
        const int r = e / C::kNV, c = (e % C::kNV) * V;
        const size_t src = base + size_t(key0 + r) * D + c;
        pt::tc::cp_async16(ks + r * D + c, k + src);
        pt::tc::cp_async16(vs + r * D + c, v + src);
      }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_sub) load(s);
      pt::tc::cp_async_commit();
    }

    float m_run = -INFINITY, l_run = 0.f, acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
    for (int i = 0; i < n_sub; ++i) {
      // sub-tile i has landed, and every thread is done with i - 1, whose
      // slot the next load takes
      pt::tc::cp_async_wait<kStages - 2>();
      __syncthreads();
      if (i + kStages - 1 < n_sub) load(i + kStages - 1);
      pt::tc::cp_async_commit();
      const T* ks = ring + (i % kStages) * 2 * C::kTileElems;
      const T* vs = ks + C::kTileElems;
      const int rows = min(C::kKT, end - (start + i * C::kKT));

      float m_mine = -INFINITY;
#pragma unroll
      for (int j = 0; j < C::kKT / C::kKeysPerStep; ++j) {
        const int kk = j * C::kKeysPerStep + grp;
        float dot = 0.f;
        if (kk < rows) {
#pragma unroll
          for (int r = 0; r < C::kR; ++r) {
            float kf[V];
            unpack(ks + kk * D + (gl + r * C::kG) * V, kf);
#pragma unroll
            for (int e = 0; e < V; ++e) dot = fmaf(qf[r][e], kf[e], dot);
          }
        }
        // every lane of the group ends with the whole dot
#pragma unroll
        for (int off = C::kG / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(pt::kFullMask, dot, off);
        if (kk < rows) {
          m_mine = fmaxf(m_mine, dot * scale);
          if (gl == 0) s_sc[kk] = dot * scale;
        }
      }
      m_mine = pt::warp_max(m_mine);
      if ((tid & 31) == 0) s_wm[tid >> 5] = m_mine;
      __syncthreads();

      float m_tile = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m_tile = fmaxf(m_tile, s_wm[w]);
      const float m_new = fmaxf(m_run, m_tile);   // finite: rows >= 1
      const float alpha = expf(m_run - m_new);    // 0 on the first sub-tile
      m_run = m_new;
      l_run *= alpha;
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] *= alpha;
      for (int kk = kg; kk < rows; kk += C::kKG) {
        const float p = expf(s_sc[kk] - m_new);
        float vf[V];
        unpack(vs + kk * D + sl * V, vf);
        l_run += p;
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
      }
    }

    // the key groups' partials, summed in key-group order
    pt::tc::cp_async_wait<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(ring);   // [kKG][D]
#pragma unroll
    for (int e = 0; e < V; ++e) red[kg * D + sl * V + e] = acc[e];
    if (sl == 0) s_l[kg] = l_run;
    __syncthreads();
    float l = 0.f;
    for (int g = 0; g < C::kKG; ++g) l += s_l[g];
    if (tid < D) {
      float a = 0.f;
      for (int g = 0; g < C::kKG; ++g) a += red[g * D + tid];
      if (S == 1)
        o[size_t(bh) * D + tid] = pt::from_f32<T>(a / (l == 0.f ? 1.f : l));
      else
        part[2 + tid] = a;
    }
    if (S == 1) return;
    if (tid == 0) {
      part[0] = m_run;
      part[1] = l;
    }
  } else {
    if (S == 1) {
      if (tid < D) o[size_t(bh) * D + tid] = pt::from_f32<T>(0.f);
      return;
    }
    if (tid == 0) {   // an empty partial: the merge reads m and skips it
      part[0] = -INFINITY;
      part[1] = 0.f;
    }
  }

  // arrive; the last of the row's S blocks merges
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(counters + bh, 1u) == static_cast<unsigned>(S - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (tid == 0) counters[bh] = 0u;
  // the partials' m and l into shared memory, their weights beside them
  // (0 for an empty one, whose acc was not written), then O in split order
  float* sm_m = reinterpret_cast<float*>(ring);   // [S] each
  float* sm_l = sm_m + S;
  float* sm_w = sm_l + S;
  const float* parts = ws + size_t(bh) * S * (D + 2);
  for (int s = tid; s < S; s += kThreads) {
    sm_m[s] = __ldcg(parts + s * (D + 2));
    sm_l[s] = __ldcg(parts + s * (D + 2) + 1);
  }
  __syncthreads();
  float mt = -INFINITY;
  for (int s = 0; s < S; ++s) mt = fmaxf(mt, sm_m[s]);
  for (int s = tid; s < S; s += kThreads)
    sm_w[s] = sm_m[s] == -INFINITY ? 0.f : expf(sm_m[s] - mt);
  __syncthreads();
  float lt = 0.f;
  for (int s = 0; s < S; ++s) lt += sm_l[s] * sm_w[s];
  if (tid < D) {
    float at = 0.f;
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      const float w = sm_w[s];
      if (w != 0.f) at += __ldcg(parts + s * (D + 2) + 2 + tid) * w;
    }
    o[size_t(bh) * D + tid] = pt::from_f32<T>(at / (lt == 0.f ? 1.f : lt));
  }
}

// The largest ring: kStages sub-tiles of K and V.
template <typename T, int D>
constexpr size_t max_ring() {
  return size_t(kStages) * 2 * Cfg<T, D>::kTileElems * sizeof(T);
}

template <typename T, int D>
cudaError_t allow_ring() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_decode_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(max_ring<T, D>()));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* o, int b, int h, int t,
                   float scale, int chunk, void* ws, void* counters,
                   cudaStream_t stream) {
  using C = Cfg<T, D>;
  const int splits = (t + chunk - 1) / chunk;
  if (splits > 65535 || (splits > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  // the ring, which the merge reuses for 3 S floats
  const int n_sub = chunk / C::kKT;
  size_t smem = size_t(n_sub < kStages ? n_sub : kStages) * 2 *
                C::kTileElems * sizeof(T);
  if (smem < 3 * sizeof(float) * splits) smem = 3 * sizeof(float) * splits;
  if (smem > max_ring<T, D>()) return cudaErrorInvalidValue;
  const cudaError_t err = allow_ring<T, D>();
  if (err != cudaSuccess) return err;
  flash_decode_kernel<T, D><<<dim3(b * h, splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(o), static_cast<float*>(ws),
      static_cast<unsigned*>(counters), h, t, chunk, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* lengths, void* o, int b, int h, int t,
                       int d, float scale, int chunk, void* ws, void* counters,
                       cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, lengths, o, b, h, t, scale, chunk, ws,
                           counters, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, o, b, h, t, scale, chunk, ws,
                            counters, stream);
    case 256:
      return launch<T, 256>(q, k, v, lengths, o, b, h, t, scale, chunk, ws,
                            counters, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: [b*h, d]; k, v: [b*h, t, d], contiguous in `dtype`, k and v
// 16-byte aligned; lengths: int32 [b], the live prefix of each row.  d in
// {64, 128, 256}.  chunk: keys per split, a positive multiple of 64; S =
// ceil(t / chunk) splits.  With S > 1, ws holds b*h*S*(d + 2) floats
// (written before read) and counters b*h unsigned ints that are 0 on entry
// and are left 0.  Returns cudaGetLastError() after the launch.
extern "C" int pt_flash_decode(const void* q, const void* k, const void* v,
                               const void* lengths, void* o, int b, int h,
                               int t, int d, int dtype, float scale,
                               int chunk, void* ws, void* counters,
                               void* stream) {
  if (b < 1 || h < 1 || t < 1 || chunk < kMinChunk || chunk % kMinChunk)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == pt::kFloat32)
    err = dispatch_d<float>(q, k, v, lengths, o, b, h, t, d, scale, chunk, ws,
                            counters, st);
  else if (dtype == pt::kBFloat16)
    err = dispatch_d<__nv_bfloat16>(q, k, v, lengths, o, b, h, t, d, scale,
                                    chunk, ws, counters, st);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}
