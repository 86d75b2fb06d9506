// K1: flash-attention forward for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/flash_attention.py `_fwd_kernel` (driven by
// `_fwd`, public as `flash_attention` / `flash_attention_with_lse`).
//
// Computes, per (batch*head, query row), online-softmax attention over
// [B, H, S, D] inputs with an optional causal mask (-1e30), running max,
// sum and accumulator in f32, the `l == 0` guard, and writes O in the
// input dtype plus the row logsumexp in f32.
//
// bf16 and f16: the tensor cores (`flash_fwd_mma_kernel<T, D>`, T the
// 16-bit type; `mma.sync ... .f32.bf16.bf16.f32` or `.f32.f16.f16.f32`,
// the same fragments and ldmatrix loads).  One block of 4 warps
// per (b*h, 64-row query tile); a warp owns 16 query rows (the FA-2
// layout).  The Q tile is loaded once; 64-key tiles of K and V arrive by
// cp.async into a 2-slot ring (csrc/flash_tc.cuh), so the next tile loads
// while the current one multiplies.  S = Q K^T runs on
// mma.sync.m16n8k16 (16-bit in, f32 out) fed by ldmatrix; the online
// softmax runs on S's fragments in registers, the row max and sum reduced
// over the 4 lanes of a quad; P is rounded to T in registers, where
// the reference rounds it (`p.astype(v_blk.dtype)`), and its C fragments
// are the A fragments of P V (V by ldmatrix.trans), with no trip through
// shared memory.  O stays in f32 registers and is written once; lse = m +
// log(l) in f32.  The sum of P V over the keys accumulates in the mma
// (flash_tc.cuh says why).  Causal: key tiles above the
// diagonal are never loaded, only the diagonal tile is masked (the
// reference's `_fast` / `_diag` split), and the heaviest query tiles are
// scheduled first ((b*h) rides blockIdx.x, the query tile blockIdx.y from
// the last).  At D <= 128 a warp keeps its Q fragments in registers; at D
// = 256 (128 f32 of O per thread) it reads them from shared memory for
// each tile.  Shared memory: (64 + 2 * 2 * 64) * (D + 8) * 2 bytes,
// 168,960 at D = 256.
//
// Bound on the H100: at the train shape ([48, 12, 512, 64] causal) the
// least time is the bytes' (q, k, v read and o written once, 0.0454 ms at
// 3.35 TB/s; the 19.4 GFLOP of products take 0.0196 ms at 989 TFLOP/s),
// but mma.sync from 4 warps without warp specialisation reaches a
// fraction of the tensor cores' rate, so the products and the softmax
// between them bound it in practice; wgmma fed by TMA is the next step.
//
// f32: the exact scalar kernel (`flash_fwd_kernel<D>`), CUDA-core
// FMAs in f32 (never TF32).  One thread block per (b*h, 16-row query
// tile); 8 warps, each owning 2 query rows.  The TPU kernel's sequential
// k-block grid axis becomes a loop inside the block over 64-key tiles of
// K and V staged in shared memory.  Inside a tile a warp takes 32 keys at
// a time with one key per lane for Q.K (each lane reads its own padded K
// row, so the 32 lanes hit 32 different banks while the Q row is a
// broadcast), reduces the chunk's max and sum with shuffles, then
// accumulates P.V with lanes over the head dimension.  In causal mode
// tiles and 32-key chunks above the diagonal are skipped outright.
// Shared memory: (16*D + 64*(D+1) + 64*D) * 4 bytes, 147,712 at D = 256.
// Both launchers raise the dynamic shared-memory limit above 48 KB.

#include <type_traits>

#include "common.cuh"
#include "flash_tc.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 2;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 16 query rows per block
constexpr int kBlockK = 64;                      // keys per staged tile

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kBlockQ) * D + size_t(kBlockK) * (D + 1) + size_t(kBlockK) * D);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int S, int causal, float scale) {
  constexpr int KS = D + 1;  // padded K row stride (bank-conflict free)
  constexpr int E = D / 32;  // accumulator elements per lane: d = lane + 32*e
  extern __shared__ float smem[];
  float* Qs = smem;               // [kBlockQ][D]
  float* Ks = Qs + kBlockQ * D;   // [kBlockK][KS]
  float* Vs = Ks + kBlockK * KS;  // [kBlockK][D]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t base = size_t(bh) * S * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < kBlockQ * D; i += blockDim.x)
    Qs[i] = q[base + size_t(q0) * D + i];

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][E];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = pt::kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  // causal: key tiles starting past the tile's last query row are dead
  const int k_end = causal ? min(S, q0 + kBlockQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    for (int i = tid; i < kBlockK * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const size_t g = base + size_t(k0 + r) * D + c;
      Ks[r * KS + c] = k[g];
      Vs[i] = v[g];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      const int qi = q0 + row;
      const float* qrow = Qs + row * D;
      for (int c0 = 0; c0 < kBlockK; c0 += 32) {
        const int kj0 = k0 + c0;
        if (causal && kj0 > qi) break;  // warp-uniform: chunk is dead
        const float* krow = Ks + (c0 + lane) * KS;
        float s = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
        s *= scale;
        if (causal && kj0 + lane > qi) s = pt::kNegInf;
        const float m_new = fmaxf(m[r], pt::warp_max(s));
        const float alpha = expf(m[r] - m_new);
        const float p = expf(s - m_new);
        l[r] = l[r] * alpha + pt::warp_sum(p);
        m[r] = m_new;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
#pragma unroll 4
        for (int jj = 0; jj < 32; ++jj) {
          const float pj = __shfl_sync(pt::kFullMask, p, jj);
          const float* vrow = Vs + (c0 + jj) * D;
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[r][e] = fmaf(pj, vrow[lane + 32 * e], acc[r][e]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int e = 0; e < E; ++e)
      o[base + size_t(qi) * D + lane + 32 * e] = acc[r][e] * inv;
    if (lane == 0) lse[size_t(bh) * S + qi] = m[r] + logf(l_safe);
  }
}

// K1 in 16-bit T (bf16 or f16) on the tensor cores: one block per (b*h,
// 64-row query tile)
template <typename T, int D>
__global__ void __launch_bounds__(128)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int causal, float scale) {
  using namespace pt::flash;
  constexpr int ld = D + kPad;
  constexpr int KD = D / 16;     // 16-deep steps of Q K^T
  constexpr int NO = D / 8;      // n-tiles of O
  constexpr int NS = kTile / 8;  // n-tiles of S
  constexpr bool kQRegs = D <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [kTile][ld]
  T* Ks = Qs + kTile * ld;                 // [2][kTile][ld]
  T* Vs = Ks + 2 * kTile * ld;             // [2][kTile][ld]

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest (causal) first
  const int q0 = qt * kTile;
  const size_t base = size_t(bh) * S * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;  // the warp's first row in the tile
  const int n_tiles = causal ? qt + 1 : S / kTile;

  load_tile<D>(Qs, q + base + size_t(q0) * D);
  load_tile<D>(Ks, k + base);
  load_tile<D>(Vs, v + base);
  pt::tc::cp_async_commit();

  // rows wr + g (index 0) and wr + g + 8 (index 1) of the tile
  float acc[NO][4], m[2] = {pt::kNegInf, pt::kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qf[kQRegs ? KD : 1][4];

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      const int slot = (j + 1) & 1;
      const size_t at = base + size_t(j + 1) * kTile * D;
      load_tile<D>(Ks + slot * kTile * ld, k + at);
      load_tile<D>(Vs + slot * kTile * ld, v + at);
    }
    pt::tc::cp_async_commit();
    pt::tc::cp_async_wait<1>();  // tile j (and Q) has landed
    __syncthreads();
    if (kQRegs && j == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) ldsm_a(qf[kd], Qs, ld, wr, kd * 16);
    }
    const T* ks = Ks + (j & 1) * kTile * ld;
    const T* vs = Vs + (j & 1) * kTile * ld;

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[4];
      if (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kQRegs ? kd : 0][e];
      } else {
        ldsm_a(a, Qs, ld, wr, kd * 16);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        ldsm_b_rows(b, ks, ld, np * 16, kd * 16);
        mma16<T>(s[2 * np], a, b[0], b[1]);
        mma16<T>(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // the online softmax on the fragments; the diagonal tile is masked
    const bool diag = causal && j == qt;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (diag && n * 8 + 2 * t + (e & 1) > wr + g + (e >> 1) * 8)
          x = pt::kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += T(P) V, P's fragments reused as A
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      c_to_a<T>(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t b[4];
        ldsm_b_cols(b, vs, ld, kk * 16, np * 16);
        mma16<T>(acc[2 * np], a, b[0], b[1]);
        mma16<T>(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // slot j & 1 is free for tile j + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + g + i * 8;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + base + size_t(row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store_x2<T>(orow + n * 8, acc[n][2 * i] / l_safe,
                  acc[n][2 * i + 1] / l_safe);
    if (t == 0) lse[size_t(bh) * S + row] = m[i] + logf(l_safe);
  }
}

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(pt::flash::bf16) * size_t(pt::flash::kTile) * 5 *
         (D + pt::flash::kPad);
}

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  int bh, s, causal;
  float scale;
  cudaStream_t stream;
};

// K1: the tensor-core kernel in bf16 and f16, the scalar one in f32
template <typename T, int D>
cudaError_t launch(const Args& a) {
  if constexpr (sizeof(T) == 2) {
    constexpr size_t smem = mma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return err;
    dim3 grid(a.bh, a.s / pt::flash::kTile);
    flash_fwd_mma_kernel<T, D><<<grid, 128, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.o),
        static_cast<float*>(a.lse), a.s, a.causal, a.scale);
  } else {
    constexpr size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return err;
    dim3 grid(a.s / kBlockQ, a.bh);
    flash_fwd_kernel<D><<<grid, kWarps * 32, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.o),
        static_cast<float*>(a.lse), a.s, a.causal, a.scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int d) {
  switch (d) {
    case 64:
      return launch<T, 64>(a);
    case 128:
      return launch<T, 128>(a);
    case 256:
      return launch<T, 256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: [bh, s, d] contiguous in `dtype`; lse: [bh, s] float32.
// Needs s % 64 == 0 (the wrapper enforces s % 128 == 0), d in {64, 128,
// 256} and, in bf16 and f16, 16-byte aligned q, k, v, o (the wrapper
// checks).  float32 runs the scalar kernel, bfloat16 and float16 the
// tensor-core kernel.
// Returns cudaGetLastError() after the launch.
extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int s, int d,
                            int dtype, int causal, float scale,
                            void* stream) {
  if (s % kBlockK != 0 || bh < 1 || bh > 65535) return cudaErrorInvalidValue;
  const Args a{q, k, v, o, lse, bh, s, causal, scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == pt::kFloat32)
    err = dispatch_d<float>(a, d);
  else if (dtype == pt::kBFloat16)
    err = dispatch_d<pt::flash::bf16>(a, d);
  else if (dtype == pt::kFloat16)
    err = dispatch_d<pt::flash::f16>(a, d);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}
