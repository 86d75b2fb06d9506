// K2 / K3: flash-attention backward for Hopper (sm_90a).
//
// Replaces paddle_tpu/kernels/flash_attention.py `_bwd_dq_kernel` (K2)
// and `_bwd_dkv_kernel` (K3), driven by `_bwd_core`.
//
// The FA-2 backward over [B, H, S, D] inputs with an optional causal mask
// (-1e30).  P is recomputed from the forward's f32 row logsumexp,
// p = exp(s - lse), and delta = rowsum(dO * O) (f32) arrives precomputed
// by the caller, as in the reference; the lse cotangent of
// `flash_attention_with_lse` folds into delta - dlse, so these kernels
// serve both public functions unchanged.  With ds = p * (dp - delta) *
// scale and dp = dO . V^T:
//   K2  dQ = sum_k ds K                     (one block per query tile)
//   K3  dV = sum_q p^T dO, dK = sum_q ds^T Q (one block per key tile)
// Two kernels and no atomics, so the result is deterministic.
//
// Design.  K1's layout (csrc/flash_attention.cu): 8 warps per block, each
// warp owning 2 rows of the block's 16-row tile; the other side streams
// through shared memory in 64-row tiles converted to f32 on load.  For
// the dot products (s = q.k, dp = dO.v) a lane takes one row of the
// streamed tile and reads its own row padded to D+1 floats, so the 32
// lanes hit 32 banks while the warp's own row is a broadcast; for the
// accumulators lanes run over the head dimension (d = lane + 32 e) and
// the per-row weights (ds, p) are broadcast with shuffles.  Accumulators
// stay in f32 registers; outputs are written once in the input dtype.
// Causal: K2 stops at the diagonal tile and skips 32-key chunks past the
// row; K3 starts at the query tile that holds its first key and skips
// 32-query chunks above the diagonal.  Heavy causal tiles are scheduled
// first (K2 walks its query tiles from the last; K3's key tile 0 is its
// heaviest), and (b*h) rides blockIdx.x so it is not held to 65535.
// p and ds stay in f32 where the Pallas kernels round them to bf16 for
// the MXU.
//
// Bound on the H100: like K1 this is scalar f32 FMA work on the CUDA
// cores, 3 (K2) and 4 (K3) FMAs per (query, key, d) with a shared-memory
// load per FMA; it is bound by those operations and by shared-memory
// bandwidth, far from the device-memory bound (q, k, v, dO read once,
// dq/dk/dv written once).  Tensor cores (mma.sync / wgmma), TMA and
// pipelined loads are later work; this version is the simple, exact one.
//
// Shared memory: (2*16*D + 2*64*(D+1) + 2*64) * 4 bytes, 164,864 at
// D = 256, above the 48 KB default, so the launchers raise the dynamic
// limit (the SM's 227 KB hold it).

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 2;
constexpr int kBlockRows = kWarps * kRowsPerWarp;  // 16 own rows per block
constexpr int kBlockCols = 64;                     // rows per streamed tile

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * size_t(kBlockRows) * D +
                          2 * size_t(kBlockCols) * (D + 1) +
                          2 * size_t(kBlockCols));
}

// K2: dQ for one (b*h, 16-row query tile).
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int causal, float scale) {
  constexpr int KS = D + 1;  // padded row stride of the streamed tiles
  constexpr int E = D / 32;
  extern __shared__ float smem[];
  float* Qs = smem;                      // [kBlockRows][D]
  float* dOs = Qs + kBlockRows * D;      // [kBlockRows][D]
  float* Ks = dOs + kBlockRows * D;      // [kBlockCols][KS]
  float* Vs = Ks + kBlockCols * KS;      // [kBlockCols][KS]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;  // heavy first
  const size_t base = size_t(bh) * S * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < kBlockRows * D; i += blockDim.x) {
    const size_t g = base + size_t(q0) * D + i;
    Qs[i] = pt::to_f32(q[g]);
    dOs[i] = pt::to_f32(dout[g]);
  }
  float row_lse[kRowsPerWarp], row_delta[kRowsPerWarp];
  float acc[kRowsPerWarp][E];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    row_lse[r] = lse[size_t(bh) * S + qi];
    row_delta[r] = delta[size_t(bh) * S + qi];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  // causal: key tiles starting past the tile's last query row are dead
  const int k_end = causal ? min(S, q0 + kBlockRows) : S;
  for (int k0 = 0; k0 < k_end; k0 += kBlockCols) {
    __syncthreads();  // the previous tile is consumed (and Qs/dOs written)
    for (int i = tid; i < kBlockCols * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const size_t g = base + size_t(k0 + r) * D + c;
      Ks[r * KS + c] = pt::to_f32(k[g]);
      Vs[r * KS + c] = pt::to_f32(v[g]);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      const int qi = q0 + row;
      const float* qrow = Qs + row * D;
      const float* dorow = dOs + row * D;
      for (int c0 = 0; c0 < kBlockCols; c0 += 32) {
        const int kj0 = k0 + c0;
        if (causal && kj0 > qi) break;  // warp-uniform: chunk is dead
        const float* krow = Ks + (c0 + lane) * KS;
        const float* vrow = Vs + (c0 + lane) * KS;
        float s = 0.f, dp = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          s = fmaf(qrow[d], krow[d], s);
          dp = fmaf(dorow[d], vrow[d], dp);
        }
        s *= scale;
        if (causal && kj0 + lane > qi) s = pt::kNegInf;
        const float p = expf(s - row_lse[r]);
        const float ds = p * (dp - row_delta[r]) * scale;
#pragma unroll 4
        for (int jj = 0; jj < 32; ++jj) {
          const float dsj = __shfl_sync(pt::kFullMask, ds, jj);
          const float* kr = Ks + (c0 + jj) * KS;
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[r][e] = fmaf(dsj, kr[lane + 32 * e], acc[r][e]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
#pragma unroll
    for (int e = 0; e < E; ++e)
      dq[base + size_t(qi) * D + lane + 32 * e] = pt::from_f32<T>(acc[r][e]);
  }
}

// K3: dK and dV for one (b*h, 16-row key tile).
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int causal, float scale) {
  constexpr int QS = D + 1;  // padded row stride of the streamed tiles
  constexpr int E = D / 32;
  extern __shared__ float smem[];
  float* Ks = smem;                      // [kBlockRows][D]
  float* Vs = Ks + kBlockRows * D;       // [kBlockRows][D]
  float* Qs = Vs + kBlockRows * D;       // [kBlockCols][QS]
  float* dOs = Qs + kBlockCols * QS;     // [kBlockCols][QS]
  float* Ls = dOs + kBlockCols * QS;     // [kBlockCols] lse
  float* Dl = Ls + kBlockCols;           // [kBlockCols] delta

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockRows;  // tile 0 is the heaviest (causal)
  const size_t base = size_t(bh) * S * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < kBlockRows * D; i += blockDim.x) {
    const size_t g = base + size_t(k0) * D + i;
    Ks[i] = pt::to_f32(k[g]);
    Vs[i] = pt::to_f32(v[g]);
  }
  float acc_k[kRowsPerWarp][E], acc_v[kRowsPerWarp][E];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      acc_k[r][e] = 0.f;
      acc_v[r][e] = 0.f;
    }
  }

  // causal: query tiles ending before the block's first key are dead
  const int q_begin = causal ? (k0 / kBlockCols) * kBlockCols : 0;
  for (int q0 = q_begin; q0 < S; q0 += kBlockCols) {
    __syncthreads();  // the previous tile is consumed (and Ks/Vs written)
    for (int i = tid; i < kBlockCols * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const size_t g = base + size_t(q0 + r) * D + c;
      Qs[r * QS + c] = pt::to_f32(q[g]);
      dOs[r * QS + c] = pt::to_f32(dout[g]);
    }
    for (int i = tid; i < kBlockCols; i += blockDim.x) {
      Ls[i] = lse[size_t(bh) * S + q0 + i];
      Dl[i] = delta[size_t(bh) * S + q0 + i];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      const int kj = k0 + row;
      const float* krow = Ks + row * D;
      const float* vrow = Vs + row * D;
      for (int c0 = 0; c0 < kBlockCols; c0 += 32) {
        const int qi0 = q0 + c0;
        if (causal && qi0 + 31 < kj) continue;  // warp-uniform: all above
        const float* qrow = Qs + (c0 + lane) * QS;
        const float* dorow = dOs + (c0 + lane) * QS;
        float s = 0.f, dp = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          s = fmaf(qrow[d], krow[d], s);
          dp = fmaf(dorow[d], vrow[d], dp);
        }
        s *= scale;
        if (causal && qi0 + lane < kj) s = pt::kNegInf;
        const float p = expf(s - Ls[c0 + lane]);
        const float ds = p * (dp - Dl[c0 + lane]) * scale;
#pragma unroll 4
        for (int jj = 0; jj < 32; ++jj) {
          const float pj = __shfl_sync(pt::kFullMask, p, jj);
          const float dsj = __shfl_sync(pt::kFullMask, ds, jj);
          const float* qr = Qs + (c0 + jj) * QS;
          const float* dr = dOs + (c0 + jj) * QS;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            acc_v[r][e] = fmaf(pj, dr[lane + 32 * e], acc_v[r][e]);
            acc_k[r][e] = fmaf(dsj, qr[lane + 32 * e], acc_k[r][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int kj = k0 + warp * kRowsPerWarp + r;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const size_t o = base + size_t(kj) * D + lane + 32 * e;
      dk[o] = pt::from_f32<T>(acc_k[r][e]);
      dv[o] = pt::from_f32<T>(acc_v[r][e]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;  // dq (K2) or dk, dv (K3)
  int bh, s, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(a.bh, a.s / kBlockRows);
  flash_bwd_dq_kernel<T, D><<<grid, kWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.s, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(a.bh, a.s / kBlockRows);
  flash_bwd_dkv_kernel<T, D><<<grid, kWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.s, a.causal,
      a.scale);
  return cudaGetLastError();
}

template <bool kDq, typename T>
cudaError_t dispatch_d(const Args& a, int d) {
  switch (d) {
    case 64:
      return kDq ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128:
      return kDq ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    case 256:
      return kDq ? launch_dq<T, 256>(a) : launch_dkv<T, 256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kDq>
int run(const Args& a, int d, int dtype) {
  if (a.s % kBlockCols != 0 || a.s / kBlockRows > 65535 || a.bh < 1)
    return int(cudaErrorInvalidValue);
  if (dtype == pt::kFloat32) return int(dispatch_d<kDq, float>(a, d));
  if (dtype == pt::kBFloat16)
    return int(dispatch_d<kDq, __nv_bfloat16>(a, d));
  return int(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, dout, dq: [bh, s, d] contiguous in `dtype`; lse, delta: [bh, s]
// float32 (delta = rowsum(dout * out) - dlse).  Needs s % 64 == 0 (the
// wrapper enforces s % 128 == 0) and d in {64, 128, 256}.  Each entry
// returns cudaGetLastError() after its launch.
extern "C" int pt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int s,
                               int d, int dtype, int causal, float scale,
                               void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, bh, s, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return run<true>(a, d, dtype);
}

// as pt_flash_bwd_dq; writes dk and dv ([bh, s, d] in `dtype`).
extern "C" int pt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int bh,
                                int s, int d, int dtype, int causal,
                                float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, bh, s, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return run<false>(a, d, dtype);
}
