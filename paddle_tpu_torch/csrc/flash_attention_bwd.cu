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
// In bf16 and f16 (T, the 16-bit type: the kernels are templates over
// it, csrc/flash_tc.cuh) both run on the tensor cores (mma.sync.m16n8k16 fed by
// ldmatrix, csrc/flash_tc.cuh on csrc/mma.cuh), one block per (b*h,
// 64-row tile) with (b*h) on blockIdx.x, each warp owning 16 rows of the
// block's resident side; the other side streams in 64-row tiles through a
// 2-slot cp.async ring.  p and ds round to T where the reference
// rounds them (`p.astype(do.dtype)`, `ds.astype(q.dtype)`), in registers:
// the C fragments of one product are the A fragments of the next
// (flash_tc.cuh has the map), so p and ds never touch shared memory.  The
// long sums (dQ; dK, dV) stay in f32 registers, accumulated in the mma
// (flash_tc.cuh says why), and are written once.  Registers: a warp's
// accumulator for 16 rows is D / 2 f32 per thread per output, 128 at D =
// 256, more than a thread has beside the products.  At D = 256 the block
// has 8 warps, two per 16 rows, each owning a 128-column slice of the
// outputs; both compute the two score products over all of D (that share
// of the work twice, with no exchange through shared memory and no extra
// barrier).  At D >= 128 the score products run over the streamed tile in
// two 32-row halves, so each takes 16 f32 per thread.
//
// K2 in bf16 and f16 (`flash_bwd_dq_mma_kernel`): Q and dO resident, each warp's
// rows' lse and delta in registers; K and V stream, from key tile 0 to
// the last (causal: to the diagonal tile, the only one masked, by the
// reference's rule that a tile is live iff (qi + 1) bq > ki bk; the
// heaviest query tile, the last, is scheduled first).  Per key tile:
//   S = Q K^T;  P = exp(S * scale - lse[row]);  dP = dO V^T;
//   dS = P (dP - delta[row]) * scale;  dQ += bf16(dS) K,
// K read transposed for the last (ldmatrix.trans), so each K tile feeds
// two products.  Shared memory: (2 + 2 * 2) * 64 * (D + 8) * 2 bytes,
// 202,752 at D = 256.
//
// K3 in bf16 and f16 (`flash_bwd_dkv_mma_kernel`), computed transposed so that no
// fragment needs a transpose: K and V resident; Q, dO, lse and delta
// stream, from the first query tile that reaches the block's keys
// (causal: the diagonal tile, the only one masked; key tile 0, the
// heaviest, is scheduled first).  Per query tile:
//   S^T = K Q^T;  P^T = exp(S^T * scale - lse[col]);
//   dV += bf16(P^T) dO;  dP^T = V dO^T;
//   dS^T = P^T (dP^T - delta[col]) * scale;  dK += bf16(dS^T) Q.
// Shared memory: (2 + 2 * 2) * 64 * (D + 8) * 2 + 2 * 2 * 64 * 4 bytes,
// 203,776 at D = 256.
//
// Bound on the H100: at the train shape the least time is the bytes' (K2:
// q, k, v, dO, lse, delta read and dq written once, 0.0571 ms; K3: dk and
// dv written, 0.0683 ms; the products, 29.0 and 38.7 GFLOP, take 0.029
// and 0.039 ms at 989 TFLOP/s), but mma.sync from 4 warps reaches a
// fraction of the tensor cores' rate and the exponentials run on the CUDA
// cores, so the products and the elementwise work between them bound it
// in practice; wgmma fed by TMA is the next step.
//
// f32: scalar kernels on the CUDA cores (exact FMAs, never TF32).  K1's
// old layout (8 warps per block, each warp owning 2 rows of the block's
// 16-row tile); the other side streams through shared memory in 64-row
// tiles.  For the dot products (s = q.k, dp = dO.v) a lane takes one row
// of the streamed tile and reads its own row padded to D+1 floats, so the
// 32 lanes hit 32 banks while the warp's own row is a broadcast; for the
// accumulators lanes run over the head dimension (d = lane + 32 e) and
// the per-row weights (ds, p) are broadcast with shuffles.  Accumulators
// stay in f32 registers; outputs are written once.  Causal: K2 stops at
// the diagonal tile and skips 32-key chunks past the row; K3 starts at
// the query tile that holds its first key and skips 32-query chunks above
// the diagonal.  Heavy causal tiles are scheduled first (K2 walks its
// query tiles from the last; K3's key tile 0 is its heaviest), and (b*h)
// rides blockIdx.x so it is not held to 65535.  They are 3 (K2) and 4
// (K3) FMAs per (query, key, d) with a shared-memory load per FMA, bound
// by those operations and by shared-memory bandwidth.  Shared memory:
// (2*16*D + 2*64*(D+1) + 2*64) * 4 bytes, 164,864 at D = 256, above the
// 48 KB default, so the launchers raise the dynamic limit (the SM's 227
// KB hold it).

#include <type_traits>

#include "common.cuh"
#include "flash_tc.cuh"

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

// K2 in f32: dQ for one (b*h, 16-row query tile).
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
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
    Qs[i] = q[g];
    dOs[i] = dout[g];
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
      Ks[r * KS + c] = k[g];
      Vs[r * KS + c] = v[g];
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
      dq[base + size_t(qi) * D + lane + 32 * e] = acc[r][e];
  }
}

// K3: dK and dV for one (b*h, 16-row key tile).
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int S, int causal, float scale) {
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
    Ks[i] = k[g];
    Vs[i] = v[g];
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
      Qs[r * QS + c] = q[g];
      dOs[r * QS + c] = dout[g];
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
      dk[o] = acc_k[r][e];
      dv[o] = acc_v[r][e];
    }
  }
}

// The tiles of the tensor-core kernels, K2 and K3 in bf16 and f16
template <int D>
struct BwdMma {
  static constexpr int kSplit = D > 128 ? 2 : 1;  // warps per 16 rows
  static constexpr int kThreads = 4 * kSplit * 32;
  static constexpr int kSlice = D / kSplit;       // output columns a warp owns
  static constexpr int kSub = D > 64 ? 32 : 64;   // streamed rows per pass
  static constexpr int ld = D + pt::flash::kPad;
  static constexpr size_t kTileBytes =
      2 * size_t(pt::flash::kTile) * ld;  // 16-bit elements
  // K2: Q, dO resident; two slots of K, V
  static constexpr size_t kSmemDq = 6 * kTileBytes;
  // K3: K, V resident; two slots of Q, dO; two slots of lse, delta
  static constexpr size_t kSmemDkv =
      6 * kTileBytes + 4 * pt::flash::kTile * sizeof(float);
};

// K2 in 16-bit T (bf16 or f16) on the tensor cores: one block per (b*h,
// 64-row query tile).  dQ accumulates in the mma itself, as K1's O and
// K3's dK, dV do.
template <typename T, int D>
__global__ void __launch_bounds__(BwdMma<D>::kThreads)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int S, int causal, float scale) {
  using namespace pt::flash;
  using C = BwdMma<D>;
  constexpr int ld = C::ld;
  constexpr int KD = D / 16;              // 16-deep steps of S, dP
  constexpr int NS = C::kSub / 8;         // n-tiles of S, dP
  constexpr int NA = C::kSlice / 8;       // n-tiles of the warp's dQ
  constexpr int kTileElems = kTile * ld;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [kTile][ld]
  T* dOs = Qs + kTileElems;                   // [kTile][ld]
  T* Ks = dOs + kTileElems;                   // [2][kTile][ld]
  T* Vs = Ks + 2 * kTileElems;                // [2][kTile][ld]

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest (causal) first
  const int q0 = qt * kTile;
  const size_t base = size_t(bh) * S * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp & 3) * 16;             // the warp's first query row
  const int c0 = (warp >> 2) * C::kSlice;     // its first dQ column
  const int n_tiles = causal ? qt + 1 : S / kTile;

  auto load_kv_tile = [&](int j, int slot) {
    const size_t at = base + size_t(j) * kTile * D;
    load_tile<D>(Ks + slot * kTileElems, k + at);
    load_tile<D>(Vs + slot * kTileElems, v + at);
  };
  load_tile<D>(Qs, q + base + size_t(q0) * D);
  load_tile<D>(dOs, dout + base + size_t(q0) * D);
  load_kv_tile(0, 0);
  pt::tc::cp_async_commit();

  // rows wr + g (index 0) and wr + g + 8 (index 1) of the tile
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t r = size_t(bh) * S + q0 + wr + g + i * 8;
    row_lse[i] = lse[r];
    row_delta[i] = delta[r];
  }
  float acc[NA][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_kv_tile(j + 1, (j + 1) & 1);
    pt::tc::cp_async_commit();
    pt::tc::cp_async_wait<1>();  // tile j (and Q, dO) has landed
    __syncthreads();
    const T* ks = Ks + (j & 1) * kTileElems;
    const T* vs = Vs + (j & 1) * kTileElems;
    const bool diag = causal && j == qt;

#pragma unroll 1
    for (int sub = 0; sub < kTile; sub += C::kSub) {
      // keys all past the warp's last row are masked: p = ds = 0
      if (diag && sub > wr + 15) continue;
      // S = Q K^T and dP = dO V^T: 16 query rows x kSub keys
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = 0.f;
          dp[n][e] = 0.f;
        }
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t a[4];
        ldsm_a(a, Qs, ld, wr, kd * 16);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t b[4];
          ldsm_b_rows(b, ks, ld, sub + np * 16, kd * 16);
          mma16<T>(s[2 * np], a, b[0], b[1]);
          mma16<T>(s[2 * np + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t a[4];
        ldsm_a(a, dOs, ld, wr, kd * 16);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t b[4];
          ldsm_b_rows(b, vs, ld, sub + np * 16, kd * 16);
          mma16<T>(dp[2 * np], a, b[0], b[1]);
          mma16<T>(dp[2 * np + 1], a, b[2], b[3]);
        }
      }
      // dS = P (dP - delta[row]) * scale with P = exp(S * scale -
      // lse[row]), in dp's registers; the diagonal tile is masked
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = sub + n * 8 + 2 * t + (e & 1);
          float x = s[n][e] * scale;
          if (diag && col > wr + g + (e >> 1) * 8) x = pt::kNegInf;
          const float p = expf(x - row_lse[e >> 1]);
          dp[n][e] = p * (dp[n][e] - row_delta[e >> 1]) * scale;
        }
      // dQ += T(dS) K: dS's fragments reused as A, K read transposed
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t a[4];
        c_to_a<T>(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < NA / 2; ++np) {
          uint32_t b[4];
          ldsm_b_cols(b, ks, ld, sub + kk * 16, c0 + np * 16);
          mma16<T>(acc[2 * np], a, b[0], b[1]);
          mma16<T>(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // slot j & 1 is free for tile j + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t at = base + size_t(q0 + wr + g + i * 8) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NA; ++n)
      store_x2<T>(dq + at + n * 8, acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// K3 in 16-bit T (bf16 or f16) on the tensor cores: one block per (b*h,
// 64-row key tile)
template <typename T, int D>
__global__ void __launch_bounds__(BwdMma<D>::kThreads)
flash_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int S, int causal, float scale) {
  using namespace pt::flash;
  using C = BwdMma<D>;
  constexpr int ld = C::ld;
  constexpr int KD = D / 16;              // 16-deep steps of S^T, dP^T
  constexpr int NS = C::kSub / 8;         // n-tiles of S^T, dP^T
  constexpr int NA = C::kSlice / 8;       // n-tiles of the warp's dK, dV
  constexpr int kTileElems = kTile * ld;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [kTile][ld]
  T* Vs = Ks + kTileElems;                    // [kTile][ld]
  T* Qs = Vs + kTileElems;                    // [2][kTile][ld]
  T* dOs = Qs + 2 * kTileElems;               // [2][kTile][ld]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * kTileElems);  // [2][kTile]
  float* Dl = Ls + 2 * kTile;                                  // [2][kTile]

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;  // key tile 0 is the heaviest (causal)
  const int k0 = kt * kTile;
  const size_t base = size_t(bh) * S * D;
  const float* lse_bh = lse + size_t(bh) * S;
  const float* delta_bh = delta + size_t(bh) * S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp & 3) * 16;             // the warp's first key row
  const int c0 = (warp >> 2) * C::kSlice;     // its first dK, dV column
  const int j0 = causal ? kt : 0;             // first live query tile
  const int n_tiles = S / kTile;

  auto load_q_tile = [&](int j, int slot) {
    const size_t at = base + size_t(j) * kTile * D;
    load_tile<D>(Qs + slot * kTileElems, q + at);
    load_tile<D>(dOs + slot * kTileElems, dout + at);
    load_row_stat(Ls + slot * kTile, lse_bh + j * kTile, 0);
    load_row_stat(Dl + slot * kTile, delta_bh + j * kTile, 32);
  };
  load_tile<D>(Ks, k + base + size_t(k0) * D);
  load_tile<D>(Vs, v + base + size_t(k0) * D);
  load_q_tile(j0, 0);
  pt::tc::cp_async_commit();

  float acc_k[NA][4], acc_v[NA][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[n][e] = 0.f;
      acc_v[n][e] = 0.f;
    }

  for (int j = j0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_q_tile(j + 1, (j + 1 - j0) & 1);
    pt::tc::cp_async_commit();
    pt::tc::cp_async_wait<1>();  // tile j (and K, V) has landed
    __syncthreads();
    const int slot = (j - j0) & 1;
    const T* qs = Qs + slot * kTileElems;
    const T* dos = dOs + slot * kTileElems;
    const float* ls = Ls + slot * kTile;
    const float* dls = Dl + slot * kTile;
    const bool diag = causal && j == kt;

#pragma unroll 1
    for (int sub = 0; sub < kTile; sub += C::kSub) {
      // S^T = K Q^T: 16 key rows x kSub queries
      float st[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[n][e] = 0.f;
          dp[n][e] = 0.f;
        }
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t a[4];
        ldsm_a(a, Ks, ld, wr, kd * 16);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t b[4];
          ldsm_b_rows(b, qs, ld, sub + np * 16, kd * 16);
          mma16<T>(st[2 * np], a, b[0], b[1]);
          mma16<T>(st[2 * np + 1], a, b[2], b[3]);
        }
      }
      // P^T = exp(S^T * scale - lse[col]); the diagonal tile is masked
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = sub + n * 8 + 2 * t + (e & 1);
          float x = st[n][e] * scale;
          if (diag && col < wr + g + (e >> 1) * 8) x = pt::kNegInf;
          st[n][e] = expf(x - ls[col]);
        }
      // dV += T(P^T) dO, P^T's fragments reused as A
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t a[4];
        c_to_a<T>(a, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < NA / 2; ++np) {
          uint32_t b[4];
          ldsm_b_cols(b, dos, ld, sub + kk * 16, c0 + np * 16);
          mma16<T>(acc_v[2 * np], a, b[0], b[1]);
          mma16<T>(acc_v[2 * np + 1], a, b[2], b[3]);
        }
      }
      // dP^T = V dO^T
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t a[4];
        ldsm_a(a, Vs, ld, wr, kd * 16);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t b[4];
          ldsm_b_rows(b, dos, ld, sub + np * 16, kd * 16);
          mma16<T>(dp[2 * np], a, b[0], b[1]);
          mma16<T>(dp[2 * np + 1], a, b[2], b[3]);
        }
      }
      // dS^T = P^T (dP^T - delta[col]) * scale, in dp's registers
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = sub + n * 8 + 2 * t + (e & 1);
          dp[n][e] = st[n][e] * (dp[n][e] - dls[col]) * scale;
        }
      // dK += T(dS^T) Q, dS^T's fragments reused as A
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t a[4];
        c_to_a<T>(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < NA / 2; ++np) {
          uint32_t b[4];
          ldsm_b_cols(b, qs, ld, sub + kk * 16, c0 + np * 16);
          mma16<T>(acc_k[2 * np], a, b[0], b[1]);
          mma16<T>(acc_k[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the slot is free for tile j + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t at = base + size_t(k0 + wr + g + i * 8) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NA; ++n) {
      store_x2<T>(dk + at + n * 8, acc_k[n][2 * i], acc_k[n][2 * i + 1]);
      store_x2<T>(dv + at + n * 8, acc_v[n][2 * i], acc_v[n][2 * i + 1]);
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

// K2: the tensor-core kernel in bf16 and f16, the scalar one in f32
template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  if constexpr (sizeof(T) == 2) {
    using C = BwdMma<D>;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_mma_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::kSmemDq));
    if (err != cudaSuccess) return err;
    dim3 grid(a.bh, a.s / pt::flash::kTile);
    flash_bwd_dq_mma_kernel<T, D><<<grid, C::kThreads, C::kSmemDq, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.out0), a.s, a.causal, a.scale);
  } else {
    constexpr size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return err;
    dim3 grid(a.bh, a.s / kBlockRows);
    flash_bwd_dq_kernel<D><<<grid, kWarps * 32, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.out0), a.s, a.causal, a.scale);
  }
  return cudaGetLastError();
}

// K3: the tensor-core kernel in bf16 and f16, the scalar one in f32
template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  if constexpr (sizeof(T) == 2) {
    using C = BwdMma<D>;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_mma_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::kSmemDkv));
    if (err != cudaSuccess) return err;
    dim3 grid(a.bh, a.s / pt::flash::kTile);
    flash_bwd_dkv_mma_kernel<T, D><<<grid, C::kThreads, C::kSmemDkv, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.s,
        a.causal, a.scale);
  } else {
    constexpr size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return err;
    dim3 grid(a.bh, a.s / kBlockRows);
    flash_bwd_dkv_kernel<D><<<grid, kWarps * 32, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.s,
        a.causal, a.scale);
  }
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
  if (dtype == pt::kFloat16) return int(dispatch_d<kDq, __half>(a, d));
  return int(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, dout, dq: [bh, s, d] contiguous in `dtype`; lse, delta: [bh, s]
// float32 (delta = rowsum(dout * out) - dlse).  Needs s % 64 == 0 (the
// wrapper enforces s % 128 == 0) and d in {64, 128, 256}; in bf16 and
// f16 every pointer 16-byte aligned (the wrapper checks).  Each entry returns
// cudaGetLastError() after its launch.
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
