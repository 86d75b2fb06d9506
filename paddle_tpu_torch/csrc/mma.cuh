// The tensor-core tile product of the port's Hopper kernels: K7's and
// K8's (csrc/block_tc.cuh), and the probes P1/P2 that run K7's pieces
// (csrc/fused_bottleneck.cu).
//
// `product` computes C[m, n] = sum_k A(m, k) B(k, n) for m < M, n < N, k <
// K over a 256-thread block and hands every element to an epilogue.  The
// operands are read through functors that return a pointer to one
// element, or nullptr where the operand is zero (padding, a partial edge):
//   a(m, k), b(k, n)  ->  const T*
// A is stored row-major ("MK", k contiguous where the functor points) or
// k-major ("KM", m contiguous); B k-major ("KN", n contiguous) or
// n-major ("NK", k contiguous).  The block's output tile is kBM x kBN =
// 64 x 128; K streams through shared memory in kBK = 32 chunks.
//
// bf16: operands stay bf16 in shared memory and the product runs on the
// tensor cores, mma.sync.aligned.m16n8k16 (f32 accumulate) fed by
// ldmatrix (.trans for the KM / KN layouts).  Each of the 8 warps owns 16
// of the 128 columns and all 64 rows, as four 16-row fragments; a fragment
// at or past M is skipped, so M pads to 16, not 64.  A tile of at most 64
// columns (N = 64: the stride-1 block's Cm at ResNet-50's stage 1) would
// leave half the warps idle, so there each warp owns 16 of the 64 columns
// and 32 of the rows (two fragments).  Each mma starts from
// a zero accumulator and its 16-deep result is added to the element's sum
// by an f32 add (round to nearest): the tensor core's own accumulation
// rounds differently (measured on the H100: twice the plain f32 version's
// error against float64 products when it ran over the whole K), and the
// bf16 roundings and relu masks downstream amplify it.  A chunk arrives by
// cp.async (16 bytes a thread) into a ring of kStages slots, so the next
// chunks load while the current one multiplies.  An A operand that already
// lies in shared memory ("resident": a tile of activations the block made)
// is not staged: each ldmatrix lane points straight at the row the
// functor names (a 16-byte zero row stands for nullptr), so an implicit
// GEMM (im2col) reads its taps without a copy.
//
// f32: the same tiles, ring and functors, and an exact f32 inner product on
// the CUDA cores (fmaf in k order, one accumulator per element; never
// TF32): each thread owns a 4 x 8 patch of the tile.
//
// Loads are 16-byte groups (8 bf16 or 4 f32 along the contiguous index)
// when `vec` is set: the caller sets it only when every contiguous extent
// is a multiple of the group and every base pointer is 16-byte aligned, so
// a group never straddles an edge.  Otherwise every element is loaded on
// its own (any channel count).  Rows of each staged tile are padded by 16
// bytes, so the 8 rows an ldmatrix reads fall in different banks.
//
// `product` starts with a barrier, so its loaders may read what an
// earlier epilogue wrote to shared or device memory; an epilogue must not
// write what its own loaders read.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace pt {
namespace tc {

constexpr int kThreads = 256;
constexpr int kBM = 64;
constexpr int kBN = 128;
constexpr int kBK = 32;

template <typename T>
struct Cfg {
  static constexpr int kVec = 16 / int(sizeof(T));   // elements per group
  static constexpr int kPad = kVec;                  // 16 bytes per row
  static constexpr int kStages = sizeof(T) == 2 ? 3 : 2;
  // a slot holds either layout of its operand
  static constexpr int kASlot = kBM * (kBK + kPad) > kBK * (kBM + kPad)
                                    ? kBM * (kBK + kPad)
                                    : kBK * (kBM + kPad);
  static constexpr int kBSlot = kBN * (kBK + kPad) > kBK * (kBN + kPad)
                                    ? kBN * (kBK + kPad)
                                    : kBK * (kBN + kPad);
  // the ring plus a 16-byte zero row
  static constexpr size_t kRingBytes =
      size_t(kStages) * (kASlot + kBSlot) * sizeof(T) + 16;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  if (kTrans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p))
        : "memory");
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p))
        : "memory");
  }
}

// c += a b, a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One operand's chunk into its slot, stored [kOuter][kInner + pad] (MK: m,
// k; KM: k, m; KN: k, n; NK: n, k); `at(outer, inner)` is the element's
// pointer or nullptr.  A source in shared memory is copied at once (the
// f32 resident A), one in device memory by cp.async.
template <typename T, bool kSrcShared, int kOuter, int kInner, class At>
__device__ __forceinline__ void load_tile(T* slot, bool vec, const At& at) {
  constexpr int V = Cfg<T>::kVec;
  constexpr int ld = kInner + Cfg<T>::kPad;
  constexpr int groups = kOuter * (kInner / V);
  for (int i = threadIdx.x; i < groups; i += kThreads) {
    const int o = i / (kInner / V), c = (i % (kInner / V)) * V;
    T* dst = slot + o * ld + c;
    if (vec) {
      const T* src = at(o, c);
      if (src == nullptr) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      } else if (kSrcShared) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        cp_async16(dst, src);
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const T* src = at(o, c + e);
        dst[e] = src == nullptr ? from_f32<T>(0.f) : *src;
      }
    }
  }
}

// The ring's 16-byte zero row; a kernel calls this once before its first
// product (the product's leading barrier publishes it).
template <typename T>
__device__ __forceinline__ void zero_row(T* ring) {
  using C = Cfg<T>;
  if (threadIdx.x == 0)
    *reinterpret_cast<uint4*>(ring + C::kStages * (C::kASlot + C::kBSlot)) =
        make_uint4(0, 0, 0, 0);
}

template <typename T, bool kAKOuter, bool kBKOuter, bool kARes, class AF,
          class BF, class Epi>
__device__ void product(int M, int N, int K, bool vec, const AF& a,
                        const BF& b, const Epi& epi, T* ring) {
  using C = Cfg<T>;
  constexpr int S = C::kStages;
  constexpr bool kMma = sizeof(T) == 2;
  T* const As = ring;
  T* const Bs = ring + S * C::kASlot;
  const T* const zero =
      reinterpret_cast<const T*>(ring + S * (C::kASlot + C::kBSlot));
  // bf16 resident A (16-byte groups) feeds ldmatrix from where it lies
  const bool direct_a = kMma && kARes && vec;
  const int nk = (K + kBK - 1) / kBK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int m0 = 0; m0 < M; m0 += kBM) {
    for (int n0 = 0; n0 < N; n0 += kBN) {
      auto load = [&](int kc, int slot) {
        const int k0 = kc * kBK;
        if (!direct_a) {
          T* as = As + slot * C::kASlot;
          if (kAKOuter) {
            load_tile<T, kARes, kBK, kBM>(as, vec, [&](int k, int m) {
              return (m0 + m < M && k0 + k < K) ? a(m0 + m, k0 + k)
                                                : static_cast<const T*>(nullptr);
            });
          } else {
            load_tile<T, kARes, kBM, kBK>(as, vec, [&](int m, int k) {
              return (m0 + m < M && k0 + k < K) ? a(m0 + m, k0 + k)
                                                : static_cast<const T*>(nullptr);
            });
          }
        }
        T* bs = Bs + slot * C::kBSlot;
        if (kBKOuter) {
          load_tile<T, false, kBK, kBN>(bs, vec, [&](int k, int n) {
            return (n0 + n < N && k0 + k < K) ? b(k0 + k, n0 + n)
                                              : static_cast<const T*>(nullptr);
          });
        } else {
          load_tile<T, false, kBN, kBK>(bs, vec, [&](int n, int k) {
            return (n0 + n < N && k0 + k < K) ? b(k0 + k, n0 + n)
                                              : static_cast<const T*>(nullptr);
          });
        }
      };

      // the previous tile's readers are done with the ring, and what the
      // caller wrote before this call is visible
      __syncthreads();
#pragma unroll
      for (int s = 0; s < S - 1; ++s) {
        if (s < nk) load(s, s);
        cp_async_commit();
      }

      if (kMma) {
        // warp w: columns n0 + 16 w .. + 15, all 64 rows (fragments 0-3);
        // in a tile of at most 64 columns, columns n0 + 16 (w % 4) .. + 15
        // and fragments 2 (w / 4), + 1
        float acc[4][2][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
        const bool narrow = N - n0 <= kBN / 2;
        const int wn = narrow ? (warp & 3) * 16 : warp * 16;
        const int f0 = narrow ? (warp >> 2) * 2 : 0;
        const int nf = narrow ? 2 : 4;
        const bool live = n0 + wn < N;
        for (int kc = 0; kc < nk; ++kc) {
          cp_async_wait<S - 2>();
          __syncthreads();
          if (kc + S - 1 < nk) load(kc + S - 1, (kc + S - 1) % S);
          cp_async_commit();
          if (!live) continue;
          const int slot = kc % S;
          const T* as = As + slot * C::kASlot;
          const T* bs = Bs + slot * C::kBSlot;
          const int li = lane & 7, lm = lane >> 3;
#pragma unroll
          for (int kk = 0; kk < kBK; kk += 16) {
            uint32_t bf[4];
            if (kBKOuter) {
              ldsm_x4<true>(bf, bs + (kk + li + (lm & 1) * 8) *
                                         (kBN + C::kPad) +
                                     wn + (lm >> 1) * 8);
            } else {
              ldsm_x4<false>(bf, bs + (wn + li + (lm >> 1) * 8) *
                                          (kBK + C::kPad) +
                                      kk + (lm & 1) * 8);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int mf = f0 + i;
              if (i >= nf || m0 + mf * 16 >= M) continue;
              uint32_t af[4];
              if (direct_a) {
                const int m = m0 + mf * 16 + li + (lm & 1) * 8;
                const int k = kc * kBK + kk + (lm >> 1) * 8;
                const T* p = (m < M && k < K) ? a(m, k) : nullptr;
                ldsm_x4<false>(af, p == nullptr ? zero : p);
              } else if (kAKOuter) {
                ldsm_x4<true>(af, as + (kk + li + (lm >> 1) * 8) *
                                           (kBM + C::kPad) +
                                       mf * 16 + (lm & 1) * 8);
              } else {
                ldsm_x4<false>(af, as + (mf * 16 + li + (lm & 1) * 8) *
                                            (kBK + C::kPad) +
                                        kk + (lm >> 1) * 8);
              }
              // each 16-deep product starts from zero and is added to
              // the sum with an f32 add (round to nearest), so the tensor
              // core's own accumulation does not run over the whole K
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                float part[4] = {0.f, 0.f, 0.f, 0.f};
                mma_bf16(part, af, bf[2 * nt], bf[2 * nt + 1]);
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][nt][e] += part[e];
              }
            }
          }
        }
        if (live) {
          const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int m = m0 + (f0 + i) * 16 + g + (e >> 1) * 8;
                const int n = n0 + wn + nt * 8 + t2 + (e & 1);
                if (i < nf && m < M && n < N) epi(m, n, acc[i][nt][e]);
              }
        }
      } else {
        // CUDA cores: thread (tm, tn) owns rows 4 tm .. +3, columns 8 tn .. +7
        float acc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
        const int tm = tid >> 4, tn = tid & 15;
        for (int kc = 0; kc < nk; ++kc) {
          cp_async_wait<S - 2>();
          __syncthreads();
          if (kc + S - 1 < nk) load(kc + S - 1, (kc + S - 1) % S);
          cp_async_commit();
          const int slot = kc % S;
          const T* as = As + slot * C::kASlot;
          const T* bs = Bs + slot * C::kBSlot;
          for (int kk = 0; kk < kBK; ++kk) {
            float av[4], bv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int m = tm * 4 + i;
              av[i] = to_f32(kAKOuter ? as[kk * (kBM + C::kPad) + m]
                                      : as[m * (kBK + C::kPad) + kk]);
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int n = tn * 8 + j;
              bv[j] = to_f32(kBKOuter ? bs[kk * (kBN + C::kPad) + n]
                                      : bs[n * (kBK + C::kPad) + kk]);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int m = m0 + tm * 4 + i, n = n0 + tn * 8 + j;
            if (m < M && n < N) epi(m, n, acc[i][j]);
          }
      }
    }
  }
}

}  // namespace tc
}  // namespace pt
