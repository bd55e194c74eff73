// Tile helpers shared by the port's attention kernels (flash_attention.cu:
// K1, K2; block_sparse_attention.cu: K5, K6): 16-byte tile loads into
// padded shared memory and the warp-level products, on tensor cores
// (mma.sync m16n8k16 bf16, f32 accumulators) for bf16 and on CUDA cores
// in f32 (never TF32). One block is kWarps warps, each owning 16 rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <typename T>
__host__ __device__ constexpr bool is_bf16() {
  return std::is_same<T, bf16>::value;
}

// Shared-memory row stride in elements: 16 bytes of padding per row keeps
// the fragment loads of one warp on distinct banks and rows 16-byte aligned.
template <typename T, int D>
__host__ __device__ constexpr int row_stride() {
  return D + 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Rows [r0, r0 + ROWS) of a [rows, D] slice whose row stride is s_row
// elements into shared memory; rows at or past n_rows are zero-filled.
// Every row start is 16-byte aligned (checked by the wrapper).
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* sm, const T* g, long long s_row,
                                          int r0, int n_rows) {
  constexpr int EPV = 16 / static_cast<int>(sizeof(T));
  constexpr int VPR = D / EPV;
  constexpr int SR = row_stride<T, D>();
  for (int i = threadIdx.x; i < ROWS * VPR; i += kThreads) {
    const int r = i / VPR;
    const int c = (i % VPR) * EPV;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(g + (long long)(r0 + r) * s_row +
                                            c);
    *reinterpret_cast<uint4*>(sm + r * SR + c) = val;
  }
}

// n f32 values of a row vector from index r0 (zero past n_rows).
__device__ __forceinline__ void load_vec(float* sm, const float* g, int r0,
                                         int n, int n_rows) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    sm[i] = r0 + i < n_rows ? g[r0 + i] : 0.f;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}
__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[nb] += A·Bᵀ for one warp: A is the warp's 16 rows [16, D] and B a
// tile [NB·8, D], both row-major in shared memory with row stride SR.
// acc is in the mma C layout: lane (g = lane/4, t = lane%4) holds rows
// g and g+8, columns nb·8 + 2t and +1, as acc[nb][0..1] and [2..3].
template <typename T, int D, int NB>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4], const T* A,
                                        const T* Bm) {
  constexpr int SR = row_stride<T, D>();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (is_bf16<T>()) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const bf16* ap = A + g * SR + ks * 16 + 2 * t;
      const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * SR), ld32(ap + 8),
                             ld32(ap + 8 * SR + 8)};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const bf16* bp = Bm + (nb * 8 + g) * SR + ks * 16 + 2 * t;
        const uint32_t b[2] = {ld32(bp), ld32(bp + 8)};
        mma16816(acc[nb], a, b);
      }
    }
  } else {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* ar = A + (g + (i >> 1) * 8) * SR;
        const float* br = Bm + (nb * 8 + 2 * t + (i & 1)) * SR;
        float s = acc[nb][i];
#pragma unroll 4
        for (int d = 0; d < D; ++d) s = fmaf(ar[d], br[d], s);
        acc[nb][i] = s;
      }
    }
  }
}

// acc[nd] += P·Bm for one warp: P [16, NBK·8] is held in registers in the
// mma C layout (as mma_abt leaves it), Bm [NBK·8, D] row-major in shared
// memory. bf16: P is rounded to bf16 and used as the A operand directly.
// f32: P goes through the warp's scratch [16, NBK·8 + 4] in shared memory.
template <typename T, int D, int NBK>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 8][4],
                                       const float (&p)[NBK][4], const T* Bm,
                                       float* scratch) {
  constexpr int SR = row_stride<T, D>();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (is_bf16<T>()) {
    static_assert(NBK % 2 == 0, "k slices of 16");
#pragma unroll
    for (int kk = 0; kk < NBK / 2; ++kk) {
      const uint32_t a[4] = {pack2f(p[2 * kk][0], p[2 * kk][1]),
                             pack2f(p[2 * kk][2], p[2 * kk][3]),
                             pack2f(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             pack2f(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const bf16* bp = Bm + (kk * 16 + 2 * t) * SR + nd * 8 + g;
        const uint32_t b[2] = {pack2(bp[0], bp[SR]),
                               pack2(bp[8 * SR], bp[9 * SR])};
        mma16816(acc[nd], a, b);
      }
    }
  } else {
    constexpr int PS = NBK * 8 + 4;
#pragma unroll
    for (int nb = 0; nb < NBK; ++nb) {
      scratch[g * PS + nb * 8 + 2 * t] = p[nb][0];
      scratch[g * PS + nb * 8 + 2 * t + 1] = p[nb][1];
      scratch[(g + 8) * PS + nb * 8 + 2 * t] = p[nb][2];
      scratch[(g + 8) * PS + nb * 8 + 2 * t + 1] = p[nb][3];
    }
    __syncwarp();
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* pr = scratch + (g + (i >> 1) * 8) * PS;
        const float* bc = Bm + nd * 8 + 2 * t + (i & 1);
        float s = acc[nd][i];
#pragma unroll 4
        for (int j = 0; j < NBK * 8; ++j) s = fmaf(pr[j], bc[j * SR], s);
        acc[nd][i] = s;
      }
    }
    __syncwarp();
  }
}

}  // namespace
