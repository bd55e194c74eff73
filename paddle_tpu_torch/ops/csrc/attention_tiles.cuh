// Tile helpers of the port's f32 attention kernels (flash_attention.cu:
// K1, K2; block_sparse_attention.cu: K5, K6 — their bf16 kernels run on
// hopper_attention.cuh): 16-byte tile loads into padded shared memory and
// the warp-level products in f32 on CUDA cores (never TF32), each lane
// holding the entries of an m16n8 accumulator fragment. One block is
// kWarps warps, each owning 16 rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

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

// acc[nb] += A·Bᵀ for one warp: A is the warp's 16 rows [16, D] and B a
// tile [NB·8, D], both row-major in shared memory with row stride SR.
// acc is in the mma C layout: lane (g = lane/4, t = lane%4) holds rows
// g and g+8, columns nb·8 + 2t and +1, as acc[nb][0..1] and [2..3].
template <typename T, int D, int NB>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4], const T* A,
                                        const T* Bm) {
  static_assert(std::is_same<T, float>::value, "f32 tiles");
  constexpr int SR = row_stride<T, D>();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
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

// acc[nd] += P·Bm for one warp: P [16, NBK·8] is held in registers in the
// mma C layout (as mma_abt leaves it), Bm [NBK·8, D] row-major in shared
// memory; P goes through the warp's scratch [16, NBK·8 + 4] in shared
// memory.
template <typename T, int D, int NBK>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 8][4],
                                       const float (&p)[NBK][4], const T* Bm,
                                       float* scratch) {
  static_assert(std::is_same<T, float>::value, "f32 tiles");
  constexpr int SR = row_stride<T, D>();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
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

}  // namespace
