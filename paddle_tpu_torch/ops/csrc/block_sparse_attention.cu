// Block-sparse flash attention forward and backward for Hopper (sm_90a) —
// kernels K5 and K6 of the port.
//
// Replaces (paddle_tpu/ops/block_sparse_attention.py, the Pallas TPU
// kernels launched by `pl.pallas_call`):
//   bsa_fwd     <- `_bsa_fwd_impl`  (kernel :73, call :145)
//   bsa_bwd_dq  <- `_bsa_bwd_impl`, `dq_kernel`  (:192, call :242)
//   bsa_bwd_dkv <- `_bsa_bwd_impl`, `dkv_kernel` (:254, call :313)
// They compute the same functions over the attended pairs of a compiled
// pattern (no causal rule):
//   forward   s = q·kᵀ·scale, −inf where the pair is not attended;
//             out = softmax(s)·v and lse = m + log(l) per row in f32; a
//             row that attends nothing gets out = 0 and lse = −inf;
//   backward  p = exp(s − lse) on attended pairs (lse pinned to 0 where
//             it is not finite), 0 elsewhere; dp = dout·vᵀ;
//             ds = p·(dp − delta)·scale — ds carries the scale, unlike
//             K2 — with delta = rowsum(dout·out) from the caller;
//             dq = ds·k, dk = dsᵀ·q (the unscaled q), dv = pᵀ·dout.
//   Rows and keys the pattern never touches get exactly 0 in dq, dk, dv.
//
// The pattern is not walked block by block. The TPU kernel visits every
// (q block, k block) of the caller's block map, whose blocks may be any
// divisor of T (512 by default: under a Longformer window of ±256 with 64
// global tokens at T=8192 its active blocks cover 28.9% of T²). The host
// (`tile_plan` in ops/block_sparse_attention.py) derives from the block
// map and the partial masks a plan at this file's own tile, kTile × kTile
// (8.4% of T² on that pattern):
//   ptr [n + 1], ent [active] (tile, slot) — the active k tiles of each
//       q tile in ascending order (forward and dq), or the active q tiles
//       of each k tile (dkv); slot −1 marks a full tile;
//   bits [mixed][kTile] u64 — bit c of word r set when pair (r, c) of the
//       mixed tile is attended. Tiles past T are mixed, so a full tile
//       needs no test at all and a column past T is never attended.
//
// What bounds them on an H100: operations. At B=1, T=8192, H=32, D=128
// the Longformer pattern above has 5,148,352 pairs: the forward's two
// products are 84.4 GFLOP (0.085 ms at 989 TFLOP/s) against 0.080 ms of
// q, k, v, out and lse at 3.35 TB/s. The design is K1/K2's (see
// flash_attention.cu and attention_tiles.cuh): mma.sync m16n8k16 bf16
// tiles with f32 accumulators, 4 warps a block, each owning 16 rows, the
// score tile kept in registers as the A operand of the second product; one
// block per (batch, head, q tile) walks its active k tiles (forward, dq),
// one per k tile walks its active q tiles in halves of 32 rows (dkv), so
// every block owns its outputs and no atomics are needed. Skipped tiles
// are never loaded; a mixed tile costs each thread two 8-byte mask loads
// (forward, dq) or a 256-byte shared stage per half (dkv). q, k, v, dout
// are read in place through element strides (the [B, H, T, D] tensors of
// `sparse.fused_attention` need no copy). The f32 instances do the same
// tiling with their products on the CUDA cores (never TF32).
//
// C interface (built by nvcc, loaded with ctypes; no PyTorch headers):
// each *_launch takes device pointers (tensors, then the plan's ptr, ent,
// bits), dtype (0 f32, 1 bf16), sizes, the f32 scale, a host array of
// element strides (batch, seq, head) for q, k, v, out, dout, dq, dk, dv —
// 24 values, unused ones 0 — and the CUDA stream; it launches on that
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attention_tiles.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kTile = 64;   // query rows × keys of a plan tile (TILE)
constexpr int kHalf = 32;   // query rows per step of dkv

struct Params {
  int B, T, H;
  float scale;
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
};

// The keys that query row `row` of a tile attends, one bit each: all of
// them in a full tile (slot < 0), else the row's word of the mixed tile.
__device__ __forceinline__ u64 row_keys(const u64* __restrict__ bits,
                                        int slot, int row) {
  return slot < 0 ? ~0ull : bits[(long long)slot * kTile + row];
}

__device__ __forceinline__ bool attends(u64 keys, int col) {
  return (keys >> col) & 1ull;
}

// ds of one pair; it carries the scale, as the JAX kernels' `p_and_ds`.
__device__ __forceinline__ float ds_of(float pr, float dp, float delta,
                                       float scale) {
  return pr * (dp - delta) * scale;
}

// lse with a non-finite value (a row that attends nothing) read as 0;
// the comparison is false for ±inf and nan.
__device__ __forceinline__ float safe_lse(float x) {
  return fabsf(x) < INFINITY ? x : 0.f;
}

// ---------------------------------------------------------------- forward
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bsa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out,
               float* __restrict__ lse, const int* __restrict__ ptr,
               const int2* __restrict__ ent, const u64* __restrict__ bits,
               const Params p) {
  constexpr int SR = row_stride<T, D>();
  constexpr int NB = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kTile * SR;
  T* sV = sK + kTile * SR;
  float* scratch = reinterpret_cast<float*>(sV + kTile * SR);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, qt = blockIdx.x;
  const int q0 = qt * kTile;
  const T* kb = k + b * p.k[0] + h * p.k[2];
  const T* vb = v + b * p.v[0] + h * p.v[2];

  load_tile<T, D, kTile>(sQ, q + b * p.q[0] + h * p.q[2], p.q[1], q0, p.T);
  const int lrow[2] = {warp * 16 + g, warp * 16 + g + 8};

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  const int a_end = ptr[qt + 1];
  for (int a = ptr[qt]; a < a_end; ++a) {
    const int2 e = ent[a];
    __syncthreads();  // the previous tile is consumed (and sQ is written)
    load_tile<T, D, kTile>(sK, kb, p.k[1], e.x * kTile, p.T);
    load_tile<T, D, kTile>(sV, vb, p.v[1], e.x * kTile, p.T);
    __syncthreads();
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nb][i] = 0.f;
    mma_abt<T, D, NB>(s, sQ + warp * 16 * SR, sK);
    const u64 keys[2] = {row_keys(bits, e.y, lrow[0]),
                         row_keys(bits, e.y, lrow[1])};

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nb * 8 + 2 * t + (i & 1);
        const float x =
            attends(keys[i >> 1], col) ? s[nb][i] * p.scale : -INFINITY;
        s[nb][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    float alpha[2], safe[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row that has attended nothing yet keeps m = -inf; exp against 0
      // leaves p and alpha exactly 0 instead of -inf - -inf = nan
      safe[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = expf(m[r] - safe[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e2 = expf(s[nb][i] - safe[i >> 1]);
        s[nb][i] = e2;
        sum[i >> 1] += e2;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nd][i] *= alpha[i >> 1];
    mma_pv<T, D, NB>(acc, s, sV, scratch + warp * 16 * (NB * 8 + 4));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  T* ob = out + b * p.o[0] + h * p.o[2];
  float* lb = lse + ((long long)b * p.H + h) * p.T;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + lrow[r];
    if (row >= p.T) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = ob + row * p.o[1];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      store2(orow + nd * 8 + 2 * t, acc[nd][2 * r] / denom,
             acc[nd][2 * r + 1] / denom);
    if (t == 0) lb[row] = m[r] + logf(denom);
  }
}

// ------------------------------------------------------------ backward dq
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bsa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq,
                  const int* __restrict__ ptr, const int2* __restrict__ ent,
                  const u64* __restrict__ bits, const Params p) {
  constexpr int SR = row_stride<T, D>();
  constexpr int NB = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = sQ + kTile * SR;
  T* sK = sDO + kTile * SR;
  T* sV = sK + kTile * SR;
  float* sLse = reinterpret_cast<float*>(sV + kTile * SR);
  float* sDelta = sLse + kTile;
  float* scratch = sDelta + kTile;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, qt = blockIdx.x;
  const int q0 = qt * kTile;
  const T* kb = k + b * p.k[0] + h * p.k[2];
  const T* vb = v + b * p.v[0] + h * p.v[2];
  const long long vrow = ((long long)b * p.H + h) * p.T;

  load_tile<T, D, kTile>(sQ, q + b * p.q[0] + h * p.q[2], p.q[1], q0, p.T);
  load_tile<T, D, kTile>(sDO, dout + b * p.dout[0] + h * p.dout[2],
                         p.dout[1], q0, p.T);
  load_vec(sLse, lse + vrow, q0, kTile, p.T);
  load_vec(sDelta, delta + vrow, q0, kTile, p.T);
  __syncthreads();
  const int lrow[2] = {warp * 16 + g, warp * 16 + g + 8};
  const float safe[2] = {safe_lse(sLse[lrow[0]]), safe_lse(sLse[lrow[1]])};
  const float dl[2] = {sDelta[lrow[0]], sDelta[lrow[1]]};

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;

  const int a_end = ptr[qt + 1];
  for (int a = ptr[qt]; a < a_end; ++a) {
    const int2 e = ent[a];
    __syncthreads();
    load_tile<T, D, kTile>(sK, kb, p.k[1], e.x * kTile, p.T);
    load_tile<T, D, kTile>(sV, vb, p.v[1], e.x * kTile, p.T);
    __syncthreads();
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nb][i] = dp[nb][i] = 0.f;
    mma_abt<T, D, NB>(s, sQ + warp * 16 * SR, sK);
    mma_abt<T, D, NB>(dp, sDO + warp * 16 * SR, sV);
    const u64 keys[2] = {row_keys(bits, e.y, lrow[0]),
                         row_keys(bits, e.y, lrow[1])};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nb * 8 + 2 * t + (i & 1);
        const int r = i >> 1;
        const float pr = attends(keys[r], col)
                             ? expf(s[nb][i] * p.scale - safe[r])
                             : 0.f;
        s[nb][i] = ds_of(pr, dp[nb][i], dl[r], p.scale);
      }
    mma_pv<T, D, NB>(acc, s, sK, scratch + warp * 16 * (NB * 8 + 4));
  }

  T* db = dq + b * p.dq[0] + h * p.dq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + lrow[r];
    if (row >= p.T) continue;
    T* drow = db + row * p.dq[1];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      store2(drow + nd * 8 + 2 * t, acc[nd][2 * r], acc[nd][2 * r + 1]);
  }
}

// ----------------------------------------------------------- backward dkv
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bsa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, const int* __restrict__ ptr,
                   const int2* __restrict__ ent,
                   const u64* __restrict__ bits, const Params p) {
  constexpr int SR = row_stride<T, D>();
  constexpr int NB = kHalf / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kTile * SR;
  T* sQ = sV + kTile * SR;
  T* sDO = sQ + kHalf * SR;
  float* sLse = reinterpret_cast<float*>(sDO + kHalf * SR);
  float* sDelta = sLse + kHalf;
  u64* sKeys = reinterpret_cast<u64*>(sDelta + kHalf);
  float* scratch = reinterpret_cast<float*>(sKeys + kHalf);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, kt = blockIdx.x;
  const int k0 = kt * kTile;
  const T* qb = q + b * p.q[0] + h * p.q[2];
  const T* db = dout + b * p.dout[0] + h * p.dout[2];
  const long long vrow = ((long long)b * p.H + h) * p.T;

  load_tile<T, D, kTile>(sK, k + b * p.k[0] + h * p.k[2], p.k[1], k0, p.T);
  load_tile<T, D, kTile>(sV, v + b * p.v[0] + h * p.v[2], p.v[1], k0, p.T);
  const int kl[2] = {warp * 16 + g, warp * 16 + g + 8};  // keys in the tile

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_dk[nd][i] = acc_dv[nd][i] = 0.f;

  const int a_end = ptr[kt + 1];
  for (int a = ptr[kt]; a < a_end; ++a) {
    const int2 e = ent[a];
    for (int half = 0; half < kTile / kHalf; ++half) {
      const int r0 = e.x * kTile + half * kHalf;
      if (r0 >= p.T) break;
      __syncthreads();
      load_tile<T, D, kHalf>(sQ, qb, p.q[1], r0, p.T);
      load_tile<T, D, kHalf>(sDO, db, p.dout[1], r0, p.T);
      load_vec(sLse, lse + vrow, r0, kHalf, p.T);
      load_vec(sDelta, delta + vrow, r0, kHalf, p.T);
      for (int i = threadIdx.x; i < kHalf; i += kThreads)
        sKeys[i] = row_keys(bits, e.y, half * kHalf + i);
      __syncthreads();
      // sᵀ, dpᵀ: rows = keys, columns = queries
      float st[NB][4], dpt[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[nb][i] = dpt[nb][i] = 0.f;
      mma_abt<T, D, NB>(st, sK + warp * 16 * SR, sQ);
      mma_abt<T, D, NB>(dpt, sV + warp * 16 * SR, sDO);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = nb * 8 + 2 * t + (i & 1);
          const float pr =
              attends(sKeys[c], kl[i >> 1])
                  ? expf(st[nb][i] * p.scale - safe_lse(sLse[c]))
                  : 0.f;
          st[nb][i] = pr;
          dpt[nb][i] = ds_of(pr, dpt[nb][i], sDelta[c], p.scale);  // dsᵀ
        }
      float* ws = scratch + warp * 16 * (NB * 8 + 4);
      mma_pv<T, D, NB>(acc_dv, st, sDO, ws);
      mma_pv<T, D, NB>(acc_dk, dpt, sQ, ws);
    }
  }

  T* kbo = dk + b * p.dk[0] + h * p.dk[2];
  T* vbo = dv + b * p.dv[0] + h * p.dv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kl[r];
    if (key >= p.T) continue;
    T* krow = kbo + key * p.dk[1];
    T* vrw = vbo + key * p.dv[1];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      store2(krow + nd * 8 + 2 * t, acc_dk[nd][2 * r], acc_dk[nd][2 * r + 1]);
      store2(vrw + nd * 8 + 2 * t, acc_dv[nd][2 * r], acc_dv[nd][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------- launchers
template <typename T, int D>
constexpr size_t smem_fwd() {
  return 3 * kTile * row_stride<T, D>() * sizeof(T) +
         (is_bf16<T>() ? 0 : kWarps * 16 * (kTile + 4) * sizeof(float));
}
template <typename T, int D>
constexpr size_t smem_dq() {
  return 4 * kTile * row_stride<T, D>() * sizeof(T) +
         2 * kTile * sizeof(float) +
         (is_bf16<T>() ? 0 : kWarps * 16 * (kTile + 4) * sizeof(float));
}
template <typename T, int D>
constexpr size_t smem_dkv() {
  return (2 * kTile + 2 * kHalf) * row_stride<T, D>() * sizeof(T) +
         2 * kHalf * sizeof(float) + kHalf * sizeof(u64) +
         (is_bf16<T>() ? 0 : kWarps * 16 * (kHalf + 4) * sizeof(float));
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Plan {
  const int* ptr;
  const int2* ent;
  const u64* bits;
};

template <typename T, int D>
int fwd(const Params& p, const Plan& pl, const void* q, const void* k,
        const void* v, void* out, void* lse, cudaStream_t s) {
  constexpr size_t bytes = smem_fwd<T, D>();
  cudaError_t e = allow_smem(bsa_fwd_kernel<T, D>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.T + kTile - 1) / kTile, p.H, p.B);
  bsa_fwd_kernel<T, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), pl.ptr, pl.ent, pl.bits, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd_dq(const Params& p, const Plan& pl, const void* q, const void* k,
           const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, cudaStream_t s) {
  constexpr size_t bytes = smem_dq<T, D>();
  cudaError_t e = allow_smem(bsa_bwd_dq_kernel<T, D>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.T + kTile - 1) / kTile, p.H, p.B);
  bsa_bwd_dq_kernel<T, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), pl.ptr, pl.ent, pl.bits, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd_dkv(const Params& p, const Plan& pl, const void* q, const void* k,
            const void* v, const void* dout, const void* lse,
            const void* delta, void* dk, void* dv, cudaStream_t s) {
  constexpr size_t bytes = smem_dkv<T, D>();
  cudaError_t e = allow_smem(bsa_bwd_dkv_kernel<T, D>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.T + kTile - 1) / kTile, p.H, p.B);
  bsa_bwd_dkv_kernel<T, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), pl.ptr, pl.ent, pl.bits, p);
  return static_cast<int>(cudaGetLastError());
}

// Validates sizes and fills Params and Plan; returns 0 or a cudaError_t.
int make_params(Params* p, Plan* pl, const void* ptr, const void* ent,
                const void* bits, int B, int T, int H, int D, float scale,
                const long long* strides) {
  if (B <= 0 || T <= 0 || H <= 0 || (D != 64 && D != 128) || B > 65535 ||
      H > 65535 || ptr == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  p->B = B; p->T = T; p->H = H; p->scale = scale;
  long long* dst[8] = {p->q, p->k, p->v, p->o, p->dout, p->dq, p->dk, p->dv};
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  pl->ptr = static_cast<const int*>(ptr);
  pl->ent = static_cast<const int2*>(ent);
  pl->bits = static_cast<const u64*>(bits);
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (every tensor but lse/delta shares it;
// lse and delta are f32 [B, H, T] contiguous). tile_ptr, tile_ent and
// tile_bits are the plan: by q tile for bsa_fwd and bsa_bwd_dq, by k tile
// for bsa_bwd_dkv. Returns a cudaError_t code.
int bsa_fwd_launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, const void* tile_ptr, const void* tile_ent,
                   const void* tile_bits, int dtype, int B, int T, int H,
                   int D, float scale, const long long* strides,
                   void* stream) {
  Params p;
  Plan pl;
  const int err = make_params(&p, &pl, tile_ptr, tile_ent, tile_bits, B, T,
                              H, D, scale, strides);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return D == 64 ? fwd<bf16, 64>(p, pl, q, k, v, out, lse, s)
                   : fwd<bf16, 128>(p, pl, q, k, v, out, lse, s);
  if (dtype == 0)
    return D == 64 ? fwd<float, 64>(p, pl, q, k, v, out, lse, s)
                   : fwd<float, 128>(p, pl, q, k, v, out, lse, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int bsa_bwd_dq_launch(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, const void* tile_ptr, const void* tile_ent,
                      const void* tile_bits, int dtype, int B, int T, int H,
                      int D, float scale, const long long* strides,
                      void* stream) {
  Params p;
  Plan pl;
  const int err = make_params(&p, &pl, tile_ptr, tile_ent, tile_bits, B, T,
                              H, D, scale, strides);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return D == 64
               ? bwd_dq<bf16, 64>(p, pl, q, k, v, dout, lse, delta, dq, s)
               : bwd_dq<bf16, 128>(p, pl, q, k, v, dout, lse, delta, dq, s);
  if (dtype == 0)
    return D == 64
               ? bwd_dq<float, 64>(p, pl, q, k, v, dout, lse, delta, dq, s)
               : bwd_dq<float, 128>(p, pl, q, k, v, dout, lse, delta, dq,
                                    s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int bsa_bwd_dkv_launch(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, const void* tile_ptr,
                       const void* tile_ent, const void* tile_bits,
                       int dtype, int B, int T, int H, int D, float scale,
                       const long long* strides, void* stream) {
  Params p;
  Plan pl;
  const int err = make_params(&p, &pl, tile_ptr, tile_ent, tile_bits, B, T,
                              H, D, scale, strides);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return D == 64 ? bwd_dkv<bf16, 64>(p, pl, q, k, v, dout, lse, delta, dk,
                                       dv, s)
                   : bwd_dkv<bf16, 128>(p, pl, q, k, v, dout, lse, delta, dk,
                                        dv, s);
  if (dtype == 0)
    return D == 64 ? bwd_dkv<float, 64>(p, pl, q, k, v, dout, lse, delta, dk,
                                        dv, s)
                   : bwd_dkv<float, 128>(p, pl, q, k, v, dout, lse, delta,
                                         dk, dv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
