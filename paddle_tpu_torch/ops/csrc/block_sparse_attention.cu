// Block-sparse flash attention forward and backward for Hopper (sm_90a) —
// kernels K5 and K6 of the port.
//
// Replaces (paddle_tpu/ops/block_sparse_attention.py, the Pallas TPU
// kernels launched by `pl.pallas_call`):
//   bsa_fwd     <- `_bsa_fwd_impl`  (kernel :73, call :145)
//   bsa_bwd     <- `_bsa_bwd_impl`, `dq_kernel` (:192, call :242) and
//                  `dkv_kernel` (:254, call :313), in one kernel (bf16)
//   bsa_bwd_dq, bsa_bwd_dkv <- the same two, in f32 (reference runs)
// They compute the same functions over the attended pairs of a compiled
// pattern (no causal rule):
//   forward   s = q·kᵀ·scale, −inf where the pair is not attended;
//             out = softmax(s)·v and lse = m + log(l) per row in f32; a
//             row that attends nothing gets out = 0 and lse = −inf;
//   backward  p = exp(s − lse) on attended pairs (lse pinned to 0 where
//             it is not finite), 0 elsewhere; dp = dout·vᵀ;
//             ds = p·(dp − delta)·scale — ds carries the scale, unlike
//             K2 — with delta = rowsum(dout·out);
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
//   bits [mixed][kTile] u64 — bit c of word r set when pair (r, c) of the
//       mixed tile is attended. Tiles past T are mixed, so a full tile
//       needs no test at all and a column past T is never attended;
//   tile lists ptr [n + 1], ent [active] (tile, slot) — the active k tiles
//       of each q tile in ascending order (f32 forward and dq), or the
//       active q tiles of each k tile (f32 dkv); slot −1 marks a full tile;
//   pair lists ptr [m + 1], ent [·] (tile, slot of half 0, slot of half
//       1), order [m] — for the bf16 kernels, whose blocks own two tiles
//       (m = ⌈n / 2⌉): the union of both tiles' lists, a half's slot kSkip
//       where its tile holds no pair, and the blocks with the longest
//       lists first.
//
// What bounds them on an H100: operations. At B=1, T=8192, H=32, D=128
// the Longformer pattern above has 5,148,352 pairs: the forward's two
// products are 84.4 GFLOP (0.085 ms at 989 TFLOP/s) against 0.080 ms of
// q, k, v, out and lse at 3.35 TB/s; the backward's five products 211
// GFLOP (0.213 ms). The bf16 kernels are K1's and K2's designs on the
// Hopper tile core (hopper_attention.cuh: wgmma from 128-byte-swizzled
// shared memory, f32 accumulators in registers, TMA from the [B, T, H, D]
// strides, so the [B, H, T, D] tensors of `sparse.fused_attention` need
// no copy), walking the plan's pair lists instead of a causal range:
//   * forward (bsa_fwd_kernel): two warpgroups per (batch·head, 128-row
//     block), S = Q·Kᵀ and O += P·V on wgmma (V MN-major), Q once and the
//     active K/V tiles through a two-stage TMA ring, each mixed half's 64
//     row words with its K tile (a bulk copy on the same mbarrier), so
//     the mask test reads shared memory; an online softmax in base 2
//     (FwdTile: a full tile tests nothing, a mixed one bit c of row i's
//     word); a half with no pair in the tile skips it;
//   * backward (bsa_bwd_kernel): one block per (batch·head, 128-key
//     block), two warpgroups of 64 keys, K and V once by TMA, the active
//     q tiles' Q, dO, lse·log2e and delta and the mixed halves' words
//     through a two-stage ring; per pair the five products of K2 (Sᵀ,
//     dPᵀ, dV += Pᵀ·dO, dK += dSᵀ·Q, dQ_partial = dS·K), the transposed
//     mask test bit `key` of query column c's word; dQ_partial added to
//     an f32 [B, T, H, D] accumulator by TMA reduce-adds, so dq's bits
//     change from run to run (its checks are tolerances). A preparation
//     kernel (delta, lse·log2e with non-finite lse read as 0, the
//     accumulator zeroed) and a conversion kernel (dq to bf16) run in the
//     same launch call. A block with an empty list still writes dk = dv =
//     0 for its keys;
//   * both launch the blocks with the longest lists first: under the
//     Longformer pattern the global tiles' blocks walk all 128 tiles of
//     T=8192, the others about 11.
// The f32 instances (bsa_fwd_f32_kernel, bsa_bwd_dq_kernel,
// bsa_bwd_dkv_kernel, on attention_tiles.cuh) keep PR 7's design for the
// reference runs: mma.sync-shaped tiles with products in f32 on the CUDA
// cores (never TF32), 4 warps a block each owning 16 rows, one block per
// (batch, head, q tile) over the tile lists (forward, dq), one per k tile
// over its q tiles in halves of 32 rows (dkv); no atomics.
//
// Numerics against the plain versions (ops/block_sparse_attention.py):
// as K1 and K2, the bf16 kernels round p and ds to bf16 as tensor-core
// operands; tolerances are ops/flash_attention.py's.
//
// C interface (built by nvcc, loaded with ctypes; no PyTorch headers):
// each *_launch takes device pointers (tensors, then the plan's arrays),
// dtype (0 f32, 1 bf16), sizes, the f32 scale, a host array of element
// strides (batch, seq, head) for q, k, v, out, dout, dq, dk, dv — 24
// values, unused ones 0 — and the CUDA stream; it launches on that
// stream, allocates nothing (bsa_bwd_launch gets its f32 scratch from the
// caller), and returns cudaGetLastError(). The TMA maps come from
// cuTensorMapEncodeTiled through the runtime's driver entry point: no
// -lcuda.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attention_tiles.cuh"
#include "hopper_attention.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kTile = 64;   // query rows × keys of a plan tile (TILE)
constexpr int kHalf = 32;   // query rows per step of the f32 dkv
constexpr int kSkip = -2;   // a half's slot where its tile holds no pair
constexpr int kWGs = 2;     // warpgroups of the bf16 kernels, a tile each
constexpr int kWordBytes = kTile * 8;   // one mixed tile's row words
static_assert(kTile == hopper::kTile, "the plan's tile is the core's");

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

// ----------------------------------------------------------- forward, f32
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bsa_fwd_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
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

// ------------------------------------------------------ backward, f32: dq
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

// ----------------------------------------------------- backward, f32: dkv
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

// ------------------------------------------------------------ bf16 kernels
// One entry of a pair list: the tile along the walk and each half's slot
// (−1 full, ≥ 0 the mixed tile's words in `bits`, kSkip no pair).
struct Ent {
  int tile;
  int slot[kWGs];
};
static_assert(sizeof(Ent) == 12, "the plan's [·, 3] int32 rows");

// ----------------------------------------------------------- forward, bf16
// Two warpgroups per (batch·head, 128-row block), each owning its 64-row
// q tile and sharing one K/V ring; the block walks the union of its two
// tiles' active key tiles (the pair list), heaviest blocks first. Q once
// and K/V tiles through a two-stage ring, all by TMA from the [B, T, H, D]
// strides, each stage's K (with the mixed halves' row words) and V on
// their own mbarrier, so that S = Q·Kᵀ starts before V lands. Products
// and softmax: hopper_attention.cuh.
template <int D>
__global__ void __launch_bounds__(kWGs * hopper::kWG)
bsa_fwd_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               bf16* __restrict__ out, float* __restrict__ lse,
               const int* __restrict__ ptr, const Ent* __restrict__ ent,
               const u64* __restrict__ bits, const int* __restrict__ order,
               const Params p) {
  using namespace hopper;
  constexpr int TB = tile_bytes<D>();
  extern __shared__ __align__(16) uint8_t fwd_smem[];
  uint8_t* sQ = align_1024(fwd_smem);   // one 64-row tile per warpgroup
  uint8_t* sK = sQ + kWGs * TB;         // two stages
  uint8_t* sV = sK + 2 * TB;            // two stages
  u64* sW = reinterpret_cast<u64*>(sV + 2 * TB);   // [stage][half][row]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sW + 2 * kWGs * kTile);

  const int wg = threadIdx.x / kWG;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int blk = order[blockIdx.y];    // longest lists first
  const int q0 = blk * (kWGs * kTile);
  const int a0 = ptr[blk];
  const int n = ptr[blk + 1] - a0;
  const Ent* e = ent + a0;
  const int rows[2] = {q0 + acc_row(0), q0 + acc_row(1)};
  const float scale_log2 = p.scale * kLog2e;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(bar + i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  // key tile j of the list into stage st: K and the mixed halves' words on
  // bar[1 + st], V on bar[3 + st]
  auto issue = [&](int j, int st) {
    const Ent x = e[j];
    const int k0 = x.tile * kTile;
    uint32_t words = 0;
    for (int hf = 0; hf < kWGs; ++hf)
      if (x.slot[hf] >= 0) words += kWordBytes;
    mbar_expect_tx(bar + 1 + st, TB + words);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      tma_load_4d(sK + st * TB + c * kChunkBytes, &tk, bar + 1 + st, c * 64,
                  h, k0, b);
    for (int hf = 0; hf < kWGs; ++hf)
      if (x.slot[hf] >= 0)
        bulk_load(sW + (st * kWGs + hf) * kTile,
                  bits + (long long)x.slot[hf] * kTile, kWordBytes,
                  bar + 1 + st);
    mbar_expect_tx(bar + 3 + st, TB);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      tma_load_4d(sV + st * TB + c * kChunkBytes, &tv, bar + 3 + st, c * 64,
                  h, k0, b);
  };
  if (threadIdx.x == 0 && n > 0) {
    mbar_expect_tx(bar, kWGs * TB);
    for (int t = 0; t < kWGs; ++t)
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(sQ + t * TB + c * kChunkBytes, &tq, bar, c * 64, h,
                    q0 + t * kTile, b);
    issue(0, 0);
  }
  const uint8_t* myQ = sQ + wg * TB;

  FwdTile<D> st;
  st.init();
  if (n > 0) mbar_wait(bar, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j & 1;
    if (j + 1 < n) {
      __syncthreads();   // every warp is done with tile j-1's stage
      if (threadIdx.x == 0) issue(j + 1, s ^ 1);
    }
    // a half with no pair in this tile adds nothing (the other half waits
    // for the stage, so every stage lands before it is reused)
    const int slot = e[j].slot[wg];
    if (slot == kSkip) continue;
    const uint32_t parity = (j >> 1) & 1;
    float sc[32];
    mbar_wait(bar + 1 + s, parity);
    qk_tile<D>(sc, myQ, sK + s * TB);
    const u64* w = sW + (s * kWGs + wg) * kTile;
    const u64 words[2] = {slot >= 0 ? w[acc_row(0) & 63] : 0ull,
                          slot >= 0 ? w[acc_row(1) & 63] : 0ull};
    st.softmax(sc, scale_log2, slot >= 0,
               [&](int i, int c) { return (words[i] >> c) & 1ull; });
    mbar_wait(bar + 3 + s, parity);
    pv_tile<D>(st.o, sc, sV + s * TB);
  }

  st.finish();
  bf16* ob = out + b * p.o[0] + h * p.o[2];
  float* lb = lse + ((long long)b * p.H + h) * p.T;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= p.T) continue;
    const float inv = 1.f / st.denom(i);
    bf16* orow = ob + rows[i] * p.o[1];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(orow + acc_col(j, 0), st.o[4 * j + 2 * i] * inv,
             st.o[4 * j + 2 * i + 1] * inv);
    if (t == 0) lb[rows[i]] = st.lse(i);
  }
}

// ---------------------------------------------------------- backward, bf16
// One block per (batch·head, 128-key block), two warpgroups of 64 keys
// each (the block's K and V tiles, loaded once by TMA); the block walks
// the union of its two key tiles' active q tiles (the pair list),
// heaviest blocks first, through a two-stage ring of Q, dO (64 rows each,
// 4D maps over the [B, T, H, D] strides), their lse·log2e and delta (bulk
// copies of the zero-padded [B, H, Tp] rows) and the mixed halves' words,
// tile i+1's copy in flight while tile i's products run. Per tile each
// warpgroup does K2's five products (flash_attention.cu); registers hold
// dK and dV (D/2 f32 each), Sᵀ and dPᵀ (32 each) and one 64-column half
// of dQ_partial at a time.
template <int D>
__global__ void __launch_bounds__(kWGs * hopper::kWG)
bsa_bwd_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tdq,
               const float* __restrict__ lse2,
               const float* __restrict__ delta, bf16* __restrict__ dk,
               bf16* __restrict__ dv, const int* __restrict__ ptr,
               const Ent* __restrict__ ent, const u64* __restrict__ bits,
               const int* __restrict__ order, const Params p, const int Tp) {
  using namespace hopper;
  constexpr int TB = tile_bytes<D>();
  extern __shared__ __align__(16) uint8_t bwd_smem_buf[];
  uint8_t* sK = align_1024(bwd_smem_buf);  // a 64-key tile per warpgroup
  uint8_t* sV = sK + kWGs * TB;
  uint8_t* sQ = sV + kWGs * TB;            // two stages
  uint8_t* sDO = sQ + 2 * TB;              // two stages
  uint8_t* sDS = sDO + 2 * TB;             // a chunk per warpgroup
  uint8_t* sDQ = sDS + kWGs * kChunkBytes;  // D/64 tiles per warpgroup
  float* sLse = reinterpret_cast<float*>(sDQ + kWGs * (D / 64) *
                                         kDqTileBytes);
  float* sDelta = sLse + 2 * kTile;        // two stages each
  u64* sW = reinterpret_cast<u64*>(sDelta + 2 * kTile);  // [stage][half]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sW + 2 * kWGs * kTile);

  const int wg = threadIdx.x / kWG;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kb = order[blockIdx.y];        // longest lists first
  const int k0 = kb * (kWGs * kTile);
  const int a0 = ptr[kb];
  const int n = ptr[kb + 1] - a0;
  const Ent* e = ent + a0;
  const long long vrow = ((long long)b * p.H + h) * Tp;
  const float scale_log2 = p.scale * kLog2e;
  const int keys[2] = {k0 + acc_row(0), k0 + acc_row(1)};
  const int kbit[2] = {acc_row(0) & 63, acc_row(1) & 63};  // in the tile

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int i, int st) {   // list entry i into stage st
    const Ent x = e[i];
    const int q0 = x.tile * kTile;
    uint64_t* bb = bar + 1 + st;
    uint32_t words = 0;
    for (int hf = 0; hf < kWGs; ++hf)
      if (x.slot[hf] >= 0) words += kWordBytes;
    mbar_expect_tx(bb, 2 * TB + 2 * kTile * 4 + words);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_load_4d(sQ + st * TB + c * kChunkBytes, &tq, bb, c * 64, h, q0, b);
      tma_load_4d(sDO + st * TB + c * kChunkBytes, &tdo, bb, c * 64, h, q0,
                  b);
    }
    bulk_load(sLse + st * kTile, lse2 + vrow + q0, kTile * 4, bb);
    bulk_load(sDelta + st * kTile, delta + vrow + q0, kTile * 4, bb);
    for (int hf = 0; hf < kWGs; ++hf)
      if (x.slot[hf] >= 0)
        bulk_load(sW + (st * kWGs + hf) * kTile,
                  bits + (long long)x.slot[hf] * kTile, kWordBytes, bb);
  };
  if (threadIdx.x == 0 && n > 0) {
    mbar_expect_tx(bar, 2 * kWGs * TB);
    for (int t = 0; t < kWGs; ++t)
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(sK + t * TB + c * kChunkBytes, &tk, bar, c * 64, h,
                    k0 + t * kTile, b);
        tma_load_4d(sV + t * TB + c * kChunkBytes, &tv, bar, c * 64, h,
                    k0 + t * kTile, b);
      }
    issue(0, 0);
  }
  const uint8_t* myK = sK + wg * TB;
  const uint8_t* myV = sV + wg * TB;
  uint8_t* myDS = sDS + wg * kChunkBytes;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  if (n > 0) mbar_wait(bar, 0);
  for (int i = 0; i < n; ++i) {
    const int st = i & 1;
    if (i + 1 < n) {
      __syncthreads();   // every warp is done with tile i-1's stage
      if (threadIdx.x == 0) issue(i + 1, st ^ 1);
    }
    // no pair of this warpgroup's keys in the tile: nothing to add (the
    // other half waits for the stage, so every stage lands before reuse)
    const int slot = e[i].slot[wg];
    if (slot == kSkip) continue;
    const int q0 = e[i].tile * kTile;
    mbar_wait(bar + 1 + st, (i >> 1) & 1);
    const uint8_t* cQ = sQ + st * TB;
    const uint8_t* cDO = sDO + st * TB;
    const float* cLse = sLse + st * kTile;
    const float* cDelta = sDelta + st * kTile;
    const u64* cW = sW + (st * kWGs + wg) * kTile;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: rows = keys, columns = queries
    float s[32], dp[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor(myK, kk), desc_kmajor(cQ, kk), kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_kmajor(myV, kk), desc_kmajor(cDO, kk), kk > 0);
    wg_commit();
    wg_wait<1>();
    fence_regs(s);
    // Pᵀ, while dPᵀ's products run: a full tile tests nothing, a mixed one
    // bit `key` of query column qc's word (0 past T)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int qc = acc_col(j, x & 1);
        const bool vis = slot < 0 || ((cW[qc] >> kbit[x >> 1]) & 1ull);
        s[4 * j + x] =
            vis ? ex2_ftz(fmaf(s[4 * j + x], scale_log2, -cLse[qc])) : 0.f;
      }
    wg_wait0();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x)   // dSᵀ, with the scale
        dp[4 * j + x] = ds_of(s[4 * j + x], dp[4 * j + x],
                              cDelta[acc_col(j, x & 1)], p.scale);

    // dS to shared memory for dQ; then dQ_partial's first 64 columns,
    // dV += Pᵀ·dO and dK += dSᵀ·Q (A from registers, dO and Q MN-major),
    // so that the first half's staging and reduce-add overlap dV and dK
    uint32_t pa[4][4], da[4][4];
    to_a_frags(pa, s);
    to_a_frags(da, dp);
    store_ds(myDS, dp);
    fence_proxy_async();
    named_barrier(1 + wg, kWG);   // the warpgroup's dS is whole
    float dq[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) dq[x] = 0.f;
    fence_regs(dq);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64_mnb(dq, desc_kmajor(myDS, kk), desc_mnmajor(myK, kk),
                       kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(dv_acc, pa[kk], desc_mnmajor(cDO, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(dk_acc, da[kk], desc_mnmajor(cQ, kk));
    wg_commit();
    wg_wait<1>();
    fence_regs(dq);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      if (c > 0) dq_product(dq, myDS, myK + c * kChunkBytes);
      uint8_t* buf = sDQ + (wg * (D / 64) + c) * kDqTileBytes;
      // the tile's reduction of the previous query tile has read it
      if (threadIdx.x % kWG == 0) bulk_wait_read<D / 64 - 1>();
      named_barrier(1 + wg, kWG);
      store_dq(buf, dq);
      fence_proxy_async();
      named_barrier(1 + wg, kWG);
      if (threadIdx.x % kWG == 0) {
        tma_reduce_add_4d(&tdq, buf, c * 64, h, q0, b);
        tma_reduce_add_4d(&tdq, buf + 8192, c * 64 + 32, h, q0, b);
        bulk_commit();
      }
    }
    wg_wait0();   // dV and dK, before their stage is reused
    hold_frags(pa);
    hold_frags(da);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
  }

  // every key below T gets its dk and dv, 0 where its list is empty
  if (threadIdx.x % kWG == 0) bulk_wait<0>();   // reductions complete
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= p.T) continue;
    bf16* krow = dk + b * p.dk[0] + keys[r] * p.dk[1] + h * p.dk[2];
    bf16* vrw = dv + b * p.dv[0] + keys[r] * p.dv[1] + h * p.dv[2];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store2(krow + acc_col(j, 0), dk_acc[4 * j + 2 * r],
             dk_acc[4 * j + 2 * r + 1]);
      store2(vrw + acc_col(j, 0), dv_acc[4 * j + 2 * r],
             dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

// Before bsa_bwd_kernel: delta[b, h, t] = Σ_d dout·out and lse2[b, h, t]
// = lse·log2(e) (0 where lse is not finite: such a row attends no key,
// and its pairs are masked), both f32 [B, H, Tp] with zeros at t >= T;
// and the rows of dq_acc [B, T, H, D] zeroed, so that rows no block
// touches read exactly 0. One warp per (b, t, h) row.
template <int D>
__global__ void __launch_bounds__(256)
bsa_bwd_prep_kernel(const bf16* __restrict__ out,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ lse2,
                    float* __restrict__ delta, float* __restrict__ dq_acc,
                    const Params p, const int Tp) {
  constexpr int EPL = D / 32;   // elements per lane: 4 or 2
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)p.B * Tp * p.H) return;
  const int h = static_cast<int>(row % p.H);
  const long long bt = row / p.H;
  const int t = static_cast<int>(bt % Tp);
  const int b = static_cast<int>(bt / Tp);
  float d = 0.f;
  if (t < p.T) {
    const bf16* o = out + b * p.o[0] + t * p.o[1] + h * p.o[2] + lane * EPL;
    const bf16* g = dout + b * p.dout[0] + t * p.dout[1] + h * p.dout[2] +
                    lane * EPL;
#pragma unroll
    for (int x = 0; x < EPL; x += 2) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(o + x));
      const float2 c = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(g + x));
      d = fmaf(a.x, c.x, fmaf(a.y, c.y, d));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    float* z = dq_acc + (((long long)b * p.T + t) * p.H + h) * D + lane * EPL;
#pragma unroll
    for (int x = 0; x < EPL; x += 2)
      *reinterpret_cast<float2*>(z + x) = make_float2(0.f, 0.f);
  }
  if (lane == 0) {
    const long long at = ((long long)b * p.H + h) * Tp + t;
    const float x =
        t < p.T ? safe_lse(lse[((long long)b * p.H + h) * p.T + t]) : 0.f;
    delta[at] = d;
    lse2[at] = x * hopper::kLog2e;
  }
}

// After bsa_bwd_kernel: dq = bf16(dq_acc) (ds carried the scale), four
// elements a thread.
template <int D>
__global__ void __launch_bounds__(256)
bsa_bwd_convert_kernel(const float* __restrict__ dq_acc,
                       bf16* __restrict__ dq, const Params p) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)p.B * p.T * p.H * (D / 4)) return;
  const float4 v = reinterpret_cast<const float4*>(dq_acc)[i];
  const int d = static_cast<int>(i % (D / 4)) * 4;
  const long long row = i / (D / 4);
  const int h = static_cast<int>(row % p.H);
  const long long bt = row / p.H;
  const int t = static_cast<int>(bt % p.T);
  const int b = static_cast<int>(bt / p.T);
  bf16* o = dq + b * p.dq[0] + t * p.dq[1] + h * p.dq[2] + d;
  store2(o, v.x, v.y);
  store2(o + 2, v.z, v.w);
}

// ------------------------------------------------------------- launchers
template <typename T, int D>
constexpr size_t smem_fwd() {
  return 3 * kTile * row_stride<T, D>() * sizeof(T) +
         kWarps * 16 * (kTile + 4) * sizeof(float);
}
template <typename T, int D>
constexpr size_t smem_dq() {
  return 4 * kTile * row_stride<T, D>() * sizeof(T) +
         2 * kTile * sizeof(float) +
         kWarps * 16 * (kTile + 4) * sizeof(float);
}
template <typename T, int D>
constexpr size_t smem_dkv() {
  return (2 * kTile + 2 * kHalf) * row_stride<T, D>() * sizeof(T) +
         2 * kHalf * sizeof(float) + kHalf * sizeof(u64) +
         kWarps * 16 * (kHalf + 4) * sizeof(float);
}
// alignment slack; Q (a tile per warpgroup), two K and two V stages, two
// stages of both halves' words, five mbarriers
template <int D>
constexpr size_t smem_fwd_bf16() {
  return 1024 + (kWGs + 4) * hopper::tile_bytes<D>() +
         2 * kWGs * kWordBytes + 5 * 8;
}
// alignment slack; K and V (a tile per warpgroup); two stages of Q and dO;
// a dS chunk per warpgroup; the dQ_partial tiles (64 columns each) of each
// warpgroup; two stages of lse and delta and of both halves' words; the
// K/V mbarrier and one per stage
template <int D>
constexpr size_t smem_bwd_bf16() {
  return 1024 + (2 * kWGs + 4) * hopper::tile_bytes<D>() +
         kWGs * hopper::kChunkBytes +
         kWGs * (D / 64) * hopper::kDqTileBytes + 2 * 2 * kTile * 4 +
         2 * kWGs * kWordBytes + 3 * 8;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Plan {          // the f32 kernels' tile lists and the words
  const int* ptr;
  const int2* ent;
  const u64* bits;
};
struct PairPlan {      // the bf16 kernels' pair lists and the words
  const int* ptr;
  const Ent* ent;
  const u64* bits;
  const int* order;
};

template <typename T, int D>
int fwd(const Params& p, const Plan& pl, const void* q, const void* k,
        const void* v, void* out, void* lse, cudaStream_t s) {
  constexpr size_t bytes = smem_fwd<T, D>();
  cudaError_t e = allow_smem(bsa_fwd_f32_kernel<T, D>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.T + kTile - 1) / kTile, p.H, p.B);
  bsa_fwd_f32_kernel<T, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), pl.ptr, pl.ent, pl.bits, p);
  return static_cast<int>(cudaGetLastError());
}

// The number of 2-tile blocks along T: the pair lists' length.
int pair_blocks(const Params& p) {
  return (p.T + kWGs * kTile - 1) / (kWGs * kTile);
}

// bf16: TMA maps over q, k, v as the strides give them, then
// bsa_fwd_kernel on (B·H, 128-row blocks) blocks of two warpgroups.
template <int D>
int fwd_bf16(const Params& p, const PairPlan& pl, const void* q,
             const void* k, const void* v, void* out, void* lse,
             cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  int err = hopper::encode_bnhd(&tq, q, p.B, p.T, p.H, D, p.q[0], p.q[1],
                                p.q[2]);
  if (!err)
    err = hopper::encode_bnhd(&tk, k, p.B, p.T, p.H, D, p.k[0], p.k[1],
                              p.k[2]);
  if (!err)
    err = hopper::encode_bnhd(&tv, v, p.B, p.T, p.H, D, p.v[0], p.v[1],
                              p.v[2]);
  if (err) return err;
  constexpr size_t bytes = smem_fwd_bf16<D>();
  cudaError_t e = allow_smem(bsa_fwd_kernel<D>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int m = pair_blocks(p);
  if (m > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  bsa_fwd_kernel<D><<<dim3(p.B * p.H, m, 1), kWGs * hopper::kWG, bytes,
                      s>>>(tq, tk, tv, static_cast<bf16*>(out),
                           static_cast<float*>(lse), pl.ptr, pl.ent, pl.bits,
                           pl.order, p);
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

// bf16 backward: TMA maps over q, k, v, dout as the strides give them and
// over the f32 accumulator, then the preparation kernel, bsa_bwd_kernel on
// (B·H, 128-key blocks) blocks of two warpgroups, and the conversion
// kernel, all on stream s. lse2 and delta are f32 [B, H, Tp] scratch (Tp =
// T rounded up to 64), dq_acc f32 [B, T, H, D] contiguous scratch; the
// caller allocates them.
template <int D>
int bwd_bf16(const Params& p, const PairPlan& pl, const void* q,
             const void* k, const void* v, const void* out,
             const void* dout, const void* lse, void* lse2, void* delta,
             void* dq_acc, void* dq, void* dk, void* dv, cudaStream_t s) {
  CUtensorMap tq, tk, tv, tdo, tdq;
  int err = hopper::encode_bnhd(&tq, q, p.B, p.T, p.H, D, p.q[0], p.q[1],
                                p.q[2]);
  if (!err)
    err = hopper::encode_bnhd(&tk, k, p.B, p.T, p.H, D, p.k[0], p.k[1],
                              p.k[2]);
  if (!err)
    err = hopper::encode_bnhd(&tv, v, p.B, p.T, p.H, D, p.v[0], p.v[1],
                              p.v[2]);
  if (!err)
    err = hopper::encode_bnhd(&tdo, dout, p.B, p.T, p.H, D, p.dout[0],
                              p.dout[1], p.dout[2]);
  if (!err) err = hopper::encode_bnhd_f32(&tdq, dq_acc, p.B, p.T, p.H, D);
  if (err) return err;
  const int Tp = (p.T + kTile - 1) / kTile * kTile;
  const int m = pair_blocks(p);
  if (m > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long rows = static_cast<long long>(p.B) * Tp * p.H;
  bsa_bwd_prep_kernel<D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                           s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(lse2),
      static_cast<float*>(delta), static_cast<float*>(dq_acc), p, Tp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr size_t bytes = smem_bwd_bf16<D>();
  e = allow_smem(bsa_bwd_kernel<D>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  bsa_bwd_kernel<D><<<dim3(p.B * p.H, m, 1), kWGs * hopper::kWG, bytes,
                      s>>>(
      tq, tk, tv, tdo, tdq, static_cast<const float*>(lse2),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), pl.ptr, pl.ent, pl.bits, pl.order, p, Tp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n4 = static_cast<long long>(p.B) * p.T * p.H * (D / 4);
  bsa_bwd_convert_kernel<D><<<static_cast<unsigned>((n4 + 255) / 256), 256,
                              0, s>>>(static_cast<const float*>(dq_acc),
                                      static_cast<bf16*>(dq), p);
  return static_cast<int>(cudaGetLastError());
}

// Validates sizes and fills Params; returns 0 or a cudaError_t code.
int make_params(Params* p, int B, int T, int H, int D, float scale,
                const long long* strides) {
  if (B <= 0 || T <= 0 || H <= 0 || (D != 64 && D != 128) || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  p->B = B; p->T = T; p->H = H; p->scale = scale;
  long long* dst[8] = {p->q, p->k, p->v, p->o, p->dout, p->dq, p->dk, p->dv};
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  return 0;
}

Plan tile_plan(const void* ptr, const void* ent, const void* bits) {
  return {static_cast<const int*>(ptr), static_cast<const int2*>(ent),
          static_cast<const u64*>(bits)};
}
PairPlan pair_plan(const void* ptr, const void* ent, const void* bits,
                   const void* order) {
  return {static_cast<const int*>(ptr), static_cast<const Ent*>(ent),
          static_cast<const u64*>(bits), static_cast<const int*>(order)};
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (every tensor but lse shares it; lse
// is f32 [B, H, T] contiguous). f32 reads the tile plan by q tile
// (tile_ptr, tile_ent), bf16 the pair plan by 2-tile q block (pair_ptr,
// pair_ent, pair_order); both the words (tile_bits). Returns a cudaError_t
// code.
int bsa_fwd_launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, const void* tile_ptr, const void* tile_ent,
                   const void* tile_bits, const void* pair_ptr,
                   const void* pair_ent, const void* pair_order, int dtype,
                   int B, int T, int H, int D, float scale,
                   const long long* strides, void* stream) {
  Params p;
  const int err = make_params(&p, B, T, H, D, scale, strides);
  if (err) return err;
  if (tile_ptr == nullptr || pair_ptr == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const PairPlan pl = pair_plan(pair_ptr, pair_ent, tile_bits, pair_order);
    return D == 64 ? fwd_bf16<64>(p, pl, q, k, v, out, lse, s)
                   : fwd_bf16<128>(p, pl, q, k, v, out, lse, s);
  }
  const Plan pl = tile_plan(tile_ptr, tile_ent, tile_bits);
  if (dtype == 0)
    return D == 64 ? fwd<float, 64>(p, pl, q, k, v, out, lse, s)
                   : fwd<float, 128>(p, pl, q, k, v, out, lse, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K6 in bf16 (dtype must be 1): the preparation kernel, bsa_bwd_kernel and
// the conversion kernel over the pair plan by 2-tile k block. lse is f32
// [B, H, T] contiguous; lse2 and delta are f32 [B, H, Tp] scratch (Tp = T
// rounded up to a multiple of 64), dq_acc f32 [B, T, H, D] contiguous
// scratch, all written before they are read. Returns a cudaError_t code.
int bsa_bwd_launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const void* lse,
                   void* lse2, void* delta, void* dq_acc, void* dq, void* dk,
                   void* dv, const void* pair_ptr, const void* pair_ent,
                   const void* tile_bits, const void* pair_order, int dtype,
                   int B, int T, int H, int D, float scale,
                   const long long* strides, void* stream) {
  Params p;
  const int err = make_params(&p, B, T, H, D, scale, strides);
  if (err) return err;
  if (dtype != 1 || pair_ptr == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PairPlan pl = pair_plan(pair_ptr, pair_ent, tile_bits, pair_order);
  return D == 64 ? bwd_bf16<64>(p, pl, q, k, v, out, dout, lse, lse2, delta,
                                dq_acc, dq, dk, dv, s)
                 : bwd_bf16<128>(p, pl, q, k, v, out, dout, lse, lse2,
                                 delta, dq_acc, dq, dk, dv, s);
}

// K6 in f32 (dtype must be 0; bf16 runs bsa_bwd_launch): dq over the tile
// plan by q tile, delta = rowsum(dout·out) f32 [B, H, T] from the caller.
int bsa_bwd_dq_launch(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, const void* tile_ptr, const void* tile_ent,
                      const void* tile_bits, int dtype, int B, int T, int H,
                      int D, float scale, const long long* strides,
                      void* stream) {
  Params p;
  const int err = make_params(&p, B, T, H, D, scale, strides);
  if (err) return err;
  if (dtype != 0 || tile_ptr == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan pl = tile_plan(tile_ptr, tile_ent, tile_bits);
  return D == 64
             ? bwd_dq<float, 64>(p, pl, q, k, v, dout, lse, delta, dq, s)
             : bwd_dq<float, 128>(p, pl, q, k, v, dout, lse, delta, dq, s);
}

// K6 in f32: dk and dv over the tile plan by k tile.
int bsa_bwd_dkv_launch(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, const void* tile_ptr,
                       const void* tile_ent, const void* tile_bits,
                       int dtype, int B, int T, int H, int D, float scale,
                       const long long* strides, void* stream) {
  Params p;
  const int err = make_params(&p, B, T, H, D, scale, strides);
  if (err) return err;
  if (dtype != 0 || tile_ptr == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan pl = tile_plan(tile_ptr, tile_ent, tile_bits);
  return D == 64 ? bwd_dkv<float, 64>(p, pl, q, k, v, dout, lse, delta, dk,
                                      dv, s)
                 : bwd_dkv<float, 128>(p, pl, q, k, v, dout, lse, delta, dk,
                                       dv, s);
}

}  // extern "C"
