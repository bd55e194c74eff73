// Flash attention forward and backward for Hopper (sm_90a) — kernels K1
// and K2 of the port.
//
// Replaces (paddle_tpu/ops/flash_attention.py, the Pallas TPU kernels
// launched by `pl.pallas_call`):
//   flash_fwd     <- `_flash_fwd_impl`  (kernel :316, call :358)
//   flash_bwd_dq  <- `_flash_bwd_impl`, `dq_kernel`  (:201, call :222)
//   flash_bwd_dkv <- `_flash_bwd_impl`, `dkv_kernel` (:243, call :270)
// They compute the same functions, not a block-by-block carry-over:
//   forward   out = softmax(q·kᵀ·scale) · v over the visible columns, and
//             lse = m + log(l) per row, in f32 (row r of L sees column c
//             of S when c <= r + S − L under `causal`: the bottom-right
//             convention of `_block_run` / `_causal_mask_scores`); a row
//             that sees no column gets out = 0 and lse = −inf;
//   backward  p = exp(s − lse) (lse = −inf read as 0), dp = dout·vᵀ,
//             ds = p·(dp − delta) with delta = rowsum(dout·out) computed
//             by the caller, dq = ds·k·scale, dk = dsᵀ·q·scale,
//             dv = pᵀ·dout.
//
// What bounds them on an H100: operations. At B=1, L=S=2048, H=32, D=128
// the causal forward does 4·H·D·L(L+1)/2 ≈ 34.4 GFLOP on 67 MB of q, k,
// v and out (≈ 0.035 ms at 989 TFLOP/s against ≈ 0.020 ms at 3.35 TB/s),
// and the backward ≈ 2.5× the forward's products on ≈ 1.7× its bytes.
// So the design puts the products on the tensor cores:
//   * the bf16 forward (flash_fwd_kernel) runs on the Hopper tile core of
//     hopper_attention.cuh: two warpgroups per (batch, head, 128-row query
//     tile), S = Q·Kᵀ and O += P·V on wgmma (V read MN-major, never
//     transposed), Q once and K/V tiles through a two-stage ring that TMA
//     fills from the [B, L, H, D] strides (4D maps, no transposing copy)
//     while the previous tile's products run, an online softmax in base
//     2, and the heaviest causal tiles launched first;
//   * the backward (and the f32 forward) uses mma.sync m16n8k16 bf16
//     tiles with an f32 accumulator (attention_tiles.cuh); the score tile
//     stays in registers and is fed to the second product as its A
//     operand without a trip through shared memory (FlashAttention-2's
//     register reuse);
//   * one block of 4 warps per (batch, head, tile of 64 rows), each warp
//     owning 16 rows, with an online softmax (forward) or a running dq,
//     dk/dv sum (backward) in registers; the TPU's sequential
//     "arbitrary" grid axis becomes a loop inside the block;
//   * the backward is split as in FlashAttention-2: flash_bwd_dq walks kv
//     tiles for a q tile, flash_bwd_dkv walks q tiles for a kv tile, so
//     every block owns its outputs and no atomics are needed;
//   * causal tiles that `_block_run` would skip are never loaded; rows
//     past L and columns past S are zero-filled in shared memory and
//     masked, so any L and S work (no multiple-of-128 gate, no padding);
//   * q, k, v, dout are read in their [B, L, H, D] layout through element
//     strides: no transposing copy.
// The f32 instances do the same tiling with their products in f32 on the
// CUDA cores (never TF32): they exist for the f32 reference runs.
//
// Numerics against the plain version (ops/flash_attention.py): the plain
// version keeps p in f32 for p·v; the bf16 kernels round p (and ds) to
// bf16 as the A operand of the tensor-core product, a relative error of
// at most 2^-9 per term, and each side rounds its outputs to bf16. The
// stated tolerances are in ops/flash_attention.py.
//
// C interface (built by nvcc, loaded with ctypes; no PyTorch headers):
// each *_launch takes device pointers, sizes, the f32 scale, a host array
// of element strides (batch, seq, head) for q, k, v, out, dout, dq, dk,
// dv — 24 values, unused ones 0 — and the CUDA stream; it launches on
// that stream, allocates nothing, and returns cudaGetLastError(). The
// bf16 forward's TMA maps come from cuTensorMapEncodeTiled, reached
// through the runtime's driver entry point: no -lcuda.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attention_tiles.cuh"
#include "hopper_attention.cuh"

namespace {

constexpr int kBQ = 64;     // query rows per block: forward and dq (16 a warp)
constexpr int kBK = 64;     // key rows per tile: forward and dq; per block: dkv
constexpr int kBQdkv = 32;  // query rows per tile in dkv

struct Params {
  int B, L, S, H, causal;
  float scale;
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
};

// Columns of a row that `causal` leaves visible: [0, end).
__device__ __forceinline__ int visible_end(int row, const Params& p) {
  return p.causal ? min(p.S, row + p.S - p.L + 1) : p.S;
}

// ------------------------------------------------------- forward, f32
// The f32 instances (products in f32 on CUDA cores, for the reference
// runs); bf16 runs flash_fwd_kernel below.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, const Params p) {
  constexpr int SR = row_stride<T, D>();
  constexpr int NB = kBK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kBQ * SR;
  T* sV = sK + kBK * SR;
  float* scratch = reinterpret_cast<float*>(sV + kBK * SR);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const T* qb = q + b * p.q[0] + h * p.q[2];
  const T* kb = k + b * p.k[0] + h * p.k[2];
  const T* vb = v + b * p.v[0] + h * p.v[2];

  load_tile<T, D, kBQ>(sQ, qb, p.q[1], q0, p.L);
  const int kv_end = visible_end(min(q0 + kBQ, p.L) - 1, p);
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int ends[2] = {visible_end(rows[0], p), visible_end(rows[1], p)};

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // the previous tile is consumed (and sQ is written)
    load_tile<T, D, kBK>(sK, kb, p.k[1], kt * kBK, p.S);
    load_tile<T, D, kBK>(sV, vb, p.v[1], kt * kBK, p.S);
    __syncthreads();
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nb][i] = 0.f;
    mma_abt<T, D, NB>(s, sQ + warp * 16 * SR, sK);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = kt * kBK + nb * 8 + 2 * t + (i & 1);
        const float x = col < ends[i >> 1] ? s[nb][i] * p.scale : -INFINITY;
        s[nb][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    float alpha[2], safe[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with no visible column yet keeps m = -inf; exp against 0
      // leaves p and alpha exactly 0 instead of -inf - -inf = nan
      safe[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = expf(m[r] - safe[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(s[nb][i] - safe[i >> 1]);
        s[nb][i] = e;
        sum[i >> 1] += e;
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
  float* lb = lse + ((long long)b * p.H + h) * p.L;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.L) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = ob + rows[r] * p.o[1];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      store2(orow + nd * 8 + 2 * t, acc[nd][2 * r] / denom,
             acc[nd][2 * r + 1] / denom);
    if (t == 0) lb[rows[r]] = m[r] + logf(denom);
  }
}

// ------------------------------------------------------ forward, bf16
// Two consumer warpgroups per (batch·head, 128-row query tile), each
// owning 64 rows and sharing one K/V ring (measured faster than one
// warpgroup per 64 rows: 0.089 against 0.099 ms causal at L=S=2048,
// PERF.md), heaviest causal tiles first; Q once and K/V tiles through a
// two-stage ring, all by TMA from the [B, L, H, D] layout (no transposing
// copy), each stage's K and V on their own mbarrier so that S = Q·Kᵀ
// starts before V lands; the copy of tile j+1 is in flight while tile
// j's products run. Products and softmax: hopper_attention.cuh.
constexpr int kFwdWG = 2;   // consumer warpgroups of the bf16 forward

template <int D>
__global__ void __launch_bounds__(kFwdWG * hopper::kWG)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 bf16* __restrict__ out, float* __restrict__ lse,
                 const Params p) {
  using namespace hopper;
  constexpr int TB = tile_bytes<D>();
  constexpr int BQ = kFwdWG * kTile;  // query rows of the block
  extern __shared__ __align__(16) uint8_t fwd_smem[];
  uint8_t* sQ = align_1024(fwd_smem);   // one 64-row tile per warpgroup
  uint8_t* sK = sQ + kFwdWG * TB;  // two stages
  uint8_t* sV = sK + 2 * TB;       // two stages
  uint64_t* bar = reinterpret_cast<uint64_t*>(sV + 2 * TB);  // q, k[2], v[2]

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int kv_end = visible_end(min(q0 + BQ, p.L) - 1, p);
  const int n_kv = kv_end > 0 ? (kv_end + kTile - 1) / kTile : 0;
  // every row of the tile sees every column below full_end (rows further
  // down see more), so only tiles reaching past it test columns
  const int full_end = visible_end(q0, p);
  const int rows[2] = {q0 + acc_row(0), q0 + acc_row(1)};
  const int ends[2] = {visible_end(rows[0], p), visible_end(rows[1], p)};
  const float scale_log2 = p.scale * kLog2e;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(bar + i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  auto load = [&](uint8_t* dst, const CUtensorMap* map, uint64_t* bb,
                  int row, int tiles) {
    mbar_expect_tx(bb, tiles * TB);
    for (int t = 0; t < tiles; ++t)
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(dst + t * TB + c * kChunkBytes, map, bb, c * 64, h,
                    row + t * kTile, b);
  };
  if (threadIdx.x == 0 && n_kv > 0) {
    load(sQ, &tq, bar, q0, kFwdWG);
    load(sK, &tk, bar + 1, 0, 1);
    load(sV, &tv, bar + 3, 0, 1);
  }
  const uint8_t* myQ = sQ + (threadIdx.x / kWG) * TB;

  FwdTile<D> st;
  st.init();
  if (n_kv > 0) mbar_wait(bar, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j & 1;
    if (j + 1 < n_kv) {
      __syncthreads();   // every warp is done with tile j-1's stage
      if (threadIdx.x == 0) {
        load(sK + (s ^ 1) * TB, &tk, bar + 1 + (s ^ 1), (j + 1) * kTile, 1);
        load(sV + (s ^ 1) * TB, &tv, bar + 3 + (s ^ 1), (j + 1) * kTile, 1);
      }
    }
    const uint32_t parity = (j >> 1) & 1;
    const int c0 = j * kTile;
    float sc[32];
    mbar_wait(bar + 1 + s, parity);
    qk_tile<D>(sc, myQ, sK + s * TB);
    st.softmax(sc, scale_log2, c0 + kTile > full_end,
               [&](int i, int c) { return c0 + c < ends[i]; });
    mbar_wait(bar + 3 + s, parity);
    pv_tile<D>(st.o, sc, sV + s * TB);
  }

  st.finish();
  bf16* ob = out + b * p.o[0] + h * p.o[2];
  float* lb = lse + ((long long)b * p.H + h) * p.L;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= p.L) continue;
    const float inv = 1.f / st.denom(i);
    bf16* orow = ob + rows[i] * p.o[1];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(orow + acc_col(j, 0), st.o[4 * j + 2 * i] * inv,
             st.o[4 * j + 2 * i + 1] * inv);
    if (t == 0) lb[rows[i]] = st.lse(i);
  }
}

// ------------------------------------------------------------ backward dq
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    const Params p) {
  constexpr int SR = row_stride<T, D>();
  constexpr int NB = kBK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = sQ + kBQ * SR;
  T* sK = sDO + kBQ * SR;
  T* sV = sK + kBK * SR;
  float* sLse = reinterpret_cast<float*>(sV + kBK * SR);
  float* sDelta = sLse + kBQ;
  float* scratch = sDelta + kBQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const T* kb = k + b * p.k[0] + h * p.k[2];
  const T* vb = v + b * p.v[0] + h * p.v[2];
  const long long vrow = ((long long)b * p.H + h) * p.L;

  load_tile<T, D, kBQ>(sQ, q + b * p.q[0] + h * p.q[2], p.q[1], q0, p.L);
  load_tile<T, D, kBQ>(sDO, dout + b * p.dout[0] + h * p.dout[2], p.dout[1],
                       q0, p.L);
  load_vec(sLse, lse + vrow, q0, kBQ, p.L);
  load_vec(sDelta, delta + vrow, q0, kBQ, p.L);
  const int kv_end = visible_end(min(q0 + kBQ, p.L) - 1, p);
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;
  const int lrow[2] = {warp * 16 + g, warp * 16 + g + 8};
  const int ends[2] = {visible_end(q0 + lrow[0], p),
                       visible_end(q0 + lrow[1], p)};

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();
    load_tile<T, D, kBK>(sK, kb, p.k[1], kt * kBK, p.S);
    load_tile<T, D, kBK>(sV, vb, p.v[1], kt * kBK, p.S);
    __syncthreads();
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nb][i] = dp[nb][i] = 0.f;
    mma_abt<T, D, NB>(s, sQ + warp * 16 * SR, sK);
    mma_abt<T, D, NB>(dp, sDO + warp * 16 * SR, sV);
    float safe[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float x = sLse[lrow[r]];
      safe[r] = x == -INFINITY ? 0.f : x;
      dl[r] = sDelta[lrow[r]];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = kt * kBK + nb * 8 + 2 * t + (i & 1);
        const float pr = col < ends[i >> 1]
                             ? expf(s[nb][i] * p.scale - safe[i >> 1])
                             : 0.f;
        s[nb][i] = pr * (dp[nb][i] - dl[i >> 1]);  // ds
      }
    mma_pv<T, D, NB>(acc, s, sK, scratch + warp * 16 * (NB * 8 + 4));
  }

  T* db = dq + b * p.dq[0] + h * p.dq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + lrow[r];
    if (row >= p.L) continue;
    T* drow = db + row * p.dq[1];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      store2(drow + nd * 8 + 2 * t, acc[nd][2 * r] * p.scale,
             acc[nd][2 * r + 1] * p.scale);
  }
}

// ----------------------------------------------------------- backward dkv
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, const Params p) {
  constexpr int SR = row_stride<T, D>();
  constexpr int NB = kBQdkv / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kBK * SR;
  T* sQ = sV + kBK * SR;
  T* sDO = sQ + kBQdkv * SR;
  float* sLse = reinterpret_cast<float*>(sDO + kBQdkv * SR);
  float* sDelta = sLse + kBQdkv;
  float* scratch = sDelta + kBQdkv;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kBK;
  const T* qb = q + b * p.q[0] + h * p.q[2];
  const T* db = dout + b * p.dout[0] + h * p.dout[2];
  const long long vrow = ((long long)b * p.H + h) * p.L;

  load_tile<T, D, kBK>(sK, k + b * p.k[0] + h * p.k[2], p.k[1], k0, p.S);
  load_tile<T, D, kBK>(sV, v + b * p.v[0] + h * p.v[2], p.v[1], k0, p.S);
  // first query row that sees key k0 under `causal`: r >= k0 - (S - L)
  const int q_first = p.causal ? max(0, k0 - (p.S - p.L)) : 0;
  const int qt0 = q_first / kBQdkv;
  const int n_qt = (p.L + kBQdkv - 1) / kBQdkv;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_dk[nd][i] = acc_dv[nd][i] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int r0 = qt * kBQdkv;
    __syncthreads();
    load_tile<T, D, kBQdkv>(sQ, qb, p.q[1], r0, p.L);
    load_tile<T, D, kBQdkv>(sDO, db, p.dout[1], r0, p.L);
    load_vec(sLse, lse + vrow, r0, kBQdkv, p.L);
    load_vec(sDelta, delta + vrow, r0, kBQdkv, p.L);
    __syncthreads();
    float st[NB][4], dpt[NB][4];  // sᵀ, dpᵀ: rows = keys, columns = queries
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
        const int row = r0 + c;
        const int key = keys[i >> 1];
        const bool ok = row < p.L && key < visible_end(row, p);
        const float x = sLse[c];
        const float safe = x == -INFINITY ? 0.f : x;
        const float pr = ok ? expf(st[nb][i] * p.scale - safe) : 0.f;
        st[nb][i] = pr;
        dpt[nb][i] = pr * (dpt[nb][i] - sDelta[c]);  // dsᵀ
      }
    float* ws = scratch + warp * 16 * (NB * 8 + 4);
    mma_pv<T, D, NB>(acc_dv, st, sDO, ws);
    mma_pv<T, D, NB>(acc_dk, dpt, sQ, ws);
  }

  T* kbo = dk + b * p.dk[0] + h * p.dk[2];
  T* vbo = dv + b * p.dv[0] + h * p.dv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= p.S) continue;
    T* krow = kbo + keys[r] * p.dk[1];
    T* vrw = vbo + keys[r] * p.dv[1];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      store2(krow + nd * 8 + 2 * t, acc_dk[nd][2 * r] * p.scale,
             acc_dk[nd][2 * r + 1] * p.scale);
      store2(vrw + nd * 8 + 2 * t, acc_dv[nd][2 * r], acc_dv[nd][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------- launchers
template <typename T, int D>
constexpr size_t smem_fwd() {
  return (kBQ + 2 * kBK) * row_stride<T, D>() * sizeof(T) +
         (is_bf16<T>() ? 0 : kWarps * 16 * (kBK + 4) * sizeof(float));
}
template <typename T, int D>
constexpr size_t smem_dq() {
  return (2 * kBQ + 2 * kBK) * row_stride<T, D>() * sizeof(T) +
         2 * kBQ * sizeof(float) +
         (is_bf16<T>() ? 0 : kWarps * 16 * (kBK + 4) * sizeof(float));
}
template <typename T, int D>
constexpr size_t smem_dkv() {
  return (2 * kBK + 2 * kBQdkv) * row_stride<T, D>() * sizeof(T) +
         2 * kBQdkv * sizeof(float) +
         (is_bf16<T>() ? 0 : kWarps * 16 * (kBQdkv + 4) * sizeof(float));
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
int fwd(const Params& p, const void* q, const void* k, const void* v,
        void* out, void* lse, cudaStream_t s) {
  constexpr size_t bytes = smem_fwd<T, D>();
  cudaError_t e = allow_smem(flash_fwd_f32_kernel<T, D>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.L + kBQ - 1) / kBQ, p.H, p.B);
  flash_fwd_f32_kernel<T, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), p);
  return static_cast<int>(cudaGetLastError());
}

// bf16: TMA maps over q, k, v as the strides give them, then
// flash_fwd_kernel on (B·H, 128-row query tiles) blocks of two
// warpgroups.
template <int D>
int fwd_bf16(const Params& p, const void* q, const void* k, const void* v,
             void* out, void* lse, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  int err = hopper::encode_bnhd(&tq, q, p.B, p.L, p.H, D, p.q[0], p.q[1],
                                p.q[2]);
  if (!err)
    err = hopper::encode_bnhd(&tk, k, p.B, p.S, p.H, D, p.k[0], p.k[1],
                              p.k[2]);
  if (!err)
    err = hopper::encode_bnhd(&tv, v, p.B, p.S, p.H, D, p.v[0], p.v[1],
                              p.v[2]);
  if (err) return err;
  // alignment slack, Q, two K and two V stages, five mbarriers
  constexpr size_t bytes =
      1024 + (kFwdWG + 4) * hopper::tile_bytes<D>() + 5 * 8;
  cudaError_t e = allow_smem(flash_fwd_kernel<D>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int BQ = kFwdWG * hopper::kTile;
  const int n_q = (p.L + BQ - 1) / BQ;
  if (n_q > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(p.B * p.H, n_q, 1);
  flash_fwd_kernel<D><<<grid, kFwdWG * hopper::kWG, bytes, s>>>(
      tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd_dq(const Params& p, const void* q, const void* k, const void* v,
           const void* dout, const void* lse, const void* delta, void* dq,
           cudaStream_t s) {
  constexpr size_t bytes = smem_dq<T, D>();
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, D>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.L + kBQ - 1) / kBQ, p.H, p.B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd_dkv(const Params& p, const void* q, const void* k, const void* v,
            const void* dout, const void* lse, const void* delta, void* dk,
            void* dv, cudaStream_t s) {
  constexpr size_t bytes = smem_dkv<T, D>();
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, D>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.S + kBK - 1) / kBK, p.H, p.B);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), p);
  return static_cast<int>(cudaGetLastError());
}

// Validates sizes and fills Params; returns 0 or a cudaError_t code.
int make_params(Params* p, int B, int L, int S, int H, int D, int causal,
                float scale, const long long* strides) {
  if (B <= 0 || L <= 0 || S <= 0 || H <= 0 || (D != 64 && D != 128) ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  p->B = B; p->L = L; p->S = S; p->H = H; p->causal = causal != 0;
  p->scale = scale;
  long long* dst[8] = {p->q, p->k, p->v, p->o, p->dout, p->dq, p->dk, p->dv};
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (every tensor but lse/delta shares it;
// lse and delta are f32 [B, H, L] contiguous). Returns a cudaError_t code.
int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                     void* lse, int dtype, int B, int L, int S, int H, int D,
                     int causal, float scale, const long long* strides,
                     void* stream) {
  Params p;
  const int err = make_params(&p, B, L, S, H, D, causal, scale, strides);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return D == 64 ? fwd_bf16<64>(p, q, k, v, out, lse, s)
                   : fwd_bf16<128>(p, q, k, v, out, lse, s);
  if (dtype == 0)
    return D == 64 ? fwd<float, 64>(p, q, k, v, out, lse, s)
                   : fwd<float, 128>(p, q, k, v, out, lse, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int dtype, int B, int L, int S, int H,
                        int D, int causal, float scale,
                        const long long* strides, void* stream) {
  Params p;
  const int err = make_params(&p, B, L, S, H, D, causal, scale, strides);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return D == 64 ? bwd_dq<bf16, 64>(p, q, k, v, dout, lse, delta, dq, s)
                   : bwd_dq<bf16, 128>(p, q, k, v, dout, lse, delta, dq, s);
  if (dtype == 0)
    return D == 64 ? bwd_dq<float, 64>(p, q, k, v, dout, lse, delta, dq, s)
                   : bwd_dq<float, 128>(p, q, k, v, dout, lse, delta, dq, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv, int dtype,
                         int B, int L, int S, int H, int D, int causal,
                         float scale, const long long* strides,
                         void* stream) {
  Params p;
  const int err = make_params(&p, B, L, S, H, D, causal, scale, strides);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return D == 64
               ? bwd_dkv<bf16, 64>(p, q, k, v, dout, lse, delta, dk, dv, s)
               : bwd_dkv<bf16, 128>(p, q, k, v, dout, lse, delta, dk, dv, s);
  if (dtype == 0)
    return D == 64
               ? bwd_dkv<float, 64>(p, q, k, v, dout, lse, delta, dk, dv, s)
               : bwd_dkv<float, 128>(p, q, k, v, dout, lse, delta, dk, dv,
                                     s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
