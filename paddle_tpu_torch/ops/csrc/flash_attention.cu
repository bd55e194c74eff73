// Flash attention forward and backward for Hopper (sm_90a) — kernels K1
// and K2 of the port.
//
// Replaces (paddle_tpu/ops/flash_attention.py, the Pallas TPU kernels
// launched by `pl.pallas_call`):
//   flash_fwd     <- `_flash_fwd_impl`  (kernel :316, call :358)
//   flash_bwd     <- `_flash_bwd_impl`, `dq_kernel` (:201, call :222) and
//                    `dkv_kernel` (:243, call :270), in one kernel (bf16)
//   flash_bwd_dq, flash_bwd_dkv <- the same two, in f32 (reference runs)
// They compute the same functions, not a block-by-block carry-over:
//   forward   out = softmax(q·kᵀ·scale) · v over the visible columns, and
//             lse = m + log(l) per row, in f32 (row r of L sees column c
//             of S when c <= r + S − L under `causal`: the bottom-right
//             convention of `_block_run` / `_causal_mask_scores`); a row
//             that sees no column gets out = 0 and lse = −inf;
//   backward  p = exp(s − lse) (lse = −inf read as 0), dp = dout·vᵀ,
//             ds = p·(dp − delta) with delta = rowsum(dout·out), dq =
//             ds·k·scale, dk = dsᵀ·q·scale, dv = pᵀ·dout.
//
// What bounds them on an H100: operations. At B=1, L=S=2048, H=32, D=128
// the causal forward does 4·H·D·L(L+1)/2 ≈ 34.4 GFLOP on 67 MB of q, k,
// v and out (≈ 0.035 ms at 989 TFLOP/s against ≈ 0.020 ms at 3.35 TB/s),
// and the backward 2.5× the forward's products (five per visible pair:
// s, dp, dv, dk, dq) on ≈ 1.7× its bytes. So the bf16 kernels put the
// products on the Hopper tile core of hopper_attention.cuh (wgmma from
// 128-byte-swizzled shared memory, f32 accumulators in registers, tiles
// brought by TMA from the [B, L, H, D] strides: no transposing copy):
//   * forward (flash_fwd_kernel): two warpgroups per (batch, head,
//     128-row query tile), S = Q·Kᵀ and O += P·V on wgmma (V read
//     MN-major, never transposed), Q once and K/V tiles through a
//     two-stage ring while the previous tile's products run, an online
//     softmax in base 2, the heaviest causal tiles launched first;
//   * backward (flash_bwd_kernel): one block per (batch, head, 128-key
//     tile), two warpgroups of 64 keys each; K and V come once, the query
//     tiles that see the keys (64 rows of Q and dO with their lse and
//     delta) through a two-stage ring. Per query tile each warpgroup runs
//     the five products once: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (both operands
//     K-major); Pᵀ = 2^(Sᵀ·scale·log2e − lse·log2e) (ex2.approx.ftz:
//     faster than exp2f, tools/flash_bwd_variants.py, PERF.md)
//     and dSᵀ = Pᵀ ∘ (dPᵀ − delta) in registers; dV += Pᵀ·dO and dK +=
//     dSᵀ·Q with the A operand from registers and dO, Q read MN-major;
//     then dS goes to shared memory as a bf16 swizzled tile, and
//     dQ_partial = dS·K (K read MN-major) is staged there in f32 and
//     added to an f32 dq accumulator in global memory by TMA reduce-adds
//     (cp.reduce.async.bulk.tensor, where per-thread float2 atomics were
//     slower).
//     FlashAttention-2's split into a dq and a dk/dv kernel recomputed s
//     and dp in both (seven products, no reduction across blocks); this
//     does five. The reductions make dq's f32 sum order, and so its
//     bits, change from run to run: every check of dq is a tolerance. A
//     preparation kernel computes delta and lse·log2e (zero-padded to
//     whole 64-row tiles, so the ring's bulk copies never read past them)
//     and zeroes the accumulator; a conversion kernel scales it into dq;
//   * causal tiles that `_block_run` would skip are never loaded or
//     computed; rows past L and columns past S arrive zero-filled by TMA
//     and are masked, so any L and S work (no multiple-of-128 gate, no
//     padding of the inputs).
// The f32 instances (flash_fwd_f32_kernel, flash_bwd_dq_kernel,
// flash_bwd_dkv_kernel, on attention_tiles.cuh) do the FlashAttention-2
// tiling with their products in f32 on the CUDA cores (never TF32): they
// exist for the f32 reference runs.
//
// Numerics against the plain version (ops/flash_attention.py): the plain
// version keeps p in f32 for p·v; the bf16 kernels round p and ds to bf16
// as tensor-core A operands, a relative error of at most 2^-9 per term,
// and each side rounds its outputs to bf16. The stated tolerances are in
// ops/flash_attention.py.
//
// C interface (built by nvcc, loaded with ctypes; no PyTorch headers):
// each *_launch takes device pointers, sizes, the f32 scale, a host array
// of element strides (batch, seq, head) for q, k, v, out, dout, dq, dk,
// dv — 24 values, unused ones 0 — and the CUDA stream; it launches on
// that stream, allocates nothing (flash_bwd_launch gets its f32 scratch
// from the caller), and returns cudaGetLastError(). The TMA maps come
// from cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point: no -lcuda. flash_bwd_wgmma_check runs the backward's first
// launch check.

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

// ------------------------------------------------------ backward, bf16
// One block per (batch·head, 128-key tile), two consumer warpgroups of 64
// keys each (the block's K and V tiles, loaded once by TMA); the block
// walks the query tiles that see its keys, from the first one under
// `causal`, through a two-stage TMA ring of Q, dO (64 rows each, 4D maps
// over the [B, L, H, D] strides) and their lse and delta (bulk copies of
// the zero-padded [B, H, Lp] rows), tile j+1's copy in flight while tile
// j's products run. The key tiles nearest the start see the most query
// rows and are launched first. Per tile each warpgroup does its five
// products (see the header): registers hold dK and dV (HD/2 f32 each),
// Sᵀ and dPᵀ (32 each) and one 64-column half of dQ_partial at a time.
constexpr int kBwdWG = 2;   // consumer warpgroups of the bf16 backward

template <int D>
__host__ __device__ constexpr int bwd_smem() {
  // alignment slack; K and V (a 64-key tile per warpgroup); two stages of
  // Q and dO; a dS chunk per warpgroup; the dQ_partial tiles (64 columns
  // each) of each warpgroup; two stages of lse and delta; the K/V
  // mbarrier and one per stage
  return 1024 + (2 * kBwdWG + 4) * hopper::tile_bytes<D>() +
         kBwdWG * hopper::kChunkBytes +
         kBwdWG * (D / 64) * hopper::kDqTileBytes +
         2 * 2 * hopper::kTile * 4 + 3 * 8;
}

template <int D>
__global__ void __launch_bounds__(kBwdWG * hopper::kWG)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tdq,
                 const float* __restrict__ lse2,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, const Params p, const int Lp) {
  using namespace hopper;
  constexpr int TB = tile_bytes<D>();
  extern __shared__ __align__(16) uint8_t bwd_smem_buf[];
  uint8_t* sK = align_1024(bwd_smem_buf);  // a 64-key tile per warpgroup
  uint8_t* sV = sK + kBwdWG * TB;
  uint8_t* sQ = sV + kBwdWG * TB;           // two stages
  uint8_t* sDO = sQ + 2 * TB;               // two stages
  uint8_t* sDS = sDO + 2 * TB;              // a chunk per warpgroup
  uint8_t* sDQ = sDS + kBwdWG * kChunkBytes;  // D/64 tiles per warpgroup
  float* sLse = reinterpret_cast<float*>(sDQ + kBwdWG * (D / 64) *
                                         kDqTileBytes);
  float* sDelta = sLse + 2 * kTile;         // two stages each
  uint64_t* bar = reinterpret_cast<uint64_t*>(sDelta + 2 * kTile);

  const int wg = threadIdx.x / kWG;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int k0 = blockIdx.y * (kBwdWG * kTile);
  const int kw0 = k0 + wg * kTile;          // this warpgroup's first key
  // first query row that sees key k0 under `causal`: r >= k0 − (S − L)
  const int q_first = p.causal ? max(0, k0 - (p.S - p.L)) : 0;
  const int qt0 = q_first / kTile;
  const int n_qt = (p.L + kTile - 1) / kTile - qt0;
  const int wq_first = p.causal ? max(0, kw0 - (p.S - p.L)) : 0;
  const long long vrow = ((long long)b * p.H + h) * Lp;
  const float scale_log2 = p.scale * kLog2e;
  const int keys[2] = {k0 + acc_row(0), k0 + acc_row(1)};

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int i, int st) {   // query tile qt0 + i into stage st
    const int q0 = (qt0 + i) * kTile;
    uint64_t* bb = bar + 1 + st;
    mbar_expect_tx(bb, 2 * TB + 2 * kTile * 4);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_load_4d(sQ + st * TB + c * kChunkBytes, &tq, bb, c * 64, h, q0, b);
      tma_load_4d(sDO + st * TB + c * kChunkBytes, &tdo, bb, c * 64, h, q0,
                  b);
    }
    bulk_load(sLse + st * kTile, lse2 + vrow + q0, kTile * 4, bb);
    bulk_load(sDelta + st * kTile, delta + vrow + q0, kTile * 4, bb);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, 2 * kBwdWG * TB);
    for (int t = 0; t < kBwdWG; ++t)
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
  mbar_wait(bar, 0);
  for (int i = 0; i < n_qt; ++i) {
    const int st = i & 1;
    if (i + 1 < n_qt) {
      __syncthreads();   // every warp is done with tile i-1's stage
      if (threadIdx.x == 0) issue(i + 1, st ^ 1);
    }
    const int q0 = (qt0 + i) * kTile;
    // no (key, query) pair of this warpgroup's tile is visible: nothing to
    // add (warpgroup 0 always waits, so every stage lands before reuse)
    if (kw0 >= p.S || q0 + kTile <= wq_first) continue;
    mbar_wait(bar + 1 + st, (i >> 1) & 1);
    const uint8_t* cQ = sQ + st * TB;
    const uint8_t* cDO = sDO + st * TB;
    const float* cLse = sLse + st * kTile;
    const float* cDelta = sDelta + st * kTile;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: rows = keys, columns = queries
    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
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
    // Pᵀ, while dPᵀ's products run; only tiles that are not wholly
    // visible test pairs
    const bool full = q0 + kTile <= p.L && kw0 + kTile <= p.S &&
                      (!p.causal || kw0 + kTile - 1 <= q0 + p.S - p.L);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = acc_col(j, e & 1);
        const int key = keys[e >> 1];
        const bool vis = full || (q0 + qc < p.L && key < p.S &&
                                  (!p.causal || key <= q0 + qc + p.S - p.L));
        s[4 * j + e] =
            vis ? ex2_ftz(fmaf(s[4 * j + e], scale_log2, -cLse[qc])) : 0.f;
      }
    wg_wait0();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] -
                                        cDelta[acc_col(j, e & 1)]);   // dSᵀ

    // dS to shared memory for dQ; then dQ_partial's first 64 columns,
    // dV += Pᵀ·dO and dK += dSᵀ·Q (A from registers, dO and Q MN-major),
    // so that the first half's staging and reduce-add overlap dV and dK
    uint32_t pa[4][4], da[4][4];
    to_a_frags(pa, s);
    to_a_frags(da, dp);
    store_ds(myDS, dp);
    fence_proxy_async();
    named_barrier(1 + wg, kWG);   // the warpgroup's dS is whole
    // dQ_partial = dS·K over this warpgroup's keys, 64 columns at a time,
    // staged in shared memory and added to the f32 accumulator by the
    // bulk-copy engine (rows past L are skipped there)
    float dq[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[e] = 0.f;
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

  if (threadIdx.x % kWG == 0) bulk_wait<0>();   // reductions complete
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= p.S) continue;
    bf16* krow = dk + b * p.dk[0] + keys[r] * p.dk[1] + h * p.dk[2];
    bf16* vrw = dv + b * p.dv[0] + keys[r] * p.dv[1] + h * p.dv[2];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store2(krow + acc_col(j, 0), dk_acc[4 * j + 2 * r] * p.scale,
             dk_acc[4 * j + 2 * r + 1] * p.scale);
      store2(vrw + acc_col(j, 0), dv_acc[4 * j + 2 * r],
             dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

// Before flash_bwd_kernel: delta[b, h, l] = Σ_d dout·out and lse2[b, h,
// l] = lse·log2(e) (0 where lse is −inf: such a row sees no key, and its
// pairs are masked), both f32 [B, H, Lp] with zeros at l >= L; and the
// rows of dq_acc [B, L, H, D] zeroed. One warp per (b, l, h) row.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const bf16* __restrict__ out,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ lse2,
                      float* __restrict__ delta, float* __restrict__ dq_acc,
                      const Params p, const int Lp) {
  constexpr int EPL = D / 32;   // elements per lane: 4 or 2
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)p.B * Lp * p.H) return;
  const int h = static_cast<int>(row % p.H);
  const long long bl = row / p.H;
  const int l = static_cast<int>(bl % Lp);
  const int b = static_cast<int>(bl / Lp);
  float d = 0.f;
  if (l < p.L) {
    const bf16* o = out + b * p.o[0] + l * p.o[1] + h * p.o[2] + lane * EPL;
    const bf16* g = dout + b * p.dout[0] + l * p.dout[1] + h * p.dout[2] +
                    lane * EPL;
#pragma unroll
    for (int e = 0; e < EPL; e += 2) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(o + e));
      const float2 c = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(g + e));
      d = fmaf(a.x, c.x, fmaf(a.y, c.y, d));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    float* z = dq_acc + (((long long)b * p.L + l) * p.H + h) * D + lane * EPL;
#pragma unroll
    for (int e = 0; e < EPL; e += 2)
      *reinterpret_cast<float2*>(z + e) = make_float2(0.f, 0.f);
  }
  if (lane == 0) {
    const long long at = ((long long)b * p.H + h) * Lp + l;
    const float x =
        l < p.L ? lse[((long long)b * p.H + h) * p.L + l] : -INFINITY;
    delta[at] = d;
    lse2[at] = x == -INFINITY ? 0.f : x * hopper::kLog2e;
  }
}

// After flash_bwd_kernel: dq = bf16(dq_acc · scale), four elements a
// thread.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_convert_kernel(const float* __restrict__ dq_acc,
                         bf16* __restrict__ dq, const Params p) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)p.B * p.L * p.H * (D / 4)) return;
  const float4 v = reinterpret_cast<const float4*>(dq_acc)[i];
  const int d = static_cast<int>(i % (D / 4)) * 4;
  const long long row = i / (D / 4);
  const int h = static_cast<int>(row % p.H);
  const long long bl = row / p.H;
  const int l = static_cast<int>(bl % p.L);
  const int b = static_cast<int>(bl / p.L);
  bf16* o = dq + b * p.dq[0] + l * p.dq[1] + h * p.dq[2] + d;
  store2(o, v.x * p.scale, v.y * p.scale);
  store2(o + 2, v.z * p.scale, v.w * p.scale);
}

// The backward's first launch check: the dS tile as threads write it
// (store_ds) read as an A operand, and K read MN-major as B (dq_product),
// for one warpgroup: x [64 keys, 64 queries] f32 (dSᵀ, each thread taking
// its accumulator entries), k [64 keys, D] bf16, out = bf16(x)ᵀ·k [64, D]
// f32, all row-major.
template <int D>
__global__ void __launch_bounds__(hopper::kWG)
bwd_wgmma_check_kernel(const float* x, const bf16* k, float* out) {
  using namespace hopper;
  extern __shared__ __align__(16) uint8_t bchk_smem[];
  uint8_t* sK = align_1024(bchk_smem);
  uint8_t* sDS = sK + tile_bytes<D>();
  for (int i = threadIdx.x; i < 64 * D / 8; i += kWG) {
    const int r = i / (D / 8), c = i % (D / 8);
    *reinterpret_cast<uint4*>(sK + swz(r, c)) =
        *reinterpret_cast<const uint4*>(k + r * D + c * 8);
  }
  float xr[32];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      xr[4 * j + e] = x[acc_row(e >> 1) * 64 + acc_col(j, e & 1)];
  store_ds(sDS, xr);
  fence_proxy_async();
  __syncthreads();
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    float dq[32];
    dq_product(dq, sDS, sK + c * kChunkBytes);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          out[acc_row(r) * D + c * 64 + acc_col(j, e)] = dq[4 * j + 2 * r + e];
  }
}

// --------------------------------------------------- backward, f32: dq
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

// -------------------------------------------------- backward, f32: dkv
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
// Shared memory of the f32 kernels: their tiles and the per-warp scratch
// of attention_tiles.cuh's f32 products.
template <typename T, int D>
constexpr size_t smem_fwd() {
  return (kBQ + 2 * kBK) * row_stride<T, D>() * sizeof(T) +
         kWarps * 16 * (kBK + 4) * sizeof(float);
}
template <typename T, int D>
constexpr size_t smem_dq() {
  return (2 * kBQ + 2 * kBK) * row_stride<T, D>() * sizeof(T) +
         2 * kBQ * sizeof(float) + kWarps * 16 * (kBK + 4) * sizeof(float);
}
template <typename T, int D>
constexpr size_t smem_dkv() {
  return (2 * kBK + 2 * kBQdkv) * row_stride<T, D>() * sizeof(T) +
         2 * kBQdkv * sizeof(float) +
         kWarps * 16 * (kBQdkv + 4) * sizeof(float);
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

// bf16 backward: TMA maps over q, k, v, dout as the strides give them,
// then the preparation kernel, flash_bwd_kernel on (B·H, 128-key tiles)
// blocks of two warpgroups, and the conversion kernel, all on stream s.
// lse2 and delta are f32 [B, H, Lp] scratch (Lp = L rounded up to 64),
// dq_acc f32 [B, L, H, D] contiguous scratch; the caller allocates them.
template <int D>
int bwd_bf16(const Params& p, const void* q, const void* k, const void* v,
             const void* out, const void* dout, const void* lse, void* lse2,
             void* delta, void* dq_acc, void* dq, void* dk, void* dv,
             cudaStream_t s) {
  CUtensorMap tq, tk, tv, tdo, tdq;
  int err = hopper::encode_bnhd(&tq, q, p.B, p.L, p.H, D, p.q[0], p.q[1],
                                p.q[2]);
  if (!err)
    err = hopper::encode_bnhd(&tk, k, p.B, p.S, p.H, D, p.k[0], p.k[1],
                              p.k[2]);
  if (!err)
    err = hopper::encode_bnhd(&tv, v, p.B, p.S, p.H, D, p.v[0], p.v[1],
                              p.v[2]);
  if (!err)
    err = hopper::encode_bnhd(&tdo, dout, p.B, p.L, p.H, D, p.dout[0],
                              p.dout[1], p.dout[2]);
  if (!err) err = hopper::encode_bnhd_f32(&tdq, dq_acc, p.B, p.L, p.H, D);
  if (err) return err;
  constexpr int BK = kBwdWG * hopper::kTile;
  const int Lp = (p.L + hopper::kTile - 1) / hopper::kTile * hopper::kTile;
  const int n_k = (p.S + BK - 1) / BK;
  if (n_k > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long rows = static_cast<long long>(p.B) * Lp * p.H;
  flash_bwd_prep_kernel<D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                             s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(lse2),
      static_cast<float*>(delta), static_cast<float*>(dq_acc), p, Lp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int bytes = bwd_smem<D>();
  e = allow_smem(flash_bwd_kernel<D>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_kernel<D><<<dim3(p.B * p.H, n_k, 1), kBwdWG * hopper::kWG,
                        bytes, s>>>(
      tq, tk, tv, tdo, tdq, static_cast<const float*>(lse2),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), p, Lp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n4 = static_cast<long long>(p.B) * p.L * p.H * (D / 4);
  flash_bwd_convert_kernel<D><<<static_cast<unsigned>((n4 + 255) / 256),
                                256, 0, s>>>(
      static_cast<const float*>(dq_acc), static_cast<bf16*>(dq), p);
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

// K2 in bf16 (dtype must be 1): the preparation kernel, flash_bwd_kernel
// and the conversion kernel. lse is f32 [B, H, L] contiguous; lse2 and
// delta are f32 [B, H, Lp] scratch (Lp = L rounded up to a multiple of
// 64), dq_acc f32 [B, L, H, D] contiguous scratch, all written before
// they are read. Returns a cudaError_t code.
int flash_bwd_launch(const void* q, const void* k, const void* v,
                     const void* out, const void* dout, const void* lse,
                     void* lse2, void* delta, void* dq_acc, void* dq,
                     void* dk, void* dv, int dtype, int B, int L, int S,
                     int H, int D, int causal, float scale,
                     const long long* strides, void* stream) {
  Params p;
  const int err = make_params(&p, B, L, S, H, D, causal, scale, strides);
  if (err) return err;
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? bwd_bf16<64>(p, q, k, v, out, dout, lse, lse2, delta,
                                dq_acc, dq, dk, dv, s)
                 : bwd_bf16<128>(p, q, k, v, out, dout, lse, lse2, delta,
                                 dq_acc, dq, dk, dv, s);
}

// K2 in f32 (dtype must be 0; bf16 runs flash_bwd_launch): dq.
int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int dtype, int B, int L, int S, int H,
                        int D, int causal, float scale,
                        const long long* strides, void* stream) {
  Params p;
  const int err = make_params(&p, B, L, S, H, D, causal, scale, strides);
  if (err) return err;
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? bwd_dq<float, 64>(p, q, k, v, dout, lse, delta, dq, s)
                 : bwd_dq<float, 128>(p, q, k, v, dout, lse, delta, dq, s);
}

// K2 in f32: dk and dv.
int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv, int dtype,
                         int B, int L, int S, int H, int D, int causal,
                         float scale, const long long* strides,
                         void* stream) {
  Params p;
  const int err = make_params(&p, B, L, S, H, D, causal, scale, strides);
  if (err) return err;
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64
             ? bwd_dkv<float, 64>(p, q, k, v, dout, lse, delta, dk, dv, s)
             : bwd_dkv<float, 128>(p, q, k, v, dout, lse, delta, dk, dv, s);
}

// The backward's first launch check (bwd_wgmma_check_kernel) at head dim
// D (64 or 128) on device pointers. Returns a cudaError_t code.
int flash_bwd_wgmma_check(const void* x, const void* k, void* out, int D,
                          void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = 1024 + hopper::tile_bytes<128>() + hopper::kChunkBytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = D == 64 ? allow_smem(bwd_wgmma_check_kernel<64>, bytes)
                          : allow_smem(bwd_wgmma_check_kernel<128>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (D == 64)
    bwd_wgmma_check_kernel<64><<<1, hopper::kWG, bytes, s>>>(
        static_cast<const float*>(x), static_cast<const bf16*>(k),
        static_cast<float*>(out));
  else
    bwd_wgmma_check_kernel<128><<<1, hopper::kWG, bytes, s>>>(
        static_cast<const float*>(x), static_cast<const bf16*>(k),
        static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
