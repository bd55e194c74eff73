// Ragged paged attention for Hopper (sm_90a) — kernels K3 and K4 of the
// port.
//
// Replaces: paddle_tpu/ops/ragged_attention.py::ragged_paged_attention,
// the Pallas TPU kernels launched by its `pl.pallas_call`:
//   K3 — `_kernel_body`, pools in the model dtype (rpa_launch);
//   K4 — `_kernel_body_quant`, int8 or fp8-e4m3 payload pools with f32
//        scales per (page, row, kv head) (rpa_quant_launch).
// It computes the same function — not a block-by-block carry-over:
//   out[b, qpos, h] = softmax_j(q·k_j / sqrt(hd)) · v_j over the live
//   columns j < kv_len[b] with j <= kv_len[b] − q_len[b] + qpos, reading
//   K/V rows of kv head h / groups through the slot's block table.
// A slot with q_len = 0 writes zeros. Decode rows (q_len = 1), ragged
// causal prefill rows and suffix rows (kv_len > q_len > 1) are all just
// values of (q_len, kv_len) for the same launch. K4 dequantizes each K and
// V row as the reference does: payload × scale in f32 (__fmul_rn, never
// contracted), rounded to the model type (round to nearest even; the
// identity for f32), then widened to f32 — the values the plain version
// forms, bit for bit.
//
// Two kernels compute it; ops/ragged_attention.py's `_tile_path` picks
// one by shape alone:
//   rpa_kernel      — decode rows (q_max = 1), f32 models and head dim 16
//                     (rpa_launch, rpa_quant_launch), on CUDA cores;
//   rpa_tile_kernel — bf16 prefill and suffix rows (q_max > 1) at head
//                     dims 64 and 128 (rpa_tile_launch,
//                     rpa_tile_quant_launch), on the Hopper tile core of
//                     hopper_attention.cuh.
//
// What bounds them on an H100: bytes. Decode reads 2·kv_len·KV·hd·bytes
// of pool per slot per layer (K and V once) and does ~4 flops per byte
// read; at 3.35 TB/s, B=4 slots of 1024 bf16 positions at KV=32, hd=128
// (64 MiB) take at least 20 us, and K4's int8/fp8 pages with their f32
// scales (33 MiB) at least 10 us. A 4×512-row prefill reads as much and
// does 4·hd flops per (row, column) pair, 8.6 GFLOP: 0.020 ms of bytes
// against 0.009 ms of bf16 tensor-core time. rpa_kernel therefore:
//   * reads only the ceil(kv_len/page_size) live pages, page addresses by
//     block-table pointer arithmetic, and never touches a row at or past
//     the row limit, payload or scale (no NaN or stale row in a dead tail
//     or in the scratch page can reach the output — such rows are
//     skipped, not weighted 0);
//   * loads each K/V row once per block and uses it for every query row
//     the block holds (all `groups` query heads of one kv head, and up to
//     8 query rows), a warp reading one contiguous row: 8 or 16 bytes per
//     lane for K3, 4 payload bytes per lane at hd 128 for K4 (the same
//     element-to-lane map, one byte per element), plus the row's one
//     scale, which every lane of the warp reads at one address;
//   * spreads a block's keys over 8-16 warps with 4 rows in flight per
//     warp, each warp keeping an online softmax (running max, sum and
//     accumulator in f32), merged across warps through shared memory.
// rpa_tile_kernel puts 64 query rows on one warpgroup, so each K/V row
// is read once per 64 rows (not per 8), and does both products on wgmma
// with the key tiles' loads in flight behind them (see its comment).
// Work splits into blocks by (slot, kv head, tile of query rows); each
// block reads its slot's q_len, kv_len and block-table row itself. No
// split-KV across blocks yet.
//
// Numerics: logits, softmax and accumulation in f32. rpa_kernel never
// rounds the probabilities; rpa_tile_kernel rounds the unnormalised ones
// to bf16 as wgmma's A operand. The plain version (and the TPU kernels)
// normalise first and round the probabilities to the dtype of the V rows
// before the V product. Each bf16 output element is held to the bound
// that follows from those roundings (ops/ragged_attention.py:
// `tolerance`, derived in its docstring: one more u·Σ_j p_j·|v_j| term
// for the tile kernel); f32 differs by summation order only.
//
// C interface (built by nvcc, loaded with ctypes; no PyTorch headers):
// the *_launch functions take device pointers, sizes, element strides,
// the f32 scale and the CUDA stream; they launch on that stream, allocate
// nothing, and return cudaGetLastError(). hopper_wgmma_check runs the
// tile core's first launch check.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "hopper_attention.cuh"

namespace {

constexpr int kUnroll = 4;  // key rows in flight per warp

struct Params {
  int B, q_max, H, KV, groups, ps, max_pages;
  int pages;                      // pool pages (the TMA gather's map)
  long long q_sb, q_sq, q_sh;     // q strides (elements): slot, row, head
  long long kv_sp, kv_sr, kv_sh;  // pool strides: page, row, kv head
  long long o_sb, o_sq, o_sh;     // out strides
  long long s_sp, s_sr;           // K4 scale-pool strides: page, row (the
                                  // kv head stride is 1)
  long long bt_sb;                // block-table row stride
  float scale;
};

// Device pointers of one launch; ks/vs are null for K3.
struct Ptrs {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* bt;
  const int* ql;
  const int* kl;
  void* o;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// EPL consecutive elements at p (aligned to EPL * sizeof(T)) as f32.
template <typename T, int EPL>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[EPL]) {
  if constexpr (std::is_same<T, float>::value && EPL == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (std::is_same<T, float>::value && EPL == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value && EPL == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value && EPL == 2) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x; out[1] = a.y;
  } else {
#pragma unroll
    for (int e = 0; e < EPL; ++e) out[e] = to_f32(p[e]);
  }
}

// One payload byte (the low 8 bits of b) as f32.
template <typename P>
__device__ __forceinline__ float payload_to_f32(unsigned b);
template <>
__device__ __forceinline__ float payload_to_f32<int8_t>(unsigned b) {
  return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(b)));
}
template <>
__device__ __forceinline__ float payload_to_f32<__nv_fp8_e4m3>(unsigned b) {
  __nv_fp8_e4m3 x;
  x.__x = static_cast<__nv_fp8_storage_t>(b);
  return static_cast<float>(x);  // exact: e4m3 -> half -> float
}

// An f32 value rounded to the model type T, as f32.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// EPL consecutive one-byte payload elements at p (aligned to EPL bytes),
// dequantized with the row's scale s: payload × s in f32, rounded to T.
template <typename T, typename P, int EPL>
__device__ __forceinline__ void load_dequant(const P* p, float s,
                                             float (&out)[EPL]) {
  unsigned raw;
  if constexpr (EPL == 4) {
    raw = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (EPL == 2) {
    raw = *reinterpret_cast<const uint16_t*>(p);
  } else {
    static_assert(EPL == 1, "one, two or four payload bytes per lane");
    raw = *reinterpret_cast<const uint8_t*>(p);
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    out[e] = round_to<T>(
        __fmul_rn(payload_to_f32<P>((raw >> (8 * e)) & 0xffu), s));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block: slot b, kv head kvh, query rows [r0, r0 + ROWS) of the
// regrouped [q_max * groups] row axis (row = qpos * groups + gi, query
// head = kvh * groups + gi). NW warps split the key rows. T is the model
// type (q, out); P the pool's: P = T is K3, a one-byte P is K4, whose
// rows are dequantized with kscale / vscale.
template <typename T, typename P, int HD, int ROWS, int NW>
__global__ void __launch_bounds__(NW * 32)
rpa_kernel(const T* __restrict__ q, const P* __restrict__ kpool,
           const P* __restrict__ vpool, const float* __restrict__ kscale,
           const float* __restrict__ vscale,
           const int* __restrict__ block_table,
           const int* __restrict__ q_lens, const int* __restrict__ kv_lens,
           T* __restrict__ out, const Params p) {
  constexpr bool kQuant = !std::is_same<T, P>::value;
  constexpr int EPL = HD >= 32 ? HD / 32 : 1;  // elements per lane
  __shared__ float sm_acc[NW][ROWS][HD];
  __shared__ float sm_m[NW][ROWS];
  __shared__ float sm_l[NW][ROWS];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool lane_on = lane * EPL < HD;  // HD = 16: lanes 16..31 idle
  const int b = blockIdx.x / p.KV;
  const int kvh = blockIdx.x % p.KV;
  const int span = p.q_max * p.groups;
  const int r0 = blockIdx.y * ROWS;
  const int q_len = q_lens[b];
  const int kv_len = kv_lens[b];
  const int* bt = block_table + (long long)b * p.bt_sb;

  // per-row column limit: columns [0, lim) are attended
  int lim[ROWS];
  int lmax = 0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = r0 + r;
    int l = 0;
    if (row < span && q_len > 0) {
      const int qpos = row / p.groups;
      l = min(kv_len, kv_len - q_len + qpos + 1);
      l = min(l, p.max_pages * p.ps);  // never read past the table row
      l = max(l, 0);
    }
    lim[r] = l;
    lmax = max(lmax, l);
  }

  float qr[ROWS][EPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = r0 + r;
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[r][e] = 0.f;
    if (lim[r] > 0 && lane_on) {
      const int qpos = row / p.groups;
      const int h = kvh * p.groups + row % p.groups;
      load_vec<T, EPL>(q + b * p.q_sb + qpos * p.q_sq + h * p.q_sh +
                           lane * EPL, qr[r]);
    }
  }

  float m[ROWS], l[ROWS], acc[ROWS][EPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  for (int j0 = warp * kUnroll; j0 < lmax; j0 += NW * kUnroll) {
    float kf[kUnroll][EPL], vf[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u;
#pragma unroll
      for (int e = 0; e < EPL; ++e) kf[u][e] = vf[u][e] = 0.f;
      if (j < lmax && lane_on) {
        const long long page = bt[j / p.ps];
        const long long off = page * p.kv_sp + (j % p.ps) * p.kv_sr +
                              kvh * p.kv_sh + lane * EPL;
        if constexpr (kQuant) {
          // the row's one scale per pool, at [page, row, kv head]
          const long long soff = page * p.s_sp + (j % p.ps) * p.s_sr + kvh;
          load_dequant<T, P, EPL>(kpool + off, kscale[soff], kf[u]);
          load_dequant<T, P, EPL>(vpool + off, vscale[soff], vf[u]);
        } else {
          load_vec<T, EPL>(kpool + off, kf[u]);
          load_vec<T, EPL>(vpool + off, vf[u]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float s[kUnroll];
      float m_new = m[r];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qr[r][e], kf[u][e], d);
        s[u] = warp_sum(d) * p.scale;
        if (j0 + u < lim[r]) m_new = fmaxf(m_new, s[u]);
      }
      if (j0 >= lim[r]) continue;  // no live column for this row here
      const float corr = expf(m[r] - m_new);  // 0 while m[r] = -inf
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= corr;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + u >= lim[r]) break;  // skipped, never multiplied in
        const float pu = expf(s[u] - m_new);
        l[r] += pu;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(pu, vf[u][e], acc[r][e]);
      }
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (lane_on) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[warp][r][lane * EPL + e] = acc[r][e];
    }
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < ROWS * HD; idx += NW * 32) {
    const int r = idx / HD;
    const int d = idx % HD;
    const int row = r0 + r;
    if (row >= span) continue;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float o = 0.f;
    if (mx != -INFINITY) {  // else: no live column (q_len = 0) -> zeros
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (sm_m[w][r] == -INFINITY) continue;
        const float c = expf(sm_m[w][r] - mx);
        den = fmaf(sm_l[w][r], c, den);
        num = fmaf(sm_acc[w][r][d], c, num);
      }
      o = num / den;
    }
    const int qpos = row / p.groups;
    const int h = kvh * p.groups + row % p.groups;
    store(out + b * p.o_sb + qpos * p.o_sq + h * p.o_sh + d, o);
  }
}

// ------------------------------------------------ prefill: the tile path
// Slot b, kv head kvh, one 64-row tile of the regrouped [q_max · groups]
// row axis (rows as in rpa_kernel), on the Hopper tile core
// (hopper_attention.cuh): one warpgroup, Q gathered once by cp.async, key
// tiles of 64 rows gathered through the block table into a two-stage
// ring, the copy of tile j+1 in flight while tile j's wgmma products run.
// K3 (P = bf16) gathers K and V straight into the swizzled tiles: by TMA
// when the page size is a multiple of 8 (kTma: one box of min(ps, 64)
// page rows per live page and 64-column chunk, issued by one thread and
// counted on the stage's mbarrier; measured faster than per-row copies at
// every shape tried, PERF.md), else by 16-byte cp.async copies per row
// (a row's page is bt[row / ps]). K4 (one-byte P) gathers payload rows
// and their f32 scales by cp.async into a staging ring, and the threads
// dequantize a staged tile into the bf16 K and V tiles exactly as
// load_dequant does. No row at or past the tile's largest limit enters a
// product with a nonzero weight: cp.async copies of such rows read
// nothing and write zeros; a TMA box brings in the rest of the last live
// page, so V rows past the limit are zeroed in shared memory before P·V,
// and K rows there only meet masked columns. So a NaN payload, scale or
// K/V row past kv_len cannot reach an output, and key tiles past the
// limit are never loaded. Only tiles that reach past the tile's smallest
// limit test columns.
template <typename P, int HD>
__host__ __device__ constexpr int tile_smem() {
  // Q, then K3: two stages of K and V tiles; K4: one K and V tile pair
  // and two stages of payload (K, V) and scales (K, V); two mbarriers
  return 1024 + 16 + hopper::tile_bytes<HD>() +
         (std::is_same<P, __nv_bfloat16>::value
              ? 4 * hopper::tile_bytes<HD>()
              : 2 * hopper::tile_bytes<HD>() +
                    2 * (2 * hopper::kTile * HD + 2 * hopper::kTile * 4));
}

template <typename P, int HD, bool kTma>
__global__ void __launch_bounds__(hopper::kWG)
rpa_tile_kernel(const __nv_bfloat16* __restrict__ q,
                const P* __restrict__ kpool, const P* __restrict__ vpool,
                const float* __restrict__ kscale,
                const float* __restrict__ vscale,
                const int* __restrict__ block_table,
                const int* __restrict__ q_lens,
                const int* __restrict__ kv_lens,
                __nv_bfloat16* __restrict__ out,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Params p) {
  using hopper::kTile;
  constexpr bool kQuant = !std::is_same<P, __nv_bfloat16>::value;
  static_assert(!(kQuant && kTma), "TMA pages are bf16 only");
  constexpr int TB = hopper::tile_bytes<HD>();
  constexpr int PIECES = kTile * HD / 8;   // 16-byte bf16 pieces of a tile
  constexpr int STAGE = kQuant ? 2 * kTile * HD + 2 * kTile * 4 : 2 * TB;
  extern __shared__ __align__(16) uint8_t rpa_smem[];
  uint8_t* sQ = hopper::align_1024(rpa_smem);
  // K3: stage s holds K at ring + s·STAGE, V TB after it. K4: the bf16 K
  // and V tiles at kv, then stage s: K payload, V payload, K scales, V
  // scales at ring + s·STAGE.
  uint8_t* kv = sQ + TB;
  uint8_t* ring = kQuant ? kv + 2 * TB : kv;
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + 2 * STAGE);

  const int b = blockIdx.x / p.KV;
  const int kvh = blockIdx.x % p.KV;
  const int span = p.q_max * p.groups;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kTile;   // longest first
  const int q_len = q_lens[b];
  const int kv_len = kv_lens[b];
  const int* bt = block_table + (long long)b * p.bt_sb;
  // a row's column limit, as rpa_kernel: columns [0, lim) are attended
  auto limit = [&](int row) {
    if (row >= span || q_len <= 0) return 0;
    int l = min(kv_len, kv_len - q_len + row / p.groups + 1);
    l = min(l, p.max_pages * p.ps);  // never read past the table row
    return max(l, 0);
  };
  // limits grow with the row: the tile's smallest is its first row's,
  // its largest its last live row's
  const int lmin = limit(r0);
  const int lmax = limit(min(r0 + kTile, span) - 1);
  const int lim[2] = {limit(r0 + hopper::acc_row(0)),
                      limit(r0 + hopper::acc_row(1))};
  const int n_kv = (lmax + kTile - 1) / kTile;
  const float scale_log2 = p.scale * hopper::kLog2e;
  const int tid = threadIdx.x;

  // the pool row of key j (j < lmax): its page's row, kv head kvh
  auto pool_row = [&](int j) {
    return (long long)bt[j / p.ps] * p.kv_sp + (j % p.ps) * p.kv_sr +
           kvh * p.kv_sh;
  };
  auto issue = [&](int kt, int stage) {
    uint8_t* st = ring + stage * STAGE;
    if constexpr (kTma) {
      // one box of R = min(ps, 64) page rows per live page of the tile
      // and 64-column chunk, by one thread, counted on the stage's
      // mbarrier; rows past lmax in the last page are zeroed in V later
      if (tid == 0) {
        const int j0 = kt * kTile;
        const int R = min(p.ps, kTile);
        const int nbox = (min(lmax - j0, kTile) + R - 1) / R;
        hopper::mbar_expect_tx(bar + stage, nbox * R * HD * 2 * 2);
        for (int i = 0; i < nbox; ++i) {
          const int j = j0 + i * R;
          const int prow = bt[j / p.ps] * p.ps + j % p.ps;
#pragma unroll
          for (int c = 0; c < HD / 64; ++c) {
            const int at = c * hopper::kChunkBytes + i * R * 128;
            hopper::tma_load_3d(st + at, &tk, bar + stage, c * 64, kvh,
                                prow);
            hopper::tma_load_3d(st + TB + at, &tv, bar + stage, c * 64, kvh,
                                prow);
          }
        }
      }
    } else if constexpr (!kQuant) {
      for (int i = tid; i < PIECES; i += hopper::kWG) {
        const int r = i / (HD / 8), c = i % (HD / 8);
        const int j = kt * kTile + r;
        const bool live = j < lmax;
        const long long off = live ? pool_row(j) + c * 8 : 0;
        const uint32_t at = hopper::swz(r, c);
        hopper::cp_async16(st + at, kpool + off, live ? 16 : 0);
        hopper::cp_async16(st + TB + at, vpool + off, live ? 16 : 0);
      }
    } else {
      constexpr int RP = HD / 16;      // 16-byte payload pieces a row
      for (int i = tid; i < kTile * RP; i += hopper::kWG) {
        const int r = i / RP, c = i % RP;
        const int j = kt * kTile + r;
        const bool live = j < lmax;
        const long long off = live ? pool_row(j) + c * 16 : 0;
        hopper::cp_async16(st + r * HD + c * 16, kpool + off,
                           live ? 16 : 0);
        hopper::cp_async16(st + kTile * HD + r * HD + c * 16, vpool + off,
                           live ? 16 : 0);
      }
      {  // the rows' scales: K by threads 0..63, V by 64..127
        const int r = tid & (kTile - 1);
        const int j = kt * kTile + r;
        const bool live = j < lmax;
        const long long soff =
            live ? (long long)bt[j / p.ps] * p.s_sp + (j % p.ps) * p.s_sr +
                       kvh
                 : 0;
        float* dst = reinterpret_cast<float*>(st + 2 * kTile * HD) +
                     (tid >= kTile ? kTile : 0) + r;
        hopper::cp_async4(dst, (tid >= kTile ? vscale : kscale) + soff,
                          live ? 4 : 0);
      }
    }
  };

  if (n_kv > 0) {
    // Q rows of the tile, zeros past the row axis (group 0, with tile 0)
    for (int i = tid; i < PIECES; i += hopper::kWG) {
      const int r = i / (HD / 8), c = i % (HD / 8);
      const int row = r0 + r;
      const bool live = row < span;
      const long long off =
          live ? b * p.q_sb + (row / p.groups) * p.q_sq +
                     (kvh * p.groups + row % p.groups) * p.q_sh + c * 8
               : 0;
      hopper::cp_async16(sQ + hopper::swz(r, c), q + off, live ? 16 : 0);
    }
    if constexpr (kTma) {
      if (tid == 0) {
        hopper::mbar_init(bar, 1);
        hopper::mbar_init(bar + 1, 1);
        hopper::fence_barrier_init();
      }
      __syncthreads();
    }
    issue(0, 0);
    hopper::cp_async_commit();
  }

  hopper::FwdTile<HD> st;
  st.init();
  for (int kt = 0; kt < n_kv; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < n_kv) {
      __syncthreads();   // every warp is done with tile kt-1's stage
      issue(kt + 1, s ^ 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();   // this thread's copies of tile kt
    } else {
      hopper::cp_async_wait<0>();
    }
    const uint8_t* sK = ring + s * STAGE;
    const uint8_t* sV = sK + TB;
    if constexpr (kTma) {
      hopper::mbar_wait(bar + s, (kt >> 1) & 1);
      const int dead = lmax - kt * kTile;   // rows of V past lmax: zeros
      if (dead < kTile) {
        uint8_t* v = ring + s * STAGE + TB;
        for (int i = tid; i < (kTile - dead) * (HD / 8); i += hopper::kWG)
          *reinterpret_cast<uint4*>(
              v + hopper::swz(dead + i / (HD / 8), i % (HD / 8))) =
              make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if constexpr (kQuant) {
      __syncthreads();   // the staged tile is complete for every thread
      const uint8_t* st8 = ring + s * STAGE;
      const float* sc = reinterpret_cast<const float*>(st8 + 2 * kTile * HD);
      for (int i = tid; i < 2 * PIECES; i += hopper::kWG) {
        const int which = i / PIECES;           // 0: K, 1: V
        const int r = (i % PIECES) / (HD / 8), c = (i % PIECES) % (HD / 8);
        const uint2 raw = *reinterpret_cast<const uint2*>(
            st8 + which * kTile * HD + r * HD + c * 8);
        const float scale = sc[which * kTile + r];
        float f[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          f[e] = __fmul_rn(payload_to_f32<P>(
                               ((e < 4 ? raw.x : raw.y) >> (8 * (e & 3))) &
                               0xffu),
                           scale);
        uint4 pk;
        pk.x = hopper::pack_bf16(f[0], f[1]);
        pk.y = hopper::pack_bf16(f[2], f[3]);
        pk.z = hopper::pack_bf16(f[4], f[5]);
        pk.w = hopper::pack_bf16(f[6], f[7]);
        *reinterpret_cast<uint4*>(kv + which * TB + hopper::swz(r, c)) = pk;
      }
      sK = kv;
      sV = kv + TB;
    }
    hopper::fence_proxy_async();
    __syncthreads();     // tile kt (and Q) visible to every warp's wgmma
    const int c0 = kt * kTile;
    float sc[32];
    hopper::qk_tile<HD>(sc, sQ, sK);
    st.softmax(sc, scale_log2, c0 + kTile > lmin,
               [&](int i, int c) { return c0 + c < lim[i]; });
    hopper::pv_tile<HD>(st.o, sc, sV);
  }

  // rows with no live column (q_len = 0) leave o = 0: zeros
  st.finish();
  const int t = tid & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + hopper::acc_row(i);
    if (row >= span) continue;
    const float inv = 1.f / st.denom(i);
    __nv_bfloat16* orow = out + b * p.o_sb + (row / p.groups) * p.o_sq +
                          (kvh * p.groups + row % p.groups) * p.o_sh;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(st.o[4 * j + 2 * i] * inv,
                                st.o[4 * j + 2 * i + 1] * inv);
  }
}

template <typename P, int HD, bool kTma = false>
int launch_tile(const Params& p, const Ptrs& a, cudaStream_t stream) {
  constexpr int bytes = tile_smem<P, HD>();
  CUtensorMap tk{}, tv{};
  if constexpr (kTma) {
    const int R = p.ps < hopper::kTile ? p.ps : hopper::kTile;
    if (p.ps % 8 || p.kv_sp != p.ps * p.kv_sr)
      return static_cast<int>(cudaErrorInvalidValue);
    int err = hopper::encode_pool_rows(&tk, a.k, p.pages * p.ps, p.KV, HD,
                                       p.kv_sr, p.kv_sh, R);
    if (!err)
      err = hopper::encode_pool_rows(&tv, a.v, p.pages * p.ps, p.KV, HD,
                                     p.kv_sr, p.kv_sh, R);
    if (err) return err;
  }
  cudaError_t e = cudaFuncSetAttribute(
      rpa_tile_kernel<P, HD, kTma>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (p.q_max * p.groups + hopper::kTile - 1) / hopper::kTile;
  const dim3 grid(p.B * p.KV, tiles, 1);
  rpa_tile_kernel<P, HD, kTma><<<grid, hopper::kWG, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const P*>(a.k),
      static_cast<const P*>(a.v), a.ks, a.vs, a.bt, a.ql, a.kl,
      static_cast<__nv_bfloat16*>(a.o), tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

// The tile path takes bf16 models at head dims 64 and 128, with a page
// size that divides the 64-row key tile or is a multiple of it. K3
// gathers pages by TMA when the page size is a multiple of 8 (the boxes
// then start on the 1024-byte swizzle pattern), by cp.async otherwise.
template <typename P, int HD>
int launch_tile_gather(const Params& p, const Ptrs& a, cudaStream_t stream) {
  if constexpr (std::is_same<P, __nv_bfloat16>::value) {
    if (p.ps % 8 == 0) return launch_tile<P, HD, true>(p, a, stream);
  }
  return launch_tile<P, HD, false>(p, a, stream);
}

template <typename P>
int launch_tile_hd(const Params& p, int hd, const Ptrs& a,
                   cudaStream_t stream) {
  if (!(64 % p.ps == 0 || p.ps % 64 == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 64) return launch_tile_gather<P, 64>(p, a, stream);
  if (hd == 128) return launch_tile_gather<P, 128>(p, a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The first launch check of the tile core: one 64-row tile S = Q·Kᵀ
// (wgmma m64n64k16 from shared memory) and O = bf16(S)·V (wgmma m64n128k16,
// P from registers, V MN-major), Q, K, V [64, 128] bf16 row-major, S [64,
// 64] and O [64, 128] f32 row-major.
__global__ void __launch_bounds__(hopper::kWG)
wgmma_check_kernel(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, float* s_out, float* o_out) {
  constexpr int TB = hopper::tile_bytes<128>();
  extern __shared__ __align__(16) uint8_t chk_smem[];
  uint8_t* sQ = hopper::align_1024(chk_smem);
  uint8_t* sK = sQ + TB;
  uint8_t* sV = sK + TB;
  for (int i = threadIdx.x; i < 64 * 16; i += hopper::kWG) {
    const int r = i / 16, c = i % 16;
    const uint32_t at = hopper::swz(r, c);
    *reinterpret_cast<uint4*>(sQ + at) =
        *reinterpret_cast<const uint4*>(q + r * 128 + c * 8);
    *reinterpret_cast<uint4*>(sK + at) =
        *reinterpret_cast<const uint4*>(k + r * 128 + c * 8);
    *reinterpret_cast<uint4*>(sV + at) =
        *reinterpret_cast<const uint4*>(v + r * 128 + c * 8);
  }
  hopper::fence_proxy_async();
  __syncthreads();
  float s[32], o[64];
  hopper::qk_tile<128>(s, sQ, sK);
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  hopper::pv_tile<128>(o, s, sV);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = hopper::acc_row(i);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        s_out[r * 64 + hopper::acc_col(j, c)] = s[4 * j + 2 * i + c];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        o_out[r * 128 + hopper::acc_col(j, c)] = o[4 * j + 2 * i + c];
  }
}

template <typename T, typename P, int HD, int ROWS>
void launch_rows(const Params& p, const Ptrs& a, cudaStream_t stream) {
  // 16 warps keep enough rows in flight for decode's few blocks; at 8
  // query rows the merge buffer would pass 48 KB, so 8 warps there
  constexpr int NW = ROWS >= 8 ? 8 : 16;
  const dim3 grid(p.B * p.KV, (p.q_max * p.groups + ROWS - 1) / ROWS, 1);
  rpa_kernel<T, P, HD, ROWS, NW><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const P*>(a.k),
      static_cast<const P*>(a.v), a.ks, a.vs, a.bt, a.ql, a.kl,
      static_cast<T*>(a.o), p);
}

template <typename T, typename P, int HD>
void launch_hd(const Params& p, const Ptrs& a, cudaStream_t stream) {
  const int span = p.q_max * p.groups;
  if (span >= 8)
    launch_rows<T, P, HD, 8>(p, a, stream);
  else if (span > 2)
    launch_rows<T, P, HD, 4>(p, a, stream);
  else if (span == 2)
    launch_rows<T, P, HD, 2>(p, a, stream);
  else
    launch_rows<T, P, HD, 1>(p, a, stream);
}

template <typename T, typename P>
int launch_types(const Params& p, int hd, const Ptrs& a,
                 cudaStream_t stream) {
  switch (hd) {
    case 16: launch_hd<T, P, 16>(p, a, stream); break;
    case 64: launch_hd<T, P, 64>(p, a, stream); break;
    case 128: launch_hd<T, P, 128>(p, a, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Fills p; returns a cudaError_t code (0 = the sizes can be launched).
int make_params(Params& p, int B, int q_max, int H, int KV, int page_size,
                int max_pages, long long q_sb, long long q_sq, long long q_sh,
                long long kv_sp, long long kv_sr, long long kv_sh,
                long long o_sb, long long o_sq, long long o_sh,
                long long s_sp, long long s_sr, long long bt_sb,
                float scale) {
  if (B <= 0 || q_max <= 0 || KV <= 0 || H % KV != 0 || page_size <= 0 ||
      max_pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.B = B; p.q_max = q_max; p.H = H; p.KV = KV; p.groups = H / KV;
  p.pages = 0;
  p.ps = page_size; p.max_pages = max_pages;
  p.q_sb = q_sb; p.q_sq = q_sq; p.q_sh = q_sh;
  p.kv_sp = kv_sp; p.kv_sr = kv_sr; p.kv_sh = kv_sh;
  p.o_sb = o_sb; p.o_sq = o_sq; p.o_sh = o_sh;
  p.s_sp = s_sp; p.s_sr = s_sr;
  p.bt_sb = bt_sb; p.scale = scale;
  if ((p.q_max * p.groups + 7) / 8 > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  return 0;
}

}  // namespace

extern "C" {

// K3. dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).
// Strides are in elements; the last dimension of q, the pools and out is
// contiguous. Returns a cudaError_t code (0 = launched).
int rpa_launch(const void* q, const void* k_pool, const void* v_pool,
               const void* block_table, const void* q_lens,
               const void* kv_lens, void* out, int dtype, int B, int q_max,
               int H, int KV, int hd, int page_size, int max_pages,
               long long q_sb, long long q_sq, long long q_sh,
               long long kv_sp, long long kv_sr, long long kv_sh,
               long long o_sb, long long o_sq, long long o_sh,
               long long bt_sb, float scale, void* stream) {
  Params p;
  const int bad = make_params(p, B, q_max, H, KV, page_size, max_pages, q_sb,
                              q_sq, q_sh, kv_sp, kv_sr, kv_sh, o_sb, o_sq,
                              o_sh, 0, 0, bt_sb, scale);
  if (bad) return bad;
  const Ptrs a{q, k_pool, v_pool, nullptr, nullptr,
               static_cast<const int*>(block_table),
               static_cast<const int*>(q_lens),
               static_cast<const int*>(kv_lens), out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_types<float, float>(p, hd, a, s);
  if (dtype == 1)
    return launch_types<__nv_bfloat16, __nv_bfloat16>(p, hd, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4. dtype: 0 = float32, 1 = bfloat16 (q and out); payload: 0 = int8,
// 1 = fp8 e4m3 (both pools). k_scale / v_scale are f32 [pages, page_size,
// KV] with strides s_sp, s_sr and 1. Other arguments as rpa_launch.
int rpa_quant_launch(const void* q, const void* k_pool, const void* v_pool,
                     const void* k_scale, const void* v_scale,
                     const void* block_table, const void* q_lens,
                     const void* kv_lens, void* out, int dtype, int payload,
                     int B, int q_max, int H, int KV, int hd, int page_size,
                     int max_pages, long long q_sb, long long q_sq,
                     long long q_sh, long long kv_sp, long long kv_sr,
                     long long kv_sh, long long o_sb, long long o_sq,
                     long long o_sh, long long s_sp, long long s_sr,
                     long long bt_sb, float scale, void* stream) {
  Params p;
  const int bad = make_params(p, B, q_max, H, KV, page_size, max_pages, q_sb,
                              q_sq, q_sh, kv_sp, kv_sr, kv_sh, o_sb, o_sq,
                              o_sh, s_sp, s_sr, bt_sb, scale);
  if (bad) return bad;
  const Ptrs a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(block_table),
               static_cast<const int*>(q_lens),
               static_cast<const int*>(kv_lens), out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && payload == 0)
    return launch_types<float, int8_t>(p, hd, a, s);
  if (dtype == 0 && payload == 1)
    return launch_types<float, __nv_fp8_e4m3>(p, hd, a, s);
  if (dtype == 1 && payload == 0)
    return launch_types<__nv_bfloat16, int8_t>(p, hd, a, s);
  if (dtype == 1 && payload == 1)
    return launch_types<__nv_bfloat16, __nv_fp8_e4m3>(p, hd, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tile path (rpa_tile_kernel) for K3: bf16 only, head dims 64 and
// 128, a page size dividing 64 or a multiple of it; the arguments of
// rpa_launch and, after max_pages, the pool's page count (the extent of
// the TMA maps over the pools, which must be contiguous). Returns a
// cudaError_t code (0 = launched).
int rpa_tile_launch(const void* q, const void* k_pool, const void* v_pool,
                    const void* block_table, const void* q_lens,
                    const void* kv_lens, void* out, int dtype, int B,
                    int q_max, int H, int KV, int hd, int page_size,
                    int max_pages, int num_pages, long long q_sb,
                    long long q_sq, long long q_sh, long long kv_sp,
                    long long kv_sr, long long kv_sh, long long o_sb,
                    long long o_sq, long long o_sh, long long bt_sb,
                    float scale, void* stream) {
  Params p;
  const int bad = make_params(p, B, q_max, H, KV, page_size, max_pages, q_sb,
                              q_sq, q_sh, kv_sp, kv_sr, kv_sh, o_sb, o_sq,
                              o_sh, 0, 0, bt_sb, scale);
  if (bad) return bad;
  if (dtype != 1 || num_pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.pages = num_pages;
  const Ptrs a{q, k_pool, v_pool, nullptr, nullptr,
               static_cast<const int*>(block_table),
               static_cast<const int*>(q_lens),
               static_cast<const int*>(kv_lens), out};
  return launch_tile_hd<__nv_bfloat16>(p, hd, a,
                                       static_cast<cudaStream_t>(stream));
}

// The tile path for K4: bf16 model, int8 (payload 0) or fp8 e4m3 (1)
// pools; the arguments of rpa_quant_launch.
int rpa_tile_quant_launch(const void* q, const void* k_pool,
                          const void* v_pool, const void* k_scale,
                          const void* v_scale, const void* block_table,
                          const void* q_lens, const void* kv_lens, void* out,
                          int dtype, int payload, int B, int q_max, int H,
                          int KV, int hd, int page_size, int max_pages,
                          long long q_sb, long long q_sq, long long q_sh,
                          long long kv_sp, long long kv_sr, long long kv_sh,
                          long long o_sb, long long o_sq, long long o_sh,
                          long long s_sp, long long s_sr, long long bt_sb,
                          float scale, void* stream) {
  Params p;
  const int bad = make_params(p, B, q_max, H, KV, page_size, max_pages, q_sb,
                              q_sq, q_sh, kv_sp, kv_sr, kv_sh, o_sb, o_sq,
                              o_sh, s_sp, s_sr, bt_sb, scale);
  if (bad) return bad;
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Ptrs a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(block_table),
               static_cast<const int*>(q_lens),
               static_cast<const int*>(kv_lens), out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (payload == 0) return launch_tile_hd<int8_t>(p, hd, a, s);
  if (payload == 1) return launch_tile_hd<__nv_fp8_e4m3>(p, hd, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tile core's first launch check (wgmma_check_kernel) on device
// pointers. Returns a cudaError_t code.
int hopper_wgmma_check(const void* q, const void* k, const void* v,
                       void* s_out, void* o_out, void* stream) {
  constexpr int bytes = 1024 + 3 * hopper::tile_bytes<128>();
  cudaError_t e = cudaFuncSetAttribute(
      wgmma_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  wgmma_check_kernel<<<1, hopper::kWG, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(s_out),
      static_cast<float*>(o_out));
  return static_cast<int>(cudaGetLastError());
}

const char* rpa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
