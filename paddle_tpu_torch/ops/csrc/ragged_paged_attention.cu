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
//   * splits the keys of each (slot, kv head, query rows) tile into
//     page-aligned chunks over the grid's third axis when the tiles alone
//     would not fill the card several times over (B·KV = 128 decode
//     tiles against 132 SMs; ops/ragged_attention.py's `_split_plan`
//     picks the chunk from the shapes), and merges the chunks' partials
//     in the same launch (see its comment);
//   * reads only the live pages of its chunk, their block-table entries
//     staged in shared memory once, and never touches a row at or past
//     the rows' limit, payload or scale (no NaN or stale row in a dead
//     tail or in the scratch page can reach the output — such rows are
//     skipped, not weighted 0);
//   * loads each K/V row once per block and uses it for every query row
//     the block holds (all `groups` query heads of one kv head, and up to
//     8 query rows), 16 bytes a lane, with the next step's rows in flight
//     while the current step computes; K4 reads a row's one scale at one
//     address for every lane of the row.
// rpa_tile_kernel puts 64 query rows on one warpgroup, so each K/V row
// is read once per 64 rows (not per 8), and does both products on wgmma
// with the key tiles' loads in flight behind them (see its comment).
// Each block reads its slot's q_len, kv_len and block-table row itself.
//
// Numerics: logits, softmax, accumulation and rpa_kernel's partials and
// their merge in f32. rpa_kernel never rounds the probabilities; rpa_tile_kernel rounds the unnormalised ones
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
// nothing (rpa_kernel's workspace and tickets come from the caller), and
// return cudaGetLastError(). hopper_wgmma_check runs the
// tile core's first launch check.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "hopper_attention.cuh"

namespace {

struct Params {
  int B, q_max, H, KV, groups, ps, max_pages;
  int pages;                      // pool pages (the TMA gather's map)
  int rows, chunk;                // rpa_kernel: query rows a block, keys a
                                  // chunk (the grid's split axis)
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
  float* ws;      // rpa_kernel's f32 partials, when it splits the keys
  int* tickets;   // one a (slot, kv head, rows) tile, zero between launches
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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

// Byte i (0..3) of w, a one-byte payload, as f32 — payload_to_f32's
// value. int8 without a conversion instruction (those run at a quarter of
// the FMA rate): 2^23 + (b ^ 0x80) built by one byte permute, less 2^23 +
// 128, exact; e4m3 through its hardware conversion. (An integer path for
// e4m3 and an integer bf16 rounding measured slower on an H100, PERF.md.)
template <typename P>
__device__ __forceinline__ float payload_byte_to_f32(uint32_t w, int i) {
  return payload_to_f32<P>((w >> (8 * i)) & 0xffu);
}
template <>
__device__ __forceinline__ float payload_byte_to_f32<int8_t>(uint32_t w,
                                                             int i) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u,
                                     0x7540 | i)) - 8388736.f;
}

// 16 bytes of a row of P (16 / sizeof(P) elements) as f32: f32 and bf16
// widened exactly; a one-byte payload dequantized with the row's scale s
// as the reference does — payload × s in f32 (__fmul_rn, never
// contracted), rounded to the model type T.
template <typename T, typename P>
__device__ __forceinline__ void unpack16(const uint4& raw, float s,
                                         float (&out)[16 / sizeof(P)]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (std::is_same<P, float>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = __uint_as_float(w[i]);
  } else if constexpr (std::is_same<P, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      out[i] = round_to<T>(
          __fmul_rn(payload_byte_to_f32<P>(w[i >> 2], i & 3), s));
  }
}

// --------------------------------------------------- decode: rpa_kernel
// One block: slot b, kv head kvh, query rows [r0, r0 + ROWS) of the
// regrouped [q_max * groups] row axis (row = qpos * groups + gi, query
// head = kvh * groups + gi), and one chunk [c0, c0 + chunk) of the key
// axis (blockIdx.z; chunks are whole pages). T is the model type (q, out);
// P the pool's: P = T is K3, a one-byte P is K4, whose rows are
// dequantized with kscale / vscale.
//
// Inside the block, each lane loads 16 bytes of a K or V row, so a row
// takes LPR = HD·sizeof(P)/16 lanes (16 for bf16 at hd 128, 8 for K4's
// one-byte payloads) and a warp reads 32/LPR rows at once; each such lane
// group is a worker with its own online softmax (base 2, the scale times
// log2(e) folded into q) over every NWK-th key, U keys a step, the next
// step's rows already in flight in registers while the current step
// computes. The chunk's block-table entries are staged in shared memory
// once, so a row's load is one global round trip. Workers merge by
// shuffles within a warp and through shared memory across warps. With one
// chunk the block writes out; with more, it writes its partial (m, l,
// acc) in f32 to the workspace, and the last block of the (slot, kv head,
// rows) tile to arrive — an atomic ticket, which it then resets for the
// next launch — merges every chunk's partial by the lse rule and writes
// out: a call stays one launch. A chunk wholly past the rows' limits
// reads nothing and contributes m = −inf.
constexpr int kDecWarps = 4;     // warps of one rpa_kernel block
constexpr int kWinPages = 256;   // block-table entries staged at a time

template <typename T, typename P, int HD, int ROWS>
__global__ void __launch_bounds__(kDecWarps * 32)
rpa_kernel(const T* __restrict__ q, const P* __restrict__ kpool,
           const P* __restrict__ vpool, const float* __restrict__ kscale,
           const float* __restrict__ vscale,
           const int* __restrict__ block_table,
           const int* __restrict__ q_lens, const int* __restrict__ kv_lens,
           T* __restrict__ out, float* __restrict__ ws,
           int* __restrict__ tickets, const Params p) {
  constexpr bool kQuant = !std::is_same<T, P>::value;
  constexpr int EPL = 16 / static_cast<int>(sizeof(P));  // elements a lane
  constexpr int LPR = HD / EPL;           // lanes a K/V row
  constexpr int RPW = 32 / LPR;           // rows a warp loads at once
  constexpr int NWK = kDecWarps * RPW;    // workers of the block
  constexpr int U = kQuant || ROWS >= 8 ? 2 : 4;   // keys a worker a step
  constexpr int QV = 16 / static_cast<int>(sizeof(T));  // q elements / 16 B
  static_assert(HD % EPL == 0 && LPR >= 1 && LPR <= 32 && 32 % LPR == 0,
                "a K/V row must take a power-of-two share of a warp");
  __shared__ float sm_acc[kDecWarps][ROWS][HD];
  __shared__ float sm_m[kDecWarps][ROWS];
  __shared__ float sm_l[kDecWarps][ROWS];
  __shared__ int s_bt[kWinPages];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int li = lane % LPR;                // the lane's 16 bytes of a row
  const int wk = warp * RPW + lane / LPR;   // the lane's worker
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
  // this block's chunk of the keys, [c0, c1); row r's live keys in it end
  // at end[r]
  const int c0 = blockIdx.z * p.chunk;
  const int c1 = min(c0 + p.chunk, lmax);
  int end[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) end[r] = min(c1, lim[r]);

  // q rows, times scale·log2(e), of the rows with a live key here
  const float qscale = p.scale * hopper::kLog2e;
  float qr[ROWS][EPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = r0 + r;
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[r][e] = 0.f;
    if (c0 < end[r]) {
      const T* qp = q + b * p.q_sb + (row / p.groups) * p.q_sq +
                    (kvh * p.groups + row % p.groups) * p.q_sh + li * EPL;
#pragma unroll
      for (int c = 0; c < EPL / QV; ++c) {
        float t[QV];
        unpack16<T, T>(*reinterpret_cast<const uint4*>(qp + c * QV), 0.f, t);
#pragma unroll
        for (int e = 0; e < QV; ++e) qr[r][c * QV + e] = t[e] * qscale;
      }
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

  // the K and V rows (16 bytes of each) and K4's scales of keys j0 +
  // u·NWK + wk, u < U, of the staged window [w0, w1); zeros past w1,
  // where nothing is read
  auto fetch = [&](int j0, int w0, int w1, uint4 (&kr)[U], uint4 (&vr)[U],
                   float (&ks)[U], float (&vs)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * NWK + wk;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      ks[u] = vs[u] = 0.f;
      if (j < w1) {
        const long long page = s_bt[(j - w0) / p.ps];
        const long long off = page * p.kv_sp + (j % p.ps) * p.kv_sr +
                              kvh * p.kv_sh + li * EPL;
        kr[u] = *reinterpret_cast<const uint4*>(kpool + off);
        vr[u] = *reinterpret_cast<const uint4*>(vpool + off);
        if constexpr (kQuant) {
          // the row's one scale per pool, at [page, row, kv head]
          const long long soff = page * p.s_sp + (j % p.ps) * p.s_sr + kvh;
          ks[u] = kscale[soff];
          vs[u] = vscale[soff];
        }
      }
    }
  };
  // one step: keys j0 + u·NWK + wk into each row's online softmax; a key
  // at or past a row's end is skipped, never multiplied in
  auto consume = [&](int j0, const uint4 (&kr)[U], const uint4 (&vr)[U],
                     const float (&ks)[U], const float (&vs)[U]) {
    float kf[U][EPL], vf[U][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      unpack16<T, P>(kr[u], ks[u], kf[u]);
      unpack16<T, P>(vr[u], vs[u], vf[u]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float s[U];
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qr[r][e], kf[u][e], d);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        s[u] = d;
        if (j0 + u * NWK + wk < end[r]) mx = fmaxf(mx, d);
      }
      if (mx == -INFINITY) continue;  // no live key for this row yet
      const float corr = exp2f(m[r] - mx);  // 0 while m[r] = −inf
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + u * NWK + wk >= end[r]) continue;
        const float pu = exp2f(s[u] - mx);
        l[r] += pu;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[r][e] = fmaf(pu, vf[u][e], acc[r][e]);
      }
      m[r] = mx;
    }
  };

  for (int w0 = c0; w0 < c1; w0 += kWinPages * p.ps) {
    const int w1 = min(c1, w0 + kWinPages * p.ps);
    __syncthreads();   // the previous window's table entries are consumed
    for (int i = tid; i < (w1 - w0 + p.ps - 1) / p.ps; i += kDecWarps * 32)
      s_bt[i] = bt[w0 / p.ps + i];
    __syncthreads();
    uint4 kc[U], vc[U];
    float ksc[U], vsc[U];
    fetch(w0, w0, w1, kc, vc, ksc, vsc);
    for (int j0 = w0; j0 < w1; j0 += NWK * U) {
      uint4 kn[U], vn[U];
      float ksn[U], vsn[U];
      fetch(j0 + NWK * U, w0, w1, kn, vn, ksn, vsn);   // in flight
      consume(j0, kc, vc, ksc, vsc);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        kc[u] = kn[u];
        vc[u] = vn[u];
        ksc[u] = ksn[u];
        vsc[u] = vsn[u];
      }
    }
  }

  // merge the warp's workers (lane groups LPR apart), then the warps
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mx = fmaxf(m[r], mo);
      const float safe = mx == -INFINITY ? 0.f : mx;
      const float a = exp2f(m[r] - safe), c = exp2f(mo - safe);
      l[r] = l[r] * a + lo * c;
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[r][e] = acc[r][e] * a +
                    __shfl_xor_sync(0xffffffffu, acc[r][e], o) * c;
      m[r] = mx;
    }
  if (lane < LPR) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[warp][r][li * EPL + e] = acc[r][e];
      if (lane == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
    }
  }
  __syncthreads();

  const int splits = gridDim.z;
  const int tile = blockIdx.x * gridDim.y + blockIdx.y;
  // workspace: (m, l) of [tiles][splits][ROWS], then acc of [tiles]
  // [splits][ROWS][HD], all f32
  float* ws_ml = ws;
  float* ws_acc = ws + 2LL * gridDim.x * gridDim.y * splits * ROWS;
  for (int idx = tid; idx < ROWS * HD; idx += kDecWarps * 32) {
    const int r = idx / HD;
    const int d = idx % HD;
    const int row = r0 + r;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float den = 0.f, num = 0.f;
    if (mx != -INFINITY) {  // else: no live column here
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) {
        if (sm_m[w][r] == -INFINITY) continue;
        const float c = exp2f(sm_m[w][r] - mx);
        den = fmaf(sm_l[w][r], c, den);
        num = fmaf(sm_acc[w][r][d], c, num);
      }
    }
    if (splits == 1) {
      if (row < span)   // no live column (q_len = 0) -> zeros
        store(out + b * p.o_sb + (row / p.groups) * p.o_sq +
                  (kvh * p.groups + row % p.groups) * p.o_sh + d,
              mx == -INFINITY ? 0.f : num / den);
    } else {
      const long long at = ((long long)tile * splits + blockIdx.z) * ROWS + r;
      ws_acc[at * HD + d] = num;
      if (d == 0) {
        ws_ml[2 * at] = mx;
        ws_ml[2 * at + 1] = den;
      }
    }
  }
  if (splits == 1) return;
  __threadfence();    // this block's partial, before its ticket
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(tickets + tile, 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();    // every other block's partial, after their tickets
  for (int idx = tid; idx < ROWS * HD; idx += kDecWarps * 32) {
    const int r = idx / HD;
    const int d = idx % HD;
    const int row = r0 + r;
    if (row >= span) continue;
    const long long base = (long long)tile * splits * ROWS + r;
    float mx = -INFINITY;
    for (int sp = 0; sp < splits; ++sp)
      mx = fmaxf(mx, __ldcg(ws_ml + 2 * (base + sp * ROWS)));
    float o = 0.f;
    if (mx != -INFINITY) {
      float den = 0.f, num = 0.f;
      for (int sp = 0; sp < splits; ++sp) {
        const long long at = base + sp * ROWS;
        const float ms = __ldcg(ws_ml + 2 * at);
        if (ms == -INFINITY) continue;     // a chunk with no live column
        const float c = exp2f(ms - mx);
        den = fmaf(__ldcg(ws_ml + 2 * at + 1), c, den);
        num = fmaf(__ldcg(ws_acc + at * HD + d), c, num);
      }
      o = num / den;
    }
    store(out + b * p.o_sb + (row / p.groups) * p.o_sq +
              (kvh * p.groups + row % p.groups) * p.o_sh + d,
          o);
  }
  if (tid == 0) tickets[tile] = 0;   // ready for the next launch
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
// unpack16 does. No row at or past the tile's largest limit enters a
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
int launch_rows(const Params& p, const Ptrs& a, int splits,
                cudaStream_t stream) {
  const int tiles = (p.q_max * p.groups + ROWS - 1) / ROWS;
  if (tiles > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (splits > 1 && (a.ws == nullptr || a.tickets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(p.B * p.KV, tiles, splits);
  rpa_kernel<T, P, HD, ROWS><<<grid, kDecWarps * 32, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const P*>(a.k),
      static_cast<const P*>(a.v), a.ks, a.vs, a.bt, a.ql, a.kl,
      static_cast<T*>(a.o), a.ws, a.tickets, p);
  return static_cast<int>(cudaGetLastError());
}

// Query rows a block: 1, 2, 4 or 8 (K4 at most 4: a lane holds 16 of a
// row's elements there).
template <typename T, typename P, int HD>
int launch_hd(const Params& p, const Ptrs& a, int splits,
              cudaStream_t stream) {
  switch (p.rows) {
    case 1: return launch_rows<T, P, HD, 1>(p, a, splits, stream);
    case 2: return launch_rows<T, P, HD, 2>(p, a, splits, stream);
    case 4: return launch_rows<T, P, HD, 4>(p, a, splits, stream);
    case 8:
      if constexpr (std::is_same<T, P>::value)
        return launch_rows<T, P, HD, 8>(p, a, splits, stream);
      break;
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename P>
int launch_types(const Params& p, int hd, const Ptrs& a, int splits,
                 cudaStream_t stream) {
  if (p.chunk <= 0 || p.chunk % p.ps || splits <= 0 ||
      static_cast<long long>(splits) * p.chunk <
          static_cast<long long>(p.max_pages) * p.ps)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return launch_hd<T, P, 16>(p, a, splits, stream);
    case 64: return launch_hd<T, P, 64>(p, a, splits, stream);
    case 128: return launch_hd<T, P, 128>(p, a, splits, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  p.rows = 0; p.chunk = 0;
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

// K3 on rpa_kernel. dtype: 0 = float32, 1 = bfloat16 (q, pools and out
// share it). Strides are in elements; the last dimension of q, the pools
// and out is contiguous. rows (query rows a block: 1, 2, 4, 8), splits
// and chunk (the key axis in `splits` chunks of `chunk` rows, a multiple
// of page_size, covering max_pages·page_size) are the caller's plan;
// with splits > 1, workspace holds tiles·splits·rows·(hd + 2) f32 and
// tickets `tiles` int32 zeros (tiles = B·KV·ceil(q_max·groups / rows)),
// which every launch leaves zero. Returns a cudaError_t code (0 =
// launched).
int rpa_launch(const void* q, const void* k_pool, const void* v_pool,
               const void* block_table, const void* q_lens,
               const void* kv_lens, void* out, void* workspace,
               void* tickets, int dtype, int B, int q_max, int H, int KV,
               int hd, int page_size, int max_pages, int rows, int splits,
               int chunk, long long q_sb, long long q_sq, long long q_sh,
               long long kv_sp, long long kv_sr, long long kv_sh,
               long long o_sb, long long o_sq, long long o_sh,
               long long bt_sb, float scale, void* stream) {
  Params p;
  const int bad = make_params(p, B, q_max, H, KV, page_size, max_pages, q_sb,
                              q_sq, q_sh, kv_sp, kv_sr, kv_sh, o_sb, o_sq,
                              o_sh, 0, 0, bt_sb, scale);
  if (bad) return bad;
  p.rows = rows;
  p.chunk = chunk;
  const Ptrs a{q, k_pool, v_pool, nullptr, nullptr,
               static_cast<const int*>(block_table),
               static_cast<const int*>(q_lens),
               static_cast<const int*>(kv_lens), out,
               static_cast<float*>(workspace), static_cast<int*>(tickets)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_types<float, float>(p, hd, a, splits, s);
  if (dtype == 1)
    return launch_types<__nv_bfloat16, __nv_bfloat16>(p, hd, a, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4 on rpa_kernel. dtype: 0 = float32, 1 = bfloat16 (q and out);
// payload: 0 = int8, 1 = fp8 e4m3 (both pools). k_scale / v_scale are f32
// [pages, page_size, KV] with strides s_sp, s_sr and 1. Other arguments
// as rpa_launch.
int rpa_quant_launch(const void* q, const void* k_pool, const void* v_pool,
                     const void* k_scale, const void* v_scale,
                     const void* block_table, const void* q_lens,
                     const void* kv_lens, void* out, void* workspace,
                     void* tickets, int dtype, int payload, int B, int q_max,
                     int H, int KV, int hd, int page_size, int max_pages,
                     int rows, int splits, int chunk, long long q_sb,
                     long long q_sq, long long q_sh, long long kv_sp,
                     long long kv_sr, long long kv_sh, long long o_sb,
                     long long o_sq, long long o_sh, long long s_sp,
                     long long s_sr, long long bt_sb, float scale,
                     void* stream) {
  Params p;
  const int bad = make_params(p, B, q_max, H, KV, page_size, max_pages, q_sb,
                              q_sq, q_sh, kv_sp, kv_sr, kv_sh, o_sb, o_sq,
                              o_sh, s_sp, s_sr, bt_sb, scale);
  if (bad) return bad;
  p.rows = rows;
  p.chunk = chunk;
  const Ptrs a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(block_table),
               static_cast<const int*>(q_lens),
               static_cast<const int*>(kv_lens), out,
               static_cast<float*>(workspace), static_cast<int*>(tickets)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && payload == 0)
    return launch_types<float, int8_t>(p, hd, a, splits, s);
  if (dtype == 0 && payload == 1)
    return launch_types<float, __nv_fp8_e4m3>(p, hd, a, splits, s);
  if (dtype == 1 && payload == 0)
    return launch_types<__nv_bfloat16, int8_t>(p, hd, a, splits, s);
  if (dtype == 1 && payload == 1)
    return launch_types<__nv_bfloat16, __nv_fp8_e4m3>(p, hd, a, splits, s);
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
               static_cast<const int*>(kv_lens), out, nullptr, nullptr};
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
               static_cast<const int*>(kv_lens), out, nullptr, nullptr};
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
