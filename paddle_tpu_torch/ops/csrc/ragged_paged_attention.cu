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
// What bounds it on an H100: bytes. Decode reads 2·kv_len·KV·hd·bytes of
// pool per slot per layer (K and V once) and does ~4 flops per byte read;
// at 3.35 TB/s, B=4 slots of 1024 bf16 positions at KV=32, hd=128
// (64 MiB) take at least 20 us, and K4's int8/fp8 pages with their f32
// scales (33 MiB) at least 10 us. The design therefore:
//   * reads only the ceil(kv_len/page_size) live pages, page addresses by
//     block-table pointer arithmetic, and never touches a row at or past
//     the row limit, payload or scale (no NaN or stale row in a dead tail
//     or in the scratch page can reach the output — such rows are
//     skipped, not weighted 0);
//   * loads each K/V row once per block and uses it for every query row
//     the block holds (all `groups` query heads of one kv head, and up to
//     8 query rows of a prefill), a warp reading one contiguous row: 8 or
//     16 bytes per lane for K3, 4 payload bytes per lane at hd 128 for K4
//     (the same element-to-lane map, one byte per element), plus the
//     row's one scale, which every lane of the warp reads at one address;
//   * spreads a block's keys over 8-16 warps with 4 rows in flight per
//     warp, each warp keeping an online softmax (running max, sum and
//     accumulator in f32), merged across warps through shared memory.
// Work splits into blocks by (slot, kv head, tile of query rows); each
// block reads its slot's q_len, kv_len and block-table row itself.
// Simple first: CUDA cores, no wgmma, no TMA, no split-KV across blocks.
//
// Numerics: logits, softmax and accumulation in f32; the probabilities are
// never rounded. The plain version (and the TPU kernels) normalise first
// and round the probabilities to the dtype of the V rows before the V
// product, so in bf16 the two differ by at most 2^-8 times the largest |V|
// a row attends from that rounding plus at most 2^-8·|out| of output
// rounding on each side: 3·2^-8 of that max in all. K4 is held to 2^-6
// of it per output row, K3 to 2^-7 of the call's largest |V|
// (ops/ragged_attention.py: BF16_ROW_TOL and `tolerance`,
// BF16_TOL_PER_MAX_V). In f32 they differ by summation order only.
//
// C interface (built by nvcc, loaded with ctypes; no PyTorch headers):
// rpa_launch and rpa_quant_launch take device pointers, sizes, element
// strides, the f32 scale and the CUDA stream; they launch on that stream,
// allocate nothing, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kUnroll = 4;  // key rows in flight per warp

struct Params {
  int B, q_max, H, KV, groups, ps, max_pages;
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

const char* rpa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
