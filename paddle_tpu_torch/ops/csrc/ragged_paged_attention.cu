// Ragged paged attention for Hopper (sm_90a) — kernel K3 of the port.
//
// Replaces: paddle_tpu/ops/ragged_attention.py::ragged_paged_attention
// (`_kernel_body`, the Pallas TPU kernel launched by `pl.pallas_call`).
// It computes the same function — not a block-by-block carry-over:
//   out[b, qpos, h] = softmax_j(q·k_j / sqrt(hd)) · v_j over the live
//   columns j < kv_len[b] with j <= kv_len[b] − q_len[b] + qpos, reading
//   K/V rows of kv head h / groups through the slot's block table.
// A slot with q_len = 0 writes zeros. Decode rows (q_len = 1), ragged
// causal prefill rows and suffix rows (kv_len > q_len > 1) are all just
// values of (q_len, kv_len) for the same launch.
//
// What bounds it on an H100: bytes. Decode reads 2·kv_len·KV·hd·bytes of
// pool per slot per layer (K and V once) and does ~4 flops per byte read;
// at 3.35 TB/s, B=4 slots of 1024 bf16 positions at KV=32, hd=128
// (64 MiB) take at least 20 us. The design therefore:
//   * reads only the ceil(kv_len/page_size) live pages, page addresses by
//     block-table pointer arithmetic, and never touches a row at or past
//     the row limit (no NaN or stale row in a dead tail or in the scratch
//     page can reach the output — such rows are skipped, not weighted 0);
//   * loads each K/V row once per block and uses it for every query row
//     the block holds (all `groups` query heads of one kv head, and up to
//     8 query rows of a prefill), 8 or 16 bytes per lane, a warp reading
//     one contiguous row;
//   * spreads a block's keys over 8-16 warps with 4 rows in flight per
//     warp, each warp keeping an online softmax (running max, sum and
//     accumulator in f32), merged across warps through shared memory.
// Work splits into blocks by (slot, kv head, tile of query rows); each
// block reads its slot's q_len, kv_len and block-table row itself.
// Simple first: CUDA cores, no wgmma, no TMA, no split-KV across blocks.
//
// Numerics: logits, softmax and accumulation in f32; the probabilities are
// never rounded. The plain version (and the TPU kernel) normalise first
// and round the probabilities to the pool dtype before the V product, so
// in bf16 the two differ by at most ~2^-9·max|V| from that rounding plus
// half an ulp of output rounding on each side: the stated bound is
// 2^-7·max|V| (ops/ragged_attention.py, BF16_TOL_PER_MAX_V). In f32 they
// differ by summation order only.
//
// C interface (built by nvcc, loaded with ctypes; no PyTorch headers):
// rpa_launch takes device pointers, sizes, element strides, the f32 scale
// and the CUDA stream; it launches on that stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
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
  long long bt_sb;                // block-table row stride
  float scale;
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block: slot b, kv head kvh, query rows [r0, r0 + ROWS) of the
// regrouped [q_max * groups] row axis (row = qpos * groups + gi, query
// head = kvh * groups + gi). NW warps split the key rows.
template <typename T, int HD, int ROWS, int NW>
__global__ void __launch_bounds__(NW * 32)
rpa_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
           const T* __restrict__ vpool, const int* __restrict__ block_table,
           const int* __restrict__ q_lens, const int* __restrict__ kv_lens,
           T* __restrict__ out, const Params p) {
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
        load_vec<T, EPL>(kpool + off, kf[u]);
        load_vec<T, EPL>(vpool + off, vf[u]);
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

template <typename T, int HD, int ROWS>
void launch_rows(const Params& p, dim3 grid, const T* q, const T* k,
                 const T* v, const int* bt, const int* ql, const int* kl,
                 T* o, cudaStream_t stream) {
  // 16 warps keep enough rows in flight for decode's few blocks; at 8
  // query rows the merge buffer would pass 48 KB, so 8 warps there
  constexpr int NW = ROWS >= 8 ? 8 : 16;
  grid.y = (p.q_max * p.groups + ROWS - 1) / ROWS;
  rpa_kernel<T, HD, ROWS, NW><<<grid, NW * 32, 0, stream>>>(q, k, v, bt, ql,
                                                            kl, o, p);
}

template <typename T, int HD>
void launch_hd(const Params& p, const void* q, const void* k, const void* v,
               const int* bt, const int* ql, const int* kl, void* o,
               cudaStream_t stream) {
  const dim3 grid(p.B * p.KV, 1, 1);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  const int span = p.q_max * p.groups;
  if (span >= 8)
    launch_rows<T, HD, 8>(p, grid, qt, kt, vt, bt, ql, kl, ot, stream);
  else if (span > 2)
    launch_rows<T, HD, 4>(p, grid, qt, kt, vt, bt, ql, kl, ot, stream);
  else if (span == 2)
    launch_rows<T, HD, 2>(p, grid, qt, kt, vt, bt, ql, kl, ot, stream);
  else
    launch_rows<T, HD, 1>(p, grid, qt, kt, vt, bt, ql, kl, ot, stream);
}

template <typename T>
int launch_dtype(const Params& p, int hd, const void* q, const void* k,
                 const void* v, const int* bt, const int* ql, const int* kl,
                 void* o, cudaStream_t stream) {
  switch (hd) {
    case 16: launch_hd<T, 16>(p, q, k, v, bt, ql, kl, o, stream); break;
    case 64: launch_hd<T, 64>(p, q, k, v, bt, ql, kl, o, stream); break;
    case 128: launch_hd<T, 128>(p, q, k, v, bt, ql, kl, o, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).
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
  if (B <= 0 || q_max <= 0 || KV <= 0 || H % KV != 0 || page_size <= 0 ||
      max_pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.B = B; p.q_max = q_max; p.H = H; p.KV = KV; p.groups = H / KV;
  p.ps = page_size; p.max_pages = max_pages;
  p.q_sb = q_sb; p.q_sq = q_sq; p.q_sh = q_sh;
  p.kv_sp = kv_sp; p.kv_sr = kv_sr; p.kv_sh = kv_sh;
  p.o_sb = o_sb; p.o_sq = o_sq; p.o_sh = o_sh;
  p.bt_sb = bt_sb; p.scale = scale;
  if ((p.q_max * p.groups + 7) / 8 > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int* bt = static_cast<const int*>(block_table);
  const int* ql = static_cast<const int*>(q_lens);
  const int* kl = static_cast<const int*>(kv_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dtype<float>(p, hd, q, k_pool, v_pool, bt, ql, kl, out, s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(p, hd, q, k_pool, v_pool, bt, ql, kl,
                                       out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rpa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
