// The Hopper forward tile core shared by the port's attention kernels:
// flash_attention.cu's bf16 forward (K1, `flash_fwd_kernel`) and
// ragged_paged_attention.cu's prefill and suffix rows (K3/K4,
// `rpa_tile_kernel`). One warpgroup (4 warps, 128 threads) owns a 64-row
// query tile and walks 64-row key tiles (K1 puts two warpgroups on one
// K/V ring):
//   * S = Q·Kᵀ on `wgmma.mma_async` m64n64k16 with both operands K-major in
//     shared memory, f32 accumulators in registers;
//   * an online softmax in base 2 (the scale times log2(e) folded into S
//     once, exp2f), its running max, sum and O accumulator in f32
//     registers; only tiles that cross a row's limit test columns;
//   * O += P·V on `wgmma` m64n{HD}k16 with P rounded to bf16 in registers
//     (the S accumulator's row pairs are wgmma's A fragment) and V read
//     MN-major from shared memory through the descriptor's transpose bit,
//     so V is never transposed in memory.
// Tiles live in shared memory as [64 rows x 64 bf16] chunks of 8 KB with
// the 128-byte swizzle that TMA writes and wgmma reads (a 16-byte column
// piece c of row r sits at r·128 + ((c ^ r%8) << 4)); a row of HD
// elements spans HD/64 chunks. Tile buffers are 1024-byte aligned.
// Callers bring their own loads (TMA for K1, cp.async gathers through a
// block table for K3/K4) into a ring of at least two stages.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

constexpr int kTile = 64;                // query and key rows per tile
constexpr int kWG = 128;                 // threads of one warpgroup
constexpr int kChunkBytes = kTile * 128; // [64 rows x 64 bf16], swizzled
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Bytes of one 64-row bf16 tile of HD columns.
template <int HD>
__host__ __device__ constexpr int tile_bytes() {
  return HD / 64 * kChunkBytes;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte aligned address at or after p in shared memory.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// Byte offset of 16-byte column piece c (0..HD/8-1) of row r in a tile.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * kChunkBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all >> 4), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFFu) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFFu) >> 4) << 32) |
         (1ull << 62);
}
// K-major operand (Q, K): 8-row groups 1024 bytes apart (SBO); k step kk of
// 16 elements starts 32 bytes further in the 128-byte row, chunk by chunk.
__device__ __forceinline__ uint64_t desc_kmajor(const uint8_t* tile, int kk) {
  return make_desc(tile + (kk >> 2) * kChunkBytes + (kk & 3) * 32, 16, 1024);
}
// MN-major operand (V as B of P·V, stored [keys][HD]): 64-column chunks
// kChunkBytes apart along N (LBO), 8-key groups 1024 bytes apart along K
// (SBO); k step kk of 16 keys starts 16 rows (2048 bytes) further.
__device__ __forceinline__ uint64_t desc_mnmajor(const uint8_t* tile, int kk) {
  return make_desc(tile + kk * 16 * 128, kChunkBytes, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of accumulator registers across
// an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// ------------------------------------------------------ wgmma
// D[64 x 64] = A·B (+ D when `accumulate`), A and B K-major bf16 tiles
// in shared memory (descriptors da, db).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A·B, A bf16 in registers (to_a_frag's layout), B an
// MN-major bf16 tile in shared memory: stored [K rows][N contiguous], read
// through the descriptor's transpose bit.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A·B, A bf16 in registers (to_a_frag's layout), B an
// MN-major bf16 tile in shared memory: stored [K rows][N contiguous], read
// through the descriptor's transpose bit.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(HD == 64 || HD == 128, "head dims 64 and 128");
  if constexpr (HD == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

// ------------------------------------------------- barriers and copies
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One [64 rows x 64 bf16] box of a 4D tensor map at coordinates (c0, c1,
// c2, c3), innermost first, into dst; completion counted on bar.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// One box of a 3D tensor map at coordinates (c0, c1, c2) into dst.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// 16 (or 4) bytes global -> shared, asynchronously; src_bytes = 0 reads
// nothing and writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's generic-proxy shared-memory writes (st.shared,
// completed cp.async) before later wgmma reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ----------------------------------------------------- the tile core
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Thread `threadIdx.x` holds, in an accumulator of N columns, element
// [4j + 2i + c] at row 16·warp + lane/4 + 8i and column 8j + 2·(lane%4)
// + c: rows acc_row(i) for i = 0, 1. With the warp counted across the
// block, a second warpgroup's rows (64..127) follow the first's, as its
// 64-row Q tile follows the first's in shared memory.
__device__ __forceinline__ int acc_row(int i) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * i;
}
__device__ __forceinline__ int acc_col(int j, int c) {
  return 8 * j + 2 * (threadIdx.x & 3) + c;
}

// S = Q·Kᵀ for one 64x64 tile: sQ, sK are 64-row tiles of HD columns.
template <int HD>
__device__ __forceinline__ void qk_tile(float (&s)[32], const uint8_t* sQ,
                                        const uint8_t* sK) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  fence_regs(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss_n64(s, desc_kmajor(sQ, kk), desc_kmajor(sK, kk), kk > 0);
  wg_commit();
  wg_wait0();
  fence_regs(s);
}

// O += P·V for one tile: p (64 keys of this thread's rows, the S
// accumulator layout) rounded to bf16 as wgmma's A fragment, sV a 64-row
// tile of HD columns read MN-major.
template <int HD>
__device__ __forceinline__ void pv_tile(float (&o)[HD / 2],
                                        const float (&p)[32],
                                        const uint8_t* sV) {
  uint32_t a[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(p[8 * kk + 0], p[8 * kk + 1]);
    a[kk][1] = pack_bf16(p[8 * kk + 2], p[8 * kk + 3]);
    a[kk][2] = pack_bf16(p[8 * kk + 4], p[8 * kk + 5]);
    a[kk][3] = pack_bf16(p[8 * kk + 6], p[8 * kk + 7]);
  }
  fence_regs(o);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<HD>(o, a[kk], desc_mnmajor(sV, kk));
  wg_commit();
  wg_wait0();
  fence_regs(o);
}

// One 64-row query tile's online softmax state and output accumulator,
// spread over the warpgroup in the accumulator layout. m is the running
// max of the rows acc_row(0), acc_row(1) in log2 units (−inf until a
// visible column); l this thread's share of the running sum (complete
// after finish()).
template <int HD>
struct FwdTile {
  float o[HD / 2];
  float m[2];
  float l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  // Raw scores s of one key tile -> probabilities p (in s, unnormalised,
  // relative to the new running max), with m, l and o updated. With
  // `masked`, column c of row i counts only where visible(i, c) (c = 0..63
  // within the tile); without, every column of the tile counts.
  template <typename Visible>
  __device__ __forceinline__ void softmax(float (&s)[32], float scale_log2,
                                          bool masked, Visible visible) {
    float mx[2] = {m[0], m[1]};
    if (masked) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float x = visible(i, acc_col(j, e & 1))
                              ? s[4 * j + e] * scale_log2
                              : -INFINITY;
          s[4 * j + e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[4 * j + e] * scale_log2;
          s[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
    }
    float alpha[2], safe[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // a row with no visible column yet keeps m = −inf; exp2 against 0
      // leaves p and alpha exactly 0 instead of −inf − −inf = nan
      safe[i] = mx[i] == -INFINITY ? 0.f : mx[i];
      alpha[i] = exp2f(m[i] - safe[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = exp2f(s[4 * j + e] - safe[e >> 1]);
        s[4 * j + e] = pv;
        l[e >> 1] += pv;
      }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
  }

  // Completes l over the four threads of each row; returns nothing. After
  // it, row i's output is o[4j + 2i + c] / denom(i) and its natural-log
  // sum-exp lse(i).
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
  }
  __device__ __forceinline__ float denom(int i) const {
    return fmaxf(l[i], 1e-30f);
  }
  __device__ __forceinline__ float lse(int i) const {
    return (m[i] + log2f(denom(i))) * kLn2;   // −inf for an empty row
  }
};

// ----------------------------------------------------------- host side
// A 4D TMA map over a bf16 [B, N, H, D] tensor with element strides (sb,
// sn, sh) and a contiguous last dim: box [64 columns, 1 head, 64 rows, 1],
// 128-byte swizzle, rows past N read as zeros. cuTensorMapEncodeTiled
// comes from the driver through the runtime (cudaGetDriverEntryPoint), so
// the library links no -lcuda. Returns a cudaError_t code.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

inline int encode_bnhd(CUtensorMap* map, const void* ptr, int B, int N, int H,
                       int D, long long sb, long long sn, long long sh) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const long long e = static_cast<long long>(sizeof(__nv_bfloat16));
  // a dimension of extent 1 is never stepped: give it a legal stride
  if (H == 1) sh = D;
  if (N == 1) sn = static_cast<long long>(H) * sh;
  if (B == 1) sb = static_cast<long long>(N) * sn;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh * e),
                                 static_cast<cuuint64_t>(sn * e),
                                 static_cast<cuuint64_t>(sb * e)};
  const cuuint32_t box[4] = {64, 1, kTile, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A 3D TMA map over a bf16 page pool [rows = pages·ps, KV, D] with
// element strides (s_row, s_head): box [64 columns, 1 head, R rows],
// 128-byte swizzle. Returns a cudaError_t code.
inline int encode_pool_rows(CUtensorMap* map, const void* ptr, int rows,
                            int KV, int D, long long s_row, long long s_head,
                            int R) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const long long e = static_cast<long long>(sizeof(__nv_bfloat16));
  if (KV == 1) s_head = D;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(KV),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s_head * e),
                                 static_cast<cuuint64_t>(s_row * e)};
  const cuuint32_t box[3] = {64, 1, static_cast<cuuint32_t>(R)};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hopper
