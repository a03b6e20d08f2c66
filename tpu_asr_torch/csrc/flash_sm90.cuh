// Hopper (sm_90a) building blocks shared by the bf16 flash-attention
// kernels of flash_attention.cu (forward) and flash_attention_bwd.cu (dq,
// dk/dv): TMA tile loads into 128-byte (64-byte) swizzled shared memory,
// mbarriers, wgmma descriptors and the wgmma products themselves, and the
// block vote that skips key tiles the padding masks wholly.
//
// Tiles. Every operand tile is 64 rows (keys or queries) of one head of
// one utterance of a strided [B, T, H, dh] bf16 tensor, loaded by TMA
// through a 4-D tensor map {dh, H, T, B}. A row of dh bf16 is 2 dh bytes;
// the swizzle atom is 8 rows of 128 bytes (64 bytes for dh 32), so a tile
// is stored as panels of [64 rows x 64 (32) columns], each panel one TMA
// box: one panel for dh 32 and 64, two for dh 128. Rows past T arrive as
// zeros (TMA's out-of-bounds fill). Panels start on 1024-byte boundaries,
// where the swizzle pattern that TMA writes is the one wgmma reads.
//
// Descriptors (PTX ISA, "Matrix Descriptor"; CUTLASS's canonical GMMA
// layouts). A K-major operand (the reduction axis contiguous: Q and K in
// S = Q K^T, K and Q in S^T = K Q^T) is addressed 16 columns (32 bytes) at
// a time inside a panel; its 8-row groups are SBO = 8 rows apart and LBO
// is unused. An MN-major operand (the output axis contiguous: V in P V,
// dO and Q in P^T dO and dS^T Q) is addressed 16 rows at a time; SBO is
// again 8 rows and LBO the distance between panels (unused here: every
// MN-major product is one panel wide). The transpose bit of the
// instruction says which.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_sm90 {

constexpr int kRows = 64;             // rows of every tile
constexpr int kTensorMapError = 1000; // + CUresult of cuTensorMapEncodeTiled

template <int DH>
struct Tile {
  static_assert(DH == 32 || DH == 64 || DH == 128, "dh in {32, 64, 128}");
  static constexpr int kRowBytes = DH == 32 ? 64 : 128;  // swizzle width
  static constexpr int kPanelCols = kRowBytes / 2;       // bf16 columns
  static constexpr int kPanels = DH / kPanelCols;
  static constexpr int kPanelBytes = kRows * kRowBytes;
  static constexpr int kBytes = kPanels * kPanelBytes;
  static constexpr uint32_t kLayout = DH == 32 ? 2 : 1;  // 64B / 128B swizzle
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA ----

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// wait until the barrier's phase `parity` has completed; a phase that
// never completes (a wrong transaction count) traps after 2e10 cycles
// (~10 s; a tile arrives in microseconds) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Rows [t0, t0 + 64) of head h of utterance b into the tile at `dst`, one
// TMA box a panel; completes Tile<DH>::kBytes on `bar`. One thread calls it.
template <int DH>
__device__ __forceinline__ void load_tile(const CUtensorMap* map, uint32_t dst,
                                          uint32_t bar, int t0, int h, int b) {
  using G = Tile<DH>;
#pragma unroll
  for (int p = 0; p < G::kPanels; ++p) {
    tma_load_4d(dst + p * G::kPanelBytes, map, bar, p * G::kPanelCols, h, t0,
                b);
  }
}

// ---- wgmma ----

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// K-major: columns [16 kk, 16 kk + 16) of the 64-row tile at `tile`
template <int DH>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using G = Tile<DH>;
  const uint32_t at = kk * 32;                       // bytes along the row
  return make_desc(tile + (at / G::kRowBytes) * G::kPanelBytes +
                       at % G::kRowBytes,
                   16, 8 * G::kRowBytes, G::kLayout);
}

// MN-major: rows [16 kk, 16 kk + 16) of panel `panel` of the tile
template <int DH>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int panel, int kk) {
  using G = Tile<DH>;
  return make_desc(tile + panel * G::kPanelBytes + kk * 16 * G::kRowBytes,
                   G::kPanelBytes, 8 * G::kRowBytes, G::kLayout);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of wgmma registers across the
// fence / wait around them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// two floats rounded to bf16 (to nearest even), the lower column in the
// lower half: one 32-bit register of a wgmma A fragment
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] = A[64 x 16] B[16 x 64] (+ D if accumulate): A and B from
// shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] = A[64 x 16] B[16 x 64] (+ D if accumulate): A from
// registers (the m64k16 bf16 fragment), B from shared memory, MN-major
// (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// D[64 x 32] = A[64 x 16] B[16 x 32] (+ D if accumulate): A from
// registers (the m64k16 bf16 fragment), B from shared memory, MN-major
// (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}


template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t desc_b, int accumulate) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, desc_b, accumulate);
  } else {
    static_assert(N == 32, "wgmma_rs: N in {32, 64}");
    wgmma_rs_n32(d, a, desc_b, accumulate);
  }
}

// The accumulator fragment of m64nNk16 (thread t of the warpgroup, warp
// w = t / 32, lane l = t % 32): register i holds row 16 w + l / 4
// (+ 8 if bit 1 of i is set) and column 8 (i / 4) + 2 (l % 4) + i % 2. For
// N = 64, registers 8 kk .. 8 kk + 7 packed in pairs are the A fragment of
// the k-step kk of a product whose reduction runs over those 64 columns.
__device__ __forceinline__ int frag_row(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int frag_col(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
}

// ---- padded key tiles ----

// The first 64-key tile at or after t (of n_tiles) with a key that the
// utterance's kv_valid row lets through, n_tiles if none: a block-wide
// vote on the tile's bytes, whose bits also go to mask[0] and mask[1]
// (bit c % 32 of word c / 32: key 64 t + c is valid). Every thread of
// the block calls it; a block has at least 64 threads.
__device__ __forceinline__ int find_live_tile(int t, int n_tiles, int tk,
                                              const uint8_t* valid_row,
                                              uint32_t* mask) {
  const int tid = threadIdx.x, lane = tid % 32;
  for (; t < n_tiles; ++t) {
    const int key = t * kRows + tid;
    const bool ok = tid < kRows && key < tk && valid_row[key] != 0;
    const uint32_t word = __ballot_sync(0xffffffffu, ok);
    if (tid < kRows && lane == 0) mask[tid / 32] = word;
    if (__syncthreads_or(ok)) break;
  }
  return t;
}

// ---- host: tensor maps ----

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link
// against libcuda); null if the lookup finds none
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a bf16 [B, T, H, dh] tensor (strides in elements, the
// head axis contiguous; the caller makes every stride a multiple of 16
// bytes and the base 16-byte aligned), with a box of one panel: 64 (32)
// columns x 64 rows of one head of one utterance. Returns 0 or an error
// code (kTensorMapError + CUresult, or a cudaError_t).
template <int DH>
int encode_tile_map(CUtensorMap* map, const void* base, int b, int t,
                    int heads, int64_t sb, int64_t st, int64_t sh) {
  using G = Tile<DH>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // a length-0 time axis is never read (no tile of it is loaded)
  const cuuint64_t dims[4] = {DH, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(t > 0 ? t : 1),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {G::kPanelCols, 1, kRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      DH == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(res);
}

inline const char* error_string(int code) {
  if (code >= kTensorMapError) {
    return "cuTensorMapEncodeTiled refused a tensor map (code - 1000 is its "
           "CUresult)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace flash_sm90
