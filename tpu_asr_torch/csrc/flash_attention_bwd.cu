// Flash attention backward (dq, and dk/dv) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel
// of tpu_asr/ops/pallas/flash_attention.py, reached through
// _flash_backward (the custom VJP of flash_attention). For utterance b,
// head h, query row i and key j of [B, T, H, dh] that the mask lets
// through (kv_valid[b, j], and j <= i when causal):
//
//   s     = (q[i] . k[j]) * scale      the float32 dot, then the scale
//   p     = exp(s - max(lse[i], NEG_INF / 2)), 0 where the mask bars j
//   dp    = dO[i] . v[j]                float32
//   ds    = p * (dp - delta[i]) * scale
//   dq[i] = sum_j T(ds) k[j]            (T = the input type, as the TPU
//   dk[j] = sum_i T(ds) q[i]             kernel rounds ds and p before
//   dv[j] = sum_i T(p) dO[i]             its MXU products)
//
// with delta[i] = sum_d dO[i, d] out[i, d] (float32, computed by the
// caller, as the reference computes it in XLA outside its kernels) and
// lse the forward's float32 [B, H, Tq]. A query row whose keys are all
// masked and a masked key get exactly 0; nothing of [Tq, Tk] reaches
// device memory. Sums accumulate in float32; the outputs are cast to T.
//
// The bf16 scores are the forward's, bit for bit: the bf16 dq kernel
// computes S = Q K^T with the forward's wgmma instructions in its k-step
// order, so its p = exp(s - lse) never exceeds 1 by a rounding. The bf16
// dk/dv kernel computes S^T = K Q^T on the tensor cores in its own order,
// and the float32 SIMT kernels sum s in four float32 partial sums, the
// order of the float32 forward kernel; there a bf16-rounded ds term may
// round the other way than the plain backward's, moving a sum by an ulp
// of one term.
//
// What bounds them on this card: bytes. For one head of one utterance in
// bf16, dq reads q, k, v, dO once and writes dq, 2 dh (3 Tq + 2 Tk) bytes
// (plus lse and delta), for 6 dh flops a pair that the mask lets through
// (s, dp, ds k); dk/dv moves 2 dh (2 Tq + 4 Tk) bytes for 8 dh flops a
// pair. At the encoder's T' = 249 that is ~150 flops a byte, below the
// bf16 tensor-core ridge (~295). The first kernels did their products in
// float32 on the SIMT units, every operand read from shared memory: dq
// 52x, dk/dv 45-54x their byte bounds (0.61 and 0.67 ms alone at
// training's encoder self [33, 238]; PERF.md).
//
// bf16: two wgmma kernels on the TMA tiles, mbarriers and descriptors of
// flash_sm90.cuh. Each keeps its side's 64 rows in shared memory, streams
// the other side's 64-row tiles through a two-stage ring (TMA; the next
// tile loads while this one is computed) and works on the accumulator
// fragment, where p and ds packed to bf16 pairs are both the rounding
// the contract asks for and the A fragments of the next products.
//
// dq: flash_attention_bwd_dq_wgmma_kernel. A block (one warpgroup) owns
// 64 queries of one head of one utterance: Q and dO, with the rows'
// clamped lse and delta in registers. Per key tile (K and V):
//   - S = Q K^T and dP = dO V^T by wgmma m64n64k16 (A = Q, dO; B = K, V,
//     all K-major as they lie in memory): rows are the block's queries,
//     so lse and delta are per row, as the forward's running max is;
//   - p and ds on the fragment, T(ds) packed as the A fragment;
//   - dQ += T(dS) K by wgmma with A from registers and B = K MN-major (the
//     transpose bit), one product a 64-column panel; dQ accumulates in
//     float32 registers (16-64 a thread by dh) and is written once.
// Key tiles that the padding masks wholly (a block-wide vote on the
// tile's kv_valid bytes) and, under causal, tiles past the block's last
// row are never loaded: their p is exactly 0. A block with no live tile
// writes zeros. Shared memory: 6 tiles, 25-98 KB.
//
// dk/dv: flash_attention_bwd_dkv_wgmma_kernel. A block owns 64 keys
// of one head of one utterance: K and V stay in shared memory, query
// tiles of 64 (Q and dO) stream through the ring with their clamped lse
// and delta. Per tile:
//   - S^T = K Q^T and dP^T = V dO^T by wgmma m64n64k16 (A = K, V; B = Q,
//     dO, all K-major as they lie in memory): rows are the block's keys,
//     columns the tile's queries, so lse and delta are per column;
//   - p and ds on the accumulator fragment, packed to bf16 pairs: the A
//     fragments of the next two products;
//   - dV += T(P^T) dO and dK += T(dS^T) Q by wgmma with A from registers
//     and B = dO, Q MN-major (the transpose bit); dK and dV accumulate in
//     float32 registers (32 + 32 a thread at dh 64). dh 128 takes two
//     warpgroups that split dk/dv's columns (each also computes S^T and
//     dP^T), to keep the accumulators in registers.
// A block whose 64 keys are all masked writes zeros and returns; under
// causal, query tiles before the block's first key are skipped. Shared
// memory: 6 tiles, 25-98 KB.
//
// No atomics in either, so card runs repeat bitwise.
//
// float32: the first SIMT kernels, flash_attention_bwd_dq_simt_kernel and
// flash_attention_bwd_dkv_simt_kernel. wgmma has no full-float32 product
// and TF32 would break the float32 tolerance (atol 1e-5). Like the
// reference, dq and dk/dv are two kernels:
//   dq    one block per (64 query rows, head, utterance), walking key tiles
//         of 32 (causal: only up to the block's last row);
//   dk/dv one block per (64 key rows, head, utterance), walking query
//         tiles of 32 (causal: only from the block's first key).
// A block has 2 dh threads. The block's own 64 rows of two operands sit in
// shared memory as float32 with a padded row stride (dh + 1), so 32 threads
// reading 32 rows at one column hit 32 banks; the walked tile's rows are
// read by a whole warp at one address (a broadcast). Each step has two
// phases:
//   A  every thread computes s, p and ds for 1024 / dh pairs (row r =
//      thread % 64) and writes p / ds into a shared tile;
//   B  thread (r, c) adds the tile's contribution to columns
//      [32 c, 32 c + 32) of row r's accumulators, held in registers.
// So a thread holds 32 float32 accumulators (dq) or 64 (dk and dv) for any
// dh in {32, 64, 128}: no spills, and no key loop unrolled in full.
// Shared memory is dynamic: 33-108 KB (dq) and 37-116 KB (dk/dv) by dh.
// Operands are read from the strided [B, T, H, dh] layout with the strides
// the caller gives (the head axis contiguous); the outputs are contiguous
// [B, T, H, dh].

#include "flash_sm90.cuh"

namespace {

using flash_sm90::kRows;         // rows of the block's own side
constexpr int kTile = 32;        // rows of the walked side per step
constexpr int kChunk = 32;       // accumulator columns a thread owns
constexpr float kNegInf = -1e30f;
constexpr float kHalfNegInf = -5e29f;

// the SIMT kernels are instantiated for float32 alone (bf16 takes wgmma)
__device__ __forceinline__ float to_float(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <typename T>
__device__ __forceinline__ float rounded(float x) {   // x in the type T
  return to_float(from_float<T>(x));
}

struct Strides {      // in elements; the head dimension is contiguous
  int64_t b, t, h;
};

// Rows [r0, r0 + n) of one head (`head` points at [b, 0, h, 0]) into a
// float32 tile with row stride ld; rows at or past t_len are zeros.
template <typename T, int DH>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* head,
                                          int64_t st, int r0, int n,
                                          int t_len) {
  for (int idx = threadIdx.x; idx < n * DH; idx += 2 * DH) {
    const int r = idx / DH, d = idx % DH;
    const int row = r0 + r;
    dst[r * ld + d] =
        row < t_len ? to_float(head[static_cast<int64_t>(row) * st + d]) : 0.0f;
  }
}

// The forward kernel's dot: four partial sums over d = 0, 4, 8, ... (and
// 1, 5, ...), added pairwise. fmaf(a, b, acc) is symmetric in a and b.
template <int DH>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    acc[0] = fmaf(a[d], b[d], acc[0]);
    acc[1] = fmaf(a[d + 1], b[d + 1], acc[1]);
    acc[2] = fmaf(a[d + 2], b[d + 2], acc[2]);
    acc[3] = fmaf(a[d + 3], b[d + 3], acc[3]);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// acc[0..32) += w * row[0..32) (row 16-byte aligned, read as float4)
__device__ __forceinline__ void axpy_chunk(float* acc, float w,
                                           const float* row) {
#pragma unroll
  for (int d = 0; d < kChunk; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(row + d);
    acc[d] = fmaf(w, x.x, acc[d]);
    acc[d + 1] = fmaf(w, x.y, acc[d + 1]);
    acc[d + 2] = fmaf(w, x.z, acc[d + 2]);
    acc[d + 3] = fmaf(w, x.w, acc[d + 3]);
  }
}

template <typename T>
__device__ __forceinline__ void store_chunk(T* dst, const float* acc) {
#pragma unroll
  for (int d = 0; d < kChunk; ++d) dst[d] = from_float<T>(acc[d]);
}

template <int DH>
constexpr size_t dq_smem_floats() {
  return 2 * kRows * (DH + 1) + 2 * kTile * DH + kTile * kRows + 2 * kRows +
         kTile;
}

template <int DH>
constexpr size_t dkv_smem_floats() {
  return 2 * kRows * (DH + 1) + 2 * kTile * DH + 2 * kTile * kRows +
         2 * kTile + kRows;
}

template <typename T, int DH>
__global__ void __launch_bounds__(2 * DH)
flash_attention_bwd_dq_simt_kernel(const T* __restrict__ q,
                                   const T* __restrict__ k,
                                   const T* __restrict__ v,
                                   const T* __restrict__ dout,
                                   const float* __restrict__ lse,  // [B, H, Tq]
                                   const float* __restrict__ delta,
                                   const uint8_t* __restrict__ kv_valid,
                                   T* __restrict__ dq,     // [B, Tq, H, DH]
                                   int tq, int tk, int heads, Strides qs,
                                   Strides ks, Strides vs, Strides os,
                                   float scale, int causal) {
  constexpr int LD = DH + 1;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                          // [kRows][LD], own queries
  float* do_s = q_s + kRows * LD;             // [kRows][LD]
  float* k_t = do_s + kRows * LD;             // [kTile][DH], walked keys
  float* v_t = k_t + kTile * DH;              // [kTile][DH]
  float* ds_s = v_t + kTile * DH;             // [kTile][kRows], T(ds)
  float* lse_s = ds_s + kTile * kRows;        // [kRows], clamped lse
  float* delta_s = lse_s + kRows;             // [kRows]
  float* valid_s = delta_s + kRows;           // [kTile], 1 = valid key

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int r = threadIdx.x % kRows;          // this thread's query row
  const int c = threadIdx.x / kRows;          // its column chunk (phase B)
  const int i = q0 + r;

  load_rows<T, DH>(q_s, LD, q + b * qs.b + h * qs.h, qs.t, q0, kRows, tq);
  load_rows<T, DH>(do_s, LD, dout + b * os.b + h * os.h, os.t, q0, kRows,
                   tq);
  if (c == 0) {
    const int64_t at = (static_cast<int64_t>(b) * heads + h) * tq + i;
    lse_s[r] = i < tq ? fmaxf(lse[at], kHalfNegInf) : 0.0f;
    delta_s[r] = i < tq ? delta[at] : 0.0f;
  }

  float acc[kChunk];
#pragma unroll
  for (int d = 0; d < kChunk; ++d) acc[d] = 0.0f;

  // with the causal flag, keys past the block's last row are all masked
  const int last_row = min(q0 + kRows, tq) - 1;
  const int k_end = causal ? min(tk, last_row + 1) : tk;
  const T* k_head = k + b * ks.b + h * ks.h;
  const T* v_head = v + b * vs.b + h * vs.h;
  const uint8_t* valid_row = kv_valid + static_cast<int64_t>(b) * tk;

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();                 // the previous tile is consumed
    load_rows<T, DH>(k_t, DH, k_head, ks.t, k0, kTile, tk);
    load_rows<T, DH>(v_t, DH, v_head, vs.t, k0, kTile, tk);
    if (threadIdx.x < kTile) {
      const int kj = k0 + threadIdx.x;
      valid_s[threadIdx.x] = (kj < tk && valid_row[kj]) ? 1.0f : 0.0f;
    }
    __syncthreads();

    // phase A: T(ds) of (row r, keys c, c + DH/32, ...) of this tile
#pragma unroll 1
    for (int j = c; j < kTile; j += DH / kChunk) {
      const int kj = k0 + j;
      float ds = 0.0f;
      if (i < tq && valid_s[j] != 0.0f && (!causal || kj <= i)) {
        const float s = dot<DH>(q_s + r * LD, k_t + j * DH) * scale;
        const float p = s <= kHalfNegInf ? 0.0f : expf(s - lse_s[r]);
        const float dp = dot<DH>(do_s + r * LD, v_t + j * DH);
        ds = p * (dp - delta_s[r]) * scale;
      }
      ds_s[j * kRows + r] = rounded<T>(ds);
    }
    __syncthreads();

    // phase B: dq[r, chunk c] += sum_j T(ds[r, j]) k[j, chunk c]
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      axpy_chunk(acc, ds_s[j * kRows + r], k_t + j * DH + c * kChunk);
    }
  }

  if (i < tq) {
    store_chunk<T>(dq + (static_cast<int64_t>(b) * tq + i) * heads * DH +
                       static_cast<int64_t>(h) * DH + c * kChunk,
                   acc);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(2 * DH)
flash_attention_bwd_dkv_simt_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k,
                                    const T* __restrict__ v,
                                    const T* __restrict__ dout,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta,
                                    const uint8_t* __restrict__ kv_valid,
                                    T* __restrict__ dk,   // [B, Tk, H, DH]
                                    T* __restrict__ dv,   // [B, Tk, H, DH]
                                    int tq, int tk, int heads, Strides qs,
                                    Strides ks, Strides vs, Strides os,
                                    float scale, int causal) {
  constexpr int LD = DH + 1;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                          // [kRows][LD], own keys
  float* v_s = k_s + kRows * LD;              // [kRows][LD]
  float* q_t = v_s + kRows * LD;              // [kTile][DH], walked queries
  float* do_t = q_t + kTile * DH;             // [kTile][DH]
  float* p_s = do_t + kTile * DH;             // [kTile][kRows], T(p)
  float* ds_s = p_s + kTile * kRows;          // [kTile][kRows], T(ds)
  float* lse_t = ds_s + kTile * kRows;        // [kTile], clamped lse
  float* delta_t = lse_t + kTile;             // [kTile]
  float* valid_s = delta_t + kTile;           // [kRows], 1 = valid key

  const int b = blockIdx.z, h = blockIdx.y;
  const int k0 = blockIdx.x * kRows;
  const int r = threadIdx.x % kRows;          // this thread's key row
  const int c = threadIdx.x / kRows;          // its column chunk (phase B)
  const int j = k0 + r;

  load_rows<T, DH>(k_s, LD, k + b * ks.b + h * ks.h, ks.t, k0, kRows, tk);
  load_rows<T, DH>(v_s, LD, v + b * vs.b + h * vs.h, vs.t, k0, kRows, tk);
  if (c == 0) {
    valid_s[r] =
        (j < tk && kv_valid[static_cast<int64_t>(b) * tk + j]) ? 1.0f : 0.0f;
  }

  float dk_acc[kChunk], dv_acc[kChunk];
#pragma unroll
  for (int d = 0; d < kChunk; ++d) dk_acc[d] = dv_acc[d] = 0.0f;

  // with the causal flag, queries before the block's first key see none
  // of its keys
  const int q_begin = causal ? k0 : 0;
  const T* q_head = q + b * qs.b + h * qs.h;
  const T* do_head = dout + b * os.b + h * os.h;
  const int64_t row_at = (static_cast<int64_t>(b) * heads + h) * tq;

  for (int q0 = q_begin; q0 < tq; q0 += kTile) {
    __syncthreads();                 // the previous tile is consumed
    load_rows<T, DH>(q_t, DH, q_head, qs.t, q0, kTile, tq);
    load_rows<T, DH>(do_t, DH, do_head, os.t, q0, kTile, tq);
    if (threadIdx.x < kTile) {
      const int qi = q0 + threadIdx.x;
      lse_t[threadIdx.x] = qi < tq ? fmaxf(lse[row_at + qi], kHalfNegInf)
                                   : 0.0f;
      delta_t[threadIdx.x] = qi < tq ? delta[row_at + qi] : 0.0f;
    }
    __syncthreads();

    // phase A: T(p), T(ds) of (queries c, c + DH/32, ..., key row r)
    const bool key_ok = valid_s[r] != 0.0f;
#pragma unroll 1
    for (int ii = c; ii < kTile; ii += DH / kChunk) {
      const int qi = q0 + ii;
      float p = 0.0f, ds = 0.0f;
      if (key_ok && qi < tq && (!causal || j <= qi)) {
        const float s = dot<DH>(q_t + ii * DH, k_s + r * LD) * scale;
        p = s <= kHalfNegInf ? 0.0f : expf(s - lse_t[ii]);
        const float dp = dot<DH>(do_t + ii * DH, v_s + r * LD);
        ds = p * (dp - delta_t[ii]) * scale;
      }
      p_s[ii * kRows + r] = rounded<T>(p);
      ds_s[ii * kRows + r] = rounded<T>(ds);
    }
    __syncthreads();

    // phase B: dv[r, chunk c] += sum_i T(p) dO[i, chunk c];
    //          dk[r, chunk c] += sum_i T(ds) q[i, chunk c]
#pragma unroll 2
    for (int ii = 0; ii < kTile; ++ii) {
      axpy_chunk(dv_acc, p_s[ii * kRows + r], do_t + ii * DH + c * kChunk);
      axpy_chunk(dk_acc, ds_s[ii * kRows + r], q_t + ii * DH + c * kChunk);
    }
  }

  if (j < tk) {
    const int64_t at = (static_cast<int64_t>(b) * tk + j) * heads * DH +
                       static_cast<int64_t>(h) * DH + c * kChunk;
    store_chunk<T>(dk + at, dk_acc);
    store_chunk<T>(dv + at, dv_acc);
  }
}

// ---- bf16 dk/dv: the wgmma kernel ----

constexpr int kWarpgroup = 128;

// dh 128 takes two warpgroups, each the dk/dv columns of one panel (both
// compute S^T and dP^T): one warpgroup would hold 128 + 128 float32
// accumulators of dk and dv beside those of S^T and dP^T
template <int DH>
constexpr int dkv_warpgroups() { return DH == 128 ? 2 : 1; }

template <int DH>
__global__ void __launch_bounds__(kWarpgroup * dkv_warpgroups<DH>())
flash_attention_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse,       // [B, H, Tq]
    const float* __restrict__ delta,     // [B, H, Tq]
    const uint8_t* __restrict__ kv_valid,
    __nv_bfloat16* __restrict__ dk,      // [B, Tk, H, DH]
    __nv_bfloat16* __restrict__ dv,      // [B, Tk, H, DH]
    int tq, int tk, int heads, float scale, int causal) {
  using namespace flash_sm90;
  using G = Tile<DH>;
  constexpr int kCols = G::kPanelCols;   // dk/dv columns a warpgroup
  extern __shared__ uint8_t smem_raw[];
  // [K][V][Q0][dO0][Q1][dO1] from a 1024-byte boundary, then 3 mbarriers
  // (K/V, stage 0, stage 1) and the clamped lse and delta of each stage
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* tail = smem_raw + (base - raw) + 6 * G::kBytes;
  const uint32_t kv_bar = smem_u32(tail);
  const uint32_t bar = kv_bar + 8;       // bar + 8 s: stage s
  float* lse_s = reinterpret_cast<float*>(tail + 32);    // [2][64]
  float* delta_s = lse_s + 2 * kRows;                     // [2][64]
  const uint32_t k_s = base, v_s = base + G::kBytes;
  auto q_s = [&](int s) { return base + (2 + 2 * s) * G::kBytes; };
  auto do_s = [&](int s) { return base + (3 + 2 * s) * G::kBytes; };

  const CUtensorMap* qm = &q_map;
  const CUtensorMap* om = &do_map;
  const int tid = threadIdx.x, wg = tid / kWarpgroup;
  const int warp = tid % kWarpgroup / 32, lane = tid % 32;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kRows;
  const uint8_t* valid_row = kv_valid + static_cast<int64_t>(b) * tk;
  const int64_t out_at = static_cast<int64_t>(h) * DH;   // + row * heads DH

  // a block whose 64 keys are all masked writes zeros
  const bool mine = tid < kRows && k0 + tid < tk && valid_row[k0 + tid] != 0;
  if (!__syncthreads_or(mine)) {
    for (int idx = tid; idx < kRows * DH / 8; idx += blockDim.x) {
      const int j = k0 + idx / (DH / 8);
      if (j < tk) {
        const int64_t at = (static_cast<int64_t>(b) * tk + j) * heads * DH +
                           out_at + idx % (DH / 8) * 8;
        *reinterpret_cast<uint4*>(dk + at) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dv + at) = make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }
  // this thread's two key rows (the accumulator fragment's rows)
  const int row0 = k0 + 16 * warp + lane / 4;
  const int rows[2] = {row0, row0 + 8};
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key_ok[r] = rows[r] < tk && valid_row[rows[r]] != 0;
  }

  if (tid == 0) {
    mbar_init(kv_bar, 1);
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    fence_barrier_init();
  }
  __syncthreads();

  // with the causal flag, queries before the block's first key see none
  // of its keys
  const int qt0 = causal ? k0 / kRows : 0;
  const int n_qt = (tq + kRows - 1) / kRows;
  const int64_t row_at = (static_cast<int64_t>(b) * heads + h) * tq;
  // tile qt's Q and dO into stage s (one thread), its clamped lse and
  // delta into slot s (threads 0-63)
  auto fetch = [&](int qt, int s) {
    if (tid == 0) {
      mbar_expect_tx(bar + 8 * s, 2 * G::kBytes);
      load_tile<DH>(qm, q_s(s), bar + 8 * s, qt * kRows, h, b);
      load_tile<DH>(om, do_s(s), bar + 8 * s, qt * kRows, h, b);
    }
    if (tid < kRows) {
      const int qi = qt * kRows + tid;
      lse_s[s * kRows + tid] =
          qi < tq ? fmaxf(lse[row_at + qi], kHalfNegInf) : 0.0f;
      delta_s[s * kRows + tid] = qi < tq ? delta[row_at + qi] : 0.0f;
    }
  };
  if (tid == 0) {
    mbar_expect_tx(kv_bar, 2 * G::kBytes);
    load_tile<DH>(&k_map, k_s, kv_bar, k0, h, b);
    load_tile<DH>(&v_map, v_s, kv_bar, k0, h, b);
  }
  if (qt0 < n_qt) fetch(qt0, 0);
  mbar_wait(kv_bar, 0);

  float dk_acc[kCols / 2], dv_acc[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
  uint32_t phase = 0;                // bit s: the parity stage s waits for
  int stage = 0;
  for (int qt = qt0; qt < n_qt; ++qt) {
    __syncthreads();                 // the other stage and slot are free
    if (qt + 1 < n_qt) fetch(qt + 1, stage ^ 1);
    mbar_wait(bar + 8 * stage, (phase >> stage) & 1);
    phase ^= 1u << stage;

    // S^T = K Q^T and dP^T = V dO^T: rows are this block's keys, columns
    // the tile's queries
    float st[32], dpt[32];
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wgmma_ss_n64(st, desc_k<DH>(k_s, kk), desc_k<DH>(q_s(stage), kk),
                   kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wgmma_ss_n64(dpt, desc_k<DH>(v_s, kk), desc_k<DH>(do_s(stage), kk),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // p and ds on the fragment; lse and delta are per column
    const int q0 = qt * kRows;
    const float* lse_t = lse_s + stage * kRows;
    const float* delta_t = delta_s + stage * kRows;
    uint32_t pa[4][4], da[4][4];     // T(p^T), T(ds^T) as A fragments
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = frag_col(i, lane), r = frag_row(i);
      const int qi = q0 + c;
      const bool ok = key_ok[r] && qi < tq && (!causal || rows[r] <= qi);
      const float s = ok ? st[i] * scale : kNegInf;
      const float p = s <= kHalfNegInf ? 0.0f : expf(s - lse_t[c]);
      dpt[i] = p * (dpt[i] - delta_t[c]) * scale;
      st[i] = p;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pa[kk][j] = pack_bf16(st[8 * kk + 2 * j], st[8 * kk + 2 * j + 1]);
        da[kk][j] = pack_bf16(dpt[8 * kk + 2 * j], dpt[8 * kk + 2 * j + 1]);
      }
    }

    // dV += T(P^T) dO and dK += T(dS^T) Q over the tile's queries, on this
    // warpgroup's panel of columns (dO and Q MN-major)
    fence_regs(dk_acc);
    fence_regs(dv_acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(pa[kk]);
      fence_regs(da[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<kCols>(dv_acc, pa[kk], desc_mn<DH>(do_s(stage), wg, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<kCols>(dk_acc, da[kk], desc_mn<DH>(q_s(stage), wg, kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    stage ^= 1;
  }

#pragma unroll
  for (int i = 0; i < kCols / 2; i += 2) {
    const int row = rows[frag_row(i)];
    if (row < tk) {
      const int64_t at = (static_cast<int64_t>(b) * tk + row) * heads * DH +
                         out_at + wg * kCols + frag_col(i, lane);
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dk_acc[i], dk_acc[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

// ---- bf16 dq: the wgmma kernel ----

template <int DH>
__global__ void __launch_bounds__(kWarpgroup)
flash_attention_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse,       // [B, H, Tq]
    const float* __restrict__ delta,     // [B, H, Tq]
    const uint8_t* __restrict__ kv_valid,
    __nv_bfloat16* __restrict__ dq,      // [B, Tq, H, DH]
    int tq, int tk, int heads, float scale, int causal) {
  using namespace flash_sm90;
  using G = Tile<DH>;
  constexpr int kCols = G::kPanelCols;   // dq columns a panel
  extern __shared__ uint8_t smem_raw[];
  // [Q][dO][K0][V0][K1][V1] from a 1024-byte boundary, then 2 mbarriers
  // (stage 0: also Q and dO) and the key masks of the two stages (2 words
  // each)
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* tail = smem_raw + (base - raw) + 6 * G::kBytes;
  const uint32_t bar = smem_u32(tail);   // bar + 8 s: stage s
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(tail + 16);
  const uint32_t q_s = base, do_s = base + G::kBytes;
  auto k_s = [&](int s) { return base + (2 + 2 * s) * G::kBytes; };
  auto v_s = [&](int s) { return base + (3 + 2 * s) * G::kBytes; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  // this thread's two query rows (the accumulator fragment's rows), their
  // clamped lse and their delta
  const int row0 = q0 + 16 * warp + lane / 4;
  const int rows[2] = {row0, row0 + 8};
  const int64_t row_at = (static_cast<int64_t>(b) * heads + h) * tq;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < tq;
    lse_r[r] = in ? fmaxf(lse[row_at + rows[r]], kHalfNegInf) : 0.0f;
    delta_r[r] = in ? delta[row_at + rows[r]] : 0.0f;
  }
  // with the causal flag, keys past the block's last row are all masked
  const int last_row = min(q0 + kRows, tq) - 1;
  const int k_end = causal ? min(tk, last_row + 1) : tk;
  const int n_tiles = (k_end + kRows - 1) / kRows;
  const uint8_t* valid_row = kv_valid + static_cast<int64_t>(b) * tk;

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    fence_barrier_init();
  }
  __syncthreads();

  // the first live key tile at or after t; its key mask into slot
  auto find_live = [&](int t, int slot) {
    return find_live_tile(t, n_tiles, tk, valid_row, mask_s + 2 * slot);
  };

  float acc[G::kPanels][kCols / 2];
#pragma unroll
  for (int p = 0; p < G::kPanels; ++p) {
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) acc[p][i] = 0.0f;
  }

  int cur = find_live(0, 0);
  if (cur < n_tiles && tid == 0) {
    mbar_expect_tx(bar, 4 * G::kBytes);
    load_tile<DH>(&q_map, q_s, bar, q0, h, b);
    load_tile<DH>(&do_map, do_s, bar, q0, h, b);
    load_tile<DH>(&k_map, k_s(0), bar, cur * kRows, h, b);
    load_tile<DH>(&v_map, v_s(0), bar, cur * kRows, h, b);
  }
  uint32_t phase = 0;                // bit s: the parity stage s waits for
  int stage = 0;
  while (cur < n_tiles) {
    __syncthreads();                 // the other stage and mask slot are free
    const int nxt = find_live(cur + 1, stage ^ 1);
    if (nxt < n_tiles && tid == 0) {
      const uint32_t nbar = bar + 8 * (stage ^ 1);
      mbar_expect_tx(nbar, 2 * G::kBytes);
      load_tile<DH>(&k_map, k_s(stage ^ 1), nbar, nxt * kRows, h, b);
      load_tile<DH>(&v_map, v_s(stage ^ 1), nbar, nxt * kRows, h, b);
    }
    mbar_wait(bar + 8 * stage, (phase >> stage) & 1);
    phase ^= 1u << stage;

    // S = Q K^T (the forward's instructions in its k-step order, so its
    // bits) and dP = dO V^T
    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wgmma_ss_n64(s, desc_k<DH>(q_s, kk), desc_k<DH>(k_s(stage), kk),
                   kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wgmma_ss_n64(dp, desc_k<DH>(do_s, kk), desc_k<DH>(v_s(stage), kk),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // p and ds on the fragment; lse and delta are per row
    const uint32_t words[2] = {mask_s[2 * stage], mask_s[2 * stage + 1]};
    const int k0 = cur * kRows;
    uint32_t da[4][4];               // T(ds) as the A fragments of dS K
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = frag_col(i, lane), r = frag_row(i);   // c / 32 = i / 16
      const bool ok = ((words[i / 16] >> (c % 32)) & 1u) && rows[r] < tq &&
                      (!causal || k0 + c <= rows[r]);
      const float sv = ok ? s[i] * scale : kNegInf;
      const float p = sv <= kHalfNegInf ? 0.0f : expf(sv - lse_r[r]);
      dp[i] = p * (dp[i] - delta_r[r]) * scale;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        da[kk][j] = pack_bf16(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1]);
      }
    }

    // dQ += T(dS) K over the tile's keys, one product a panel of K's
    // columns (K MN-major)
#pragma unroll
    for (int p = 0; p < G::kPanels; ++p) fence_regs(acc[p]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(da[kk]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < G::kPanels; ++p) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<kCols>(acc[p], da[kk], desc_mn<DH>(k_s(stage), p, kk), 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < G::kPanels; ++p) fence_regs(acc[p]);
    cur = nxt;
    stage ^= 1;
  }

#pragma unroll
  for (int p = 0; p < G::kPanels; ++p) {
#pragma unroll
    for (int i = 0; i < kCols / 2; i += 2) {
      const int row = rows[frag_row(i)];
      if (row < tq) {
        const int64_t at = (static_cast<int64_t>(b) * tq + row) * heads * DH +
                           static_cast<int64_t>(h) * DH + p * kCols +
                           frag_col(i, lane);
        *reinterpret_cast<__nv_bfloat162*>(dq + at) =
            __floats2bfloat162_rn(acc[p][i], acc[p][i + 1]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const uint8_t* kv_valid;
  int b, tq, tk, heads;
  Strides qs, ks, vs, os;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int DH>
int launch_dq(const Args& a, void* dq) {
  const size_t smem = dq_smem_floats<DH>() * sizeof(float);
  auto kernel = flash_attention_bwd_dq_simt_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.tq + kRows - 1) / kRows, a.heads, a.b);
  kernel<<<grid, 2 * DH, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.kv_valid, static_cast<T*>(dq), a.tq, a.tk, a.heads, a.qs,
      a.ks, a.vs, a.os, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_dkv(const Args& a, void* dk, void* dv) {
  const size_t smem = dkv_smem_floats<DH>() * sizeof(float);
  auto kernel = flash_attention_bwd_dkv_simt_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.tk + kRows - 1) / kRows, a.heads, a.b);
  kernel<<<grid, 2 * DH, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.kv_valid, static_cast<T*>(dk), static_cast<T*>(dv), a.tq,
      a.tk, a.heads, a.qs, a.ks, a.vs, a.os, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

// the tensor maps of q, k, v and dO; 0 or an error code
template <int DH>
int encode_maps(const Args& a, CUtensorMap (&maps)[4]) {
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  const Strides st[4] = {a.qs, a.ks, a.vs, a.os};
  for (int i = 0; i < 4; ++i) {
    const int err = flash_sm90::encode_tile_map<DH>(
        &maps[i], ptrs[i], a.b, (i == 1 || i == 2) ? a.tk : a.tq, a.heads,
        st[i].b, st[i].t, st[i].h);
    if (err) return err;
  }
  return 0;
}

template <int DH>
int launch_dq_wgmma(const Args& a, void* dq) {
  using G = flash_sm90::Tile<DH>;
  CUtensorMap maps[4];
  if (const int err = encode_maps<DH>(a, maps)) return err;
  const size_t smem = 6 * G::kBytes + 1024 + 32;
  auto kernel = flash_attention_bwd_dq_wgmma_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.tq + kRows - 1) / kRows, a.heads, a.b);
  kernel<<<grid, kWarpgroup, smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.lse, a.delta, a.kv_valid,
      static_cast<__nv_bfloat16*>(dq), a.tq, a.tk, a.heads, a.scale,
      a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dkv_wgmma(const Args& a, void* dk, void* dv) {
  using G = flash_sm90::Tile<DH>;
  CUtensorMap maps[4];
  if (const int err = encode_maps<DH>(a, maps)) return err;
  const size_t smem = 6 * G::kBytes + 1024 + 32 + 4 * kRows * sizeof(float);
  auto kernel = flash_attention_bwd_dkv_wgmma_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.tk + kRows - 1) / kRows, a.heads, a.b);
  kernel<<<grid, kWarpgroup * dkv_warpgroups<DH>(), smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.lse, a.delta, a.kv_valid,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a.tq,
      a.tk, a.heads, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0 (float32) takes the SIMT dq kernel, 1 (bf16) the wgmma one
int launch_dq_dh(int dtype, int dh, const Args& a, void* dq) {
  switch (dh) {
    case 32:
      return dtype ? launch_dq_wgmma<32>(a, dq) : launch_dq<float, 32>(a, dq);
    case 64:
      return dtype ? launch_dq_wgmma<64>(a, dq) : launch_dq<float, 64>(a, dq);
    case 128:
      return dtype ? launch_dq_wgmma<128>(a, dq)
                   : launch_dq<float, 128>(a, dq);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype 0 (float32) takes the SIMT dk/dv kernel, 1 (bf16) the wgmma one
int launch_dkv_dh(int dtype, int dh, const Args& a, void* dk, void* dv) {
  switch (dh) {
    case 32:
      return dtype ? launch_dkv_wgmma<32>(a, dk, dv)
                   : launch_dkv<float, 32>(a, dk, dv);
    case 64:
      return dtype ? launch_dkv_wgmma<64>(a, dk, dv)
                   : launch_dkv<float, 64>(a, dk, dv);
    case 128:
      return dtype ? launch_dkv_wgmma<128>(a, dk, dv)
                   : launch_dkv<float, 128>(a, dk, dv);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// which = 0: dq into out0; 1: dk, dv into out0, out1
int launch(int which, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* delta,
           const uint8_t* kv_valid, void* out0, void* out1, int b, int tq,
           int tk, int heads, int dh, const int64_t* st, float scale,
           int causal, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  // an empty side: dq of no queries, or dk/dv of no keys, is empty
  if (b == 0 || heads == 0 || (which == 0 ? tq : tk) == 0) return 0;
  const Args a{q, k, v, dout, lse, delta, kv_valid, b, tq, tk, heads,
               Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
               Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
               scale, causal, static_cast<cudaStream_t>(stream)};
  if (which == 0) return launch_dq_dh(dtype, dh, a, out0);
  return launch_dkv_dh(dtype, dh, a, out0, out1);
}

}  // namespace

extern "C" {

// Both launch on `stream` (PyTorch's current stream) without synchronising
// and return 0, the cudaError_t of the launch, cudaErrorInvalidValue for
// an unsupported dtype or head size, or (wgmma) 1000 + the CUresult of a
// refused tensor map. dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and
// the outputs): each the SIMT kernel in float32 and the wgmma kernel in
// bf16; dh in {32, 64, 128}. q and dO
// [B, Tq, H, dh], k and v [B, Tk, H, dh] are given by their batch, time
// and head strides in elements (the head dimension contiguous; for the
// wgmma kernel every stride a multiple of 16 bytes and every base 16-byte
// aligned, as TMA reads them): strides = {q_b, q_t, q_h, k_b, k_t, k_h,
// v_b, v_t, v_h, do_b, do_t, do_h}. lse and delta [B, H, Tq] float32 and
// kv_valid [B, Tk] one byte each (non-zero = valid) are contiguous, and so
// are the outputs: dq [B, Tq, H, dh], dk and dv [B, Tk, H, dh]. The caller
// guarantees b and heads <= 65535.

int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, const uint8_t* kv_valid,
                                  void* dq, int b, int tq, int tk, int heads,
                                  int dh, const int64_t* strides, float scale,
                                  int causal, int dtype, void* stream) {
  return launch(0, q, k, v, dout, lse, delta, kv_valid, dq, nullptr, b, tq,
                tk, heads, dh, strides, scale, causal, dtype, stream);
}

int flash_attention_bwd_dkv_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   const uint8_t* kv_valid, void* dk, void* dv,
                                   int b, int tq, int tk, int heads, int dh,
                                   const int64_t* strides, float scale,
                                   int causal, int dtype, void* stream) {
  return launch(1, q, k, v, dout, lse, delta, kv_valid, dk, dv, b, tq, tk,
                heads, dh, strides, scale, causal, dtype, stream);
}

const char* flash_attention_bwd_error_string(int code) {
  return flash_sm90::error_string(code);
}

}  // extern "C"
