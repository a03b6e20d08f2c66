// Flash attention forward (online softmax) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel _flash_kernel of
// tpu_asr/ops/pallas/flash_attention.py, reached through _flash_forward
// (flash_attention). For utterance b, head h and query row i, over the
// keys j of [B, Tk, H, dh] that are valid (kv_valid[b, j], and j <= i
// when causal):
//
//   s[j]  = (q[i] . k[j]) * scale       float32 dot of the input-type
//                                        values, THEN the scale
//   m     = max_j s[j]; p[j] = exp(s[j] - m); l = sum_j p[j]
//   out   = T(sum_j T(p[j]) * v[j] / max(l, 1e-30))
//   lse   = m + log(l), float32 [B, H, Tq]
//
// with the TPU kernel's guards (:78-85): masked scores are NEG_INF = -1e30
// (finite), p is exactly 0 where s <= NEG_INF / 2, and the running max is
// clamped to NEG_INF / 2 before it is subtracted. p is rounded to the
// input type T before the product with V (as the TPU kernel feeds the MXU)
// while l sums the unrounded p. A row whose keys are all masked (the
// server's length-0 dummy rows) writes zeros and lse = NEG_INF, never NaN.
// The scores never reach device memory.
//
// What bounds it on this card: at the served shapes, bytes. One head of
// one utterance does 4 dh Tq Tk flops on 2 dh (Tq + Tk) values of q, k, v
// and out, Tq Tk / (Tq + Tk) flops a bf16 byte: <= 124 at the served
// T' <= 248, below the bf16 tensor-core ridge (~295 flops a byte). But
// this first kernel does its dot products in float32 on the SIMT units
// (67 TFLOP/s), not on the tensor cores. Measured on an H100 (PERF.md),
// the kernel alone takes ~0.40 ms at the served decoder cross-attention
// ([80, 101] x [80, 248], bf16): ~23x its byte bound and ~8% of the SIMT
// float32 rate, so neither bytes nor arithmetic hold it back but latency:
// 2 warps a block at ~250 registers a thread, and a serial walk over the
// keys. It is correct and simple first; tensor cores (wgmma), TMA and a
// pipelined K/V ring are later work.
//
// Design: one block of 64 threads per (tile of 64 query rows, head,
// utterance); thread t owns query row q0 + t: its q row and its float32
// accumulator live in registers, and so do its running max and sum. q,
// k and v are read straight from the [B, T, H, dh] layout with the
// strides the caller gives (the last axis contiguous), and out is written
// in that layout, so no transpose or pad is needed. Key/value tiles of 32
// rows are converted to float32 in shared memory; every thread of the
// block reads the same key at once (a broadcast, no bank conflict). Per
// tile a row computes its 32 scores into its own column of a shared tile
// (so the key loops need not be unrolled to keep them in registers), then
// the TPU kernel's update (m_new, the correction of l and acc, p, l,
// acc += p V). The dot keeps four partial sums (the MXU's order of the
// sum is not specified either). With the causal flag, key tiles wholly
// above the block's last query row are skipped: every entry there is
// masked, so skipping them changes nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block, one a thread
constexpr int kBK = 32;          // keys per shared-memory tile
constexpr float kNegInf = -1e30f;
constexpr float kHalfNegInf = -5e29f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);                    // round to nearest even
}

struct Strides {      // in elements; the head dimension is contiguous
  int64_t b, t, h;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kBQ)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const uint8_t* __restrict__ kv_valid,  // [B, Tk]
                           T* __restrict__ out,        // [B, Tq, H, DH]
                           float* __restrict__ lse,    // [B, H, Tq]
                           int tq, int tk, int heads, Strides qs, Strides ks,
                           Strides vs, float scale, int causal) {
  __shared__ __align__(16) float k_tile[kBK][DH];
  __shared__ __align__(16) float v_tile[kBK][DH];
  __shared__ float s_tile[kBK][kBQ];
  __shared__ uint8_t valid_tile[kBK];

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int i = q0 + threadIdx.x;
  const bool row_ok = i < tq;

  float qr[DH], acc[DH];
  const T* q_row = q + b * qs.b + static_cast<int64_t>(row_ok ? i : 0) * qs.t +
                   h * qs.h;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = row_ok ? to_float(q_row[d]) : 0.0f;
    acc[d] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;

  // with the causal flag, keys past the block's last row are all masked
  const int last_row = min(q0 + kBQ, tq) - 1;
  const int k_end = causal ? min(tk, last_row + 1) : tk;
  const T* k_head = k + b * ks.b + h * ks.h;
  const T* v_head = v + b * vs.b + h * vs.h;
  const uint8_t* valid_row = kv_valid + static_cast<int64_t>(b) * tk;

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();                       // the previous tile is consumed
    for (int idx = threadIdx.x; idx < kBK * DH; idx += kBQ) {
      const int j = idx / DH, d = idx % DH;
      const int kj = k0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (kj < tk) {
        kv = to_float(k_head[static_cast<int64_t>(kj) * ks.t + d]);
        vv = to_float(v_head[static_cast<int64_t>(kj) * vs.t + d]);
      }
      k_tile[j][d] = kv;
      v_tile[j][d] = vv;
    }
    if (threadIdx.x < kBK) {
      const int kj = k0 + threadIdx.x;
      valid_tile[threadIdx.x] = (kj < tk && valid_row[kj]) ? 1 : 0;
    }
    __syncthreads();
    if (!row_ok) continue;                 // idle rows still meet the barriers

    // scores of this tile: the float32 dot (four partial sums), then the
    // scale, then the mask; each thread keeps its row's scores in its own
    // column of s_tile
    float tile_max = kNegInf;
#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      float dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&k_tile[j][d]);
        dot[0] = fmaf(qr[d], kk.x, dot[0]);
        dot[1] = fmaf(qr[d + 1], kk.y, dot[1]);
        dot[2] = fmaf(qr[d + 2], kk.z, dot[2]);
        dot[3] = fmaf(qr[d + 3], kk.w, dot[3]);
      }
      const bool ok = valid_tile[j] && (!causal || k0 + j <= i);
      const float sj =
          ok ? ((dot[0] + dot[1]) + (dot[2] + dot[3])) * scale : kNegInf;
      s_tile[j][threadIdx.x] = sj;
      tile_max = fmaxf(tile_max, sj);
    }

    // the TPU kernel's online-softmax update
    const float m_new = fmaxf(m, tile_max);
    const float m_safe = fmaxf(m_new, kHalfNegInf);
    const float corr =
        m <= kHalfNegInf ? 0.0f : expf(fmaxf(m, kHalfNegInf) - m_safe);
    l *= corr;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= corr;
    float p_sum = 0.0f;
#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      const float sj = s_tile[j][threadIdx.x];
      const float p = sj <= kHalfNegInf ? 0.0f : expf(sj - m_safe);
      p_sum += p;
      const float pr = to_float(from_float<T>(p));   // p in the input type
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_tile[j][d]);
        acc[d] = fmaf(pr, vv.x, acc[d]);
        acc[d + 1] = fmaf(pr, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(pr, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(pr, vv.w, acc[d + 3]);
      }
    }
    l += p_sum;
    m = m_new;
  }

  if (!row_ok) return;
  const float lc = fmaxf(l, 1e-30f);
  T* o_row = out + (static_cast<int64_t>(b) * tq + i) * heads * DH +
             static_cast<int64_t>(h) * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) o_row[d] = from_float<T>(acc[d] / lc);
  lse[(static_cast<int64_t>(b) * heads + h) * tq + i] =
      m <= kHalfNegInf ? kNegInf : m + logf(lc);
}

template <typename T, int DH>
int launch_typed(const void* q, const void* k, const void* v,
                 const uint8_t* kv_valid, void* out, float* lse, int b,
                 int tq, int tk, int heads, Strides qs, Strides ks,
                 Strides vs, float scale, int causal, cudaStream_t stream) {
  const dim3 grid((tq + kBQ - 1) / kBQ, heads, b);
  flash_attention_fwd_kernel<T, DH><<<grid, kBQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_valid, static_cast<T*>(out), lse, tq, tk,
      heads, qs, ks, vs, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v,
              const uint8_t* kv_valid, void* out, float* lse, int b, int tq,
              int tk, int heads, Strides qs, Strides ks, Strides vs,
              float scale, int causal, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch_typed<T, 32>(q, k, v, kv_valid, out, lse, b, tq, tk,
                                 heads, qs, ks, vs, scale, causal, stream);
    case 64:
      return launch_typed<T, 64>(q, k, v, kv_valid, out, lse, b, tq, tk,
                                 heads, qs, ks, vs, scale, causal, stream);
    case 128:
      return launch_typed<T, 128>(q, k, v, kv_valid, out, lse, b, tq, tk,
                                  heads, qs, ks, vs, scale, causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (PyTorch's current stream) without synchronising
// and returns the cudaError_t of the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for an unsupported dtype or head size. dtype: 0 =
// float32, 1 = bfloat16; dh in {32, 64, 128}. q [B, Tq, H, dh] and k, v
// [B, Tk, H, dh] are given by their batch, time and head strides in
// elements (the head dimension contiguous); kv_valid [B, Tk] one byte
// each (non-zero = valid); out [B, Tq, H, dh] and lse [B, H, Tq] float32
// are contiguous. The caller guarantees b and heads <= 65535.

int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               const uint8_t* kv_valid, void* out, float* lse,
                               int b, int tq, int tk, int heads, int dh,
                               int64_t q_sb, int64_t q_st, int64_t q_sh,
                               int64_t k_sb, int64_t k_st, int64_t k_sh,
                               int64_t v_sb, int64_t v_st, int64_t v_sh,
                               float scale, int causal, int dtype,
                               void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || tq == 0 || heads == 0) return 0;
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_dh<float>(dh, q, k, v, kv_valid, out, lse, b, tq, tk,
                            heads, qs, ks, vs, scale, causal, s);
  }
  return launch_dh<__nv_bfloat16>(dh, q, k, v, kv_valid, out, lse, b, tq, tk,
                                  heads, qs, ks, vs, scale, causal, s);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
