// Fused residual-add + LayerNorm forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel _fwd_kernel of tpu_asr/ops/pallas/layernorm.py,
// reached through _fwd (layer_norm_residual). For each row of [rows, D]:
//
//   x     = float(residual) + float(h)             (the add in float32)
//   mean  = sum(x) / D
//   var   = sum((x - mean)^2) / D                  (two passes)
//   rstd  = 1 / sqrt(var + eps)
//   out   = T((x - mean) * rstd * gamma + beta)    (T = the input type)
//
// and mean, rstd float32, one per row (what the backward will read).
// Inputs float32 or bfloat16; gamma and beta float32.
//
// What bounds it on this card: bytes. Per row it reads residual and h once
// and writes out once (3 D elements) plus 8 bytes of statistics, ~10 flops
// an element: far below both ridges. At the served shapes (8080 x 512 bf16
// in the decoder) the bound is ~7.5 us at 3.35 TB/s.
//
// Design: one warp per row, 8 rows per block. Lane l holds elements l,
// l + 32, ... of x in registers (D / 32 of them, so D is a multiple of 32
// up to 2048; a template on that count keeps the array in registers), so
// residual and h are read once, neighbouring lanes on neighbouring
// addresses. Both reductions are warp shuffles (a butterfly, so every
// lane holds the sum): no shared memory and no barrier. 1 / sqrtf is the
// IEEE square root and division (no fast math). Measured on an H100
// (PERF.md), the kernel alone takes ~4.9 us at 8080 x 512 bf16 when its
// inputs are warm in the 50 MB L2, as the decoder leaves them (the bound
// at the HBM rate is 7.4 us). Vector loads and several rows a warp for
// small D are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;

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

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// V = the largest number of elements a lane may hold (D / 32 <= V)
template <typename T, int V>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
layer_norm_residual_kernel(const T* __restrict__ residual,
                           const T* __restrict__ h,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           T* __restrict__ out, float* __restrict__ mean_out,
                           float* __restrict__ rstd_out, int64_t rows, int d,
                           float eps) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;                 // a whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int n = d >> 5;
  const T* r_row = residual + row * d;
  const T* h_row = h + row * d;

  float x[V];
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (j < n) {
      const int c = lane + 32 * j;
      x[j] = to_float(r_row[c]) + to_float(h_row[c]);
      sum += x[j];
    }
  }
  const float df = static_cast<float>(d);
  const float mean = warp_sum(sum) / df;
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (j < n) {
      x[j] -= mean;
      sq = fmaf(x[j], x[j], sq);
    }
  }
  const float var = warp_sum(sq) / df;
  const float rstd = 1.0f / sqrtf(var + eps);
  T* o_row = out + row * d;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (j < n) {
      const int c = lane + 32 * j;
      o_row[c] = from_float<T>(x[j] * rstd * gamma[c] + beta[c]);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T>
int launch_typed(const void* residual, const void* h, const float* gamma,
                 const float* beta, void* out, float* mean, float* rstd,
                 int64_t rows, int d, float eps, cudaStream_t stream) {
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kRowsPerBlock * 32);
  const T* r = static_cast<const T*>(residual);
  const T* hh = static_cast<const T*>(h);
  T* o = static_cast<T*>(out);
  const int n = d / 32;
  if (n <= 4) {
    layer_norm_residual_kernel<T, 4><<<grid, block, 0, stream>>>(
        r, hh, gamma, beta, o, mean, rstd, rows, d, eps);
  } else if (n <= 8) {
    layer_norm_residual_kernel<T, 8><<<grid, block, 0, stream>>>(
        r, hh, gamma, beta, o, mean, rstd, rows, d, eps);
  } else if (n <= 16) {
    layer_norm_residual_kernel<T, 16><<<grid, block, 0, stream>>>(
        r, hh, gamma, beta, o, mean, rstd, rows, d, eps);
  } else if (n <= 32) {
    layer_norm_residual_kernel<T, 32><<<grid, block, 0, stream>>>(
        r, hh, gamma, beta, o, mean, rstd, rows, d, eps);
  } else {
    layer_norm_residual_kernel<T, 64><<<grid, block, 0, stream>>>(
        r, hh, gamma, beta, o, mean, rstd, rows, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` (PyTorch's current stream) without synchronising
// and returns the cudaError_t of the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for an unsupported dtype or D. dtype: 0 = float32,
// 1 = bfloat16. The caller guarantees contiguous buffers: residual, h and
// out [rows, d]; gamma, beta [d] float32; mean, rstd [rows] float32.

int layer_norm_residual_launch(const void* residual, const void* h,
                               const float* gamma, const float* beta,
                               void* out, float* mean, float* rstd,
                               int64_t rows, int d, float eps, int dtype,
                               void* stream) {
  if (d % 32 != 0 || d < 32 || d > 2048 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_typed<float>(residual, h, gamma, beta, out, mean, rstd,
                               rows, d, eps, s);
  }
  return launch_typed<__nv_bfloat16>(residual, h, gamma, beta, out, mean,
                                     rstd, rows, d, eps, s);
}

const char* layer_norm_residual_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
