// Fused residual-add + LayerNorm, forward and backward, for NVIDIA Hopper
// (sm_90a).
//
// The forward replaces the TPU kernel _fwd_kernel of
// tpu_asr/ops/pallas/layernorm.py, reached through _fwd
// (layer_norm_residual). For each row of [rows, D]:
//
//   x     = float(residual) + float(h)             (the add in float32)
//   mean  = sum(x) / D
//   var   = sum((x - mean)^2) / D                  (two passes)
//   rstd  = 1 / sqrt(var + eps)
//   out   = T((x - mean) * rstd * gamma + beta)    (T = the input type)
//
// and mean, rstd float32, one per row (what the backward reads).
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
//
// The backward replaces the TPU kernel _bwd_kernel of the same file,
// reached through _bwd (the custom VJP). For each row, from the forward's
// mean and rstd and the output's gradient dy:
//
//   x_hat = (float(residual) + float(h) - mean) * rstd
//   a     = dy * gamma
//   dx    = T(rstd * (a - mean(a) - x_hat * mean(a * x_hat)))
//
// (the same dx is the gradient of residual and of h), and per block the
// float32 partial sums over its rows of dy * x_hat (dgamma) and dy
// (dbeta), [blocks, D] each, which the caller adds up (the reference sums
// its per-program partials in XLA, outside its kernel). No float atomics:
// the sums have a fixed order, so runs are bitwise repeatable.
//
// What bounds it: bytes. Per row it reads residual, h and dy once and
// writes dx once (4 D elements, ~33 MB at the encoder's 7968 x 512 bf16:
// ~10 us at 3.35 TB/s), plus D floats of partials per block of 32 rows.
// Design: one warp a row as in the forward, 8 warps a block, each warp
// walking 4 rows. A lane keeps its columns' partial sums in registers; a
// row is read once for its two warp-shuffle sums and again (from L1) for
// dx, so no row is held in registers and D up to 2048 does not spill. The
// block then adds its 8 warps' partials in warp order through a small
// shared tile.

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

constexpr int kBwdRowsPerWarp = 4;
constexpr int kBwdRowsPerBlock = kRowsPerBlock * kBwdRowsPerWarp;

// V = the largest number of elements a lane may hold (D / 32 <= V)
template <typename T, int V>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
layer_norm_residual_bwd_kernel(const T* __restrict__ residual,
                               const T* __restrict__ h,
                               const T* __restrict__ dy,
                               const float* __restrict__ gamma,
                               const float* __restrict__ mean_in,
                               const float* __restrict__ rstd_in,
                               T* __restrict__ dx,
                               float* __restrict__ dgamma_part,  // [blocks, d]
                               float* __restrict__ dbeta_part,   // [blocks, d]
                               int64_t rows, int d) {
  __shared__ float red_g[kRowsPerBlock][32];
  __shared__ float red_b[kRowsPerBlock][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = d >> 5;
  const float df = static_cast<float>(d);

  float pg[V], pb[V];               // this lane's columns: sum dy x_hat, dy
#pragma unroll
  for (int j = 0; j < V; ++j) pg[j] = pb[j] = 0.0f;

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBwdRowsPerBlock +
                       warp * kBwdRowsPerWarp;
  for (int rr = 0; rr < kBwdRowsPerWarp; ++rr) {
    const int64_t row = row0 + rr;
    if (row >= rows) break;                 // a whole warp leaves together
    const T* r_row = residual + row * d;
    const T* h_row = h + row * d;
    const T* dy_row = dy + row * d;
    const float mean = mean_in[row], rstd = rstd_in[row];
    float sum_a = 0.0f, sum_ax = 0.0f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (j < n) {
        const int c = lane + 32 * j;
        const float xhat = (to_float(r_row[c]) + to_float(h_row[c]) - mean) *
                           rstd;
        const float g = to_float(dy_row[c]);
        const float a = g * gamma[c];
        sum_a += a;
        sum_ax = fmaf(a, xhat, sum_ax);
        pg[j] = fmaf(g, xhat, pg[j]);
        pb[j] += g;
      }
    }
    const float m1 = warp_sum(sum_a) / df;
    const float m2 = warp_sum(sum_ax) / df;
    T* dx_row = dx + row * d;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (j < n) {
        const int c = lane + 32 * j;
        const float xhat = (to_float(r_row[c]) + to_float(h_row[c]) - mean) *
                           rstd;
        const float a = to_float(dy_row[c]) * gamma[c];
        dx_row[c] = from_float<T>(rstd * (a - m1 - xhat * m2));
      }
    }
  }

  // the block's partials: warps 0..7 added in order, 32 columns at a time
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (j < n) {
      red_g[warp][lane] = pg[j];
      red_b[warp][lane] = pb[j];
      __syncthreads();
      if (warp == 0) {
        float sg = 0.0f, sb = 0.0f;
#pragma unroll
        for (int w = 0; w < kRowsPerBlock; ++w) {
          sg += red_g[w][lane];
          sb += red_b[w][lane];
        }
        const int64_t at = static_cast<int64_t>(blockIdx.x) * d + lane + 32 * j;
        dgamma_part[at] = sg;
        dbeta_part[at] = sb;
      }
      __syncthreads();
    }
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

template <typename T, int V>
void launch_bwd_v(const void* residual, const void* h, const void* dy,
                  const float* gamma, const float* mean, const float* rstd,
                  void* dx, float* dgamma_part, float* dbeta_part,
                  int64_t rows, int d, cudaStream_t stream) {
  const int64_t blocks = (rows + kBwdRowsPerBlock - 1) / kBwdRowsPerBlock;
  layer_norm_residual_bwd_kernel<T, V>
      <<<dim3(static_cast<unsigned>(blocks)), kRowsPerBlock * 32, 0,
         stream>>>(static_cast<const T*>(residual), static_cast<const T*>(h),
                   static_cast<const T*>(dy), gamma, mean, rstd,
                   static_cast<T*>(dx), dgamma_part, dbeta_part, rows, d);
}

template <typename T>
int launch_bwd_typed(const void* residual, const void* h, const void* dy,
                     const float* gamma, const float* mean, const float* rstd,
                     void* dx, float* dgamma_part, float* dbeta_part,
                     int64_t rows, int d, cudaStream_t stream) {
  const int n = d / 32;
  if (n <= 4) {
    launch_bwd_v<T, 4>(residual, h, dy, gamma, mean, rstd, dx, dgamma_part,
                       dbeta_part, rows, d, stream);
  } else if (n <= 8) {
    launch_bwd_v<T, 8>(residual, h, dy, gamma, mean, rstd, dx, dgamma_part,
                       dbeta_part, rows, d, stream);
  } else if (n <= 16) {
    launch_bwd_v<T, 16>(residual, h, dy, gamma, mean, rstd, dx, dgamma_part,
                        dbeta_part, rows, d, stream);
  } else if (n <= 32) {
    launch_bwd_v<T, 32>(residual, h, dy, gamma, mean, rstd, dx, dgamma_part,
                        dbeta_part, rows, d, stream);
  } else {
    launch_bwd_v<T, 64>(residual, h, dy, gamma, mean, rstd, dx, dgamma_part,
                        dbeta_part, rows, d, stream);
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

// The backward: the same contract, with dy and dx [rows, d] in the input
// type and mean, rstd [rows] float32 from the forward; dgamma_part and
// dbeta_part are float32 [ceil(rows / 32), d], one row of partial sums per
// block of 32 rows (layer_norm_residual_bwd_blocks gives the count).

int layer_norm_residual_bwd_blocks(int64_t rows) {
  return static_cast<int>((rows + kBwdRowsPerBlock - 1) / kBwdRowsPerBlock);
}

int layer_norm_residual_bwd_launch(const void* residual, const void* h,
                                   const void* dy, const float* gamma,
                                   const float* mean, const float* rstd,
                                   void* dx, float* dgamma_part,
                                   float* dbeta_part, int64_t rows, int d,
                                   int dtype, void* stream) {
  if (d % 32 != 0 || d < 32 || d > 2048 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_bwd_typed<float>(residual, h, dy, gamma, mean, rstd, dx,
                                   dgamma_part, dbeta_part, rows, d, s);
  }
  return launch_bwd_typed<__nv_bfloat16>(residual, h, dy, gamma, mean, rstd,
                                         dx, dgamma_part, dbeta_part, rows, d,
                                         s);
}

const char* layer_norm_residual_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
