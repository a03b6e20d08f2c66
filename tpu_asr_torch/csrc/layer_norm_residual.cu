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
// (the same dx is the gradient of residual and of h), and dgamma =
// sum over the rows of dy * x_hat, dbeta = sum of dy, float32 (the
// reference sums its per-program partials in XLA, outside its kernel).
//
// What bounds it: bytes. Per row it reads residual, h and dy once and
// writes dx once (4 D elements, ~32 MB at the encoder's 7854 x 512 bf16:
// ~9.6 us at 3.35 TB/s). The first kernel (a lane one 2-byte element at a
// time, every row read twice, gamma re-read per element, partial sums of
// 32 rows a block added by a separate torch.sum) took 0.0265 ms alone
// there, 36% of the bound, and the wrapper two launches (PERF.md).
//
// Design: one cooperative launch that also sums dgamma and dbeta.
//   - Persistent grid: as many blocks of 8 warps as fit on the card at
//     once (the occupancy API); warp w of W walks rows w, w + W, ...
//   - Vector loads: lane l holds columns [VEC (32 j + l), + VEC) of chunk
//     j, VEC the largest count up to 16 bytes (8 bf16, 4 float32) that
//     divides D / 32; at 16 bytes a warp instruction moves 512 contiguous
//     bytes.
//   - Up to D / 32 = 16 values a lane (D <= 512), gamma sits in
//     registers for the whole launch and a row's
//     x_hat and dy stay in registers from its two warp-shuffle sums to
//     dx: every row is read once. Wider rows (D / 32 up to 64) read the
//     row and gamma again (from L1) for dx, as the first kernel did, so
//     that nothing spills.
//   - A lane keeps its columns' sums of dy x_hat and dy over the rows its
//     warp walks; the block adds its 8 warps' in warp order (shared
//     memory) into one row of partials [blocks, 2 D] in device memory.
//   - A grid-wide barrier (cooperative_groups), then every block adds
//     slices of 8 columns over the blocks' partials: 32 streams a slice,
//     stream i the partials i, i + 32, ... in order, then the streams in
//     order. No float atomics: every sum has a fixed order for a given
//     grid, so runs on one card are bitwise repeatable.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ---- the backward ----

constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kHoldMax = 16;       // values a lane holds to read a row once
constexpr int kSliceCols = 8;      // columns of a slice of the final sums
constexpr int kStreams = kBwdThreads / kSliceCols;

template <int BYTES>
struct RawOf;
template <>
struct RawOf<16> { using type = uint4; };
template <>
struct RawOf<8> { using type = uint2; };
template <>
struct RawOf<4> { using type = uint32_t; };
template <>
struct RawOf<2> { using type = uint16_t; };

// VEC elements of T as they lie in memory: one load of VEC sizeof(T)
// <= 16 bytes
template <typename T, int VEC>
using Raw = typename RawOf<VEC * static_cast<int>(sizeof(T))>::type;

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> load_raw(const T* p) {
  return *reinterpret_cast<const Raw<T, VEC>*>(p);
}

// bf16 in the lower or upper half of a 32-bit word, as float (exact)
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));   // to nearest even
}

// the 32-bit words of a raw vector (a bf16 pair each, or a float)
__device__ __forceinline__ void words(const uint4& v, uint32_t* w) {
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}
__device__ __forceinline__ void words(const uint2& v, uint32_t* w) {
  w[0] = v.x;
  w[1] = v.y;
}
__device__ __forceinline__ void words(const uint32_t& v, uint32_t* w) {
  w[0] = v;
}

// a raw vector of VEC elements of T as floats
template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Raw<T, VEC>& v, float* out) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && VEC == 1) {
    out[0] = __uint_as_float(static_cast<uint32_t>(v) << 16);
  } else {
    constexpr int kWords = VEC * static_cast<int>(sizeof(T)) / 4;
    uint32_t w[kWords];
    words(v, w);
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      if constexpr (std::is_same<T, float>::value) {
        out[i] = __uint_as_float(w[i]);
      } else {
        out[2 * i] = bf16_lo(w[i]);
        out[2 * i + 1] = bf16_hi(w[i]);
      }
    }
  }
}

// VEC elements of T at p (VEC sizeof(T)-byte aligned) as floats, in loads
// of at most 16 bytes
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  constexpr int kStep = VEC * sizeof(T) <= 16 ? VEC : 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < VEC; i += kStep) {
    unpack<T, kStep>(load_raw<T, kStep>(p + i), out + i);
  }
}

// VEC floats to T at p (VEC sizeof(T)-byte aligned)
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* x) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    } else if constexpr (VEC == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
    } else {
      *p = x[0];
    }
  } else if constexpr (VEC == 1) {
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(bf16_bits(x[0]));
  } else {
    uint32_t w[VEC / 2];
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      w[i] = bf16_bits(x[2 * i]) | (bf16_bits(x[2 * i + 1]) << 16);
    }
    if constexpr (VEC == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (VEC == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    }
  }
}

// VEC = elements a lane loads at once (D % (32 VEC) == 0); CH = chunks of
// 32 VEC columns a lane may have (D / (32 VEC) <= CH); a lane holds its
// row in registers when CH VEC <= kHoldMax
template <typename T, int VEC, int CH>
__global__ void __launch_bounds__(kBwdThreads)
layer_norm_residual_bwd_kernel(const T* __restrict__ residual,
                               const T* __restrict__ h,
                               const T* __restrict__ dy,
                               const float* __restrict__ gamma,
                               const float* __restrict__ mean_in,
                               const float* __restrict__ rstd_in,
                               T* __restrict__ dx,
                               float* __restrict__ part,  // [blocks, 2 d]
                               float* __restrict__ dgb,   // [2, d]
                               int64_t rows, int d) {
  constexpr bool kHold = CH * VEC <= kHoldMax;
  constexpr int kHeld = kHold ? CH : 1;
  __shared__ float red[2][kBwdWarps][32 * VEC];
  __shared__ float red_cols[kStreams][kSliceCols];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nch = d / (32 * VEC);
  const float df = static_cast<float>(d);

  float gam[kHeld][VEC];            // gamma of this lane's columns
  float pg[CH][VEC], pb[CH][VEC];   // sums over the warp's rows: dy x_hat, dy
#pragma unroll
  for (int j = 0; j < CH; ++j) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) pg[j][e] = pb[j][e] = 0.0f;
    if constexpr (kHold) {
      if (j < nch) load_vec<float, VEC>(gamma + (32 * j + lane) * VEC, gam[j]);
    }
  }

  const int64_t stride = static_cast<int64_t>(gridDim.x) * kBwdWarps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kBwdWarps + warp;
       row < rows; row += stride) {      // a whole warp walks together
    const int64_t at = row * d;
    const float mean = mean_in[row], rstd = rstd_in[row];
    float xh[kHeld][VEC], g[kHeld][VEC];
    float sum_a = 0.0f, sum_ax = 0.0f;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (j < nch) {
        const int c = (32 * j + lane) * VEC;
        float r[VEC], hv[VEC], gy[VEC], gm[VEC];
        load_vec<T, VEC>(residual + at + c, r);
        load_vec<T, VEC>(h + at + c, hv);
        load_vec<T, VEC>(dy + at + c, gy);
        if constexpr (kHold) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) gm[e] = gam[j][e];
        } else {
          load_vec<float, VEC>(gamma + c, gm);
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float x = (r[e] + hv[e] - mean) * rstd;
          const float a = gy[e] * gm[e];
          sum_a += a;
          sum_ax = fmaf(a, x, sum_ax);
          pg[j][e] = fmaf(gy[e], x, pg[j][e]);
          pb[j][e] += gy[e];
          if constexpr (kHold) {
            xh[j][e] = x;
            g[j][e] = gy[e];
          }
        }
      }
    }
    const float m1 = warp_sum(sum_a) / df;
    const float m2 = warp_sum(sum_ax) / df;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (j < nch) {
        const int c = (32 * j + lane) * VEC;
        float x[VEC], gy[VEC], gm[VEC], out[VEC];
        if constexpr (kHold) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            x[e] = xh[j][e];
            gy[e] = g[j][e];
            gm[e] = gam[j][e];
          }
        } else {
          float r[VEC], hv[VEC];
          load_vec<T, VEC>(residual + at + c, r);
          load_vec<T, VEC>(h + at + c, hv);
          load_vec<T, VEC>(dy + at + c, gy);
          load_vec<float, VEC>(gamma + c, gm);
#pragma unroll
          for (int e = 0; e < VEC; ++e) x[e] = (r[e] + hv[e] - mean) * rstd;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          out[e] = rstd * (gy[e] * gm[e] - m1 - x[e] * m2);
        }
        store_vec<T, VEC>(dx + at + c, out);
      }
    }
  }

  // the block's partials: its warps' sums added in warp order
  const int64_t part_at = static_cast<int64_t>(blockIdx.x) * 2 * d;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    if (j < nch) {                   // the same for every thread
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        red[0][warp][lane * VEC + e] = pg[j][e];
        red[1][warp][lane * VEC + e] = pb[j][e];
      }
      __syncthreads();
      for (int idx = tid; idx < 2 * 32 * VEC; idx += kBwdThreads) {
        const int which = idx / (32 * VEC), col = idx % (32 * VEC);
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kBwdWarps; ++w) sum += red[which][w][col];
        part[part_at + which * d + 32 * VEC * j + col] = sum;
      }
      __syncthreads();
    }
  }

  // every block's partials are written: sum them, 8 columns a slice
  cooperative_groups::this_grid().sync();
  const int col = tid % kSliceCols, stream = tid / kSliceCols;
  for (int s0 = blockIdx.x * kSliceCols; s0 < 2 * d;
       s0 += gridDim.x * kSliceCols) {
    float sum = 0.0f;
#pragma unroll 4
    for (int p = stream; p < static_cast<int>(gridDim.x); p += kStreams) {
      sum += __ldcg(part + static_cast<int64_t>(p) * 2 * d + s0 + col);
    }
    red_cols[stream][col] = sum;
    __syncthreads();
    if (tid < kSliceCols) {
      float total = 0.0f;
#pragma unroll
      for (int i = 0; i < kStreams; ++i) total += red_cols[i][tid];
      dgb[s0 + tid] = total;
    }
    __syncthreads();
  }
}

struct BwdArgs {
  const void *residual, *h, *dy;
  const float *gamma, *mean, *rstd;
  void* dx;
  float *part, *dgb;
  int64_t rows;
  int d;
  cudaStream_t stream;
};

// The grid of one instantiation: as many blocks as fit on the card at
// once (a cooperative launch needs them all resident), no more than the
// rows need, at least one. 0 if the card cannot be asked.
template <typename T, int VEC, int CH>
int bwd_grid(int64_t rows) {
  constexpr int kMaxDevices = 64;
  static int resident[kMaxDevices];   // blocks resident at once, by device
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, layer_norm_residual_bwd_kernel<T, VEC, CH>, kBwdThreads,
            0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      return 0;
    }
    resident[dev] = per_sm * sms;
  }
  const int64_t need = (rows + kBwdWarps - 1) / kBwdWarps;
  return static_cast<int>(
      need < 1 ? 1 : (need < resident[dev] ? need : resident[dev]));
}

template <typename T, int VEC, int CH>
int launch_bwd_v(const BwdArgs& a, int grid) {
  const T* residual = static_cast<const T*>(a.residual);
  const T* h = static_cast<const T*>(a.h);
  const T* dy = static_cast<const T*>(a.dy);
  const float *gamma = a.gamma, *mean = a.mean, *rstd = a.rstd;
  T* dx = static_cast<T*>(a.dx);
  float *part = a.part, *dgb = a.dgb;
  int64_t rows = a.rows;
  int d = a.d;
  void* args[] = {&residual, &h, &dy, &gamma, &mean, &rstd, &dx,
                  &part, &dgb, &rows, &d};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(
          layer_norm_residual_bwd_kernel<T, VEC, CH>),
      dim3(grid), dim3(kBwdThreads), args, 0, a.stream));
}

// launch (a != nullptr) or only size the grid: D / 32 = VEC x chunks, VEC
// the widest of 8 (bf16) or 4 (float32) that divides it; up to kHoldMax
// values a lane the row is held in registers. -> the grid, or the
// negated cudaError_t.
template <typename T>
int bwd_dispatch(int64_t rows, int d, const BwdArgs* a) {
  const int n = d / 32;
  const int vec = (sizeof(T) == 2 && n % 8 == 0) ? 8
                  : n % 4 == 0                     ? 4
                  : n % 2 == 0                     ? 2
                                                   : 1;
  const bool hold = n <= kHoldMax;
  int grid = 0, err = 0;
#define LN_BWD_CASE(VEC)                                                   \
  if (vec == VEC) {                                                        \
    if (hold) {                                                            \
      grid = bwd_grid<T, VEC, kHoldMax / VEC>(rows);                       \
      if (grid && a) err = launch_bwd_v<T, VEC, kHoldMax / VEC>(*a, grid); \
    } else {                                                               \
      grid = bwd_grid<T, VEC, 64 / VEC>(rows);                             \
      if (grid && a) err = launch_bwd_v<T, VEC, 64 / VEC>(*a, grid);       \
    }                                                                      \
  }
  if constexpr (sizeof(T) == 2) {
    LN_BWD_CASE(8)
  }
  LN_BWD_CASE(4)
  LN_BWD_CASE(2)
  LN_BWD_CASE(1)
#undef LN_BWD_CASE
  if (grid == 0) return -static_cast<int>(cudaErrorInvalidValue);
  return err ? -err : grid;
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
// type, mean, rstd [rows] float32 from the forward, and every buffer
// 16-byte aligned; dgb [2, d] float32 receives dgamma and dbeta; part is
// float32 scratch of at least layer_norm_residual_bwd_max_blocks(d, dtype)
// x 2 d. One cooperative launch, rows == 0 too (dgamma and dbeta are then
// zeros).

// the most blocks a backward launch for d and dtype has on the current
// device (or the negated cudaError_t)
int layer_norm_residual_bwd_max_blocks(int d, int dtype) {
  if (d % 32 != 0 || d < 32 || d > 2048 || (dtype != 0 && dtype != 1)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t all = INT64_MAX / 2;      // more rows than any grid takes
  return dtype == 0 ? bwd_dispatch<float>(all, d, nullptr)
                    : bwd_dispatch<__nv_bfloat16>(all, d, nullptr);
}

int layer_norm_residual_bwd_launch(const void* residual, const void* h,
                                   const void* dy, const float* gamma,
                                   const float* mean, const float* rstd,
                                   void* dx, float* part, float* dgb,
                                   int64_t rows, int d, int dtype,
                                   void* stream) {
  if (d % 32 != 0 || d < 32 || d > 2048 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdArgs a{residual, h, dy, gamma, mean, rstd, dx, part, dgb, rows, d,
                  static_cast<cudaStream_t>(stream)};
  const int grid = dtype == 0 ? bwd_dispatch<float>(rows, d, &a)
                              : bwd_dispatch<__nv_bfloat16>(rows, d, &a);
  return grid < 0 ? -grid : 0;
}

const char* layer_norm_residual_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
