// CIF fire (continuous integrate-and-fire) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel _cif_kernel of tpu_asr/ops/pallas/cif.py, reached
// through _cif_fire_pallas_fwd (cif_fire_pallas). For utterance b, with
// c = cumsum(alpha) (made by the caller in torch, as the reference makes
// it), c_prev = c - alpha (one float subtraction, here: bitwise what
// torch's c - alphas gives) and encoder states h [B, T, D] float32:
//
//   w[t, u]  = max(min(c[t], u + 1) - max(c_prev[t], u), 0)
//   fired[u] = sum_t w[t, u] * h[t, :]          -> out [B, U, D] float32
//
// W [B, T, U] is never stored. The overlap is the TPU kernel's three
// operations (cif.py:41-43), so given the same c every weight is bitwise
// that of the plain version (tpu_asr_torch/ops/cif.py); only the order of
// the sum over t differs (here: increasing t, one fma each, frames whose
// weight is 0 skipped).
//
// Work: a frame's weight is non-zero only for the outputs its interval
// [c_prev, c] overlaps, so each output reads a short run of frames and the
// whole call is O(B (T + U) D), not the dense O(B T U D) of the product.
//
// What bounds it on this card: bytes. At the path's shape (B = 32, T = 249,
// D = 512, U = 25) it must read h once (16.3 MB), c and alpha (64 KB)
// and write the output (1.6 MB): ~5.4 us at 3.35 TB/s. The arithmetic, one
// fma per (non-zero weight, column), is ~2 flops per byte of h, far below
// the float32 ridge. The served shapes (B = 8, T' = 126 or 248, U = 100)
// are 1.1-1.7 us of bytes, near a launch's own latency: there the count of
// dependent memory round trips a block makes is what the time is.
//
// Design: one block per (utterance b, group of kOutputs outputs, slab of
// columns), one warp per output u, the lanes over D with 16-byte loads
// (D = 512 is one slab: four float4 a lane). A block pays one round trip
// for c and alpha and one for each batch of kFrames frames of h:
// 1. The block stages the utterance's c and c_prev into shared memory
//    (kChunk frames at a time; one chunk up to T = 2048).
// 2. Each warp finds its output's first and last frame in the chunk by
//    its own scan with ballots, no block barrier: frame t can weigh on u
//    only if c_prev[t] < c[t] and floor(c_prev[t]) <= u <= ceil(c[t]) - 1
//    (may_weigh). The rule
//    comes from each frame's own (c_prev, c): c_prev = c - alpha is not
//    monotone to the last ulp, so a frame outside the expected run can
//    carry a weight of ~1e-7 that the dense formula counts, and a search
//    that assumed order could miss it.
// 3. It walks that range in increasing t, kFrames frames at a time: the
//    weights first (from shared memory), then every 16-byte load of h
//    those frames need (frames of weight 0 load nothing), then the fmas
//    in order. An output past the last fire, a zero-length row (all
//    alphas 0) and an empty range write zeros.
// No atomics and a fixed order: runs repeat bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOutputs = 8;      // outputs (warps) a block
constexpr int kVecs = 4;         // loads a lane a frame: a slab is 32 kVecs V
constexpr int kFrames = 8;       // frames whose loads of h are in flight
constexpr int kChunk = 2048;     // frames of c and c_prev staged at once

__device__ __forceinline__ float overlap(float c_prev, float c, float u) {
  const float lo = fmaxf(c_prev, u);
  const float hi = fminf(c, u + 1.0f);
  return fmaxf(hi - lo, 0.0f);
}

// overlap(c_prev, c, u) != 0 implies this: min(c, u + 1) > max(c_prev, u)
// gives c > c_prev, c > u, so u <= ceil(c) - 1, and u + 1 > c_prev, so u >=
// floor(c_prev) (floorf, ceilf and u + 1 are exact here). c > c_prev drops
// the frames of alpha 0, such as a row's padding, which would otherwise
// all fall to output floor(c) when a row's total is not a whole number.
__device__ __forceinline__ bool may_weigh(float c_prev, float c, float u) {
  return c_prev < c && floorf(c_prev) <= u && u <= ceilf(c) - 1.0f;
}

template <int V> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T fma(float w, T h, T acc) {
    return make_float4(fmaf(w, h.x, acc.x), fmaf(w, h.y, acc.y),
                       fmaf(w, h.z, acc.z), fmaf(w, h.w, acc.w));
  }
};
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T fma(float w, T h, T acc) {
    return fmaf(w, h, acc);
  }
};

// V floats a load: 4 (float4) when D is a multiple of 4 and h and out
// start on 16-byte boundaries, else 1.
template <int V>
__global__ void cif_fire_kernel(
    const float* __restrict__ c,        // [B, T]
    const float* __restrict__ alpha,    // [B, T]
    const float* __restrict__ hidden,   // [B, T, D]
    float* __restrict__ out,            // [B, U, D]
    int t_total, int u_total, int d_total) {
  using VecT = typename Vec<V>::T;
  __shared__ float s_c[kChunk], s_cp[kChunk];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * kOutputs + (threadIdx.x >> 5);
  const bool live = u < u_total;
  const float uf = static_cast<float>(u);
  const int d0 = blockIdx.z * 32 * kVecs * V + lane * V;   // + 32 V k
  const float* cc = c + static_cast<int64_t>(b) * t_total;
  const float* al = alpha + static_cast<int64_t>(b) * t_total;
  const float* h = hidden + static_cast<int64_t>(b) * t_total * d_total;
  VecT acc[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) acc[k] = VecT{};

  for (int t0 = 0; t0 < t_total; t0 += kChunk) {
    const int n = t_total - t0 < kChunk ? t_total - t0 : kChunk;
    if (t0 > 0) __syncthreads();             // every warp is done with it
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float ci = cc[t0 + i];
      s_c[i] = ci;
      s_cp[i] = ci - al[t0 + i];
    }
    __syncthreads();
    if (!live) continue;

    // 1. the first and last frame of the chunk that may weigh on u
    int lo = n, hi = -1;
    for (int w0 = 0; w0 < n; w0 += 32) {
      const int i = w0 + lane;
      const unsigned m = __ballot_sync(
          0xffffffffu, i < n && may_weigh(s_cp[i], s_c[i], uf));
      if (m) {
        lo = lo < n ? lo : w0 + __ffs(m) - 1;
        hi = w0 + 31 - __clz(m);
      }
    }

    // 2. sum over that range in increasing t, kFrames frames at a time
    for (int f0 = lo; f0 <= hi; f0 += kFrames) {
      float w[kFrames];
      VecT x[kFrames][kVecs];
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        const int i = f0 + f <= hi ? f0 + f : hi;
        w[f] = f0 + f <= hi ? overlap(s_cp[i], s_c[i], uf) : 0.0f;
        const VecT* row = reinterpret_cast<const VecT*>(
            h + static_cast<int64_t>(t0 + i) * d_total + d0);
#pragma unroll
        for (int k = 0; k < kVecs; ++k)
          if (w[f] != 0.0f && d0 + 32 * V * k < d_total)
            x[f][k] = row[32 * k];
      }
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        if (w[f] == 0.0f) continue;
#pragma unroll
        for (int k = 0; k < kVecs; ++k)
          acc[k] = Vec<V>::fma(w[f], x[f][k], acc[k]);
      }
    }
  }
  if (!live) return;
  VecT* o = reinterpret_cast<VecT*>(
      out + (static_cast<int64_t>(b) * u_total + u) * d_total + d0);
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
    if (d0 + 32 * V * k < d_total) o[32 * k] = acc[k];
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// Launches on `stream` (PyTorch's current stream) without synchronising
// and returns the cudaError_t of the launch (0 = cudaSuccess). The caller
// guarantees contiguous buffers and b <= 65535 (the grid's y extent).

int cif_fire_launch(const float* c, const float* alpha, const float* hidden,
                    float* out, int b, int t_total, int u_total, int d_total,
                    void* stream) {
  if (b == 0 || u_total == 0 || d_total == 0) return 0;
  const bool vec4 = d_total % 4 == 0 && aligned16(hidden) && aligned16(out);
  const int slab = 32 * kVecs * (vec4 ? 4 : 1);
  const dim3 grid((u_total + kOutputs - 1) / kOutputs, b,
                  (d_total + slab - 1) / slab);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4)
    cif_fire_kernel<4><<<grid, 32 * kOutputs, 0, s>>>(
        c, alpha, hidden, out, t_total, u_total, d_total);
  else
    cif_fire_kernel<1><<<grid, 32 * kOutputs, 0, s>>>(
        c, alpha, hidden, out, t_total, u_total, d_total);
  return static_cast<int>(cudaGetLastError());
}

const char* cif_fire_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
