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
// the sum over t differs (here: increasing t, one fma each).
//
// Work: a frame's weight is non-zero only for the outputs its interval
// [c_prev, c] overlaps, so each output reads a short run of frames and the
// whole call is O(B (T + U) D), not the dense O(B T U D) of the product.
//
// What bounds it on this card: bytes. At the path's shape (B = 32, T = 249,
// D = 512, U = 25) it must read h once (16.3 MB), c and alpha (64 KB)
// and write the output (1.6 MB): ~5.4 us at 3.35 TB/s. The arithmetic, one
// fma per (non-zero weight, column), is ~2 flops per byte of h, far below
// the float32 ridge.
//
// Design: one thread block per (output u, utterance b, chunk of <= 256
// columns of D); a thread owns one column and keeps its sum in a register.
// The block first scans ALL T frames for the first and last frame with a
// non-zero weight for u (a strided scan plus a min/max reduction): c_prev =
// c - alpha is not monotone to the last ulp, so a frame outside the
// expected run can carry a weight of ~1e-7 that the dense formula counts,
// and a binary search could miss it. Then it walks that range in
// increasing t, skips frames whose weight is 0 (a test uniform across the
// block: no divergence), and reads h[t, :] coalesced for the others. An
// output past the last fire, a zero-length row (all alphas 0) and an empty
// range write zeros. c and alpha are read by every thread of the block at
// the same address (a broadcast, cached in L1). Measured on an H100, the
// kernel alone takes ~1.7x its byte bound at the path's shape (PERF.md).
// Tensor cores, TMA and several outputs per block are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float overlap(float c_prev, float c, float u) {
  const float lo = fmaxf(c_prev, u);
  const float hi = fminf(c, u + 1.0f);
  return fmaxf(hi - lo, 0.0f);
}

__device__ __forceinline__ int warp_min(int x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__global__ void cif_fire_kernel(const float* __restrict__ c,       // [B, T]
                                const float* __restrict__ alpha,   // [B, T]
                                const float* __restrict__ hidden,  // [B, T, D]
                                float* __restrict__ out,           // [B, U, D]
                                int t_total, int u_total, int d_total) {
  const int u = blockIdx.x;
  const int b = blockIdx.y;
  const int d = blockIdx.z * blockDim.x + threadIdx.x;
  const float* cc = c + static_cast<int64_t>(b) * t_total;
  const float* al = alpha + static_cast<int64_t>(b) * t_total;
  const float uf = static_cast<float>(u);
  auto weight = [&](int t) { return overlap(cc[t] - al[t], cc[t], uf); };

  // 1. the first and last frame with a non-zero weight for u, over all T
  int lo = t_total, hi = -1;
  for (int t = threadIdx.x; t < t_total; t += blockDim.x) {
    if (weight(t) != 0.0f) {
      lo = min(lo, t);
      hi = max(hi, t);
    }
  }
  __shared__ int s_lo[kMaxThreads / 32], s_hi[kMaxThreads / 32];
  __shared__ int s_range[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  lo = warp_min(lo);
  hi = warp_max(hi);
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    lo = warp_min(lane < n_warps ? s_lo[lane] : t_total);
    hi = warp_max(lane < n_warps ? s_hi[lane] : -1);
    if (lane == 0) {
      s_range[0] = lo;
      s_range[1] = hi;
    }
  }
  __syncthreads();
  lo = s_range[0];
  hi = s_range[1];
  if (d >= d_total) return;

  // 2. fired[u, d] = sum over that range of w[t, u] * h[t, d], increasing t
  const float* h = hidden + static_cast<int64_t>(b) * t_total * d_total + d;
  float acc = 0.0f;
  for (int t = lo; t <= hi; ++t) {
    const float w = weight(t);
    if (w != 0.0f) acc = fmaf(w, h[static_cast<int64_t>(t) * d_total], acc);
  }
  out[(static_cast<int64_t>(b) * u_total + u) * d_total + d] = acc;
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
  const int rounded = (d_total + 31) / 32 * 32;
  const int threads = rounded < kMaxThreads ? rounded : kMaxThreads;
  const dim3 grid(u_total, b, (d_total + threads - 1) / threads);
  cif_fire_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      c, alpha, hidden, out, t_total, u_total, d_total);
  return static_cast<int>(cudaGetLastError());
}

const char* cif_fire_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
