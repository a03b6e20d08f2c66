// Staging rows of device memory into shared memory with cp.async, for
// the CTC kernels whose step chains read shared memory only
// (ctc_prefix_scan.cu, ctc_loss.cu). sm_80 and later.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Where n floats copied from src start in their shared slot: src's offset
// in floats past a 16-byte boundary, so that slot + lead and src share
// their alignment.
__device__ __forceinline__ int stage_lead(const float* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

// Issue cp.async copies of the n floats at src into slot + stage_lead(src)
// by `lanes` threads (this one is `lane`): 4-byte copies up to src's next
// 16-byte boundary and after its last, 16-byte copies in between. slot is
// 16-byte aligned and holds n + 3 floats.
__device__ __forceinline__ void stage_floats_async(float* slot,
                                                   const float* src, int n,
                                                   int lane, int lanes) {
  const int lead = stage_lead(src);
  float* dst = slot + lead;
  const int head = min((4 - lead) & 3, n);
  const int body = (n - head) >> 2;
  for (int i = lane; i < head; i += lanes) cp_async4(dst + i, src + i);
  for (int i = lane; i < body; i += lanes)
    cp_async16(dst + head + 4 * i, src + head + 4 * i);
  for (int i = head + 4 * body + lane; i < n; i += lanes)
    cp_async4(dst + i, src + i);
}

}  // namespace
