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
// What bounds it on this card: bytes. One head of one utterance does
// 4 dh Tq Tk flops on 2 dh (Tq + Tk) values of q, k, v and out, so
// Tq Tk / (Tq + Tk) flops a bf16 byte: <= 124 at the served T' <= 248,
// below the bf16 tensor-core ridge (~295 flops a byte). The first kernel
// (one thread a query row, float32 fmaf chains on the SIMT units, K/V
// converted to float32 by synchronous loads) ran at 23-36x that bound:
// 0.61 ms alone at the served decoder cross-attention ([80, 101] x
// [80, 248], bf16; PERF.md), latency-bound.
//
// bf16: flash_attention_fwd_wgmma_kernel. One warpgroup (128 threads) a
// block owns 64 query rows of one head of one utterance and walks key
// tiles of 64:
//   - Q, K and V tiles arrive by TMA (tensor maps over the strided
//     [B, T, H, dh] layout; flash_sm90.cuh) into 128-byte swizzled shared
//     memory (64-byte for dh 32); K/V go through a two-stage ring, so the
//     next tile loads while this one is computed;
//   - S = Q K^T by wgmma m64n64k16 (A = Q, B = K, both K-major as they lie
//     in memory), float32 accumulators in registers: s is the float32 dot
//     of the bf16 values, then the scale;
//   - the masks, the running max (a row's 64 entries sit on the 4 lanes of
//     a quad: two shuffles), the correction and p on the accumulator
//     fragment; l sums the unrounded p in float32;
//   - O += P V by wgmma with A = P from registers: the S fragment packed to
//     bf16 pairs is both the A fragment and the rounding of p the contract
//     asks for; B = V, MN-major (the transpose bit);
//   - key tiles that the padding masks wholly (a block-wide vote on the
//     tile's kv_valid bytes) and, under causal, tiles past the block's
//     last row are never loaded: their p is exactly 0, so skipping them
//     changes no bit.
// Shared memory: 5 tiles (Q, K and V twice) of 64 x dh bf16, 20-80 KB.
// TMA's per-call cost is three tensor maps encoded on the host
// (cuTensorMapEncodeTiled, looked up through the CUDA runtime). The
// scores' float32 sums run in the tensor core's order, which differs
// from the SIMT kernels' in the last bits; the bf16 dq kernel of
// flash_attention_bwd.cu issues the same instructions in the same k-step
// order, so its scores are these, bit for bit.
//
// float32: flash_attention_fwd_simt_kernel, the first kernel unchanged.
// wgmma has no full-float32 product, and TF32 (10-bit mantissa) would
// break the float32 tolerance (1e-5); the float32 models (cif_dev,
// hybrid_dev) run this kernel. Its design: one block of 64 threads per
// (tile of 64 query rows, head, utterance); thread t owns query row q0 + t:
// its q row and its float32 accumulator live in registers, and so do its
// running max and sum. Key/value tiles of 32 rows are converted to float32
// in shared memory; every thread of the block reads the same key at once
// (a broadcast, no bank conflict). Per tile a row computes its 32 scores
// into its own column of a shared tile, then the TPU kernel's update
// (m_new, the correction of l and acc, p, l, acc += p V). The dot keeps
// four partial sums. With the causal flag, key tiles wholly above the
// block's last query row are skipped.

#include "flash_sm90.cuh"

namespace {

constexpr int kBQ = 64;          // SIMT: query rows per block, one a thread
constexpr int kBK = 32;          // SIMT: keys per shared-memory tile
constexpr float kNegInf = -1e30f;
constexpr float kHalfNegInf = -5e29f;

__device__ __forceinline__ float to_float(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

struct Strides {      // in elements; the head dimension is contiguous
  int64_t b, t, h;
};

// ---- float32: the SIMT kernel ----

template <typename T, int DH>
__global__ void __launch_bounds__(kBQ)
flash_attention_fwd_simt_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const uint8_t* __restrict__ kv_valid,
                                T* __restrict__ out,      // [B, Tq, H, DH]
                                float* __restrict__ lse,  // [B, H, Tq]
                                int tq, int tk, int heads, Strides qs,
                                Strides ks, Strides vs, float scale,
                                int causal) {
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

// ---- bf16: the wgmma kernel ----

constexpr int kWarpgroup = 128;

template <int DH>
__global__ void __launch_bounds__(kWarpgroup)
flash_attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 const uint8_t* __restrict__ kv_valid,
                                 __nv_bfloat16* __restrict__ out,
                                 float* __restrict__ lse, int tq, int tk,
                                 int heads, float scale, int causal) {
  using namespace flash_sm90;
  using G = Tile<DH>;
  constexpr int kCols = G::kPanelCols;          // output columns a panel
  extern __shared__ uint8_t smem_raw[];
  // [Q][K0][V0][K1][V1] from a 1024-byte boundary, then 2 mbarriers and
  // the key masks of the two stages (2 words each)
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* tail = smem_raw + (base - raw) + 5 * G::kBytes;
  const uint32_t bar = smem_u32(tail);          // bar + 8 s: stage s
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(tail + 16);
  const uint32_t q_s = base;
  auto k_s = [&](int s) { return base + (1 + 2 * s) * G::kBytes; };
  auto v_s = [&](int s) { return base + (2 + 2 * s) * G::kBytes; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int row0 = q0 + 16 * warp + lane / 4, row1 = row0 + 8;
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

  float o[G::kPanels][kCols / 2];
#pragma unroll
  for (int p = 0; p < G::kPanels; ++p) {
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) o[p][i] = 0.0f;
  }
  float m[2] = {kNegInf, kNegInf};   // running max of rows row0, row1
  float l[2] = {0.0f, 0.0f};         // this thread's part of their sums

  int cur = find_live(0, 0);
  if (cur < n_tiles && tid == 0) {
    mbar_expect_tx(bar, 3 * G::kBytes);
    load_tile<DH>(&q_map, q_s, bar, q0, h, b);
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

    // S = Q K^T: float32 dots of the bf16 values
    float s[32];
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wgmma_ss_n64(s, desc_k<DH>(q_s, kk), desc_k<DH>(k_s(stage), kk),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // the scale, the masks and the TPU kernel's online-softmax update
    const uint32_t words[2] = {mask_s[2 * stage], mask_s[2 * stage + 1]};
    const int k0 = cur * kRows;
    float tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = frag_col(i, lane), r = frag_row(i);   // c / 32 = i / 16
      const bool ok = ((words[i / 16] >> (c % 32)) & 1u) &&
                      (!causal || k0 + c <= (r ? row1 : row0));
      s[i] = ok ? s[i] * scale : kNegInf;
      tile_max[r] = fmaxf(tile_max[r], s[i]);
    }
    float m_safe[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu,
                                                       tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu,
                                                       tile_max[r], 2));
      const float m_new = fmaxf(m[r], tile_max[r]);
      m_safe[r] = fmaxf(m_new, kHalfNegInf);
      corr[r] = m[r] <= kHalfNegInf ? 0.0f
                                    : expf(fmaxf(m[r], kHalfNegInf) - m_safe[r]);
      l[r] *= corr[r];
      m[r] = m_new;
    }
#pragma unroll
    for (int p = 0; p < G::kPanels; ++p) {
#pragma unroll
      for (int i = 0; i < kCols / 2; ++i) o[p][i] *= corr[frag_row(i)];
    }
    uint32_t pa[4][4];               // T(p) as the A fragments of P V
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = frag_row(i);
      s[i] = s[i] <= kHalfNegInf ? 0.0f : expf(s[i] - m_safe[r]);
      l[r] += s[i];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
      }
    }

    // O += T(P) V, one product a panel of V's columns
#pragma unroll
    for (int p = 0; p < G::kPanels; ++p) fence_regs(o[p]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < G::kPanels; ++p) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<kCols>(o[p], pa[kk], desc_mn<DH>(v_s(stage), p, kk), 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < G::kPanels; ++p) fence_regs(o[p]);
    cur = nxt;
    stage ^= 1;
  }

  float lc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    lc[r] = fmaxf(l[r], 1e-30f);
  }
  const int rows[2] = {row0, row1};
#pragma unroll
  for (int p = 0; p < G::kPanels; ++p) {
#pragma unroll
    for (int i = 0; i < kCols / 2; i += 2) {
      const int r = frag_row(i), row = rows[r];
      if (row < tq) {
        const int col = p * kCols + frag_col(i, lane);
        *reinterpret_cast<__nv_bfloat162*>(
            out + (static_cast<int64_t>(b) * tq + row) * heads * DH +
            static_cast<int64_t>(h) * DH + col) =
            __floats2bfloat162_rn(o[p][i] / lc[r], o[p][i + 1] / lc[r]);
      }
    }
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] < tq) {
        lse[(static_cast<int64_t>(b) * heads + h) * tq + rows[r]] =
            m[r] <= kHalfNegInf ? kNegInf : m[r] + logf(lc[r]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const uint8_t* kv_valid;
  void* out;
  float* lse;
  int b, tq, tk, heads;
  Strides qs, ks, vs;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int DH>
int launch_simt(const Args& a) {
  const dim3 grid((a.tq + kBQ - 1) / kBQ, a.heads, a.b);
  flash_attention_fwd_simt_kernel<float, DH><<<grid, kBQ, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.kv_valid, static_cast<float*>(a.out),
      a.lse, a.tq, a.tk, a.heads, a.qs, a.ks, a.vs, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_wgmma(const Args& a) {
  using G = flash_sm90::Tile<DH>;
  CUtensorMap maps[3];
  const void* ptrs[3] = {a.q, a.k, a.v};
  const Strides st[3] = {a.qs, a.ks, a.vs};
  for (int i = 0; i < 3; ++i) {
    const int err = flash_sm90::encode_tile_map<DH>(
        &maps[i], ptrs[i], a.b, i == 0 ? a.tq : a.tk, a.heads, st[i].b,
        st[i].t, st[i].h);
    if (err) return err;
  }
  const size_t smem = 5 * G::kBytes + 1024 + 64;
  auto kernel = flash_attention_fwd_wgmma_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.tq + flash_sm90::kRows - 1) / flash_sm90::kRows, a.heads,
                  a.b);
  kernel<<<grid, kWarpgroup, smem, a.stream>>>(
      maps[0], maps[1], maps[2], a.kv_valid,
      static_cast<__nv_bfloat16*>(a.out), a.lse, a.tq, a.tk, a.heads,
      a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0 (float32) takes the SIMT kernel, 1 (bf16) the wgmma kernel
int launch(const void* q, const void* k, const void* v,
           const uint8_t* kv_valid, void* out, float* lse, int b, int tq,
           int tk, int heads, int dh, const int64_t* st, float scale,
           int causal, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || tq == 0 || heads == 0) return 0;
  const Args a{q, k, v, kv_valid, out, lse, b, tq, tk, heads,
               Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
               Strides{st[6], st[7], st[8]}, scale, causal,
               static_cast<cudaStream_t>(stream)};
  switch (dh) {
    case 32:
      return dtype ? launch_wgmma<32>(a) : launch_simt<32>(a);
    case 64:
      return dtype ? launch_wgmma<64>(a) : launch_simt<64>(a);
    case 128:
      return dtype ? launch_wgmma<128>(a) : launch_simt<128>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (PyTorch's current stream) without synchronising
// and returns 0, the cudaError_t of the launch, cudaErrorInvalidValue for an
// unsupported dtype or head size, or (wgmma) 1000 + the CUresult of a
// refused tensor map. dtype: 0 = float32 (the SIMT kernel), 1 = bfloat16
// (the wgmma kernel); dh in {32, 64, 128}. q [B, Tq, H, dh] and k, v
// [B, Tk, H, dh] are given by their batch, time and head strides in
// elements, strides = {q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h} (the
// head dimension contiguous; in bf16 every stride a multiple of 16 bytes
// and every base 16-byte aligned, as TMA reads them); kv_valid [B, Tk] one
// byte each (non-zero = valid); out [B, Tq, H, dh] and lse [B, H, Tq]
// float32 are contiguous. The caller guarantees b and heads <= 65535.

int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               const uint8_t* kv_valid, void* out, float* lse,
                               int b, int tq, int tk, int heads, int dh,
                               const int64_t* strides, float scale,
                               int causal, int dtype, void* stream) {
  return launch(q, k, v, kv_valid, out, lse, b, tq, tk, heads, dh, strides,
                scale, causal, dtype, stream);
}

const char* flash_attention_error_string(int code) {
  return flash_sm90::error_string(code);
}

}  // extern "C"
