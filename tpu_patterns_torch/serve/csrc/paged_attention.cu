// Fused paged attention over block tables, for Hopper (sm_90a).
//
// Replaces tpu_patterns/serve/paged_kernel.py::_paged_kernel (the Pallas
// kernel behind paged_block).  Computes, for every (row b, kv head h),
// the UNNORMALIZED online-softmax triple of the row's G*W query rows
// against the row's pool pages:
//   o [B, Hkv, G*W, D] f32, m / l [B, Hkv, G*W] f32.
// The normalize and the regroup to [B, W, H, D] stay in torch
// (serve/paged_kernel.py::paged_attend).
//
// What bounds it on this card: device-memory bytes.  Per (b, h) it reads
// each live page's K and V slots once (plus the int8 scales), the q rows
// and the table row, and writes o/m/l; the arithmetic is 4*G*W*D flops
// per visible key, far below the H100's ~20 flops/byte f32 ridge.
//
// Design (first version: right and simple):
//   * one thread block per (row, kv head); a loop over the row's pages
//     INSIDE the block takes the place of the TPU's sequential grid axis,
//     and the running max, normalizer and accumulator of the G*W query
//     rows live in shared memory across the loop;
//   * each live page is staged into shared memory once, converted to
//     f32 (bf16 and int8 dequantize in registers on the way);
//   * dead pages (TRASH block 0, inactive row, pages wholly in the
//     future of the row's last query) are skipped before any load;
//   * scalar f32 FMAs, warp-shuffle reductions; no wgmma, no TMA and no
//     split of one row's pages across blocks.
// At the serve slice's shape (B=8 rows, Hkv=8) this launches only 64
// blocks for 132 SMs: splitting pages across blocks (flash-decoding
// style, with a combine pass) is the first thing to change for speed.
//
// Masking and math follow the Pallas kernel: g-major row r is query
// w = r % W at global position pos0 + w; a key at page j slot c sits at
// j*block_len + c and is visible iff k_pos <= q_pos; masked scores are
// NEG_INF = -1e30; p = exp(s - m_cur) * (m_cur > NEG_INF/2); l sums the
// unscaled p; for int8 the k scale multiplies the score after the
// d^-0.5 scale and the v scale multiplies p after l is updated.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename QT, typename KT, int D, bool INT8>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(
    const QT* __restrict__ q,         // [B, W, H, D]
    const KT* __restrict__ k,         // [n_blocks, bl, Hkv, D]
    const KT* __restrict__ v,         // [n_blocks, bl, Hkv, D]
    const float* __restrict__ ks,     // [n_blocks, bl, Hkv] (int8 only)
    const float* __restrict__ vs,     // [n_blocks, bl, Hkv] (int8 only)
    const int32_t* __restrict__ tables,  // [B, n_pages]
    const int32_t* __restrict__ pos0,    // [B]
    const uint8_t* __restrict__ active,  // [B] (bool)
    float* __restrict__ o,            // [B, Hkv, GW, D]
    float* __restrict__ m_out,        // [B, Hkv, GW]
    float* __restrict__ l_out,        // [B, Hkv, GW]
    int W, int H, int Hkv, int n_blocks, int bl, int n_pages, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / Hkv;
  const int GW = G * W;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;               // [GW][D]
  float* acc = q_s + GW * D;       // [GW][D]
  float* k_s = acc + GW * D;       // [bl][D]
  float* v_s = k_s + bl * D;       // [bl][D]
  float* s_s = v_s + bl * D;       // [GW][bl] scores, then probabilities
  float* m_s = s_s + GW * bl;      // [GW]
  float* l_s = m_s + GW;           // [GW]
  float* a_s = l_s + GW;           // [GW] this page's rescale factor
  float* sc_s = a_s + GW;          // [2][bl] k and v scales (int8)

  // q rows g-major: row r = g*W + w reads q[b, w, h*G + g, :]
  for (int i = tid; i < GW * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int g = r / W, w = r % W;
    q_s[i] = to_f32(q[((static_cast<size_t>(b) * W + w) * H + h * G + g) * D + d]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < GW; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int p0 = pos0[b];
  const bool act = active[b] != 0;
  for (int j = 0; j < n_pages; ++j) {
    int tab = tables[static_cast<size_t>(b) * n_pages + j];
    tab = min(max(tab, 0), n_blocks - 1);
    const int k_first = j * bl;
    // the same value in every thread: the whole block skips together
    if (tab == 0 || !act || k_first > p0 + W - 1) continue;

    for (int i = tid; i < bl * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const size_t off =
          ((static_cast<size_t>(tab) * bl + c) * Hkv + h) * D + d;
      k_s[i] = to_f32(k[off]);
      v_s[i] = to_f32(v[off]);
    }
    if (INT8) {
      for (int c = tid; c < bl; c += THREADS) {
        const size_t off = (static_cast<size_t>(tab) * bl + c) * Hkv + h;
        sc_s[c] = ks[off];
        sc_s[bl + c] = vs[off];
      }
    }
    __syncthreads();

    // scores: one warp per (row, slot) pair, lanes split D
    for (int pr = warp; pr < GW * bl; pr += WARPS) {
      const int r = pr / bl, c = pr % bl;
      float part = 0.f;
#pragma unroll
      for (int d = lane; d < D; d += 32)
        part = fmaf(q_s[r * D + d], k_s[c * D + d], part);
      float s = warp_sum(part) * scale;
      if (INT8) s *= sc_s[c];
      const int q_pos = p0 + r % W;
      const int k_pos = k_first + c;
      if (lane == 0) s_s[pr] = (k_pos <= q_pos) ? s : NEG_INF;
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int r = warp; r < GW; r += WARPS) {
      float mx = NEG_INF;
      for (int c = lane; c < bl; c += 32) mx = fmaxf(mx, s_s[r * bl + c]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, mx);
      // rows with nothing unmasked yet keep exp() exactly 0
      const float keep = (m_cur > NEG_INF * 0.5f) ? 1.f : 0.f;
      float sum = 0.f;
      for (int c = lane; c < bl; c += 32) {
        float p = expf(s_s[r * bl + c] - m_cur) * keep;
        sum += p;
        if (INT8) p *= sc_s[bl + c];
        s_s[r * bl + c] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_cur;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P @ V
    for (int i = tid; i < GW * D; i += THREADS) {
      const int r = i / D, d = i % D;
      float pv = 0.f;
      for (int c = 0; c < bl; ++c) pv = fmaf(s_s[r * bl + c], v_s[c * D + d], pv);
      acc[i] = a_s[r] * acc[i] + pv;
    }
    __syncthreads();
  }

  const size_t row0 = (static_cast<size_t>(b) * Hkv + h) * GW;
  for (int i = tid; i < GW * D; i += THREADS) o[row0 * D + i] = acc[i];
  for (int r = tid; r < GW; r += THREADS) {
    m_out[row0 + r] = m_s[r];
    l_out[row0 + r] = l_s[r];
  }
}

template <typename QT, typename KT, int D, bool INT8>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int32_t* tables, const int32_t* pos0,
           const uint8_t* active, float* o, float* m, float* l, int B, int W,
           int H, int Hkv, int n_blocks, int bl, int n_pages, float scale,
           size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<QT, KT, D, INT8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch reports its own
      return static_cast<int>(e);
    }
  }
  dim3 grid(Hkv, B);
  paged_attention_kernel<QT, KT, D, INT8><<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), ks, vs, tables, pos0, active, o, m, l, W, H,
      Hkv, n_blocks, bl, n_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT, bool INT8>
int launch_d(int D, const void* q, const void* k, const void* v,
             const float* ks, const float* vs, const int32_t* tables,
             const int32_t* pos0, const uint8_t* active, float* o, float* m,
             float* l, int B, int W, int H, int Hkv, int n_blocks, int bl,
             int n_pages, float scale, size_t smem, cudaStream_t stream) {
#define PAGED_CASE(DV)                                                     \
  case DV:                                                                 \
    return launch<QT, KT, DV, INT8>(q, k, v, ks, vs, tables, pos0, active, \
                                    o, m, l, B, W, H, Hkv, n_blocks, bl,   \
                                    n_pages, scale, smem, stream);
  switch (D) {
    PAGED_CASE(32)
    PAGED_CASE(64)
    PAGED_CASE(128)
    PAGED_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PAGED_CASE
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for one launch, in bytes.
size_t paged_attention_smem_bytes(int GW, int D, int bl) {
  return sizeof(float) *
         (static_cast<size_t>(2) * GW * D + 2 * bl * D + GW * bl + 3 * GW +
          2 * bl);
}

// q_kind: 0 float32, 1 bfloat16.  kv_kind: 0 float32, 1 bfloat16,
// 2 int8 with float32 per-slot scales ks/vs.  Launches on ``stream`` and
// returns cudaGetLastError() (0 on success); never synchronizes.
int paged_attention(int q_kind, int kv_kind, const void* q, const void* k,
                    const void* v, const float* ks, const float* vs,
                    const int32_t* tables, const int32_t* pos0,
                    const uint8_t* active, float* o, float* m, float* l,
                    int B, int W, int H, int Hkv, int D, int n_blocks, int bl,
                    int n_pages, float scale, void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  const size_t smem = paged_attention_smem_bytes((H / Hkv) * W, D, bl);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_kind == 0 && kv_kind == 0)
    return launch_d<float, float, false>(D, q, k, v, ks, vs, tables, pos0,
                                         active, o, m, l, B, W, H, Hkv,
                                         n_blocks, bl, n_pages, scale, smem,
                                         st);
  if (q_kind == 1 && kv_kind == 1)
    return launch_d<__nv_bfloat16, __nv_bfloat16, false>(
        D, q, k, v, ks, vs, tables, pos0, active, o, m, l, B, W, H, Hkv,
        n_blocks, bl, n_pages, scale, smem, st);
  if (q_kind == 0 && kv_kind == 2)
    return launch_d<float, int8_t, true>(D, q, k, v, ks, vs, tables, pos0,
                                         active, o, m, l, B, W, H, Hkv,
                                         n_blocks, bl, n_pages, scale, smem,
                                         st);
  if (q_kind == 1 && kv_kind == 2)
    return launch_d<__nv_bfloat16, int8_t, true>(
        D, q, k, v, ks, vs, tables, pos0, active, o, m, l, B, W, H, Hkv,
        n_blocks, bl, n_pages, scale, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
