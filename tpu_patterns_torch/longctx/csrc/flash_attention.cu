// Fused flash-attention forward for Hopper (sm_90a): K2 and K3.
//
// Replaces, in tpu_patterns/longctx/flash.py,
//   * flash_block's _block_kernel (:591) and _block_kernel_compact (:639)
//     -- K3: emits the unnormalized (o f32 [Lq, H, D], m, l f32 [H, Lq]);
//   * flash_attention's _kernel (:135) and _kernel_compact (:840)
//     -- K2: normalizes (o / l, l == 0 -> 1) and casts to q's dtype.
// One kernel with a runtime epilogue switch (emit_stats) gives both.
//
// What bounds it on this card: operations.  Per (head, q-tile) it reads
// q once and each visible k/v tile once, and does 4*D flops per visible
// (query, key) pair; at D = 128 in bf16 that is far above the H100's
// ~295 flops/byte ridge, so the tensor-core rate is the bound.
//
// Design (first version: right and simple):
//   * one thread block (8 warps) per (q-tile, head); a loop over the
//     k-tiles INSIDE the block takes the place of the TPU's sequential
//     grid axis, and m / l / acc of the q-tile live in shared memory
//     across it;
//   * causal: the loop stops at the first k-tile wholly above the
//     diagonal (by global position: q_off + (row0 + bq - 1) * stride <
//     k_off + col0 * stride), before its k/v are loaded.  Later tiles
//     are masked too (positions grow with the tile index), so every
//     block visits exactly its live tiles: the dense and the compact
//     grid of the reference are one launch here, bit-identical;
//   * per k-tile: stage k, v; S = Q K^T (tensor cores for bf16, scalar
//     f32 for f32); one warp per row applies scale, mask and the online
//     softmax; P is rounded to the input dtype (the Pallas kernel's
//     p.astype(v.dtype)) and acc = alpha * acc + P V;
//   * synchronous 16-byte loads, no cp.async, TMA or wgmma: those, and
//     keeping S and acc in registers, are the next steps for speed.
//
// Math as the Pallas _online_step: s = (q . k) * scale, masked to
// NEG_INF = -1e30 where q_pos < k_pos; m_cur = max(m_prev, max s);
// p = exp(s - m_cur) * (m_cur > NEG_INF / 2); alpha = exp(m_prev - m_cur);
// l = alpha * l + sum p (p unrounded); acc = alpha * acc + round(p) . v.

#include "flash_common.cuh"

namespace flash {

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q,  // [Lq, H, D]
    const T* __restrict__ k,  // [Lk, H, D]
    const T* __restrict__ v,  // [Lk, H, D]
    void* __restrict__ o_out,  // [Lq, H, D]: f32 (stats) or T (normalized)
    float* __restrict__ m_out,  // [H, Lq] (stats only)
    float* __restrict__ l_out,  // [H, Lq] (stats only)
    int Lq, int Lk, int H, int D, int bq, int bk, int causal, int q_off,
    int k_off, int stride, float scale, int emit_stats) {
  const int row0 = blockIdx.x * bq;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ldt = D + Pad<T>::value, lds = bk + 4, ldp = bk + Pad<T>::value,
            lda = D + 4;

  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv(smem);
  T* q_s = cv.take<T>(static_cast<size_t>(bq) * ldt);
  T* k_s = cv.take<T>(static_cast<size_t>(bk) * ldt);
  T* v_s = cv.take<T>(static_cast<size_t>(bk) * ldt);
  float* s_s = cv.take<float>(static_cast<size_t>(bq) * lds);
  T* p_s = cv.take<T>(static_cast<size_t>(bq) * ldp);
  float* acc = cv.take<float>(static_cast<size_t>(bq) * lda);
  float* m_s = cv.take<float>(bq);
  float* l_s = cv.take<float>(bq);
  float* a_s = cv.take<float>(bq);

  load_tile(q_s, ldt, q, row0, bq, H, h, D);
  for (int i = tid; i < bq * lda; i += THREADS) acc[i] = 0.f;
  for (int r = tid; r < bq; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int nk = Lk / bk;
  const long long q_last =
      q_off + static_cast<long long>(row0 + bq - 1) * stride;
  for (int ik = 0; ik < nk; ++ik) {
    const int col0 = ik * bk;
    // the same value in every thread: the whole block stops together
    if (causal && q_last < k_off + static_cast<long long>(col0) * stride)
      break;
    load_tile(k_s, ldt, k, col0, bk, H, h, D);
    load_tile(v_s, ldt, v, col0, bk, H, h, D);
    __syncthreads();

    mm<false, true>(q_s, ldt, k_s, ldt, s_s, lds, bq, bk, D, false);
    __syncthreads();

    for (int r = warp; r < bq; r += WARPS) {
      const long long q_pos =
          q_off + static_cast<long long>(row0 + r) * stride;
      float mx = NEG_INF;
      for (int c = lane; c < bk; c += 32) {
        float s = s_s[r * lds + c] * scale;
        if (causal && q_pos < k_off + static_cast<long long>(col0 + c) * stride)
          s = NEG_INF;
        s_s[r * lds + c] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, mx);
      // rows with nothing unmasked yet keep exp() exactly 0
      const float keep = (m_cur > NEG_INF * 0.5f) ? 1.f : 0.f;
      float sum = 0.f;
      for (int c = lane; c < bk; c += 32) {
        const float p = expf(s_s[r * lds + c] - m_cur) * keep;
        sum += p;
        p_s[r * ldp + c] = from_f32<T>(p);
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

    for (int i = tid; i < bq * D; i += THREADS) {
      const int r = i / D, c = i % D;
      acc[r * lda + c] *= a_s[r];
    }
    __syncthreads();
    mm<false, false>(p_s, ldp, v_s, ldt, acc, lda, bq, D, bk, true);
    __syncthreads();
  }

  if (emit_stats) {
    float* o = static_cast<float*>(o_out);
    for (int i = tid; i < bq * D; i += THREADS) {
      const int r = i / D, c = i % D;
      o[(static_cast<size_t>(row0 + r) * H + h) * D + c] = acc[r * lda + c];
    }
    for (int r = tid; r < bq; r += THREADS) {
      m_out[static_cast<size_t>(h) * Lq + row0 + r] = m_s[r];
      l_out[static_cast<size_t>(h) * Lq + row0 + r] = l_s[r];
    }
  } else {
    T* o = static_cast<T*>(o_out);
    for (int i = tid; i < bq * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const float l = l_s[r];
      o[(static_cast<size_t>(row0 + r) * H + h) * D + c] =
          from_f32<T>(acc[r * lda + c] / (l == 0.f ? 1.f : l));
    }
  }
}

template <typename T>
int launch_fwd(int emit_stats, const void* q, const void* k, const void* v,
               void* o, float* m, float* l, int Lq, int Lk, int H, int D,
               int bq, int bk, int causal, int q_off, int k_off, int stride,
               float scale, cudaStream_t stream) {
  const size_t smem = smem_fwd(sizeof(T), bq, bk, D);
  if (int e = set_smem(flash_fwd_kernel<T>, smem)) return e;
  dim3 grid(Lq / bq, H);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), o, m, l, Lq, Lk, H, D, bq, bk, causal, q_off,
      k_off, stride, scale, emit_stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash

extern "C" {

// Dynamic shared memory of one forward block, in bytes.
size_t flash_fwd_smem_bytes(int in_bytes, int bq, int bk, int D) {
  return flash::smem_fwd(in_bytes, bq, bk, D);
}

// kind: 0 float32, 1 bfloat16 (q, k, v and, without stats, o).
// emit_stats 1: o is f32 [Lq, H, D] unnormalized, m and l f32 [H, Lq]
// (K3); 0: o is normalized in q's dtype, m and l unused (K2).
// Launches on ``stream`` and returns cudaGetLastError() (0 on
// success); never synchronizes.
int flash_fwd(int kind, int emit_stats, const void* q, const void* k,
              const void* v, void* o, float* m, float* l, int Lq, int Lk,
              int H, int D, int bq, int bk, int causal, int q_off, int k_off,
              int stride, float scale, void* stream) {
  if (!flash::shapes_ok(Lq, Lk, H, D, bq, bk, stride))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return flash::launch_fwd<float>(emit_stats, q, k, v, o, m, l, Lq, Lk, H,
                                    D, bq, bk, causal, q_off, k_off, stride,
                                    scale, st);
  if (kind == 1)
    return flash::launch_fwd<flash::bf16>(emit_stats, q, k, v, o, m, l, Lq,
                                          Lk, H, D, bq, bk, causal, q_off,
                                          k_off, stride, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
