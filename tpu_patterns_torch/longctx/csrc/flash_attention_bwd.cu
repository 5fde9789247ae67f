// Fused flash-attention backward for Hopper (sm_90a): K4's dq and dk/dv.
//
// Replaces, in tpu_patterns/longctx/flash.py::flash_block_bwd,
//   * _bwd_dq_kernel (:255) and _bwd_dq_kernel_compact (:316) -- dq;
//   * _bwd_dkv_kernel (:279) and _bwd_dkv_kernel_compact (:334) -- dk, dv.
// From the saved row statistics lse = m + log l and
// delta = rowsum(dO * O) ([H, Lq] f32), with the score tiles recomputed:
//   P = exp(s - lse), s = (q . k) * scale masked to NEG_INF
//   dV = P^T dO, dP = dO V^T, dS = P * (dP - delta)
//   dQ = scale * dS K, dK = scale * dS^T Q            (all f32 out)
//
// What bounds them on this card: operations.  Per visible (query, key)
// pair the dq kernel runs 3 products of 2*D flops (S, dP, dQ) and the
// dk/dv kernel 4 (S, dP, dV, dK); in bf16 at D = 128 that is far above
// the ~295 flops/byte ridge.
//
// Design (first version: right and simple):
//   * dq: one thread block per (q-tile, head) loops over its live
//     k-tiles (ascending; the loop stops at the first tile wholly above
//     the diagonal, before loading it) and keeps dq in shared memory;
//   * dk/dv: one thread block per (k-tile, head) loops over the q-tiles
//     in ascending order, skipping those wholly above the diagonal (the
//     first ones) before loading them, and keeps dk and dv in shared
//     memory.
//     No floating-point atomics anywhere: every output element is summed
//     by one block in a fixed order, so two runs agree bit for bit (the
//     reference's ik- and iq-ascending accumulation).  As in the forward,
//     the reference's dense and compact grids are one launch here;
//   * rounding points of the Pallas kernels: dS is rounded to the input
//     dtype before dS K and dS^T Q, P before P^T dO; products accumulate
//     in f32.  The scale multiplies the summed dS K (dS^T Q) once at the
//     end instead of each tile's product: the same value up to f32
//     reassociation;
//   * products on the tensor cores (WMMA) for bf16, scalar f32 FMAs for
//     f32; synchronous 16-byte loads.

#include "flash_common.cuh"

namespace flash {

// s = (q . k) * scale, NEG_INF where query row ``qrow`` may not see key
// ``kcol`` (rows and columns counted within the shards)
__device__ __forceinline__ float masked_score(float dot, float scale,
                                              int causal, int q_off,
                                              int k_off, int stride, int qrow,
                                              int kcol) {
  float s = dot * scale;
  if (causal && q_off + static_cast<long long>(qrow) * stride <
                    k_off + static_cast<long long>(kcol) * stride)
    s = NEG_INF;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq,  // [Lq, H, D]
    int Lq, int Lk, int H, int D, int bq, int bk, int causal, int q_off,
    int k_off, int stride, float scale) {
  const int row0 = blockIdx.x * bq;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int ldt = D + Pad<T>::value, lds = bk + 4, ldp = bk + Pad<T>::value,
            lda = D + 4;

  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv(smem);
  T* q_s = cv.take<T>(static_cast<size_t>(bq) * ldt);
  T* do_s = cv.take<T>(static_cast<size_t>(bq) * ldt);
  T* k_s = cv.take<T>(static_cast<size_t>(bk) * ldt);
  T* v_s = cv.take<T>(static_cast<size_t>(bk) * ldt);
  float* s_s = cv.take<float>(static_cast<size_t>(bq) * lds);
  float* dp_s = cv.take<float>(static_cast<size_t>(bq) * lds);
  T* ds_s = cv.take<T>(static_cast<size_t>(bq) * ldp);
  float* acc = cv.take<float>(static_cast<size_t>(bq) * lda);
  float* lse_s = cv.take<float>(bq);
  float* delta_s = cv.take<float>(bq);

  load_tile(q_s, ldt, q, row0, bq, H, h, D);
  load_tile(do_s, ldt, dout, row0, bq, H, h, D);
  load_row_stat(lse_s, lse, row0, bq, Lq, h);
  load_row_stat(delta_s, delta, row0, bq, Lq, h);
  for (int i = tid; i < bq * lda; i += THREADS) acc[i] = 0.f;
  __syncthreads();

  const int nk = Lk / bk;
  const long long q_last =
      q_off + static_cast<long long>(row0 + bq - 1) * stride;
  for (int ik = 0; ik < nk; ++ik) {
    const int col0 = ik * bk;
    if (causal && q_last < k_off + static_cast<long long>(col0) * stride)
      break;
    load_tile(k_s, ldt, k, col0, bk, H, h, D);
    load_tile(v_s, ldt, v, col0, bk, H, h, D);
    __syncthreads();

    mm<false, true>(q_s, ldt, k_s, ldt, s_s, lds, bq, bk, D, false);
    mm<false, true>(do_s, ldt, v_s, ldt, dp_s, lds, bq, bk, D, false);
    __syncthreads();

    for (int i = tid; i < bq * bk; i += THREADS) {
      const int r = i / bk, c = i % bk;
      const float s = masked_score(s_s[r * lds + c], scale, causal, q_off,
                                   k_off, stride, row0 + r, col0 + c);
      const float p = expf(s - lse_s[r]);
      const float ds = p * (dp_s[r * lds + c] - delta_s[r]);
      ds_s[r * ldp + c] = from_f32<T>(ds);
    }
    __syncthreads();
    mm<false, false>(ds_s, ldp, k_s, ldt, acc, lda, bq, D, bk, true);
    __syncthreads();
  }

  for (int i = tid; i < bq * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dq[(static_cast<size_t>(row0 + r) * H + h) * D + c] =
        scale * acc[r * lda + c];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk,  // [Lk, H, D]
    float* __restrict__ dv,  // [Lk, H, D]
    int Lq, int Lk, int H, int D, int bq, int bk, int causal, int q_off,
    int k_off, int stride, float scale) {
  const int col0 = blockIdx.x * bk;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int ldt = D + Pad<T>::value, lds = bk + 4, ldp = bk + Pad<T>::value,
            lda = D + 4;

  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv(smem);
  T* k_s = cv.take<T>(static_cast<size_t>(bk) * ldt);
  T* v_s = cv.take<T>(static_cast<size_t>(bk) * ldt);
  T* q_s = cv.take<T>(static_cast<size_t>(bq) * ldt);
  T* do_s = cv.take<T>(static_cast<size_t>(bq) * ldt);
  float* s_s = cv.take<float>(static_cast<size_t>(bq) * lds);
  float* dp_s = cv.take<float>(static_cast<size_t>(bq) * lds);
  T* p_s = cv.take<T>(static_cast<size_t>(bq) * ldp);
  T* ds_s = cv.take<T>(static_cast<size_t>(bq) * ldp);
  float* dk_acc = cv.take<float>(static_cast<size_t>(bk) * lda);
  float* dv_acc = cv.take<float>(static_cast<size_t>(bk) * lda);
  float* lse_s = cv.take<float>(bq);
  float* delta_s = cv.take<float>(bq);

  load_tile(k_s, ldt, k, col0, bk, H, h, D);
  load_tile(v_s, ldt, v, col0, bk, H, h, D);
  for (int i = tid; i < bk * lda; i += THREADS) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  const int nq = Lq / bq;
  const long long k_first = k_off + static_cast<long long>(col0) * stride;
  for (int iq = 0; iq < nq; ++iq) {
    const int row0 = iq * bq;
    // q-tiles wholly above the diagonal for this k-tile come first
    if (causal &&
        q_off + static_cast<long long>(row0 + bq - 1) * stride < k_first)
      continue;
    __syncthreads();  // the previous tile's readers of q_s / do_s are done
    load_tile(q_s, ldt, q, row0, bq, H, h, D);
    load_tile(do_s, ldt, dout, row0, bq, H, h, D);
    load_row_stat(lse_s, lse, row0, bq, Lq, h);
    load_row_stat(delta_s, delta, row0, bq, Lq, h);
    __syncthreads();

    mm<false, true>(q_s, ldt, k_s, ldt, s_s, lds, bq, bk, D, false);
    mm<false, true>(do_s, ldt, v_s, ldt, dp_s, lds, bq, bk, D, false);
    __syncthreads();

    for (int i = tid; i < bq * bk; i += THREADS) {
      const int r = i / bk, c = i % bk;
      const float s = masked_score(s_s[r * lds + c], scale, causal, q_off,
                                   k_off, stride, row0 + r, col0 + c);
      const float p = expf(s - lse_s[r]);
      p_s[r * ldp + c] = from_f32<T>(p);
      ds_s[r * ldp + c] = from_f32<T>(p * (dp_s[r * lds + c] - delta_s[r]));
    }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q: [bk x bq] . [bq x D]
    mm<true, false>(p_s, ldp, do_s, ldt, dv_acc, lda, bk, D, bq, true);
    mm<true, false>(ds_s, ldp, q_s, ldt, dk_acc, lda, bk, D, bq, true);
  }
  __syncthreads();

  for (int i = tid; i < bk * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const size_t off = (static_cast<size_t>(col0 + r) * H + h) * D + c;
    dk[off] = scale * dk_acc[r * lda + c];
    dv[off] = dv_acc[r * lda + c];
  }
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, float* dq, int Lq, int Lk,
              int H, int D, int bq, int bk, int causal, int q_off, int k_off,
              int stride, float scale, cudaStream_t stream) {
  const size_t smem = smem_dq(sizeof(T), bq, bk, D);
  if (int e = set_smem(flash_bwd_dq_kernel<T>, smem)) return e;
  dim3 grid(Lq / bq, H);
  flash_bwd_dq_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, dq,
      Lq, Lk, H, D, bq, bk, causal, q_off, k_off, stride, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, float* dk, float* dv,
               int Lq, int Lk, int H, int D, int bq, int bk, int causal,
               int q_off, int k_off, int stride, float scale,
               cudaStream_t stream) {
  const size_t smem = smem_dkv(sizeof(T), bq, bk, D);
  if (int e = set_smem(flash_bwd_dkv_kernel<T>, smem)) return e;
  dim3 grid(Lk / bk, H);
  flash_bwd_dkv_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, dk,
      dv, Lq, Lk, H, D, bq, bk, causal, q_off, k_off, stride, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash

extern "C" {

// Dynamic shared memory of one dq (which 0) or dk/dv (which 1) block.
size_t flash_bwd_smem_bytes(int which, int in_bytes, int bq, int bk, int D) {
  return which == 0 ? flash::smem_dq(in_bytes, bq, bk, D)
                    : flash::smem_dkv(in_bytes, bq, bk, D);
}

// kind: 0 float32, 1 bfloat16 (q, k, v, do).  lse, delta f32 [H, Lq];
// dq f32 [Lq, H, D].  Launches on ``stream`` and returns
// cudaGetLastError(); never synchronizes.
int flash_bwd_dq(int kind, const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 float* dq, int Lq, int Lk, int H, int D, int bq, int bk,
                 int causal, int q_off, int k_off, int stride, float scale,
                 void* stream) {
  if (!flash::shapes_ok(Lq, Lk, H, D, bq, bk, stride))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return flash::launch_dq<float>(q, k, v, dout, lse, delta, dq, Lq, Lk, H,
                                   D, bq, bk, causal, q_off, k_off, stride,
                                   scale, st);
  if (kind == 1)
    return flash::launch_dq<flash::bf16>(q, k, v, dout, lse, delta, dq, Lq,
                                         Lk, H, D, bq, bk, causal, q_off,
                                         k_off, stride, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As flash_bwd_dq; dk, dv f32 [Lk, H, D].
int flash_bwd_dkv(int kind, const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  float* dk, float* dv, int Lq, int Lk, int H, int D, int bq,
                  int bk, int causal, int q_off, int k_off, int stride,
                  float scale, void* stream) {
  if (!flash::shapes_ok(Lq, Lk, H, D, bq, bk, stride))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return flash::launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, Lq,
                                    Lk, H, D, bq, bk, causal, q_off, k_off,
                                    stride, scale, st);
  if (kind == 1)
    return flash::launch_dkv<flash::bf16>(q, k, v, dout, lse, delta, dk, dv,
                                          Lq, Lk, H, D, bq, bk, causal, q_off,
                                          k_off, stride, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
