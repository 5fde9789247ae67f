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
// The dispatch is by dtype: bfloat16 inputs run the wgmma kernels,
// float32 inputs the scalar ones (a tensor-core f32 product would be
// TF32, which keeps ~3 digits).
//
// What bounds them on this card: operations.  Per visible (query, key)
// pair the dq kernel runs 3 products of 2*D flops (S, dP, dQ) and the
// dk/dv kernel 4 (S, dP, dV, dK); in bf16 at D = 128 that is far above
// the ~295 flops/byte ridge.
//
// Both designs keep the reference's order and rounding points:
//   * no floating-point atomics: every output element is summed by one
//     block in a fixed order (k-tiles ascending for dq, q-tiles
//     ascending for dk/dv, the reference's order), so two runs agree
//     bit for bit.  As in the forward, the reference's dense and compact
//     grids are one launch here;
//   * P is rounded to the input dtype before P^T dO, dS before dS K and
//     dS^T Q; products accumulate in f32.  The scale multiplies the
//     summed dS K (dS^T Q) once at the end instead of each tile's
//     product: the same value up to f32 reassociation;
//   * a block visits its causally live tiles only, skipping a tile
//     wholly masked for it before loading it.
//
// bf16 design (flash_bwd_wgmma_dq_kernel, flash_bwd_wgmma_dkv_kernel),
// the forward's parts (flash_wgmma.cuh, kernels/csrc/hopper.cuh):
//   * a block owns 64 * NC rows (dq) or keys (dk/dv) of one head: NC
//     consumer warpgroups of 64 each and one producer warpgroup;
//   * the producer's first thread TMA-loads the block's own tiles once
//     (q and dO for dq, k and v for dk/dv) and streams the other side
//     in tiles of 64 (k and v for dq, q and dO for dk/dv) through a ring
//     of STAGES slots (2 at D 128, 4 at D 64) behind full/free
//     mbarriers; for dk/dv its second warp copies each streamed tile's
//     64 lse and delta values into the slot (+inf and 0 past Lq, so
//     rows past the end give P = 0);
//   * every product is wgmma with its result in registers: S and dP
//     (dk/dv: S^T = K Q^T and dP^T = V dO^T) with both operands in
//     shared memory and S as a write-only first product; P and dS are
//     computed on those registers (exp as one ex2 of an FMA), rounded
//     to bf16 in registers and are the register A operand of dQ += dS K
//     (dk/dv: dV += P^T dO, dK += dS^T Q) whose B, the streamed or own
//     tile [rows, D], is the transposed (MN-major) operand.  No S, P,
//     dS or accumulator goes through shared memory.  In dk/dv the row
//     statistics are per column of S^T: register 4j + e is column
//     8j + 2 (lane % 4) + e, read as a float2 from the slot;
//   * a register operand is packed only after the wait for the product
//     that last read it (ptxas serializes every wgmma of the kernel,
//     C7513, otherwise), so a warpgroup runs products, then elementwise
//     math, in turn; its two warpgroups overlap each other's;
//   * causal: dq walks k-tiles from the first up to its last live one,
//     dk/dv q-tiles from its first live one to the end; a warpgroup
//     skips the tiles wholly masked for its own 64 rows or keys, and
//     only tiles that cross the diagonal (or, for dq, the ragged end of
//     k) are masked element by element; the heaviest blocks go first
//     (the last q-tiles for dq, the first k-tiles for dk/dv).  The
//     Python mirror of this schedule is flash.py::bwd_schedule;
//   * lengths need not be multiples of the tile: TMA fills rows past
//     the end with zeros, and rows past the end are not stored.
//
// f32 design (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): one thread
// block (8 warps) per (q-tile, head) or (k-tile, head) walks its live
// tiles as above, staging tiles, S, dP, P, dS and the sums in shared
// memory, with synchronous 16-byte loads and scalar f32 FMAs.

#include <math.h>

#include <type_traits>

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

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


// -- bf16: wgmma with TMA loads --------------------------------------------

constexpr int BWD_STREAM = 64;  // rows (dk/dv) or keys (dq) a streamed tile
constexpr size_t BWD_BAR_BYTES = 256;  // 1 + 2 * STAGES mbarriers

// depth of the streamed ring: 64 KB of streamed tiles either way
__host__ __device__ constexpr int bwd_stages(int D) { return D <= 64 ? 4 : 2; }

// Dynamic shared memory of one bf16 block (tuning.py::smem_bytes agrees):
// slack to align the swizzled tiles to 1024 bytes, the block's own two
// tiles, the ring's two tiles a slot (dk/dv: and their rows' lse and
// delta), the mbarriers.  dq owns bq rows and streams bk keys; dk/dv
// owns bk keys and streams bq rows.
__host__ __device__ constexpr size_t smem_dq_bf16(int bq, int bk, int D) {
  return 1024 + static_cast<size_t>(2) * bq * D * 2 +
         static_cast<size_t>(bwd_stages(D)) * 2 * bk * D * 2 + BWD_BAR_BYTES;
}
__host__ __device__ constexpr size_t smem_dkv_bf16(int bq, int bk, int D) {
  return 1024 + static_cast<size_t>(2) * bk * D * 2 +
         static_cast<size_t>(bwd_stages(D)) * (2 * bq * D * 2 + 2 * bq * 4) +
         BWD_BAR_BYTES;
}

template <int D, int NC>
struct BwdDq {
  static constexpr int BQ = 64 * NC;  // rows a block owns, 64 a warpgroup
  static constexpr int BK = BWD_STREAM;  // keys a streamed tile
  static constexpr int STAGES = bwd_stages(D);
  static constexpr int THREADS = 128 * (NC + 1);  // + the producer
  static constexpr int CHUNKS = D / 64;  // 128-byte swizzled column blocks
  static constexpr uint32_t Q_BYTES = BQ * D * 2;  // the q or the do tile
  static constexpr uint32_t T_BYTES = BK * D * 2;  // one k or v tile
  static constexpr size_t SMEM = smem_dq_bf16(BQ, BK, D);
  static_assert((1 + 2 * STAGES) * 8 <= BWD_BAR_BYTES, "mbarriers");
};

template <int D, int NC>
struct BwdDkv {
  static constexpr int BK = 64 * NC;  // keys a block owns, 64 a warpgroup
  static constexpr int BQ = BWD_STREAM;  // rows a streamed tile
  static constexpr int STAGES = bwd_stages(D);
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int CHUNKS = D / 64;
  static constexpr uint32_t KV_BYTES = BK * D * 2;  // the k or the v tile
  static constexpr uint32_t T_BYTES = BQ * D * 2;   // one q or do tile
  static constexpr uint32_t ST_BYTES = 2 * BQ * 4;  // its lse and delta
  static constexpr size_t SMEM = smem_dkv_bf16(BQ, BK, D);
  static_assert((1 + 2 * STAGES) * 8 <= BWD_BAR_BYTES, "mbarriers");
};

// The first q-tile of bq rows (Lq in all) with a row at or after key
// position k_pos: the first live tile of keys from k_pos on; the tile
// count if none.
__device__ __forceinline__ int first_q_tile(int causal, long long k_pos,
                                            int q_off, int stride, int bq,
                                            int Lq) {
  if (!causal || k_pos <= q_off) return 0;
  const long long r = (k_pos - q_off + stride - 1) / stride;  // first row
  return r < Lq ? static_cast<int>(r / bq) : (Lq + bq - 1) / bq;
}

// 64 x N accumulator rows of a consumer thread (E = 0 its first row, 2
// its second), times `scale`, to the f32 row at `row` (its columns)
template <int N, int E>
__device__ __forceinline__ void store_row(const float (&a)[N / 2],
                                          float* row, float scale) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
    *reinterpret_cast<float2*>(row + 8 * j) =
        make_float2(scale * a[4 * j + E], scale * a[4 * j + E + 1]);
}

template <int D, int NC>
__global__ void __launch_bounds__(BwdDq<D, NC>::THREADS, 1)
    flash_bwd_wgmma_dq_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dq, int Lq, int Lk, int H,
                              int causal, int q_off, int k_off, int stride,
                              float scale) {
  using C = BwdDq<D, NC>;
  constexpr int S = C::STAGES, BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sdo = sq + C::Q_BYTES;
  const uint32_t sk = sdo + C::Q_BYTES;     // k slot s at sk + s T
  const uint32_t sv = sk + S * C::T_BYTES;  // v slot s at sv + s T
  const uint32_t bars = sv + S * C::T_BYTES;
  // mbarriers: [0] q and do loaded; then per slot s: k and v loaded, k
  // and v read by every consumer warp
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + S + s); };

  const int h = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;  // heaviest first
  const int rows = min(C::BQ, Lq - row0);
  const int n_tiles = live_k_tiles(
      causal, q_off + static_cast<long long>(row0 + rows - 1) * stride,
      k_off, stride, BK, (Lk + BK - 1) / BK);

  if (threadIdx.x == 0) {
    hopper::bar_init(bars, 1);
    for (int s = 0; s < S; ++s) {
      hopper::bar_init(full(s), 1);
      hopper::bar_init(empty(s), NC * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    // the producer: one thread loads q and do, then k and v tiles, each
    // into its slot once every consumer warp has released the slot
    if constexpr (NC == 2) hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == NC * 128 && n_tiles > 0) {
      hopper::tma_prefetch(&tq);
      hopper::tma_prefetch(&tdo);
      hopper::tma_prefetch(&tk);
      hopper::tma_prefetch(&tv);
      hopper::bar_expect(bars, 2 * C::Q_BYTES);
      for (int c = 0; c < C::CHUNKS; ++c) {
        hopper::tma_load_3d(sq + c * C::BQ * 128, &tq, bars, c * 64, h, row0);
        hopper::tma_load_3d(sdo + c * C::BQ * 128, &tdo, bars, c * 64, h,
                            row0);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        if (it >= S) hopper::bar_wait(empty(s), (it / S - 1) & 1);
        hopper::bar_expect(full(s), 2 * C::T_BYTES);
        for (int c = 0; c < C::CHUNKS; ++c) {
          hopper::tma_load_3d(sk + s * C::T_BYTES + c * BK * 128, &tk,
                              full(s), c * 64, h, it * BK);
          hopper::tma_load_3d(sv + s * C::T_BYTES + c * BK * 128, &tv,
                              full(s), c * 64, h, it * BK);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows [wr0, wr0 + 64) of the block
  if constexpr (NC == 2) hopper::setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int wgu = __shfl_sync(0xffffffffu, wg, 0);  // uniform
  const int wr0 = row0 + wgu * 64;
  const int wrows = min(64, Lq - wr0);  // <= 0: wholly past Lq
  const int ra = wr0 + (tid / 32) * 16 + lane / 4;  // this thread's rows:
  const int rb = ra + 8;                            // ra and rb
  const int cq = 2 * (lane % 4);  // its columns in each group of 8
  const long long wq_first = q_off + static_cast<long long>(wr0) * stride;
  const long long qa = q_off + static_cast<long long>(ra) * stride;
  const long long qb = qa + 8LL * stride;
  // the tiles this warpgroup computes; the block's later live tiles are
  // wholly above its rows
  const int n_wg =
      wrows > 0
          ? live_k_tiles(causal,
                         q_off + static_cast<long long>(wr0 + wrows - 1) *
                                     stride,
                         k_off, stride, BK, n_tiles)
          : 0;
  // the rows' statistics, lse in log2 units; rows past Lq get P = 0
  const size_t st0 = static_cast<size_t>(h) * Lq;
  const float nla = ra < Lq ? lse[st0 + ra] * LOG2E : INFINITY;
  const float nlb = rb < Lq ? lse[st0 + rb] * LOG2E : INFINITY;
  const float dla = ra < Lq ? delta[st0 + ra] : 0.f;
  const float dlb = rb < Lq ? delta[st0 + rb] : 0.f;
  const float c = scale * LOG2E;

  // S = Q K^T and dP = dO V^T of slot s, 16 columns of D a product
  const uint64_t q_a = hopper::desc_sw128(sq + wgu * 64 * 128, 16, 1024);
  const uint64_t do_a = hopper::desc_sw128(sdo + wgu * 64 * 128, 16, 1024);
  auto scores = [&](float (&sc)[BK / 2], float (&dp)[BK / 2], int s) {
    const uint64_t kb = hopper::desc_sw128(sk + s * C::T_BYTES, 16, 1024);
    const uint64_t vb = hopper::desc_sw128(sv + s * C::T_BYTES, 16, 1024);
    hopper::wgmma_ss_init(sc, q_a, kb);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      hopper::wgmma_ss(sc, q_a + (kk / 4) * C::BQ * 8 + (kk % 4) * 2,
                       kb + (kk / 4) * BK * 8 + (kk % 4) * 2);
    hopper::wgmma_ss_init(dp, do_a, vb);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      hopper::wgmma_ss(dp, do_a + (kk / 4) * C::BQ * 8 + (kk % 4) * 2,
                       vb + (kk / 4) * BK * 8 + (kk % 4) * 2);
  };
  // dQ += dS K of slot s, 16 keys a product (K [keys, D] the transposed,
  // MN-major B, its 64-column blocks BK * 128 bytes apart)
  auto dsk = [&](float (&acc)[D / 2], uint32_t (&ds)[BK / 16][4], int s) {
    const uint64_t kt =
        hopper::desc_sw128(sk + s * C::T_BYTES, BK * 128, 1024);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::wgmma_rs(acc, ds[kk], kt + kk * 128);
  };
  auto mask = [&](float (&sc)[BK / 2], int it) {
    mask_keys<BK>(sc, it, Lk, causal, k_off, stride, wq_first, qa, qb, cq);
  };
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) hopper::bar_arrive(bar);
  };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  uint32_t ds[BK / 16][4];
  // tile it: S and dP, then P = exp(s - lse) and dS = P (dP - delta) on
  // their registers, then dQ += dS K
  auto step = [&](int it, auto masked) {
    const int s = it % S;
    float sc[BK / 2], dp[BK / 2];
    hopper::bar_wait(full(s), (it / S) & 1);
    hopper::wgmma_fence();
    scores(sc, dp, s);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    if constexpr (decltype(masked)::value) mask(sc, it);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pa = hopper::ex2(fmaf(sc[4 * j + e], c, -nla));
        const float pb = hopper::ex2(fmaf(sc[4 * j + 2 + e], c, -nlb));
        dp[4 * j + e] = pa * (dp[4 * j + e] - dla);
        dp[4 * j + 2 + e] = pb * (dp[4 * j + 2 + e] - dlb);
      }
    pack_a<BK>(dp, ds);  // dS: the A operand of dS K
    hopper::fence_regs(acc);
    hopper::fence_regs(ds);
    hopper::wgmma_fence();
    dsk(acc, ds, s);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    release(empty(s));
  };
  // the leading tiles need no mask: full, and wholly at or below the
  // diagonal for every row of the warpgroup; the rest go through mask()
  int n_plain = min(n_wg, Lk / BK);
  if (causal) {
    const long long last =
        wq_first < k_off ? -1 : (wq_first - k_off) / stride;
    const long long t = (last + 1) / BK;
    if (t < n_plain) n_plain = static_cast<int>(t);
  }
  if (n_tiles > 0) hopper::bar_wait(bars, 0);
  int it = 0;
  for (; it < n_plain; ++it) step(it, std::false_type{});
  for (; it < n_wg; ++it) step(it, std::true_type{});
  // tiles wholly above this warpgroup's rows: release each once loaded,
  // so no arrival runs ahead of the ring's phase
  for (; it < n_tiles; ++it) {
    const int s = it % S;
    hopper::bar_wait(full(s), (it / S) & 1);
    release(empty(s));
  }

  float* out = dq + (static_cast<size_t>(ra) * H + h) * D + cq;
  if (ra < Lq) store_row<D, 0>(acc, out, scale);
  if (rb < Lq) store_row<D, 2>(acc, out + 8 * static_cast<size_t>(H) * D,
                               scale);
}

template <int D, int NC>
__global__ void __launch_bounds__(BwdDkv<D, NC>::THREADS, 1)
    flash_bwd_wgmma_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tdo,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               float* __restrict__ dk,
                               float* __restrict__ dv, int Lq, int Lk, int H,
                               int causal, int q_off, int k_off, int stride,
                               float scale) {
  using C = BwdDkv<D, NC>;
  constexpr int S = C::STAGES, BQ = C::BQ;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = hopper::smem_u32(smem_raw);
  const uint32_t sk = (base + 1023) & ~1023u;
  const uint32_t sv = sk + C::KV_BYTES;
  const uint32_t sq = sv + C::KV_BYTES;       // q slot s at sq + s T
  const uint32_t sdo = sq + S * C::T_BYTES;   // do slot s at sdo + s T
  const uint32_t sst = sdo + S * C::T_BYTES;  // slot s: lse [BQ], delta [BQ]
  float* stats = reinterpret_cast<float*>(smem_raw + (sst - base));
  const uint32_t bars = sst + S * C::ST_BYTES;
  // mbarriers: [0] k and v loaded; then per slot s: q, do, lse and delta
  // loaded (the TMA thread and the 32 lanes of the statistics warp), and
  // read by every consumer warp
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + S + s); };

  const int h = blockIdx.x;
  const int col0 = blockIdx.y * C::BK;  // the first keys see most rows:
                                        // the heaviest blocks go first
  const int n_q = (Lq + BQ - 1) / BQ;
  const int it0 = first_q_tile(
      causal, k_off + static_cast<long long>(col0) * stride, q_off, stride,
      BQ, Lq);
  const int n_tiles = n_q - it0;  // q-tiles it0, it0 + 1, ... in turn

  if (threadIdx.x == 0) {
    hopper::bar_init(bars, 1);
    for (int s = 0; s < S; ++s) {
      hopper::bar_init(full(s), 1 + 32);
      hopper::bar_init(empty(s), NC * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    if constexpr (NC == 2) hopper::setmaxnreg_dec<24>();
    const int ptid = threadIdx.x - NC * 128;
    if (ptid == 0 && n_tiles > 0) {
      hopper::tma_prefetch(&tq);
      hopper::tma_prefetch(&tdo);
      hopper::tma_prefetch(&tk);
      hopper::tma_prefetch(&tv);
      hopper::bar_expect(bars, 2 * C::KV_BYTES);
      for (int c = 0; c < C::CHUNKS; ++c) {
        hopper::tma_load_3d(sk + c * C::BK * 128, &tk, bars, c * 64, h,
                            col0);
        hopper::tma_load_3d(sv + c * C::BK * 128, &tv, bars, c * 64, h,
                            col0);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % S;
        if (i >= S) hopper::bar_wait(empty(s), (i / S - 1) & 1);
        hopper::bar_expect(full(s), 2 * C::T_BYTES);
        for (int c = 0; c < C::CHUNKS; ++c) {
          hopper::tma_load_3d(sq + s * C::T_BYTES + c * BQ * 128, &tq,
                              full(s), c * 64, h, (it0 + i) * BQ);
          hopper::tma_load_3d(sdo + s * C::T_BYTES + c * BQ * 128, &tdo,
                              full(s), c * 64, h, (it0 + i) * BQ);
        }
      }
    } else if (ptid / 32 == 1 && n_tiles > 0) {
      // the statistics warp: each lane stores its values and arrives
      const int lane = ptid % 32;
      const size_t st0 = static_cast<size_t>(h) * Lq;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % S;
        if (i >= S) hopper::bar_wait(empty(s), (i / S - 1) & 1);
        float* st = stats + s * 2 * BQ;
        for (int r = lane; r < BQ; r += 32) {
          const int row = (it0 + i) * BQ + r;
          st[r] = row < Lq ? lse[st0 + row] : INFINITY;
          st[BQ + r] = row < Lq ? delta[st0 + row] : 0.f;
        }
        hopper::bar_arrive(full(s));
      }
    }
    return;
  }

  // a consumer warpgroup: keys [wk0, wk0 + 64) of the block
  if constexpr (NC == 2) hopper::setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int wgu = __shfl_sync(0xffffffffu, wg, 0);
  const int wk0 = col0 + wgu * 64;
  const int wkeys = min(64, Lk - wk0);  // <= 0: wholly past Lk
  const int ka = wk0 + (tid / 32) * 16 + lane / 4;  // this thread's keys:
  const int kb = ka + 8;                            // ka and kb
  const int cq = 2 * (lane % 4);  // its columns (rows of q) in each 8
  const long long pa = k_off + static_cast<long long>(ka) * stride;
  const long long pb = pa + 8LL * stride;
  // this warpgroup's first live tile (the block's earlier ones are
  // wholly before its keys), and from plain_it on, tiles every row of
  // which sees every key of the warpgroup
  int wg_it = n_q, plain_it = n_q;
  if (wkeys > 0) {
    wg_it = first_q_tile(causal, k_off + static_cast<long long>(wk0) * stride,
                         q_off, stride, BQ, Lq);
    plain_it = wg_it;
    if (causal) {
      const long long last =
          k_off + static_cast<long long>(wk0 + wkeys - 1) * stride;
      const long long span = static_cast<long long>(BQ) * stride;
      const long long t = last <= q_off ? 0 : (last - q_off + span - 1) / span;
      if (t > plain_it) plain_it = t < n_q ? static_cast<int>(t) : n_q;
    }
  }
  const float c = scale * LOG2E;

  // S^T = K Q^T and dP^T = V dO^T of slot s, 16 columns of D a product
  const uint64_t k_a = hopper::desc_sw128(sk + wgu * 64 * 128, 16, 1024);
  const uint64_t v_a = hopper::desc_sw128(sv + wgu * 64 * 128, 16, 1024);
  auto scores = [&](float (&st)[BQ / 2], float (&dpt)[BQ / 2], int s) {
    const uint64_t qb = hopper::desc_sw128(sq + s * C::T_BYTES, 16, 1024);
    const uint64_t dob = hopper::desc_sw128(sdo + s * C::T_BYTES, 16, 1024);
    hopper::wgmma_ss_init(st, k_a, qb);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      hopper::wgmma_ss(st, k_a + (kk / 4) * C::BK * 8 + (kk % 4) * 2,
                       qb + (kk / 4) * BQ * 8 + (kk % 4) * 2);
    hopper::wgmma_ss_init(dpt, v_a, dob);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      hopper::wgmma_ss(dpt, v_a + (kk / 4) * C::BK * 8 + (kk % 4) * 2,
                       dob + (kk / 4) * BQ * 8 + (kk % 4) * 2);
  };
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  // dV += P^T dO and dK += dS^T Q of slot s, 16 rows a product (dO and
  // Q [rows, D] the transposed, MN-major B)
  auto grads = [&](uint32_t (&pt)[BQ / 16][4], uint32_t (&dst)[BQ / 16][4],
                   int s) {
    const uint64_t dot =
        hopper::desc_sw128(sdo + s * C::T_BYTES, BQ * 128, 1024);
    const uint64_t qt =
        hopper::desc_sw128(sq + s * C::T_BYTES, BQ * 128, 1024);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hopper::wgmma_rs(dv_acc, pt[kk], dot + kk * 128);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hopper::wgmma_rs(dk_acc, dst[kk], qt + kk * 128);
  };
  // -inf where the tile crosses the diagonal: row c of the tile sees a
  // key once c >= the key's first visible row
  auto mask = [&](float (&st)[BQ / 2], int it) {
    const long long q_first =
        q_off + static_cast<long long>(it) * BQ * stride;
    auto first_row = [&](long long k_pos) {
      if (k_pos <= q_first) return 0;
      const long long r = (k_pos - q_first + stride - 1) / stride;
      return static_cast<int>(r < BQ ? r : BQ);
    };
    const int first_a = first_row(pa) - cq, first_b = first_row(pb) - cq;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * j + e < first_a) st[4 * j + e] = -INFINITY;
        if (8 * j + e < first_b) st[4 * j + 2 + e] = -INFINITY;
      }
  };
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) hopper::bar_arrive(bar);
  };

  // q-tile it0 + i: S^T and dP^T, then P^T and dS^T on their registers
  // with each column's (query row's) lse and delta, then dV and dK
  auto step = [&](int i, auto masked) {
    const int s = i % S;
    float st[BQ / 2], dpt[BQ / 2];
    uint32_t pt[BQ / 16][4], dst[BQ / 16][4];
    hopper::bar_wait(full(s), (i / S) & 1);
    hopper::wgmma_fence();
    scores(st, dpt, s);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    if constexpr (decltype(masked)::value) mask(st, it0 + i);
    const float* ls = stats + s * 2 * BQ;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + cq);
      const float2 d2 =
          *reinterpret_cast<const float2*>(ls + BQ + 8 * j + cq);
      const float nl[2] = {l2.x * LOG2E, l2.y * LOG2E};
      const float dl[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        st[4 * j + e] = hopper::ex2(fmaf(st[4 * j + e], c, -nl[e]));
        st[4 * j + 2 + e] = hopper::ex2(fmaf(st[4 * j + 2 + e], c, -nl[e]));
        dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - dl[e]);
        dpt[4 * j + 2 + e] = st[4 * j + 2 + e] * (dpt[4 * j + 2 + e] - dl[e]);
      }
    }
    pack_a<BQ>(st, pt);    // P^T: the A operand of P^T dO
    pack_a<BQ>(dpt, dst);  // dS^T: the A operand of dS^T Q
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::fence_regs(pt);
    hopper::fence_regs(dst);
    hopper::wgmma_fence();
    grads(pt, dst, s);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    release(empty(s));
  };

  if (n_tiles > 0 && wkeys > 0) hopper::bar_wait(bars, 0);
  int i = 0;
  // tiles wholly before this warpgroup's keys: release each once loaded
  for (; i < n_tiles && it0 + i < wg_it; ++i) {
    const int s = i % S;
    hopper::bar_wait(full(s), (i / S) & 1);
    release(empty(s));
  }
  for (; it0 + i < plain_it; ++i) step(i, std::true_type{});
  for (; i < n_tiles; ++i) step(i, std::false_type{});

  const size_t row = (static_cast<size_t>(ka) * H + h) * D + cq;
  const size_t next = 8 * static_cast<size_t>(H) * D;  // key kb's row
  if (ka < Lk) {
    store_row<D, 0>(dk_acc, dk + row, scale);
    store_row<D, 0>(dv_acc, dv + row, 1.f);
  }
  if (kb < Lk) {
    store_row<D, 2>(dk_acc, dk + row + next, scale);
    store_row<D, 2>(dv_acc, dv + row + next, 1.f);
  }
}

template <int D, int NC>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    float* dq, int Lq, int Lk, int H, int causal, int q_off,
                    int k_off, int stride, float scale, cudaStream_t stream) {
  using C = BwdDq<D, NC>;
  CUtensorMap tq, tdo, tk, tv;
  if (int e = tile_map(&tq, q, Lq, H, D, C::BQ)) return e;
  if (int e = tile_map(&tdo, dout, Lq, H, D, C::BQ)) return e;
  if (int e = tile_map(&tk, k, Lk, H, D, C::BK)) return e;
  if (int e = tile_map(&tv, v, Lk, H, D, C::BK)) return e;
  if (int e = set_smem(flash_bwd_wgmma_dq_kernel<D, NC>, C::SMEM)) return e;
  dim3 grid(H, (Lq + C::BQ - 1) / C::BQ);
  flash_bwd_wgmma_dq_kernel<D, NC><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tdo, tk, tv, lse, delta, dq, Lq, Lk, H, causal, q_off, k_off,
      stride, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int NC>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     float* dk, float* dv, int Lq, int Lk, int H, int causal,
                     int q_off, int k_off, int stride, float scale,
                     cudaStream_t stream) {
  using C = BwdDkv<D, NC>;
  CUtensorMap tq, tdo, tk, tv;
  if (int e = tile_map(&tq, q, Lq, H, D, C::BQ)) return e;
  if (int e = tile_map(&tdo, dout, Lq, H, D, C::BQ)) return e;
  if (int e = tile_map(&tk, k, Lk, H, D, C::BK)) return e;
  if (int e = tile_map(&tv, v, Lk, H, D, C::BK)) return e;
  if (int e = set_smem(flash_bwd_wgmma_dkv_kernel<D, NC>, C::SMEM)) return e;
  dim3 grid(H, (Lk + C::BK - 1) / C::BK);
  flash_bwd_wgmma_dkv_kernel<D, NC><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tdo, tk, tv, lse, delta, dk, dv, Lq, Lk, H, causal, q_off, k_off,
      stride, scale);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 kernels' shapes: D 64 or 128, any lengths; the side a block
// owns (dq's bq, dk/dv's bk) 64 or 128, the streamed side 64
inline bool shapes_ok_bf16(int which, int Lq, int Lk, int H, int D, int bq,
                           int bk, int stride) {
  const int own = which == 0 ? bq : bk, streamed = which == 0 ? bk : bq;
  const int L = which == 0 ? Lq : Lk;
  return Lq > 0 && Lk > 0 && H > 0 && (D == 64 || D == 128) &&
         (own == 64 || own == 128) && streamed == BWD_STREAM &&
         (L + own - 1) / own <= 65535 && stride >= 1;
}

}  // namespace flash

extern "C" {

// Dynamic shared memory of one dq (which 0) or dk/dv (which 1) block:
// the bf16 (wgmma) kernels' for in_bytes 2, the f32 kernels' for 4.
size_t flash_bwd_smem_bytes(int which, int in_bytes, int bq, int bk, int D) {
  if (in_bytes == 2)
    return which == 0 ? flash::smem_dq_bf16(bq, bk, D)
                      : flash::smem_dkv_bf16(bq, bk, D);
  return which == 0 ? flash::smem_dq(in_bytes, bq, bk, D)
                    : flash::smem_dkv(in_bytes, bq, bk, D);
}

// kind: 0 float32 (the scalar kernel; tiles multiples of 16 that divide
// the lengths), 1 bfloat16 (the wgmma kernel; tiles (64 or 128, 64), D
// 64 or 128, any lengths) for q, k, v and do.  lse, delta f32 [H, Lq];
// dq f32 [Lq, H, D].  Launches on ``stream`` and returns
// cudaGetLastError(); never synchronizes.
int flash_bwd_dq(int kind, const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 float* dq, int Lq, int Lk, int H, int D, int bq, int bk,
                 int causal, int q_off, int k_off, int stride, float scale,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    if (!flash::shapes_ok(Lq, Lk, H, D, bq, bk, stride))
      return static_cast<int>(cudaErrorInvalidValue);
    return flash::launch_dq<float>(q, k, v, dout, lse, delta, dq, Lq, Lk, H,
                                   D, bq, bk, causal, q_off, k_off, stride,
                                   scale, st);
  }
  if (kind != 1 || !flash::shapes_ok_bf16(0, Lq, Lk, H, D, bq, bk, stride))
    return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_DQ(DD, NC)                                                      \
  if (D == DD && bq == 64 * NC)                                               \
    return flash::launch_dq_wgmma<DD, NC>(q, k, v, dout, lse, delta, dq, Lq,  \
                                          Lk, H, causal, q_off, k_off,        \
                                          stride, scale, st);
  FLASH_DQ(128, 2)
  FLASH_DQ(128, 1)
  FLASH_DQ(64, 2)
  FLASH_DQ(64, 1)
#undef FLASH_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}

// As flash_bwd_dq; dk, dv f32 [Lk, H, D]; bf16 tiles (64, 64 or 128).
int flash_bwd_dkv(int kind, const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  float* dk, float* dv, int Lq, int Lk, int H, int D, int bq,
                  int bk, int causal, int q_off, int k_off, int stride,
                  float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    if (!flash::shapes_ok(Lq, Lk, H, D, bq, bk, stride))
      return static_cast<int>(cudaErrorInvalidValue);
    return flash::launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, Lq,
                                    Lk, H, D, bq, bk, causal, q_off, k_off,
                                    stride, scale, st);
  }
  if (kind != 1 || !flash::shapes_ok_bf16(1, Lq, Lk, H, D, bq, bk, stride))
    return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_DKV(DD, NC)                                                     \
  if (D == DD && bk == 64 * NC)                                               \
    return flash::launch_dkv_wgmma<DD, NC>(q, k, v, dout, lse, delta, dk, dv, \
                                           Lq, Lk, H, causal, q_off, k_off,   \
                                           stride, scale, st);
  FLASH_DKV(128, 2)
  FLASH_DKV(128, 1)
  FLASH_DKV(64, 2)
  FLASH_DKV(64, 1)
#undef FLASH_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
