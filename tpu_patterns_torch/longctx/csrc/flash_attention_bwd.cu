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
// float32 inputs the register-tiled FFMA ones (a tensor-core f32
// product would be TF32, which keeps ~3 digits).
//
// What bounds them on this card: operations.  Per visible (query, key)
// pair the dq kernel runs 3 products of 2*D flops (S, dP, dQ) and the
// dk/dv kernel 4 (S, dP, dV, dK); at D = 128 that is far above the
// ridge in either dtype (~295 flops/byte for the bf16 tensor cores, ~20
// for the 67 TFLOP/s of f32 FMA).
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
// f32 design (flash_bwd_dq_f32_kernel, flash_bwd_dkv_f32_kernel), for
// FFMA at its issue rate, on the f32 forward's pattern
// (flash_attention.cu):
//   * a block owns units of OWN rows (dq) or keys (dk/dv) of one head and
//     streams tiles of the other side, with 2D threads (256 at D 128,
//     128 at D 64): 32-entry units by tiles of D, or 64 by 64.  A
//     64-row unit by 128-key tiles would take 237 KB at D 128 (q, dO, k,
//     v and dS^T), over the 227 KB a block may have, so the larger
//     unit streams 64; the tiles fit in 149-202 KB at D 128 (one block
//     an SM) and 60-103 KB at D 64 (three or two);
//   * every product is FFMA from registers fed by 128-bit shared loads.
//     The score products (dq: S = Q K^T and dP = dO V^T; dk/dv: S^T = K
//     Q^T and dP^T = V dO^T) give a thread SR owned by 4 streamed
//     entries: a quarter warp reads one owned row (broadcast) and 8
//     streamed rows, padded by 4 floats so they fall in 8 bank groups.
//     P and dS are formed in those registers (exp as one ex2 of an FMA;
//     a dq thread holds its rows' lse and delta in registers, a dk/dv
//     tile's 2 x 64 or 2 x 128 values come in with its q) and go through
//     shared memory once a tile, each streamed entry's owned slots in a
//     row ([streamed][owned slot]), so the gradient products (dQ += dS
//     K; dV += P^T dO and dK += dS^T Q) read a thread's GR owned entries
//     as float4s beside one float4 of the streamed operand's row.  Each
//     gradient stays in registers across the walk, GR x 4 a thread (64
//     floats for dK and dV at 64 keys and D 128).  At 4 owned entries a
//     thread an FFMA costs 2 bytes of shared loads, at 8 1.5;
//   * staging by 16-byte cp.async into one buffer a tile, the products
//     ordered so that each tile is free before the next one lands: dq
//     runs dP (v), S (k), dS, dS K (k), so v-tile it + 1 loads while S,
//     dS and dS K of tile it run and k-tile it + 1 while its dP runs;
//     dk/dv runs dP^T (dO), S^T (q), P and dS, dV (dO), dK (q), so
//     dO-tile it + 1 loads during dK of tile it and q-tile it + 1 (with
//     its lse and delta) during its dP^T.  A unit's last tile stages
//     the next unit's own tiles as they come free.  Three barriers a
//     tile for dq, four for dk/dv;
//   * causal balance: a block takes two units, the heavier first (dq:
//     q-units n - 1 - p and p; dk/dv: k-units p and n - 1 - p), so a
//     causal triangle's blocks carry equal work and the diagonal shard
//     pair costs about half the full one; the grid is (heads, pairs).
//     The wrapper takes 64-entry units wherever their grid still holds
//     a block for every SM (tuning._auto_block), 32 elsewhere.  The
//     Python mirror of this walk is flash.py::bwd_f32_schedule;
//   * lengths need not be multiples of the tile: rows past Lq or Lk are
//     staged as zeros (and dk/dv's lse and delta past Lq as 0, so P dO
//     and dP vanish there), dq masks keys past Lk, and nothing past the
//     end is stored.  Only tiles that cross the diagonal or (dq) the
//     end of k are masked element by element; a unit with no live tile
//     stores zeros, and so does a dq row that sees no key.

#include <math.h>

#include <type_traits>

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace flash {

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

// -- f32: register-tiled FFMA with cp.async staging ------------------------

// The f32 backward's tiles and threads (see the design note above): a
// block owns units of OWN rows (dq) or keys (dk/dv) and streams tiles
// of STREAM keys (dq) or rows (dk/dv), with 2D threads.  Score thread
// (oy, sx), oy < NOY and sx < NSX, holds owned entries oy + NOY i (i <
// SR) by streamed entries sx + NSX j (j < 4) of S and dP (S^T and dP^T);
// gradient thread (ay, tx), ay < 8 and tx < D / 4, holds owned entries
// ay + 8 (g / SR + M (g % SR)) (g < GR) by columns 4 tx + e of each
// gradient.  A warp is 4 oy (ay) by 8 sx (tx).
template <int D, int OWN>
struct F32Bwd {
  static constexpr int STREAM = OWN == 64 ? 64 : D;  // keys (rows) a tile
  static constexpr int THREADS = 2 * D;               // 128 or 256
  static constexpr int NSX = STREAM / 4;
  static constexpr int NOY = THREADS / NSX;  // 8, or 16 at (D 128, OWN 64)
  static constexpr int SR = OWN / NOY;       // 4, or 8 at (D 64, OWN 64)
  static constexpr int NTX = D / 4;
  static constexpr int GR = OWN / 8;  // 4 or 8
  static constexpr int M = NOY / 8;   // score threads a gradient row set spans
  static constexpr int LDT = D + 4;   // [rows][D] tiles: 8 rows 16 B apart
  static constexpr int LDG = OWN + 4;  // P, dS ([streamed][owned slot])
  // blocks an SM holds: 1 at D 128; at D 64 as many as the registers a
  // thread needs leave: 3 of 32-entry units, 2 of 64
  static constexpr int MIN_BLOCKS = D == 128 ? 1 : OWN == 32 ? 3 : 2;
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  static_assert(OWN == 32 || OWN == 64, "units of 32 or 64");
  static_assert(M * SR == GR && NOY * SR == OWN, "tilings agree");
  // the first shared-memory slot of score thread oy's owned entries in a
  // [streamed][owned slot] row: gradient thread ay reads slots ay GR ..
  // ay GR + GR - 1, which hold those of score threads ay + 8 t (t < M)
  __device__ static int slot(int oy) { return (oy % 8) * GR + (oy / 8) * SR; }
};

// acc[i][j] = sum over d, in order, of own[oy + NOY i][d] str[sx + NSX
// j][d]: a quarter warp reads one owned row (broadcast) and 8 different
// streamed rows (8 bank groups), a float4 each, for 16 SR FFMAs a thread
template <class C, int D>
__device__ __forceinline__ void score_tile(float (&acc)[C::SR][4],
                                           const float* own, const float* str,
                                           int oy, int sx) {
#pragma unroll
  for (int i = 0; i < C::SR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int d0 = 0; d0 < D; d0 += 4) {
    float4 b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(str + (sx + C::NSX * j) * C::LDT +
                                              d0);
#pragma unroll
    for (int i = 0; i < C::SR; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(own + (oy + C::NOY * i) * C::LDT + d0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
      }
    }
  }
}

// acc[g][e] += sum over the tile's streamed entries s, in order, of
// g_s[s][gslot + g] t_s[s][4 tx + e]: GR / 4 float4s of the owned slots
// and one of the streamed operand's row, for 4 GR FFMAs a thread
template <class C>
__device__ __forceinline__ void grad_tile(float (&acc)[C::GR][4],
                                          const float* g_s, const float* t_s,
                                          int gslot, int tx) {
#pragma unroll 16
  for (int s = 0; s < C::STREAM; ++s) {
    float gv[C::GR];
    load_rows<C::GR>(gv, g_s + s * C::LDG + gslot);
    const float4 tv =
        *reinterpret_cast<const float4*>(t_s + s * C::LDT + 4 * tx);
#pragma unroll
    for (int g = 0; g < C::GR; ++g) {
      acc[g][0] = fmaf(gv[g], tv.x, acc[g][0]);
      acc[g][1] = fmaf(gv[g], tv.y, acc[g][1]);
      acc[g][2] = fmaf(gv[g], tv.z, acc[g][2]);
      acc[g][3] = fmaf(gv[g], tv.w, acc[g][3]);
    }
  }
}

// A gradient thread's GR x 4 sums, times `scale`, to rows base + ay + 8
// (g / SR + M (g % SR)) < L of out [L, H, D] (columns 4 tx + e)
template <class C, int D>
__device__ __forceinline__ void store_grad(const float (&acc)[C::GR][4],
                                           float* out, int base, int L, int H,
                                           int h, int ay, int tx,
                                           float scale) {
#pragma unroll
  for (int g = 0; g < C::GR; ++g) {
    const int r = base + ay + 8 * (g / C::SR + C::M * (g % C::SR));
    if (r < L)
      *reinterpret_cast<float4*>(out + (static_cast<size_t>(r) * H + h) * D +
                                 4 * tx) =
          make_float4(scale * acc[g][0], scale * acc[g][1], scale * acc[g][2],
                      scale * acc[g][3]);
  }
}

// FLASH_MARK dq phases: prologue, wait_v, dp, wait_k, s, ds, dq, epilogue
// FLASH_MARK dkv phases: prologue, wait_do, dp, wait_q, s, p_ds, dv, sync_dv, dk, epilogue
// (phase marks for scripts/flash_f32_phases.py; flash_common.cuh)

template <int D, int OWN>
__global__ void __launch_bounds__(F32Bwd<D, OWN>::THREADS,
                                  F32Bwd<D, OWN>::MIN_BLOCKS)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,  // [Lq, H, D]
                            const float* __restrict__ k,  // [Lk, H, D]
                            const float* __restrict__ v,  // [Lk, H, D]
                            const float* __restrict__ dout,  // [Lq, H, D]
                            const float* __restrict__ lse,  // [H, Lq]
                            const float* __restrict__ delta,  // [H, Lq]
                            float* __restrict__ dq,  // [Lq, H, D]
                            int Lq, int Lk, int H, int causal, int q_off,
                            int k_off, int stride, float scale) {
  using C = F32Bwd<D, OWN>;
  constexpr int BQ = OWN, BK = C::STREAM, NT = C::THREADS, SR = C::SR,
                GR = C::GR;
  FLASH_MARK_START;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv(smem);  // the regions of smem_dq_f32, in order
  float* q_s = cv.take<float>(BQ * C::LDT);
  float* do_s = cv.take<float>(BQ * C::LDT);
  float* k_s = cv.take<float>(BK * C::LDT);
  float* v_s = cv.take<float>(BK * C::LDT);
  float* ds_s = cv.take<float>(BK * C::LDG);  // dS^T: [key][row slot]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sx = (lane & 7) + 8 * (warp % (C::NSX / 8));
  const int oy = (lane >> 3) + 4 * (warp / (C::NSX / 8));
  const int tx = (lane & 7) + 8 * (warp % (C::NTX / 8));
  const int ay = (lane >> 3) + 4 * (warp / (C::NTX / 8));
  const int h = blockIdx.x;
  const int n_units = (Lq + BQ - 1) / BQ, nk = (Lk + BK - 1) / BK;
  const float c = scale * LOG2E;

  // this block's q-units: n_units - 1 - p, then p (the heavier first;
  // once for the middle unit of an odd count), each with its live tiles
  int unit[2], n_live[2], cnt = 0;
  for (int s = 0; s < 2; ++s) {
    const int u = s == 0 ? n_units - 1 - blockIdx.y : blockIdx.y;
    if (s == 1 && u == unit[0]) break;
    const long long q_last =
        q_off + static_cast<long long>(min((u + 1) * BQ, Lq) - 1) * stride;
    unit[cnt] = u;
    n_live[cnt++] = live_k_tiles(causal, q_last, k_off, stride, BK, nk);
  }
  auto next_live = [&](int s) {
    for (++s; s < cnt && n_live[s] == 0; ++s) {
    }
    return s;
  };
  auto load_q = [&](int u) {
    stage_rows<D, BQ, C::LDT, NT>(q_s, q, u * BQ, Lq, H, h);
  };
  auto load_do = [&](int u) {
    stage_rows<D, BQ, C::LDT, NT>(do_s, dout, u * BQ, Lq, H, h);
  };
  auto load_k = [&](int it) {
    stage_rows<D, BK, C::LDT, NT>(k_s, k, it * BK, Lk, H, h);
  };
  auto load_v = [&](int it) {
    stage_rows<D, BK, C::LDT, NT>(v_s, v, it * BK, Lk, H, h);
  };

  // One cp.async group ahead of the loop: the first live unit's q, dO
  // and v-tile 0.  Each k-tile then stages while its own dP runs, each
  // v-tile while the tile before runs S, dS and dS K; a unit's last tile
  // stages the next unit's dO and v-tile 0 once its dP is done, and its
  // q once its S is.
  if (next_live(-1) < cnt) {
    const int u = unit[next_live(-1)];
    load_q(u);
    load_do(u);
    load_v(0);
    cp_async_commit();
  }

  for (int s = 0; s < cnt; ++s) {
    const int row0 = unit[s] * BQ;
    const int n_tiles = n_live[s], ns = next_live(s);
    float acc[GR][4];
#pragma unroll
    for (int g = 0; g < GR; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
    // the score thread's rows: lse in log2 units, delta, position
    float nl[SR], dl[SR];
    long long q_pos[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int r = row0 + oy + C::NOY * i;
      const size_t at = static_cast<size_t>(h) * Lq + (r < Lq ? r : 0);
      nl[i] = r < Lq ? lse[at] * LOG2E : 0.f;
      dl[i] = r < Lq ? delta[at] : 0.f;
      q_pos[i] = q_off + static_cast<long long>(r) * stride;
    }
    const long long q_first = q_off + static_cast<long long>(row0) * stride;
    FLASH_MARK(0);

    for (int it = 0; it < n_tiles; ++it) {
      cp_async_wait<0>();  // v-tile it (a unit's first: and q, dO)
      __syncthreads();     // (A) v visible; k and dS^T read by all
      load_k(it);
      cp_async_commit();
      FLASH_MARK(1);
      float dp[SR][4];
      score_tile<C, D>(dp, do_s, v_s, oy, sx);  // dP = dO V^T
      FLASH_MARK(2);
      cp_async_wait<0>();  // k-tile it
      __syncthreads();     // (B) k visible; v and dO read by all
      if (it + 1 < n_tiles) {
        load_v(it + 1);
      } else if (ns < cnt) {
        load_do(unit[ns]);
        load_v(0);
      }
      cp_async_commit();  // perhaps empty: the group count stays in step
      FLASH_MARK(3);
      float sc[SR][4];
      score_tile<C, D>(sc, q_s, k_s, oy, sx);  // S = Q K^T
      FLASH_MARK(4);

      // P = exp(s - lse), 0 where masked (keys past Lk and, causal, keys
      // after the row; a tile below the unit's diagonal skips the test);
      // dS = P (dP - delta), to shared memory as each key's row slots
      const int col0 = it * BK;
      const bool masked =
          col0 + BK > Lk ||
          (causal && q_first < k_off + static_cast<long long>(col0 + BK - 1) *
                                           stride);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float col[SR];
#pragma unroll
        for (int i = 0; i < SR; ++i)
          col[i] = hopper::ex2(fmaf(sc[i][j], c, -nl[i]));
        if (masked) {
          const int key = col0 + sx + C::NSX * j;
          const long long k_pos = k_off + static_cast<long long>(key) * stride;
#pragma unroll
          for (int i = 0; i < SR; ++i)
            if (key >= Lk || (causal && q_pos[i] < k_pos)) col[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < SR; ++i) col[i] *= dp[i][j] - dl[i];
        store_rows<SR>(ds_s + (sx + C::NSX * j) * C::LDG + C::slot(oy), col);
      }
      __syncthreads();  // (C) dS^T visible; q read by all
      if (it + 1 == n_tiles && ns < cnt) {
        load_q(unit[ns]);
        cp_async_commit();
      }
      FLASH_MARK(5);
      grad_tile<C>(acc, ds_s, k_s, ay * GR, tx);  // dQ += dS K
      FLASH_MARK(6);
    }

    // dQ = scale (dS K); a row that sees no key stores 0
    store_grad<C, D>(acc, dq, row0, Lq, H, h, ay, tx, scale);
    FLASH_MARK(7);
  }
}

template <int D, int OWN>
__global__ void __launch_bounds__(F32Bwd<D, OWN>::THREADS,
                                  F32Bwd<D, OWN>::MIN_BLOCKS)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,  // [Lq, H, D]
                             const float* __restrict__ k,  // [Lk, H, D]
                             const float* __restrict__ v,  // [Lk, H, D]
                             const float* __restrict__ dout,  // [Lq, H, D]
                             const float* __restrict__ lse,  // [H, Lq]
                             const float* __restrict__ delta,  // [H, Lq]
                             float* __restrict__ dk,  // [Lk, H, D]
                             float* __restrict__ dv,  // [Lk, H, D]
                             int Lq, int Lk, int H, int causal, int q_off,
                             int k_off, int stride, float scale) {
  using C = F32Bwd<D, OWN>;
  constexpr int BK = OWN, BQ = C::STREAM, NT = C::THREADS, SR = C::SR,
                GR = C::GR;
  FLASH_MARK_START;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv(smem);  // the regions of smem_dkv_f32, in order
  float* k_s = cv.take<float>(BK * C::LDT);
  float* v_s = cv.take<float>(BK * C::LDT);
  float* q_s = cv.take<float>(BQ * C::LDT);
  float* do_s = cv.take<float>(BQ * C::LDT);
  float* p_s = cv.take<float>(BQ * C::LDG);   // P: [row][key slot]
  float* ds_s = cv.take<float>(BQ * C::LDG);  // dS: [row][key slot]
  float* lse_s = cv.take<float>(BQ);
  float* dl_s = cv.take<float>(BQ);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sx = (lane & 7) + 8 * (warp % (C::NSX / 8));
  const int oy = (lane >> 3) + 4 * (warp / (C::NSX / 8));
  const int tx = (lane & 7) + 8 * (warp % (C::NTX / 8));
  const int ay = (lane >> 3) + 4 * (warp / (C::NTX / 8));
  const int h = blockIdx.x;
  const int n_units = (Lk + BK - 1) / BK, nq = (Lq + BQ - 1) / BQ;
  const float c = scale * LOG2E;

  // this block's k-units: p, then n_units - 1 - p (the first keys see
  // the most rows: the heavier first), each with its first live q-tile
  int unit[2], first[2], cnt = 0;
  for (int s = 0; s < 2; ++s) {
    const int u = s == 0 ? blockIdx.y : n_units - 1 - blockIdx.y;
    if (s == 1 && u == unit[0]) break;
    unit[cnt] = u;
    first[cnt++] = first_q_tile(
        causal, k_off + static_cast<long long>(u) * BK * stride, q_off,
        stride, BQ, Lq);
  }
  auto next_live = [&](int s) {
    for (++s; s < cnt && first[s] >= nq; ++s) {
    }
    return s;
  };
  auto load_k = [&](int u) {
    stage_rows<D, BK, C::LDT, NT>(k_s, k, u * BK, Lk, H, h);
  };
  auto load_v = [&](int u) {
    stage_rows<D, BK, C::LDT, NT>(v_s, v, u * BK, Lk, H, h);
  };
  auto load_do = [&](int it) {
    stage_rows<D, BQ, C::LDT, NT>(do_s, dout, it * BQ, Lq, H, h);
  };
  // q-tile it and its rows' lse and delta (0 past Lq, where q and dO are
  // 0 too, so P dO and dP vanish there)
  auto load_q = [&](int it) {
    stage_rows<D, BQ, C::LDT, NT>(q_s, q, it * BQ, Lq, H, h);
    const int t = threadIdx.x;
    if (t < 2 * BQ) {
      const int r = it * BQ + t % BQ;
      const float* src = (t < BQ ? lse : delta) + static_cast<size_t>(h) * Lq;
      cp_async4((t < BQ ? lse_s : dl_s) + t % BQ, src + (r < Lq ? r : 0),
                r < Lq ? 4u : 0u);
    }
  };

  // One cp.async group ahead of the loop: the first live unit's k and v
  // and its first dO-tile.  Each q-tile then stages while its own dP^T
  // runs, each dO-tile while the tile before runs dK; a unit's last tile
  // stages the next unit's v once its dP^T is done and its k once its
  // S^T is.
  if (next_live(-1) < cnt) {
    const int s0 = next_live(-1);
    load_k(unit[s0]);
    load_v(unit[s0]);
    load_do(first[s0]);
    cp_async_commit();
  }

  for (int s = 0; s < cnt; ++s) {
    const int col0 = unit[s] * BK;
    const int ns = next_live(s);
    float dk_acc[GR][4], dv_acc[GR][4];
#pragma unroll
    for (int g = 0; g < GR; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[g][e] = dv_acc[g][e] = 0.f;
    long long k_pos[SR];  // the score thread's keys
#pragma unroll
    for (int i = 0; i < SR; ++i)
      k_pos[i] = k_off + static_cast<long long>(col0 + oy + C::NOY * i) * stride;
    const long long k_last =
        k_off + static_cast<long long>(col0 + BK - 1) * stride;
    FLASH_MARK(0);

    for (int it = first[s]; it < nq; ++it) {
      cp_async_wait<0>();  // dO-tile it (a unit's first: and k, v)
      __syncthreads();     // (a) dO visible; q, P and dS read by all
      load_q(it);
      cp_async_commit();
      FLASH_MARK(1);
      float dp[SR][4];
      score_tile<C, D>(dp, v_s, do_s, oy, sx);  // dP^T = V dO^T
      FLASH_MARK(2);
      cp_async_wait<0>();  // q-tile it with its lse and delta
      __syncthreads();     // (b) q visible; v read by all
      if (it + 1 == nq && ns < cnt) {
        load_v(unit[ns]);
        cp_async_commit();
      }
      FLASH_MARK(3);
      float sc[SR][4];
      score_tile<C, D>(sc, k_s, q_s, oy, sx);  // S^T = K Q^T
      FLASH_MARK(4);

      // P^T = exp(s - lse), 0 where the row precedes the key (a tile
      // whose first row sees the unit's last key skips the test); dS^T =
      // P^T (dP^T - delta); both to shared memory as each row's key slots
      const int row0 = it * BQ;
      const bool masked =
          causal && q_off + static_cast<long long>(row0) * stride < k_last;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rr = sx + C::NSX * j;
        const float nl = lse_s[rr] * LOG2E, dl = dl_s[rr];
        float p[SR], ds[SR];
#pragma unroll
        for (int i = 0; i < SR; ++i) p[i] = hopper::ex2(fmaf(sc[i][j], c, -nl));
        if (masked) {
          const long long q_pos =
              q_off + static_cast<long long>(row0 + rr) * stride;
#pragma unroll
          for (int i = 0; i < SR; ++i)
            if (q_pos < k_pos[i]) p[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < SR; ++i) ds[i] = p[i] * (dp[i][j] - dl);
        store_rows<SR>(p_s + rr * C::LDG + C::slot(oy), p);
        store_rows<SR>(ds_s + rr * C::LDG + C::slot(oy), ds);
      }
      __syncthreads();  // (c) P and dS visible; k read by all
      if (it + 1 == nq && ns < cnt) {
        load_k(unit[ns]);
        cp_async_commit();
      }
      FLASH_MARK(5);
      grad_tile<C>(dv_acc, p_s, do_s, ay * GR, tx);  // dV += P^T dO
      FLASH_MARK(6);
      __syncthreads();  // (d) dO read by all
      if (it + 1 < nq) {
        load_do(it + 1);
      } else if (ns < cnt) {
        load_do(first[ns]);
      }
      cp_async_commit();  // perhaps empty: the group count stays in step
      FLASH_MARK(7);
      grad_tile<C>(dk_acc, ds_s, q_s, ay * GR, tx);  // dK += dS^T Q
      FLASH_MARK(8);
    }

    // dK = scale (dS^T Q), dV; a key that no row sees stores 0
    store_grad<C, D>(dk_acc, dk, col0, Lk, H, h, ay, tx, scale);
    store_grad<C, D>(dv_acc, dv, col0, Lk, H, h, ay, tx, 1.f);
    FLASH_MARK(9);
  }
}

template <int D, int OWN>
int launch_dq_f32(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  float* dq, int Lq, int Lk, int H, int causal, int q_off,
                  int k_off, int stride, float scale, cudaStream_t stream) {
  using C = F32Bwd<D, OWN>;
  auto kernel = flash_bwd_dq_f32_kernel<D, OWN>;
  constexpr size_t smem = smem_dq_f32(OWN, C::STREAM, D);
  if (int e = set_smem_f32(kernel, smem)) return e;
  const int units = (Lq + OWN - 1) / OWN;
  dim3 grid(H, (units + 1) / 2);  // a block a pair of q-units
  kernel<<<grid, C::THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, dq, Lq, Lk, H, causal, q_off, k_off, stride, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int OWN>
int launch_dkv_f32(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   float* dk, float* dv, int Lq, int Lk, int H, int causal,
                   int q_off, int k_off, int stride, float scale,
                   cudaStream_t stream) {
  using C = F32Bwd<D, OWN>;
  auto kernel = flash_bwd_dkv_f32_kernel<D, OWN>;
  constexpr size_t smem = smem_dkv_f32(C::STREAM, OWN, D);
  if (int e = set_smem_f32(kernel, smem)) return e;
  const int units = (Lk + OWN - 1) / OWN;
  dim3 grid(H, (units + 1) / 2);  // a block a pair of k-units
  kernel<<<grid, C::THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, dk, dv, Lq, Lk, H, causal, q_off, k_off, stride, scale);
  return static_cast<int>(cudaGetLastError());
}

// the f32 kernels' shapes: D 64 or 128, any lengths; the side a block
// owns (dq's bq, dk/dv's bk) 32 or 64, the streamed side D beside 32
// and 64 beside 64
inline bool shapes_ok_f32(int which, int Lq, int Lk, int H, int D, int bq,
                          int bk, int stride) {
  const int own = which == 0 ? bq : bk, streamed = which == 0 ? bk : bq;
  const int L = which == 0 ? Lq : Lk;
  return Lq > 0 && Lk > 0 && H > 0 && (D == 64 || D == 128) &&
         (own == 32 || own == 64) && streamed == (own == 64 ? 64 : D) &&
         ((L + own - 1) / own + 1) / 2 <= 65535 && stride >= 1;
}


}  // namespace flash

extern "C" {

// Dynamic shared memory of one dq (which 0) or dk/dv (which 1) block:
// the bf16 (wgmma) kernels' for in_bytes 2, the f32 kernels' for 4.
size_t flash_bwd_smem_bytes(int which, int in_bytes, int bq, int bk, int D) {
  if (in_bytes == 2)
    return which == 0 ? flash::smem_dq_bf16(bq, bk, D)
                      : flash::smem_dkv_bf16(bq, bk, D);
  return which == 0 ? flash::smem_dq_f32(bq, bk, D)
                    : flash::smem_dkv_f32(bq, bk, D);
}

// kind: 0 float32 (the register-tiled FFMA kernel; tiles (32, D) or (64,
// 64)), 1 bfloat16 (the wgmma kernel; tiles (64 or 128, 64)) for q, k, v
// and do; D 64 or 128, any lengths.  lse, delta f32 [H, Lq]; dq f32 [Lq,
// H, D].  Launches on ``stream`` and returns cudaGetLastError(); never
// synchronizes.
int flash_bwd_dq(int kind, const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 float* dq, int Lq, int Lk, int H, int D, int bq, int bk,
                 int causal, int q_off, int k_off, int stride, float scale,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    if (!flash::shapes_ok_f32(0, Lq, Lk, H, D, bq, bk, stride))
      return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_DQ_F32(DD, OWN)                                                 \
  if (D == DD && bq == OWN)                                                   \
    return flash::launch_dq_f32<DD, OWN>(q, k, v, dout, lse, delta, dq, Lq,   \
                                         Lk, H, causal, q_off, k_off, stride, \
                                         scale, st);
    FLASH_DQ_F32(128, 64)
    FLASH_DQ_F32(128, 32)
    FLASH_DQ_F32(64, 64)
    FLASH_DQ_F32(64, 32)
#undef FLASH_DQ_F32
    return static_cast<int>(cudaErrorInvalidValue);
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

// As flash_bwd_dq; dk, dv f32 [Lk, H, D]; f32 tiles (D, 32) or (64, 64),
// bf16 (64, 64 or 128).
int flash_bwd_dkv(int kind, const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  float* dk, float* dv, int Lq, int Lk, int H, int D, int bq,
                  int bk, int causal, int q_off, int k_off, int stride,
                  float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    if (!flash::shapes_ok_f32(1, Lq, Lk, H, D, bq, bk, stride))
      return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_DKV_F32(DD, OWN)                                                \
  if (D == DD && bk == OWN)                                                   \
    return flash::launch_dkv_f32<DD, OWN>(q, k, v, dout, lse, delta, dk, dv,  \
                                          Lq, Lk, H, causal, q_off, k_off,    \
                                          stride, scale, st);
    FLASH_DKV_F32(128, 64)
    FLASH_DKV_F32(128, 32)
    FLASH_DKV_F32(64, 64)
    FLASH_DKV_F32(64, 32)
#undef FLASH_DKV_F32
    return static_cast<int>(cudaErrorInvalidValue);
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
