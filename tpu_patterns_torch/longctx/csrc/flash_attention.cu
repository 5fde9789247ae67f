// Fused flash-attention forward for Hopper (sm_90a): K2 and K3.
//
// Replaces, in tpu_patterns/longctx/flash.py,
//   * flash_block's _block_kernel (:591) and _block_kernel_compact (:639)
//     -- K3: emits the unnormalized (o f32 [Lq, H, D], m, l f32 [H, Lq]);
//   * flash_attention's _kernel (:135) and _kernel_compact (:840)
//     -- K2: normalizes (o / l, l == 0 -> 1) and casts to q's dtype.
// One kernel with a runtime epilogue switch (emit_stats) gives both.
// The dispatch is by dtype: bfloat16 inputs run flash_fwd_wgmma_kernel,
// float32 inputs flash_fwd_f32_kernel, on the FMA units (a tensor-core
// f32 product would be TF32, which keeps ~3 digits).
//
// What bounds it on this card: operations.  Per (head, q-tile) it reads
// q once and each visible k/v tile once, and does 4*D flops per visible
// (query, key) pair; at D = 128 that is far above the H100's ridge in
// either dtype (~295 flops/byte for the bf16 tensor cores, ~20 for the
// 67 TFLOP/s of f32 FMA), so the arithmetic rate is the bound.
//
// bf16 design (flash_fwd_wgmma_kernel), built from the card's own units:
//   * a block is one (head, q-tile of 64 * NC rows): NC consumer
//     warpgroups of 64 rows each and one producer warpgroup, whose
//     first thread issues every load;
//   * loads are TMA boxes [rows, 1, 64] of the 3-D tensors [L, H, D]
//     (tensor maps made per launch), 128-byte swizzled: q once per
//     block, k and v tiles each through a ring of STAGES slots (2 at D
//     128, 4 at D 64) behind their own full/free mbarriers, so the next
//     tiles are in flight while the consumers compute;
//   * S = Q K^T is wgmma with both operands in shared memory and S in
//     registers; the online softmax runs on those registers (row max
//     and sum over the quad of threads that share a row, by shuffles,
//     exp as one ex2 of an FMA); P is rounded to bf16 in registers and
//     is the register A operand of O += P V (V the transposed shared
//     operand); O stays in registers across the k loop and alpha
//     rescales it there.  No S, P or O goes through shared memory;
//   * inside a warpgroup the products of tile it and the P V of tile
//     it - 1 are issued together, and the softmax of tile it runs while
//     that P V is on the tensor cores; the two consumer warpgroups
//     overlap each other's softmax and products as well.  A product
//     reads its register operand while it runs, and ptxas serializes
//     every product of the kernel (C7513) if any instruction writes
//     such a register before the product is waited for: so the softmax
//     works on the f32 scores in place and P is packed only after the
//     wait for the P V that read the previous P, and the first product
//     of S takes S as a write-only operand;
//   * causal: the block visits its live k-tiles only (it stops at the
//     first tile wholly above its last row), a warpgroup skips a tile
//     wholly above its own rows, and only tiles that cross the diagonal
//     (or the ragged end of k) are masked element by element; the grid
//     is (heads, q-tiles) with the last, heaviest q-tiles first, so the
//     triangle's long blocks start in the first wave;
//   * lengths need not be multiples of the tile: TMA fills rows past
//     the end with zeros, columns past Lk are masked, rows past Lq are
//     not stored;
//   * no atomics: each output element has one owner, and the k-tiles
//     are summed in ascending order, so two runs give the same bits.
//
// f32 design (flash_fwd_f32_kernel), for FFMA at its issue rate:
//   * a block owns q-units of 8 RT rows of one head (RT = 4 or 8 rows a
//     thread) and walks their live k-tiles of D keys in ascending order,
//     with 2D threads (128 at D 64, 256 at D 128): thread (ty, tx), ty <
//     8 and tx < D / 4, holds the scores of rows ty + 8i and keys tx +
//     (D / 4) j (RT x 4) and the output of the same rows at columns 4tx +
//     e (RT x 4) in registers across the whole k loop, and alpha rescales
//     them there;
//   * both products are FFMA from registers fed by 128-bit shared loads:
//     S = Q K^T reads a float4 of D from each of its RT q rows and 4 k
//     rows (16 RT FFMA a step), P V a float4 of P for each 4 of its rows
//     and one of V a key (4 RT FFMA).  A warp is 4 ty by 8 tx; rows of q
//     and k are padded by 4 floats, so the 8 rows a warp reads at once
//     fall in 8 different 16-byte bank groups: every shared read is one
//     pass.  Each FFMA costs a thread 2 bytes of shared loads at RT 4,
//     1.5 at RT 8, against the 1 an SM can feed at the FFMA rate: so the
//     wrapper takes RT 8 (64-row units) wherever their grid still holds
//     a block for every SM (tuning._auto_block), RT 4 (32 rows) elsewhere;
//   * the row max reduces by shuffles over the 8 lanes of a warp that
//     share a row, then over the row's D / 32 warps through shared memory
//     behind a named barrier of those warps alone; l stays a per-thread
//     partial, summed over the row once at the end; P goes through
//     shared memory once a tile, transposed ([key][row]), so P V reads a
//     thread's rows as float4s;
//   * k and v tiles are staged by 16-byte cp.async into one k and one v
//     buffer, a ring of two: k-tile it + 1 loads while tile it's P V
//     runs, v-tile it while its S and softmax run, and a unit's last
//     tile stages the next unit's q, k and v.  At D 128 one block of 8
//     warps fills an SM (166 or 199 KB of shared memory); at D 64 two or
//     three blocks of 4 warps share it;
//   * causal balance: a block takes two q-units, n - 1 - p and p (the
//     heavier first), so a causal triangle's blocks carry equal work and
//     the diagonal shard pair costs about half the full one; the grid is
//     (heads, pairs), the pairs holding the heaviest units first.  One
//     launch, no atomics: each output element has one owner, its keys
//     summed in ascending order, so two runs give the same bits;
//   * lengths need not be multiples of the tile: rows past Lq or Lk are
//     staged as zeros, keys past Lk are masked, rows past Lq are not
//     stored.  Only tiles that cross the diagonal or the end of k are
//     masked element by element.
//
// Math as the Pallas _online_step: s = (q . k) * scale, masked to
// NEG_INF = -1e30 where q_pos < k_pos; m_cur = max(m_prev, max s);
// p = exp(s - m_cur) * (m_cur > NEG_INF / 2); alpha = exp(m_prev - m_cur);
// l = alpha * l + sum p (p unrounded); acc = alpha * acc + round(p) . v.

#include <math.h>

#include <type_traits>

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace flash {

// -- f32: register-tiled FFMA with cp.async staging ------------------------

// The f32 forward's tile and threads (see the design note above): thread
// (ty, tx), ty < 8 and tx < D / 4, holds RT rows by 4 keys of S and RT
// rows by 4 columns of O, so a q-unit has 8 RT rows and a k-tile D keys.
template <int D, int RT>
struct F32Fwd {
  static constexpr int BQ = 8 * RT;  // rows of a q-unit: 32 or 64
  static constexpr int BK = D;       // keys of a k-tile
  static constexpr int NTX = BK / 4;  // 16 or 32
  static constexpr int THREADS = 8 * NTX;  // 128 or 256
  static constexpr int KW = NTX / 8;  // warps that share a row: 2 or 4
  static constexpr int LDQ = D + 4;  // padded rows: 8 rows 16 B apart mod
  static constexpr int LDK = D + 4;  // 128 B, so 8 rows read in one pass
  static constexpr int LDV = D;      // a key's row is read whole
  static constexpr int LDP = BQ + 4;
  static constexpr size_t SMEM = smem_fwd(BQ, BK, D);
  // blocks an SM holds: 1 at D 128 (166 or 199 KB); at D 64 (51 or 68
  // KB) as many as the registers a thread needs leave: 3 at 4 rows, 2 at 8
  static constexpr int MIN_BLOCKS = D == 128 ? 1 : RT == 4 ? 3 : 2;
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  static_assert(RT == 4 || RT == 8, "4 or 8 rows a thread");
};

// FLASH_MARK phases: prologue, qk, max_exchange, softmax, wait_v, pv, wait_k, epilogue
// (phase marks for scripts/flash_f32_phases.py; flash_common.cuh)

template <int D, int RT>
__global__ void __launch_bounds__(F32Fwd<D, RT>::THREADS,
                                  F32Fwd<D, RT>::MIN_BLOCKS)
    flash_fwd_f32_kernel(const float* __restrict__ q,  // [Lq, H, D]
                         const float* __restrict__ k,  // [Lk, H, D]
                         const float* __restrict__ v,  // [Lk, H, D]
                         void* __restrict__ o_out,  // [Lq, H, D] f32
                         float* __restrict__ m_out,  // [H, Lq] (stats only)
                         float* __restrict__ l_out,  // [H, Lq] (stats only)
                         int Lq, int Lk, int H, int causal, int q_off,
                         int k_off, int stride, float scale, int emit_stats) {
  using C = F32Fwd<D, RT>;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::THREADS, NTX = C::NTX,
                KW = C::KW;
  FLASH_MARK_START;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv(smem);  // the regions of smem_fwd, in order
  float* q_s = cv.take<float>(BQ * C::LDQ);
  float* k_s = cv.take<float>(BK * C::LDK);
  float* v_s = cv.take<float>(BK * C::LDV);
  float* p_s = cv.take<float>(BK * C::LDP);  // P^T: [key][row slot]
  float* red = cv.take<float>(KW * BQ);   // row max of each warp's keys
  float* lred = cv.take<float>(KW * BQ);  // row sum of each warp's keys

  // thread (ty, tx): rows ty + 8i, keys tx + NTX j of a k-tile, output
  // columns 4tx + e, and row slots ty RT + i in P and the exchanges; a
  // warp is 4 ty by 8 tx, so a row's keys lie in KW warps (its row
  // group, 1 + warp / KW), and a warp's shared reads of q, k, p and v
  // are each one pass
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = 4 * (warp / KW) + (lane >> 3);
  const int kw = warp % KW, tx = 8 * kw + (lane & 7);
  const int slot = ty * RT;
  const int h = blockIdx.x;
  const int n_units = (Lq + BQ - 1) / BQ, nk = (Lk + BK - 1) / BK;

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
    stage_rows<D, BQ, C::LDQ, NT>(q_s, q, u * BQ, Lq, H, h);
  };
  auto load_k = [&](int it) {
    stage_rows<D, BK, C::LDK, NT>(k_s, k, it * BK, Lk, H, h);
  };
  auto load_v = [&](int it) {
    stage_rows<D, BK, C::LDV, NT>(v_s, v, it * BK, Lk, H, h);
  };

  // Two cp.async groups ahead of the loop: q and k-tile 0, then v-tile
  // 0.  Each k-tile then stages while the tile before runs its P V, each
  // v-tile while its own S and softmax run; a unit's last tile stages
  // the next unit's q and first tiles.
  if (next_live(-1) < cnt) {
    load_q(unit[next_live(-1)]);
    load_k(0);
    cp_async_commit();
    load_v(0);
    cp_async_commit();
  }

  for (int s = 0; s < cnt; ++s) {
    const int row0 = unit[s] * BQ;
    float o[RT][4];
    float m[RT], l[RT];
    long long q_pos[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
      q_pos[i] = q_off + static_cast<long long>(row0 + ty + 8 * i) * stride;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[i][c] = 0.f;
    }
    const int n_tiles = n_live[s], ns = next_live(s);
    const long long q_first = q_off + static_cast<long long>(row0) * stride;
    if (n_tiles > 0) {
      cp_async_wait<1>();  // q and k-tile 0 (v-tile 0 may be in flight)
      __syncthreads();
    }
    FLASH_MARK(0);

    for (int it = 0; it < n_tiles; ++it) {
      // S = Q K^T: RT x 4 scores a thread, summed over D in order
      float sc[RT][4];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 4) {
        float4 kf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kf[j] = *reinterpret_cast<const float4*>(
              k_s + (tx + NTX * j) * C::LDK + d0);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float4 qf = *reinterpret_cast<const float4*>(
              q_s + (ty + 8 * i) * C::LDQ + d0);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = fmaf(qf.x, kf[j].x, sc[i][j]);
            sc[i][j] = fmaf(qf.y, kf[j].y, sc[i][j]);
            sc[i][j] = fmaf(qf.z, kf[j].z, sc[i][j]);
            sc[i][j] = fmaf(qf.w, kf[j].w, sc[i][j]);
          }
        }
      }
      FLASH_MARK(1);

      // scale, then mask to NEG_INF: keys past Lk, and (causal) keys
      // after the row; a tile below the unit's diagonal skips the test
      const int col0 = it * BK;
      const bool masked =
          col0 + BK > Lk ||
          (causal && q_first < k_off + static_cast<long long>(col0 + BK - 1) *
                                           stride);
      float mx[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        mx[i] = NEG_INF;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = sc[i][j] * scale;
          if (masked) {
            const int key = col0 + tx + NTX * j;
            if (key >= Lk ||
                (causal &&
                 q_pos[i] < k_off + static_cast<long long>(key) * stride))
              x = NEG_INF;
          }
          sc[i][j] = x;
          mx[i] = fmaxf(mx[i], x);
        }
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 4));
      }
      if ((lane & 7) == 0) store_rows<RT>(red + kw * BQ + slot, mx);
      // (A) the KW warps of these rows only (named barrier 1 or 2)
      hopper::named_sync(1 + warp / KW, 32 * KW);
      FLASH_MARK(2);

      // the online softmax (Pallas _online_step): m <- max(m, tile max);
      // p = exp(s - m), 0 while the row has seen no key (keep); l <-
      // alpha l + sum p (this thread's keys; summed over the row at the
      // end); P to shared memory unrounded
      float tmax[RT], alpha[RT];
      load_rows<RT>(tmax, red + slot);
#pragma unroll
      for (int w = 1; w < KW; ++w) {
        float other[RT];
        load_rows<RT>(other, red + w * BQ + slot);
#pragma unroll
        for (int i = 0; i < RT; ++i) tmax[i] = fmaxf(tmax[i], other[i]);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float m_cur = fmaxf(m[i], tmax[i]);
        alpha[i] = hopper::ex2((m[i] - m_cur) * LOG2E);
        m[i] = m_cur;
        const bool keep = m_cur > NEG_INF * 0.5f;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = keep ? hopper::ex2((sc[i][j] - m_cur) * LOG2E) : 0.f;
          sc[i][j] = p;
          sum += p;
        }
        l[i] = alpha[i] * l[i] + sum;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float col[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) col[i] = sc[i][j];
        store_rows<RT>(p_s + (tx + NTX * j) * C::LDP + slot, col);
      }
      FLASH_MARK(3);
      cp_async_wait<0>();  // v-tile it
      __syncthreads();     // (B) P and v visible to all; k (and q) read
      if (it + 1 < n_tiles) {
        load_k(it + 1);
      } else if (ns < cnt) {
        load_q(unit[ns]);
        load_k(0);
      }
      cp_async_commit();  // perhaps empty: the group count stays in step
      FLASH_MARK(4);

      // O = alpha O + P V, over the tile's keys in order
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[i][c] *= alpha[i];
#pragma unroll 16
      for (int kk = 0; kk < BK; ++kk) {
        float pv[RT];
        load_rows<RT>(pv, p_s + kk * C::LDP + slot);
        const float4 vv =
            *reinterpret_cast<const float4*>(v_s + kk * C::LDV + 4 * tx);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          o[i][0] = fmaf(pv[i], vv.x, o[i][0]);
          o[i][1] = fmaf(pv[i], vv.y, o[i][1]);
          o[i][2] = fmaf(pv[i], vv.z, o[i][2]);
          o[i][3] = fmaf(pv[i], vv.w, o[i][3]);
        }
      }
      FLASH_MARK(5);
      cp_async_wait<0>();  // the next k-tile (and q)
      __syncthreads();     // (C) v and P read by all
      if (it + 1 < n_tiles) {
        load_v(it + 1);
      } else if (ns < cnt) {
        load_v(0);
      }
      cp_async_commit();
      FLASH_MARK(6);
    }

    // the row sums: this thread's, then the 8 lanes of its warp, then
    // the KW warps in order (a fixed order: the same bits every run)
    if (n_tiles > 0) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
      }
      if ((lane & 7) == 0) store_rows<RT>(lred + kw * BQ + slot, l);
      __syncthreads();
      load_rows<RT>(l, lred + slot);
#pragma unroll
      for (int w = 1; w < KW; ++w) {
        float other[RT];
        load_rows<RT>(other, lred + w * BQ + slot);
#pragma unroll
        for (int i = 0; i < RT; ++i) l[i] += other[i];
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = row0 + ty + 8 * i;
      if (r >= Lq) continue;
      float* row = static_cast<float*>(o_out) +
                   (static_cast<size_t>(r) * H + h) * D + 4 * tx;
      // K3 keeps o unnormalized (x / 1 is exact); K2: o / l, l == 0 -> 1
      const float den = emit_stats || l[i] == 0.f ? 1.f : l[i];
      *reinterpret_cast<float4*>(row) =
          make_float4(o[i][0] / den, o[i][1] / den, o[i][2] / den,
                      o[i][3] / den);
      if (emit_stats && tx == 0) {
        m_out[static_cast<size_t>(h) * Lq + r] = m[i];
        l_out[static_cast<size_t>(h) * Lq + r] = l[i];
      }
    }
    FLASH_MARK(7);
  }
}

template <int D, int RT>
int launch_f32(int emit_stats, const void* q, const void* k, const void* v,
               void* o, float* m, float* l, int Lq, int Lk, int H,
               int causal, int q_off, int k_off, int stride, float scale,
               cudaStream_t stream) {
  using C = F32Fwd<D, RT>;
  auto kernel = flash_fwd_f32_kernel<D, RT>;
  if (int e = set_smem_f32(kernel, C::SMEM)) return e;
  const int units = (Lq + C::BQ - 1) / C::BQ;
  dim3 grid(H, (units + 1) / 2);  // a block a pair of q-units
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), o, m, l, Lq, Lk, H, causal, q_off, k_off,
      stride, scale, emit_stats);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32_rows(int bq, int emit_stats, const void* q, const void* k,
                    const void* v, void* o, float* m, float* l, int Lq,
                    int Lk, int H, int causal, int q_off, int k_off,
                    int stride, float scale, cudaStream_t st) {
  return bq == 64 ? launch_f32<D, 8>(emit_stats, q, k, v, o, m, l, Lq, Lk, H,
                                     causal, q_off, k_off, stride, scale, st)
                  : launch_f32<D, 4>(emit_stats, q, k, v, o, m, l, Lq, Lk, H,
                                     causal, q_off, k_off, stride, scale, st);
}

// the f32 kernel's shapes: D 64 or 128, a tile (32 or 64, D), any lengths
inline bool shapes_ok_f32(int Lq, int Lk, int H, int D, int bq, int bk,
                          int stride) {
  return Lq > 0 && Lk > 0 && H > 0 && (D == 64 || D == 128) &&
         (bq == 32 || bq == 64) && bk == D &&
         ((Lq + bq - 1) / bq + 1) / 2 <= 65535 && stride >= 1;
}


// -- bf16: wgmma with TMA loads --------------------------------------------

constexpr size_t FWD_BAR_BYTES = 256;  // 1 + 4 * STAGES mbarriers

// K/V ring depth: 128 KB of k and v tiles in flight at bk 128 either way
__host__ __device__ constexpr int fwd_stages(int D) { return D <= 64 ? 4 : 2; }

// Dynamic shared memory of one bf16 forward block: slack to align the
// swizzled tiles to 1024 bytes, the q tile, the ring's k and v tiles and
// the mbarriers (tuning.py::smem_bytes agrees).
__host__ __device__ constexpr size_t smem_fwd_bf16(int bq, int bk, int D) {
  return 1024 + static_cast<size_t>(bq) * D * 2 +
         static_cast<size_t>(fwd_stages(D)) * 2 * bk * D * 2 + FWD_BAR_BYTES;
}

template <int D, int BK, int NC>
struct Fwd {
  static constexpr int BQ = 64 * NC;  // 64 query rows per warpgroup
  static constexpr int STAGES = fwd_stages(D);
  static constexpr int THREADS = 128 * (NC + 1);  // + the producer
  static constexpr int CHUNKS = D / 64;  // 128-byte swizzled column blocks
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr uint32_t T_BYTES = BK * D * 2;  // one k or v tile
  static constexpr size_t SMEM = smem_fwd_bf16(BQ, BK, D);
  static_assert((1 + 4 * STAGES) * 8 <= FWD_BAR_BYTES, "mbarriers");
};

// max / sum over the four threads that hold one accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The online-softmax state of a consumer thread's two rows (a: row ra,
// b: row rb = ra + 8).  l is this thread's part of the row sum.
struct Rows {
  float m_a, m_b, l_a, l_b;
};

// One tile's online softmax on the raw scores S (q . k, masked to
// -inf), in registers, in place: m <- max(m, scale * max S); S <- p =
// exp(scale * S - m), 0 for a row whose m is still NEG_INF (the keep
// factor: its offset is 0 and every score -inf); l <- alpha l + sum p.
// Returns alpha = exp(m_prev - m) of both rows.
template <int BK>
__device__ __forceinline__ float2 online_softmax(float (&sc)[BK / 2], Rows& r,
                                                 float scale) {
  float mx_a[4], mx_b[4];  // four independent partial maxima per row
#pragma unroll
  for (int i = 0; i < 4; ++i) mx_a[i] = mx_b[i] = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx_a[j % 4] = fmaxf(mx_a[j % 4], fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx_b[j % 4] = fmaxf(mx_b[j % 4], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  const float tile_a = quad_max(fmaxf(fmaxf(mx_a[0], mx_a[1]),
                                      fmaxf(mx_a[2], mx_a[3])));
  const float tile_b = quad_max(fmaxf(fmaxf(mx_b[0], mx_b[1]),
                                      fmaxf(mx_b[2], mx_b[3])));
  // the rounded max of the scaled scores is the max of the rounded ones
  const float mc_a = fmaxf(r.m_a, tile_a * scale);
  const float mc_b = fmaxf(r.m_b, tile_b * scale);
  const float2 alpha = make_float2(hopper::ex2((r.m_a - mc_a) * LOG2E),
                                   hopper::ex2((r.m_b - mc_b) * LOG2E));
  r.m_a = mc_a;
  r.m_b = mc_b;
  const float c = scale * LOG2E;
  const float off_a = mc_a > NEG_INF * 0.5f ? mc_a * LOG2E : 0.f;
  const float off_b = mc_b > NEG_INF * 0.5f ? mc_b * LOG2E : 0.f;
  float sum_a[2] = {0.f, 0.f}, sum_b[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[4 * j + e] = hopper::ex2(fmaf(sc[4 * j + e], c, -off_a));
      sc[4 * j + 2 + e] = hopper::ex2(fmaf(sc[4 * j + 2 + e], c, -off_b));
      sum_a[j % 2] += sc[4 * j + e];
      sum_b[j % 2] += sc[4 * j + 2 + e];
    }
  }
  r.l_a = alpha.x * r.l_a + (sum_a[0] + sum_a[1]);
  r.l_b = alpha.y * r.l_b + (sum_b[0] + sum_b[1]);
  return alpha;
}

// One output row of a consumer thread: its D / 4 values o[4j + e],
// o[4j + e + 1] (e = 0 for its first row, 2 for its second).
template <int D, int E>
__device__ __forceinline__ void store_row(const float (&o)[D / 2], int r,
                                          float m, float l, void* o_out,
                                          float* m_out, float* l_out, int Lq,
                                          int H, int h, int cq, int lane,
                                          int emit_stats) {
  const size_t base = (static_cast<size_t>(r) * H + h) * D + cq;
  if (emit_stats) {
    float* row = static_cast<float*>(o_out) + base;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) =
          make_float2(o[4 * j + E], o[4 * j + E + 1]);
    if (lane % 4 == 0) {
      m_out[static_cast<size_t>(h) * Lq + r] = m;
      l_out[static_cast<size_t>(h) * Lq + r] = l;
    }
  } else {
    bf16* row = static_cast<bf16*>(o_out) + base;
    const float d = l == 0.f ? 1.f : l;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + E] / d, o[4 * j + E + 1] / d);
  }
}

template <int D, int BK, int NC>
__global__ void __launch_bounds__(Fwd<D, BK, NC>::THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           void* __restrict__ o_out,
                           float* __restrict__ m_out,
                           float* __restrict__ l_out, int Lq, int Lk, int H,
                           int causal, int q_off, int k_off, int stride,
                           float scale, int emit_stats) {
  using C = Fwd<D, BK, NC>;
  constexpr int S = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + C::Q_BYTES;      // k slot s at sk + s T
  const uint32_t sv = sk + S * C::T_BYTES;  // v slot s at sv + s T
  const uint32_t bars = sv + S * C::T_BYTES;
  // mbarriers: [0] q loaded; then per slot s: k loaded, v loaded, k read
  // and v read by every consumer warp
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (1 + S + s); };
  auto free_k = [&](int s) { return bars + 8 * (1 + 2 * S + s); };
  auto free_v = [&](int s) { return bars + 8 * (1 + 3 * S + s); };

  const int h = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;  // heaviest first
  const int rows = min(C::BQ, Lq - row0);
  const int n_tiles = live_k_tiles(
      causal, q_off + static_cast<long long>(row0 + rows - 1) * stride,
      k_off, stride, BK, (Lk + BK - 1) / BK);

  if (threadIdx.x == 0) {
    hopper::bar_init(bars, 1);
    for (int s = 0; s < S; ++s) {
      hopper::bar_init(full_k(s), 1);
      hopper::bar_init(full_v(s), 1);
      hopper::bar_init(free_k(s), NC * 4);  // one arrival per consumer warp
      hopper::bar_init(free_v(s), NC * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    // the producer: registers go to the consumers; one thread loads q,
    // then k and v tiles in turn, each into its slot once every
    // consumer warp has released the slot's previous tile
    if constexpr (NC == 2) hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == NC * 128) {
      hopper::tma_prefetch(&tq);
      hopper::tma_prefetch(&tk);
      hopper::tma_prefetch(&tv);
      hopper::bar_expect(bars, C::Q_BYTES);
      for (int c = 0; c < C::CHUNKS; ++c)
        hopper::tma_load_3d(sq + c * C::BQ * 128, &tq, bars, c * 64, h, row0);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        const uint32_t prev = (it / S - 1) & 1;
        if (it >= S) hopper::bar_wait(free_k(s), prev);
        hopper::bar_expect(full_k(s), C::T_BYTES);
        for (int c = 0; c < C::CHUNKS; ++c)
          hopper::tma_load_3d(sk + s * C::T_BYTES + c * BK * 128, &tk,
                              full_k(s), c * 64, h, it * BK);
        if (it >= S) hopper::bar_wait(free_v(s), prev);
        hopper::bar_expect(full_v(s), C::T_BYTES);
        for (int c = 0; c < C::CHUNKS; ++c)
          hopper::tma_load_3d(sv + s * C::T_BYTES + c * BK * 128, &tv,
                              full_v(s), c * 64, h, it * BK);
      }
    }
    return;
  }

  // a consumer warpgroup: rows [wr0, wr0 + 64) of the q tile
  if constexpr (NC == 2) hopper::setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128, lane = tid % 32;
  // the warpgroup's index, broadcast so the compiler sees it uniform
  // and keeps the descriptors in uniform registers
  const int wgu = __shfl_sync(0xffffffffu, wg, 0);
  const int wr0 = row0 + wgu * 64;
  const int wrows = min(64, Lq - wr0);  // <= 0: wholly past Lq
  const int ra = wr0 + (tid / 32) * 16 + lane / 4;  // this thread's rows:
  const int rb = ra + 8;                            // ra and rb
  const int cq = 2 * (lane % 4);  // its columns in each group of 8
  const long long wq_first = q_off + static_cast<long long>(wr0) * stride;
  const long long wq_last =
      q_off + static_cast<long long>(wr0 + wrows - 1) * stride;
  const long long qa = q_off + static_cast<long long>(ra) * stride;
  const long long qb = qa + 8LL * stride;
  const uint32_t q_wg = sq + wgu * 64 * 128;
  // the tiles this warpgroup computes; the block's later live tiles are
  // wholly above its rows
  const int n_wg =
      wrows > 0 ? live_k_tiles(causal, wq_last, k_off, stride, BK, n_tiles)
                : 0;

  // S = Q K^T of slot s, 16 columns of D per product, and O += P V of
  // slot s, 16 keys per product (V [keys, D] is the transposed,
  // MN-major B, its 64-column blocks BK * 128 bytes apart).  Each
  // descriptor is a base plus a constant step in 16-byte units: 2 for
  // 16 columns, rows * 8 for a 64-column block, 128 for 16 keys.
  const uint64_t dq = hopper::desc_sw128(q_wg, 16, 1024);
  auto qk = [&](float (&sc)[BK / 2], int s) {
    const uint64_t dk = hopper::desc_sw128(sk + s * C::T_BYTES, 16, 1024);
    hopper::wgmma_ss_init(sc, dq, dk);  // S = ..., then S += ...
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      hopper::wgmma_ss(sc, dq + (kk / 4) * C::BQ * 8 + (kk % 4) * 2,
                       dk + (kk / 4) * BK * 8 + (kk % 4) * 2);
  };
  auto pv = [&](float (&o)[D / 2], uint32_t (&p)[BK / 16][4], int s) {
    const uint64_t dv =
        hopper::desc_sw128(sv + s * C::T_BYTES, BK * 128, 1024);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::wgmma_rs(o, p[kk], dv + kk * 128);
  };
  auto mask = [&](float (&sc)[BK / 2], int it) {
    mask_keys<BK>(sc, it, Lk, causal, k_off, stride, wq_first, qa, qb, cq);
  };
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) hopper::bar_arrive(bar);
  };

  // With two consumer warpgroups, they take turns to issue their
  // products (named barriers 1 and 2), so one's softmax runs while the
  // other's products hold the tensor cores.  Both pass n_tiles + 1
  // turns (tile 0's S, one per later tile, the last P V), skipped tiles
  // included; warpgroup 0 goes first.
  auto turn_wait = [&]() {
    if constexpr (NC == 2) hopper::named_sync(1 + wgu, 256);
  };
  auto turn_pass = [&]() {
    if constexpr (NC == 2) hopper::named_arrive(2 - wgu, 256);
  };
  if (NC == 2 && wgu == 1) hopper::named_arrive(1, 256);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  Rows r{NEG_INF, NEG_INF, 0.f, 0.f};
  uint32_t p[BK / 16][4];  // P of the tile before the current one

  hopper::bar_wait(bars, 0);
  if (n_wg > 0) {  // tile 0: S and its softmax (O is still zero)
    float sc[BK / 2];
    hopper::bar_wait(full_k(0), 0);
    turn_wait();
    hopper::wgmma_fence();
    qk(sc, 0);
    hopper::wgmma_commit();
    turn_pass();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    release(free_k(0));
    mask(sc, 0);
    online_softmax<BK>(sc, r, scale);
    pack_a<BK>(sc, p);  // P: the A operand of P V
  }
  // tile it: S_it = Q K_it^T and O += P_{it-1} V_{it-1} in flight
  // together; the softmax of S_it runs while P V is on the tensor cores
  auto step = [&](int it, auto masked) {
    const int s = it % S, sp = (it - 1) % S;
    float sc[BK / 2];
    hopper::bar_wait(full_k(s), (it / S) & 1);
    hopper::bar_wait(full_v(sp), ((it - 1) / S) & 1);
    hopper::fence_regs(o);  // rescaled O and packed P before the products
    hopper::fence_regs(p);
    turn_wait();
    hopper::wgmma_fence();
    qk(sc, s);
    hopper::wgmma_commit();
    pv(o, p, sp);
    hopper::wgmma_commit();
    turn_pass();
    hopper::wgmma_wait<1>();  // S_it is done; P V may still run
    hopper::fence_regs(sc);
    release(free_k(s));
    if constexpr (decltype(masked)::value) mask(sc, it);
    const float2 alpha = online_softmax<BK>(sc, r, scale);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);   // the rescale and the packing of the next P
    hopper::fence_regs(sc);  // only once this P V is done
    release(free_v(sp));
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha.x;
      o[4 * j + 1] *= alpha.x;
      o[4 * j + 2] *= alpha.y;
      o[4 * j + 3] *= alpha.y;
    }
    pack_a<BK>(sc, p);  // P: the A operand of P V
  };
  // the leading tiles need no mask: full, and wholly at or below the
  // diagonal for every row of the warpgroup; the rest go through mask()
  int n_plain = min(n_wg, Lk / BK);
  if (causal) {
    const long long last = wq_first < k_off ? -1 : (wq_first - k_off) / stride;
    const long long t = (last + 1) / BK;
    if (t < n_plain) n_plain = static_cast<int>(t);
  }
  int it = 1;
  for (; it < n_plain; ++it) step(it, std::false_type{});
  for (; it < n_wg; ++it) step(it, std::true_type{});
  if (n_wg > 0) {  // the last tile's P V
    const int s = (n_wg - 1) % S;
    hopper::bar_wait(full_v(s), ((n_wg - 1) / S) & 1);
    hopper::fence_regs(o);
    hopper::fence_regs(p);
    turn_wait();
    hopper::wgmma_fence();
    pv(o, p, s);
    hopper::wgmma_commit();
    turn_pass();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    release(free_v(s));
  }
  // tiles wholly above this warpgroup's rows: release them in turn,
  // each only once loaded, so no arrival runs ahead of the ring's phase
  if (n_wg == 0 && n_tiles > 0) {  // the turn of the last P V
    turn_wait();
    turn_pass();
  }
  for (int it = n_wg; it < n_tiles; ++it) {
    const int s = it % S;
    const uint32_t ph = (it / S) & 1;
    turn_wait();
    turn_pass();
    hopper::bar_wait(full_k(s), ph);
    release(free_k(s));
    hopper::bar_wait(full_v(s), ph);
    release(free_v(s));
  }

  const float l_a = quad_sum(r.l_a), l_b = quad_sum(r.l_b);
  if (ra < Lq)
    store_row<D, 0>(o, ra, r.m_a, l_a, o_out, m_out, l_out, Lq, H, h, cq,
                    lane, emit_stats);
  if (rb < Lq)
    store_row<D, 2>(o, rb, r.m_b, l_b, o_out, m_out, l_out, Lq, H, h, cq,
                    lane, emit_stats);
}

template <int D, int BK, int NC>
int launch_wgmma(int emit_stats, const void* q, const void* k, const void* v,
                 void* o, float* m, float* l, int Lq, int Lk, int H,
                 int causal, int q_off, int k_off, int stride, float scale,
                 cudaStream_t stream) {
  using C = Fwd<D, BK, NC>;
  CUtensorMap tq, tk, tv;
  if (int e = tile_map(&tq, q, Lq, H, D, C::BQ)) return e;
  if (int e = tile_map(&tk, k, Lk, H, D, BK)) return e;
  if (int e = tile_map(&tv, v, Lk, H, D, BK)) return e;
  if (int e = set_smem(flash_fwd_wgmma_kernel<D, BK, NC>, C::SMEM)) return e;
  dim3 grid(H, (Lq + C::BQ - 1) / C::BQ);
  flash_fwd_wgmma_kernel<D, BK, NC><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, o, m, l, Lq, Lk, H, causal, q_off, k_off, stride, scale,
      emit_stats);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(int bq, int bk, int emit_stats, const void* q, const void* k,
                const void* v, void* o, float* m, float* l, int Lq, int Lk,
                int H, int causal, int q_off, int k_off, int stride,
                float scale, cudaStream_t st) {
#define FLASH_WGMMA(BQ, BK)                                                   \
  if (bq == BQ && bk == BK)                                                   \
    return launch_wgmma<D, BK, BQ / 64>(emit_stats, q, k, v, o, m, l, Lq, Lk, \
                                        H, causal, q_off, k_off, stride,      \
                                        scale, st);
  FLASH_WGMMA(128, 128)
  FLASH_WGMMA(128, 64)
  FLASH_WGMMA(64, 128)
  FLASH_WGMMA(64, 64)
#undef FLASH_WGMMA
  return static_cast<int>(cudaErrorInvalidValue);
}

// the bf16 kernel's shapes: tiles and D of 64 or 128, any lengths
inline bool shapes_ok_bf16(int Lq, int Lk, int H, int D, int bq, int bk,
                           int stride) {
  return Lq > 0 && Lk > 0 && H > 0 && (D == 64 || D == 128) &&
         (bq == 64 || bq == 128) && (bk == 64 || bk == 128) &&
         (Lq + bq - 1) / bq <= 65535 && stride >= 1;
}

}  // namespace flash

extern "C" {

// Dynamic shared memory of one forward block, in bytes: the bf16
// (wgmma) kernel's for in_bytes 2, the f32 kernel's for 4.
size_t flash_fwd_smem_bytes(int in_bytes, int bq, int bk, int D) {
  return in_bytes == 2 ? flash::smem_fwd_bf16(bq, bk, D)
                       : flash::smem_fwd(bq, bk, D);
}

// kind: 0 float32 (the register-tiled FFMA kernel; tiles (32 or 64, D),
// D 64 or 128, any lengths), 1 bfloat16 (the wgmma kernel; tiles 64 or 128,
// D 64 or 128, any lengths) for q, k, v and, without stats, o.
// emit_stats 1: o is f32 [Lq, H, D] unnormalized, m and l f32 [H, Lq]
// (K3); 0: o is normalized in q's dtype, m and l unused (K2).
// Launches on ``stream`` and returns cudaGetLastError() (0 on
// success); never synchronizes.
int flash_fwd(int kind, int emit_stats, const void* q, const void* k,
              const void* v, void* o, float* m, float* l, int Lq, int Lk,
              int H, int D, int bq, int bk, int causal, int q_off, int k_off,
              int stride, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    if (!flash::shapes_ok_f32(Lq, Lk, H, D, bq, bk, stride))
      return static_cast<int>(cudaErrorInvalidValue);
    return D == 64 ? flash::launch_f32_rows<64>(bq, emit_stats, q, k, v, o,
                                                m, l, Lq, Lk, H, causal,
                                                q_off, k_off, stride, scale,
                                                st)
                   : flash::launch_f32_rows<128>(bq, emit_stats, q, k, v, o,
                                                 m, l, Lq, Lk, H, causal,
                                                 q_off, k_off, stride, scale,
                                                 st);
  }
  if (kind == 1) {
    if (!flash::shapes_ok_bf16(Lq, Lk, H, D, bq, bk, stride))
      return static_cast<int>(cudaErrorInvalidValue);
    return D == 64 ? flash::launch_bf16<64>(bq, bk, emit_stats, q, k, v, o, m,
                                            l, Lq, Lk, H, causal, q_off,
                                            k_off, stride, scale, st)
                   : flash::launch_bf16<128>(bq, bk, emit_stats, q, k, v, o,
                                             m, l, Lq, Lk, H, causal, q_off,
                                             k_off, stride, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
