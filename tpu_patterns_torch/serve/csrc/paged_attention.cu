// Fused paged attention over block tables, for Hopper (sm_90a).
//
// Replaces tpu_patterns/serve/paged_kernel.py::_paged_kernel (the Pallas
// kernel behind paged_block).  Computes, for every (row b, kv head h),
// the UNNORMALIZED online-softmax triple of the row's G*W query rows
// against the row's pool pages:
//   o [B, Hkv, G*W, D] f32, m / l [B, Hkv, G*W] f32.
// The sp combine, the normalize and the regroup to [B, W, H, D] stay in
// torch (serve/paged.py::paged_attend).
//
// What bounds it on this card: at the serve shape, latency; at long
// windows, device-memory bytes.  Per (b, h) it reads each visible key's
// K and V head row once (plus the int8 scales), the q rows and the table
// row, and writes o/m/l; the arithmetic is 4*G*W*D flops per visible
// key, far below the H100's ~20 flops/byte f32 ridge.  At the serve
// shape (8 rows, 8 kv heads, 36 pages of 16 slots) the whole call reads
// under 10 MB, less than 3 us at 3.35 TB/s: what costs is the chain of
// dependent round trips to memory (table, K/V rows, partials) and how
// many SMs issue them.  At long windows the bytes bound it, and the
// instructions a block spends around its loads decide how much of the
// memory rate it reaches.
//
// Design (split pages, flash-decoding style):
//   * the grid is (split, kv head, row).  A split is `pps` consecutive
//     pages of one row, staged `sp` pages (~32 KB of K and V: 4 pages of
//     16 bf16 slots at D 128) at a time.  The wrapper's split_pages
//     gives one stage a split while that keeps 4 blocks on every SM,
//     more stages (at most 4) while it still does, fewer pages when the
//     grid would leave an SM idle: the serve shape launches 9 x 8 x 8 =
//     576 blocks of one stage for 132 SMs (not 64), a 4096-token window
//     of 32 rows 16 x 8 x 32 blocks of four stages;
//   * a block stages a stage's live K and V rows into shared memory in
//     ONE round trip: page by page, every thread issues 16-byte cp.async
//     copies (a bf16 head row of 128 is 256 B), dead slots zero-filled
//     without a read; the int8 scales likewise, 4 bytes each.  With more
//     than one stage, the next stage's copies fly into a second buffer
//     while this one is computed.  Values convert to f32 in registers
//     after the load;
//   * one softmax pass a stage: scores for all its keys at once (LPK
//     lanes a key, each lane 32 elements of the head row, so a warp
//     takes 32 / LPK keys a step and reduces in log2(LPK) shuffles; the
//     keys of a quarter warp start at different chunks, so their rows
//     read different banks), one max and one sum per query row merged
//     online into the split's, then P V with each thread owning a
//     16-byte chunk of output columns over a share of the stage's keys,
//     the shares summed in shared memory.  Scalar f32 FMAs: G*W is at
//     most 20, the products are too small for tensor cores to pay for
//     their staging, and the kernel is bound by bytes and latency, not
//     arithmetic;
//   * a split whose pages are all dead (TRASH block 0, inactive row,
//     wholly in the future of the row's last query) loads nothing and
//     writes exact zeros with m = NEG_INF, so the combine weighs it 0
//     (uninitialized partials times 0 would be NaN);
//   * the combine, in the same launch: each block writes its partial
//     (o, m, l) to a workspace, then the last block of a (row, head) to
//     finish, found by a per-(row, head) counter that it resets to 0,
//     merges them in one pass (each thread its output columns, sixteen
//     splits' loads in flight): m = max m_i, l = sum l_i exp(m_i - m),
//     o = sum o_i exp(m_i - m), with the m > NEG_INF/2 guard, so a row
//     that sees nothing keeps m = NEG_INF, l = 0, o = 0.  One split
//     writes the output directly.
//
// Over sp ranks the pool is a shard: each block holds rank `rank`'s
// stripe of bl = block_len / sp slots of a block_len-slot block (sp = 1:
// bl = block_len, rank 0).  Local slot indices stay monotone in global
// position, so staging and the split plan work on local indices; only
// the liveness test, the cut-off nk and the key limits read positions.
//
// Masking and math follow the Pallas kernel: g-major row r is query
// w = r % W at global position pos0 + w; a key at page j slot c sits at
// j*block_len + rank*bl + c and is visible iff its page is live and
// k_pos <= q_pos;
// masked scores are NEG_INF = -1e30; p = exp(s - m) * (m > NEG_INF/2);
// l sums the unscaled p; for int8 the k scale multiplies the score after
// the d^-0.5 scale and the v scale multiplies p after l is summed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

// element kinds: 0 float32, 1 bfloat16, 2 int8 (template arguments are
// kinds, so that ptxas names each instance by plain integers)
template <int KIND>
struct Elem;
template <>
struct Elem<0> {
  using T = float;
};
template <>
struct Elem<1> {
  using T = __nv_bfloat16;
};
template <>
struct Elem<2> {
  using T = int8_t;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// One 16-byte chunk of a head row in shared memory, as f32 in registers.
__device__ __forceinline__ void chunk_f32(const unsigned char* p, float* f,
                                          float) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void chunk_f32(const unsigned char* p, float* f,
                                          __nv_bfloat16) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void chunk_f32(const unsigned char* p, float* f,
                                          int8_t) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(c[i]);
}

// cp.async of `bytes` (16, or 4 for .ca) from global to shared; a
// src_size of 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint32_t src_size) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_size)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          uint32_t src_size) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_size)
               : "memory");
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

// 16-byte chunks a head row of D elements of `kv_bytes` bytes; lanes a
// key in the scores (each lane takes 32 elements: VPL chunks).
__host__ __device__ constexpr int row_chunks(int D, int kv_bytes) {
  return D * kv_bytes / 16;
}

// Dynamic shared memory of one block: `nb` stage buffers (2 when a
// split holds more than one stage of `sp` pages) of K rows (raw; after a
// stage's scores, its P V partial sums of THREADS threads) and of V rows,
// q rows and the split's output sums [GW][D] (f32), a stage's scores
// [GW][sk], the int8 scales [nb][2][sk], m, l and a stage's rescale
// [GW] each, each row's last visible key [GW], each staged key's
// position or INT_MAX [nb][sk], the split's page blocks [pps].
__host__ __device__ inline size_t smem_bytes(int GW, int D, int kv_bytes,
                                             int bl, int pps, int sp) {
  const size_t sk = static_cast<size_t>(sp) * bl;
  const size_t nb = pps > sp ? 2 : 1;
  const size_t k_bytes = sk * D * kv_bytes;
  const size_t red = sizeof(float) * THREADS * (16 / kv_bytes);
  return nb * (k_bytes > red ? k_bytes : red) + nb * k_bytes +
         sizeof(float) * (2 * static_cast<size_t>(GW) * D + GW * sk +
                          (kv_bytes == 1 ? nb * 2 * sk : 0) + 3 * GW) +
         sizeof(int) * (GW + nb * sk + pps);
}

template <int QK, int KVK, int D, bool STRIPED>
__global__ void __launch_bounds__(THREADS) paged_attention_split_kernel(
    const void* __restrict__ q_,      // [B, W, H, D]
    const void* __restrict__ k_,      // [n_blocks, bl, Hkv, D]
    const void* __restrict__ v_,      // [n_blocks, bl, Hkv, D]
    const float* __restrict__ ks,     // [n_blocks, bl, Hkv] (int8 only)
    const float* __restrict__ vs,     // [n_blocks, bl, Hkv] (int8 only)
    const int32_t* __restrict__ tables,  // [B, n_pages]
    const int32_t* __restrict__ pos0,    // [B]
    const uint8_t* __restrict__ active,  // [B] (bool)
    float* __restrict__ o,            // [B, Hkv, GW, D]
    float* __restrict__ m_out,        // [B, Hkv, GW]
    float* __restrict__ l_out,        // [B, Hkv, GW]
    float* __restrict__ part,         // partials (more than one split)
    unsigned int* __restrict__ count,  // [B * Hkv], 0 between launches
    int W, int H, int Hkv, int n_blocks, int bl, int n_pages, int pps,
    int sp, int block_len, int rank, float scale) {
  using QT = typename Elem<QK>::T;
  using KT = typename Elem<KVK>::T;
  constexpr bool INT8 = KVK == 2;
  constexpr int KV_BYTES = static_cast<int>(sizeof(KT));
  constexpr int ROW = D * KV_BYTES;     // a head row, bytes
  constexpr int CHUNKS = ROW / 16;      // 16-byte chunks a row
  constexpr int EPC = 16 / KV_BYTES;    // elements a chunk
  // scores: a lane takes VPL chunks (32 elements) of a key, LPK lanes a
  // key, KPW keys a warp step
  constexpr int VPL = CHUNKS < 32 / EPC ? CHUNKS : 32 / EPC;
  constexpr int LPK = CHUNKS / VPL;
  constexpr int KPW = 32 / LPK;
  static_assert(LPK * VPL == CHUNKS && LPK <= 32, "head row split");

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int S = gridDim.x, B = gridDim.z;
  const int G = H / Hkv;
  const int GW = G * W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sk = sp * bl;                // keys a stage
  const int nb = pps > sp ? 2 : 1;       // stage buffers
  const int page0 = s * pps;
  const int np = min(pps, n_pages - page0);  // pages of this split
  const int key0 = page0 * bl;               // first key, local index
  // a page's global extent and the split's first key position: a
  // striped page is rank `rank`'s stripe of a block_len-slot block, an
  // unstriped one (sp = 1) the whole block, whose positions are the
  // local indices
  const int blk = STRIPED ? block_len : bl;
  const int gbase = STRIPED ? page0 * block_len + rank * bl : key0;

  extern __shared__ __align__(16) unsigned char smem[];
  const int red_bytes = static_cast<int>(sizeof(float)) * THREADS * EPC;
  const int kbuf = sk * ROW > red_bytes ? sk * ROW : red_bytes;
  unsigned char* k_s = smem;                          // [nb][kbuf]
  unsigned char* v_s = k_s + nb * kbuf;               // [nb][sk][ROW]
  float* q_s = reinterpret_cast<float*>(v_s + nb * sk * ROW);  // [GW][D]
  float* acc_s = q_s + GW * D;                 // [GW][D]
  float* p_s = acc_s + GW * D;                 // [GW][sk]
  float* sc_s = p_s + GW * sk;                 // [nb][2][sk] (int8)
  float* m_s = sc_s + (INT8 ? nb * 2 * sk : 0);  // [GW]
  float* l_s = m_s + GW;                       // [GW]
  float* a_s = l_s + GW;                       // [GW]
  int* qlim_s = reinterpret_cast<int*>(a_s + GW);  // [GW]
  int* klim_s = qlim_s + GW;                   // [nb][sk]
  int* tab_s = klim_s + nb * sk;               // [pps], -1 dead
  __shared__ unsigned int is_last;

  const int p0 = pos0[b];
  const int last_q = p0 + W - 1;  // the row's last query position
  const bool act = active[b] != 0;
  int live = 0;
  for (int j = tid; j < np; j += THREADS) {
    int tab = tables[static_cast<size_t>(b) * n_pages + page0 + j];
    tab = min(max(tab, 0), n_blocks - 1);
    const bool ok = tab != 0 && act && gbase + j * blk <= last_q;
    tab_s[j] = ok ? tab : -1;
    live |= ok;
  }
  // keys past the row's last query are seen by no query row.  Striped,
  // count the local slots at positions <= last_q page by page (a page's
  // slots sit at j*block_len + c relative to gbase, so the split's keys
  // are no run of consecutive positions)
  int nk = min(np * bl, last_q - key0 + 1);
  if (STRIPED) {
    const int rel = last_q - gbase;
    const int jf = rel / block_len;
    nk = rel < 0 ? 0
         : jf >= np ? np * bl
                    : jf * bl + min(bl, rel - jf * block_len + 1);
  }
  const bool alive = __syncthreads_or(live) && nk > 0;

  const size_t bh = static_cast<size_t>(b) * Hkv + h;
  float *dst_o, *dst_m, *dst_l;
  if (S == 1) {
    dst_o = o + bh * GW * D;
    dst_m = m_out + bh * GW;
    dst_l = l_out + bh * GW;
  } else {
    const size_t slot = bh * S + s;
    const size_t n_part = static_cast<size_t>(B) * Hkv * S * GW;
    dst_o = part + slot * GW * D;
    dst_m = part + n_part * D + slot * GW;
    dst_l = part + n_part * (D + 1) + slot * GW;
  }

  if (alive) {
    // stage st's live K and V head rows, all in flight at once: page by
    // page, a thread a 16-byte chunk; dead pages zero-filled unread
    const unsigned char* kb = static_cast<const unsigned char*>(k_);
    const unsigned char* vb = static_cast<const unsigned char*>(v_);
    const size_t slot_stride = static_cast<size_t>(Hkv) * ROW;
    auto load_stage = [&](int st) {
      const int bf = st % nb, kfirst = st * sk;
      const int kend = min(kfirst + sk, nk);
      for (int j = st * sp; j * bl < kend; ++j) {
        const int tab = tab_s[j];
        const int kbase = j * bl - kfirst;  // the page's first key here
        const int nslot = min(bl, kend - j * bl);
        const size_t page =
            static_cast<size_t>(tab < 0 ? 0 : tab) * bl * slot_stride +
            static_cast<size_t>(h) * ROW;
        const uint32_t n = tab < 0 ? 0 : 16;
        for (int i = tid; i < nslot * CHUNKS; i += THREADS) {
          const int c = i / CHUNKS, ch = i % CHUNKS;
          const size_t off = page + c * slot_stride + ch * 16;
          const int row = kbase + c;
          cp_async16(k_s + bf * kbuf + row * ROW + ch * 16, kb + off, n);
          cp_async16(v_s + (bf * sk + row) * ROW + ch * 16, vb + off, n);
          if (ch == 0)
            klim_s[bf * sk + row] = tab < 0 ? INT_MAX : j * blk + c;
        }
        if (INT8) {
          const size_t sp0 =
              static_cast<size_t>(tab < 0 ? 0 : tab) * bl * Hkv + h;
          float* sc = sc_s + bf * 2 * sk + kbase;
          for (int c = tid; c < nslot; c += THREADS) {
            cp_async4(sc + c, ks + sp0 + c * Hkv, n / 4);
            cp_async4(sc + sk + c, vs + sp0 + c * Hkv, n / 4);
          }
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    load_stage(0);
    // q rows g-major while the copies fly: row r = g*W + w reads
    // q[b, w, h*G + g, :]; a row sees keys up to its own position
    const QT* q = static_cast<const QT*>(q_);
    for (int i = tid; i < GW * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int g = r / W, w = r % W;
      q_s[i] = to_f32(
          q[((static_cast<size_t>(b) * W + w) * H + h * G + g) * D + d]);
      acc_s[i] = 0.f;
      if (d == 0) {
        qlim_s[r] = p0 + w - gbase;
        m_s[r] = NEG_INF;
        l_s[r] = 0.f;
      }
    }

    // P V: a thread owns a 16-byte chunk of one row's output columns
    // (an item) over every kg_n-th key of a stage; with fewer items than
    // threads the kg_n key groups' sums meet in shared memory
    const int items = GW * CHUNKS;
    const int kg_n = items < THREADS ? THREADS / items : 1;
    const int kq = lane / LPK, kl = lane % LPK;
    const int n_st = (nk + sk - 1) / sk;
    for (int st = 0; st < n_st; ++st) {
      const int bf = st % nb, nks = min(sk, nk - st * sk);
      // the next stage's copies fly while this one is computed
      if (st + 1 < n_st) {
        load_stage(st + 1);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();
      const unsigned char* kst = k_s + bf * kbuf;
      const unsigned char* vst = v_s + bf * sk * ROW;
      const int* klim_st = klim_s + bf * sk;
      const float* sc_st = sc_s + bf * 2 * sk;

      // scores: LPK lanes a key, VPL chunks a lane; a key's lanes start
      // at chunk kq * LPK, so that the keys of a quarter warp read
      // different banks
      for (int base = warp * KPW; base < nks; base += WARPS * KPW) {
        const int key = base + kq;
        const bool in = key < nks;
        const unsigned char* krow = kst + (in ? key : 0) * ROW;
        const int klim = in ? klim_st[key] : INT_MAX;
        const float k_scale = INT8 ? sc_st[in ? key : 0] : 1.f;
        for (int r = 0; r < GW; ++r) {
          float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
          for (int v = 0; v < VPL; ++v) {
            const int ch = (kl + (v + kq) * LPK) % CHUNKS;
            float kf[EPC];
            chunk_f32(krow + ch * 16, kf, KT());
            const float4* q4 =
                reinterpret_cast<const float4*>(q_s + r * D + ch * EPC);
#pragma unroll
            for (int e = 0; e < EPC / 4; ++e) {
              const float4 x = q4[e];
              acc0 = fmaf(x.x, kf[4 * e], acc0);
              acc1 = fmaf(x.y, kf[4 * e + 1], acc1);
              acc0 = fmaf(x.z, kf[4 * e + 2], acc0);
              acc1 = fmaf(x.w, kf[4 * e + 3], acc1);
            }
          }
          float dot = acc0 + acc1;
#pragma unroll
          for (int off = LPK / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          if (kl == 0 && in) {
            float sc = dot * scale;
            if (INT8) sc *= k_scale;
            p_s[r * sk + key] = klim <= qlim_s[r] ? sc : NEG_INF;
          }
        }
      }
      __syncthreads();

      // one softmax pass a stage: one warp a query row, merged online
      // into the split's m and l
      for (int r = warp; r < GW; r += WARPS) {
        float* pr = p_s + r * sk;
        float mx = NEG_INF;
        for (int c = lane; c < nks; c += 32) mx = fmaxf(mx, pr[c]);
        const float m_old = m_s[r];
        const float mn = fmaxf(m_old, warp_max(mx));
        // a row with nothing visible yet keeps exp() exactly 0
        const float keep = (mn > NEG_INF * 0.5f) ? 1.f : 0.f;
        float sum = 0.f;
        for (int c = lane; c < nks; c += 32) {
          float p = expf(pr[c] - mn) * keep;
          sum += p;
          if (INT8) p *= sc_st[sk + c];
          pr[c] = p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_old - mn);
          a_s[r] = alpha;
          l_s[r] = alpha * l_s[r] + sum;
          m_s[r] = mn;
        }
      }
      __syncthreads();

      // acc = alpha * acc + P V (the stage's K rows hold the key groups'
      // sums: its scores are done)
      float* red = reinterpret_cast<float*>(k_s + bf * kbuf);
      for (int t = tid; t < items * kg_n; t += THREADS) {
        const int item = t % items, kg = t / items;
        const int r = item / CHUNKS, ch = item % CHUNKS;
        const float* pr = p_s + r * sk;
        float acc[EPC];
#pragma unroll
        for (int e = 0; e < EPC; ++e) acc[e] = 0.f;
        for (int c = kg; c < nks; c += kg_n) {
          const float p = pr[c];
          float vf[EPC];
          chunk_f32(vst + c * ROW + ch * 16, vf, KT());
#pragma unroll
          for (int e = 0; e < EPC; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
        }
        if (kg_n == 1) {
          float* out = acc_s + item * EPC;
          const float alpha = a_s[r];
#pragma unroll
          for (int e = 0; e < EPC; ++e) out[e] = fmaf(alpha, out[e], acc[e]);
        } else {
          float* out = red + (kg * items + item) * EPC;
#pragma unroll
          for (int e = 0; e < EPC; e += 4)
            *reinterpret_cast<float4*>(out + e) =
                make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
        }
      }
      if (kg_n > 1) {
        __syncthreads();
        for (int i = tid; i < GW * D; i += THREADS) {
          float sum = 0.f;
          for (int kg = 0; kg < kg_n; ++kg) sum += red[kg * items * EPC + i];
          acc_s[i] = fmaf(a_s[i / D], acc_s[i], sum);
        }
      }
      __syncthreads();  // the stage's buffers are free for stage st + 2
    }
    for (int i = tid; i < GW * D; i += THREADS) dst_o[i] = acc_s[i];
    for (int r = tid; r < GW; r += THREADS) {
      dst_m[r] = m_s[r];
      dst_l[r] = l_s[r];
    }
  } else {
    // dead split: exact zeros and m = NEG_INF, weighed 0 by the combine
    for (int i = tid; i < GW * D; i += THREADS) dst_o[i] = 0.f;
    for (int r = tid; r < GW; r += THREADS) {
      dst_m[r] = NEG_INF;
      dst_l[r] = 0.f;
    }
  }
  if (S == 1) return;

  // the last block of (b, h) to finish merges the S partials
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(count + bh, 1u) == static_cast<unsigned int>(S - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const size_t n_part = static_cast<size_t>(B) * Hkv * S * GW;
  const float* po = part + bh * S * GW * D;
  const float* pm = part + n_part * D + bh * S * GW;
  const float* pl = part + n_part * (D + 1) + bh * S * GW;
  // one pass: each thread merges its output column over the splits
  // online, sixteen splits' m_i and o_i (and l_i for column 0) in
  // flight at once
  constexpr int BATCH = 16;
  for (int i = tid; i < GW * D; i += THREADS) {
    const int r = i / D;
    const bool col0 = i % D == 0;
    float mx = NEG_INF, acc = 0.f, lsum = 0.f;
    for (int t0 = 0; t0 < S; t0 += BATCH) {
      float mv[BATCH], ov[BATCH], lv[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int t = t0 + u < S ? t0 + u : S - 1;
        mv[u] = __ldcg(pm + t * GW + r);
        ov[u] = __ldcg(po + static_cast<size_t>(t) * GW * D + i);
        lv[u] = col0 ? __ldcg(pl + t * GW + r) : 0.f;
      }
      float mn = mx;
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (t0 + u < S) mn = fmaxf(mn, mv[u]);
      const float alpha = expf(mx - mn);
      acc *= alpha;
      lsum *= alpha;
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        if (t0 + u < S) {
          const float a = expf(mv[u] - mn);
          acc = fmaf(a, ov[u], acc);
          lsum = fmaf(a, lv[u], lsum);
        }
      }
      mx = mn;
    }
    // a row that sees nothing: every partial is 0 and m stays NEG_INF
    const bool keep = mx > NEG_INF * 0.5f;
    o[bh * GW * D + i] = keep ? acc : 0.f;
    if (col0) {
      m_out[bh * GW + r] = mx;
      l_out[bh * GW + r] = keep ? lsum : 0.f;
    }
  }
  if (tid == 0) count[bh] = 0;  // ready for the next launch
}

template <int QK, int KVK, int D>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int32_t* tables, const int32_t* pos0,
           const uint8_t* active, float* o, float* m, float* l, float* part,
           unsigned int* count, int B, int W, int H, int Hkv, int n_blocks,
           int bl, int n_pages, int pps, int sp, int block_len, int rank,
           float scale, size_t smem, cudaStream_t stream) {
  // sp = 1 runs the unstriped instance: its position arithmetic is the
  // local indices', with no per-page division
  auto kernel = block_len == bl
                    ? paged_attention_split_kernel<QK, KVK, D, false>
                    : paged_attention_split_kernel<QK, KVK, D, true>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch reports its own
      return static_cast<int>(e);
    }
  }
  dim3 grid((n_pages + pps - 1) / pps, Hkv, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      q, k, v, ks, vs, tables, pos0, active, o, m, l, part, count, W, H, Hkv,
      n_blocks, bl, n_pages, pps, sp, block_len, rank, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int QK, int KVK>
int launch_d(int D, const void* q, const void* k, const void* v,
             const float* ks, const float* vs, const int32_t* tables,
             const int32_t* pos0, const uint8_t* active, float* o, float* m,
             float* l, float* part, unsigned int* count, int B, int W, int H,
             int Hkv, int n_blocks, int bl, int n_pages, int pps, int sp,
             int block_len, int rank, float scale, size_t smem,
             cudaStream_t stream) {
#define PAGED_CASE(DV)                                                      \
  case DV:                                                                  \
    return launch<QK, KVK, DV>(q, k, v, ks, vs, tables, pos0, active, o, m, \
                               l, part, count, B, W, H, Hkv, n_blocks, bl,  \
                               n_pages, pps, sp, block_len, rank, scale,    \
                               smem, stream);
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

// Dynamic shared memory of one block, in bytes: kv_kind 0 float32,
// 1 bfloat16, 2 int8; `pps` pages of `bl` slots a split, staged `sp`
// pages at a time.
size_t paged_attention_smem_bytes(int GW, int D, int kv_kind, int bl,
                                  int pps, int sp) {
  return smem_bytes(GW, D, kv_kind == 0 ? 4 : (kv_kind == 1 ? 2 : 1), bl,
                    pps, sp);
}

// q_kind: 0 float32, 1 bfloat16.  kv_kind: 0 float32, 1 bfloat16,
// 2 int8 with float32 per-slot scales ks/vs.  The pool's blocks hold
// `bl` slots, sp rank `rank`'s stripe of `block_len`-slot blocks
// (block_len a multiple of bl, 0 <= rank < block_len / bl).  `pps`
// pages a split, ceil(n_pages / pps) splits, each staged `sp` pages
// (1 <= sp <= pps) at a time.  With more than one split, `part` holds
// B*Hkv*splits*GW*(D + 2) floats and `count` B*Hkv zeros (the kernel
// leaves them 0).  Launches on ``stream`` and returns cudaGetLastError()
// (0 on success); never synchronizes.
int paged_attention(int q_kind, int kv_kind, const void* q, const void* k,
                    const void* v, const float* ks, const float* vs,
                    const int32_t* tables, const int32_t* pos0,
                    const uint8_t* active, float* o, float* m, float* l,
                    float* part, unsigned int* count, int B, int W, int H,
                    int Hkv, int D, int n_blocks, int bl, int n_pages,
                    int pps, int sp, int block_len, int rank, float scale,
                    void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  if (n_pages < 1 || pps < 1 || sp < 1 || sp > pps || bl < 1 ||
      block_len % bl != 0 || rank < 0 || rank >= block_len / bl ||
      B > 65535 || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      paged_attention_smem_bytes((H / Hkv) * W, D, kv_kind, bl, pps, sp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PAGED_KINDS(QK, KVK)                                                 \
  if (q_kind == QK && kv_kind == KVK)                                        \
    return launch_d<QK, KVK>(D, q, k, v, ks, vs, tables, pos0, active, o, m, \
                             l, part, count, B, W, H, Hkv, n_blocks, bl,     \
                             n_pages, pps, sp, block_len, rank, scale, smem, \
                             st);
  PAGED_KINDS(0, 0)
  PAGED_KINDS(1, 1)
  PAGED_KINDS(0, 2)
  PAGED_KINDS(1, 2)
#undef PAGED_KINDS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
