// Forward flash attention with GQA for Hopper (sm_90a), fp32 or bf16 in,
// both products on wgmma fed by TMA copies, fp32 online softmax, output in
// the input's type.
//
// Replaces the TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention.py (launched by flash_attention_bhsd,
// wrapped by repro.kernels.ops.flash_attention). It computes the same
// function: softmax(q k^T / sqrt(hd)) v with an fp32 online softmax
// (running max m, running sum l, fp32 accumulator), NEG_INF = -1e30 for
// masked scores and a max(l, 1e-30) guard on the final division.
//
// What differs from the TPU kernel, by design:
//  * Layout. It reads q (B, Sq, H, hd) and k/v (B, Sk, Hkv, hd) in place
//    through 4-D tensor maps (hd, heads, positions, batch): no transpose
//    and no padding in the wrapper. Query head h reads KV head h / (H /
//    Hkv), the (Hkv, g) head grouping of the model's _sdpa.
//  * Ragged edges are masked here: every key at or beyond Sk is masked,
//    causal or not, and query rows at or beyond Sq are never stored. The
//    copies read 0 past hd, past Sq and past Sk within a sequence (the
//    batch is a dimension of its own, so a tile never reads the next
//    sequence); a key read as 0 scores 0, so the mask still sets it to
//    NEG_INF.
//  * The causal diagonal is aligned bottom-right (key c is visible to
//    query r iff c <= r + Sk - Sq), as the plain reference aligns it.
//  * The TPU walks K blocks on a sequential grid axis and carries m, l
//    and the accumulator in VMEM scratch between grid steps. CUDA blocks
//    run in no order and share nothing, so a work item is one (batch *
//    head, BQ-row query tile) and its loop over BK-key tiles. One block
//    runs on each SM (its shared memory allows no second) and walks a
//    fixed share of the items, heaviest first, so that the next item's
//    query rows and key tiles load while the last one finishes.
//
// What bounds it on an H100: at the serving shapes (S ~ 500) a block does
// 4 * BQ * hd multiply-adds per key against 2 * hd values loaded, so it
// is bound by operations: in fp32 by the tensor cores' tf32 rate times
// three (3xTF32), in bf16 by their bf16 rate. The design (after
// FlashAttention-3):
//  * Roles. A block is WG consumer warpgroups of 64 query rows each, one
//    producer warpgroup and (fp32) HELPER_WG helper warpgroups. One
//    producer thread keeps TMA copies of K and V tiles in flight into a
//    ring of STAGES stages (128-byte swizzled boxes of 128 bytes of hd),
//    ordered by mbarriers "full" (copies landed), "ready" (fp32: the
//    stage's derived tiles written) and "empty" (every consumer is done
//    with it), and copies an item's query rows once its consumers' last
//    q k^T of the item before is done ("q_empty"). With more than two
//    warpgroups the producer and helpers give registers to the consumers
//    (setmaxnreg).
//  * A consumer runs S = Q K^T (A = Q and B = K, both K-major in shared
//    memory) and O += P V (A = P from registers: the S accumulator's
//    layout is the A fragment's, so P needs no shuffle) on wgmma, with the
//    softmax state and O in registers. Score rows are reduced with quad
//    shuffles; scale * log2(e) is one multiply folded into exp2f. Causal
//    blocks stop at the last key tile their rows can see, a consumer skips
//    the tiles its rows cannot see, the mask runs only on diagonal and
//    ragged tiles, and the heaviest query tiles launch first.
//  * bf16: B = V as it lies (MN-major, the transposed form wgmma takes for
//    16-bit types); P is packed to bf16 in registers (the plain version
//    rounds the probabilities to bf16 too).
//  * fp32: 3xTF32. Each operand x is split into big and small tf32 parts
//    and small*big + big*small + big*big is summed; the dropped
//    small*small term and the rounding of the small parts are each below
//    2^-21 of a product. A tf32 operand in shared memory is read as its
//    top 19 bits, so there the big part is x itself and the small part
//    x - trunc(x), rounded to tf32, is a tile of its own; P's parts are
//    split in registers. tf32 wgmma reads B only K-major, which V (keys x
//    hd) is not for P V, so the producer's three idle warps and the helper
//    warpgroups write, once a tile, V^T and its small part (keys as K, 32
//    keys a 128-byte row), and the small parts of K and, once an item, of
//    Q: the work of the splits and the transpose is done once a tile, not
//    once a warp (with the producer's three warps alone it took as long
//    as the consumers' products). Within each
//    8-key step V^T's keys are permuted (position t <-> key 2t, t + 4 <->
//    2t + 1; a sum is free of order), which turns the S accumulator into
//    P's A fragment in place. The tensor cores truncate as they
//    accumulate, so a sum chained over the whole depth drifts (4e-5 from
//    the plain version with q scaled by 8): every F32_QK_CHUNK (P V:
//    F32_PV_CHUNK) 8-deep steps are summed on the tensor cores from zero
//    and then added to the fp32 sums with a rounded add, which keeps fp32
//    results within the 2e-5 tolerance that plain TF32 misses by far.
//    q k^T's chunks alternate between two sums, so one chunk's products
//    run while the last one is added.
//  * Shared memory bounds the fp32 tiles: at hd 128 the query rows and
//    their small part take 64 KB for 64 rows, and a stage of 32 keys 80
//    KB (K, K's small part, V^T, V^T's small part and V as copied), so
//    one consumer and two stages fill 224 of the 227 KB a block may use.
//  * Every wgmma group is waited for within the tile that issued it, so
//    the count in flight is fixed at compile time (ptxas serializes wgmma
//    whose groups in flight it cannot count). No atomics: the same inputs
//    give the same bits.
// (tools/k1_variants.py times other tile choices.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, tf32 splits, tensor maps

namespace {

using namespace hopper;

constexpr int STAGES = 2;  // K/V tiles in the ring
// Consumer warpgroups (64 query rows each) and keys per tile: in fp32 at
// hd 64 and in bf16; fp32 at hd 112 and 128 takes one warpgroup and 32
// keys, all that its shared memory holds (see the budget above).
constexpr int F32_WG_HD64 = 2;
constexpr int F32_BK_HD64 = 64;
constexpr int BF16_WG = 2;
constexpr int BF16_BK = 64;
// 8-deep steps summed from zero on the tensor cores before they are added
// to the fp32 sums: the deepest count up to this that divides the steps
// (those of hd, 14 at hd 112, or of a key tile)
constexpr int F32_QK_CHUNK = 2;
constexpr int F32_PV_CHUNK = 4;
// Extra warpgroups (fp32) that write the derived tiles beside the
// producer's three idle warps
constexpr int F32_HELPER_WG = 1;
// Registers a thread of the producer and helper warpgroups keeps when a
// block has more than two warpgroups (setmaxnreg); the consumers take the
// rest, up to CONSUMER_REGS_MAX (see Tile::CONSUMER_REGS)
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS_MAX = 248;
constexpr float NEG_INF = -1e30f;

__host__ __device__ constexpr int chunk_of(int steps, int c) {
  return steps % c == 0 ? c : chunk_of(steps, c - 1);
}

// The tiles of one instantiation. Shared memory, from a 1024-byte aligned
// base: Q (and, fp32, Q's small part) for WG x 64 rows, then STAGES
// stages of [K | V] (bf16) or [K | K small | V^T | V^T small | V] (fp32),
// then the mbarriers. Every tile is a multiple of 1024 bytes, the
// swizzle's period.
template <typename T, int HD>
struct Tile {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int WG = F32 ? (HD == 64 ? F32_WG_HD64 : 1) : BF16_WG;
  static constexpr int BK = F32 ? (HD == 64 ? F32_BK_HD64 : 32) : BF16_BK;
  static constexpr int BQ = 64 * WG;  // query rows a block
  static constexpr int HELPER_WG = F32 ? F32_HELPER_WG : 0;
  static constexpr int THREADS = 128 * (WG + 1 + HELPER_WG);
  // threads that write the derived tiles: the producer's last three warps
  // and the helper warpgroups
  static constexpr int HELPERS = 96 + 128 * HELPER_WG;
  // With more than two warpgroups a thread holds 65536 / THREADS
  // registers at launch (to a multiple of 8); the producer and helpers
  // give all but PRODUCER_REGS of theirs to the consumers (setmaxnreg).
  static constexpr bool REBALANCE = THREADS > 256;
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
  static constexpr int CONSUMER_REGS_FREE =
      ((WG + 1 + HELPER_WG) * LAUNCH_REGS - (1 + HELPER_WG) * PRODUCER_REGS) /
      WG / 8 * 8;
  static constexpr int CONSUMER_REGS =
      CONSUMER_REGS_FREE < CONSUMER_REGS_MAX ? CONSUMER_REGS_FREE
                                             : CONSUMER_REGS_MAX;
  static_assert(!REBALANCE || CONSUMER_REGS >= LAUNCH_REGS,
                "setmaxnreg.inc only adds registers");
  static constexpr int ATOM = 128 / (int)sizeof(T);  // values a swizzled row
  static constexpr int ATOMS = (HD + ATOM - 1) / ATOM;  // such rows across hd
  static constexpr int Q_ROWS = 64 * ATOMS * 128;  // one consumer's rows
  static constexpr int K_TILE = BK * ATOMS * 128;
  static constexpr int VT_TILE = F32 ? HD * 128 * (BK / 32) : 0;
  static constexpr int V_TILE = F32 ? BK * HD * 4 : BK * ATOMS * 128;
  static constexpr int Q_BYTES = (F32 ? 2 : 1) * WG * Q_ROWS;
  static constexpr int STAGE = (F32 ? 2 : 1) * (K_TILE + VT_TILE) + V_TILE;
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE +
                              8 * (3 * STAGES + 3);
  static_assert(SMEM <= 232448, "the tiles fit in a block's shared memory");
  static_assert(HD % 16 == 0 && BK % 16 == 0 && (!F32 || BK % 32 == 0) &&
                    V_TILE % 1024 == 0 && VT_TILE % 1024 == 0,
                "whole wgmma steps; V^T in rows of 32 keys; aligned tiles");
  static_assert(F32 ? (BK == 32 || BK == 64) : (BK == 64 || BK == 128),
                "wgmma N of q k^T: 32 or 64 (tf32), 64 or 128 (bf16)");
};

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Descriptor offset (16-byte units) of 8-deep (tf32) or 16-deep (bf16)
// step j of a K-major tile of `rows` rows per 128-byte column of hd or
// keys: 4 steps a swizzled row, rows x 128 bytes between such columns.
template <int ROWS>
__device__ __forceinline__ uint64_t step(int j) {
  return (uint64_t)((j / 4) * (ROWS * 128 / 16) + (j % 4) * 2);
}

// The two products of one consumer warpgroup, per input type. A thread
// (warp wi, lane 4 g + t) holds accumulator element 4 j + e at row 16 wi +
// g + 8 (e / 2), column 8 j + 2 t + e % 2, as mma.sync's m16n8 tiles.
template <typename T, int HD>
struct Math;

template <int HD>
struct Math<float, HD> {
  using C = Tile<float, HD>;
  static constexpr int BK = C::BK;

  // s = q k^T over the tile's BK keys; q, qs: the consumer's Q and its
  // small part; st: the stage
  static __device__ __forceinline__ void qk(float (&s)[BK / 2],
                                            const unsigned char* q,
                                            const unsigned char* qs,
                                            const unsigned char* st) {
    constexpr int STEPS = HD / 8, CH = chunk_of(STEPS, F32_QK_CHUNK);
    constexpr int NC = STEPS / CH;
    const uint64_t dq = sw128_desc(q), dqs = sw128_desc(qs);
    const uint64_t dk = sw128_desc(st), dks = sw128_desc(st + C::K_TILE);
    float part[2][BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) s[e] = part[0][e] = part[1][e] = 0.f;
#pragma unroll
    for (int c = 0; c <= NC; ++c) {
      if (c < NC) {
        float(&p)[BK / 2] = part[c % 2];
        keep(p);
        wgmma_fence();
#pragma unroll
        for (int j = c * CH; j < (c + 1) * CH; ++j) {
          const uint64_t oq = step<64>(j), ok = step<BK>(j);
          wgmma_tf32_ss(p, dqs + oq, dk + ok, j > c * CH);
          wgmma_tf32_ss(p, dq + oq, dks + ok, 1);
          wgmma_tf32_ss(p, dq + oq, dk + ok, 1);
        }
        wgmma_commit();
      }
      if (c >= 1) {
        if (c < NC)
          wgmma_wait<1>();
        else
          wgmma_wait<0>();
        float(&p)[BK / 2] = part[(c - 1) % 2];
        keep(p);
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) s[e] += p[e];
      }
    }
  }

  // o += p v; p is s after the softmax. Keys 8 j + 2 t and 8 j + 2 t + 1
  // of a row (p[4 j + e], e = 0, 1 or 2, 3) are A's positions t and t + 4
  // of 8-deep step j, where V^T holds them.
  static __device__ __forceinline__ void pv(float (&o)[HD / 2],
                                            const float (&p)[BK / 2],
                                            const unsigned char* st) {
    constexpr int STEPS = BK / 8, CH = chunk_of(STEPS, F32_PV_CHUNK);
    const unsigned char* vt = st + 2 * C::K_TILE;
    const uint64_t dv = sw128_desc(vt), dvs = sw128_desc(vt + C::VT_TILE);
    float part[HD / 2];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) part[e] = 0.f;
#pragma unroll
    for (int c = 0; c < STEPS; c += CH) {
      uint32_t a_big[CH][4], a_small[CH][4];
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const int j = c + u;
        split_tf32(p[4 * j], a_big[u][0], a_small[u][0]);
        split_tf32(p[4 * j + 2], a_big[u][1], a_small[u][1]);
        split_tf32(p[4 * j + 1], a_big[u][2], a_small[u][2]);
        split_tf32(p[4 * j + 3], a_big[u][3], a_small[u][3]);
      }
      keep(part);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const uint64_t ov = step<HD>(c + u);
        wgmma_tf32(part, a_small[u], dv + ov, u > 0);
        wgmma_tf32(part, a_big[u], dvs + ov, 1);
        wgmma_tf32(part, a_big[u], dv + ov, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      keep(part);
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) o[e] += part[e];
    }
  }
};

template <int HD>
struct Math<__nv_bfloat16, HD> {
  using C = Tile<__nv_bfloat16, HD>;
  static constexpr int BK = C::BK;

  static __device__ __forceinline__ void qk(float (&s)[BK / 2],
                                            const unsigned char* q,
                                            const unsigned char*,
                                            const unsigned char* st) {
    const uint64_t dq = sw128_desc(q), dk = sw128_desc(st);
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) s[e] = 0.f;
    keep(s);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      wgmma_bf16_ss(s, dq + step<64>(j), dk + step<BK>(j), j > 0);
    wgmma_commit();
    wgmma_wait<0>();
    keep(s);
  }

  // o += p v with V (keys x hd, hd contiguous) as it was copied: 16-key
  // steps 2048 bytes apart, its 64-value columns of hd K_TILE / ATOMS
  // bytes apart.
  static __device__ __forceinline__ void pv(float (&o)[HD / 2],
                                            const float (&p)[BK / 2],
                                            const unsigned char* st) {
    const uint64_t dv = sw128_desc_mn(st + C::K_TILE, BK * 128);
    uint32_t a[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      a[kk][0] = pack_bf16(p[8 * kk], p[8 * kk + 1]);
      a[kk][1] = pack_bf16(p[8 * kk + 2], p[8 * kk + 3]);
      a[kk][2] = pack_bf16(p[8 * kk + 4], p[8 * kk + 5]);
      a[kk][3] = pack_bf16(p[8 * kk + 6], p[8 * kk + 7]);
    }
    keep(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_bf16_rs_mn(o, a[kk], dv + (uint64_t)kk * (16 * 128 / 16), 1);
    wgmma_commit();
    wgmma_wait<0>();
    keep(o);
  }
};

// One work item: the query tile q0.. q0 + BQ of (batch b, head h) and
// the n_tiles key tiles it sees. Items are numbered heaviest first: all
// (b, h) of the last query tile, then of the one before, and so on.
struct Item {
  int b, h, kvh, q0, n_tiles;
};
__device__ __forceinline__ Item item_of(int w, int B, int Sq, int Sk, int H,
                                        int Hkv, int causal, int BQ, int BK) {
  const int n_qt = (Sq + BQ - 1) / BQ;
  Item it;
  const int bh = w % (B * H);
  it.b = bh / H;
  it.h = bh - it.b * H;
  it.kvh = it.h / (H / Hkv);
  it.q0 = (n_qt - 1 - w / (B * H)) * BQ;
  const int k_end = causal ? min(Sk, it.q0 + BQ + Sk - Sq) : Sk;
  it.n_tiles = (k_end + BK - 1) / BK;
  return it;
}
// The k-th item of this block, or a number past the last item: blocks take
// the items round by round, in turn forwards and backwards, so that the
// heavy items of one round and the light ones of the next even out (the
// longest-first greedy order, fixed ahead).
__device__ __forceinline__ int work_of(int k) {
  const int G = gridDim.x, b = blockIdx.x;
  return k * G + (k % 2 == 0 ? b : G - 1 - b);
}

template <typename T, int HD>
__global__ void __launch_bounds__(Tile<T, HD>::THREADS, 1)
    flash_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                T* __restrict__ o, int B, int Sq, int Sk, int H, int Hkv,
                int causal, float scale_log2e) {
  using C = Tile<T, HD>;
  constexpr int BK = C::BK, BQ = C::BQ, WG = C::WG, ATOMS = C::ATOMS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = sq + C::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE);
  uint64_t* ready = full + STAGES;
  uint64_t* empty = ready + STAGES;
  uint64_t* q_full = empty + STAGES;
  uint64_t* q_ready = q_full + 1;
  uint64_t* q_empty = q_ready + 1;

  const int items = B * H * ((Sq + BQ - 1) / BQ);
  const int offset = Sk - Sq;  // >= 0 when causal (checked on the host)

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], C::HELPERS);
      mbar_init(&empty[s], WG);
    }
    mbar_init(q_full, 1);
    mbar_init(q_ready, C::HELPERS);
    mbar_init(q_empty, WG);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Every role walks the same items; `it` counts key tiles over all of
  // them (the ring's stage and phase), `n` items (the query rows' phase).
  if (threadIdx.x >= 128 * WG) {
    // The producer warpgroup: its first thread issues every copy, its
    // other three warps and the helper warpgroups (fp32) write the derived
    // tiles.
    if constexpr (C::REBALANCE)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          PRODUCER_REGS));
    const int pt = threadIdx.x - 128 * WG;
    if (pt == 0) {
      int it = 0;
      for (int n = 0, w = work_of(0); w < items; w = work_of(++n)) {
        const Item t = item_of(w, B, Sq, Sk, H, Hkv, causal, BQ, BK);
        // the next item's query rows once the consumers' last q k^T of
        // this one is done
        mbar_wait(q_empty, (n & 1) ^ 1);
        mbar_expect_tx(q_full, WG * C::Q_ROWS);
        for (int c = 0; c < WG; ++c)
          for (int a = 0; a < ATOMS; ++a)
            tma_load_4d(sq + (c * ATOMS + a) * 64 * 128, &q_map, q_full,
                        a * C::ATOM, t.h, t.q0 + 64 * c, t.b);
        for (int i = 0; i < t.n_tiles; ++i, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          unsigned char* st = ring + s * C::STAGE;
          unsigned char* sv = st + C::STAGE - C::V_TILE;
          mbar_expect_tx(&full[s], C::K_TILE + C::V_TILE);
          for (int a = 0; a < ATOMS; ++a)
            tma_load_4d(st + a * BK * 128, &k_map, &full[s], a * C::ATOM,
                        t.kvh, i * BK, t.b);
          if constexpr (C::F32) {
            tma_load_4d(sv, &v_map, &full[s], 0, t.kvh, i * BK, t.b);
          } else {
            for (int a = 0; a < ATOMS; ++a)
              tma_load_4d(sv + a * BK * 128, &v_map, &full[s], a * C::ATOM,
                          t.kvh, i * BK, t.b);
          }
        }
      }
    } else if constexpr (C::F32) {
      if (pt < 32) return;
      const int ht = pt - 32;  // C::HELPERS threads
      constexpr int HT = C::HELPERS;
      int it = 0;
      for (int n = 0, w = work_of(0); w < items; w = work_of(++n)) {
        const Item t = item_of(w, B, Sq, Sk, H, Hkv, causal, BQ, BK);
        mbar_wait(q_full, n & 1);
        const float4* q4 = reinterpret_cast<const float4*>(sq);
        float4* qs4 = reinterpret_cast<float4*>(sq + WG * C::Q_ROWS);
#pragma unroll 4
        for (int j = ht; j < WG * C::Q_ROWS / 16; j += HT)
          qs4[j] = tf32_rest(q4[j]);
        fence_proxy_async();  // visible to the consumers' wgmma
        mbar_arrive(q_ready);
        for (int i = 0; i < t.n_tiles; ++i, ++it) {
          const int s = it % STAGES;
          mbar_wait(&full[s], (it / STAGES) & 1);
          unsigned char* st = ring + s * C::STAGE;
          const float4* k4 = reinterpret_cast<const float4*>(st);
          float4* ks4 = reinterpret_cast<float4*>(st + C::K_TILE);
#pragma unroll 4
          for (int j = ht; j < C::K_TILE / 16; j += HT)
            ks4[j] = tf32_rest(k4[j]);
          // V (BK x HD, row-major) -> V^T: row n of 128-byte column kc
          // holds keys 32 kc.., each 8-key group as keys 0, 2, 4, 6 | 1, 3,
          // 5, 7, its 16-byte chunk c at c ^ (n % 8) (the 128-byte swizzle)
          const float* v = reinterpret_cast<const float*>(st + C::STAGE -
                                                          C::V_TILE);
          float4* vt4 = reinterpret_cast<float4*>(st + 2 * C::K_TILE);
          float4* vts4 = vt4 + C::VT_TILE / 16;
#pragma unroll 2
          for (int j = ht; j < HD * (BK / 8); j += HT) {
            const int n = j % HD, grp = j / HD;
            float x[8];
#pragma unroll
            for (int r = 0; r < 8; ++r) x[r] = v[(8 * grp + r) * HD + n];
            const float4 even = make_float4(x[0], x[2], x[4], x[6]);
            const float4 odd = make_float4(x[1], x[3], x[5], x[7]);
            const int row = (grp / 4 * HD + n) * 8, c = 2 * (grp % 4);
            vt4[row + (c ^ (n & 7))] = even;
            vt4[row + ((c + 1) ^ (n & 7))] = odd;
            vts4[row + (c ^ (n & 7))] = tf32_rest(even);
            vts4[row + ((c + 1) ^ (n & 7))] = tf32_rest(odd);
          }
          fence_proxy_async();
          mbar_arrive(&ready[s]);
        }
      }
    }
    return;
  }
  if constexpr (C::REBALANCE)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        C::CONSUMER_REGS));

  // A consumer warpgroup: query rows r0.. r0 + 63 of each item; its warp
  // wi rows w0 + g and w0 + g + 8.
  const int wg = threadIdx.x / 128, wi = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  const unsigned char* q = sq + wg * C::Q_ROWS;
  const unsigned char* qs = q + WG * C::Q_ROWS;  // fp32: Q's small part
  const int64_t q_row = (int64_t)H * HD;  // elements between positions
  int it = 0;
  for (int n = 0, w = work_of(0); w < items; w = work_of(++n)) {
    const Item item = item_of(w, B, Sq, Sk, H, Hkv, causal, BQ, BK);
    const int r0 = item.q0 + 64 * wg, w0 = r0 + 16 * wi;
    // the last key tile the warpgroup's rows see (-1: its rows are
    // padding); it skips the tiles after it
    const int last =
        r0 >= Sq ? -1
                 : causal ? min(item.n_tiles - 1, (r0 + 63 + offset) / BK)
                          : item.n_tiles - 1;
    mbar_wait(q_full, n & 1);
    if constexpr (C::F32) mbar_wait(q_ready, n & 1);
    if (last < 0 && leader) mbar_arrive(q_empty);

    float m[2] = {NEG_INF, NEG_INF};  // rows g and g + 8
    float l[2] = {0.f, 0.f};          // this thread's share of each row sum
    float acc[HD / 2];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) acc[e] = 0.f;

    for (int i = 0; i < item.n_tiles; ++i, ++it) {
      const int s = it % STAGES;
      const uint32_t phase = (it / STAGES) & 1;
      mbar_wait(&full[s], phase);
      if constexpr (C::F32) mbar_wait(&ready[s], phase);
      if (i <= last) {
        const int k0 = i * BK;
        const unsigned char* st = ring + s * C::STAGE;
        float sc[BK / 2];
        Math<T, HD>::qk(sc, q, qs, st);
        // the query rows are free for the next item after the last q k^T
        if (i == last && leader) mbar_arrive(q_empty);

        if (k0 + BK > Sk || (causal && k0 + BK - 1 > w0 + offset)) {
#pragma unroll
          for (int e = 0; e < BK / 2; ++e) {
            const int col = k0 + 8 * (e / 4) + 2 * t + (e & 1);
            const int row = w0 + g + 8 * ((e >> 1) & 1);
            if (col >= Sk || (causal && col > row + offset)) sc[e] = NEG_INF;
          }
        }

#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = NEG_INF;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
            mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[r], mx);
          const float alpha = exp2f((m[r] - m_new) * scale_log2e);
          const float mc = m_new * scale_log2e;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 4 * j + 2 * r; e < 4 * j + 2 * r + 2; ++e) {
              sc[e] = exp2f(fmaf(sc[e], scale_log2e, -mc));
              sum += sc[e];
            }
          l[r] = l[r] * alpha + sum;
          m[r] = m_new;
#pragma unroll
          for (int c = 0; c < HD / 8; ++c) {
            acc[4 * c + 2 * r] *= alpha;
            acc[4 * c + 2 * r + 1] *= alpha;
          }
        }

        Math<T, HD>::pv(acc, sc, st);
      }
      // this warpgroup is done with the stage
      if (leader) mbar_arrive(&empty[s]);
    }

    T* ob = o + ((int64_t)item.b * Sq * H + item.h) * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = w0 + g + 8 * r;
      if (row >= Sq) continue;
      const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
        store2(ob + row * q_row + 8 * c + 2 * t, acc[4 * c + 2 * r] / denom,
               acc[4 * c + 2 * r + 1] / denom);
    }
  }
}

// The tensor map of a contiguous (batch, positions, heads, hd) array of
// fp32 or bf16, in boxes of (1, rows, 1, width): 128-byte swizzled, or
// (fp32 V) plain. Boxes past an edge of any dimension read 0.
bool tensor_map(CUtensorMap* map, const void* base, bool bf16, uint64_t hd,
                uint64_t heads, uint64_t positions, uint64_t batch,
                uint32_t width, uint32_t rows, bool swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const uint64_t e = bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {hd, heads, positions, batch};
  const cuuint64_t strides[3] = {hd * e, heads * hd * e,
                                 positions * heads * hd * e};  // bytes
  const cuuint32_t box[4] = {width, 1, rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map,
                bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                4, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int Hkv, int causal,
                   cudaStream_t stream) {
  using C = Tile<T, HD>;
  constexpr bool bf16 = !C::F32;
  CUtensorMap q_map, k_map, v_map;
  if (!tensor_map(&q_map, q, bf16, HD, H, Sq, B, C::ATOM, 64, true) ||
      !tensor_map(&k_map, k, bf16, HD, Hkv, Sk, B, C::ATOM, C::BK, true) ||
      !tensor_map(&v_map, v, bf16, HD, Hkv, Sk, B, bf16 ? C::ATOM : HD,
                  C::BK, bf16))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return err;
  const float scale_log2e =
      (float)(1.4426950408889634 / std::sqrt((double)HD));
  // One block an SM (its shared memory allows no second), each walking
  // its share of the items.
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int64_t items = (int64_t)B * H * ((Sq + C::BQ - 1) / C::BQ);
  if (items > INT32_MAX) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(items < sms ? items : sms);
  flash_wgmma<T, HD><<<grid, C::THREADS, C::SMEM, stream>>>(
      q_map, k_map, v_map, static_cast<T*>(o), B, Sq, Sk, H, Hkv, causal,
      scale_log2e);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// q, o: (B, Sq, H, hd) contiguous; k, v: (B, Sk, Hkv, hd) contiguous, all
// of one type (is_bf16 ? bf16 : fp32) and 16-byte aligned. hd is 64,
// 112 or 128; H % Hkv == 0; causal requires Sq <= Sk. Launches on `stream` and
// returns the cudaError_t of the launch (0 on success); does not
// synchronise.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int Sq, int Sk, int H, int Hkv,
                                         int hd, int is_bf16, int causal,
                                         void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      (causal && Sq > Sk))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return (int)(is_bf16
                     ? launch<__nv_bfloat16, 64>(q, k, v, o, B, Sq, Sk, H, Hkv,
                                                 causal, s)
                     : launch<float, 64>(q, k, v, o, B, Sq, Sk, H, Hkv, causal,
                                         s));
  if (hd == 112)
    return (int)(is_bf16
                     ? launch<__nv_bfloat16, 112>(q, k, v, o, B, Sq, Sk, H,
                                                  Hkv, causal, s)
                     : launch<float, 112>(q, k, v, o, B, Sq, Sk, H, Hkv,
                                          causal, s));
  if (hd == 128)
    return (int)(is_bf16
                     ? launch<__nv_bfloat16, 128>(q, k, v, o, B, Sq, Sk, H,
                                                  Hkv, causal, s)
                     : launch<float, 128>(q, k, v, o, B, Sq, Sk, H, Hkv,
                                          causal, s));
  return (int)cudaErrorInvalidValue;
}

// The variant repro_flash_attention_fwd launches for a head dim and type:
// 0 flash_wgmma<float> (3xTF32), 1 flash_wgmma<bf16>; -1 for a head dim it
// refuses.
extern "C" int repro_flash_attention_route(int hd, int is_bf16) {
  if (hd != 64 && hd != 112 && hd != 128) return -1;
  return is_bf16 ? 1 : 0;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
