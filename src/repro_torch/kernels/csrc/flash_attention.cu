// Forward flash attention with GQA for Hopper (sm_90a), fp32 or bf16 in,
// products on the tensor cores through mma.sync, fp32 online softmax,
// output in the input's type.
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
//    through strides: no transpose and no padding in the wrapper. Query
//    head h reads KV head h / (H / Hkv), the (Hkv, g) head grouping of
//    the model's _sdpa.
//  * Ragged edges are masked here: every key at or beyond Sk is masked,
//    causal or not, and query rows at or beyond Sq are never stored.
//  * The causal diagonal is aligned bottom-right (key c is visible to
//    query r iff c <= r + Sk - Sq), as the plain reference aligns it.
//  * The TPU walks K blocks on a sequential grid axis and carries m, l
//    and the accumulator in VMEM scratch between grid steps. CUDA blocks
//    run in no order and share nothing, so each block owns one
//    (batch*head, BQ-row query tile) and loops over BK-key tiles itself.
//
// What bounds it on an H100: at the serving shapes (S ~ 500) a block
// does 4 * BQ * hd multiply-adds per key against 2 * hd values loaded, so
// it is bound by operations, not by device memory. The design:
//  * Work split (after FlashAttention-2). A block of WARPS warps owns
//    16 * WARPS query rows; each warp owns 16 of them and keeps their
//    scores, running max and sum and output accumulator in mma fragments
//    in registers. Score rows are reduced with quad shuffles; scale *
//    log2(e) is one multiply folded into exp2f. Causal blocks stop at the
//    last key tile their rows can see, a warp skips the tiles its rows
//    cannot see, the mask runs only on diagonal and ragged tiles, and the
//    heaviest query tiles launch first.
//  * K/V pipeline. K and V tiles go from device to shared memory with
//    16-byte cp.async copies into a ring of STAGES tiles, so the next
//    tile lands while this one is computed. Keys at or past Sk are
//    zero-filled through cp.async's src-size operand. Rows are padded so
//    that every fragment load is free of bank conflicts.
//  * The block's query rows are staged once in shared memory with the
//    first tile; registers hold only the softmax state, the scores and the
//    output accumulator.
//  * bf16: mma.sync m16n8k16 bf16 -> fp32. Q and K fragments come from
//    ldmatrix, V fragments from ldmatrix.trans, and P is repacked from
//    the q k^T accumulators straight into bf16 A fragments (the plain
//    version rounds the probabilities to bf16 too).
//  * fp32: 3xTF32 on mma.sync m16n8k8 tf32 -> fp32. Each operand x is
//    split into big = tf32(x), rounded to nearest, and small = x - big,
//    which the tensor cores truncate to tf32, and small*big + big*small +
//    big*big is summed; the dropped small*small term and the truncation
//    of small are each below 2^-21 of the product. The tensor
//    cores truncate as they accumulate, so a sum chained over the whole
//    depth drifts (4e-5 from the plain version with q scaled by 8, at the
//    moe prefill shape): every F32_CHUNK 8-deep steps are summed on the
//    tensor cores from zero and then added to the fp32 accumulator with a
//    rounded add, which keeps fp32 results within the 2e-5 tolerance that
//    plain TF32 misses by far. The split is done per use, in registers:
//    splitting once per staged tile would double the shared memory of K
//    and V (one block per SM at hd 128). The k index of each 8-deep mma is
//    permuted (position t <-> element 2t, t + 4 <-> 2t + 1; a sum is free
//    of order), which makes Q's and K's fragments float2 loads and turns
//    the q k^T accumulator into P's A fragment with no shuffle.
// wgmma, TMA and warp specialisation are later work: tf32 wgmma needs
// both operands K-major, which V in p v is not.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int WARPS = 4;            // warps a block, 16 query rows each
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;      // query rows per block
constexpr int STAGES = 2;           // K/V tiles in the cp.async ring
constexpr int MIN_BLOCKS = 2;       // blocks per SM the registers allow
constexpr int F32_CHUNK = 2;        // see Warp<float, HD>
// Keys per tile, by input type and head dim: at fp32 hd 128, Q and two
// stages of 64 keys would take 172 KB, one block per SM; at fp32 hd 112,
// 148 KB.
constexpr int F32_BK_HD64 = 64;
constexpr int F32_BK_HD112 = 32;
constexpr int F32_BK_HD128 = 32;
constexpr int BF16_BK_HD64 = 64;
constexpr int BF16_BK_HD112 = 64;
constexpr int BF16_BK_HD128 = 64;
constexpr float NEG_INF = -1e30f;

// The deepest chunk of at most F32_CHUNK 8-deep steps that divides
// `steps` (those of hd, 14 at hd 112, or of a key tile)
constexpr int f32_chunk(int steps, int c = F32_CHUNK) {
  return steps % c == 0 ? c : f32_chunk(steps, c - 1);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  // 16 bytes global -> shared; reads nothing and writes zeros if !valid
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small. big is x rounded to tf32 (10-bit mantissa, to nearest,
// ties away from zero, as cvt.rna.tf32.f32 rounds it; cvt.rna compiles to
// four instructions that also handle NaN and Inf, this to two). small is
// x - big, exact in fp32: the tensor cores read only a tf32 operand's top
// 19 bits, so small goes in as it is and loses its low bits there.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a b for a 16 x 8 (row) tf32 A, an 8 x 8 (col) B and fp32 d
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b (3xTF32): the small products first, then big * big
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           float b0, float b1) {
  uint32_t b0_big, b0_small, b1_big, b1_small;
  split_tf32(b0, b0_big, b0_small);
  split_tf32(b1, b1_big, b1_small);
  mma_tf32(d, a_small, b0_big, b1_big);
  mma_tf32(d, a_big, b0_small, b1_small);
  mma_tf32(d, a_big, b0_big, b1_big);
}

// d += a b for a 16 x 16 (row) bf16 A, a 16 x 8 (col) B and fp32 d
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The fragment arithmetic of one warp, per input type. Fragment
// coordinates: lane = 4 g + t; an accumulator d of a 16 x 8 tile holds
// (row g, cols 2t, 2t + 1) in d[0], d[1] and (row g + 8, the same cols)
// in d[2], d[3].
template <typename T, int HD>
struct Warp;

template <int HD>
struct Warp<float, HD> {
  static constexpr int BK =
      HD == 64 ? F32_BK_HD64 : (HD == 112 ? F32_BK_HD112 : F32_BK_HD128);
  // Q[row][2t..2t+1] and K[key][2t..2t+1] are float2 loads: a half warp
  // (g = 0..3) reads words g * LDK + 2t, 2t + 1, which fill the 32 banks
  // once iff g * LDK mod 32 is 0, 8, 16, 24 in some order, i.e. LDK = 8
  // (mod 16): 72, 120 and 136 floats at hd 64, 112 and 128. V[2t][g] is
  // a scalar load of word 2t LDV + g over the whole warp, conflict-free
  // iff 2 LDV = 8 or 24 (mod 32), i.e. LDV = 4 (mod 8): 68, 116, 132.
  // Rows stay multiples of 16 bytes for cp.async.
  static constexpr int LDK = HD + 8;
  static constexpr int LDV = HD + 4;
  static_assert(LDK % 16 == 8 && LDV % 8 == 4, "bank-conflict-free pads");
  // 8-deep steps summed from zero on the tensor cores, then added to the
  // fp32 accumulator
  static constexpr int QK_STEPS = f32_chunk(HD / 8);
  static constexpr int PV_STEPS = f32_chunk(BK / 8);

  // s = q k^T over the tile's BK keys (n-tile j: keys 8j..8j+7); sQ is
  // the warp's 16 rows
  static __device__ __forceinline__ void qk(float (&s)[BK / 8][4],
                                            const float* sQ, const float* sK) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int c = 0; c < HD / 8; c += QK_STEPS) {
      // A: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
      uint32_t a_big[QK_STEPS][4], a_small[QK_STEPS][4];
#pragma unroll
      for (int u = 0; u < QK_STEPS; ++u) {
        const float* a = sQ + g * LDK + 8 * (c + u) + 2 * t;
        const float2 r0 = *reinterpret_cast<const float2*>(a);
        const float2 r8 = *reinterpret_cast<const float2*>(a + 8 * LDK);
        split_tf32(r0.x, a_big[u][0], a_small[u][0]);
        split_tf32(r8.x, a_big[u][1], a_small[u][1]);
        split_tf32(r0.y, a_big[u][2], a_small[u][2]);
        split_tf32(r8.y, a_big[u][3], a_small[u][3]);
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int u = 0; u < QK_STEPS; ++u) {
          const float2 b = *reinterpret_cast<const float2*>(
              sK + (8 * j + g) * LDK + 8 * (c + u) + 2 * t);
          mma_3xtf32(d, a_big[u], a_small[u], b.x, b.y);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += d[e];
      }
    }
  }

  // o += p v; p is s after the softmax (keys 8kk + 2t, 2t + 1 of row g
  // in p[kk][0..1] are A's positions t, t + 4 under the permuted k index)
  static __device__ __forceinline__ void pv(float (&o)[HD / 8][4],
                                            const float (&p)[BK / 8][4],
                                            const float* sV) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int c = 0; c < BK / 8; c += PV_STEPS) {
      uint32_t a_big[PV_STEPS][4], a_small[PV_STEPS][4];
#pragma unroll
      for (int u = 0; u < PV_STEPS; ++u) {
        split_tf32(p[c + u][0], a_big[u][0], a_small[u][0]);
        split_tf32(p[c + u][2], a_big[u][1], a_small[u][1]);
        split_tf32(p[c + u][1], a_big[u][2], a_small[u][2]);
        split_tf32(p[c + u][3], a_big[u][3], a_small[u][3]);
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int u = 0; u < PV_STEPS; ++u) {
          const float* b = sV + (8 * (c + u) + 2 * t) * LDV + 8 * n + g;
          mma_3xtf32(d, a_big[u], a_small[u], b[0], b[LDV]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] += d[e];
      }
    }
  }

  static __device__ __forceinline__ void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

template <int HD>
struct Warp<__nv_bfloat16, HD> {
  using T = __nv_bfloat16;
  static constexpr int BK =
      HD == 64 ? BF16_BK_HD64 : (HD == 112 ? BF16_BK_HD112 : BF16_BK_HD128);
  // ldmatrix reads 8 rows of 16 bytes; they fill the 32 banks once iff
  // the row stride is an odd number of 16 bytes (mod 128), i.e. LD = 8
  // (mod 16) elements: 72, 120 and 136 at hd 64, 112 and 128
  static constexpr int LDK = HD + 8;  // also Q's
  static constexpr int LDV = HD + 8;
  static_assert(LDK % 16 == 8 && LDV % 16 == 8, "bank-conflict-free pads");
  static __device__ __forceinline__ void qk(float (&s)[BK / 8][4],
                                            const T* sQ, const T* sK) {
    const int lane = threadIdx.x & 31;
    // ldmatrix x4: lane i points at row i % 8 of matrix i / 8. For Q (the
    // A fragment) matrix i / 8 covers rows + 8 (i / 8 % 2) and elements
    // + 8 (i / 16 % 2); for K (two B fragments) keys + 8 (i / 16 % 2) and
    // elements + 8 (i / 8 % 2).
    const T* qa =
        sQ + (((lane >> 3) & 1) * 8 + (lane & 7)) * LDK + ((lane >> 4) & 1) * 8;
    const T* kb =
        sK + (((lane >> 4) & 1) * 8 + (lane & 7)) * LDK + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qa + 16 * kk);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, kb + 16 * np * LDK + 16 * kk);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  static __device__ __forceinline__ void pv(float (&o)[HD / 8][4],
                                            const float (&p)[BK / 8][4],
                                            const T* sV) {
    const int lane = threadIdx.x & 31;
    // ldmatrix x4 trans: matrix i / 8 covers keys + 8 (i / 8 % 2) and
    // elements + 8 (i / 16 % 2)
    const T* base =
        sV + (((lane >> 3) & 1) * 8 + (lane & 7)) * LDV + ((lane >> 4) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                             pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                             pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, base + 16 * kk * LDV + 16 * np);
        mma_bf16(o[2 * np], a, b[0], b[1]);
        mma_bf16(o[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  static __device__ __forceinline__ void store2(T* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
};

template <typename T, int HD>
constexpr size_t smem_bytes() {
  using W = Warp<T, HD>;
  return sizeof(T) * ((size_t)BQ * W::LDK + (size_t)STAGES * W::BK * (W::LDK + W::LDV));
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Sq,
                     int Sk, int H, int Hkv, int causal, float scale_log2e) {
  using W = Warp<T, HD>;
  constexpr int BK = W::BK, LDK = W::LDK, LDV = W::LDV;
  constexpr int NT = BK / 8, ND = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // BQ x LDK
  T* sK = sQ + BQ * LDK;                   // STAGES x BK x LDK
  T* sV = sK + STAGES * BK * LDK;          // STAGES x BK x LDV

  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / Hkv);
  // Heaviest (latest) causal tiles first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int w0 = q0 + 16 * (tid >> 5);  // the warp's first query row

  const int64_t q_row = (int64_t)H * HD;  // elements between positions
  const int64_t kv_row = (int64_t)Hkv * HD;
  const T* qb = q + ((int64_t)b * Sq * H + h) * HD;
  const T* kb = k + ((int64_t)b * Sk * Hkv + kvh) * HD;
  const T* vb = v + ((int64_t)b * Sk * Hkv + kvh) * HD;
  T* ob = o + ((int64_t)b * Sq * H + h) * HD;

  const int offset = Sk - Sq;  // >= 0 when causal (checked on the host)
  const int k_end = causal ? min(Sk, q0 + BQ + offset) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = HD / VEC;  // 16-byte copies a row
  // K and V rows tile * BK.. into ring slot `slot`
  auto load_tile = [&](int tile, int slot) {
    T* dk = sK + slot * BK * LDK;
    T* dv = sV + slot * BK * LDV;
#pragma unroll
    for (int i = tid; i < BK * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * VEC, col = tile * BK + r;
      const bool in = col < Sk;
      const int64_t src = in ? col * kv_row + c : 0;
      cp_async16(dk + r * LDK + c, kb + src, in);
      cp_async16(dv + r * LDV + c, vb + src, in);
    }
  };
  // the block's query rows go with the first tile
#pragma unroll
  for (int i = tid; i < BQ * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * VEC, row = q0 + r;
    const bool in = row < Sq;
    cp_async16(sQ + r * LDK + c, qb + (in ? row * q_row + c : 0), in);
  }
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) load_tile(i, i);
    cp_async_commit();
  }
  const T* wQ = sQ + (w0 - q0) * LDK;  // the warp's rows

  float m[2] = {NEG_INF, NEG_INF};  // rows g and g + 8
  float l[2] = {0.f, 0.f};          // this thread's share of each row sum
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES - 2>();  // tile i has landed ...
    __syncthreads();              // ... for all, and tile i - 1 is consumed
    if (i + STAGES - 1 < n_tiles)
      load_tile(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();

    const int k0 = i * BK;
    // a warp skips the tile if its rows are padding or see none of it
    if (w0 >= Sq || (causal && k0 > w0 + 15 + offset)) continue;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    W::qk(s, wQ, sK + (i % STAGES) * BK * LDK);

    if (k0 + BK > Sk || (causal && k0 + BK - 1 > w0 + offset)) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const int row = w0 + g + 8 * (e >> 1);
          if (col >= Sk || (causal && col > row + offset)) s[j][e] = NEG_INF;
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f((m[r] - m_new) * scale_log2e);
      const float mc = m_new * scale_log2e;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = exp2f(fmaf(s[j][e], scale_log2e, -mc));
          sum += s[j][e];
        }
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    W::pv(acc, s, sV + (i % STAGES) * BK * LDV);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = w0 + g + 8 * r;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      W::store2(ob + row * q_row + 8 * n + 2 * t, acc[n][2 * r] / denom,
                acc[n][2 * r + 1] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int Hkv, int causal,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const float scale_log2e =
      (float)(1.4426950408889634 / std::sqrt((double)HD));
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ));
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, Hkv, causal,
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
      (causal && Sq > Sk) || (Sq + BQ - 1) / BQ > 65535)
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

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
