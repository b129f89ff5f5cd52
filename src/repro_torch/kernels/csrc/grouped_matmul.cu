// Grouped (per-expert) matrix product for Hopper (sm_90a): for every
// expert e, o[e] = x[e] @ w[e], with x (E, C, d), w (E, d, f) and
// o (E, C, f); fp32 or bf16 in, fp32 accumulation, output in x's type.
//
// Replaces the TPU kernel `_gmm_kernel` in src/repro/kernels/moe_gmm.py
// (launched by grouped_matmul there, wrapped by
// repro.kernels.ops.grouped_matmul). It computes the same function: an
// fp32 accumulator over the whole d axis, written once in x's type.
//
// Occupied rows. An optional (E,) int32 array `rows` on the card says
// that row r of expert e is zero when r >= rows[e] (the MoE dispatch
// packs each expert's tokens as a prefix of its capacity slots). The
// kernel reads rows[e] itself, clamped to [0, C], so the launch never
// waits on the host. Output rows at or past rows[e] are written 0 and
// never depend on x's rows there or on w: a tile of rows that holds no
// occupied row loads nothing, so an expert with rows[e] = 0 reads none
// of its weights; where a tile straddles rows[e] (the tensor-core
// variant's copies are whole boxes of rows), row r of x feeds only
// output row r, which is written 0. With rows == NULL every row is
// computed.
//
// What differs from the TPU kernel, by design:
//  * The TPU grid (e, ci, fi, di) walks the reduction axis d as its
//    sequential last dimension and carries the accumulator in VMEM
//    scratch between grid steps. CUDA blocks run in no order and share
//    nothing, so a block owns its output tile and loops over d itself,
//    the accumulator in registers. No block splits d, so there are no
//    atomics and results are the same from run to run.
//  * No padding. The reference wrapper pads C to 128 and d to 512 (and
//    the MoE expert width d_expert = 1408 is no multiple of 512). Here
//    the ragged C, d and f edges are masked in the kernel (or read as 0
//    by the copies), so any shape with non-zero dimensions is right,
//    (1, 1, 1, 1) included.
//
// Five variants, chosen on the host from the shapes, the type and the
// pointers alone (repro_grouped_matmul_route; it never reads `rows`):
//
//  * gmm_small, C <= 32 in fp32, and in bf16 where TMA cannot copy,
//    bound by bytes (the decode step of
//    qwen2-moe-a2.7b: (60, 32, 2048) x (60, 2048, 1408) at B = 4, where
//    at most 16 experts hold a token and each at most 4 rows). Its bound
//    counts the weights of the experts that hold a token, their occupied
//    rows of x and all of o: about 15 of 60 experts' weights. A block
//    owns one (expert, 32-column slice of f) and streams that slice of w
//    through a 2-stage ring of 64-deep chunks in shared memory with
//    16-byte cp.async copies; the 44-64 column slices of each of the ~15
//    active experts give 660-960 blocks, several on every one of the 132
//    SMs. Only the occupied rows are computed: the 32 lanes of a block
//    split those rows and the chunk's depth between them and sum their
//    partial products in shared memory in a fixed order at the end.
//  * gmm_wgmma, C > 32 in fp32 with d and f multiples of 4 and 16-byte
//    aligned pointers (the prefill: (60, 192, 2048) x (60, 2048, 1408)
//    for gate and up, (60, 192, 1408) x (60, 1408, 2048) for down).
//    Dense, it does 66 GFLOP against 0.85 GB, bound by operations: 0.99
//    ms on the CUDA cores' 67 TFLOP/s, 0.40 ms as 3xTF32 (three tf32
//    products per multiply-add at 494.7 TFLOP/s). With the moe path's
//    rows (about 43% of the slots occupied, every expert holding some)
//    the operations shrink and the bound is bytes: all the weights,
//    ~0.7 GB, so w must come from device memory about once. The design:
//    - 3xTF32 on the tensor cores: each operand is split into a big and
//      a small tf32 part and small*big + big*small + big*big is summed;
//      both small parts are rounded to tf32 (the tensor cores read only
//      an operand's top 19 bits), so the dropped small*small term and
//      the rounding of the small parts are each below 2^-21 of a
//      product. The tensor cores truncate as they accumulate, so each
//      W_CHUNK 8-deep steps are summed on them from zero (scale-d 0 on
//      the first wgmma) and then added to an fp32 accumulator in
//      registers with a rounded add; a sum chained over d = 2048 would
//      drift past the 2e-5 tolerance that plain TF32 misses by far.
//    - The operands are swapped: the block computes o^T = w^T x^T. A
//      tf32 wgmma reads an operand from shared memory only K-major, and
//      w (d x f, f contiguous) is not K-major as B, while x (C x d) is.
//      So B = x^T comes from shared memory as x lies, and A = w^T from
//      registers: each consumer thread loads its m16n8k8-layout
//      fragment of the staged w tile and splits it there. For x the big
//      part is x itself (the tensor cores truncate it) and the small
//      part, x - trunc(x), goes into a second staged tile in x's layout.
//    - A block owns W_BM = 128 columns of f (64 a consumer warpgroup,
//      wgmma M) and W_NT x W_BN = 192 rows of C (wgmma N = 32 an
//      n-tile), so every w tile is read from device memory once, and x,
//      1.5 MB an expert, is re-read from L2 by the 11-16 blocks of an
//      expert, which run next to each other. A producer warpgroup gives
//      its registers to the two consumers (setmaxnreg): one thread keeps
//      W_STAGES stages of 32-deep tiles in flight with TMA copies
//      (128-byte swizzle; 3-D tensor maps whose out-of-range boxes read
//      0), the other three warps write each stage's small part of x;
//      mbarriers "full", "ready" and "empty" order the three roles.
//      Within a stage a consumer issues n-tile t's products into one of
//      two chunk sums while n-tile t - 1's are added to its accumulator.
//    - Rows: n-tiles wholly at or past rows[e] are neither copied nor
//      computed, the count of those left fixed at compile time (ptxas
//      serializes wgmma whose groups in flight it cannot count), and the
//      experts with the most occupied rows launch first. The epilogue
//      writes each thread's accumulator straight to o (each warp store
//      fills 32-byte sectors) and 0 at rows past rows[e].
//  * gmm_wgmma_bf16, C > 32 in bf16 with d and f multiples of 8 and
//    16-byte aligned pointers (the same prefill shapes served in bf16).
//    Dense, it does 66 GFLOP against 426 MB: bound by bytes, 0.127 ms at
//    3.35 TB/s against 0.067 ms at the bf16 tensor cores' 989 TFLOP/s;
//    with the moe path's rows the weights alone (~346 MB) set it. So
//    the design streams every weight from device memory once and keeps
//    enough of it in flight, and the products only have to keep up:
//    - One fp32 accumulator over the whole of d, chained on the tensor
//      cores (bf16 has no small part to carry, and the truncation of
//      their fp32 adds stays far below the bf16 rounding of the output),
//      written once in bf16.
//    - The operands are swapped as in gmm_wgmma: o^T = w^T x^T, A = w^T
//      (M = 64 columns of f a consumer warpgroup), B = x^T (N = 32 rows
//      of C an n-tile). bf16 wgmma could read w MN-major as B of
//      o = x w, but then its M would be 64 rows of C: an expert's ~80
//      occupied rows of 192 would take 2 m-tiles of 3 where they take 3
//      n-tiles of 6 here. And A comes from registers: each consumer
//      loads its 64 x 64 tile of w^T once a stage from the swizzled
//      MN-major tile (ldmatrix .trans), so each m64n32k16 product reads
//      only its 1 KB of x from shared memory; with A in shared memory it
//      would read 3 KB for 16 cycles of tensor work (24 cycles of
//      shared-memory bytes: the limit of K1's q k^T at N = 32 keys).
//    - A block owns B_BM = 128 columns of f (two consumer warpgroups)
//      and B_NT x B_BN = 192 rows of C. A producer warpgroup gives its
//      registers to the consumers (setmaxnreg); its first thread keeps
//      B_STAGES stages of 64-deep tiles (one 128-byte swizzle row of
//      bf16) in flight with TMA copies, mbarriers "full" and "empty"
//      between the roles. A consumer issues a stage's products as one
//      wgmma group and waits for it before it releases the stage; the
//      count of n-tiles is fixed at compile time (with_const), as in
//      gmm_wgmma.
//    - Rows: as in gmm_wgmma, n-tiles wholly at or past rows[e] are
//      neither copied nor computed, and the experts with the most rows
//      launch first.
//  * gmm_decode_bf16, C <= 32 in bf16 with d and f multiples of 8 and
//    16-byte aligned pointers (the decode step served in bf16). Dense it
//    does 11.1 GFLOP against 359 MB: 0.107 ms at 3.35 TB/s, 0.011 ms at
//    989 TFLOP/s; with the decode step's rows (~15 of 60 experts, 1-4
//    rows each) the weights of the experts that hold a row, ~87 MB, and
//    all of o, 5.4 MB, set it (~0.027 ms). So the kernel is a weight stream, with the
//    products done on the tensor cores on the way:
//    - The operands are swapped: o^T = w^T x^T, A = w^T (M = 64 columns
//      of f an m-tile), B = x^T (N = 8 rows of C an n-tile, one wgmma of
//      N = 8, 16, 24 or 32 over the occupied n-tiles, their count fixed
//      at compile time), one fp32 accumulator over the whole of d,
//      written once in bf16. Both operands come from shared memory: w as
//      it lies in its 128-byte-swizzled TMA box, MN-major (bf16 wgmma
//      reads A transposed), x K-major. So the consumer only issues the
//      products; the tensor cores read each weight once from shared
//      memory, at 2 KB a 16-deep step, far below what shared memory
//      gives, and hold no fragment in registers.
//    - A block of one warpgroup owns one (expert, D_BM = 64 columns of
//      f) and streams that slice of w, D_BK = 64 deep a stage (8 KB of w
//      and 1 KB an occupied n-tile of x) through a ring of D_STAGES = 3
//      stages with TMA copies; a "full" mbarrier a stage. The products
//      of a stage take a few hundred cycles where its bytes take
//      thousands to come, so there is no producer warp: the
//      warpgroup's first thread refills a slot as soon as the products
//      on it are done, and D_STAGES - 1 stages stay in flight. At ~39
//      KB a block, five blocks share an SM (660 places on 132 SMs): 16
//      KB of weights in flight a block, 40-58 KB an SM, where gmm_small
//      keeps 4 KB in flight a block. 2 or 4 stages, or 128 columns a
//      block, were no faster; by ablation the weights alone take as
//      long as the whole kernel (tools/k2_variants.py).
//    - Only active experts cost: blocks take experts in rank order
//      (ranked_expert), so the ~15 that hold a row (330 blocks of gate
//      and up, 480 of down) all start at once and share the memory's
//      bandwidth; a block whose expert holds no row writes its slice of
//      o as 0 with 16-byte stores and exits, reading nothing, and the
//      ~1000-1400 such blocks pass through the places left over. Rows
//      past the occupied n-tiles are written 0 without a product, and
//      rows inside them at or past rows[e] are written 0 in place of the
//      accumulator.
//  * gmm_large, C > 32 where TMA cannot copy (d or f not a multiple of
//    16 bytes' worth of elements, or a pointer off 16-byte alignment; no
//    main path launches it): a register-tiled SGEMM on the CUDA cores.
//    A block of 128 threads owns a 64 x 128 output tile, each thread an
//    8 x 8 register tile; w streams through a 3-stage cp.async ring of
//    16-deep chunks, x is staged transposed. Row tiles at or past rows[e]
//    are zero-filled without any load.
//
// The vector copies of gmm_small and gmm_large need d and f to be
// multiples of 16 bytes' worth of elements and 16-byte aligned pointers;
// other shapes take scalar loads through the same tiles.
// (tools/k2_variants.py times other tile choices and the ablations.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, tf32 splits, tensor maps

namespace {

using namespace hopper;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Four consecutive elements as floats: p is 16-byte (fp32) or 8-byte
// (bf16) aligned.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// 16 bytes global -> shared, asynchronous; reads nothing (and writes 16
// zero bytes) when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
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

// Copies n_rows x COLS elements of the row-major matrix g (ld elements
// a row), from (r0, c0), into s (row-major, COLS a row), reading 0 at
// rows >= r_lim or columns >= c_lim. VEC: 16-byte cp.async copies, to be
// waited for (c0, ld and c_lim are multiples of 16 bytes' worth of
// elements, g 16-byte aligned); otherwise plain loads and stores.
template <typename T, bool VEC, int COLS>
__device__ __forceinline__ void stage_tile(T* s, const T* g, int64_t ld,
                                           int r0, int c0, int n_rows,
                                           int r_lim, int c_lim) {
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);
    constexpr int CPR = COLS / V;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < n_rows * CPR; i += blockDim.x) {
      const int r = i / CPR, c = (i % CPR) * V;
      const bool ok = r0 + r < r_lim && c0 + c < c_lim;
      cp_async16(s + r * COLS + c, ok ? g + (r0 + r) * ld + c0 + c : g, ok);
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * COLS; i += blockDim.x) {
      const int r = i / COLS, c = i % COLS;
      s[i] = r0 + r < r_lim && c0 + c < c_lim ? g[(r0 + r) * ld + c0 + c]
                                              : T{};
    }
  }
}

// Rows of expert e that may be non-zero: rows[e] clamped to [0, C], or C.
__device__ __forceinline__ int occupied(const int* rows, int e, int C) {
  return rows ? min(max(rows[e], 0), C) : C;
}

// o rows [r_begin, r_end) x columns [c0, c0 + width) of one expert := 0.
template <typename T>
__device__ void zero_rows(T* oe, int r_begin, int r_end, int c0, int width,
                          int F) {
  const int w = min(width, F - c0);
  for (int i = threadIdx.x; i < (r_end - r_begin) * w; i += blockDim.x)
    store(&oe[(int64_t)(r_begin + i / w) * F + c0 + i % w], 0.f);
}

// ---------------------------------------------------------------------
// C <= SMALL_C: stream the weights of the experts that hold a row.
constexpr int SMALL_C = 32;
constexpr int S_BN = 32;        // columns of f per block
constexpr int S_KC = 64;        // depth of d per staged chunk
constexpr int S_STAGES = 2;     // chunks in the ring
constexpr int S_THREADS = 256;  // S_BN / 4 column quads x S_LANES lanes
constexpr int S_QUADS = S_BN / 4;
constexpr int S_LANES = S_THREADS / S_QUADS;  // (row, depth) lanes
static_assert(S_LANES >= 16 && SMALL_C <= 32, "at most 2 rows a thread");

// One staged chunk: lane (rs, kl) of NRS row lanes adds, for its rows
// rs and rs + NRS below n, the products over its contiguous span of the
// chunk's depth to acc.
template <typename T, int NRS>
__device__ __forceinline__ void small_chunk(const T* tw, const T* tx, int n,
                                            int cq, int rs, int kl,
                                            float (&acc)[2][4]) {
  constexpr int SPAN = S_KC / (S_LANES / NRS) > 0 ? S_KC / (S_LANES / NRS) : 1;
  constexpr int RPT = NRS >= 16 ? 2 : 1;
  const int k0 = kl * SPAN;
  if (k0 >= S_KC) return;
#pragma unroll
  for (int i = 0; i < SPAN; i += (SPAN >= 4 ? 4 : 1)) {
    float4 b[SPAN >= 4 ? 4 : 1];
#pragma unroll
    for (int q = 0; q < (SPAN >= 4 ? 4 : 1); ++q)
      b[q] = load4(tw + (k0 + i + q) * S_BN + cq * 4);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = rs + j * NRS;
      if (r >= n) continue;
      float a[4];
      if constexpr (SPAN >= 4) {
        const float4 v = load4(tx + r * S_KC + k0 + i);
        a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
      } else {
        a[0] = to_float(tx[r * S_KC + k0 + i]);
      }
#pragma unroll
      for (int q = 0; q < (SPAN >= 4 ? 4 : 1); ++q) {
        acc[j][0] = fmaf(a[q], b[q].x, acc[j][0]);
        acc[j][1] = fmaf(a[q], b[q].y, acc[j][1]);
        acc[j][2] = fmaf(a[q], b[q].z, acc[j][2]);
        acc[j][3] = fmaf(a[q], b[q].w, acc[j][3]);
      }
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(S_THREADS)
    gmm_small(const T* __restrict__ x, const T* __restrict__ w,
              T* __restrict__ o, const int* __restrict__ rows, int C, int D,
              int F) {
  constexpr int W_TILE = S_KC * S_BN, X_TILE = SMALL_C * S_KC;
  __shared__ __align__(16) unsigned char smem[S_STAGES * (W_TILE + X_TILE) *
                                              sizeof(T)];
  T* sw = reinterpret_cast<T*>(smem);  // [S_STAGES][S_KC][S_BN]
  T* sx = sw + S_STAGES * W_TILE;      // [S_STAGES][SMALL_C][S_KC]

  const int64_t e = blockIdx.y;
  const int c0 = blockIdx.x * S_BN;
  const int n = occupied(rows, (int)e, C);
  const T* xe = x + e * C * D;
  const T* we = w + e * D * F;
  T* oe = o + e * C * F;
  zero_rows(oe, n, C, c0, S_BN, F);
  if (n == 0) return;

  // n rows over n_rs row lanes (a power of two <= 16); the other
  // S_LANES / n_rs lanes split each chunk's depth into contiguous spans.
  int n_rs = 1;
  while (n_rs < n && n_rs < 16) n_rs *= 2;
  const int n_kl = S_LANES / n_rs;
  const int cq = threadIdx.x % S_QUADS, lane = threadIdx.x / S_QUADS;
  const int rs = lane % n_rs, kl = lane / n_rs;
  const int nk = (D + S_KC - 1) / S_KC;

  auto stage = [&](int kt) {
    if (kt < nk) {
      const int st = kt % S_STAGES, k0 = kt * S_KC;
      stage_tile<T, VEC, S_BN>(sw + st * W_TILE, we, F, k0, c0, S_KC, D, F);
      stage_tile<T, VEC, S_KC>(sx + st * X_TILE, xe, D, 0, k0, n, n, D);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  float acc[2][4] = {};
  for (int kt = 0; kt < S_STAGES - 1; ++kt) stage(kt);
  for (int kt = 0; kt < nk; ++kt) {
    stage(kt + S_STAGES - 1);  // into the slot consumed at kt - 1
    cp_async_wait<S_STAGES - 1>();
    __syncthreads();  // chunk kt is in shared memory for every thread
    const T* tw = sw + (kt % S_STAGES) * W_TILE;
    const T* tx = sx + (kt % S_STAGES) * X_TILE;
    switch (n_rs) {
      case 1: small_chunk<T, 1>(tw, tx, n, cq, rs, kl, acc); break;
      case 2: small_chunk<T, 2>(tw, tx, n, cq, rs, kl, acc); break;
      case 4: small_chunk<T, 4>(tw, tx, n, cq, rs, kl, acc); break;
      case 8: small_chunk<T, 8>(tw, tx, n, cq, rs, kl, acc); break;
      default: small_chunk<T, 16>(tw, tx, n, cq, rs, kl, acc); break;
    }
    __syncthreads();  // chunk kt is consumed; its slot may be refilled
  }

  // Sum the depth lanes' partial rows in lane order: red[n][n_kl][S_BN]
  // (n * n_kl <= 2 * S_LANES rows of S_BN floats) over the drained ring.
  cp_async_wait<0>();
  float* red = reinterpret_cast<float*>(smem);
  static_assert(2 * S_LANES * S_BN * sizeof(float) <=
                    S_STAGES * (W_TILE + X_TILE) * sizeof(__nv_bfloat16),
                "the partial rows fit in the ring");
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = rs + j * n_rs;
    if (r < n)
      store4(red + (r * n_kl + kl) * S_BN + cq * 4,
             make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n * S_BN; i += S_THREADS) {
    const int r = i / S_BN, c = i % S_BN;
    if (c0 + c >= F) continue;
    float v = 0.f;
    for (int l = 0; l < n_kl; ++l) v += red[(r * n_kl + l) * S_BN + c];
    store(&oe[(int64_t)r * F + c0 + c], v);
  }
}

// ---------------------------------------------------------------------
// C > SMALL_C where the tensor-core variant cannot run: register-tiled
// SGEMM on the CUDA cores.
constexpr int L_BM = 64;        // rows of C per block
constexpr int L_BN = 128;       // columns of f per block
constexpr int L_BK = 16;        // depth of d per staged chunk
constexpr int L_STAGES = 3;     // chunks of w in the ring
constexpr int L_THREADS = 2 * L_BM;  // L_BM / 8 row x 16 column groups
constexpr int L_MIN_BLOCKS = 3;      // blocks an SM holds (register cap)
constexpr int L_WARP_TX = 16;        // column groups a warp spans
constexpr int L_APAD = 4;            // keeps the transposed stores of x apart
constexpr int L_A_RUNS = L_BK / 8;   // runs of 4 depths of x a thread loads
static_assert(L_BN == 128 && L_BK % 8 == 0 && L_BM % 16 == 0 &&
                  L_BM / 8 * 16 == L_THREADS && 32 % L_WARP_TX == 0,
              "8 x 8 outputs a thread, 16 column groups across");
// Dynamic shared memory (it may exceed the 48 KB of a static array).
template <typename T>
constexpr int large_smem_bytes() {
  return 2 * L_BK * (L_BM + L_APAD) * 4 + L_STAGES * L_BK * L_BN * sizeof(T);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(L_THREADS, L_MIN_BLOCKS)
    gmm_large(const T* __restrict__ x, const T* __restrict__ w,
              T* __restrict__ o, const int* __restrict__ rows, int C, int D,
              int F) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  auto sA = reinterpret_cast<float(*)[L_BK][L_BM + L_APAD]>(dsmem);  // x^T
  auto sB = reinterpret_cast<T(*)[L_BK][L_BN]>(
      dsmem + 2 * L_BK * (L_BM + L_APAD) * 4);                      // w

  const int64_t e = blockIdx.z;
  const int r0 = blockIdx.y * L_BM, c0 = blockIdx.x * L_BN;
  const int n = occupied(rows, (int)e, C);
  const T* xe = x + e * C * D;
  const T* we = w + e * D * F;
  T* oe = o + e * C * F;
  if (r0 >= n) {  // a row tile that holds no occupied row
    zero_rows(oe, r0, min(r0 + L_BM, C), c0, L_BN, F);
    return;
  }

  // Thread (ty, tx) owns rows {ty*4 .. +3, L_BM/2 + ty*4 .. +3} and
  // columns {tx*4 .. +3, 64 + tx*4 .. +3} of the tile, so the 16-byte
  // reads of a warp's L_WARP_TX column groups from a row of sB are
  // contiguous and free of bank conflicts.
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int WARPS_X = 16 / L_WARP_TX, WARP_TY = 32 / L_WARP_TX;
  const int tx = warp % WARPS_X * L_WARP_TX + lane % L_WARP_TX;
  const int ty = warp / WARPS_X * WARP_TY + lane / L_WARP_TX;
  const int nk = (D + L_BK - 1) / L_BK;

  // The x chunk: L_BM rows x L_BK depths in runs of 4 depths.
  constexpr int RUNS_A_ROW = L_BK / 4;
  float4 areg[L_A_RUNS];
  auto load_a = [&](int kt) {
#pragma unroll
    for (int j = 0; j < L_A_RUNS; ++j) {
      const int g = tid + j * L_THREADS, r = g / RUNS_A_ROW;
      const int k = kt * L_BK + g % RUNS_A_ROW * 4;
      const T* p = xe + (int64_t)(r0 + r) * D + k;
      const bool live = r0 + r < n;
      if constexpr (VEC) {
        areg[j] = live && k < D ? load4(p) : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = live && k + i < D ? to_float(p[i]) : 0.f;
        areg[j] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  auto store_a = [&](int buf) {
#pragma unroll
    for (int j = 0; j < L_A_RUNS; ++j) {
      const int g = tid + j * L_THREADS, r = g / RUNS_A_ROW;
      const int k = g % RUNS_A_ROW * 4;
      sA[buf][k + 0][r] = areg[j].x;
      sA[buf][k + 1][r] = areg[j].y;
      sA[buf][k + 2][r] = areg[j].z;
      sA[buf][k + 3][r] = areg[j].w;
    }
  };
  auto stage_b = [&](int kt) {
    if (kt < nk)
      stage_tile<T, VEC, L_BN>(&sB[kt % L_STAGES][0][0], we, F, kt * L_BK,
                               c0, L_BK, D, F);
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < L_STAGES - 1; ++kt) stage_b(kt);
  load_a(0);
  store_a(0);
  for (int kt = 0; kt < nk; ++kt) {
    stage_b(kt + L_STAGES - 1);  // into the slot consumed at kt - 1
    cp_async_wait<L_STAGES - 1>();
    __syncthreads();  // chunk kt of x and of w is visible to every thread
    if (kt + 1 < nk) load_a(kt + 1);  // in flight during the FMAs
    const int buf = kt & 1, st = kt % L_STAGES;
#pragma unroll
    for (int kk = 0; kk < L_BK; ++kk) {
      const float4 a0 = load4(&sA[buf][kk][ty * 4]);
      const float4 a1 = load4(&sA[buf][kk][L_BM / 2 + ty * 4]);
      const float4 b0 = load4(&sB[st][kk][tx * 4]);
      const float4 b1 = load4(&sB[st][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < nk) store_a((kt + 1) & 1);  // its buffer was read at kt - 1
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + (i < 4 ? ty * 4 + i : L_BM / 2 + ty * 4 + i - 4);
    if (row >= C) continue;
    const bool live = row < n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c0 + h * 64 + tx * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live)
        v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      T* p = oe + (int64_t)row * F + col;
      if constexpr (VEC) {
        if (col < F) store4(p, v);  // F % 4 == 0: all four or none
      } else {
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (col + jj < F) store(p + jj, vs[jj]);
      }
    }
  }
}

// The expert of this block of a tensor-core variant (all threads call
// it). Blocks launch in order of blockIdx.z, and with rows an expert's
// blocks take time in proportion to its occupied n-tiles: block z takes
// the expert with the z-th most occupied rows (ties by index), so the
// longest run first and the shortest fill the last wave. Up to
// RANK_CACHE experts' rows are read once into shared memory.
constexpr int RANK_CACHE = 256;
__device__ int ranked_expert(const int* rows, int C) {
  __shared__ int expert;
  __shared__ int occ[RANK_CACHE];
  if (rows == nullptr) return blockIdx.z;
  const int E = gridDim.z;
  const bool cached = E <= RANK_CACHE;
  if (cached)
    for (int i = threadIdx.x; i < E; i += blockDim.x)
      occ[i] = occupied(rows, i, C);
  __syncthreads();
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const int ni = cached ? occ[i] : occupied(rows, i, C);
    int rank = 0;
    for (int j = 0; j < E; ++j) {
      const int nj = cached ? occ[j] : occupied(rows, j, C);
      rank += nj > ni || (nj == ni && j < i);
    }
    if (rank == (int)blockIdx.z) expert = i;
  }
  __syncthreads();
  return expert;
}

// ---------------------------------------------------------------------
// C > SMALL_C, fp32, d and f multiples of 4, 16-byte aligned pointers:
// 3xTF32 on wgmma with the operands swapped (o^T = w^T x^T), TMA copies
// into a ring of stages, a producer warpgroup and W_CONSUMERS consumer
// warpgroups. See the note at the top.
constexpr int W_CONSUMERS = 2;   // consumer warpgroups, 64 columns of f each
constexpr int W_BM = 64 * W_CONSUMERS;  // columns of f per block (wgmma M)
constexpr int W_BN = 32;         // rows of C per n-tile (wgmma N: 32 or 64)
constexpr int W_NT = 6;          // n-tiles per block: W_NT * W_BN rows of C
constexpr int W_BK = 32;         // depth per stage: one 128-byte swizzle row
constexpr int W_STAGES = 3;      // stages in the ring
constexpr int W_CHUNK = 4;       // 8-deep steps summed from zero (divides 4)
// The producer warpgroup gives registers to the consumers (setmaxnreg).
constexpr int W_THREADS = 128 * (W_CONSUMERS + 1);
constexpr int W_PRODUCER_REGS = 40;
constexpr int W_CONSUMER_REGS = 232;
constexpr int W_BOX = 32;        // columns of f per TMA box of w (128 bytes)
constexpr int W_TILE_W = W_BK * W_BM;         // floats of w in a stage
constexpr int W_TILE_X = W_NT * W_BN * W_BK;  // floats of x (and x_small)
constexpr int W_STAGE = W_TILE_W + 2 * W_TILE_X;
constexpr int W_SMEM = W_STAGES * W_STAGE * 4 + 3 * W_STAGES * 8 + 1024;
static_assert(W_BK == 32 && W_BM % W_BOX == 0 && (W_BK / 8) % W_CHUNK == 0 &&
                  (W_BN == 32 || W_BN == 64) && W_BN * W_BK % 1024 == 0,
              "128-byte swizzled tiles of 1 KB multiples; wgmma N 32 or 64");
static_assert(W_SMEM <= 232448, "the ring fits in an SM's shared memory");
static_assert(128 * (W_PRODUCER_REGS + W_CONSUMERS * W_CONSUMER_REGS) <=
                  65536 && W_CONSUMER_REGS % 8 == 0,
              "the warpgroups' registers fit in the SM's 64 K");

__global__ void __launch_bounds__(W_THREADS, 1)
    gmm_wgmma(const __grid_constant__ CUtensorMap x_map,
              const __grid_constant__ CUtensorMap w_map, float* __restrict__ o,
              const int* __restrict__ rows, int C, int D, int F) {
  extern __shared__ unsigned char wsmem[];
  // 1024-byte alignment for the swizzled tiles: [stage][w | x | x_small]
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(wsmem) + 1023) & ~uintptr_t(1023));
  // full: the stage's copies landed; ready: its x_small is written;
  // empty: both consumers are done with it
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + W_STAGES * W_STAGE);
  uint64_t* ready = full + W_STAGES;
  uint64_t* empty = ready + W_STAGES;

  const int e = ranked_expert(rows, C);
  const int f0 = blockIdx.x * W_BM, c0 = blockIdx.y * (W_NT * W_BN);
  const int n = occupied(rows, e, C);
  float* oe = o + (int64_t)e * C * F;
  if (c0 >= n) {  // no occupied row: no load at all
    zero_rows(oe, c0, min(c0 + W_NT * W_BN, C), f0, W_BM, F);
    return;
  }
  // n-tiles holding an occupied row; the rest are neither loaded nor
  // computed
  const int live = min(W_NT, (n - c0 + W_BN - 1) / W_BN);
  const int nk = (D + W_BK - 1) / W_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], 96);
      mbar_init(&empty[s], W_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * W_CONSUMERS) {
    // The producer warpgroup: its first thread keeps the ring full, its
    // other three warps write each stage's x_small (tf32_rest) in x's
    // swizzled layout.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        W_PRODUCER_REGS));
    const int pt = threadIdx.x - 128 * W_CONSUMERS;
    if (pt == 0) {
      const uint32_t bytes = 4u * (W_TILE_W + live * W_BN * W_BK);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % W_STAGES;
        mbar_wait(&empty[s], ((kt / W_STAGES) & 1) ^ 1);
        float* st = ring + s * W_STAGE;
        mbar_expect_tx(&full[s], bytes);
        for (int b = 0; b < W_BM / W_BOX; ++b)
          tma_load(st + b * W_BK * W_BOX, &w_map, &full[s], f0 + b * W_BOX,
                   kt * W_BK, e);
        for (int t = 0; t < live; ++t)
          tma_load(st + W_TILE_W + t * W_BN * W_BK, &x_map, &full[s],
                   kt * W_BK, c0 + t * W_BN, e);
      }
    } else if (pt >= 32) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % W_STAGES;
        mbar_wait(&full[s], (kt / W_STAGES) & 1);
        const float4* xt =
            reinterpret_cast<const float4*>(ring + s * W_STAGE + W_TILE_W);
        float4* xs = const_cast<float4*>(xt) + W_TILE_X / 4;
        for (int i = pt - 32; i < live * W_BN * W_BK / 4; i += 96) {
          const float4 v = xt[i];
          xs[i] = make_float4(tf32_rest(v.x), tf32_rest(v.y),
                              tf32_rest(v.z), tf32_rest(v.w));
        }
        // visible to the consumers' wgmma (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&ready[s]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      W_CONSUMER_REGS));

  // A consumer warpgroup: columns [f0 + wg * 64, + 64) of f. Its warp wi
  // holds A rows (f) wi * 16 + g and + 8 (g = lane / 4) and depths
  // q = lane % 4 and q + 4 of each 8-deep step.
  const int wg = threadIdx.x / 128, wi = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int fl = wg * 64 + wi * 16 + g;  // f within the block
  const int box = fl / W_BOX, fb = fl % W_BOX;  // fb + 8 stays in the box
  constexpr int ND = W_BN / 2;  // accumulator floats a thread per n-tile
  // acc: the fp32 sums; part: two chunk sums on the tensor cores, so that
  // one n-tile's chunk runs while the other's is added to acc
  float acc[W_NT][ND], part[2][ND];
#pragma unroll
  for (int t = 0; t < W_NT; ++t)
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[t][i] = 0.f;
#pragma unroll
  for (int i = 0; i < ND; ++i) part[0][i] = part[1][i] = 0.f;

  // The stage's A = w^T fragments, split. Element (f, k) of a stage lies
  // at row k of its box, in 16-byte chunk (f / 4) ^ (k % 8) of the row
  // (the 128-byte swizzle).
  uint32_t a_big[W_BK / 8][4], a_small[W_BK / 8][4];
  // The stages over LIVE n-tiles, fixed at compile time so that ptxas
  // sees how many wgmma groups are in flight (else it serializes them):
  // for each chunk, n-tile t's products are issued into part[t % 2],
  // then n-tile t - 1's, complete, are added to acc.
  with_const<W_NT>(live, [&](auto n_live) {
    constexpr int LIVE = decltype(n_live)::value;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % W_STAGES;
      mbar_wait(&full[s], (kt / W_STAGES) & 1);
      mbar_wait(&ready[s], (kt / W_STAGES) & 1);
      const float* wt = ring + s * W_STAGE + box * W_BK * W_BOX;
      const float* xt = ring + s * W_STAGE + W_TILE_W;
      const float* xs = xt + W_TILE_X;
#pragma unroll
      for (int j = 0; j < W_BK / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int k = 8 * j + q + (r >= 2 ? 4 : 0);
          const int f = fb + (r & 1 ? 8 : 0);
          split_tf32(wt[k * W_BOX + ((f / 4) ^ (k % 8)) * 4 + f % 4],
                     a_big[j][r], a_small[j][r]);
        }
#pragma unroll
      for (int c = 0; c < W_BK / 8; c += W_CHUNK) {
#pragma unroll
        for (int t = 0; t <= LIVE; ++t) {
          if (t < LIVE) {
            float(&p)[ND] = part[t % 2];
            const uint64_t db = sw128_desc(xt + t * W_BN * W_BK);
            const uint64_t ds = sw128_desc(xs + t * W_BN * W_BK);
            keep(p);
            wgmma_fence();
#pragma unroll
            for (int j = c; j < c + W_CHUNK; ++j) {
              // + 32 bytes of depth a step, inside the swizzled row
              wgmma_tf32(p, a_small[j], db + 2 * j, j > c);
              wgmma_tf32(p, a_big[j], ds + 2 * j, 1);
              wgmma_tf32(p, a_big[j], db + 2 * j, 1);
            }
            wgmma_commit();
          }
          if (t >= 1) {
            if (t < LIVE)
              wgmma_wait<1>();
            else
              wgmma_wait<0>();
            float(&p)[ND] = part[(t - 1) % 2];
            keep(p);
#pragma unroll
            for (int i = 0; i < ND; ++i) acc[t - 1][i] += p[i];
          }
        }
      }
      // this warpgroup is done with the stage
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
    }
  });

  // acc[t][4 j + 2 h + b] is o^T at f = fl + 8 h, c = c0 + t W_BN + 8 j +
  // 2 q + b. Rows of c at or past n are written 0, never the accumulator.
#pragma unroll
  for (int t = 0; t < W_NT; ++t)
#pragma unroll
    for (int j = 0; j < W_BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int c = c0 + t * W_BN + 8 * j + 2 * q + b;
          const int f = f0 + fl + 8 * h;
          if (c < C && f < F)
            oe[(int64_t)c * F + f] = c < n ? acc[t][4 * j + 2 * h + b] : 0.f;
        }
}

// The tensor map of a contiguous fp32 or bf16 (n2, n1, n0) array, n0
// innermost, in boxes of (1, b1, b0) with the 128-byte swizzle; boxes
// past an edge read 0.
bool tensor_map(CUtensorMap* map, const void* base, uint64_t n0, uint64_t n1,
                uint64_t n2, uint32_t b0, uint32_t b1, bool bf16 = false) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const uint64_t elt = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {n0, n1, n2};
  const cuuint64_t strides[2] = {n0 * elt, n0 * n1 * elt};  // bytes
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_wgmma(const void* x, const void* w, void* o,
                         const int* rows, int E, int C, int D, int F,
                         cudaStream_t stream) {
  CUtensorMap x_map, w_map;
  if (!tensor_map(&x_map, x, D, C, E, W_BK, W_BN) ||
      !tensor_map(&w_map, w, F, D, E, W_BOX, W_BK))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((F + W_BM - 1) / W_BM),
                  (unsigned)((C + W_NT * W_BN - 1) / (W_NT * W_BN)),
                  (unsigned)E);
  gmm_wgmma<<<grid, W_THREADS, W_SMEM, stream>>>(
      x_map, w_map, static_cast<float*>(o), rows, C, D, F);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// C > SMALL_C, bf16, d and f multiples of 8, 16-byte aligned pointers:
// bf16 wgmma with the operands swapped (o^T = w^T x^T), A = w^T loaded
// into registers, TMA copies into a ring of stages, a producer warpgroup
// and B_CONSUMERS consumer warpgroups. See the note at the top.
constexpr int B_CONSUMERS = 2;   // consumer warpgroups, 64 columns of f each
constexpr int B_BM = 64 * B_CONSUMERS;  // columns of f per block (wgmma M)
constexpr int B_BN = 32;         // rows of C per n-tile (wgmma N)
constexpr int B_NT = 6;          // n-tiles per block: B_NT * B_BN rows of C
constexpr int B_BK = 64;         // depth per stage: one 128-byte swizzle row
constexpr int B_STAGES = 5;      // stages in the ring
constexpr int B_THREADS = 128 * (B_CONSUMERS + 1);
constexpr int B_PRODUCER_REGS = 40;
constexpr int B_CONSUMER_REGS = 232;
constexpr int B_BOX = 64;        // columns of f per TMA box of w (128 bytes)
constexpr int B_TILE_W = B_BK * B_BM;         // bf16 values of w in a stage
constexpr int B_TILE_X = B_NT * B_BN * B_BK;  // bf16 values of x in a stage
constexpr int B_STAGE = B_TILE_W + B_TILE_X;
constexpr int B_SMEM = B_STAGES * B_STAGE * 2 + 2 * B_STAGES * 8 + 1024;
static_assert(B_BOX == 64 && B_BM == B_CONSUMERS * B_BOX && B_BK % 16 == 0 &&
                  B_BN == 32 && B_BN * B_BK * 2 % 1024 == 0,
              "one 128-byte swizzled box of w a consumer; wgmma N 32");
static_assert(B_SMEM <= 232448, "the ring fits in an SM's shared memory");
static_assert(128 * (B_PRODUCER_REGS + B_CONSUMERS * B_CONSUMER_REGS) <=
                  65536 && B_CONSUMER_REGS % 8 == 0,
              "the warpgroups' registers fit in the SM's 64 K");

__global__ void __launch_bounds__(B_THREADS, 1)
    gmm_wgmma_bf16(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap w_map,
                   __nv_bfloat16* __restrict__ o,
                   const int* __restrict__ rows, int C, int D, int F) {
  extern __shared__ unsigned char bsmem[];
  // 1024-byte alignment for the swizzled tiles: [stage][w box 0 | w box 1
  // | x n-tiles]
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(bsmem) + 1023) & ~uintptr_t(1023));
  // full: the stage's copies landed; empty: both consumers are done with it
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + B_STAGES * B_STAGE * 2);
  uint64_t* empty = full + B_STAGES;

  const int e = ranked_expert(rows, C);
  const int f0 = blockIdx.x * B_BM, c0 = blockIdx.y * (B_NT * B_BN);
  const int n = occupied(rows, e, C);
  __nv_bfloat16* oe = o + (int64_t)e * C * F;
  if (c0 >= n) {  // no occupied row: no load at all
    zero_rows(oe, c0, min(c0 + B_NT * B_BN, C), f0, B_BM, F);
    return;
  }
  // n-tiles holding an occupied row; the rest are neither loaded nor
  // computed
  const int live = min(B_NT, (n - c0 + B_BN - 1) / B_BN);
  const int nk = (D + B_BK - 1) / B_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], B_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * B_CONSUMERS) {
    // The producer warpgroup: its first thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        B_PRODUCER_REGS));
    if (threadIdx.x == 128 * B_CONSUMERS) {
      const uint32_t bytes = 2u * (B_TILE_W + live * B_BN * B_BK);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % B_STAGES;
        mbar_wait(&empty[s], ((kt / B_STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * B_STAGE * 2;
        mbar_expect_tx(&full[s], bytes);
        for (int b = 0; b < B_CONSUMERS; ++b)
          tma_load(st + b * B_BK * B_BOX * 2, &w_map, &full[s],
                   f0 + b * B_BOX, kt * B_BK, e);
        for (int t = 0; t < live; ++t)
          tma_load(st + (B_TILE_W + t * B_BN * B_BK) * 2, &x_map, &full[s],
                   kt * B_BK, c0 + t * B_BN, e);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      B_CONSUMER_REGS));

  // A consumer warpgroup: columns [f0 + wg * 64, + 64) of f, its box of
  // w in each stage. Its warp wi holds A rows (f) wi * 16 + g and + 8 (g
  // = lane / 4). Element (f, k) of a box lies at row k, in 16-byte chunk
  // (f / 8) ^ (k % 8) of the row (the 128-byte swizzle); for ldmatrix
  // lane l gives row k = 16 j + 8 (l / 16) + l % 8 of the k-step j and
  // the chunk of columns wi * 16 + 8 ((l / 8) % 2).
  const int wg = threadIdx.x / 128, wi = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int lr = lane % 8;
  const uint32_t a_off =
      (8 * (lane / 16) + lr) * 128 + ((2 * wi + (lane / 8) % 2) ^ lr) * 16;
  const int fl = wg * 64 + wi * 16 + g;  // f within the block
  constexpr int ND = B_BN / 2;  // accumulator floats a thread per n-tile
  float acc[B_NT][ND];
#pragma unroll
  for (int t = 0; t < B_NT; ++t)
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[t][i] = 0.f;
  uint32_t a[B_BK / 16][4];  // the stage's A fragments

  // The stages over LIVE n-tiles, fixed at compile time so that ptxas
  // sees how many wgmma groups are in flight (else it serializes them):
  // a stage's products are one group, waited for before the stage is
  // released.
  with_const<B_NT>(live, [&](auto n_live) {
    constexpr int LIVE = decltype(n_live)::value;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % B_STAGES;
      mbar_wait(&full[s], (kt / B_STAGES) & 1);
      const unsigned char* st = ring + s * B_STAGE * 2;
      const uint32_t box = smem_addr(st + wg * B_BK * B_BOX * 2) + a_off;
#pragma unroll
      for (int j = 0; j < B_BK / 16; ++j) ldsm_x4_trans(a[j], box + j * 2048);
#pragma unroll
      for (int t = 0; t < LIVE; ++t) keep(acc[t]);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < LIVE; ++t) {
        const uint64_t dx = sw128_desc(st + (B_TILE_W + t * B_BN * B_BK) * 2);
#pragma unroll
        for (int j = 0; j < B_BK / 16; ++j)
          // + 32 bytes of depth a step, inside the swizzled row
          wgmma_bf16_rs(acc[t], a[j], dx + 2 * j, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int t = 0; t < LIVE; ++t) keep(acc[t]);
      // this warpgroup is done with the stage
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
    }
  });

  // acc[t][4 j + 2 h + b] is o^T at f = fl + 8 h, c = c0 + t B_BN + 8 j +
  // 2 q + b. Rows of c at or past n are written 0, never the accumulator.
#pragma unroll
  for (int t = 0; t < B_NT; ++t)
#pragma unroll
    for (int j = 0; j < B_BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int c = c0 + t * B_BN + 8 * j + 2 * q + b;
          const int f = f0 + fl + 8 * h;
          if (c < C && f < F)
            oe[(int64_t)c * F + f] = __float2bfloat16_rn(
                c < n ? acc[t][4 * j + 2 * h + b] : 0.f);
        }
}

cudaError_t launch_wgmma_bf16(const void* x, const void* w, void* o,
                              const int* rows, int E, int C, int D, int F,
                              cudaStream_t stream) {
  CUtensorMap x_map, w_map;
  if (!tensor_map(&x_map, x, D, C, E, B_BK, B_BN, true) ||
      !tensor_map(&w_map, w, F, D, E, B_BOX, B_BK, true))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_wgmma_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, B_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((F + B_BM - 1) / B_BM),
                  (unsigned)((C + B_NT * B_BN - 1) / (B_NT * B_BN)),
                  (unsigned)E);
  gmm_wgmma_bf16<<<grid, B_THREADS, B_SMEM, stream>>>(
      x_map, w_map, static_cast<__nv_bfloat16*>(o), rows, C, D, F);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// C <= SMALL_C, bf16, d and f multiples of 8, 16-byte aligned pointers:
// bf16 wgmma (o^T = w^T x^T, both operands from shared memory) on a TMA
// stream of the active experts' weights. See the note at the top.
constexpr int D_MT = 1;          // 64-column m-tiles of f per block
constexpr int D_BM = 64 * D_MT;  // columns of f per block
constexpr int D_BK = 64;         // depth per stage: one 128-byte swizzle row
constexpr int D_STAGES = 3;      // stages in the ring
// Ablation only (tools/k2_variants.py): 1 skips the products, 2 the x
// copies; 3 both, and the ring then holds no x.
constexpr int D_SKIP = 0;
constexpr int D_NT = SMALL_C / 8;  // n-tiles of 8 rows of C (wgmma N = 8)
constexpr int D_TILE_W = D_BK * D_BM;  // bf16 values of w in a stage
constexpr int D_TILE_X = D_SKIP == 3 ? 0 : D_NT * 8 * D_BK;  // of x
constexpr int D_STAGE = D_TILE_W + D_TILE_X;
constexpr int D_SMEM = D_STAGES * D_STAGE * 2 + D_STAGES * 8 + 1024;
static_assert(D_BK == 64 && SMALL_C % 8 == 0 && SMALL_C <= 32,
              "one 128-byte swizzle row of depth; wgmma N at most 32");
static_assert(D_SMEM <= 232448, "the ring fits in an SM's shared memory");

__global__ void __launch_bounds__(128)
    gmm_decode_bf16(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap w_map,
                    __nv_bfloat16* __restrict__ o,
                    const int* __restrict__ rows, int C, int D, int F) {
  extern __shared__ unsigned char dsmem[];
  // 1024-byte alignment for the swizzled tiles: [stage][w m-tiles | x]
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(dsmem) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + D_STAGES * D_STAGE * 2);

  const int e = ranked_expert(rows, C);
  const int f0 = blockIdx.x * D_BM;
  const int n = occupied(rows, e, C);
  __nv_bfloat16* oe = o + (int64_t)e * C * F;
  // n-tiles of 8 rows holding an occupied row; the rows past them are
  // written 0 here, 16 bytes a store (F and f0 are multiples of 8, o is
  // 16-byte aligned), and an expert with no occupied row reads nothing
  const int live = (n + 7) / 8;
  const int w8 = min(D_BM, F - f0) / 8;
  for (int i = threadIdx.x; i < (C - 8 * live) * w8; i += blockDim.x)
    *reinterpret_cast<uint4*>(oe + (int64_t)(8 * live + i / w8) * F + f0 +
                              i % w8 * 8) = make_uint4(0, 0, 0, 0);
  if (live == 0) return;
  const int nk = (D + D_BK - 1) / D_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < D_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Thread 0 copies stage kt into its slot: D_MT boxes of w (64 columns
  // of f x D_BK of d each, MN-major) and the live n-tiles of x (8 rows x
  // D_BK, K-major), all 128-byte swizzled.
  const uint32_t bytes =
      2u * (D_TILE_W + ((D_SKIP & 2) ? 0 : live * 8 * D_BK));
  auto load = [&](int kt) {
    const int s = kt % D_STAGES;
    unsigned char* st = ring + s * D_STAGE * 2;
    mbar_expect_tx(&full[s], bytes);
    for (int m = 0; m < D_MT; ++m)
      tma_load(st + m * D_BK * 64 * 2, &w_map, &full[s], f0 + 64 * m,
               kt * D_BK, e);
    if constexpr (!(D_SKIP & 2))
      for (int t = 0; t < live; ++t)
        tma_load(st + (D_TILE_W + t * 8 * D_BK) * 2, &x_map, &full[s],
                 kt * D_BK, 8 * t, e);
  };
  if (threadIdx.x == 0)
    for (int kt = 0; kt < min(D_STAGES, nk); ++kt) load(kt);

  // Warp wi holds A rows (f) 16 wi + g and + 8 of each m-tile, and
  // columns (c) 8 j + 2 q and + 1 of n-tile j (g = lane / 4, q = lane % 4).
  const int wi = threadIdx.x / 32, g = threadIdx.x % 32 / 4,
            q = threadIdx.x % 4;
  // The live n-tiles fixed at compile time: one wgmma of N = 8 LIVE a
  // 16-deep step and m-tile, so ptxas sees how many are in flight.
  with_const<D_NT>(live, [&](auto n_live) {
    constexpr int LIVE = decltype(n_live)::value;
    constexpr int ND = 4 * LIVE;  // accumulator floats a thread per m-tile
    float acc[D_MT][ND];
#pragma unroll
    for (int m = 0; m < D_MT; ++m)
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[m][i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % D_STAGES;
      mbar_wait(&full[s], (kt / D_STAGES) & 1);
      if constexpr (!(D_SKIP & 1)) {
        const unsigned char* st = ring + s * D_STAGE * 2;
        const uint64_t dx = sw128_desc(st + D_TILE_W * 2);
#pragma unroll
        for (int m = 0; m < D_MT; ++m) keep(acc[m]);
        wgmma_fence();
#pragma unroll
        for (int m = 0; m < D_MT; ++m) {
          const uint64_t dw = sw128_desc_mn(st + m * D_BK * 64 * 2, D_BK * 128);
#pragma unroll
          for (int j = 0; j < D_BK / 16; ++j)
            // 16 rows of d a step: + 2048 bytes of w, + 32 bytes of x
            wgmma_bf16_ss_amn(acc[m], dw + 128 * j, dx + 2 * j, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int m = 0; m < D_MT; ++m) keep(acc[m]);
      }
      __syncthreads();  // every warp's products are done with the slot
      if (threadIdx.x == 0 && kt + D_STAGES < nk) load(kt + D_STAGES);
    }

    // acc[m][4 j + 2 h + b] is o^T at f = f0 + 64 m + 16 wi + g + 8 h,
    // c = 8 j + 2 q + b. Rows of c at or past n are written 0, never the
    // accumulator.
#pragma unroll
    for (int m = 0; m < D_MT; ++m)
#pragma unroll
      for (int j = 0; j < LIVE; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int c = 8 * j + 2 * q + b;
            const int f = f0 + 64 * m + 16 * wi + g + 8 * h;
            if (c < C && f < F)
              oe[(int64_t)c * F + f] = __float2bfloat16_rn(
                  c < n ? acc[m][4 * j + 2 * h + b] : 0.f);
          }
  });
}

cudaError_t launch_decode_bf16(const void* x, const void* w, void* o,
                               const int* rows, int E, int C, int D, int F,
                               cudaStream_t stream) {
  CUtensorMap x_map, w_map;
  if (!tensor_map(&x_map, x, D, C, E, D_BK, 8, true) ||
      !tensor_map(&w_map, w, F, D, E, 64, D_BK, true))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_decode_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, D_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((F + D_BM - 1) / D_BM), 1u, (unsigned)E);
  gmm_decode_bf16<<<grid, 128, D_SMEM, stream>>>(
      x_map, w_map, static_cast<__nv_bfloat16*>(o), rows, C, D, F);
  return cudaGetLastError();
}

enum Route {
  ROUTE_SMALL = 0,
  ROUTE_WGMMA = 1,
  ROUTE_LARGE = 2,
  ROUTE_WGMMA_BF16 = 3,
  ROUTE_DECODE_BF16 = 4
};

Route route(const void* x, const void* w, const void* o, int C, int D, int F,
            bool bf16) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(o)) % 16 == 0;
  const int v = bf16 ? 8 : 4;  // elements in 16 bytes (TMA's unit)
  const bool tma = D % v == 0 && F % v == 0 && aligned;
  if (C <= SMALL_C) return bf16 && tma ? ROUTE_DECODE_BF16 : ROUTE_SMALL;
  if (!tma) return ROUTE_LARGE;
  return bf16 ? ROUTE_WGMMA_BF16 : ROUTE_WGMMA;
}

template <typename T, bool VEC>
cudaError_t launch_variant(const void* x, const void* w, void* o,
                           const int* rows, int E, int C, int D, int F,
                           cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(o);
  if (C <= SMALL_C) {
    const dim3 grid((unsigned)((F + S_BN - 1) / S_BN), (unsigned)E);
    gmm_small<T, VEC><<<grid, S_THREADS, 0, stream>>>(xt, wt, ot, rows, C, D,
                                                      F);
  } else {
    constexpr int smem = large_smem_bytes<T>();
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          gmm_large<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return err;
    }
    const dim3 grid((unsigned)((F + L_BN - 1) / L_BN),
                    (unsigned)((C + L_BM - 1) / L_BM), (unsigned)E);
    gmm_large<T, VEC><<<grid, L_THREADS, smem, stream>>>(xt, wt, ot, rows, C,
                                                         D, F);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* o, const int* rows,
                   int E, int C, int D, int F, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);  // elements in 16 bytes
  const bool vec =
      D % V == 0 && F % V == 0 &&
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(o)) % 16 == 0;
  return vec ? launch_variant<T, true>(x, w, o, rows, E, C, D, F, stream)
             : launch_variant<T, false>(x, w, o, rows, E, C, D, F, stream);
}

}  // namespace

// x: (E, C, d), w: (E, d, f), o: (E, C, f), all contiguous and of one
// type (is_bf16 ? bf16 : fp32); every dimension > 0. rows: NULL, or an
// (E,) int32 array on the card (see the note at the top). Launches on
// `stream` and returns the cudaError_t of the launch (0 on success);
// does not synchronise.
extern "C" int repro_grouped_matmul(const void* x, const void* w, void* o,
                                    const int* rows, int E, int C, int D,
                                    int F, int is_bf16, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 ||
      (C + L_BM - 1) / L_BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route(x, w, o, C, D, F, is_bf16)) {
    case ROUTE_WGMMA:
      return (int)launch_wgmma(x, w, o, rows, E, C, D, F, s);
    case ROUTE_WGMMA_BF16:
      return (int)launch_wgmma_bf16(x, w, o, rows, E, C, D, F, s);
    case ROUTE_DECODE_BF16:
      return (int)launch_decode_bf16(x, w, o, rows, E, C, D, F, s);
    default:
      break;
  }
  return (int)(is_bf16
                   ? launch<__nv_bfloat16>(x, w, o, rows, E, C, D, F, s)
                   : launch<float>(x, w, o, rows, E, C, D, F, s));
}

// The variant repro_grouped_matmul launches for these arguments: 0
// gmm_small, 1 gmm_wgmma, 2 gmm_large, 3 gmm_wgmma_bf16, 4
// gmm_decode_bf16.
extern "C" int repro_grouped_matmul_route(const void* x, const void* w,
                                          const void* o, int C, int D, int F,
                                          int is_bf16) {
  return (int)route(x, w, o, C, D, F, is_bf16);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
