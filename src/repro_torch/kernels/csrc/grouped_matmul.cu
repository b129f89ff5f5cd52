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
// waits on the host; it writes o[e, r, :] = 0 for those rows without
// reading x or w for them, and an expert with rows[e] = 0 reads none of
// its weights. With rows == NULL every row is computed.
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
//    the ragged C, d and f edges are masked in the kernel: loads past an
//    edge read 0 and stores past an edge are skipped, so any shape with
//    non-zero dimensions is right, (1, 1, 1, 1) included.
//
// Two variants, chosen from C on the host (which never reads `rows`):
//
//  * C <= 32, bound by bytes (the decode step of qwen2-moe-a2.7b:
//    (60, 32, 2048) x (60, 2048, 1408) at B = 4, where at most 16
//    experts hold a token and each at most 4 rows). Its bound counts the
//    weights of the experts that hold a token, their occupied rows of x
//    and all of o: about 15 of 60 experts' weights. A block owns one
//    (expert, 32-column slice of f) and streams that slice of w through
//    a 2-stage ring of 64-deep chunks in shared memory with 16-byte
//    cp.async copies, one chunk (8 KB in fp32) in flight while the other
//    is consumed; the 44-64 column slices of each of the ~15 active
//    experts give 660-960 blocks, several on every one of the 132 SMs.
//    Only the occupied rows are computed: the 32 lanes of a block split
//    those rows and the chunk's depth between them (4 rows: 4 row lanes
//    x 8 depth lanes) and sum their partial products in shared memory in
//    a fixed order at the end. (tools/k2_variants.py times other tile
//    choices.)
//  * C > 32, bound by fp32 operations (the prefill: (60, 192, 2048) x
//    (60, 2048, 1408) does 66 GFLOP against 0.85 GB). A register-tiled
//    SGEMM: a block of 128 threads owns a 64 x 128 output tile (64
//    divides C = 192, 128 divides 1408 and 2048), each thread an 8 x 8
//    register tile, so every depth step issues 64 FMAs against four
//    16-byte shared-memory loads (x is staged transposed, k-major, so
//    its reads vectorise like w's). w streams through a 3-stage
//    cp.async ring of 16-deep chunks; the next chunk of x is loaded into
//    registers during the FMAs and stored transposed after them. Row
//    tiles at or past rows[e] are zero-filled without any load.
//
// The products are plain IEEE fp32 FMAs on the CUDA cores. Tensor cores
// are left to later work: the main path is fp32 and must meet 2e-5
// against the plain version, which TF32 cannot, and a 3xTF32 split would
// run faster than the fp32 bound the measurements state, which would
// first have to be restated. The vector copies need d and f to be
// multiples of 16 bytes' worth of elements and 16-byte aligned
// pointers; other shapes take scalar loads through the same tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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
// C > SMALL_C: register-tiled fp32 SGEMM.
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
  return (int)(is_bf16
                   ? launch<__nv_bfloat16>(x, w, o, rows, E, C, D, F, s)
                   : launch<float>(x, w, o, rows, E, C, D, F, s));
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
