// Grouped (per-expert) matrix product for Hopper (sm_90a): for every
// expert e, o[e] = x[e] @ w[e], with x (E, C, d), w (E, d, f) and
// o (E, C, f); fp32 or bf16 in, fp32 accumulation, output in x's type.
//
// Replaces the TPU kernel `_gmm_kernel` in src/repro/kernels/moe_gmm.py
// (launched by grouped_matmul there, wrapped by
// repro.kernels.ops.grouped_matmul). It computes the same function: an
// fp32 accumulator over the whole d axis, written once in x's type.
//
// What differs from the TPU kernel, by design:
//  * The TPU grid (e, ci, fi, di) walks the reduction axis d as its
//    sequential last dimension and carries the accumulator in VMEM
//    scratch between grid steps. CUDA blocks run in no order and share
//    nothing, so a block owns one (expert, 64-row tile of C, 64-column
//    tile of f) output tile and loops over d in chunks of 32 itself,
//    with the accumulator in registers.
//  * No padding. The reference wrapper pads C to 128 and d to 512 (and
//    the MoE expert width d_expert = 1408 is no multiple of 512). Here
//    the ragged C, d and f edges are masked in the kernel: loads past an
//    edge read 0 and stores past an edge are skipped, so any shape with
//    non-zero dimensions is right, (1, 1, 1, 1) included.
//
// What bounds it on an H100 at the MoE serving shapes (qwen2-moe-a2.7b,
// fp32): the prefill product (60, 192, 2048) x (60, 2048, 1408) does
// 66.4 GFLOP against 0.85 GB moved, so it is bound by operations
// (0.99 ms at 67 TFLOP/s against 0.25 ms of bytes); the decode product
// (60, 32, 2048) x (60, 2048, 1408) reads every expert's weights for 32
// rows, so it is bound by bytes (0.21 ms at 3.35 TB/s against 0.17 ms
// of operations). The design stages a 64 x 32 tile of x and a 32 x 64
// tile of w in shared memory, converted to fp32 there, and a 16 x 16
// thread grid keeps a 4 x 4 fp32 register tile per thread, so that one
// shared-memory load feeds four FMAs; each weight is read from device
// memory once per 64-row tile of C. The products are plain IEEE fp32
// FMAs on the CUDA cores (no TF32, so fp32 results meet a 2e-5
// tolerance). It uses no tensor cores yet; mma / wgmma with TMA, and
// skipping the capacity slots that hold no token, are left to later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;        // rows of C per block
constexpr int BN = 64;        // columns of f per block
constexpr int BK = 32;        // depth of d per staged chunk
constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int TM = BM / 16;   // output rows per thread
constexpr int TN = BN / 16;   // output columns per thread

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ o, int C, int D, int F) {
  // sX's odd stride puts the two rows a warp reads in distinct banks.
  __shared__ float sX[BM][BK + 1];
  __shared__ float sW[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // output column group
  const int ty = tid >> 4;  // output row group
  const int r0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  const int64_t e = blockIdx.z;
  const T* xe = x + e * C * D;
  const T* we = w + e * D * F;
  T* oe = o + e * C * F;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    // Consecutive threads read consecutive elements of a row of x and
    // of w, so the loads coalesce.
#pragma unroll
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int row = r0 + r, k = k0 + kk;
      sX[r][kk] =
          row < C && k < D ? to_float(xe[(int64_t)row * D + k]) : 0.f;
    }
#pragma unroll
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kk = i / BN, c = i % BN;
      const int k = k0 + kk, col = c0 + c;
      sW[kk][c] =
          k < D && col < F ? to_float(we[(int64_t)k * F + col]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sX[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sW[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // this chunk's sX / sW are consumed
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= C) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < F) store(&oe[(int64_t)row * F + col], acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* o, int E, int C,
                   int D, int F, cudaStream_t stream) {
  const dim3 grid((unsigned)((F + BN - 1) / BN), (unsigned)((C + BM - 1) / BM),
                  (unsigned)E);
  gmm_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(o),
      C, D, F);
  return cudaGetLastError();
}

}  // namespace

// x: (E, C, d), w: (E, d, f), o: (E, C, f), all contiguous and of one
// type (is_bf16 ? bf16 : fp32); every dimension > 0. Launches on
// `stream` and returns the cudaError_t of the launch (0 on success);
// does not synchronise.
extern "C" int repro_grouped_matmul(const void* x, const void* w, void* o,
                                    int E, int C, int D, int F, int is_bf16,
                                    void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 ||
      (C + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(x, w, o, E, C, D, F, s)
                       : launch<float>(x, w, o, E, C, D, F, s));
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
