// Forward flash attention with GQA for Hopper (sm_90a), fp32 or bf16 in,
// fp32 arithmetic throughout, output in the input's type.
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
//    (batch*head, 64-row query tile) and loops over 64-key tiles itself,
//    with m, l and the accumulator in registers. Causal blocks stop at
//    the last tile their rows can see, and the heaviest query tiles are
//    launched first.
//
// What bounds it on an H100: at the serving shapes (hd = 64, S ~ 500)
// a block does 4 * 64 * hd multiply-adds per key tile against 2 * 64 * hd
// values loaded, so it is bound by operations, not by device memory
// (fp32: ~27 us of FMA at 67 TFLOP/s against ~5 us of bytes at
// 3.35 TB/s). The design keeps every score, probability and partial sum
// on chip: q, k and v are read once per block into shared memory,
// converted to fp32 there, and only the output goes back to device
// memory. The products are plain IEEE fp32 FMAs on the CUDA cores (no
// TF32, so fp32 results meet a 2e-5 tolerance); each thread holds a
// 4 x 4 block of scores and a 4 x hd/16 block of the output so that one
// shared-memory load feeds four FMAs. Tensor cores (mma / wgmma), TMA
// and warp specialisation are left to later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int THREADS = 256;     // a 16 x 16 grid of threads
constexpr int TR = BQ / 16;      // query rows per thread
constexpr int TC = BK / 16;      // score columns per thread
constexpr int LDP = BK + 1;      // padded row stride of the probability tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Sum or max over the 16 lanes that share a query row (one half-warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  // sQ and sK padded to HD + 1 columns, sV unpadded, sP padded.
  return sizeof(float) * (size_t)(BQ * (HD + 1) + BK * (HD + 1) + BK * HD +
                                  BQ * LDP);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Sq,
                     int Sk, int H, int Hkv, int causal, float scale) {
  constexpr int LD = HD + 1;  // odd stride: rows land in distinct banks
  constexpr int NC = HD / 16; // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // BQ x LD
  float* sK = sQ + BQ * LD;    // BK x LD
  float* sV = sK + BK * LD;    // BK x HD
  float* sP = sV + BK * HD;    // BQ x LDP

  const int tid = threadIdx.x;
  const int tx = tid & 15;     // score / output column group
  const int ty = tid >> 4;     // query row group
  const int bh = blockIdx.x;   // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / Hkv);
  // Heaviest (latest) causal tiles first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;

  const int64_t q_row = (int64_t)H * HD;    // elements between positions
  const int64_t kv_row = (int64_t)Hkv * HD;
  const T* qb = q + ((int64_t)b * Sq * H + h) * HD;
  const T* kb = k + ((int64_t)b * Sk * Hkv + kvh) * HD;
  const T* vb = v + ((int64_t)b * Sk * Hkv + kvh) * HD;
  T* ob = o + ((int64_t)b * Sq * H + h) * HD;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD, row = q0 + r;
    sQ[r * LD + d] = row < Sq ? to_float(qb[row * q_row + d]) : 0.f;
  }

  float m[TR], l[TR], acc[TR][NC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  const int offset = Sk - Sq;  // >= 0 when causal (checked on the host)
  const int k_end = causal ? min(Sk, q0 + BQ + offset) : Sk;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's sK / sV / sP are consumed
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, d = i % HD, col = k0 + r;
      const bool in = col < Sk;
      sK[r * LD + d] = in ? to_float(kb[col * kv_row + d]) : 0.f;
      sV[r * HD + d] = in ? to_float(vb[col * kv_row + d]) : 0.f;
    }
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qr[TR], kc[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) qr[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < TC; ++j) kc[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool seen = col < Sk && (!causal || col <= row + offset);
        s[i][j] = seen ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[r * LDP + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float pr[TR], vc[NC];
#pragma unroll
      for (int i = 0; i < TR; ++i) pr[i] = sP[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int n = 0; n < NC; ++n) vc[n] = sV[c * HD + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(pr[i], vc[n], acc[i][n]);
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NC; ++n)
      store(&ob[row * q_row + tx + 16 * n], acc[i][n] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int Hkv, int causal,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / std::sqrt((double)HD));
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ));
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, Hkv, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, Sq, H, hd) contiguous; k, v: (B, Sk, Hkv, hd) contiguous, all
// of one type (is_bf16 ? bf16 : fp32). hd is 64 or 128; H % Hkv == 0;
// causal requires Sq <= Sk. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success); does not synchronise.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int Sq, int Sk, int H, int Hkv,
                                         int hd, int is_bf16, int causal,
                                         void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      (causal && Sq > Sk) || (Sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return (int)(is_bf16
                     ? launch<__nv_bfloat16, 64>(q, k, v, o, B, Sq, Sk, H, Hkv,
                                                 causal, s)
                     : launch<float, 64>(q, k, v, o, B, Sq, Sk, H, Hkv, causal,
                                         s));
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
