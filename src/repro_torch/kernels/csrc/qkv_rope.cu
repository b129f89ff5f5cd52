// The q/k/v epilogue of GQA attention for Hopper (sm_90a), K3: one launch
// takes an attention layer's three projection outputs and does, token by
// token, what the plain chain (kernels/ref.py, qkv_rope_ref) does in about
// fifty torch launches: the q/k/v bias, each head's RMSNorm of q and k
// (qk-norm), split-half RoPE with fp32 angles, q and k written in the
// input's type, and k and v written into their rows of the KV cache in
// the cache's type.
//
// It replaces no TPU kernel: the reference leaves this chain to XLA, which
// fuses it into the projections' epilogue. Run op by op, each step is a
// launch and, in fp32, a temporary in device memory.
//
// The same arithmetic as the chain. Every value is computed in fp32 and
// rounded to the input's type exactly where the chain rounds: the bias
// sum, the rsqrt factor, x * r, (x * r) * scale and each RoPE output. Each
// product and sum that the chain takes as an op of its own is an
// __fmul_rn / __fadd_rn / __fsub_rn here, which nvcc never contracts into
// an FMA; cos and sin are the precise sincosf (with theta = 1e6 the angles
// reach thousands of radians). The one step taken in another order is the
// RMSNorm's sum of squares (xor shuffles here, torch's reduction tree
// there): in bf16 a head whose fp32 factor lies within a few fp32 ulps of a
// bf16 rounding boundary may round its factor the other way.
//
// What bounds it on an H100: bytes. It does about 10 operations an element
// against 6-16 bytes moved, ~0.1 a byte where the card turns bound by
// operations at ~295. The least time reads q, k and v once, writes q and
// k, and writes k and v to the cache, at 3.35 TB/s. The design:
//  * One pass. A block takes TOK consecutive tokens with all their q, k
//    and v heads; nothing goes to device memory but the outputs.
//  * cos and sin once per (token, frequency): the block first fills a
//    table of its tokens' cos and sin rows in shared memory from the
//    positions and the 1/theta^(2i/hd) table, and every head of those
//    tokens reads it.
//  * A head is the task of a group of `lanes` threads (a power of two up
//    to 32). Lane l holds vector l of the head's first half and vector l
//    of its second half, the pairs that RoPE rotates together, loaded and
//    stored 16 bytes at a time (8 bf16 or 4 fp32 values); where hd/2 or a
//    pointer does not allow that, one value at a time. The RMS statistic
//    is summed by xor shuffles within the group.
//  * Launched on the caller's stream; allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TOK = 16;  // tokens a block takes at most
constexpr int MAX_HD = 256;

struct Args {
  const void *q, *k, *v;     // (B, S, H*hd), (B, S, Hkv*hd), (B, S, Hkv*hd)
  void *qo, *ko, *vo;        // (B, S, H, hd), (B, S, Hkv, hd) x2; vo NULL: v
                             // is not written out
  const void *bq, *bk, *bv;  // biases (H*hd,), (Hkv*hd,) x2, or all NULL
  const void *qs, *ks;       // qk-norm scales (hd,), or both NULL
  const float* freqs;        // (hd/2,): 1/theta^(2i/hd)
  const int* pos;            // (B, S), batch stride pos_bs
  void *kc, *vc;             // caches (B, T, Hkv, hd), or both NULL
  int B, S, H, Hkv, hd, pos_bs, T, off;  // cache rows off .. off + S - 1
  float eps, inv_hd;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T, held in fp32: where the chain's op writes a T tensor
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

// N consecutive values of T, copied as one (16 bytes at most a piece)
template <typename T, int N>
struct alignas(N * sizeof(T) >= 16 ? 16 : N * sizeof(T)) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load(const T* p, float (&out)[N]) {
  const Pack<T, N> pk = *reinterpret_cast<const Pack<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f(pk.v[i]);
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const float (&in)[N]) {
  Pack<T, N> pk;
#pragma unroll
  for (int i = 0; i < N; ++i) pk.v[i] = from_f<T>(in[i]);
  *reinterpret_cast<Pack<T, N>*>(p) = pk;
}

// T: the input's type; CT: the cache's; VEC values a vector; NV vectors of
// each half a lane at most.
template <typename T, typename CT, int VEC, int NV>
__global__ void __launch_bounds__(THREADS)
    qkv_rope(const Args a, const int tok_per_block, const int lanes) {
  extern __shared__ float table[];  // cos rows, then sin rows: [tok][hd/2]
  const int half = a.hd / 2;
  const int64_t n_tok = (int64_t)a.B * a.S;
  const int64_t tok0 = (int64_t)blockIdx.x * tok_per_block;
  const int ntok = (int)(n_tok - tok0 < tok_per_block ? n_tok - tok0
                                                      : tok_per_block);
  float* cos_t = table;
  float* sin_t = table + tok_per_block * half;
  for (int i = threadIdx.x; i < ntok * half; i += THREADS) {
    const int t = i / half, f = i - t * half;
    const int64_t tok = tok0 + t;
    const int64_t b = tok / a.S, s = tok - b * a.S;
    const float ang = __fmul_rn(__int2float_rn(a.pos[b * a.pos_bs + s]),
                                a.freqs[f]);
    sincosf(ang, &sin_t[i], &cos_t[i]);
  }
  __syncthreads();

  const bool do_v = a.vo != nullptr || a.vc != nullptr;
  const int per_tok = a.H + a.Hkv + (do_v ? a.Hkv : 0);
  const int tasks = ntok * per_tok;
  const int groups = THREADS / lanes;
  const int group = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  // a warp's groups loop together, so that every lane reaches the shuffles
  const int warp_group0 = (threadIdx.x / 32) * (32 / lanes);
  for (int base = 0; base + warp_group0 < tasks; base += groups) {
    const int task = base + group;
    const bool live = task < tasks;
    const int t = live ? task / per_tok : 0;
    const int h = live ? task - t * per_tok : 0;
    const int64_t tok = tok0 + t;
    const int64_t b = tok / a.S, s = tok - b * a.S;
    // kind 0: a q head, 1: a k head, 2: a v head
    const int kind = h < a.H ? 0 : (h < a.H + a.Hkv ? 1 : 2);
    const int head = kind == 0 ? h : (kind == 1 ? h - a.H : h - a.H - a.Hkv);
    const int nh = kind == 0 ? a.H : a.Hkv;
    const int64_t row = (tok * nh + head) * a.hd;
    const T* src = static_cast<const T*>(kind == 0 ? a.q
                                         : (kind == 1 ? a.k : a.v)) + row;
    const T* bias = static_cast<const T*>(kind == 0 ? a.bq
                                          : (kind == 1 ? a.bk : a.bv));
    const T* scale = static_cast<const T*>(kind == 0 ? a.qs
                                           : (kind == 1 ? a.ks : nullptr));
    T* dst = static_cast<T*>(kind == 0 ? a.qo : (kind == 1 ? a.ko : a.vo));
    CT* cache = static_cast<CT*>(kind == 0 ? nullptr
                                 : (kind == 1 ? a.kc : a.vc));
    if (bias) bias += (int64_t)head * a.hd;
    if (dst) dst += row;
    if (cache) cache += ((b * a.T + a.off + s) * a.Hkv + head) * a.hd;

    float x1[NV][VEC], x2[NV][VEC];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e = (lane + j * lanes) * VEC;
      if (live && e < half) {
        load<T, VEC>(src + e, x1[j]);
        load<T, VEC>(src + half + e, x2[j]);
        if (bias) {
          float b1[VEC], b2[VEC];
          load<T, VEC>(bias + e, b1);
          load<T, VEC>(bias + half + e, b2);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            x1[j][i] = rnd<T>(__fadd_rn(x1[j][i], b1[i]));
            x2[j][i] = rnd<T>(__fadd_rn(x2[j][i], b2[i]));
          }
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          ss = fmaf(x1[j][i], x1[j][i], fmaf(x2[j][i], x2[j][i], ss));
      }
    }
    for (int o = lanes / 2; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (!live) continue;

    if (kind < 2) {
      const float r =
          scale ? rnd<T>(rsqrtf(__fadd_rn(__fmul_rn(ss, a.inv_hd), a.eps)))
                : 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int e = (lane + j * lanes) * VEC;
        if (e >= half) continue;
        if (scale) {
          float s1[VEC], s2[VEC];
          load<T, VEC>(scale + e, s1);
          load<T, VEC>(scale + half + e, s2);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            x1[j][i] = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(x1[j][i], r)), s1[i]));
            x2[j][i] = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(x2[j][i], r)), s2[i]));
          }
        }
        const float* c = cos_t + t * half + e;
        const float* sn = sin_t + t * half + e;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float u = x1[j][i], w = x2[j][i];
          x1[j][i] = rnd<T>(__fsub_rn(__fmul_rn(u, c[i]), __fmul_rn(w, sn[i])));
          x2[j][i] = rnd<T>(__fadd_rn(__fmul_rn(u, sn[i]), __fmul_rn(w, c[i])));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e = (lane + j * lanes) * VEC;
      if (e >= half) continue;
      if (dst) {
        store<T, VEC>(dst + e, x1[j]);
        store<T, VEC>(dst + half + e, x2[j]);
      }
      if (cache) {
        store<CT, VEC>(cache + e, x1[j]);
        store<CT, VEC>(cache + half + e, x2[j]);
      }
    }
  }
}

template <typename T, typename CT, int VEC, int NV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int half = a.hd / 2;
  const int nvec = half / VEC;
  int lanes = 1;
  while (lanes < nvec && lanes < 32) lanes *= 2;
  if ((nvec + lanes - 1) / lanes > NV) return cudaErrorInvalidValue;
  const bool do_v = a.vo != nullptr || a.vc != nullptr;
  const int per_tok = a.H + a.Hkv + (do_v ? a.Hkv : 0);
  const int64_t n_tok = (int64_t)a.B * a.S;
  // about four rounds of the block's groups over its tokens' heads; one
  // token a block where fewer tokens than two blocks an SM would leave SMs
  // idle
  int tok = 4 * (THREADS / lanes) / per_tok;
  tok = tok < 1 ? 1 : (tok > MAX_TOK ? MAX_TOK : tok);
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  if (n_tok < (int64_t)tok * 2 * sms) tok = 1;
  const int64_t blocks = (n_tok + tok - 1) / tok;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)tok * half * sizeof(float);
  qkv_rope<T, CT, VEC, NV>
      <<<(unsigned)blocks, THREADS, smem, stream>>>(a, tok, lanes);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// wide: 16-byte vectors; else one value at a time
template <typename T, typename CT>
cudaError_t dispatch(const Args& a, bool wide, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  return wide ? launch<T, CT, V, 1>(a, s) : launch<T, CT, 1, 4>(a, s);
}

}  // namespace

// q (B, S, H*hd), k and v (B, S, Hkv*hd): contiguous, of one type
// (is_bf16 ? bf16 : fp32). qo (B, S, H, hd) and ko (B, S, Hkv, hd) are
// written; vo (B, S, Hkv, hd) too where it is not NULL. bq, bk, bv: the
// biases, all NULL or none; qs, ks: the qk-norm scales (hd,), both NULL or
// neither, all of the input's type. freqs (hd/2,) fp32; pos (B, S) int32
// with batch stride pos_bs (0: one row for the batch). kc, vc: the caches
// (B, T, Hkv, hd) contiguous, of one type (cache_bf16 ? bf16 : fp32), or
// both NULL; rows off .. off + S - 1 are written. hd even, at most 256.
// wide asks for 16-byte vectors: hd / 2 a multiple of 16 bytes' values and
// every pointer but freqs and pos 16-byte aligned. Launches on `stream`,
// returns the cudaError_t of the launch (0 on success); does not
// synchronise.
extern "C" int repro_qkv_rope(const void* q, const void* k, const void* v,
                              void* qo, void* ko, void* vo, const void* bq,
                              const void* bk, const void* bv, const void* qs,
                              const void* ks, const void* freqs,
                              const void* pos, void* kc, void* vc, int B,
                              int S, int H, int Hkv, int hd, int pos_bs,
                              int T, int off, int is_bf16, int cache_bf16,
                              int wide, float eps, float inv_hd,
                              void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || hd <= 0 || hd % 2 ||
      hd > MAX_HD || pos_bs < 0 || !q || !k || !v || !qo || !ko || !freqs ||
      !pos || (!bq != !bk) || (!bq != !bv) || (!qs != !ks) || (!kc != !vc) ||
      (kc && (off < 0 || off + S > T)))
    return (int)cudaErrorInvalidValue;
  if (wide) {
    const int vec = is_bf16 ? 8 : 4;
    const void* ptrs[] = {q, k, v, qo, ko, vo, bq, bk, bv, qs, ks, kc, vc};
    if ((hd / 2) % vec) return (int)cudaErrorInvalidValue;
    for (const void* p : ptrs)
      if (p && !aligned16(p)) return (int)cudaErrorMisalignedAddress;
  }
  const Args a{q,  k,  v,  qo,  ko,  vo,  bq,  bk,  bv,     qs,
               ks, static_cast<const float*>(freqs),
               static_cast<const int*>(pos), kc, vc, B, S, H, Hkv, hd,
               pos_bs, kc ? T : 0, kc ? off : 0, eps, inv_hd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)(cache_bf16 ? dispatch<__nv_bfloat16, __nv_bfloat16>(a, wide, s)
                            : dispatch<__nv_bfloat16, float>(a, wide, s));
  return (int)(cache_bf16 ? dispatch<float, __nv_bfloat16>(a, wide, s)
                          : dispatch<float, float>(a, wide, s));
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
