// wkv_chunked: the RWKV6 (Finch) WKV recurrence over chunks of 64 tokens
//
//   S_t = diag(w_t)·S_{t−1} + k_t v_tᵀ,   o_t = r_tᵀ (S_{t−1} + diag(u) k_t v_tᵀ)
//
// per (batch, head), with an (hd × hd) float32 state carried across the
// sequence; it returns the outputs and the final state.
//
// Replaces the TPU kernel src/repro/kernels/wkv_chunked.py::wkv_chunked
// (Pallas body _wkv_kernel) and computes its closed form per chunk, with
// cum = the inclusive cumsum of log w over the chunk, cum_prev = cum − log w:
//   cross-chunk   o_t  = (r_t ⊙ e^{cum_prev_t}) · S₀
//   intra-chunk   o_t += Σ_{s<t} (Σ_i r_t[i] k_s[i] e^{cum_prev_t[i] − cum_s[i]}) v_s
//   bonus         o_t += (Σ_i r_t[i] u[i] k_t[i]) v_t
//   state         S    = diag(e^{cum_C}) S₀ + Σ_s (k_s ⊙ e^{cum_C − cum_s}) v_sᵀ
// Every exponent that is used is ≤ 0, so nothing overflows for any decay.
// The TPU grid carries S in VMEM across its sequential chunk axis; Hopper
// blocks run in parallel, so here one block per (head, batch) walks the
// chunks in order with S in shared memory. A tail chunk is padded as the
// TPU wrapper pads it (r = k = v = 0, w = 1): the state is unchanged there.
//
// Bound on the H100: at the rwkv6-7b prefill shape (B=4, S=4096, H=64,
// hd=64; r/k/v bf16, w f32) the function must move 0.81 GB (r, k, v, w,
// out and the final state: 0.24 ms at 3.35 TB/s) and do the recurrence's
// 5·hd² + 5·hd operations per token and head, 2.2e10 (0.33 ms at the
// 67 TFLOP/s of fp32), so operations bound it. The closed form computed
// here does 2.2× that (4.8e10: the (C, C, hd) decay products and exps).
// This first kernel is the simple one: fp32 FFMA and expf on f32 tiles in
// shared memory, no tensor cores; 256 blocks fill the 132 SMs about twice.
//
// Design: 256 threads as a 16 × 16 grid. Per chunk the r, k, v tiles are
// staged as f32 and log w in the cum buffer; 64 threads take the per-channel
// cumsums while 64 others form the bonus diagonal; the intra-chunk scores
// come from 4 × 4 (t, s) micro-tiles (threads wholly above the diagonal
// idle); r and k are then decayed in place, and the output and the new
// state are two 64 × 64 × 64 products each, in registers, written after a
// barrier. Shared memory: seven 64 × 65 f32 tiles, 117 KB, opted into.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;       // tokens per chunk
constexpr int kHd = 64;          // head width
constexpr int kLd = 65;          // padded row of every shared tile
constexpr int kThreads = 256;
constexpr size_t kSmemFloats = 7 * kChunk * kLd + kChunk + kHd;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ s0,
           T* __restrict__ out, float* __restrict__ s_fin, int seq, int h) {
  extern __shared__ float sm[];
  float* rs = sm;                    // r, then r ⊙ e^{cum_prev}
  float* ks = rs + kChunk * kLd;     // k, then k ⊙ e^{cum_C − cum}
  float* vs = ks + kChunk * kLd;     // v
  float* cum = vs + kChunk * kLd;    // log w, then its inclusive cumsum
  float* cp = cum + kChunk * kLd;    // cum − log w
  float* st = cp + kChunk * kLd;     // state S[i][j], i = key, j = value
  float* sc = st + kHd * kLd;        // intra-chunk scores [t][s]
  float* diag = sc + kChunk * kLd;   // bonus diagonal per t
  float* us = diag + kChunk;         // u of this head

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t state_at = ((size_t)b * h + head) * kHd * kHd;

  for (int e = tid; e < kHd * kHd; e += kThreads)
    st[(e / kHd) * kLd + e % kHd] = s0[state_at + e];
  if (tid < kHd) us[tid] = u[head * kHd + tid];

  const int n_chunks = (seq + kChunk - 1) / kChunk;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int t0 = chunk * kChunk;
    __syncthreads();  // the previous chunk's tiles and state are consumed
    for (int e = tid; e < kChunk * kHd; e += kThreads) {
      const int t = e / kHd, i = e % kHd;
      const int gt = t0 + t;
      const bool live = gt < seq;
      const size_t at = (((size_t)b * seq + gt) * h + head) * kHd + i;
      rs[t * kLd + i] = live ? to_f32(r[at]) : 0.f;
      ks[t * kLd + i] = live ? to_f32(k[at]) : 0.f;
      vs[t * kLd + i] = live ? to_f32(v[at]) : 0.f;
      cum[t * kLd + i] = logf(fmaxf(live ? w[at] : 1.f, 1e-38f));
    }
    __syncthreads();

    if (tid < kHd) {
      float run = 0.f;
      for (int t = 0; t < kChunk; ++t) {
        const float lw = cum[t * kLd + tid];
        run += lw;
        cum[t * kLd + tid] = run;
        cp[t * kLd + tid] = run - lw;
      }
    } else if (tid < kHd + kChunk) {
      const int t = tid - kHd;
      float a = 0.f;
      for (int i = 0; i < kHd; ++i)
        a += rs[t * kLd + i] * us[i] * ks[t * kLd + i];
      diag[t] = a;
    }
    __syncthreads();

    // scores[t][s], t = 4·ty + a, s = 4·tx + c, only s < t
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
    if (tx <= ty) {
      for (int i = 0; i < kHd; ++i) {
        float ra[4], ca[4], kc[4], cc[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          ra[a] = rs[(ty * 4 + a) * kLd + i];
          ca[a] = cp[(ty * 4 + a) * kLd + i];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          kc[c] = ks[(tx * 4 + c) * kLd + i];
          cc[c] = cum[(tx * 4 + c) * kLd + i];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (tx < ty || c < a)
              acc[a][c] += (ra[a] * kc[c]) * expf(ca[a] - cc[c]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sc[(ty * 4 + a) * kLd + tx * 4 + c] = acc[a][c];
    __syncthreads();

    for (int e = tid; e < kChunk * kHd; e += kThreads) {
      const int t = e / kHd, i = e % kHd;
      rs[t * kLd + i] *= expf(cp[t * kLd + i]);
      ks[t * kLd + i] *= expf(cum[(kChunk - 1) * kLd + i] - cum[t * kLd + i]);
    }
    __syncthreads();

    // output rows t = 4·ty + a, value columns j = tx + 16·c
    float o1[4][4], o2[4][4], ns[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) o1[a][c] = o2[a][c] = ns[a][c] = 0.f;
    for (int i = 0; i < kHd; ++i) {
      float ra[4], sb[4], ka[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ra[a] = rs[(ty * 4 + a) * kLd + i];
        ka[a] = ks[i * kLd + ty * 4 + a];   // k_dec[s = i][key 4·ty + a]
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) sb[c] = st[i * kLd + tx + 16 * c];
      float pa[4], vb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = sc[(ty * 4 + a) * kLd + i];
#pragma unroll
      for (int c = 0; c < 4; ++c) vb[c] = vs[i * kLd + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          o1[a][c] = fmaf(ra[a], sb[c], o1[a][c]);
          o2[a][c] = fmaf(pa[a], vb[c], o2[a][c]);
          ns[a][c] = fmaf(ka[a], vb[c], ns[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = ty * 4 + a;
      const int key = ty * 4 + a;
      const float decay = expf(cum[(kChunk - 1) * kLd + key]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        ns[a][c] = decay * st[key * kLd + j] + ns[a][c];
        if (t0 + t < seq) {
          const float o = (o1[a][c] + o2[a][c]) + diag[t] * vs[t * kLd + j];
          out[(((size_t)b * seq + t0 + t) * h + head) * kHd + j] =
              from_f32<T>(o);
        }
      }
    }
    __syncthreads();  // every read of S₀ is done
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[(ty * 4 + a) * kLd + tx + 16 * c] = ns[a][c];
  }
  __syncthreads();
  for (int e = tid; e < kHd * kHd; e += kThreads)
    s_fin[state_at + e] = st[(e / kHd) * kLd + e % kHd];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* out, float* s_fin, int b,
           int seq, int h, cudaStream_t stream) {
  const size_t smem = kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_kernel<T><<<dim3(h, b), kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<T*>(out), s_fin, seq,
      h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v: (b, seq, h, 64) in one type (dtype 0 = float32, 1 = bfloat16,
// 2 = float16); w: (b, seq, h, 64) float32 decays in (0, 1]; u: (h, 64)
// float32; s0: (b, h, 64, 64) float32 initial state; out: like r;
// s_fin: like s0. All contiguous on the device. Launches on `stream`, does
// not synchronise, allocates nothing.
extern "C" int repro_wkv_chunked(const void* r, const void* k, const void* v,
                                 const float* w, const float* u,
                                 const float* s0, void* out, float* s_fin,
                                 int dtype, int b, int seq, int h, int hd,
                                 cudaStream_t stream) {
  if (b <= 0 || seq <= 0 || h <= 0 || hd != kHd)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch<float>(r, k, v, w, u, s0, out, s_fin, b, seq, h, stream);
    case 1:
      return launch<__nv_bfloat16>(r, k, v, w, u, s0, out, s_fin, b, seq, h,
                                   stream);
    case 2:
      return launch<__half>(r, k, v, w, u, s0, out, s_fin, b, seq, h,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
