// flash_attention: blocked online-softmax attention with causal and
// sliding-window masks, a query offset and grouped-query heads.
//
//   out[b, q, h, :] = softmax_s(q·k[s]ᵀ / √hd  over the visible s) · v
//   visible: s < Skv, causal → s ≤ q + q_offset,
//            window > 0 → s > q + q_offset − window;
//   query head h reads kv head h / (H / K).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (Pallas body _flash_kernel). The TPU grid walks the kv
// blocks of one q block in order on one core and carries m, l and acc in
// VMEM scratch between grid steps, skipping whole kv blocks outside the
// band with pl.when. Hopper blocks run in parallel and carry nothing, so
// here one block owns a 64-row q tile of one (batch, head) and walks the kv
// tiles of its kv head itself, in order, with m, l and acc in registers;
// tiles wholly outside the causal/window band are skipped by the same test.
//
// Bound on the H100: at the qwen2-1.5b prefill shape (B=4, S=4096, H=12,
// K=2, hd=128, bf16, causal) the work is 4·B·H·S²·hd/2 = 0.206 TFLOP on
// 0.13 GB of q/k/v/out: 0.21 ms at the 989 TFLOP/s bf16 tensor-core peak,
// 3.1 ms at the 67 TFLOP/s of fp32 FFMA that this kernel uses. This first
// kernel is the simple one: fp32 FFMA on f32 tiles in shared memory, no
// tensor cores, no TMA; wgmma with bf16 tiles is the later optimisation.
//
// Design: 256 threads as a 16 × 16 grid. Thread (ty, tx) owns query rows
// 4·ty … 4·ty+3 and, of each 64-column S tile, columns tx + 16·j; of the
// output, head-dim columns tx + 16·c. Per kv tile: K (transposed) and V
// are staged as f32 in shared memory, S = Q·Kᵀ by fp32 FFMA, scaled, masked
// to −1e30; the row max and sum go across the 16 lanes of a row by
// shuffles; P goes through shared memory into acc += P·V. The output is
// acc / max(l, 1e-30), rounded once to the input type. expf, not the fast
// approximation: the result equals the plain PyTorch version to f32
// rounding. Shared memory is above 48 KB (116 KB at hd = 128, 66 KB at
// hd = 64) and is opted into.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // q rows and kv columns per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

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

template <int HD>
constexpr size_t smem_floats() {
  return kTile * (HD + 4)        // q tile, rows padded
         + HD * (kTile + 1)      // k tile transposed, [d][col]
         + kTile * HD            // v tile
         + kTile * (kTile + 1);  // p tile
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int sq, int skv,
             int h, int kh, int causal, int window, int q_offset,
             float scale) {
  constexpr int kQld = HD + 4;
  constexpr int kKld = kTile + 1;
  constexpr int kPld = kTile + 1;
  constexpr int kCols = HD / 16;           // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* kt = qs + kTile * kQld;
  float* vs = kt + HD * kKld;
  float* ps = vs + kTile * HD;

  const int q0 = blockIdx.x * kTile;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / kh);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  for (int e = threadIdx.x; e < kTile * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int gq = q0 + r;
    qs[r * kQld + d] =
        gq < sq ? to_f32(q[(((size_t)b * sq + gq) * h + head) * HD + d])
                : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int row_lo = q0 + q_offset;
  const int row_hi = row_lo + kTile - 1;
  const int n_tiles = (skv + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int c0 = tile * kTile;
    // the Pallas band test: the same for every thread of the block
    bool band = c0 < skv;
    if (causal) band = band && c0 <= row_hi;
    if (window) band = band && c0 + kTile - 1 > row_lo - window;
    if (!band) continue;

    __syncthreads();  // the previous tile's k, v and p are consumed
    for (int e = threadIdx.x; e < kTile * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      const int gc = c0 + r;
      const size_t at = (((size_t)b * skv + gc) * kh + kvh) * HD + d;
      kt[d * kKld + r] = gc < skv ? to_f32(k[at]) : 0.f;
      vs[r * HD + d] = gc < skv ? to_f32(v[at]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * kQld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = kt[d * kKld + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row_lo + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        ok[j] = col < skv;
        if (causal) ok[j] = ok[j] && col <= row;
        if (window) ok[j] = ok[j] && col > row - window;
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty * 4 + i) * kPld + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int cc = 0; cc < kTile; ++cc) {
      float pa[4], vb[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ps[(ty * 4 + i) * kPld + cc];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vb[c] = vs[cc * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(pa[i], vb[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + ty * 4 + i;
    if (gq >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* dst = out + (((size_t)b * sq + gq) * h + head) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      dst[tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int h, int kh, int causal, int window,
           int q_offset, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  auto kernel = flash_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kTile - 1) / kTile, h, b);
  const float scale = (float)(1.0 / sqrt((double)HD));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, h, kh,
      causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              void* out, int b, int sq, int skv, int h, int kh, int causal,
              int window, int q_offset, cudaStream_t stream) {
  if (hd == 64)
    return launch<T, 64>(q, k, v, out, b, sq, skv, h, kh, causal, window,
                         q_offset, stream);
  if (hd == 128)
    return launch<T, 128>(q, k, v, out, b, sq, skv, h, kh, causal, window,
                          q_offset, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: (b, sq, h, hd), k/v: (b, skv, kh, hd), out: (b, sq, h, hd), all
// contiguous on the device in one type: dtype 0 = float32, 1 = bfloat16,
// 2 = float16. hd is 64 or 128, h a multiple of kh. Launches on `stream`,
// does not synchronise, allocates nothing.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int dtype,
                                     int b, int sq, int skv, int h, int kh,
                                     int hd, int causal, int window,
                                     int q_offset, cudaStream_t stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || kh <= 0 || h % kh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch_hd<float>(hd, q, k, v, out, b, sq, skv, h, kh, causal,
                              window, q_offset, stream);
    case 1:
      return launch_hd<__nv_bfloat16>(hd, q, k, v, out, b, sq, skv, h, kh,
                                      causal, window, q_offset, stream);
    case 2:
      return launch_hd<__half>(hd, q, k, v, out, b, sq, skv, h, kh, causal,
                               window, q_offset, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
