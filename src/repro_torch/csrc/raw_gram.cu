// raw_gram: the Eq. 7 header Gram  out = x · xᵀ  in float32.
//
// Replaces the TPU kernel src/repro/kernels/peer_score.py::raw_gram
// (Pallas body _gram_kernel): a blocked x·xᵀ with an f32 accumulator
// over P. It serves header_distance_matrix(use_kernel=True), i.e. the
// random and threshold selection modes of the PFedDST round.
//
// Bound on the H100: the product takes 2·M²·P operations on M·P·4 bytes
// of input and M²·4 bytes of output. At the round's shape (M = 16,
// P = 5130) the bytes set the floor: 0.33 MB at 3.35 TB/s is about 0.1 µs,
// against 0.04 µs for 2.6e6 FLOP at the 67 TFLOP/s of non-tensor fp32.
// From M ≈ 100 on, fp32 FFMA sets it (M = 4096: 1.7e11 FLOP, 2.6 ms).
// Tensor cores are left out on purpose: TF32 rounding would move
// near-tied Eq. 9 scores.
//
// Design (simple first): one 256-thread block per 64×64 output tile. P
// is walked in slices of 16; each slice of the tile's 64 rows and 64
// columns is staged in shared memory, and every thread accumulates a 4×4
// register micro-tile with fmaf. Edges are zero-filled, so any M and P
// are taken. It computes every tile, like the TPU kernel: the symmetry
// of the Gram is not exploited. At M = 16 this is one block that walks
// all 321 slices of P on one SM, so latency, far above either bound,
// sets its time; splitting P across blocks (split-K) is the answer, left
// to a later optimisation.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // output tile edge
constexpr int kDepth = 16;     // P slice staged per step
constexpr int kThreads = 256;  // 16 × 16 threads
constexpr int kMicro = 4;      // 4 × 4 outputs per thread

__global__ void __launch_bounds__(kThreads)
raw_gram_kernel(const float* __restrict__ x, float* __restrict__ out,
                int m, int p) {
  __shared__ float a_s[kDepth][kTile + 4];
  __shared__ float b_s[kDepth][kTile + 4];
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[kMicro][kMicro] = {};

  for (int p0 = 0; p0 < p; p0 += kDepth) {
    for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
      const int r = e / kDepth, c = e % kDepth;
      const int gp = p0 + c;
      const int gi = row0 + r, gj = col0 + r;
      a_s[c][r] = (gi < m && gp < p) ? x[(size_t)gi * p + gp] : 0.f;
      b_s[c][r] = (gj < m && gp < p) ? x[(size_t)gj * p + gp] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      float a[kMicro], b[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) a[i] = a_s[d][ty * kMicro + i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) b[j] = b_s[d][tx * kMicro + j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j)
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int gi = row0 + ty * kMicro + i;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int gj = col0 + tx * kMicro + j;
      if (gi < m && gj < m) out[(size_t)gi * m + gj] = acc[i][j];
    }
  }
}

}  // namespace

// x: (m, p) float32 row-major on the device; out: (m, m) float32.
// Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int repro_raw_gram_f32(const float* x, float* out, int m, int p,
                                  cudaStream_t stream) {
  const dim3 grid((m + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  raw_gram_kernel<<<grid, kThreads, 0, stream>>>(x, out, m, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
