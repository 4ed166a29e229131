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
// Design: split-K. The TPU grid walks P in order on one core; here P is
// cut into `splits` contiguous chunks (planned in Python by
// kernels/peer_score.gram_split_plan: about two blocks per SM while the
// output tiles alone do not fill the card, at least 64 P elements a
// chunk, one chunk from M = 1024 on), and block (i, j, s) computes output
// tile (i, j) over chunk s. A 256-thread block owns a TILE × TILE tile
// (16 for M ≤ 16, else 64): each P slice of 16 is staged in shared memory
// and every thread accumulates a (TILE/16)² register micro-tile with fmaf;
// edges are zero-filled, so any M and P are taken. Each split writes its
// partial Gram to a (splits, M, M) workspace, and a second kernel sums
// the splits in ascending order, one thread per entry: no float atomics,
// so two launches give bitwise-equal results. With one split the first
// kernel writes the output and the second is not launched; that instance
// (SPLIT = false) walks all of P with no chunk bounds. Every tile is
// computed, like the TPU kernel: the Gram's symmetry is not exploited.
#include <cuda_runtime.h>

namespace {

constexpr int kDepth = 16;     // P slice staged per step
constexpr int kThreads = 256;  // 16 × 16 threads

// SPLIT: block z covers P chunk z and writes partial Gram z of `out`;
// else the block covers all of P and writes `out` itself.
template <int TILE, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
raw_gram_kernel(const float* __restrict__ x, float* __restrict__ out,
                int m, int p, int chunk) {
  constexpr int kMicro = TILE / 16;  // kMicro × kMicro outputs a thread
  __shared__ float a_s[kDepth][TILE + 4];
  __shared__ float b_s[kDepth][TILE + 4];
  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;
  const int p_begin = SPLIT ? blockIdx.z * chunk : 0;
  const int p_end = SPLIT ? min(p, p_begin + chunk) : p;
  if (SPLIT) out += (size_t)blockIdx.z * m * m;  // this split's partial
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[kMicro][kMicro] = {};

  for (int p0 = p_begin; p0 < p_end; p0 += kDepth) {
    for (int e = threadIdx.x; e < TILE * kDepth; e += kThreads) {
      const int r = e / kDepth, c = e % kDepth;
      const int gp = p0 + c;
      const int gi = row0 + r, gj = col0 + r;
      a_s[c][r] = (gi < m && gp < p_end) ? x[(size_t)gi * p + gp] : 0.f;
      b_s[c][r] = (gj < m && gp < p_end) ? x[(size_t)gj * p + gp] : 0.f;
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

// out[e] = work[0][e] + work[1][e] + … in ascending split order
__global__ void __launch_bounds__(kThreads)
raw_gram_sum_kernel(const float* __restrict__ work, float* __restrict__ out,
                    int n, int splits) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float acc = work[e];
  for (int s = 1; s < splits; ++s) acc += work[(size_t)s * n + e];
  out[e] = acc;
}

}  // namespace

// x: (m, p) float32 row-major on the device; out: (m, m) float32; work:
// (splits, m, m) float32 scratch, unused (may be null) when splits = 1.
// The plan (tile 16 or 64, splits, chunk) must cover P exactly with no
// empty split: (splits − 1)·chunk < p ≤ splits·chunk. Launches on
// `stream`, does not synchronise, allocates nothing.
extern "C" int repro_raw_gram_f32(const float* x, float* out, float* work,
                                  int m, int p, int tile, int splits,
                                  int chunk, cudaStream_t stream) {
  if (m <= 0 || p <= 0 || splits <= 0 || chunk <= 0 ||
      (long long)(splits - 1) * chunk >= p ||
      (long long)splits * chunk < p || splits > 65535 ||
      (splits > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tile != 16 && tile != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int edge = (m + tile - 1) / tile;
  const dim3 grid(edge, edge, splits);
  if (splits > 1 && tile == 16)
    raw_gram_kernel<16, true><<<grid, kThreads, 0, stream>>>(x, work, m, p,
                                                             chunk);
  else if (splits > 1)
    raw_gram_kernel<64, true><<<grid, kThreads, 0, stream>>>(x, work, m, p,
                                                             chunk);
  else if (tile == 16)
    raw_gram_kernel<16, false><<<grid, kThreads, 0, stream>>>(x, out, m, p,
                                                              chunk);
  else
    raw_gram_kernel<64, false><<<grid, kThreads, 0, stream>>>(x, out, m, p,
                                                              chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int n = m * m;
  raw_gram_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(work, out, n, splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
