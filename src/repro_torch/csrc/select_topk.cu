// select_topk: fused Eq. 7–9 peer scoring with a streaming per-row top-k.
//
// Replaces the TPU kernel src/repro/kernels/select_score.py::select_topk
// (Pallas body _select_kernel). For every client pair (i, j):
//   cos  = clip(<x_i, x_j> · inv_i · inv_j, −1, 1)      inv = 1/(‖x‖+1e-12)
//   s_p  = 1 − exp(−λ·max(t − last_ij, 0)), or 1 if last_ij < 0 (never)
//   s    = s_p · (α·s_l_ij − cos + c_ij)                 (scalar or matrix c)
// with the diagonal and non-candidates set to NEG = −1e30; then the k best
// columns of each row, ties to the lowest column (jax.lax.top_k), and the
// row statistics [Σ_j cos_ij, cos_ii]. No (M, M) array is written.
//
// Bound on the H100: fp32 FFMA. The Gram is 2·M²·P operations; at
// M = 4096, P = 5130 that is 1.7e11, 2.6 ms at the 67 TFLOP/s of
// non-tensor fp32. The (M, M) reads of s_l and last (and of c and the
// candidate mask when given) are about 0.13 GB, 0.04 ms at 3.35 TB/s,
// and come second. Tensor cores are left out on purpose: TF32 rounding
// moves near-tied scores, and the indices must match the plain version.
//
// Design (simple first):
//  * row_inv_norm_kernel: one warp per row computes inv_i.
//  * select_topk_kernel: one 256-thread block per 32-row tile. It walks
//    all 64-column tiles in ascending order; for each, P is walked
//    in slices of 16 staged in shared memory and every thread accumulates
//    a 2×4 register micro-tile with fmaf. The epilogue computes cos and
//    the Eq. 8–9 score of the tile into shared memory (with __f*_rn so
//    no multiply-add is contracted: the arithmetic is the plain
//    version's, op for op). One thread per row then folds the tile, in
//    ascending column order, into that row's sorted top-k carry in shared
//    memory: a value enters only if it beats the current k-th strictly,
//    so among equal values the lowest column stays ahead.
//  * The grid has ceil(M / 32) blocks: 1 at M = 16, where one block walks
//    all of P on one SM and latency, not the bound, sets the time; 128 at
//    M = 4096, under one block per SM. Splitting the columns (or P) across
//    blocks is the answer for both and is left to a later optimisation.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 32;      // rows per block; one top-k carry per row
constexpr int kCols = 64;      // column tile
constexpr int kDepth = 16;     // P slice staged per step
constexpr int kThreads = 256;  // 16 (row groups) × 16 (column groups)
constexpr int kMicroR = 2;     // rows per thread in the Gram tile
constexpr int kMicroC = 4;     // columns per thread in the Gram tile
constexpr int kMaxK = 32;
constexpr float kNeg = -1e30f;

__global__ void row_inv_norm_kernel(const float* __restrict__ x,
                                    float* __restrict__ inv, int m, int p) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;
  float s = 0.f;
  for (int q = lane; q < p; q += 32) {
    const float v = x[(size_t)row * p + q];
    s = fmaf(v, v, s);
  }
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) inv[row] = 1.f / (sqrtf(s) + 1e-12f);
}

__global__ void __launch_bounds__(kThreads)
select_topk_kernel(const float* __restrict__ x, const float* __restrict__ inv,
                   const int* __restrict__ last, const float* __restrict__ sl,
                   int t, const float* __restrict__ cost_mat,
                   float cost_scalar, const unsigned char* __restrict__ cand,
                   float* __restrict__ out_v, int* __restrict__ out_i,
                   float* __restrict__ out_stats, int m, int p, int k,
                   float alpha, float lam) {
  __shared__ float a_s[kDepth][kRows + 4];
  __shared__ float b_s[kDepth][kCols + 4];
  __shared__ float score_s[kRows][kCols + 1];
  __shared__ float cos_s[kRows][kCols + 1];
  __shared__ float top_v[kRows][kMaxK + 1];
  __shared__ int top_i[kRows][kMaxK + 1];

  const int row0 = blockIdx.x * kRows;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const bool merger = threadIdx.x < kRows;   // owns row threadIdx.x's carry
  float row_sum = 0.f, row_diag = 0.f;
  if (merger) {
    for (int j = 0; j < k; ++j) {
      top_v[threadIdx.x][j] = -INFINITY;
      top_i[threadIdx.x][j] = 0;
    }
  }

  for (int col0 = 0; col0 < m; col0 += kCols) {
    // ---- Gram tile over P ------------------------------------------------
    float acc[kMicroR][kMicroC] = {};
    for (int p0 = 0; p0 < p; p0 += kDepth) {
      for (int e = threadIdx.x; e < kRows * kDepth; e += kThreads) {
        const int r = e / kDepth, c = e % kDepth;
        const int gi = row0 + r, gp = p0 + c;
        a_s[c][r] = (gi < m && gp < p) ? x[(size_t)gi * p + gp] : 0.f;
      }
      for (int e = threadIdx.x; e < kCols * kDepth; e += kThreads) {
        const int r = e / kDepth, c = e % kDepth;
        const int gj = col0 + r, gp = p0 + c;
        b_s[c][r] = (gj < m && gp < p) ? x[(size_t)gj * p + gp] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        float a[kMicroR], b[kMicroC];
#pragma unroll
        for (int i = 0; i < kMicroR; ++i) a[i] = a_s[d][ty * kMicroR + i];
#pragma unroll
        for (int j = 0; j < kMicroC; ++j) b[j] = b_s[d][tx * kMicroC + j];
#pragma unroll
        for (int i = 0; i < kMicroR; ++i)
#pragma unroll
          for (int j = 0; j < kMicroC; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // ---- Eq. 7–9 epilogue into shared memory -----------------------------
#pragma unroll
    for (int i = 0; i < kMicroR; ++i) {
#pragma unroll
      for (int j = 0; j < kMicroC; ++j) {
        const int r = ty * kMicroR + i, c = tx * kMicroC + j;
        const int gi = row0 + r, gj = col0 + c;
        if (gi < m && gj < m) {
          float cs = __fmul_rn(__fmul_rn(acc[i][j], inv[gi]), inv[gj]);
          cs = fminf(fmaxf(cs, -1.f), 1.f);
          const size_t o = (size_t)gi * m + gj;
          const int t0 = last[o];
          float sp = 1.f;
          if (t0 >= 0) {
            const float dt = static_cast<float>(max(t - t0, 0));
            sp = __fsub_rn(1.f, expf(__fmul_rn(-lam, dt)));
          }
          const float c_ij = cost_mat ? cost_mat[o] : cost_scalar;
          float s = __fmul_rn(
              sp, __fadd_rn(__fsub_rn(__fmul_rn(alpha, sl[o]), cs), c_ij));
          if (gi == gj) s = kNeg;
          if (cand && !cand[o]) s = kNeg;
          score_s[r][c] = s;
          cos_s[r][c] = cs;
        }
      }
    }
    __syncthreads();

    // ---- fold the tile into the row's top-k carry ------------------------
    if (merger && row0 + threadIdx.x < m) {
      const int r = threadIdx.x, gi = row0 + r;
      const int ncol = min(kCols, m - col0);
      float thr = top_v[r][k - 1];
      for (int c = 0; c < ncol; ++c) {
        row_sum += cos_s[r][c];
        if (col0 + c == gi) row_diag = cos_s[r][c];
        const float v = score_s[r][c];
        if (v > thr) {
          int pos = k - 1;
          while (pos > 0 && v > top_v[r][pos - 1]) {
            top_v[r][pos] = top_v[r][pos - 1];
            top_i[r][pos] = top_i[r][pos - 1];
            --pos;
          }
          top_v[r][pos] = v;
          top_i[r][pos] = col0 + c;
          thr = top_v[r][k - 1];
        }
      }
    }
    __syncthreads();
  }

  if (merger && row0 + threadIdx.x < m) {
    const int r = threadIdx.x, gi = row0 + r;
    for (int j = 0; j < k; ++j) {
      out_v[(size_t)gi * k + j] = top_v[r][j];
      out_i[(size_t)gi * k + j] = top_i[r][j];
    }
    out_stats[(size_t)gi * 2] = row_sum;
    out_stats[(size_t)gi * 2 + 1] = row_diag;
  }
}

}  // namespace

// x (m, p) f32; inv (m,) f32 scratch; last (m, m) int32; sl (m, m) f32;
// cost_mat (m, m) f32 or null (then cost_scalar); cand (m, m) bool or
// null; vals (m, k) f32, idx (m, k) int32, stats (m, 2) f32.
// Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int repro_select_topk_f32(
    const float* x, float* inv, const int* last, const float* sl, int t,
    const float* cost_mat, float cost_scalar, const unsigned char* cand,
    float* vals, int* idx, float* stats, int m, int p, int k, float alpha,
    float lam, cudaStream_t stream) {
  if (m < 1 || k < 1 || k > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  row_inv_norm_kernel<<<(m + 7) / 8, 256, 0, stream>>>(x, inv, m, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  select_topk_kernel<<<(m + kRows - 1) / kRows, kThreads, 0, stream>>>(
      x, inv, last, sl, t, cost_mat, cost_scalar, cand, vals, idx, stats, m,
      p, k, alpha, lam);
  return static_cast<int>(cudaGetLastError());
}
