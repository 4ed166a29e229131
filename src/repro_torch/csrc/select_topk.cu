// select_topk: fused Eq. 7–9 peer scoring with a per-row top-k.
//
// Replaces the TPU kernel src/repro/kernels/select_score.py::select_topk
// (Pallas body _select_kernel). For every client pair (i, j):
//   cos  = clip(<x_i, x_j> · inv_i · inv_j, −1, 1)      inv = 1/(‖x‖+1e-12)
//   s_p  = 1 − exp(−λ·max(t − last_ij, 0)), or 1 if last_ij < 0 (never)
//   s    = s_p · (α·s_l_ij − cos + c_ij)                 (scalar or matrix c)
// with the diagonal and non-candidates set to NEG = −1e30; then the k best
// columns of each row, ties to the lowest column (jax.lax.top_k), and the
// row statistics [Σ_j cos_ij, cos_ii]. No (M, M) score array is written.
//
// Bound on the H100: fp32 FFMA. The Gram is 2·M²·P operations; at
// M = 4096, P = 5130 that is 1.7e11, 2.6 ms at the 67 TFLOP/s of
// non-tensor fp32. The (M, M) reads of s_l and last (and of c and the
// candidate mask when given) are about 0.13 GB, 0.04 ms at 3.35 TB/s,
// and come second. Tensor cores are left out on purpose: TF32 rounding
// moves near-tied scores, and the indices must match the plain version.
//
// Design. The TPU kernel walks the column tiles of a row block in order
// on one core, carrying the row's top-k. Here the work is cut three ways,
// planned in Python (kernels/select_score.select_plan) so that about one
// block runs on each SM:
//  * 128 × 128 Gram tiles, one 256-thread block on each SM: each thread
//    an 8 × 8 register micro-tile (rows ty + 16·i, columns tx + 16·j) fed
//    by P slices of 32, staged in shared memory by cp.async (16, 8 or 4
//    bytes a copy, as P's alignment allows) and double-buffered: the next
//    slice loads while this one is multiplied, one barrier a slice. Slices are read as float4
//    along P; rows padded to 36 floats keep those reads free of bank
//    conflicts. 16 FFMA per 16 bytes a thread reads from shared memory.
//  * Column splits: block (split, row tile) walks only its range of column
//    tiles. For each tile it forms cos and the Eq. 8–9 score in registers
//    (__f*_rn: no contracted multiply-add, the plain version's arithmetic
//    op for op), stores the scores in shared memory, and one thread per
//    row folds them, in ascending column order, into the row's sorted
//    top-k carry: a value enters only if it beats the k-th strictly, so
//    among equal values the lowest column stays ahead. The split's carry
//    and its row statistics go to a workspace; select_merge_kernel folds
//    the splits of a row in ascending split order by the same rule (all of
//    a later split's columns are higher), and sums their statistics in
//    that order. With one split the tile kernel writes the outputs itself.
//  * P splits, where row tiles × column splits cannot fill the card (one
//    of each at M = 16): select_partial_kernel writes the partial Gram of
//    each (tile, P chunk) to the workspace, and the tile kernel then sums
//    the chunks of each entry in ascending order instead of multiplying.
// Every sum is taken in a fixed order and nothing is added by float
// atomics, so repeated calls agree bitwise.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kRows = 128;     // Gram tile rows; one top-k carry per row
constexpr int kCols = 128;     // Gram tile columns
constexpr int kDepth = 32;     // P slice staged per step
constexpr int kLd = kDepth + 4;  // padded shared row of a slice (floats)
constexpr int kStages = 2;     // P slices in shared memory: a ring
constexpr int kThreads = 256;  // 16 (column groups) × 16 (row groups)
constexpr int kMicroR = kRows / 16;  // 8 rows a thread
constexpr int kMicroC = kCols / 16;  // 8 columns a thread
constexpr int kMaxK = 32;
constexpr float kNeg = -1e30f;

// Shared memory of the tile kernel: the two slice buffers, the scores of
// the current tile, the top-k carries, the diagonal cosines and each
// column group's running Σ cos of each row.
struct TileSmem {
  float a[kStages][kRows][kLd];
  float b[kStages][kCols][kLd];
  float score[kRows][kCols + 1];
  float top_v[kRows][kMaxK + 1];
  int top_i[kRows][kMaxK + 1];
  float diag[kRows];
  float sums[kRows][17];   // [row][column group], padded
};

// Only the slice buffers: the P-split kernel
struct SliceSmem {
  float a[kStages][kRows][kLd];
  float b[kStages][kCols][kLd];
};

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

// cp.async of VEC floats; src_ok false fills the destination with zeros
template <int VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool src_ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = src_ok ? VEC * 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(VEC * 4), "r"(bytes));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage the P slice [p0, p0 + 32) of rows row0.. (kRows) and col0..
// (kCols) into buffer `buf`; rows ≥ m and P ≥ p_end read as zeros.
template <int VEC>
__device__ __forceinline__ void load_slice(const float* __restrict__ x, int m,
                                           int p, int p_end, int row0,
                                           int col0, int p0,
                                           float (*a)[kRows][kLd],
                                           float (*b)[kCols][kLd], int buf) {
  constexpr int kPerRow = kDepth / VEC;   // copies a row of the slice
#pragma unroll
  for (int c = threadIdx.x; c < kRows * kPerRow; c += kThreads) {
    const int r = c / kPerRow, k = (c % kPerRow) * VEC;
    const int gi = row0 + r, gp = p0 + k;
    const bool ok = gi < m && gp < p_end;
    copy_async<VEC>(&a[buf][r][k], ok ? x + (size_t)gi * p + gp : x, ok);
  }
#pragma unroll
  for (int c = threadIdx.x; c < kCols * kPerRow; c += kThreads) {
    const int r = c / kPerRow, k = (c % kPerRow) * VEC;
    const int gj = col0 + r, gp = p0 + k;
    const bool ok = gj < m && gp < p_end;
    copy_async<VEC>(&b[buf][r][k], ok ? x + (size_t)gj * p + gp : x, ok);
  }
  copy_commit();
}

// acc[i][j] = Σ_{q ∈ [p_begin, p_end)} x[row0 + ty + 16i, q] ·
// x[col0 + tx + 16j, q], by fmaf in ascending q. kMasked: only the
// micro-rows and -columns that reach below m are multiplied (a tile that
// M fills in part; the others stay 0).
template <int VEC, bool kMasked>
__device__ void gram_tile(const float* __restrict__ x, int m, int p,
                          int row0, int col0, int p_begin, int p_end,
                          float (*a)[kRows][kLd], float (*b)[kCols][kLd],
                          float acc[kMicroR][kMicroC]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // micro-rows i < ni and micro-columns j < nj hold rows and columns < m
  const int ni = kMasked ? min(kMicroR, (m - row0 + 15) / 16) : kMicroR;
  const int nj = kMasked ? min(kMicroC, (m - col0 + 15) / 16) : kMicroC;
#pragma unroll
  for (int i = 0; i < kMicroR; ++i)
#pragma unroll
    for (int j = 0; j < kMicroC; ++j) acc[i][j] = 0.f;
  const int steps = (p_end - p_begin + kDepth - 1) / kDepth;
  // a ring of kStages slices: kStages − 1 in flight while one is used
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps)
      load_slice<VEC>(x, m, p, p_end, row0, col0, p_begin + st * kDepth, a,
                      b, st);
    else
      copy_commit();   // an empty group keeps the count per step fixed
  }
  for (int s = 0; s < steps; ++s) {
    const int buf = s % kStages;
    copy_wait<kStages - 2>();   // slice s has landed
    __syncthreads();            // for every thread; and slice s − 1 is done
    const int next = s + kStages - 1;
    if (next < steps)
      load_slice<VEC>(x, m, p, p_end, row0, col0, p_begin + next * kDepth,
                      a, b, next % kStages);
    else
      copy_commit();
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 4) {
      float4 bv[kMicroC];
#pragma unroll
      for (int j = 0; j < kMicroC; ++j)
        if (!kMasked || j < nj)
          bv[j] = *reinterpret_cast<const float4*>(&b[buf][tx + 16 * j][kk]);
#pragma unroll
      for (int i = 0; i < kMicroR; ++i) {
        if (kMasked && i >= ni) break;
        const float4 av =
            *reinterpret_cast<const float4*>(&a[buf][ty + 16 * i][kk]);
#pragma unroll
        for (int j = 0; j < kMicroC; ++j) {
          if (kMasked && j >= nj) break;
          float t = acc[i][j];
          t = fmaf(av.x, bv[j].x, t);
          t = fmaf(av.y, bv[j].y, t);
          t = fmaf(av.z, bv[j].z, t);
          t = fmaf(av.w, bv[j].w, t);
          acc[i][j] = t;
        }
      }
    }
  }
  __syncthreads();   // the ring is free for the next tile
}

// Partial Gram over P chunk blockIdx.z of output tile (blockIdx.y,
// blockIdx.x) into work[z] (M × M).
template <int VEC, bool kMasked>
__global__ void __launch_bounds__(kThreads, 1)
select_partial_kernel(const float* __restrict__ x, float* __restrict__ work,
                      int m, int p, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SliceSmem& sm = *reinterpret_cast<SliceSmem*>(smem_raw);
  const int row0 = blockIdx.y * kRows, col0 = blockIdx.x * kCols;
  const int p_begin = blockIdx.z * chunk;
  const int p_end = min(p, p_begin + chunk);
  float acc[kMicroR][kMicroC];
  gram_tile<VEC, kMasked>(x, m, p, row0, col0, p_begin, p_end, sm.a, sm.b,
                          acc);
  float* out = work + (size_t)blockIdx.z * m * m;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < kMicroR; ++i) {
    const int gi = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kMicroC; ++j) {
      const int gj = col0 + tx + 16 * j;
      if (gi < m && gj < m) out[(size_t)gi * m + gj] = acc[i][j];
    }
  }
}

struct ScoreArgs {
  const int* last;
  const float* sl;
  int t;
  const float* cost_mat;
  float cost_scalar;
  const unsigned char* cand;
  float alpha, lam;
};

// Block (split blockIdx.x, row tile blockIdx.y): for each column tile of
// the split, the Gram tile (over all of P, or summed from `gram_parts`
// P chunks), its Eq. 7–9 scores and cosines, folded into each row's top-k
// carry and statistics. Writes the carries and statistics to out_v/out_i
// /out_s at split blockIdx.x (the final outputs when there is one split).
template <int VEC, bool kFromParts>
__global__ void __launch_bounds__(kThreads, 1)
select_tile_kernel(const float* __restrict__ x, const float* __restrict__ inv,
                   const float* __restrict__ gram_parts, int p_splits,
                   ScoreArgs sa, float* __restrict__ out_v,
                   int* __restrict__ out_i, float* __restrict__ out_s, int m,
                   int p, int k, int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem& sm = *reinterpret_cast<TileSmem*>(smem_raw);
  const int row0 = blockIdx.y * kRows;
  const int col_tiles = (m + kCols - 1) / kCols;
  const int tile_begin = blockIdx.x * tiles_per_split;
  const int tile_end = min(col_tiles, tile_begin + tiles_per_split);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool merger = threadIdx.x < kRows;   // owns row threadIdx.x's carry

  if (merger) {
    for (int j = 0; j < k; ++j) {
      sm.top_v[threadIdx.x][j] = -INFINITY;
      sm.top_i[threadIdx.x][j] = 0;
    }
    sm.diag[threadIdx.x] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kMicroR; ++i) sm.sums[ty + 16 * i][tx] = 0.f;
  __syncthreads();   // the carries and diagonal before any tile writes

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int col0 = tile * kCols;
    float acc[kMicroR][kMicroC];
    if (kFromParts) {
      // each entry: the P chunks' partial Grams added in ascending order,
      // the eight columns' loads of a chunk issued together
#pragma unroll
      for (int i = 0; i < kMicroR; ++i) {
        const int gi = row0 + ty + 16 * i;
        if (gi >= m) break;   // rows ascend with i; the epilogue skips them
        const float* e = gram_parts + (size_t)gi * m + col0 + tx;
#pragma unroll 4
        for (int s = 0; s < p_splits; ++s) {
          float part[kMicroC];
#pragma unroll
          for (int j = 0; j < kMicroC; ++j)
            part[j] = col0 + tx + 16 * j < m
                          ? e[(size_t)s * m * m + 16 * j] : 0.f;
#pragma unroll
          for (int j = 0; j < kMicroC; ++j)
            acc[i][j] = s == 0 ? part[j] : acc[i][j] + part[j];
        }
      }
    } else {
      gram_tile<VEC, false>(x, m, p, row0, col0, 0, p, sm.a, sm.b, acc);
    }

    // ---- Eq. 7–9 epilogue: scores to shared memory, cosines summed -----
    float inv_c[kMicroC];
#pragma unroll
    for (int j = 0; j < kMicroC; ++j) {
      const int gj = col0 + tx + 16 * j;
      inv_c[j] = gj < m ? inv[gj] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kMicroR; ++i) {
      const int r = ty + 16 * i, gi = row0 + r;
      if (gi >= m) continue;   // no carry to fold into
      const float inv_r = inv[gi];
      // the row's Eq. 8–9 inputs at the thread's columns, loads first
      int t0[kMicroC];
      float slv[kMicroC], cost[kMicroC];
      bool cand[kMicroC];
      const size_t o0 = (size_t)gi * m + col0 + tx;
#pragma unroll
      for (int j = 0; j < kMicroC; ++j) {
        const bool ok = col0 + tx + 16 * j < m;
        const size_t o = o0 + 16 * j;
        t0[j] = ok ? sa.last[o] : -1;
        slv[j] = ok ? sa.sl[o] : 0.f;
        cost[j] = ok && sa.cost_mat ? sa.cost_mat[o] : sa.cost_scalar;
        cand[j] = !(ok && sa.cand) || sa.cand[o];
      }
      float row_sum = sm.sums[r][tx];
#pragma unroll
      for (int j = 0; j < kMicroC; ++j) {
        const int c = tx + 16 * j, gj = col0 + c;
        if (gj >= m) break;   // columns ascend with j
        float cs = __fmul_rn(__fmul_rn(acc[i][j], inv_r), inv_c[j]);
        cs = fminf(fmaxf(cs, -1.f), 1.f);
        float sp = 1.f;
        if (t0[j] >= 0) {
          const float dt = static_cast<float>(max(sa.t - t0[j], 0));
          sp = __fsub_rn(1.f, expf(__fmul_rn(-sa.lam, dt)));
        }
        float sc = __fmul_rn(
            sp, __fadd_rn(__fsub_rn(__fmul_rn(sa.alpha, slv[j]), cs), cost[j]));
        if (gi == gj) {
          sc = kNeg;
          sm.diag[r] = cs;
        }
        if (!cand[j]) sc = kNeg;
        row_sum = __fadd_rn(row_sum, cs);
        sm.score[r][c] = sc;
      }
      sm.sums[r][tx] = row_sum;
    }
    __syncthreads();

    // ---- fold the tile into the row's top-k carry -----------------------
    if (merger && row0 + threadIdx.x < m) {
      const int r = threadIdx.x;
      const int ncol = min(kCols, m - col0);
      float thr = sm.top_v[r][k - 1];
      for (int c = 0; c < ncol; ++c) {
        const float v = sm.score[r][c];
        if (v > thr) {
          int pos = k - 1;
          while (pos > 0 && v > sm.top_v[r][pos - 1]) {
            sm.top_v[r][pos] = sm.top_v[r][pos - 1];
            sm.top_i[r][pos] = sm.top_i[r][pos - 1];
            --pos;
          }
          sm.top_v[r][pos] = v;
          sm.top_i[r][pos] = col0 + c;
          thr = sm.top_v[r][k - 1];
        }
      }
    }
    __syncthreads();
  }

  // ---- the split's carries and statistics --------------------------------
  const size_t base = (size_t)blockIdx.x * m;   // this split's rows
  if (merger && row0 + threadIdx.x < m) {
    const int r = threadIdx.x, gi = row0 + r;
    float sum = sm.sums[r][0];   // Σ cos: the column groups in order
    for (int g = 1; g < 16; ++g) sum = __fadd_rn(sum, sm.sums[r][g]);
    out_s[(base + gi) * 2] = sum;
    out_s[(base + gi) * 2 + 1] = sm.diag[r];
    for (int j = 0; j < k; ++j) {
      out_v[(base + gi) * k + j] = sm.top_v[r][j];
      out_i[(base + gi) * k + j] = sm.top_i[r][j];
    }
  }
}

// One thread per row: the splits' carries folded in ascending split order
// (strict >, so ties stay with the lower split's, lower, columns), the
// statistics summed in that order.
__global__ void __launch_bounds__(kRows)
select_merge_kernel(const float* __restrict__ part_v,
                    const int* __restrict__ part_i,
                    const float* __restrict__ part_s, int splits, int m, int k,
                    float* __restrict__ vals, int* __restrict__ idx,
                    float* __restrict__ stats) {
  __shared__ float top_v[kRows][kMaxK + 1];
  __shared__ int top_i[kRows][kMaxK + 1];
  const int r = threadIdx.x, gi = blockIdx.x * kRows + r;
  if (gi >= m) return;
  for (int j = 0; j < k; ++j) {
    top_v[r][j] = part_v[(size_t)gi * k + j];
    top_i[r][j] = part_i[(size_t)gi * k + j];
  }
  float sum = part_s[(size_t)gi * 2], diag = part_s[(size_t)gi * 2 + 1];
  for (int s = 1; s < splits; ++s) {
    const size_t row = (size_t)s * m + gi;
    float thr = top_v[r][k - 1];
    for (int j = 0; j < k; ++j) {
      const float v = part_v[row * k + j];
      if (!(v > thr)) break;   // the split's list descends: none beats it
      int pos = k - 1;
      while (pos > 0 && v > top_v[r][pos - 1]) {
        top_v[r][pos] = top_v[r][pos - 1];
        top_i[r][pos] = top_i[r][pos - 1];
        --pos;
      }
      top_v[r][pos] = v;
      top_i[r][pos] = part_i[row * k + j];
      thr = top_v[r][k - 1];
    }
    sum = __fadd_rn(sum, part_s[row * 2]);
    diag = __fadd_rn(diag, part_s[row * 2 + 1]);
  }
  for (int j = 0; j < k; ++j) {
    vals[(size_t)gi * k + j] = top_v[r][j];
    idx[(size_t)gi * k + j] = top_i[r][j];
  }
  stats[(size_t)gi * 2] = sum;
  stats[(size_t)gi * 2 + 1] = diag;
}

// The shared-memory attributes of the kernels launch<VEC> uses: the
// opt-in above 48 KB, and one carveout (all shared memory) for all of them
// so the SMs do not switch their L1/shared split between a call's
// launches. Set once per device (an attribute call costs host time on
// every select_topk call otherwise).
template <int VEC>
void configure() {
  static int configured_device = -1;
  int device = 0;
  cudaGetDevice(&device);
  if (device == configured_device) return;
  constexpr auto kCarveout = cudaFuncAttributePreferredSharedMemoryCarveout;
  constexpr auto kDynamic = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaFuncSetAttribute(row_inv_norm_kernel, kCarveout,
                       cudaSharedmemCarveoutMaxShared);
  for (auto kern : {select_partial_kernel<VEC, true>,
                    select_partial_kernel<VEC, false>}) {
    cudaFuncSetAttribute(kern, kDynamic, static_cast<int>(sizeof(SliceSmem)));
    cudaFuncSetAttribute(kern, kCarveout, cudaSharedmemCarveoutMaxShared);
  }
  for (auto kern : {select_tile_kernel<VEC, false>,
                    select_tile_kernel<1, true>}) {
    cudaFuncSetAttribute(kern, kDynamic, static_cast<int>(sizeof(TileSmem)));
    cudaFuncSetAttribute(kern, kCarveout, cudaSharedmemCarveoutMaxShared);
  }
  configured_device = device;
}

template <int VEC>
int launch(const float* x, float* work, const ScoreArgs& sa, float* vals,
           int* idx, float* stats, int m, int p, int k, int col_splits,
           int tiles_per_split, int p_splits, int chunk,
           cudaStream_t stream) {
  const int row_tiles = (m + kRows - 1) / kRows;
  const int col_tiles = (m + kCols - 1) / kCols;
  // the workspace: inverse norms, then the P chunks' partial Grams, then
  // the column splits' carries and statistics
  float* inv = work;
  float* gram = inv + ((m + 3) / 4) * 4;
  float* part_v = gram + (p_splits > 1 ? (size_t)p_splits * m * m : 0);
  int* part_i = reinterpret_cast<int*>(part_v + (size_t)col_splits * m * k);
  float* part_s = reinterpret_cast<float*>(part_i + (size_t)col_splits * m * k);

  configure<VEC>();
  row_inv_norm_kernel<<<(m + 7) / 8, 256, 0, stream>>>(x, inv, m, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p_splits > 1) {
    auto partial = m < kCols ? select_partial_kernel<VEC, true>
                             : select_partial_kernel<VEC, false>;
    partial<<<dim3(col_tiles, row_tiles, p_splits), kThreads,
              sizeof(SliceSmem), stream>>>(x, gram, m, p, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool merge = col_splits > 1;
  float* tv = merge ? part_v : vals;
  int* ti = merge ? part_i : idx;
  float* ts = merge ? part_s : stats;
  const dim3 grid(col_splits, row_tiles);
  auto tile = p_splits > 1 ? select_tile_kernel<1, true>
                           : select_tile_kernel<VEC, false>;
  tile<<<grid, kThreads, sizeof(TileSmem), stream>>>(
      x, inv, gram, p_splits, sa, tv, ti, ts, m, p, k, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return static_cast<int>(err);
  select_merge_kernel<<<row_tiles, kRows, 0, stream>>>(
      part_v, part_i, part_s, col_splits, m, k, vals, idx, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (m, p) f32; work: f32 scratch of the plan's size
// (kernels/select_score.select_work_floats); last (m, m) int32; sl (m, m)
// f32; cost_mat (m, m) f32 or null (then cost_scalar); cand (m, m) bool or
// null; vals (m, k) f32, idx (m, k) int32, stats (m, 2) f32. The plan:
// vec (1, 2 or 4 floats a copy, dividing p, x 4·vec-byte aligned);
// col_splits × tiles_per_split cover the ceil(m / kCols) column tiles, no
// empty split; p_splits chunks of `chunk` (a multiple of vec) cover p with
// no empty chunk. Launches on `stream`, does not synchronise, allocates
// nothing.
extern "C" int repro_select_topk_f32(
    const float* x, float* work, const int* last, const float* sl, int t,
    const float* cost_mat, float cost_scalar, const unsigned char* cand,
    float* vals, int* idx, float* stats, int m, int p, int k, float alpha,
    float lam, int vec, int col_splits, int tiles_per_split, int p_splits,
    int chunk, cudaStream_t stream) {
  const int col_tiles = (m + kCols - 1) / kCols;
  if (m < 1 || p < 1 || k < 1 || k > kMaxK || col_splits < 1 ||
      tiles_per_split < 1 || (col_splits - 1) * tiles_per_split >= col_tiles ||
      col_splits * tiles_per_split < col_tiles || p_splits < 1 ||
      p_splits > 65535 || chunk < 1 || chunk % vec != 0 ||
      (long long)(p_splits - 1) * chunk >= p ||
      (long long)p_splits * chunk < p ||
      reinterpret_cast<uintptr_t>(x) % (4 * vec) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const ScoreArgs sa{last, sl, t, cost_mat, cost_scalar, cand, alpha, lam};
  switch (vec) {
    case 4:
      if (p % 4) break;
      return launch<4>(x, work, sa, vals, idx, stats, m, p, k, col_splits,
                       tiles_per_split, p_splits, chunk, stream);
    case 2:
      if (p % 2) break;
      return launch<2>(x, work, sa, vals, idx, stats, m, p, k, col_splits,
                       tiles_per_split, p_splits, chunk, stream);
    case 1:
      return launch<1>(x, work, sa, vals, idx, stats, m, p, k, col_splits,
                       tiles_per_split, p_splits, chunk, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
