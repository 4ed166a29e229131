// gossip_mix: row-stochastic gossip mixing over packed neighbour lists,
//   out[i, f] = Σ_d w[i, d] · x[idx[i, d], f]      d = 0..D−1 in order,
// in float32, every step one single-rounded multiply-add (__fmaf_rn).
//
// Replaces the TPU kernel src/repro/kernels/gossip_mix.py::gossip_mix
// (Pallas body _mix_kernel, which gathers rows through scalar prefetch).
// It serves stage_mix of the gossip baselines when the plan carries packed
// lists: dfedpgp's directed plans (D = k + 1). idx rows hold ascending
// column indices, padded with index 0 / weight 0.0.
//
// Numerics: the reference's CPU sum `acc + w·x` is contracted into an FMA
// by XLA, and its Pallas kernel, jnp twin and dense oracle agree bitwise.
// So each slot here is __fmaf_rn(w, x, acc), starting from acc = +0, in
// slot order: bitwise equal to gossip_mix_plain (which emulates the FMA
// exactly) whatever the grid.
//
// Bound on the H100: bytes. Each output row reads D rows of x, so the
// function moves the x rows its lists name, its (M, D) lists and its
// (M, F) output: at the dfedpgp round's shape (M = 16, F = 11,167,040 —
// the ResNet-18 extractor — D = 5) about 1.43 GB, 0.43 ms at 3.35 TB/s,
// against 1.8 GFLOP of FMA (0.03 ms at 67 TFLOP/s).
//
// Design (simple first): a 2-D grid — blockIdx.x is the output row,
// blockIdx.y strides over 1024-column tiles of F. Rows are the fastest
// grid axis, so the blocks resident at one time cover the same columns
// of every row, and the x tile a row pulls is the one its neighbours
// pull too: x is read from L2, not D times from device memory. Each
// thread mixes four adjacent columns with 16-byte loads and stores when
// F is a multiple of 4 and the pointers are 16-byte aligned, one column
// otherwise. The row's D indices and weights are staged in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 1024;       // neighbour slots staged in shared memory
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
gossip_mix_vec4_kernel(const float4* __restrict__ x,
                       const int* __restrict__ idx,
                       const float* __restrict__ w, float4* __restrict__ out,
                       long long f4, int d) {
  __shared__ int s_idx[kMaxD];
  __shared__ float s_w[kMaxD];
  const int row = blockIdx.x;
  for (int s = threadIdx.x; s < d; s += kThreads) {
    s_idx[s] = idx[(size_t)row * d + s];
    s_w[s] = w[(size_t)row * d + s];
  }
  __syncthreads();
  for (long long c = (long long)blockIdx.y * kThreads + threadIdx.x; c < f4;
       c += (long long)gridDim.y * kThreads) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < d; ++s) {
      const float ws = s_w[s];
      const float4 v = x[(size_t)s_idx[s] * f4 + c];
      acc.x = __fmaf_rn(ws, v.x, acc.x);
      acc.y = __fmaf_rn(ws, v.y, acc.y);
      acc.z = __fmaf_rn(ws, v.z, acc.z);
      acc.w = __fmaf_rn(ws, v.w, acc.w);
    }
    out[(size_t)row * f4 + c] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
gossip_mix_scalar_kernel(const float* __restrict__ x,
                         const int* __restrict__ idx,
                         const float* __restrict__ w, float* __restrict__ out,
                         long long f, int d) {
  __shared__ int s_idx[kMaxD];
  __shared__ float s_w[kMaxD];
  const int row = blockIdx.x;
  for (int s = threadIdx.x; s < d; s += kThreads) {
    s_idx[s] = idx[(size_t)row * d + s];
    s_w[s] = w[(size_t)row * d + s];
  }
  __syncthreads();
  for (long long c = (long long)blockIdx.y * kThreads + threadIdx.x; c < f;
       c += (long long)gridDim.y * kThreads) {
    float acc = 0.f;
    for (int s = 0; s < d; ++s)
      acc = __fmaf_rn(s_w[s], x[(size_t)s_idx[s] * f + c], acc);
    out[(size_t)row * f + c] = acc;
  }
}

}  // namespace

// x (m, f) f32; idx (m, d) int32, entries in [0, m); w (m, d) f32;
// out (m, f) f32. Launches on `stream`, does not synchronise, allocates
// nothing.
extern "C" int repro_gossip_mix_f32(const float* x, const int* idx,
                                    const float* w, float* out, int m,
                                    long long f, int d,
                                    cudaStream_t stream) {
  if (m < 1 || f < 1 || d < 1 || d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = f % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long cols = vec ? f / 4 : f;
  long long tiles = (cols + kThreads - 1) / kThreads;
  if (tiles > kMaxGridY) tiles = kMaxGridY;
  const dim3 grid(m, static_cast<unsigned>(tiles));
  if (vec) {
    gossip_mix_vec4_kernel<<<grid, kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(x), idx, w,
        reinterpret_cast<float4*>(out), cols, d);
  } else {
    gossip_mix_scalar_kernel<<<grid, kThreads, 0, stream>>>(x, idx, w, out,
                                                            f, d);
  }
  return static_cast<int>(cudaGetLastError());
}
