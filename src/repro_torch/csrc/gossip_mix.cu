// gossip_mix: row-stochastic gossip mixing over packed neighbour lists,
//   out[i, f] = Σ_d w[i, d] · x[idx[i, d], f]      d = 0..D−1 in order,
// in float32, every step one single-rounded multiply-add (__fmaf_rn).
//
// Replaces the TPU kernel src/repro/kernels/gossip_mix.py::gossip_mix
// (Pallas body _mix_kernel, which gathers rows through scalar prefetch).
// It serves stage_mix of the gossip baselines when the plan carries packed
// lists: dfedpgp's directed plans (D = k + 1), and the undirected plans
// of dfedavgm and dispfl on a static sparse topology (D = degree + 1).
// idx rows hold ascending column indices, padded with index 0 / weight
// 0.0.
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
// thread mixes four adjacent columns. When F is a multiple of 4 and the
// pointers are 16-byte aligned, every load and store is 16 bytes
// (gossip_mix_vec4_kernel). Otherwise (gossip_mix_phased_kernel) each
// output row is cut at the 16-byte boundaries of out: a head of fewer
// than 4 columns, a body of 16-byte stores, a tail of fewer than 4
// columns, the head and tail mixed one column at a time. In the body,
// slot s reads its source row at a fixed phase (its element offset mod
// 4): 0 takes one 16-byte load, 2 two 8-byte loads, 1 or 3 four 4-byte
// loads. The phase depends on the row and the slot only, so every thread
// of a block takes the same branch. At even F (the whole ResNet-18, the
// 5130-wide header) the phases are 0 and 2 only. The row's D indices,
// weights and phases are staged in shared memory.
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

__device__ __forceinline__ float mix_column(const float* __restrict__ x,
                                            const int* s_idx,
                                            const float* s_w, long long f,
                                            long long col, int d) {
  float acc = 0.f;
  for (int s = 0; s < d; ++s)
    acc = __fmaf_rn(s_w[s], x[(size_t)s_idx[s] * f + col], acc);
  return acc;
}

// ax, ao: the element offsets of x and out from a 16-byte boundary.
__global__ void __launch_bounds__(kThreads)
gossip_mix_phased_kernel(const float* __restrict__ x,
                         const int* __restrict__ idx,
                         const float* __restrict__ w, float* __restrict__ out,
                         long long f, int d, int ax, int ao) {
  __shared__ int s_idx[kMaxD];
  __shared__ float s_w[kMaxD];
  __shared__ unsigned char s_phase[kMaxD];
  const int row = blockIdx.x;
  const int f_mod = static_cast<int>(f & 3);
  // head: the columns before out's first 16-byte boundary in this row
  const int start = (ao + (row & 3) * f_mod) & 3;
  const int lead = (4 - start) & 3;
  const long long head = lead < f ? lead : f;
  const long long body = (f - head) >> 2;       // float4 columns
  for (int s = threadIdx.x; s < d; s += kThreads) {
    const int src = idx[(size_t)row * d + s];
    s_idx[s] = src;
    s_w[s] = w[(size_t)row * d + s];
    s_phase[s] = static_cast<unsigned char>(
        (ax + (src & 3) * f_mod + static_cast<int>(head)) & 3);
  }
  __syncthreads();
  float* out_row = out + (size_t)row * f;
  for (long long c = (long long)blockIdx.y * kThreads + threadIdx.x;
       c < body; c += (long long)gridDim.y * kThreads) {
    const long long col = head + 4 * c;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < d; ++s) {
      const float ws = s_w[s];
      const float* p = x + (size_t)s_idx[s] * f + col;
      float4 v;
      const int phase = s_phase[s];
      if (phase == 0) {
        v = *reinterpret_cast<const float4*>(p);
      } else if (phase == 2) {
        const float2 lo = reinterpret_cast<const float2*>(p)[0];
        const float2 hi = reinterpret_cast<const float2*>(p)[1];
        v = make_float4(lo.x, lo.y, hi.x, hi.y);
      } else {
        v = make_float4(p[0], p[1], p[2], p[3]);
      }
      acc.x = __fmaf_rn(ws, v.x, acc.x);
      acc.y = __fmaf_rn(ws, v.y, acc.y);
      acc.z = __fmaf_rn(ws, v.z, acc.z);
      acc.w = __fmaf_rn(ws, v.w, acc.w);
    }
    *reinterpret_cast<float4*>(out_row + col) = acc;
  }
  // head and tail, one column a thread, in the row's first column tile
  if (blockIdx.y == 0 && threadIdx.x < 8) {
    const int t = threadIdx.x;
    const long long col = t < 4 ? t : head + 4 * body + (t - 4);
    if (t < 4 ? col < head : col < f)
      out_row[col] = mix_column(x, s_idx, s_w, f, col, d);
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
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  if (m < 1 || f < 1 || d < 1 || d > kMaxD || xa % 4 != 0 || oa % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = f % 4 == 0 && xa % 16 == 0 && oa % 16 == 0;
  // the phased kernel's body has at most f / 4 float4 columns
  long long tiles = (f / 4 + kThreads - 1) / kThreads;
  if (tiles < 1) tiles = 1;
  if (tiles > kMaxGridY) tiles = kMaxGridY;
  const dim3 grid(m, static_cast<unsigned>(tiles));
  if (vec) {
    gossip_mix_vec4_kernel<<<grid, kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(x), idx, w,
        reinterpret_cast<float4*>(out), f / 4, d);
  } else {
    gossip_mix_phased_kernel<<<grid, kThreads, 0, stream>>>(
        x, idx, w, out, f, d, static_cast<int>((xa / 4) & 3),
        static_cast<int>((oa / 4) & 3));
  }
  return static_cast<int>(cudaGetLastError());
}
