// mask_evolve: DisPFL's mask evolution on one stacked parameter leaf —
//   thr  = the (n − keep)-th smallest |x| (0-based), exact
//   mask = (|x| ≥ thr) | grow
//   out  = x · mask          (a product, in x's type: −x·0 is −0.0)
// for float32 or bfloat16 x.
//
// Replaces the TPU kernel src/repro/kernels/mask_evolve.py::mask_evolve
// (Pallas bodies _thr_kernel and _apply_kernel). The threshold is the
// reference's bisection, reproduced step for step: the bit patterns of
// non-negative float32 values are ordered like their integers, so 31
// halvings of [lo, hi] = [0, 0x7F800000], each keeping the lower half when
// at least kth + 1 elements have bits ≤ mid = lo + (hi − lo) / 2, end on
// the exact kth-smallest |x|, ties included.
//
// The TPU kernel carries lo/hi in scalar memory across a sequential
// (31, blocks) grid. Hopper blocks run in parallel and carry nothing, so
// here each bisection step is one counting launch, and lo/hi never leave
// the device: the launches share a device array of 31 64-bit counters,
// and every block of step s first replays steps 0..s−1 from the counters
// of those steps (31 integer comparisons) to find its mid, counts its
// elements with bits ≤ mid, reduces the count over the block and adds it
// to counter s with one atomicAdd. The apply launch replays all 31 steps
// and writes out, mask and the threshold. No host synchronisation: the
// 32 launches are queued on the stream back to back. bfloat16 is read as
// it is (bfloat16 → float32 is a shift of the bits, exact).
//
// Bound on the H100: bytes. The function must read x and grow once and
// write out and mask once: for the largest leaf of the dispfl round
// (16 × 2,359,296 bfloat16 weights, 37.7 M) that is 226 MB, 0.07 ms at
// 3.35 TB/s. This design reads x 32 times (31 counts, then the apply),
// so a leaf that does not fit the 50 MB L2 costs about 31 × its size of
// traffic; a radix select (4 passes of 8-bit histograms, same exact
// answer) and one launch over all 56 leaves are the later optimisations.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIters = 31;
constexpr int kMaxFiniteBits = 0x7F800000;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

// |x| as float32 bits, from one float32 word
__device__ __forceinline__ uint32_t abs_bits_f32(uint32_t word) {
  return word & 0x7FFFFFFFu;
}

// |x| as float32 bits, from one bfloat16 half-word
__device__ __forceinline__ uint32_t abs_bits_bf16(uint32_t half) {
  return (half & 0x7FFFu) << 16;
}

// lo of the bisection after `steps` steps, replayed from the counters
__device__ __forceinline__ void replay(const unsigned long long* counts,
                                       int steps, long long target, int* lo,
                                       int* hi) {
  int l = 0, h = kMaxFiniteBits;
  for (int t = 0; t < steps; ++t) {
    const int mid = l + (h - l) / 2;
    if (static_cast<long long>(counts[t]) >= target) {
      h = mid;
    } else {
      l = mid + 1;
    }
  }
  *lo = l;
  *hi = h;
}

__device__ __forceinline__ unsigned block_sum(unsigned v) {
  __shared__ unsigned warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = v;
  __syncthreads();
  unsigned total = 0;
  if (threadIdx.x < 32) {
    total = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0u;
    for (int off = 16; off > 0; off >>= 1)
      total += __shfl_xor_sync(0xffffffffu, total, off);
  }
  return total;  // valid in thread 0
}

// One bisection step: counts[step] += #{ e : |x_e| bits ≤ mid }. `x` is
// read as 32-bit words (one float32 or two bfloat16 each), 16 bytes a
// thread where it is aligned.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
count_kernel(const void* __restrict__ x, long long n,
             unsigned long long* __restrict__ counts, int step,
             long long target) {
  __shared__ uint32_t s_mid;
  if (threadIdx.x == 0) {
    int lo, hi;
    replay(counts, step, target, &lo, &hi);
    s_mid = static_cast<uint32_t>(lo + (hi - lo) / 2);
  }
  __syncthreads();
  const uint32_t mid = s_mid;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  unsigned c = 0;
  // elements per 16-byte vector
  constexpr int kPerVec = kBf16 ? 8 : 4;
  long long head = 0;  // elements handled by the vector loop
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const long long nv = n / kPerVec;
    for (long long i = tid; i < nv; i += stride) {
      const uint4 q = xv[i];
      const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kBf16) {
          c += abs_bits_bf16(words[j] & 0xFFFFu) <= mid;
          c += abs_bits_bf16(words[j] >> 16) <= mid;
        } else {
          c += abs_bits_f32(words[j]) <= mid;
        }
      }
    }
    head = nv * kPerVec;
  }
  for (long long i = head + tid; i < n; i += stride) {
    const uint32_t b =
        kBf16 ? abs_bits_bf16(reinterpret_cast<const uint16_t*>(x)[i])
              : abs_bits_f32(reinterpret_cast<const uint32_t*>(x)[i]);
    c += b <= mid;
  }
  const unsigned total = block_sum(c);
  if (threadIdx.x == 0 && total)
    atomicAdd(&counts[step], static_cast<unsigned long long>(total));
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // exact: v is x or ±0
}

// mask = (|x| ≥ thr) | grow; out = x · mask in T; thr_bits ← thr.
template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const bool* __restrict__ grow,
             long long n, const unsigned long long* __restrict__ counts,
             long long target, T* __restrict__ out, bool* __restrict__ mask,
             int* __restrict__ thr_bits) {
  __shared__ float s_thr;
  if (threadIdx.x == 0) {
    int lo, hi;
    replay(counts, kIters, target, &lo, &hi);
    s_thr = __int_as_float(lo);
    if (blockIdx.x == 0) *thr_bits = lo;
  }
  __syncthreads();
  const float thr = s_thr;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float v = to_f32(x[i]);
    const bool keep = (fabsf(v) >= thr) | grow[i];
    mask[i] = keep;
    out[i] = from_f32<T>(__fmul_rn(v, keep ? 1.f : 0.f));
  }
}

int grid_for(long long units) {
  const long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks < 1) return 1;
  return blocks > kMaxBlocks ? kMaxBlocks : static_cast<int>(blocks);
}

template <typename T, bool kBf16>
int launch_all(const void* x, const bool* grow, long long n, long long target,
               unsigned long long* counts, void* out, bool* mask,
               int* thr_bits, cudaStream_t stream) {
  const int count_grid = grid_for((n + 3) / 4);
  for (int s = 0; s < kIters; ++s) {
    count_kernel<kBf16><<<count_grid, kThreads, 0, stream>>>(x, n, counts, s,
                                                             target);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  apply_kernel<T><<<grid_for(n), kThreads, 0, stream>>>(
      static_cast<const T*>(x), grow, n, counts, target, static_cast<T*>(out),
      mask, thr_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: n elements of float32 (dtype 0) or bfloat16 (dtype 1); grow: n bools;
// target = kth + 1 = n − keep + 1; counts: 31 int64 counters, zeroed by
// the caller; out: n elements of x's type; mask: n bools; thr_bits: one
// int32, the threshold's float32 bits. Launches 32 kernels on `stream`,
// does not synchronise, allocates nothing.
extern "C" int repro_mask_evolve(const void* x, int dtype, const bool* grow,
                                 long long n, long long target,
                                 unsigned long long* counts, void* out,
                                 bool* mask, int* thr_bits,
                                 cudaStream_t stream) {
  if (n < 1 || target < 1 || target > n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_all<float, false>(x, grow, n, target, counts, out, mask,
                                    thr_bits, stream);
  if (dtype == 1)
    return launch_all<__nv_bfloat16, true>(x, grow, n, target, counts, out,
                                           mask, thr_bits, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
