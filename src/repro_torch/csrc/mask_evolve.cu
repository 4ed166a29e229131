// mask_evolve: DisPFL's mask evolution over every stacked parameter leaf
// of a round, in one call — for each leaf
//   thr  = the (n − keep)-th smallest |x| (0-based), exact
//   mask = (|x| ≥ thr) | grow
//   out  = x · mask          (a product, in x's type: −x·0 is −0.0)
// for float32 or bfloat16 leaves.
//
// Replaces the TPU kernel src/repro/kernels/mask_evolve.py::mask_evolve
// (Pallas bodies _thr_kernel and _apply_kernel), whose threshold is a
// bisection of [0, 0x7F800000] over the bits of |x|: 31 halvings, each
// keeping the lower half when at least kth + 1 elements have bits ≤ mid,
// else moving lo to mid + 1. It ends on the exact kth-smallest |x| where
// that is at most +inf. Where it is a NaN every step moves lo, and the
// interval closes on 0x7F800000 one step early, so the last step ends on
// 0x7F800001: a NaN threshold, which keeps nothing but the regrowth.
//
// Here the same value comes from an exact radix select. The bits of a
// non-negative float32 are ordered like its integer, so the kth-smallest
// |x| is found digit by digit, most significant first: bits 30..24, then
// 23..16, 15..8 and 7..0. Pass p histograms digit p of the elements whose
// higher digits equal the prefix found so far; a select step then walks
// the bins in ascending order to the digit at which the running count
// reaches the remaining target (kth + 1 at first), appends it to the
// prefix and subtracts the elements below it from the target. After the
// last pass the prefix is the kth-smallest |x|, clamped to 0x7F800001 as
// the bisection's end is. A bfloat16 |x| has no bits below 16, so its
// leaves take the first two passes only (the rest would find 0).
//
// One call covers a list of leaves, described by a device table (pointers,
// n, target, first block, dtype; float32 leaves first). Blocks map to
// (leaf, chunk) through the table's prefix sum of each leaf's block count,
// so a 10-element and a 37.7 M-element leaf share one grid. Each block
// builds its histogram in shared memory — a two-entry run cache per thread
// absorbs the few bins that hold most elements in the first pass — and
// adds its non-zero bins to the leaf's global histogram with integer
// atomics, so the sums do not depend on order. The block that finishes a
// leaf's pass last (a ticket counter) runs the select step and clears the
// histogram for the next pass. The apply launch then writes out, mask and
// the threshold of every leaf. A call is one launch per pass (4 with a
// float32 leaf, else 2) and one apply, queued back to back with no host
// synchronisation.
//
// Bound on the H100: bytes. The function must read x and grow once and
// write out and mask once: for the largest leaf of the dispfl round
// (16 × 2,359,296 bfloat16 weights, 37.7 M) that is 226 MB, 0.07 ms at
// 3.35 TB/s. This design reads a bfloat16 leaf three times (two
// histograms and the apply), 377 MB for that leaf; the leaf is larger
// than the 50 MB L2, so those reads go to device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// where the bisection ends when the kth-smallest |x| is a NaN: the
// first NaN above +inf (0x7F800000)
constexpr uint32_t kNanEndBits = 0x7F800001u;
constexpr int kThreads = 256;
constexpr int kBins = 256;
constexpr int kMaxLeaves = 1024;   // the table's rows a block can search

// A row of the leaf table: eight 64-bit words.
struct Leaf {
  long long x, grow, out, mask;  // device pointers
  long long n;                   // elements
  long long target;              // kth + 1 = n − keep + 1
  long long begin;               // the leaf's first block
  long long dtype;               // 0 float32, 1 bfloat16
};

// Per-leaf workspace, zeroed by the caller: the current pass's
// histogram, the ticket of blocks done, the prefix and the target left.
struct LeafState {
  unsigned long long hist[kBins];
  unsigned long long ticket;
  unsigned long long prefix;
  unsigned long long remaining;
  unsigned long long pad;
};

__device__ __forceinline__ int passes_of(long long dtype) {
  return dtype == 0 ? 4 : 2;
}

// digit p of |x|'s bits: its lowest bit, and the first bit above it
__device__ __forceinline__ int digit_shift(int pass) { return 24 - 8 * pass; }
__device__ __forceinline__ int high_shift(int pass) {
  return pass == 0 ? 31 : 32 - 8 * pass;
}

// |x| as float32 bits, from one float32 word
__device__ __forceinline__ uint32_t abs_bits_f32(uint32_t word) {
  return word & 0x7FFFFFFFu;
}

// |x| as float32 bits, from one bfloat16 half-word
__device__ __forceinline__ uint32_t abs_bits_bf16(uint32_t half) {
  return (half & 0x7FFFu) << 16;
}

// Block b's leaf: the last row whose first block is ≤ b. The rows' first
// blocks are staged in shared memory, then searched by thread 0.
__device__ int find_leaf(const Leaf* __restrict__ table, int n_leaves,
                         long long* s_begin) {
  __shared__ int s_leaf;
  for (int l = threadIdx.x; l < n_leaves; l += kThreads)
    s_begin[l] = table[l].begin;
  __syncthreads();
  if (threadIdx.x == 0) {
    int lo = 0, hi = n_leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (s_begin[mid] <= (long long)blockIdx.x) lo = mid;
      else hi = mid - 1;
    }
    s_leaf = lo;
  }
  __syncthreads();
  return s_leaf;
}

__device__ __forceinline__ long long leaf_blocks(const long long* s_begin,
                                                 int leaf, int n_leaves,
                                                 long long grid) {
  return (leaf + 1 < n_leaves ? s_begin[leaf + 1] : grid) - s_begin[leaf];
}

// 16-byte vectors where every pointer of the leaf allows them: VEC
// elements of x, out (16 bytes) and of grow, mask (VEC bytes)
__device__ __forceinline__ bool vector_ok(const Leaf& lf, int vec) {
  return lf.x % 16 == 0 && lf.out % 16 == 0 && lf.grow % vec == 0 &&
         lf.mask % vec == 0;
}

// Two bins cached in registers: a run of elements in the same bin costs
// one shared-memory atomic, not one each.
struct BinCache {
  uint32_t bin0 = 0xFFFFFFFFu, count0 = 0, bin1 = 0xFFFFFFFFu, count1 = 0;

  __device__ __forceinline__ void add(uint32_t bin, uint32_t* hist) {
    if (bin == bin0) {
      ++count0;
    } else if (bin == bin1) {
      ++count1;
    } else {
      if (count1) atomicAdd(&hist[bin1], count1);
      bin1 = bin0;
      count1 = count0;
      bin0 = bin;
      count0 = 1;
    }
  }

  __device__ __forceinline__ void flush(uint32_t* hist) {
    if (count0) atomicAdd(&hist[bin0], count0);
    if (count1) atomicAdd(&hist[bin1], count1);
  }
};

// Inclusive sum of one u64 per thread over the block.
__device__ unsigned long long block_inclusive_scan(unsigned long long v) {
  __shared__ unsigned long long warp_tot[kThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long up = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += up;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  unsigned long long before = 0;
  for (int w = 0; w < warp; ++w) before += warp_tot[w];
  return v + before;
}

// The block's chunk of one leaf into the block's histogram of digit
// `pass`, counting only elements whose higher digits equal the prefix.
template <bool kBf16>
__device__ void histogram_chunk(const Leaf& lf, long long j, long long nb,
                                int pass, uint32_t prefix, uint32_t* hist) {
  constexpr int kVec = kBf16 ? 8 : 4;   // elements per 16-byte vector
  const int shift = digit_shift(pass), hi = high_shift(pass);
  const uint32_t want = prefix >> hi;
  const long long n = lf.n;
  const long long stride = nb * kThreads;
  BinCache cache;
  long long head = 0;   // elements taken by the vector loop
  if (vector_ok(lf, kVec)) {
    const uint4* xv = reinterpret_cast<const uint4*>(lf.x);
    const long long nv = n / kVec;
    for (long long u = j * kThreads + threadIdx.x; u < nv; u += stride) {
      const uint4 q = xv[u];
      const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if (kBf16) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t b = abs_bits_bf16(words[w] >> (16 * h) & 0xFFFFu);
            if ((b >> hi) == want) cache.add((b >> shift) & 0xFFu, hist);
          }
        } else {
          const uint32_t b = abs_bits_f32(words[w]);
          if ((b >> hi) == want) cache.add((b >> shift) & 0xFFu, hist);
        }
      }
    }
    head = nv * kVec;
  }
  for (long long i = head + j * kThreads + threadIdx.x; i < n; i += stride) {
    const uint32_t b =
        kBf16 ? abs_bits_bf16(reinterpret_cast<const uint16_t*>(lf.x)[i])
              : abs_bits_f32(reinterpret_cast<const uint32_t*>(lf.x)[i]);
    if ((b >> hi) == want) cache.add((b >> shift) & 0xFFu, hist);
  }
  cache.flush(hist);
}

// One digit pass over every leaf whose blocks lie in the grid: the block's
// histogram of the digit, added to the leaf's; the leaf's last block then
// fixes the digit, updates prefix and target, clears the histogram and,
// after the leaf's last pass, writes its threshold bits.
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const Leaf* __restrict__ table, int n_leaves,
                 LeafState* __restrict__ states, int* __restrict__ thr_bits,
                 int pass) {
  __shared__ long long s_begin[kMaxLeaves];
  __shared__ uint32_t hist[kBins];
  __shared__ bool s_last;
  const int leaf = find_leaf(table, n_leaves, s_begin);
  const Leaf lf = table[leaf];
  const int passes = passes_of(lf.dtype);
  if (pass >= passes) return;   // the whole block: this leaf is done
  LeafState* st = states + leaf;
  const long long j = blockIdx.x - s_begin[leaf];
  const long long nb = leaf_blocks(s_begin, leaf, n_leaves, gridDim.x);
  const uint32_t prefix = pass == 0 ? 0u : static_cast<uint32_t>(st->prefix);

  for (int b = threadIdx.x; b < kBins; b += kThreads) hist[b] = 0;
  __syncthreads();
  if (lf.dtype == 1)
    histogram_chunk<true>(lf, j, nb, pass, prefix, hist);
  else
    histogram_chunk<false>(lf, j, nb, pass, prefix, hist);
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += kThreads)
    if (hist[b]) atomicAdd(&st->hist[b], (unsigned long long)hist[b]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&st->ticket, 1ull) == (unsigned long long)(nb - 1);
  __syncthreads();
  if (!s_last) return;

  // ---- select step, in the leaf's last block -----------------------------
  __threadfence();
  const unsigned long long target =
      pass == 0 ? (unsigned long long)lf.target : __ldcg(&st->remaining);
  const int bin = threadIdx.x;   // kThreads == kBins: one bin a thread
  const unsigned long long count = __ldcg(&st->hist[bin]);
  const unsigned long long upto = block_inclusive_scan(count);
  const unsigned long long below = upto - count;
  __syncthreads();
  if (below < target && upto >= target) {   // exactly one bin
    const uint32_t found =
        prefix | (static_cast<uint32_t>(bin) << digit_shift(pass));
    st->prefix = found;
    st->remaining = target - below;
    if (pass == passes - 1)
      thr_bits[leaf] = static_cast<int>(min(found, kNanEndBits));
  }
  st->hist[bin] = 0;
  if (threadIdx.x == 0) st->ticket = 0;
}

// mask = (|x| ≥ thr) | grow and out = x · mask for one element given by
// its bits: a float32 word, or a bfloat16 half-word (bfloat16 → float32
// is a shift of the bits, exact; back, x and ±0 are exact)
template <bool kBf16>
__device__ __forceinline__ uint32_t apply_bits(uint32_t bits, bool grow,
                                               float thr, bool* keep) {
  const float v = kBf16 ? __uint_as_float(bits << 16) : __uint_as_float(bits);
  *keep = (fabsf(v) >= thr) | grow;
  const float r = __fmul_rn(v, *keep ? 1.f : 0.f);
  return kBf16 ? __bfloat16_as_ushort(__float2bfloat16_rn(r))
               : __float_as_uint(r);
}

// the block's chunk of one leaf, 16-byte vectors where aligned
template <bool kBf16>
__device__ void apply_chunk(const Leaf& lf, long long j, long long nb,
                            float thr) {
  constexpr int kVec = kBf16 ? 8 : 4;   // elements per 16-byte vector
  const bool* grow = reinterpret_cast<const bool*>(lf.grow);
  bool* mask = reinterpret_cast<bool*>(lf.mask);
  const long long n = lf.n;
  const long long stride = nb * kThreads;
  long long head = 0;
  if (vector_ok(lf, kVec)) {
    const long long nv = n / kVec;
    for (long long u = j * kThreads + threadIdx.x; u < nv; u += stride) {
      const uint4 q = reinterpret_cast<const uint4*>(lf.x)[u];
      const uint32_t words[4] = {q.x, q.y, q.z, q.w};
      const unsigned long long g =
          kBf16 ? reinterpret_cast<const unsigned long long*>(grow)[u]
                : reinterpret_cast<const uint32_t*>(grow)[u];
      uint32_t res[4];
      unsigned long long kept = 0;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        bool k0, k1;
        if (kBf16) {
          const int e = 2 * w;
          const uint32_t lo = apply_bits<true>(
              words[w] & 0xFFFFu, (g >> (8 * e)) & 0xFF, thr, &k0);
          const uint32_t hi = apply_bits<true>(
              words[w] >> 16, (g >> (8 * e + 8)) & 0xFF, thr, &k1);
          res[w] = lo | hi << 16;
          kept |= (unsigned long long)k0 << (8 * e) |
                  (unsigned long long)k1 << (8 * e + 8);
        } else {
          res[w] = apply_bits<false>(words[w], (g >> (8 * w)) & 0xFF, thr,
                                     &k0);
          kept |= (unsigned long long)k0 << (8 * w);
        }
      }
      reinterpret_cast<uint4*>(lf.out)[u] =
          make_uint4(res[0], res[1], res[2], res[3]);
      if (kBf16)
        reinterpret_cast<unsigned long long*>(mask)[u] = kept;
      else
        reinterpret_cast<uint32_t*>(mask)[u] = static_cast<uint32_t>(kept);
    }
    head = nv * kVec;
  }
  for (long long i = head + j * kThreads + threadIdx.x; i < n; i += stride) {
    bool k;
    if (kBf16) {
      uint16_t* out = reinterpret_cast<uint16_t*>(lf.out);
      out[i] = static_cast<uint16_t>(apply_bits<true>(
          reinterpret_cast<const uint16_t*>(lf.x)[i], grow[i], thr, &k));
    } else {
      uint32_t* out = reinterpret_cast<uint32_t*>(lf.out);
      out[i] = apply_bits<false>(reinterpret_cast<const uint32_t*>(lf.x)[i],
                                 grow[i], thr, &k);
    }
    mask[i] = k;
  }
}

__global__ void __launch_bounds__(kThreads)
apply_kernel(const Leaf* __restrict__ table, int n_leaves,
             const int* __restrict__ thr_bits) {
  __shared__ long long s_begin[kMaxLeaves];
  const int leaf = find_leaf(table, n_leaves, s_begin);
  const Leaf lf = table[leaf];
  const long long j = blockIdx.x - s_begin[leaf];
  const long long nb = leaf_blocks(s_begin, leaf, n_leaves, gridDim.x);
  const float thr = __int_as_float(thr_bits[leaf]);
  if (lf.dtype == 1)
    apply_chunk<true>(lf, j, nb, thr);
  else
    apply_chunk<false>(lf, j, nb, thr);
}

}  // namespace

// table: n_leaves rows of 8 int64 (struct Leaf) on the device, the
// float32 leaves first; the rows' first blocks ascend from 0 and every
// leaf has at least one block. states: n_leaves × 260 int64, zeroed.
// thr_bits: n_leaves int32, each leaf's threshold as float32 bits.
// grid: the blocks of all leaves; grid_deep: the blocks of the float32
// leaves (they take passes 2 and 3). Launches one kernel per pass (4 when
// grid_deep > 0, else 2) and the apply on `stream`, does not synchronise,
// allocates nothing.
extern "C" int repro_mask_evolve_leaves(const void* table, int n_leaves,
                                        void* states, int* thr_bits,
                                        int grid, int grid_deep,
                                        cudaStream_t stream) {
  static_assert(sizeof(Leaf) == 64 && sizeof(LeafState) == 260 * 8,
                "the table and workspace layouts are fixed");
  if (n_leaves < 1 || n_leaves > kMaxLeaves || grid < n_leaves ||
      grid_deep < 0 || grid_deep > grid)
    return static_cast<int>(cudaErrorInvalidValue);
  const Leaf* t = static_cast<const Leaf*>(table);
  LeafState* s = static_cast<LeafState*>(states);
  const int passes = grid_deep > 0 ? 4 : 2;
  for (int pass = 0; pass < passes; ++pass) {
    histogram_kernel<<<pass < 2 ? grid : grid_deep, kThreads, 0, stream>>>(
        t, n_leaves, s, thr_bits, pass);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  apply_kernel<<<grid, kThreads, 0, stream>>>(t, n_leaves, thr_bits);
  return static_cast<int>(cudaGetLastError());
}
