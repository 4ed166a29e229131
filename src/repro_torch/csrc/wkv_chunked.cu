// wkv_chunked: the RWKV6 (Finch) WKV recurrence over chunks of 64 tokens
//
//   S_t = diag(w_t)·S_{t−1} + k_t v_tᵀ,   o_t = r_tᵀ (S_{t−1} + diag(u) k_t v_tᵀ)
//
// per (batch, head), with an (hd × hd) float32 state carried across the
// sequence; it returns the outputs and the final state.
//
// Replaces the TPU kernel src/repro/kernels/wkv_chunked.py::wkv_chunked
// (Pallas body _wkv_kernel), whose grid walks the chunks in order with S in
// VMEM. Hopper wants many blocks in flight, so the work is split in two
// launches (cum = the log-w prefix within a chunk, cum_prev = cum one token
// earlier):
//
// 1. wkv_state_kernel, sequential over chunks and light: one block per
//    (head, batch) carries S in mma accumulators; each chunk's w, k and v
//    come into shared memory by cp.async one chunk ahead of their use; per
//    chunk the block stores S_c, the state entering chunk c, to an f32
//    scratch (b, h, n_chunks, 64, 64), then
//      S ← diag(D)·S + (k ⊙ e^{cum_C − cum})ᵀ·v,   D = e^{cum_C},
//    and after the last chunk it writes the final state.
// 2. wkv_output_kernel, one block per (chunk, head, batch), all in
//    parallel: o = (r ⊙ e^{cum_prev})·S_c + A·v with A[t][s] (s ≤ t) the
//    intra-chunk scores. Over sub-chunks of 16 tokens:
//    - the 6 off-diagonal 16 × 16 sub-blocks (t in a, s in b < a) in the
//      factored form (r_t ⊙ e^{cum_prev_t − g_a})·(k_s ⊙ e^{g_a − cum_s})ᵀ,
//      g_a = cum at the last token before sub-chunk a: both exponents are
//      ≤ 0 for every decay, so no factor exceeds 1 (what the TPU kernel's
//      decay-inside form bought) and the sub-block is a plain product;
//    - the 4 diagonal sub-blocks with the decay inside the sum over
//      channels, Σ_i r_t k_s Π_{s<q<t} w_q, and the bonus Σ_i (r_t k_t) u on
//      the diagonal, on FFMA.
//    Warps 2a, 2a + 1 own output rows 16a ... and form the off-diagonal
//    blocks of sub-chunk 3 − a, which evens out the longer A·v of the
//    later rows.
//    A tail chunk acts as w = 1, r = k = v = 0, as the TPU wrapper pads.
//
// Decay factors are products of w, taken in a fixed order from the edges
// of the sub-chunks (lx_t = Π_{16a ≤ q < t} w_q, rx_s = Π_{s < q < 16(b+1)}
// w_q, the sub-chunk totals T_m), never exps of log-w prefix sums: no expf,
// no logf, and each factor within n·ε of its exact value for n ≤ 64
// factors, where e^{cum_prev − cum} loses ε·|cum| (|cum| reaches 64·87.5
// where the reference clamps w = 0 to 1e-38). w = 0 gives an exact 0.
//
// Products on tensor cores in 3xTF32: mma.sync m16n8k8 tf32 with f32
// accumulators; each f32 operand x is split into hi = cvt.rna.tf32(x) and
// lo = cvt.rna.tf32(x − hi), and lo·hi + hi·lo + hi·hi go into one
// accumulator (~f32 precision; one TF32 product would miss the one-bf16-ulp
// and 1e-5-of-max|S| checks). Where the B operand is v in bf16 or f16 it is
// exact in TF32, its lo is 0 and that product is left out. mma.sync rather
// than wgmma: wgmma takes TF32 only K-major from shared memory, and these
// 16–64 wide tiles are built in registers and shared memory. The CPU twin
// of this arithmetic is
// tests/test_torch_kernels_hopper.py::wkv_two_pass_emulation.
//
// Bound on the H100: at the rwkv6-7b prefill shape (B=4, S=4096, H=64,
// hd=64; r/k/v bf16, w f32) the function must move 0.81 GB (0.24 ms at
// 3.35 TB/s) and do the recurrence's 2.2e10 operations (0.045 ms at the
// 495 TFLOP/s TF32 tensor peak; 0.33 ms at 67 TFLOP/s fp32), so bytes bound
// it. This design also writes and reads S_c (0.54 GB) and reads k, v and w
// twice: ~1.9 GB, a floor of ~0.55 ms.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;       // tokens per chunk
constexpr int kHd = 64;          // head width
constexpr int kSub = 16;         // tokens per sub-chunk
constexpr int kNSub = kChunk / kSub;
// Row strides of the shared tiles, in floats, chosen so that the mma
// fragment reads hit 32 distinct banks: a tile read as [row g][col t]
// (g = lane / 4, t = lane % 4) has a stride ≡ 4 (mod 32), one read as
// [row t][col g] a stride ≡ 8 (mod 32).
constexpr int kLdA = 68;
constexpr int kLdB = 72;
constexpr int kThreads = 256;

constexpr size_t kOutSmemFloats =
    4 * kChunk * kLdA + 2 * kChunk * kLdB + kHd + 2 * kNSub * kHd + 3 * kHd;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// 8 consecutive elements as f32 (one 16-byte load for 16-bit types)
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    x[2 * q] = f.x;
    x[2 * q + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const __half* p, float* x) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&a);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __half22float2(h[q]);
    x[2 * q] = f.x;
    x[2 * q + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* x) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// x split into TF32 hi + lo: hi = x rounded to nearest (ties away) at 10
// mantissa bits, lo = the remainder rounded the same way
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi & 0xffffe000u);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

struct FragA {   // a 16 × 8 row-major operand, hi and lo parts
  uint32_t hi[4], lo[4];
};
struct FragB {   // an 8 × 8 column operand, hi and lo parts
  uint32_t hi[2], lo[2];
};

// A fragment from its four elements: (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4) of the 16 × 8 tile, g = lane / 4, t = lane % 4
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}
// B fragment from its two elements: (k = t, n = g) and (k = t + 4, n = g).
// kExact: the elements are bf16 or f16 values, exact in TF32, so lo = 0
// and is left out.
template <bool kExact = false>
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  if (kExact) {
    f.hi[0] = __float_as_uint(b0);
    f.hi[1] = __float_as_uint(b1);
  } else {
    split_tf32(b0, f.hi[0], f.lo[0]);
    split_tf32(b1, f.hi[1], f.lo[1]);
  }
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b in 3xTF32 (kExact: b's lo is 0, its product is left out); d's
// elements are (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) of the
// 16 × 8 tile
template <bool kExact = false>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  if (!kExact) mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// a 16-byte copy global → shared that bypasses registers; size 0 fills
// the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int size) {
  const uint32_t dst =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(size));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T>
constexpr bool kHalfWidth = sizeof(T) == 2;   // bf16, f16: exact in TF32

__device__ __forceinline__ size_t token_at(int b, int gt, int seq, int h,
                                           int head) {
  return (((size_t)b * seq + gt) * h + head) * kHd;
}

// ---------------------------------------------------------------------------
// pass 1: the state entering every chunk
// ---------------------------------------------------------------------------

// grid (h, b), 256 threads. Warp w holds key rows 16·(w % 4) ... and
// value columns 32·(w / 4) ... of S as four 16 × 8 accumulator tiles.
// Each chunk's w, k and v come into a shared staging buffer by cp.async,
// one chunk ahead of its use; thread (sa, ch) = (tid / 64, tid % 64)
// forms channel ch's products over sub-chunk sa.
template <typename T>
struct StateSmem {
  float w[2][kChunk * kHd];     // staged w, k, v of two chunks
  T k[2][kChunk * kHd];
  T v[2][kChunk * kHd];
  float kd[kChunk * kLdB];      // k ⊙ e^{cum_C − cum}
  float vs[kChunk * kLdB];      // v as f32
  float ts[kNSub * kHd];        // sub-chunk totals
  float dc[kHd];                // D = e^{cum_C}
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wkv_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ w, const float* __restrict__ s0,
                 float* __restrict__ s_chunks, float* __restrict__ s_fin,
                 int seq, int h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StateSmem<T>& sm = *reinterpret_cast<StateSmem<T>*>(smem_raw);
  constexpr bool kExactV = kHalfWidth<T>;
  constexpr int kPer = 16 / sizeof(T);         // elements per 16 bytes

  const int head = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = 16 * (warp & 3) + g, row1 = row0 + 8;
  const int col = 32 * (warp >> 2) + 2 * t4;           // + 8·nt
  const int sa = tid >> 6, ch = tid & 63;
  const int n_chunks = (seq + kChunk - 1) / kChunk;
  const size_t state_at = ((size_t)b * h + head) * kHd * kHd;

  // chunk c's w, k, v rows into staging buffer c % 2 (rows past the end
  // are zero-filled)
  auto stage = [&](int c) {
    const int buf = c & 1, t0 = c * kChunk;
    for (int p = tid; p < kChunk * kHd / 4; p += kThreads) {
      const int tok = p >> 4, c4 = (p & 15) * 4;
      const bool live = t0 + tok < seq;
      cp_async16(&sm.w[buf][tok * kHd + c4],
                 w + (live ? token_at(b, t0 + tok, seq, h, head) + c4 : 0),
                 live ? 16 : 0);
    }
    for (int p = tid; p < kChunk * kHd / kPer; p += kThreads) {
      const int tok = p / (kHd / kPer), cc = (p % (kHd / kPer)) * kPer;
      const bool live = t0 + tok < seq;
      const size_t at = live ? token_at(b, t0 + tok, seq, h, head) + cc : 0;
      cp_async16(&sm.k[buf][tok * kHd + cc], k + at, live ? 16 : 0);
      cp_async16(&sm.v[buf][tok * kHd + cc], v + at, live ? 16 : 0);
    }
    cp_async_commit();
  };

  float st[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const float2 x = *reinterpret_cast<const float2*>(
        s0 + state_at + row0 * kHd + col + 8 * nt);
    const float2 y = *reinterpret_cast<const float2*>(
        s0 + state_at + row1 * kHd + col + 8 * nt);
    st[nt][0] = x.x; st[nt][1] = x.y; st[nt][2] = y.x; st[nt][3] = y.y;
  }
  stage(0);

  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1, t0 = c * kChunk;
    cp_async_wait_all();
    __syncthreads();   // chunk c is staged; chunk c − 1 is consumed
    if (c + 1 < n_chunks) stage(c + 1);

    float* sc = s_chunks + (((size_t)b * h + head) * n_chunks + c) * kHd *
                               kHd;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      store2(sc + row0 * kHd + col + 8 * nt, st[nt][0], st[nt][1]);
      store2(sc + row1 * kHd + col + 8 * nt, st[nt][2], st[nt][3]);
    }
    // the sub-chunk's total (in token order) and rx_j = Π_{j < q < 16} w_q,
    // taken from the sub-chunk's end; w is 1 past the sequence's end
    float wv[kSub];
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int tok = kSub * sa + j;
      wv[j] = t0 + tok < seq ? sm.w[buf][tok * kHd + ch] : 1.f;
    }
    float tot = 1.f;
#pragma unroll
    for (int j = 0; j < kSub; ++j) tot *= wv[j];
    float run = 1.f;
#pragma unroll
    for (int j = kSub - 1; j >= 0; --j) {
      const float wj = wv[j];
      wv[j] = run;
      run *= wj;
    }
    sm.ts[sa * kHd + ch] = tot;
    for (int e = tid; e < kChunk * kHd; e += kThreads)
      sm.vs[(e >> 6) * kLdB + (e & 63)] = to_f32(sm.v[buf][e]);
    __syncthreads();

    float after = 1.f;   // T_{sa+1} ⋯ T_3
#pragma unroll
    for (int m = 1; m < kNSub; ++m)
      if (m > sa) after *= sm.ts[m * kHd + ch];
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int tok = kSub * sa + j;
      sm.kd[tok * kLdB + ch] =
          (to_f32(sm.k[buf][tok * kHd + ch]) * wv[j]) * after;
    }
    if (sa == 0) {
      float d = 1.f;
#pragma unroll
      for (int m = 0; m < kNSub; ++m) d *= sm.ts[m * kHd + ch];
      sm.dc[ch] = d;
    }
    __syncthreads();

    const float d0 = sm.dc[row0], d1 = sm.dc[row1];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      st[nt][0] *= d0; st[nt][1] *= d0; st[nt][2] *= d1; st[nt][3] *= d1;
    }
    // S[i][j] += Σ_s kd[s][i]·v[s][j]: A = kdᵀ (i rows, s columns)
#pragma unroll
    for (int kk = 0; kk < kChunk / 8; ++kk) {
      const int s_lo = 8 * kk + t4, s_hi = s_lo + 4;
      const FragA fa = frag_a(
          sm.kd[s_lo * kLdB + row0], sm.kd[s_lo * kLdB + row1],
          sm.kd[s_hi * kLdB + row0], sm.kd[s_hi * kLdB + row1]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int j = 32 * (warp >> 2) + 8 * nt + g;
        mma3<kExactV>(st[nt], fa, frag_b<kExactV>(sm.vs[s_lo * kLdB + j],
                                                  sm.vs[s_hi * kLdB + j]));
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    store2(s_fin + state_at + row0 * kHd + col + 8 * nt, st[nt][0],
           st[nt][1]);
    store2(s_fin + state_at + row1 * kHd + col + 8 * nt, st[nt][2],
           st[nt][3]);
  }
}

// ---------------------------------------------------------------------------
// pass 2: every chunk's outputs, in parallel
// ---------------------------------------------------------------------------

// grid (n_chunks, h, b), 256 threads. Warps 2a and 2a + 1 own sub-chunk a
// (output rows 16a ... 16a + 15), each 32 of the 64 value columns.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wkv_output_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u,
                  const float* __restrict__ s_chunks, T* __restrict__ out,
                  int seq, int h) {
  extern __shared__ __align__(16) float sm[];
  float* rs = sm;                     // r, then r ⊙ lx
  float* ks = rs + kChunk * kLdA;     // k, then k ⊙ rx
  float* ws = ks + kChunk * kLdA;     // w
  float* as = ws + kChunk * kLdA;     // the scores A[t][s]
  float* vs = as + kChunk * kLdA;     // v
  float* ss = vs + kChunk * kLdB;     // S_c[i][j]
  float* us = ss + kChunk * kLdB;     // u of this head
  float* ts = us + kHd;               // the sub-chunk totals T_m
  float* pre = ts + kNSub * kHd;      // T_0 ⋯ T_{a−1}, per sub-chunk a
  float* mid = pre + kNSub * kHd;     // T_1, T_2, T_1·T_2
  constexpr bool kExactV = kHalfWidth<T>;

  const int c = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int a = warp >> 1, hh = warp & 1;
  const int t0 = c * kChunk;
  const int n_chunks = gridDim.x;

  // ---- load the chunk: r, k, v as f32 rows; w (1 past the end); S_c; u
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int e = tid + kThreads * n;
    const int tok = e >> 3, i0 = (e & 7) * 8;
    float xr[8], xk[8], xv[8];
    if (t0 + tok < seq) {
      const size_t at = token_at(b, t0 + tok, seq, h, head) + i0;
      load8(r + at, xr);
      load8(k + at, xk);
      load8(v + at, xv);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) xr[j] = xk[j] = xv[j] = 0.f;
    }
    store8(rs + tok * kLdA + i0, xr);
    store8(ks + tok * kLdA + i0, xk);
    store8(vs + tok * kLdB + i0, xv);
  }
  const float* sc = s_chunks + (((size_t)b * h + head) * n_chunks + c) *
                                   kHd * kHd;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int e = tid + kThreads * n;
    const int row = e >> 4, c4 = (e & 15) * 4;
    float4 x = make_float4(1.f, 1.f, 1.f, 1.f);
    if (t0 + row < seq)
      x = *reinterpret_cast<const float4*>(
          w + token_at(b, t0 + row, seq, h, head) + c4);
    *reinterpret_cast<float4*>(ws + row * kLdA + c4) = x;
    *reinterpret_cast<float4*>(ss + row * kLdB + c4) =
        *reinterpret_cast<const float4*>(sc + row * kHd + c4);
  }
  if (tid < kHd / 4)
    *reinterpret_cast<float4*>(us + 4 * tid) =
        *reinterpret_cast<const float4*>(u + head * kHd + 4 * tid);
  __syncthreads();

  // ---- the diagonal sub-block of sub-chunk a, decay inside the sum:
  // lane (row t = 2·(lane % 8) + hh, channels 16·(lane / 8) ...) keeps
  // A[t][s] = Σ_i (r_t k_s)·P, P = Π_{s<q<t} w_q built downwards from
  // s = t − 1, and the bonus Σ_i (r_t k_t)·u at s = t; every lane walks
  // all 16 s with selects (no divergent branches); the 4 channel quarters
  // are summed by shuffles
  {
    const int t = 2 * (lane & 7) + hh, cq = lane >> 3;
    const int row = kSub * a + t;
    float acc[kSub];
#pragma unroll
    for (int s = 0; s < kSub; ++s) acc[s] = 0.f;
    // four channels at a time: 16-byte loads, four independent P chains
    for (int iq = 0; iq < 4; ++iq) {
      const int i = 16 * cq + 4 * iq;
      const float4 r4 = *reinterpret_cast<const float4*>(rs + row * kLdA + i);
      const float4 u4 = *reinterpret_cast<const float4*>(us + i);
      const float ri[4] = {r4.x, r4.y, r4.z, r4.w};
      const float ui[4] = {u4.x, u4.y, u4.z, u4.w};
      float p[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
      for (int s = kSub - 1; s >= 0; --s) {
        const int at = (kSub * a + s) * kLdA + i;
        const float4 k4 = *reinterpret_cast<const float4*>(ks + at);
        const float4 w4 = *reinterpret_cast<const float4*>(ws + at);
        const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float coef = s < t ? p[c] : (s == t ? ui[c] : 0.f);
          acc[s] = fmaf(ri[c] * kv[c], coef, acc[s]);
          p[c] = s < t ? p[c] * wv[c] : p[c];
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      acc[s] += __shfl_xor_sync(0xffffffffu, acc[s], 8);
      acc[s] += __shfl_xor_sync(0xffffffffu, acc[s], 16);
    }
#pragma unroll
    for (int s = 0; s < kSub; ++s)
      if ((s >> 2) == cq)
        as[row * kLdA + kSub * a + s] = s <= t ? acc[s] : 0.f;
  }

  // ---- per sub-chunk products of w: thread (sa, ch) takes channel ch of
  // sub-chunk sa from its edges inwards
  const int sa = tid >> 6, ch = tid & 63;
  float lx[kSub], rx[kSub];
  {
    float run = 1.f;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      lx[j] = run;
      run *= ws[(kSub * sa + j) * kLdA + ch];
    }
    ts[sa * kHd + ch] = run;
    run = 1.f;
#pragma unroll
    for (int j = kSub - 1; j >= 0; --j) {
      rx[j] = run;
      run *= ws[(kSub * sa + j) * kLdA + ch];
    }
  }
  __syncthreads();   // the raw r and k are read for the last time above
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    rs[(kSub * sa + j) * kLdA + ch] *= lx[j];
    ks[(kSub * sa + j) * kLdA + ch] *= rx[j];
  }
  {
    // products of the totals, in order: before sub-chunk sa, and the
    // middle ones the off-diagonal blocks (2, 0), (3, 1), (3, 0) need
    float run = 1.f;
    for (int m = 0; m < sa; ++m) run *= ts[m * kHd + ch];
    pre[sa * kHd + ch] = run;
    if (sa == 1) mid[ch] = ts[kHd + ch];                          // T1
    if (sa == 2) mid[kHd + ch] = ts[2 * kHd + ch];                // T2
    if (sa == 3) mid[2 * kHd + ch] = ts[kHd + ch] * ts[2 * kHd + ch];
  }
  __syncthreads();

  const int row0 = kSub * a + g, row1 = row0 + 8;
  const int col0 = 32 * hh + g;   // + 8·nt: this lane's B column
  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  // ---- cross-chunk: (r ⊙ lx ⊙ T_0⋯T_{a−1})·S_c
#pragma unroll
  for (int kk = 0; kk < kHd / 8; ++kk) {
    const int i0 = 8 * kk + t4, i1 = i0 + 4;
    const float p0 = pre[a * kHd + i0], p1 = pre[a * kHd + i1];
    const FragA fa = frag_a(rs[row0 * kLdA + i0] * p0,
                            rs[row1 * kLdA + i0] * p0,
                            rs[row0 * kLdA + i1] * p1,
                            rs[row1 * kLdA + i1] * p1);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int j = col0 + 8 * nt;
      mma3(acc[nt], fa, frag_b(ss[i0 * kLdB + j], ss[i1 * kLdB + j]));
    }
  }

  // ---- off-diagonal sub-blocks (ao, bb < ao) with ao = 3 − a, 8 of the
  // 16 columns each: (r ⊙ lx)_ao · (k ⊙ rx ⊙ T_{bb+1}⋯T_{ao−1})_bbᵀ. The
  // pair with the longest A·v (a = 3) gets none, the one with the
  // shortest the most.
  const int ao = kNSub - 1 - a;
  if (ao > 0) {
    const int orow0 = kSub * ao + g, orow1 = orow0 + 8;
    float pacc[kNSub - 1][4];
#pragma unroll
    for (int bb = 0; bb < kNSub - 1; ++bb)
#pragma unroll
      for (int e = 0; e < 4; ++e) pacc[bb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHd / 8; ++kk) {
      const int i0 = 8 * kk + t4, i1 = i0 + 4;
      const FragA fa = frag_a(rs[orow0 * kLdA + i0], rs[orow1 * kLdA + i0],
                              rs[orow0 * kLdA + i1], rs[orow1 * kLdA + i1]);
#pragma unroll
      for (int bb = 0; bb < kNSub - 1; ++bb) {
        if (bb < ao) {
          // T_{bb+1}⋯T_{ao−1}: 1, T1 (2, 0), T2 (3, 1), T1·T2 (3, 0)
          const int m = bb + 1 == ao ? -1 : (ao == 2 ? 0 : (bb == 1 ? 1 : 2));
          const float m0 = m < 0 ? 1.f : mid[m * kHd + i0];
          const float m1 = m < 0 ? 1.f : mid[m * kHd + i1];
          const int s = kSub * bb + 8 * hh + g;
          mma3(pacc[bb], fa, frag_b(ks[s * kLdA + i0] * m0,
                                    ks[s * kLdA + i1] * m1));
        }
      }
    }
#pragma unroll
    for (int bb = 0; bb < kNSub - 1; ++bb) {
      if (bb < ao) {
        const int s = kSub * bb + 8 * hh + 2 * t4;
        as[orow0 * kLdA + s] = pacc[bb][0];
        as[orow0 * kLdA + s + 1] = pacc[bb][1];
        as[orow1 * kLdA + s] = pacc[bb][2];
        as[orow1 * kLdA + s + 1] = pacc[bb][3];
      }
    }
  }
  __syncthreads();   // every pair wrote another sub-chunk's rows of A

  // ---- A·v over s < 16(a + 1)
  for (int kk = 0; kk < 2 * (a + 1); ++kk) {
    const int s0 = 8 * kk + t4, s1 = s0 + 4;
    const FragA fa = frag_a(as[row0 * kLdA + s0], as[row1 * kLdA + s0],
                            as[row0 * kLdA + s1], as[row1 * kLdA + s1]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int j = col0 + 8 * nt;
      mma3<kExactV>(acc[nt], fa, frag_b<kExactV>(vs[s0 * kLdB + j],
                                                 vs[s1 * kLdB + j]));
    }
  }

#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int j = 32 * hh + 8 * nt + 2 * t4;
    if (t0 + row0 < seq)
      store2(out + token_at(b, t0 + row0, seq, h, head) + j, acc[nt][0],
             acc[nt][1]);
    if (t0 + row1 < seq)
      store2(out + token_at(b, t0 + row1, seq, h, head) + j, acc[nt][2],
             acc[nt][3]);
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* out, float* s_fin,
           float* s_chunks, int b, int seq, int h, cudaStream_t stream) {
  const int n_chunks = (seq + kChunk - 1) / kChunk;
  const size_t state_smem = sizeof(StateSmem<T>);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)state_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_state_kernel<T><<<dim3(h, b), kThreads, state_smem, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), w, s0, s_chunks,
      s_fin, seq, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = kOutSmemFloats * sizeof(float);
  err = cudaFuncSetAttribute(wkv_output_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_output_kernel<T><<<dim3(n_chunks, h, b), kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s_chunks, static_cast<T*>(out), seq,
      h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v: (b, seq, h, 64) in one type (dtype 0 = float32, 1 = bfloat16,
// 2 = float16); w: (b, seq, h, 64) float32 decays in [0, 1]; u: (h, 64)
// float32; s0: (b, h, 64, 64) float32 initial state; out: like r;
// s_fin: like s0; s_chunks: float32 scratch of (b, h, ceil(seq / 64), 64,
// 64). All contiguous on the device and 16-byte aligned. Launches the two
// passes on `stream`, does not synchronise, allocates nothing.
extern "C" int repro_wkv_chunked(const void* r, const void* k, const void* v,
                                 const float* w, const float* u,
                                 const float* s0, void* out, float* s_fin,
                                 float* s_chunks, int dtype, int b, int seq,
                                 int h, int hd, cudaStream_t stream) {
  if (b <= 0 || seq <= 0 || h <= 0 || hd != kHd || h > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return launch<float>(r, k, v, w, u, s0, out, s_fin, s_chunks, b, seq,
                           h, stream);
    case 1:
      return launch<__nv_bfloat16>(r, k, v, w, u, s0, out, s_fin, s_chunks,
                                   b, seq, h, stream);
    case 2:
      return launch<__half>(r, k, v, w, u, s0, out, s_fin, s_chunks, b, seq,
                            h, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
