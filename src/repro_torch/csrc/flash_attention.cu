// flash_attention: blocked online-softmax attention with causal and
// sliding-window masks, a query offset and grouped-query heads.
//
//   out[b, q, h, :] = softmax_s(q·k[s]ᵀ · scale  over the visible s) · v
//   visible: s < Skv, causal → s ≤ q + q_offset,
//            window > 0 → s > q + q_offset − window;
//   query head h reads kv head h / (H / K).
//
// The kernels are instantiated at hd = 64, 128 and 256; the caller passes
// the scale (1/√hd of the model's head dim), so a head dim between the
// instances runs zero-padded to the next one: zero columns add exact zeros
// to q·k and to P·V.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (Pallas body _flash_kernel). The TPU grid walks the kv
// blocks of one q block in order on one core and carries m, l and acc in
// VMEM scratch between grid steps, skipping whole kv blocks outside the
// band with pl.when. Hopper blocks run in parallel and carry nothing, so
// here a block owns a q tile of one (batch, head) and walks the kv tiles
// of its kv head itself, in order, with m, l and acc in registers; the kv
// tiles wholly outside the causal/window band are never visited.
//
// Bound on the H100: at the qwen2-1.5b prefill shape (B=4, S=4096, H=12,
// K=2, hd=128, causal) the work is 4·B·H·S²·hd/2 = 0.206 TFLOP on 0.13 GB
// of q/k/v/out: 0.21 ms at the 989 TFLOP/s bf16 tensor-core peak, 3.1 ms
// at the 67 TFLOP/s of fp32 FFMA. Operations bound it, so bf16 and f16
// inputs take the tensor cores; f32 inputs keep an FFMA kernel.
//
// Two kernels, chosen by dtype in the Python wrapper:
//
// * bf16 / f16: flash_wgmma_kernel (repro_flash_attention_wgmma). A block
//   of 288 threads owns a 128-row q tile: two consumer warpgroups of 64
//   rows each and one producer warp. The producer loads the block's Q
//   once and keeps 64-row K and V tiles in flight in a 3-slot ring in
//   shared memory, by TMA over 3-D tensor maps (hd of all heads, S, B):
//   the stride between kv heads costs nothing, rows past Skv or Sq of a
//   batch are zero-filled, and the 128-byte swizzle is the one wgmma
//   reads. Each slot has full barriers for K and V and an empty barrier
//   the 256 consumer threads arrive on. Per kv tile a consumer computes
//   S = Q·Kᵀ with wgmma (Q and K in shared memory, K-major, f32
//   accumulators), scales it after the product as the reference does
//   (folded into the exponent, 2^x by the SFU), masks only tiles the band
//   cuts (the diagonal, the window edge, the ragged Skv edge; the others
//   take a path without masks), and runs the online softmax on the
//   accumulator fragments (row max and sum across the quad of lanes that
//   holds a row). P·V is wgmma with P in registers and V an MN-major operand
//   (the descriptor's transpose bit). P keeps f32-level precision: the
//   reference multiplies an f32 p by V, and rounding p to bf16 (as FA2,
//   FA3 and SDPA do) errs by 2⁻⁹ per term, more than one output ulp. So p
//   is split into hi = p rounded to the input type and lo = (p − hi)
//   rounded, and both products accumulate into the same O registers:
//   about 16 mantissa bits for 1.5× the tensor work of plain flash. The
//   two consumer warpgroups take turns on the tensor cores (ping-pong on
//   two named barriers), so one's softmax runs beside the other's
//   wgmmas; a turn issues P·V of one tile and S of the next together.
//   (Overlapping a warpgroup's own softmax with its P·V needs a second P
//   tile in registers; ptxas holds the consumers to 168 registers, the
//   register file over 384 threads, whatever setmaxnreg asks, so that
//   variant spilled and ran slower.) At hd = 256 O alone would take 128
//   registers a thread, so there the two consumer warpgroups share one
//   64-row q tile and each owns half of O's columns: both compute the
//   same S and softmax (the same p, bit for bit), each multiplies P by its
//   128-column half of V. S = Q·Kᵀ is done twice, a third more tensor
//   work; K and V tiles are 32 KB each, the ring of 3 slots 192 KB.
//   q tiles are scheduled longest first
//   (the last q tile of every (b, h) leads the grid), so the causal
//   triangle leaves no ragged last wave. m, l and O stay in f32; the
//   output is O · (1 / max(l, 1e-30)), rounded once.
// * f32: flash_ffma_kernel (repro_flash_attention_f32). 256 threads as a
//   16 × 16 grid own a 64-row q tile: thread (ty, tx) owns query rows
//   4·ty … 4·ty+3 and, of each 64-column S tile, columns tx + 16·j; of the
//   output, head-dim columns tx + 16·c. K (transposed), V and P are
//   staged as f32 in shared memory (116 KB at hd = 128, opted into), S
//   and P·V by fp32 FFMA, row max and sum by shuffles over the 16 lanes
//   of a row, expf: the result equals the plain PyTorch version to f32
//   rounding.
#include <cuda.h>  // CUtensorMap (its encoder is looked up at run time)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: fp32 FFMA
// ---------------------------------------------------------------------------

constexpr int kTile = 64;        // q rows and kv columns per tile
constexpr int kThreads = 256;

template <int HD>
constexpr size_t smem_floats() {
  return kTile * (HD + 4)        // q tile, rows padded
         + HD * (kTile + 1)      // k tile transposed, [d][col]
         + kTile * HD            // v tile
         + kTile * (kTile + 1);  // p tile
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_ffma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  int sq, int skv, int h, int kh, int causal, int window,
                  int q_offset, float scale) {
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
        gq < sq ? q[(((size_t)b * sq + gq) * h + head) * HD + d] : 0.f;
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
      kt[d * kKld + r] = gc < skv ? k[at] : 0.f;
      vs[r * HD + d] = gc < skv ? v[at] : 0.f;
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
    float* dst = out + (((size_t)b * sq + gq) * h + head) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dst[tx + 16 * c] = acc[i][c] / denom;
  }
}

template <int HD>
int launch_ffma(const void* q, const void* k, const void* v, void* out,
                int b, int sq, int skv, int h, int kh, int causal,
                int window, int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  auto kernel = flash_ffma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kTile - 1) / kTile, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, skv, h,
      kh, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 / f16: wgmma fed by TMA
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kConsumerWGs = 2;          // 64 q rows each (hd ≤ 128)
constexpr int kBlockKV = 64;
constexpr int kStages = 3;               // slots of the K/V ring
constexpr int kThreads = 128 * kConsumerWGs + 32;  // + one producer warp
constexpr int kPanelBytes = 64 * 128;    // 64 rows of 64 16-bit columns
constexpr float kLog2e = 1.4426950408889634f;

// How the consumer warpgroups share a block's work. Up to hd = 128 each
// owns 64 q rows and all of O's columns; at hd = 256 they share 64 q rows
// and each owns half of O's columns (kOut).
template <int HD>
struct Split {
  static constexpr bool kCols = HD > 128;
  static constexpr int kBlockQ = kCols ? 64 : 64 * kConsumerWGs;
  static constexpr int kQTiles = kBlockQ / 64;     // Q tiles in smem
  static constexpr int kOut = kCols ? HD / kConsumerWGs : HD;
  static_assert(kOut == 64 || kOut == 128, "P·V takes N = 64 or 128");
};

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle's
// period): Q [q tile][panel], K and V [slot][panel], each panel 64
// rows × 64 columns (128 bytes a row); then the barriers.
template <int HD>
struct Layout {
  static constexpr int kPanels = HD / 64;
  static constexpr int kTileBytes = kPanels * kPanelBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + Split<HD>::kQTiles * kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;
  static_assert(kBytes <= 227 * 1024, "past the opt-in shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Spins until the barrier's phase differs from `parity`. A wait of more
// than ~10 s (a protocol fault, never a slow copy) traps, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// Named barriers 1 and 2 between the two consumer warpgroups (256
// threads: one warpgroup syncs, the other arrives).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptors for the 128-byte swizzle (layout type 1
// in bits 62–63), addresses and offsets in 16-byte units.
// K-major (Q, K): rows of 128 bytes, SBO = 1024 bytes between 8-row
// groups; LBO is unused within one swizzle width (1, as CUTLASS sets it).
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// MN-major (V as the B operand of P·V, N = hd contiguous): LBO = 8192
// bytes between 64-column panels along N, SBO = 1024 bytes between 8-row
// groups along K (kv).
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(kPanelBytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until every committed wgmma group of this warpgroup completed.
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64×64 f32) (+)= A (64×16, shared, K-major) · B (16×64, shared, K-major)
#define REPRO_WGMMA_SS_N64(TY)                                                \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                             \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31])                                              \
      : "l"(da), "l"(db), "r"(scale_d))

// D (64×64 f32) += A (64×16, registers) · B (16×64, shared, MN-major)
#define REPRO_WGMMA_RS_N64(TY)                                                \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                             \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31])                                              \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// D (64×128 f32) += A (64×16, registers) · B (16×128, shared, MN-major)
#define REPRO_WGMMA_RS_N128(TY)                                               \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                              \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                              \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                              \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                              \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                             \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),     \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),     \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),     \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),     \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),     \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),     \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// S (+)= Q·Kᵀ for one k-step of 16 head-dim columns
template <bool BF16>
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (BF16) {
    REPRO_WGMMA_SS_N64("bf16");
  } else {
    REPRO_WGMMA_SS_N64("f16");
  }
}

// O += P·V for one k-step of 16 kv rows over N output columns; a holds
// this thread's P fragment
template <bool BF16, int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t* a, uint64_t db) {
  if constexpr (N == 128) {
    if constexpr (BF16) {
      REPRO_WGMMA_RS_N128("bf16");
    } else {
      REPRO_WGMMA_RS_N128("f16");
    }
  } else {
    if constexpr (BF16) {
      REPRO_WGMMA_RS_N64("bf16");
    } else {
      REPRO_WGMMA_RS_N64("f16");
    }
  }
}

#undef REPRO_WGMMA_SS_N64
#undef REPRO_WGMMA_RS_N64
#undef REPRO_WGMMA_RS_N128

// Two floats rounded to the 16-bit type, the first in the low half.
template <bool BF16>
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  if constexpr (BF16) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&t);
  } else {
    const __half2 t = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&t);
  }
}

template <bool BF16>
__device__ __forceinline__ float2 unpack2(uint32_t x) {
  if constexpr (BF16) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  } else {
    return __half22float2(*reinterpret_cast<const __half2*>(&x));
  }
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ bool visible(int col, int row, int skv,
                                        int causal, int window) {
  return col < skv && (!causal || col <= row) &&
         (!window || col > row - window);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x by the SFU's ex2.approx (≤ 2 ulp; results below 2^-126 flush to 0,
// so a p that small drops out of the sums, ~1e-38 of the row max's 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// What a consumer thread needs to mask and scale its rows: its first
// row's absolute position (the second is + 8), its warpgroup's first,
// its first column in each 8-column chunk, and the kernel's arguments.
struct Rows {
  int pos0, wg_lo, cq, skv, causal, window;
  float scale;
};

// S = Q·Kᵀ of one kv tile into sc, issued and committed, not waited for.
// sc needs no initial value: the first k-step does not read it
// (scale-d = 0), and defining it here would serialise the wgmma.
template <bool BF16, int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t q_base,
                                         uint32_t k_base) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
    wgmma_qk<BF16>(sc, desc_k_major(q_base + off),
                   desc_k_major(k_base + off), kk > 0);
  }
  wgmma_commit();
}

// O += P_hi·V + P_lo·V of one kv tile over N columns, issued and
// committed.
template <bool BF16, int N>
__device__ __forceinline__ void issue_pv(float (&o)[N / 2],
                                         const uint32_t (&p_hi)[16],
                                         const uint32_t (&p_lo)[16],
                                         uint32_t v_base) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBlockKV / 16; ++kk) {
    const uint64_t dv = desc_mn_major(v_base + kk * 16 * 128);
    wgmma_pv<BF16, N>(o, p_hi + 4 * kk, dv);
    wgmma_pv<BF16, N>(o, p_lo + 4 * kk, dv);
  }
  wgmma_commit();
}

// The online softmax of one thread's two rows.
struct Softmax {
  float m0 = kNegInf, m1 = kNegInf;  // running row maxima
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums
  float corr0 = 1.f, corr1 = 1.f;    // rescale of O for the last step

  // One kv tile at column c0: mask S where the band cuts the
  // warpgroup's rows, update m and l, and split p = exp(s·scale − m) into
  // hi + lo parts of the 16-bit type (the P fragments of P·V). Tiles the
  // band does not cut take the path without masks.
  template <bool BF16>
  __device__ __forceinline__ void step(float (&sc)[32], uint32_t (&p_hi)[16],
                                       uint32_t (&p_lo)[16], int c0,
                                       const Rows& r) {
    const bool edge = c0 + kBlockKV > r.skv ||
                      (r.causal && c0 + kBlockKV - 1 > r.wg_lo) ||
                      (r.window && c0 <= r.wg_lo + 63 - r.window);
    if (edge)
      step_impl<BF16, true>(sc, p_hi, p_lo, c0, r);
    else
      step_impl<BF16, false>(sc, p_hi, p_lo, c0, r);
  }

  // The scale is applied after the product, as in the reference, but
  // inside the exponent: p = 2^(s·(scale·log2 e) − m·log2 e), and the row
  // max is taken over the unscaled s and scaled once (rounding is
  // monotone, so that is the max of the scaled scores).
  template <bool BF16, bool MASK>
  __device__ __forceinline__ void step_impl(float (&sc)[32],
                                            uint32_t (&p_hi)[16],
                                            uint32_t (&p_lo)[16], int c0,
                                            const Rows& r) {
    const int pos1 = r.pos0 + 8;
    uint32_t hidden = 0;  // bit 4j+e: entry sc[4j+e] is masked
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (MASK && !visible(c0 + 8 * j + r.cq + (e & 1),
                             e < 2 ? r.pos0 : pos1, r.skv, r.causal,
                             r.window)) {
          sc[4 * j + e] = kNegInf;
          hidden |= 1u << (4 * j + e);
        }
        if (e < 2)
          mx0 = fmaxf(mx0, sc[4 * j + e]);
        else
          mx1 = fmaxf(mx1, sc[4 * j + e]);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0) * r.scale);
    const float mn1 = fmaxf(m1, quad_max(mx1) * r.scale);
    corr0 = ex2((m0 - mn0) * kLog2e);
    corr1 = ex2((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    const float k2 = r.scale * kLog2e;
    const float mb0 = mn0 * kLog2e, mb1 = mn1 * kLog2e;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const float mb = e < 2 ? mb0 : mb1;
        float pa = ex2(fmaf(sc[4 * j + e], k2, -mb));
        float pb = ex2(fmaf(sc[4 * j + e + 1], k2, -mb));
        if (MASK) {  // masked p is 0, also in rows that see no key yet
          if (hidden & (1u << (4 * j + e))) pa = 0.f;
          if (hidden & (1u << (4 * j + e + 1))) pb = 0.f;
        }
        if (e < 2)
          sum0 += pa + pb;
        else
          sum1 += pa + pb;
        const uint32_t hi = pack2<BF16>(pa, pb);
        const float2 hf = unpack2<BF16>(hi);
        p_hi[2 * j + e / 2] = hi;
        p_lo[2 * j + e / 2] = pack2<BF16>(pa - hf.x, pb - hf.y);
      }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
  }
};

// O *= the correction of the softmax's last step, row by row.
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N / 2],
                                        const Softmax& sm) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    o[4 * j] *= sm.corr0;
    o[4 * j + 1] *= sm.corr0;
    o[4 * j + 2] *= sm.corr1;
    o[4 * j + 3] *= sm.corr1;
  }
}

// A consumer warpgroup's view of shared memory: its Q tile, slot 0 of
// the K and V rings (slot s at + s·stride), the ring's barriers (8 bytes
// a slot) and the band's first kv tile.
struct Ring {
  uint32_t q, k, v, stride, bar_k, bar_v, bar_e;
  int t_begin;
};

// A consumer warpgroup's walk over the band's kv tiles, in ping-pong with
// the other warpgroup: the two take turns on the tensor cores (named
// barriers 1 and 2: a warpgroup waits on its own for its turn and, once
// its wgmmas are issued, hands the turn over), so one's softmax runs
// beside the other's wgmmas. Turn k issues P·V of tile k−1 and S = Q·Kᵀ
// of tile k together; the softmax of tile k follows once both landed, and
// O is rescaled for tile k−1 just before its P·V. Registers hold one S
// tile, one P tile (hi and lo) and O.
template <bool BF16, int HD, int N = Split<HD>::kOut>
__device__ __forceinline__ void consume(float (&o)[N / 2], Softmax& sm,
                                        int wg, int n_tiles,
                                        const Ring& ring, const Rows& rows) {
  static_assert(kConsumerWGs == 2, "ping-pong takes two warpgroups");
  if (n_tiles <= 0) return;
  if (wg == 1) named_arrive(1);  // warpgroup 0 takes the first turn
  uint32_t p_hi[16], p_lo[16];
  {
    float sc[32];
    mbar_wait(ring.bar_k, 0);
    __syncwarp();
    named_sync(1 + wg);
    issue_qk<BF16, HD>(sc, ring.q, ring.k);
    named_arrive(2 - wg);
    wgmma_wait_all();
    fence_regs(sc);
    sm.step<BF16>(sc, p_hi, p_lo, ring.t_begin * kBlockKV, rows);
  }
  for (int k = 1; k < n_tiles; ++k) {
    const int s = (k - 1) % kStages, s1 = k % kStages;
    float sc[32];
    mbar_wait(ring.bar_k + 8 * s1, (k / kStages) & 1);
    mbar_wait(ring.bar_v + 8 * s, ((k - 1) / kStages) & 1);
    __syncwarp();
    rescale<N>(o, sm);
    named_sync(1 + wg);
    issue_pv<BF16, N>(o, p_hi, p_lo, ring.v + s * ring.stride);
    issue_qk<BF16, HD>(sc, ring.q, ring.k + s1 * ring.stride);
    named_arrive(2 - wg);
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(sc);
    mbar_arrive(ring.bar_e + 8 * s);  // K and V of slot s consumed
    sm.step<BF16>(sc, p_hi, p_lo, (ring.t_begin + k) * kBlockKV, rows);
  }
  const int s = (n_tiles - 1) % kStages;
  mbar_wait(ring.bar_v + 8 * s, ((n_tiles - 1) / kStages) & 1);
  __syncwarp();
  rescale<N>(o, sm);
  named_sync(1 + wg);
  issue_pv<BF16, N>(o, p_hi, p_lo, ring.v + s * ring.stride);
  if (wg == 0) named_arrive(2);  // warpgroup 1's last turn
  wgmma_wait_all();
  fence_regs(o);
}

// out = O / max(l, 1e-30), rounded once to the 16-bit type; out is
// written as pairs of 16-bit values, (b, sq, h, hd / 2), this
// warpgroup's N columns from column col0.
template <bool BF16, int HD, int N>
__device__ __forceinline__ void store(uint32_t* __restrict__ out,
                                      const float (&o)[N / 2],
                                      const Softmax& sm, int b, int sq,
                                      int h, int head, int r0, int cq,
                                      int col0) {
  // the fast reciprocal (≤ 2 f32 ulp): an IEEE division would call a
  // slow-path subroutine
  const float d0 = __fdividef(1.f, fmaxf(quad_sum(sm.l0), 1e-30f));
  const float d1 = __fdividef(1.f, fmaxf(quad_sum(sm.l1), 1e-30f));
  uint32_t* row0 =
      out + (((size_t)b * sq + r0) * h + head) * (HD / 2) + col0 / 2;
  uint32_t* row1 = row0 + (size_t)8 * h * (HD / 2);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int at = 4 * j + cq / 2;
    if (r0 < sq) row0[at] = pack2<BF16>(o[4 * j] * d0, o[4 * j + 1] * d0);
    if (r0 + 8 < sq)
      row1[at] = pack2<BF16>(o[4 * j + 2] * d1, o[4 * j + 3] * d1);
  }
}

// Thread t of a consumer warpgroup holds, of every 64-row accumulator,
// rows 16·(t/32) + (t%32)/4 and that + 8; of each 8-column chunk j,
// columns 8j + 2·(t%4) and + 1: d[4j], d[4j+1] on the first row,
// d[4j+2], d[4j+3] on the second. The P fragment of k-step kk (kv columns
// 16kk … 16kk+15) is then d[8kk … 8kk+7] packed in pairs, in order.
template <bool BF16, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   uint32_t* __restrict__ out, int sq, int skv, int h,
                   int kh, int n_bh, int nq, int causal, int window,
                   int q_offset, float scale) {
  using L = Layout<HD>;
  using W = Split<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_k = bar_q + 8;                 // + 8 · slot
  const uint32_t bar_v = bar_k + 8 * kStages;
  const uint32_t bar_e = bar_v + 8 * kStages;

  // the longest q tiles first: the q tile is the slowest grid index
  const int bh = blockIdx.x % n_bh;
  const int q0 = (nq - 1 - blockIdx.x / n_bh) * W::kBlockQ;
  const int head = bh % h, b = bh / h;
  const int kvh = head / (h / kh);

  // the kv tiles in the block's band (the Pallas band test, solved for
  // the first and last tile)
  const int row_lo = q0 + q_offset;
  int t_end = (skv + kBlockKV - 1) / kBlockKV;
  if (causal)
    t_end = min(t_end, floor_div(row_lo + W::kBlockQ - 1, kBlockKV) + 1);
  const int t_begin =
      window ? max(0, floor_div(row_lo - window - (kBlockKV - 1), kBlockKV) +
                          1)
             : 0;
  const int n_tiles = max(0, t_end - t_begin);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 128 * kConsumerWGs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumerWGs) {
    // ---- producer: one lane issues every copy ----
    if (lane == 0) {
      mbar_expect_tx(bar_q, W::kQTiles * L::kTileBytes);
      for (int w = 0; w < W::kQTiles; ++w)
        for (int p = 0; p < L::kPanels; ++p)
          tma_load_3d(base + L::kQ + w * L::kTileBytes + p * kPanelBytes,
                      &tm_q, head * HD + 64 * p, q0 + 64 * w, b, bar_q);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const int c0 = (t_begin + i) * kBlockKV;
        mbar_wait(bar_e + 8 * s, ((i / kStages) & 1) ^ 1);  // round 0: free
        mbar_expect_tx(bar_k + 8 * s, L::kTileBytes);
        for (int p = 0; p < L::kPanels; ++p)
          tma_load_3d(base + L::kK + s * L::kTileBytes + p * kPanelBytes,
                      &tm_k, kvh * HD + 64 * p, c0, b, bar_k + 8 * s);
        mbar_expect_tx(bar_v + 8 * s, L::kTileBytes);
        for (int p = 0; p < L::kPanels; ++p)
          tma_load_3d(base + L::kV + s * L::kTileBytes + p * kPanelBytes,
                      &tm_v, kvh * HD + 64 * p, c0, b, bar_v + 8 * s);
      }
    }
    return;
  }

  // ---- consumers ----
  const int wg = warp / 4;
  // the warpgroup's q tile (its own, or the shared one) and O columns
  const int qt = W::kCols ? 0 : wg;
  const int col0 = W::kCols ? wg * W::kOut : 0;
  const int r0 = q0 + 64 * qt + 16 * (warp % 4) + lane / 4;  // and r0 + 8
  const Rows rows{r0 + q_offset, q0 + 64 * qt + q_offset, 2 * (lane % 4),
                  skv, causal, window, scale};
  const Ring ring{base + L::kQ + qt * L::kTileBytes, base + L::kK,
                  base + L::kV + (col0 / 64) * kPanelBytes, L::kTileBytes,
                  bar_k, bar_v, bar_e, t_begin};
  float o[W::kOut / 2];
#pragma unroll
  for (int i = 0; i < W::kOut / 2; ++i) o[i] = 0.f;
  Softmax sm;
  mbar_wait(bar_q, 0);
  consume<BF16, HD>(o, sm, wg, n_tiles, ring, rows);
  store<BF16, HD, W::kOut>(out, o, sm, b, sq, h, head, r0, rows.cq, col0);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query, so the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (s, heads·hd) view per batch of a (b, s, heads, hd) tensor as a 3-D
// map (hd of all heads, s, b), read in boxes of 64 × 64 × 1 with the
// 128-byte swizzle; rows past s are zero-filled.
bool make_map(CUtensorMap* map, const void* ptr, bool bf16, int b, int s,
              int heads, int hd) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row = (cuuint64_t)heads * hd;
  const cuuint64_t dims[3] = {row, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[2] = {row * 2, row * 2 * s};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map,
                bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                3, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool BF16, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int h, int kh, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, BF16, b, sq, h, HD) ||
      !make_map(&tm_k, k, BF16, b, skv, kh, HD) ||
      !make_map(&tm_v, v, BF16, b, skv, kh, HD))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = Layout<HD>::kBytes;
  auto kernel = flash_wgmma_kernel<BF16, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (sq + Split<HD>::kBlockQ - 1) / Split<HD>::kBlockQ;
  const long long blocks = (long long)nq * h * b;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<uint32_t*>(out), sq, skv, h, kh, h * b,
      nq, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// q: (b, sq, h, hd), k/v: (b, skv, kh, hd), out: (b, sq, h, hd), all
// contiguous float32 on the device. hd is 64, 128 or 256, h a multiple of
// kh; scale multiplies q·k (1/√hd of the unpadded head dim). Launches on
// `stream`, does not synchronise, allocates nothing.
extern "C" int repro_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* out, int b,
                                         int sq, int skv, int h, int kh,
                                         int hd, int causal, int window,
                                         int q_offset, float scale,
                                         cudaStream_t stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || kh <= 0 || h % kh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 64)
    return launch_ffma<64>(q, k, v, out, b, sq, skv, h, kh, causal, window,
                           q_offset, scale, stream);
  if (hd == 128)
    return launch_ffma<128>(q, k, v, out, b, sq, skv, h, kh, causal, window,
                            q_offset, scale, stream);
  if (hd == 256)
    return launch_ffma<256>(q, k, v, out, b, sq, skv, h, kh, causal, window,
                            q_offset, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int HD>
int launch_wgmma(bool bf16, const void* q, const void* k, const void* v,
                 void* out, int b, int sq, int skv, int h, int kh,
                 int causal, int window, int q_offset, float scale,
                 cudaStream_t stream) {
  return bf16 ? tc::launch<true, HD>(q, k, v, out, b, sq, skv, h, kh, causal,
                                     window, q_offset, scale, stream)
              : tc::launch<false, HD>(q, k, v, out, b, sq, skv, h, kh,
                                      causal, window, q_offset, scale,
                                      stream);
}

// The same contract for 16-bit inputs: dtype 1 = bfloat16, 2 = float16;
// every pointer 16-byte aligned (TMA).
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k,
                                           const void* v, void* out,
                                           int dtype, int b, int sq, int skv,
                                           int h, int kh, int hd, int causal,
                                           int window, int q_offset,
                                           float scale, cudaStream_t stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || kh <= 0 || h % kh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
          16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const bool bf16 = dtype == 1;
  if (dtype != 1 && dtype != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 64)
    return launch_wgmma<64>(bf16, q, k, v, out, b, sq, skv, h, kh, causal,
                            window, q_offset, scale, stream);
  if (hd == 128)
    return launch_wgmma<128>(bf16, q, k, v, out, b, sq, skv, h, kh, causal,
                             window, q_offset, scale, stream);
  if (hd == 256)
    return launch_wgmma<256>(bf16, q, k, v, out, b, sq, skv, h, kh, causal,
                             window, q_offset, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
