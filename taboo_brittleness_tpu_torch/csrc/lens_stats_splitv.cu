// Fused logit-lens statistics for few rows on NVIDIA Hopper (sm_90a): the
// vocabulary streamed once as a split-V GEMV, rows of E as the wgmma's M.
//
// Replaces the TPU kernel of the JAX package, ops/pallas_lens.py
// `_lens_tile_kernel` launched by `lens_stats`, for the calls with few rows:
// bf16, f16 or f32 inputs, any top_k (above KMAX_WIDE in several passes, below)
// and N <= the route's row limit (the wrapper, ops/lens_kernel.py
// `lens_plan`, sends them here; the main path's N 1140 stays on
// lens_stats_wgmma.cu).  Those are the serving readouts: one
// row per slot (N 8), the speculative verify (N 32), the attack search and
// each tp shard.  For rows x [N, D] and the tied embedding E [V, D] each
// block owns a contiguous chunk of the vocabulary and writes one partial per
// (chunk, row), the same contract as the other two kernels:
//
//   logits = x @ E[chunk]^T            (bf16 or f16 wgmma, or 3xTF32; f32 sums)
//   logits = tanh(logits / cap) * cap   [CAP only]
//   part_max[s, n], part_sumexp[s, n]   max / sum exp(logit - max)
//   part_tgt[s, n]                      logit of targets[n] in the chunk, else -1e30
//   part_vals/ids[s, n, :K]             the chunk's top-K, lowest id first
//                                       among equal values
//
// and, unless the caller asks for the partials alone, the last block to
// finish (one atomic ticket) merges the S chunks into the call's logsumexp,
// target logit and top-K, as the torch epilogue `merge_partials` would: that
// epilogue's ~20 small launches took 15-16% of a call at N 8 on an H100.
//
// What bounds it: at N 8, D 3584, V 256000 a call is 14.7 GFLOP against 1.84
// GB of E read once: 15 us of tensor-core work and 0.55 ms at 3.35 TB/s.  It
// is a stream of E, and the design spends nothing that does not move it:
//
// - The operands are swapped.  A 128-row tile of E is the M dimension of two
//   wgmma.m64nNk16 (one per consumer warpgroup, A = E from shared memory,
//   K-major as stored), and the N rows of x, padded to a multiple of 8, are
//   the instruction's N (B = x, K-major).  wgmma rather than mma.sync: it
//   reads both operands from shared memory itself, so the consumers spend no
//   instructions or registers moving E into fragments, and its descriptors
//   are those the 128-byte TMA swizzle writes (as in lens_stats_wgmma.cu).
//   No product is spent past the pad to 8 rows.
// - E crosses HBM once with enough bytes in flight.  One grid of one block
//   per SM (the wrapper plans as many chunks as the card has SMs), each
//   walking a contiguous range of 32-row vocab tiles, balanced to within one
//   tile.  One producer thread keeps a ring of up to MAX_STAGES stages full
//   with TMA (cp.async.bulk.tensor, full / empty mbarrier pairs): a stage is
//   up to 128 rows x 64 deep of E (16 KB) and the N x 64 slice of x beside it,
//   so 96-128 KB of E can be in flight per SM (6-8 stages, fewer at larger
//   N), more than Little's law asks at ~1 us and 25 GB/s per SM.  x (at most 64 x 3584 bf16) does not fit in
//   shared memory whole; each stage streams its slice from L2.  A chunk's
//   last tile may be 32, 64 or 96 rows: only those boxes are loaded, and the
//   rows past them are masked before any statistic reads them.
// - The epilogue touches live values only.  After a tile's products the
//   consumers stage its [N, 128] logits in shared memory (double-buffered:
//   one named barrier per tile), and each consumer warp folds the rows it
//   owns (tokens w, w + 8, ...), one token across the 32 lanes: an online max
//   / sum-exp (warp-uniform max, per-lane sums), the target logit, and a
//   top-L list held one entry per lane (lanes 0 .. L-1).  A value enters
//   the list only when above its last entry; candidates are found by ballot
//   and inserted in ascending id, so ties keep the lowest id.  exp2 and the
//   cap's tanh come from the approximate-function unit, as in
//   lens_stats_wgmma.cu (within about 1e-5 at a cap of 30).
// - Two list lengths, L = KMAX (8) for top_k <= 8 and L = KMAX_WIDE (32, one
//   entry per lane of the warp) for 8 < top_k <= 32, each its own
//   instantiation: the list costs one register pair a lane either way, and
//   the longer list only moves the cut to lane 31, so more of a chunk's
//   first columns enter it before its cut settles.  The short list keeps
//   its cut higher and its insertions fewer for the common top_k <= 8.
// - f32 (3xTF32, tf32_split.cuh): the same stream of E at twice the bytes
//   (1.1 ms of the bound at N 8), three tf32 wgmma.m64nNk8 per 8-deep slice
//   (E hi . x hi + E lo . x hi + E hi . x lo).  x comes split from the
//   wrapper's scratch (a small kernel splits it once per call); each
//   consumer warpgroup splits its own 64 rows of E in shared memory when a
//   stage lands (hi in place, lo into one of two lo tiles), behind one
//   warpgroup barrier.  The tensor-core work is a few percent of the stream's
//   time, so the split costs the consumers' idle time, not the stream's.
// - f16 takes bf16's path whole (the same 2-byte elements, stages and
//   boxes), with the f16 form of each wgmma (m64nNk16.f32.f16.f16).
// - A top-k above KMAX_WIDE takes the long list in ceil(K / KMAX_WIDE)
//   passes (ops/lens_kernel.py `certify_top_k` has the argument): the first
//   is the K = KMAX_WIDE call; each later one (a refill) gets a ceiling per
//   (chunk, token), the last key that pair's list held, and lists the
//   KMAX_WIDE keys strictly below it.  The ceiling hides a token's columns
//   at or above it (-inf) after its statistics have read them; the list's
//   cut is its own last entry, with no stand-in taken from the tile, so
//   the list is the top of what the ceiling leaves.  A pair known complete
//   gets the empty key (-inf, INT_MAX).  A refill runs on a grid of one
//   block per SM of its own, whatever chunks are open: a plan kernel lists
//   the open chunks and their 32-row tiles, each block takes an even share
//   of those tiles (loading only their boxes, each at its place in its
//   128-row step), and the pieces of a chunk are merged by the block that
//   completes it (refill_work.cuh), so one open chunk is streamed by 60-61
//   SMs, not one.  Up to MERGE_MAX (128) the last block of each pass
//   also certifies: it merges the open pairs' lists into the call's top-K
//   (4 ranks a lane), takes t, its K-th key, and gives each pair whose list
//   ends above t that last key as its next ceiling (every other pair the
//   empty key), where the next pass reads it, so no pass waits on the host
//   or on a torch merge (0.113 ms at N 8 on an H100).  Above MERGE_MAX the
//   wrapper certifies in torch from the partials.
//
// The macro LENS_ANATOMY_SKIP_FOLD leaves out the staging and the fold; only
// perf/lens_anatomy.py sets it, to time the stream alone, and its partials
// are meaningless.
//
// Build units: the wrapper compiles this file six times, in parallel, and
// links the objects into one library, each unit holding 16 of the kernel's
// 96 instantiations: -DLENS_SPLITV_UNIT=1 the bf16 ones without the cap and
// the C interface, 2 bf16 with the cap, 3 f32 without, 4 f32 with, 5 f16
// without, 6 f16 with (tbx_splitv_bf16, tbx_splitv_bf16_cap, tbx_splitv_f32,
// tbx_splitv_f32_cap, tbx_splitv_f16, tbx_splitv_f16_cap).  Without the
// macro (perf/lens_anatomy.py) one unit holds all.
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes.  The launcher returns 0, a cudaError_t of the launch, or a negative
// code for a tensor map the driver refused (see tbx_splitv_error_string).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#ifndef LENS_SPLITV_UNIT
#define LENS_SPLITV_UNIT 0
#endif

namespace {

// Inside this file's anonymous namespace: each unit of the library keeps
// its own copy of the header's x split kernel.
#include "tf32_split.cuh"

// The input types, as the C interface's dtype code and the wrapper's bit
// mask name them (ops/lens_kernel.py DTYPE_BITS).
constexpr int DTYPE_BF16 = 1, DTYPE_F32 = 2, DTYPE_F16 = 4;
template <typename T>
constexpr int dtype_code = DTYPE_BF16;
template <>
constexpr int dtype_code<float> = DTYPE_F32;
template <>
constexpr int dtype_code<__half> = DTYPE_F16;

constexpr int TILE_ROWS = 32;     // vocab rows per plan tile: one TMA box of E
constexpr int BLOCK_ROWS = 128;   // vocab rows per wgmma tile: two warpgroups
constexpr int BK = 64;            // depth per stage: one 128-byte row of bf16 / f16
constexpr int MAX_NT = 8;         // 8-row groups of x the kernel holds
constexpr int MAX_ROWS = 8 * MAX_NT;
constexpr int KMAX = 8;           // the short top-k list
constexpr int KMAX_WIDE = 32;     // the long one
static_assert(KMAX < KMAX_WIDE && KMAX_WIDE <= 32, "one list entry per lane");
constexpr int MERGE_MAX = 128;    // the last block's certified top-K: 4 a lane
constexpr int MAX_STAGES = 8;
constexpr int CONSUMER_THREADS = 256;
constexpr int CONSUMER_WARPS = CONSUMER_THREADS / 32;
constexpr int THREADS = CONSUMER_THREADS + 32;  // + one producer warp
constexpr int BOX_BYTES = TILE_ROWS * BK * 2;   // 4 KB of E
constexpr int E_BYTES = BLOCK_ROWS * BK * 2;    // 16 KB of E per stage
constexpr int LOGIT_STRIDE = BLOCK_ROWS + 4;    // floats per staged token row
constexpr int SMEM_LIMIT = 232448;              // a block's most on sm_90
constexpr int FIXED_BYTES = 1024 + 2 * MAX_STAGES * 8;
constexpr int STATIC_BYTES = 16;                // the merge's flag, padded
constexpr float NEG_BIG = -1e30f;     // logit of an absent target
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL_MASK = 0xffffffffu;
// A barrier wait that outlasts this traps instead of hanging the card.
constexpr unsigned long long WAIT_LIMIT_NS = 10ull * 1000 * 1000 * 1000;

// Shared-memory layout for NT 8-row groups of x: the ring (1024-aligned
// stages of E then x), the full and empty barriers, then two staging buffers
// of [8 NT, LOGIT_STRIDE] floats.
__host__ __device__ constexpr int stage_bytes(int nt) {
  return E_BYTES + 8 * nt * BK * 2;
}
__host__ __device__ constexpr int staging_bytes(int nt) {
  return 2 * 8 * nt * LOGIT_STRIDE * 4;
}
__host__ __device__ constexpr int ring_stages(int nt) {
  return (SMEM_LIMIT - STATIC_BYTES - FIXED_BYTES - staging_bytes(nt)) /
                     stage_bytes(nt) <
                 MAX_STAGES
             ? (SMEM_LIMIT - STATIC_BYTES - FIXED_BYTES - staging_bytes(nt)) /
                   stage_bytes(nt)
             : MAX_STAGES;
}
__host__ __device__ constexpr int smem_bytes(int nt) {
  return FIXED_BYTES + ring_stages(nt) * stage_bytes(nt) + staging_bytes(nt);
}
static_assert(ring_stages(MAX_NT) >= 4, "the ring needs 4 stages at N 64");

// The f32 (3xTF32) instantiation.  A 128-byte row holds 32 f32, so a stage
// is 32 deep and its E tile holds the same 16 KB (128 rows); x comes split
// into hi and lo (the wrapper's [2, n, d] scratch, both planes in one TMA
// box).  Each consumer warpgroup splits its 64 rows of E as the stage lands
// (hi in place, lo into one of two lo tiles: one for the stage being
// multiplied, one for the stage in flight before it), so the ring keeps
// bf16's bytes of E in flight where the staging buffers leave room.
constexpr int F32_BK = 32;
constexpr int F32_LO_BYTES = 2 * E_BYTES;
__host__ __device__ constexpr int f32_stage_bytes(int nt) {
  return E_BYTES + 2 * 8 * nt * F32_BK * 4;
}
__host__ __device__ constexpr int f32_ring_stages(int nt) {
  return (SMEM_LIMIT - STATIC_BYTES - FIXED_BYTES - staging_bytes(nt) -
          F32_LO_BYTES) / f32_stage_bytes(nt) < MAX_STAGES
             ? (SMEM_LIMIT - STATIC_BYTES - FIXED_BYTES - staging_bytes(nt) -
                F32_LO_BYTES) / f32_stage_bytes(nt)
             : MAX_STAGES;
}
__host__ __device__ constexpr int f32_smem_bytes(int nt) {
  return FIXED_BYTES + f32_ring_stages(nt) * f32_stage_bytes(nt) +
         F32_LO_BYTES + staging_bytes(nt);
}
static_assert(f32_ring_stages(MAX_NT) >= 3, "the f32 ring at N 64");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of the given parity to complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = globaltimer_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (globaltimer_ns() - t0 > WAIT_LIMIT_NS) __trap();
  }
}

// The consumer warpgroups' own barrier (the producer warp takes no part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMER_THREADS) : "memory");
}

// One consumer warpgroup's own barrier.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
}

// --------------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A [2, rows, cols] box: both planes of the f32 split of x in one load.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// ------------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor of a K-major tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |          // leading offset (unused)
         (static_cast<uint64_t>(1024 >> 4) << 32) |  // stride offset
         (static_cast<uint64_t>(1) << 62);           // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of the accumulator above a wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 8 NT] += A[64 x 16] * B[8 NT x 16]^T, both K-major in shared memory
// (A = 64 rows of E, B = the rows of x), in bf16 or (F16) f16: one overload
// per accumulator of 4 NT floats, NT 1-8.  Each defines TILE(AB), its asm
// statement for operands of PTX type AB, and takes the type's form.
#define WGMMA_TYPED(TILE)  \
  if constexpr (F16) {     \
    TILE("f16");           \
  } else {                 \
    TILE("bf16");          \
  }

template <bool F16>
__device__ __forceinline__ void wgmma_tile(float (&d)[4], uint64_t da,
                                           uint64_t db) {
#define TILE(AB)                                                               \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"                              \
      "wgmma.mma_async.sync.aligned.m64n8k16.f32." AB "." AB " "               \
      "{%0, %1, %2, %3}, "                                                     \
      "%4, %5, p, 1, 1, 0, 0;\n}\n"                                            \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                         \
      : "l"(da), "l"(db), "r"(1))
  WGMMA_TYPED(TILE)
#undef TILE
}

template <bool F16>
__device__ __forceinline__ void wgmma_tile(float (&d)[8], uint64_t da,
                                           uint64_t db) {
#define TILE(AB)                                                               \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"                             \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." AB "." AB " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "                                     \
      "%8, %9, p, 1, 1, 0, 0;\n}\n"                                            \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
        "+f"(d[6]), "+f"(d[7])                                                 \
      : "l"(da), "l"(db), "r"(1))
  WGMMA_TYPED(TILE)
#undef TILE
}

template <bool F16>
__device__ __forceinline__ void wgmma_tile(float (&d)[12], uint64_t da,
                                           uint64_t db) {
#define TILE(AB)                                                               \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"                             \
      "wgmma.mma_async.sync.aligned.m64n24k16.f32." AB "." AB " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "                   \
      "%12, %13, p, 1, 1, 0, 0;\n}\n"                                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]) \
      : "l"(da), "l"(db), "r"(1))
  WGMMA_TYPED(TILE)
#undef TILE
}

template <bool F16>
__device__ __forceinline__ void wgmma_tile(float (&d)[16], uint64_t da,
                                           uint64_t db) {
#define TILE(AB)                                                               \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                             \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." AB "." AB " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15}, "                                                                 \
      "%16, %17, p, 1, 1, 0, 0;\n}\n"                                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])        \
      : "l"(da), "l"(db), "r"(1))
  WGMMA_TYPED(TILE)
#undef TILE
}

template <bool F16>
__device__ __forceinline__ void wgmma_tile(float (&d)[20], uint64_t da,
                                           uint64_t db) {
#define TILE(AB)                                                               \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"                             \
      "wgmma.mma_async.sync.aligned.m64n40k16.f32." AB "." AB " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19}, "                                             \
      "%20, %21, p, 1, 1, 0, 0;\n}\n"                                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])                     \
      : "l"(da), "l"(db), "r"(1))
  WGMMA_TYPED(TILE)
#undef TILE
}

template <bool F16>
__device__ __forceinline__ void wgmma_tile(float (&d)[24], uint64_t da,
                                           uint64_t db) {
#define TILE(AB)                                                               \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"                             \
      "wgmma.mma_async.sync.aligned.m64n48k16.f32." AB "." AB " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, "                         \
      "%24, %25, p, 1, 1, 0, 0;\n}\n"                                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23])                                  \
      : "l"(da), "l"(db), "r"(1))
  WGMMA_TYPED(TILE)
#undef TILE
}

template <bool F16>
__device__ __forceinline__ void wgmma_tile(float (&d)[28], uint64_t da,
                                           uint64_t db) {
#define TILE(AB)                                                               \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"                             \
      "wgmma.mma_async.sync.aligned.m64n56k16.f32." AB "." AB " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, "     \
      "%28, %29, p, 1, 1, 0, 0;\n}\n"                                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
        "+f"(d[26]), "+f"(d[27])                                               \
      : "l"(da), "l"(db), "r"(1))
  WGMMA_TYPED(TILE)
#undef TILE
}

template <bool F16>
__device__ __forceinline__ void wgmma_tile(float (&d)[32], uint64_t da,
                                           uint64_t db) {
#define TILE(AB)                                                               \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                             \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "      \
      "%28, %29, %30, %31}, "                                                  \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
        "+f"(d[31])                                                            \
      : "l"(da), "l"(db), "r"(1))
  WGMMA_TYPED(TILE)
#undef TILE
}

#undef WGMMA_TYPED

// d[64 x 8 NT] += A[64 x 8] * B[8 NT x 8]^T in TF32 (f32 operands whose low
// 13 mantissa bits are zero), both K-major in shared memory.
template <int NT>
__device__ __forceinline__ void wgmma_tile_tf32(float (&d)[4 * NT], uint64_t da,
                                                uint64_t db);

template <>
__device__ __forceinline__ void wgmma_tile_tf32<1>(float (&d)[4], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tile_tf32<2>(float (&d)[8], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tile_tf32<3>(float (&d)[12], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, %12, %13, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tile_tf32<4>(float (&d)[16], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tile_tf32<5>(float (&d)[20], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19"
      "}, %20, %21, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tile_tf32<6>(float (&d)[24], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tile_tf32<7>(float (&d)[28], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27"
      "}, %28, %29, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tile_tf32<8>(float (&d)[32], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// ------------------------------------------------------- epilogue helpers

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// cap * tanh(x / cap) as cap * (1 - 2 / (1 + 2^(x * k2))), k2 = 2 log2(e) /
// cap, as in lens_stats_wgmma.cu.
__device__ __forceinline__ float capped_tanh(float x, float k2, float cap) {
  return cap * (1.0f - 2.0f * fast_rcp(1.0f + fast_exp2(x * k2)));
}

// (a, ai) ahead of (b, bi) in the top-k order: value descending, then id
// ascending.
__device__ __forceinline__ bool ahead(float a, int ai, float b, int bi) {
  return a > b || (a == b && ai < bi);
}

// A top-k key as the wrapper builds it (ops/lens_kernel.py `_keys`): the
// value's order-preserving bits (-0 as +0) above, 0xFFFFFFFF - id below;
// int64 order is the top-k order.  The empty key (-inf, INT_MAX) is below
// every column's.
__device__ __forceinline__ void key_parts(long long key, float& v, int& id) {
  const int hi = static_cast<int>(key >> 32);
  v = __int_as_float(hi >= 0 ? hi : hi ^ 0x7FFFFFFF);
  id = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(key));
}

__device__ __forceinline__ long long make_key(float v, int id) {
  const int bits = __float_as_int(v == 0.0f ? 0.0f : v);
  const unsigned hi = static_cast<unsigned>(bits >= 0 ? bits : bits ^ 0x7FFFFFFF);
  return static_cast<long long>((static_cast<unsigned long long>(hi) << 32) |
                                (0xFFFFFFFFu - static_cast<unsigned>(id)));
}

// Whether a ceiling leaves the pair anything to list.
__device__ __forceinline__ bool open_key(long long key) {
  float v;
  int id;
  key_parts(key, v, id);
  return v != -INFINITY;
}

#include "refill_work.cuh"

// ------------------------------------------------------------------ kernel

// Where a launch writes: the partials, and the merged statistics of the last
// block (lse == nullptr: the partials alone).
struct Outputs {
  float* part_max;     // [S, n]
  float* part_sumexp;  // [S, n]
  float* part_tgt;     // [S, n]
  float* part_vals;    // [S, n, k_top]
  int* part_ids;       // [S, n, k_top]
  float* lse;          // [n]
  float* tgt;          // [n]
  float* vals;         // [n, k_top]
  int* ids;            // [n, k_top]
  int* ticket;         // one int, 0 at launch
};

// The last block to finish merges every chunk's partials of its tokens, as
// ops/lens_kernel.py merge_partials does: logsumexp from the chunks' (max,
// sum-exp), the target logit, and the top-k of the S * k_top candidates
// (held one entry per lane, inserted in the top-k order whatever the order
// they arrive in).  Warp w merges tokens w, w + 8, ...  Each chunk's list is
// in the top-k order, so with the long list (L = KMAX_WIDE) a rank at which
// no chunk of the 32 read together goes above the merged list's last entry
// ends that group's reads: the loads of the later ranks, one round trip to
// L2 each, were most of the merge at K 32.
template <int NT, int L>
__device__ __forceinline__ void merge_chunks(const Outputs& out, int n,
                                             int k_top, int n_chunks,
                                             int warp, int lane) {
#pragma unroll
  for (int r = 0; r < NT; ++r) {
    const int tok = warp + 8 * r;
    if (tok >= n) break;
    float m = -INFINITY;
    for (int s = lane; s < n_chunks; s += 32)
      m = fmaxf(m, __ldcg(out.part_max + (size_t)s * n + tok));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, off));
    float sum = 0.0f, tv = NEG_BIG;
    for (int s = lane; s < n_chunks; s += 32) {
      const size_t at = (size_t)s * n + tok;
      sum += __ldcg(out.part_sumexp + at) * expf(__ldcg(out.part_max + at) - m);
      tv = fmaxf(tv, __ldcg(out.part_tgt + at));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(FULL_MASK, sum, off);
      tv = fmaxf(tv, __shfl_xor_sync(FULL_MASK, tv, off));
    }
    float lv = -INFINITY;  // lane p < k_top holds entry p of the list
    int li = INT_MAX;
    for (int base = 0; base < n_chunks; base += 32) {
      const int s = base + lane;
      for (int kk = 0; kk < k_top; ++kk) {
        const size_t at = ((size_t)s * n + tok) * k_top + kk;
        const float cv = s < n_chunks ? __ldcg(out.part_vals + at) : -INFINITY;
        const int ci = s < n_chunks ? __ldcg(out.part_ids + at) : INT_MAX;
        float cut = __shfl_sync(FULL_MASK, lv, k_top - 1);
        int cut_i = __shfl_sync(FULL_MASK, li, k_top - 1);
        unsigned todo = __ballot_sync(FULL_MASK, ahead(cv, ci, cut, cut_i));
        if (L == KMAX_WIDE && todo == 0) break;
        while (todo) {
          const int from = __ffs(todo) - 1;
          const float y = __shfl_sync(FULL_MASK, cv, from);
          const int yi = __shfl_sync(FULL_MASK, ci, from);
          const int pos = __popc(
              __ballot_sync(FULL_MASK, lane < k_top && ahead(lv, li, y, yi)));
          const float up_v = __shfl_up_sync(FULL_MASK, lv, 1);
          const int up_i = __shfl_up_sync(FULL_MASK, li, 1);
          if (lane > pos) {
            lv = up_v;
            li = up_i;
          }
          if (lane == pos) {
            lv = y;
            li = yi;
          }
          cut = __shfl_sync(FULL_MASK, lv, k_top - 1);
          cut_i = __shfl_sync(FULL_MASK, li, k_top - 1);
          todo &= __ballot_sync(FULL_MASK, ahead(cv, ci, cut, cut_i)) &
                  ~((2u << from) - 1u);
        }
      }
    }
    if (lane == 0) {
      out.lse[tok] = m + logf(sum);
      out.tgt[tok] = tv;
    }
    if (lane < k_top) {
      out.vals[tok * k_top + lane] = lv;
      out.ids[tok * k_top + lane] = li;
    }
  }
}

// The entry at rank 32 j + lane_of of a list held R ranks a lane (rank
// 32 j + lane in register j), on every lane.
template <int R>
__device__ __forceinline__ void rank_entry(const float (&lv)[R],
                                           const int (&li)[R], int j,
                                           int lane_of, float& v, int& id) {
  float sv = lv[0];
  int si = li[0];
#pragma unroll
  for (int q = 1; q < R; ++q) {
    if (j == q) {
      sv = lv[q];
      si = li[q];
    }
  }
  v = __shfl_sync(FULL_MASK, sv, lane_of);
  id = __shfl_sync(FULL_MASK, si, lane_of);
}

// Insert (y, yi), ahead of the list's rank k - 1 entry, into the first k
// ranks of a list held R ranks a lane: the ranks at and after its place
// move down one, the lane-31 entry of register j - 1 into lane 0 of j.
template <int R>
__device__ __forceinline__ void rank_insert(float (&lv)[R], int (&li)[R],
                                            float y, int yi, int k,
                                            int lane) {
  int pos = 0;
#pragma unroll
  for (int j = 0; j < R; ++j)
    pos += __popc(__ballot_sync(
        FULL_MASK, 32 * j + lane < k && ahead(lv[j], li[j], y, yi)));
  float up_v[R];
  int up_i[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    up_v[j] = __shfl_up_sync(FULL_MASK, lv[j], 1);
    up_i[j] = __shfl_up_sync(FULL_MASK, li[j], 1);
    const float wrap_v =
        __shfl_sync(FULL_MASK, j > 0 ? lv[j > 0 ? j - 1 : 0] : -INFINITY, 31);
    const int wrap_i =
        __shfl_sync(FULL_MASK, j > 0 ? li[j > 0 ? j - 1 : 0] : INT_MAX, 31);
    if (lane == 0) {
      up_v[j] = wrap_v;
      up_i[j] = wrap_i;
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int rank = 32 * j + lane;
    if (rank > pos) {
      lv[j] = up_v[j];
      li[j] = up_i[j];
    }
    if (rank == pos) {
      lv[j] = y;
      li[j] = yi;
    }
  }
}

// The last block's merge of a pass of a top-K above the long list
// (KMAX_WIDE < k_merge <= MERGE_MAX) and its certificate.  The first pass
// (ceiling null) writes lse and the target as merge_chunks does and starts
// the top-K from its chunks' lists; a refill merges the lists of the pairs
// its ceilings left open into the top-K the earlier passes wrote to out.vals
// and out.ids.  Then t, the top-K's last key: a pair that listed a key above
// t may hold more of the top-K below its list's last key, which becomes its
// ceiling; every other pair is complete (every key it did not list lies
// below its list's last key, hence below t) and gets the empty key.  Each
// pair's ceiling is read and written by one lane, so next may be ceiling.
// The next pass's work list (refill_work.cuh) is written here too, from
// the ceilings just made: the chunks an open pair keeps and their tiles.
// `stage`: 64 KB of the block's shared memory, which no stage holds by now.
template <int NT>
__device__ __forceinline__ void merge_certify(const Outputs& out,
                                              const long long* ceiling,
                                              long long* next, int n,
                                              int k_merge, int n_chunks,
                                              int* work, int vocab_tiles,
                                              float* stage, int warp,
                                              int lane) {
  constexpr int R = MERGE_MAX / 32;
  const bool refill = ceiling != nullptr;
  const int last_j = (k_merge - 1) / 32, last_lane = (k_merge - 1) % 32;
  int* const next_open = work + 3 + 2 * n_chunks;  // the next pass's chunks
  for (int s = threadIdx.x; s < n_chunks; s += CONSUMER_THREADS)
    next_open[s] = 0;
  consumers_sync();
#pragma unroll 1
  for (int r = 0; r < NT; ++r) {
    const int tok = warp + 8 * r;
    if (tok >= n) break;
    if (!refill) {
      float m = -INFINITY;
      for (int s = lane; s < n_chunks; s += 32)
        m = fmaxf(m, __ldcg(out.part_max + (size_t)s * n + tok));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, off));
      float sum = 0.0f, tv = NEG_BIG;
      for (int s = lane; s < n_chunks; s += 32) {
        const size_t at = (size_t)s * n + tok;
        sum += __ldcg(out.part_sumexp + at) * expf(__ldcg(out.part_max + at) - m);
        tv = fmaxf(tv, __ldcg(out.part_tgt + at));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(FULL_MASK, sum, off);
        tv = fmaxf(tv, __shfl_xor_sync(FULL_MASK, tv, off));
      }
      if (lane == 0) {
        out.lse[tok] = m + logf(sum);
        out.tgt[tok] = tv;
      }
    }
    float lv[R];
    int li[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int rank = 32 * j + lane;
      const bool held = refill && rank < k_merge;
      const size_t at = (size_t)tok * k_merge + rank;
      lv[j] = held ? __ldcg(out.vals + at) : -INFINITY;
      li[j] = held ? __ldcg(out.ids + at) : INT_MAX;
    }
    // Offers the top-K the 32 lanes' entries (cv, ci), in lane order; a
    // false return: none of them went above its last entry.
    auto offer = [&](float cv, int ci) -> bool {
      float cut;
      int cut_i;
      rank_entry(lv, li, last_j, last_lane, cut, cut_i);
      unsigned todo = __ballot_sync(FULL_MASK, ahead(cv, ci, cut, cut_i));
      const bool any = todo != 0;
      while (todo) {
        const int from = __ffs(todo) - 1;
        rank_insert(lv, li, __shfl_sync(FULL_MASK, cv, from),
                    __shfl_sync(FULL_MASK, ci, from), k_merge, lane);
        rank_entry(lv, li, last_j, last_lane, cut, cut_i);
        todo &= __ballot_sync(FULL_MASK, ahead(cv, ci, cut, cut_i)) &
                ~((2u << from) - 1u);
      }
      return any;
    };
    // The first pass offers every chunk's first entry first: the top-K
    // then starts from the largest candidates, and few of the later ones
    // go in only to be pushed out (chunk after chunk, a chunk's low ranks
    // went in before the next chunks' firsts pushed them out).
    int first_rank = 0;
    if (!refill) {
      for (int s0 = 0; s0 < n_chunks; s0 += 32) {
        const int s = s0 + lane;
        const size_t at = ((size_t)s * n + tok) * KMAX_WIDE;
        offer(s < n_chunks ? __ldcg(out.part_vals + at) : -INFINITY,
              s < n_chunks ? __ldcg(out.part_ids + at) : INT_MAX);
      }
      first_rank = 1;
    }
    // Then chunk group by chunk group (32 chunks, a lane each; a refill's
    // open pairs alone), the lists staged in this warp's 8 KB of the
    // block's shared memory, free by now ([rank][chunk]: one round trip to
    // L2 a group, not one a rank), and offered rank by rank: each list is
    // in the top-k order, so a rank at which no chunk goes above the
    // top-K's last entry ends the group.
    float* const group_v = stage + warp * 2 * 32 * KMAX_WIDE;
    int* const group_i = reinterpret_cast<int*>(group_v + 32 * KMAX_WIDE);
    for (int s0 = 0; s0 < n_chunks; s0 += 32) {
      const int s = s0 + lane;
      const size_t pair = (size_t)s * n + tok;
      const bool open =
          s < n_chunks && (!refill || open_key(__ldcg(ceiling + pair)));
      if (!__any_sync(FULL_MASK, open)) continue;
      __syncwarp();  // the last group's reads are done
      if (open) {
#pragma unroll
        for (int j = 0; j < KMAX_WIDE / 4; ++j) {
          const float4 v4 = __ldcg(
              reinterpret_cast<const float4*>(out.part_vals + pair * KMAX_WIDE) +
              j);
          const int4 i4 = __ldcg(
              reinterpret_cast<const int4*>(out.part_ids + pair * KMAX_WIDE) +
              j);
          const int at = 4 * j * 32 + lane;
          group_v[at] = v4.x, group_v[at + 32] = v4.y;
          group_v[at + 64] = v4.z, group_v[at + 96] = v4.w;
          group_i[at] = i4.x, group_i[at + 32] = i4.y;
          group_i[at + 64] = i4.z, group_i[at + 96] = i4.w;
        }
      }
      __syncwarp();
      for (int kk = first_rank; kk < KMAX_WIDE; ++kk) {
        if (!offer(open ? group_v[kk * 32 + lane] : -INFINITY,
                   open ? group_i[kk * 32 + lane] : INT_MAX))
          break;
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int rank = 32 * j + lane;
      if (rank < k_merge) {
        out.vals[(size_t)tok * k_merge + rank] = lv[j];
        out.ids[(size_t)tok * k_merge + rank] = li[j];
      }
    }
    float t;
    int ti;
    rank_entry(lv, li, last_j, last_lane, t, ti);
    for (int s = lane; s < n_chunks; s += 32) {
      const size_t pair = (size_t)s * n + tok;
      long long key = make_key(-INFINITY, INT_MAX);
      if (!refill || open_key(__ldcg(ceiling + pair))) {
        const size_t at = pair * KMAX_WIDE + KMAX_WIDE - 1;
        const float v = __ldcg(out.part_vals + at);
        const int id = __ldcg(out.part_ids + at);
        if (ahead(v, id, t, ti)) key = make_key(v, id);
      }
      next[pair] = key;
      if (open_key(key)) next_open[s] = 1;
    }
  }
  consumers_sync();
  if (warp == 0) {
    const refill::Geometry g{n, 1, MAX_ROWS, n_chunks, vocab_tiles};
    refill::compact_units(g, work, lane);
  }
}

// Grid: n_chunks blocks.  Chunk s covers the 32-row vocab tiles
// [s * T / S, (s + 1) * T / S) of T = ceil(v / TILE_ROWS).  Each token's
// running top-k list has L entries, one per lane of lanes 0 .. L-1.  T is
// the input type: __nv_bfloat16, __half, or float (3xTF32; map_x then
// covers the wrapper's [2, n, d] split of x).  The long list only: ceiling, [n_chunks,
// n] keys or null, makes the pass a refill on a grid of its own, its work
// dealt out by the list in `scratch` (refill_work.cuh), and k_merge >
// KMAX_WIDE the last block's merge a certified one that writes the next
// pass's ceilings to next_ceiling (see the file header).
template <typename T, int NT, bool CAP, int L>
__global__ void __launch_bounds__(THREADS, 1)
    lens_splitv_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_e,
                       const int* __restrict__ targets, const Outputs out,
                       int n, int d, int v, int k_top, int n_chunks,
                       float cap, const long long* ceiling,
                       long long* next_ceiling, int k_merge,
                       const refill::Scratch scratch) {
  constexpr bool F32 = tf32::is_f32<T>;
  constexpr bool F16 = dtype_code<T> == DTYPE_F16;
  constexpr int NPAD = 8 * NT;
  constexpr int kBK = F32 ? F32_BK : BK;
  constexpr int X_BYTES = (F32 ? 2 : 1) * NPAD * 128;  // f32: x hi, x lo
  constexpr int STAGE_BYTES = F32 ? f32_stage_bytes(NT) : stage_bytes(NT);
  constexpr int STAGES = F32 ? f32_ring_stages(NT) : ring_stages(NT);
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the ring to it.
  // f32: the two lo tiles of E follow the ring.
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t ring = (base + 1023) & ~1023u;
  const uint32_t lo_tiles = ring + STAGES * STAGE_BYTES;
  const uint32_t full = lo_tiles + (F32 ? F32_LO_BYTES : 0);  // + 8 * stage
  const uint32_t empty = full + MAX_STAGES * 8;       // + 8 * stage
  float* const staged =
      reinterpret_cast<float*>(smem_raw + (empty + MAX_STAGES * 8 - base));

  const int vocab_tiles = (v + TILE_ROWS - 1) / TILE_ROWS;
  const int k_steps = (d + kBK - 1) / kBK;
  // A refill of the long list walks the spans the work list deals this
  // block (units are chunks, items 32-row tiles); every other launch the
  // block's own chunk, whole.
  const bool spread = L == KMAX_WIDE && ceiling != nullptr;
  const refill::Work work{scratch.work, n_chunks};
  // A refill with nothing open has nothing to list, and its certifying
  // block nothing to change.
  if (spread && work.items() == 0) return;
  refill::Spans spans{work, 0, 1};
  if (spread) spans = refill::Spans::of_block(work, blockIdx.x, gridDim.x);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The rows [row_begin, row_end) of a span's chunk and its tiles [tile_lo,
  // tile_hi) of it.  A block walks a chunk in 128-row steps from row_begin
  // and loads a step's boxes [box_lo, box_hi) that are its tiles, each at
  // its place in the step as on the first pass (steps()).
  refill::Span span{-1, 0, 0, 0, 0};
  int chunk = 0, row_begin = 0, row_end = 0, tile_lo = 0, tile_hi = 0;
  auto next_span = [&]() -> bool {
    if (spread) {
      if (!spans.next(span)) return false;
      chunk = span.unit;
    } else {
      if (spans.item++ > 0) return false;
      chunk = blockIdx.x;
    }
    row_begin = (int)((long long)chunk * vocab_tiles / n_chunks) * TILE_ROWS;
    row_end = min(
        v, (int)((long long)(chunk + 1) * vocab_tiles / n_chunks) * TILE_ROWS);
    tile_lo = spread ? span.first : 0;
    tile_hi = spread ? span.upto : (row_end - row_begin + TILE_ROWS - 1) /
                                       TILE_ROWS;
    return true;
  };
  constexpr int STEP_BOXES = BLOCK_ROWS / TILE_ROWS;
  // The step of tile t of the span and its boxes [box_lo, box_hi).
  auto step_of = [&](int t, int& row0, int& box_lo, int& box_hi) {
    const int step = t / STEP_BOXES;
    row0 = row_begin + step * BLOCK_ROWS;
    box_lo = t - step * STEP_BOXES;
    box_hi = min(STEP_BOXES, tile_hi - step * STEP_BOXES);
  };

  if (threadIdx.x >= CONSUMER_THREADS) {
    // ---- producer warp: one lane keeps the ring full.
    if (threadIdx.x == CONSUMER_THREADS) {
      int stage = 0;
      uint32_t phase = 0;
      while (next_span()) {
        for (int t = tile_lo; t < tile_hi;) {
          int row0, box_lo, box_hi;
          step_of(t, row0, box_lo, box_hi);
          t += box_hi - box_lo;
          for (int ks = 0; ks < k_steps; ++ks) {
            mbar_wait(empty + 8 * stage, phase ^ 1);
            const uint32_t s = ring + stage * STAGE_BYTES;
            mbar_expect_tx(full + 8 * stage,
                           (box_hi - box_lo) * BOX_BYTES + X_BYTES);
            for (int b = box_lo; b < box_hi; ++b) {
              tma_load_2d(s + b * BOX_BYTES, &map_e, full + 8 * stage,
                          ks * kBK, row0 + b * TILE_ROWS);
            }
            if constexpr (F32) {
              tma_load_3d(s + E_BYTES, &map_x, full + 8 * stage, ks * kBK, 0,
                          0);
            } else {
              tma_load_2d(s + E_BYTES, &map_x, full + 8 * stage, ks * BK, 0);
            }
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg multiplies rows wg*64 .. wg*64+63 of each
  // tile; warp w folds tokens w, w + 8, ... of it.
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q = lane % 4;

  int tgt[NT];
  float run_max[NT], run_sum[NT], run_tgt[NT], top_v[NT];
  int top_i[NT];
  float ceil_v[NT];  // a refill's ceiling per token (long list only)
  int ceil_i[NT];
  float acc[4 * NT];
  int stage = 0;
  uint32_t phase = 0;
  int buf = 0;
  int lo_buf = 0;  // f32: the lo tile of E this stage's split writes
  while (next_span()) {
#pragma unroll
  for (int r = 0; r < NT; ++r) {
    const int tok = warp + 8 * r;
    const int t = tok < n ? targets[tok] : -1;
    tgt[r] = (t >= row_begin && t < row_end) ? t : -1;
    run_max[r] = -INFINITY;
    run_sum[r] = 0.0f;
    run_tgt[r] = NEG_BIG;
    top_v[r] = -INFINITY;  // lane p < L holds entry p of the list
    top_i[r] = INT_MAX;
    if constexpr (L == KMAX_WIDE) {
      ceil_v[r] = -INFINITY;
      ceil_i[r] = INT_MAX;
      if (ceiling != nullptr && tok < n)
        key_parts(ceiling[(size_t)chunk * n + tok], ceil_v[r], ceil_i[r]);
    }
  }

  for (int t = tile_lo; t < tile_hi;) {
    int row0, box_lo, box_hi;
    step_of(t, row0, box_lo, box_hi);
    t += box_hi - box_lo;
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) acc[i] = 0.0f;
    int prev = 0;
    for (int ks = 0; ks < k_steps; ++ks) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t s = ring + stage * STAGE_BYTES;
      const uint32_t a = s + wg * 64 * 128;  // this warpgroup's 64 rows of E
      const uint32_t b = s + E_BYTES;        // the slice of x
      if constexpr (F32) {
        // Split this warpgroup's 64 rows of E (8 KB): hi in place, lo into
        // the lo tile the stage before last used (its products are done).
        const uint32_t a_lo = lo_tiles + lo_buf * E_BYTES + wg * 64 * 128;
#pragma unroll
        for (int i = threadIdx.x % 128; i < 64 * 128 / 16; i += 128) {
          tf32::split_shared16(a + 16 * i, a_lo + 16 * i);
        }
        tf32::fence_proxy_async();
        warpgroup_sync(wg);
        lo_buf ^= 1;
        wgmma_fence();
        // 3xTF32: E hi . x hi + E lo . x hi + E hi . x lo.
        const uint32_t b_lo = b + NPAD * 128;
#pragma unroll
        for (int kk = 0; kk < F32_BK / 8; ++kk) {
          wgmma_tile_tf32<NT>(acc, smem_desc(a + kk * 32),
                              smem_desc(b + kk * 32));
          wgmma_tile_tf32<NT>(acc, smem_desc(a_lo + kk * 32),
                              smem_desc(b + kk * 32));
          wgmma_tile_tf32<NT>(acc, smem_desc(a + kk * 32),
                              smem_desc(b_lo + kk * 32));
        }
      } else {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wgmma_tile<F16>(acc, smem_desc(a + kk * 32), smem_desc(b + kk * 32));
        }
      }
      wgmma_commit();
      if (ks > 0) {
        // The previous stage's products are done: hand its buffer back.
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * prev);
    fence_acc(acc);

#ifndef LENS_ANATOMY_SKIP_FOLD
    // ---- stage the tile: acc[4j + 2i + c] is vocab row
    // 64 wg + 16 (warp % 4) + lane / 4 + 8 i of the tile, token 8 j + 2 q + c.
    float* const tile = staged + buf * NPAD * LOGIT_STRIDE;
    const int row = 64 * wg + 16 * (warp % 4) + lane / 4;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          tile[(8 * j + 2 * q + c) * LOGIT_STRIDE + row + 8 * i] =
              acc[4 * j + 2 * i + c];
    consumers_sync();

    // ---- fold: lane l reads columns l, l + 32, l + 64, l + 96 of a token,
    // so visiting u, then lanes in order, visits ascending ids.
    // The rows of this span's boxes, below the chunk's end.
    const int valid_lo = box_lo * TILE_ROWS;
    const int valid_hi = min(box_hi * TILE_ROWS, row_end - row0);
#pragma unroll
    for (int r = 0; r < NT; ++r) {
      const float* src = tile + (warp + 8 * r) * LOGIT_STRIDE;
      float x[4];
      float tile_max = -INFINITY;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int col = lane + 32 * u;
        float y = src[col];
        if (CAP) y = capped_tanh(y, 2.0f * LOG2E / cap, cap);
        x[u] = col >= valid_lo && col < valid_hi ? y : -INFINITY;
        tile_max = fmaxf(tile_max, x[u]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(FULL_MASK, tile_max, off));
      const float m = fmaxf(run_max[r], tile_max);
      const float m2 = m * LOG2E;
      float sum = 0.0f;
      const int rel = tgt[r] - row0 - lane;  // 32 u of the target, if this lane's
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sum += fast_exp2(fmaf(x[u], LOG2E, -m2));
        run_tgt[r] = rel == 32 * u ? x[u] : run_tgt[r];
      }
      run_sum[r] = run_sum[r] * fast_exp2((run_max[r] - m) * LOG2E) + sum;
      run_max[r] = m;

      if constexpr (L == KMAX_WIDE) {
        if (ceiling != nullptr) {
          // A refill: the columns at or above the token's ceiling leave the
          // list's view; the statistics above have read them.
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int id = row0 + 32 * u + lane;
            const bool below = x[u] < ceil_v[r] ||
                               (x[u] == ceil_v[r] && id > ceil_i[r]);
            x[u] = below ? x[u] : -INFINITY;
          }
        }
      }
      // Only a value above the list's last entry can enter it: every entry
      // has a lower id than this tile's columns.
      float cut = __shfl_sync(FULL_MASK, top_v[r], L - 1);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        unsigned todo = __ballot_sync(FULL_MASK, x[u] > cut);
        while (todo) {
          const int from = __ffs(todo) - 1;
          const float y = __shfl_sync(FULL_MASK, x[u], from);
          const int id = row0 + 32 * u + from;
          // Entries at or above y keep their places (lower ids among ties).
          const int pos = __popc(
              __ballot_sync(FULL_MASK, lane < L && top_v[r] >= y));
          const float up_v = __shfl_up_sync(FULL_MASK, top_v[r], 1);
          const int up_i = __shfl_up_sync(FULL_MASK, top_i[r], 1);
          if (lane > pos) {
            top_v[r] = up_v;
            top_i[r] = up_i;
          }
          if (lane == pos) {
            top_v[r] = y;
            top_i[r] = id;
          }
          cut = __shfl_sync(FULL_MASK, top_v[r], L - 1);
          todo &= __ballot_sync(FULL_MASK, x[u] > cut) & ~((2u << from) - 1u);
        }
      }
    }
    buf ^= 1;
#else
    // Measurement build (perf/lens_anatomy.py): the stream alone.
    run_max[0] = fmaxf(run_max[0], acc[0] + acc[4 * NT - 1]);
#endif  // LENS_ANATOMY_SKIP_FOLD
  }

  if constexpr (L == KMAX_WIDE) {
   if (spread && !span.whole()) {
    // ---- a piece of the chunk: its lists into slot m + b; the block whose
    // steps complete the chunk merges the pieces into the chunk's lists.
    const size_t slot = (size_t)(span.m + blockIdx.x);
#pragma unroll
    for (int r = 0; r < NT; ++r) {
      const int tok = warp + 8 * r;
      if (tok < n) {
        const size_t at = (slot * n + tok) * KMAX_WIDE + lane;
        scratch.piece_vals[at] = top_v[r];
        scratch.piece_ids[at] = top_i[r];
      }
    }
    __shared__ int merges;
    __threadfence();
    consumers_sync();
    if (threadIdx.x == 0) {
      const int done = span.upto - span.first;
      merges = atomicAdd(scratch.tickets + chunk, done) + done == span.items;
    }
    consumers_sync();
    if (merges) {
      __threadfence();
      const int items = work.items();
      const int s0 = work.start(span.m);
      const int b0 = refill::block_of(s0, items, gridDim.x);
      const int b1 = refill::block_of(s0 + span.items - 1, items, gridDim.x);
      for (int tok = warp; tok < n; tok += CONSUMER_WARPS) {
        const size_t first = ((size_t)(span.m + b0) * n + tok) * KMAX_WIDE;
        const size_t at = ((size_t)chunk * n + tok) * KMAX_WIDE;
        refill::merge_pieces(scratch.piece_vals + first,
                             scratch.piece_ids + first,
                             (size_t)n * KMAX_WIDE, b0, b1 - b0 + 1, items,
                             gridDim.x, out.part_vals + at, out.part_ids + at,
                             lane);
      }
    }
    continue;
   }
  }

  // ---- reduce each token's lanes and write the chunk's partials.
#pragma unroll
  for (int r = 0; r < NT; ++r) {
    const int tok = warp + 8 * r;
    float s = run_sum[r];
    float tv = run_tgt[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(FULL_MASK, s, off);
      tv = fmaxf(tv, __shfl_xor_sync(FULL_MASK, tv, off));
    }
    if (tok < n) {
      const size_t at = (size_t)chunk * n + tok;
      if (lane == 0) {
        out.part_max[at] = run_max[r];
        out.part_sumexp[at] = s;
        out.part_tgt[at] = tv;
      }
      if (lane < k_top) {
        out.part_vals[at * k_top + lane] = top_v[r];
        out.part_ids[at * k_top + lane] = top_i[r];
      }
    }
  }
  }  // spans
  if (out.lse == nullptr) return;

  // ---- the last block to finish merges the chunks (one ticket).
  __shared__ int last;
  __threadfence();
  consumers_sync();
  if (threadIdx.x == 0)
    last = atomicAdd(out.ticket, 1) ==
           (L == KMAX_WIDE ? (int)gridDim.x : n_chunks) - 1;
  consumers_sync();
  if (!last) return;
  __threadfence();
  if constexpr (L == KMAX_WIDE) {
    if (k_merge > KMAX_WIDE) {
      merge_certify<NT>(out, ceiling, next_ceiling, n, k_merge, n_chunks,
                        scratch.work, vocab_tiles,
                        reinterpret_cast<float*>(smem_raw + (ring - base)),
                        warp, lane);
      return;
    }
  }
  merge_chunks<NT, L>(out, n, k_top, n_chunks, warp, lane);
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from the driver the runtime has loaded (no link
// against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                             cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A tensor map over `planes` row-major [rows, cols] matrices of `dtype` (a
// DTYPE_* code) one after the other, boxes of planes x box_rows x one
// 128-byte row (BK bf16 or f16, F32_BK f32) with the 128-byte swizzle; reads
// past an edge are zero.
CUresult make_map(CUtensorMap* map, const void* base, int rows, int cols,
                  int box_rows, int dtype, int planes = 1) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const bool f32 = dtype == DTYPE_F32;
  const cuuint64_t bytes = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * bytes,
                                 (cuuint64_t)cols * bytes * rows};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / bytes), (cuuint32_t)box_rows,
                             (cuuint32_t)planes};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map,
                f32                   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : dtype == DTYPE_F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                planes > 1 ? 3 : 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

struct Args {
  const int* targets;
  Outputs out;
  int n, d, v, k_top, n_chunks;
  float cap;
  const long long* ceiling;
  long long* next_ceiling;
  int k_merge;
  refill::Scratch scratch;
  int grid;  // a refill's blocks
};

template <typename T, int NT, bool CAP, int L>
int launch(const CUtensorMap& mx, const CUtensorMap& me, const Args& a,
           cudaStream_t stream) {
  auto kernel = lens_splitv_kernel<T, NT, CAP, L>;
  constexpr int bytes = tf32::is_f32<T> ? f32_smem_bytes(NT) : smem_bytes(NT);
  static_assert(bytes + STATIC_BYTES <= SMEM_LIMIT, "shared memory");
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<a.ceiling != nullptr ? a.grid : a.n_chunks, THREADS, bytes,
           stream>>>(mx, me, a.targets, a.out, a.n, a.d, a.v, a.k_top,
                     a.n_chunks, a.cap, a.ceiling, a.next_ceiling, a.k_merge,
                     a.scratch);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool CAP, int L>
int launch_rows(const CUtensorMap& mx, const CUtensorMap& me, const Args& a,
                cudaStream_t s) {
  switch ((a.n + 7) / 8) {
    case 1: return launch<T, 1, CAP, L>(mx, me, a, s);
    case 2: return launch<T, 2, CAP, L>(mx, me, a, s);
    case 3: return launch<T, 3, CAP, L>(mx, me, a, s);
    case 4: return launch<T, 4, CAP, L>(mx, me, a, s);
    case 5: return launch<T, 5, CAP, L>(mx, me, a, s);
    case 6: return launch<T, 6, CAP, L>(mx, me, a, s);
    case 7: return launch<T, 7, CAP, L>(mx, me, a, s);
    case 8: return launch<T, 8, CAP, L>(mx, me, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// The arguments of tbx_lens_splitv, which checks them.
#define SPLITV_PARAMS                                                         \
  const void *x, const void *e, void *x_split, const int *targets,            \
      float *part_max, float *part_sumexp, float *part_tgt, float *part_vals, \
      int *part_ids, float *lse, float *tgt, float *vals, int *ids,           \
      int *ticket, int n, int d, int v, int k_top, int list_len,              \
      int n_chunks, int has_cap, int dtype, float cap, void *stream,          \
      const long long *ceiling, long long *next_ceiling, int k_merge,         \
      int *work, float *piece_vals, int *piece_ids, int *tickets, int grid
#define SPLITV_ARGS                                                          \
  x, e, x_split, targets, part_max, part_sumexp, part_tgt, part_vals,        \
      part_ids, lse, tgt, vals, ids, ticket, n, d, v, k_top, list_len,       \
      n_chunks, has_cap, dtype, cap, stream, ceiling, next_ceiling, k_merge, \
      work, piece_vals, piece_ids, tickets, grid

// One launch in the input type T (float: x split first into x_split), with
// the cap or without.
template <typename T, bool CAP>
int launch_typed(SPLITV_PARAMS) {
  constexpr bool F32 = tf32::is_f32<T>;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int npad = 8 * ((n + 7) / 8);
  CUtensorMap mx, me;
  CUresult cr = F32 ? make_map(&mx, x_split, n, d, npad, DTYPE_F32, 2)
                    : make_map(&mx, x, n, d, npad, dtype_code<T>);
  if (cr != CUDA_SUCCESS) return -static_cast<int>(cr);
  cr = make_map(&me, e, v, d, TILE_ROWS, dtype_code<T>);
  if (cr != CUDA_SUCCESS) return -static_cast<int>(cr);
  const Args a{targets,
               {part_max, part_sumexp, part_tgt, part_vals, part_ids, lse,
                tgt, vals, ids, ticket},
               n, d, v, k_top, n_chunks, cap, ceiling, next_ceiling, k_merge,
               {work, piece_vals, piece_ids, tickets}, grid};
  if constexpr (F32) {
    const cudaError_t rc = tf32::split_rows(static_cast<const float*>(x),
                                            static_cast<float*>(x_split), n, d,
                                            s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  if (ceiling != nullptr && k_merge == k_top) {
    // A refill: the work list of its chunks (units) and 32-row tiles.  (A
    // certified pass finds it written by the pass before.)
    const refill::Geometry g{n, 1, MAX_ROWS, n_chunks,
                             (v + TILE_ROWS - 1) / TILE_ROWS};
    const cudaError_t rc = refill::launch_plan(ceiling, g, work, s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return list_len == KMAX ? launch_rows<T, CAP, KMAX>(mx, me, a, s)
                          : launch_rows<T, CAP, KMAX_WIDE>(mx, me, a, s);
}

}  // namespace

extern "C" {

// The sixths of tbx_lens_splitv, which checks the arguments, each in its
// own unit.
int tbx_splitv_bf16(SPLITV_PARAMS);
int tbx_splitv_bf16_cap(SPLITV_PARAMS);
int tbx_splitv_f32(SPLITV_PARAMS);
int tbx_splitv_f32_cap(SPLITV_PARAMS);
int tbx_splitv_f16(SPLITV_PARAMS);
int tbx_splitv_f16_cap(SPLITV_PARAMS);

#if LENS_SPLITV_UNIT == 0 || LENS_SPLITV_UNIT == 1
int tbx_splitv_bf16(SPLITV_PARAMS) {
  return launch_typed<__nv_bfloat16, false>(SPLITV_ARGS);
}
#endif
#if LENS_SPLITV_UNIT == 0 || LENS_SPLITV_UNIT == 2
int tbx_splitv_bf16_cap(SPLITV_PARAMS) {
  return launch_typed<__nv_bfloat16, true>(SPLITV_ARGS);
}
#endif
#if LENS_SPLITV_UNIT == 0 || LENS_SPLITV_UNIT == 3
int tbx_splitv_f32(SPLITV_PARAMS) {
  return launch_typed<float, false>(SPLITV_ARGS);
}
#endif
#if LENS_SPLITV_UNIT == 0 || LENS_SPLITV_UNIT == 4
int tbx_splitv_f32_cap(SPLITV_PARAMS) {
  return launch_typed<float, true>(SPLITV_ARGS);
}
#endif
#if LENS_SPLITV_UNIT == 0 || LENS_SPLITV_UNIT == 5
int tbx_splitv_f16(SPLITV_PARAMS) {
  return launch_typed<__half, false>(SPLITV_ARGS);
}
#endif
#if LENS_SPLITV_UNIT == 0 || LENS_SPLITV_UNIT == 6
int tbx_splitv_f16_cap(SPLITV_PARAMS) {
  return launch_typed<__half, true>(SPLITV_ARGS);
}
#endif

#if LENS_SPLITV_UNIT == 0 || LENS_SPLITV_UNIT == 1
// Geometry, checked by the wrapper against its own plan.
int tbx_splitv_tile_rows() { return TILE_ROWS; }
int tbx_splitv_kmax() { return KMAX; }
int tbx_splitv_kmax_wide() { return KMAX_WIDE; }
int tbx_splitv_merge_max() { return MERGE_MAX; }
int tbx_splitv_max_rows() { return MAX_ROWS; }
int tbx_splitv_smem_bytes(int n) {
  return n >= 1 && n <= MAX_ROWS ? smem_bytes((n + 7) / 8) : -1;
}
int tbx_splitv_f32_smem_bytes(int n) {
  return n >= 1 && n <= MAX_ROWS ? f32_smem_bytes((n + 7) / 8) : -1;
}
// The input types instantiated, as a mask of their dtype codes: bit 0
// bf16, bit 1 f32 (3xTF32), bit 2 f16.
int tbx_splitv_dtypes() { return DTYPE_BF16 | DTYPE_F32 | DTYPE_F16; }

// Negative codes are -(CUresult) of a refused tensor map.
const char* tbx_splitv_error_string(int code) {
  if (code < 0) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch one pass on `stream`.  x [n, d] and e [v, d] row-major, both of
// the type `dtype` codes (DTYPE_BF16, DTYPE_F32 or DTYPE_F16), 16-byte
// aligned, d % 8 == 0 (d % 4 == 0 in f32); x_split
// [2, n, d] f32 scratch for the split of x (f32 only; written here first);
// 1 <= n <= MAX_ROWS; targets [n] int32 (-1 = none); list_len KMAX or
// KMAX_WIDE, the instantiation's list length, and 1 <= k_top <= list_len;
// 1 <= n_chunks <= ceil(v / TILE_ROWS).  Partials [n_chunks, n] and
// [n_chunks, n, k_top] as in the file header; with lse not null, also the
// merged statistics lse, tgt [n], vals and ids [n, k_merge], counted on
// ticket (one int, 0 at launch).  k_merge is k_top, or for a certified
// pass (list_len == k_top == KMAX_WIDE, lse and next_ceiling not null)
// KMAX_WIDE < k_merge <= MERGE_MAX; ceiling, null or a refill's [n_chunks,
// n] keys (long list only; a refill's max, sum-exp and target partials are
// not read), may be next_ceiling.  A refill runs on `grid` blocks with its
// scratch (refill_work.cuh): work [3 + 3 n_chunks] ints, piece_vals and
// piece_ids [n_chunks + grid, n, KMAX_WIDE], tickets [n_chunks] ints, 0 at
// launch; it lists only the pairs its ceilings leave open.  A certified
// pass writes the next pass's work list into `work` (every certified pass
// takes it), and its refill reads the list the pass before wrote.
int tbx_lens_splitv(SPLITV_PARAMS) {
  const bool wide = list_len == KMAX_WIDE && k_top == KMAX_WIDE;
  const bool certified = k_merge != k_top;
  if (n < 1 || n > MAX_ROWS || (list_len != KMAX && list_len != KMAX_WIDE) ||
      k_top < 1 || k_top > list_len || n_chunks < 1 ||
      n_chunks > (v + TILE_ROWS - 1) / TILE_ROWS ||
      (lse != nullptr && (tgt == nullptr || vals == nullptr ||
                          ids == nullptr || ticket == nullptr)) ||
      (dtype == DTYPE_F32 && (x_split == nullptr || d % 4 != 0)) ||
      (ceiling != nullptr &&
       (!wide || work == nullptr || piece_vals == nullptr ||
        piece_ids == nullptr || tickets == nullptr || grid < 1)) ||
      (certified && (!wide || k_merge <= KMAX_WIDE || k_merge > MERGE_MAX ||
                     lse == nullptr || next_ceiling == nullptr ||
                     work == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case DTYPE_BF16:
      return has_cap ? tbx_splitv_bf16_cap(SPLITV_ARGS)
                     : tbx_splitv_bf16(SPLITV_ARGS);
    case DTYPE_F32:
      return has_cap ? tbx_splitv_f32_cap(SPLITV_ARGS)
                     : tbx_splitv_f32(SPLITV_ARGS);
    case DTYPE_F16:
      return has_cap ? tbx_splitv_f16_cap(SPLITV_ARGS)
                     : tbx_splitv_f16(SPLITV_ARGS);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif

}  // extern "C"
