// Fused logit-lens statistics for NVIDIA Hopper (sm_90a): TMA ring, wgmma,
// and a running per-row state across a chunk of the vocabulary.
//
// Replaces the TPU kernel of the JAX package: ops/pallas_lens.py,
// `_lens_tile_kernel` launched by `lens_stats`, on its bf16, f16 or f32
// inputs with more rows than the split-V kernel takes (ops/lens_kernel.py
// `lens_plan`): every top_k, those above KMAX_WIDE in several passes of the
// long list (below).  For rows x [N, D]
// (final-normed residuals) and the tied embedding E [V, D] a block owns one
// tile of BM rows and a contiguous chunk of the vocabulary, and writes one
// partial per (chunk, row):
//
//   logits = x @ E[chunk]^T            (bf16 or f16 wgmma, or 3xTF32; f32 sums)
//   logits = tanh(logits / cap) * cap   [CAP only]
//   part_max[s, n], part_sumexp[s, n]   running max / sum exp(logit - max)
//   part_tgt[s, n]                      logit of targets[n] in the chunk, else -1e30
//   part_vals/ids[s, n, :K]             the chunk's top-K, lowest id first
//                                       among equal values
//
// and the torch epilogue (`merge_partials`) merges the S chunks.  The [N, V]
// logits never reach device memory.
//
// What bounds it: at the main path's shape (N 1140, D 3584, V 256000) a call
// is 2*N*D*V = 2.09 TFLOP, 2.1 ms at the card's 989 TFLOP/s bf16 peak, against
// 1.84 GB of x and E read once (0.55 ms at 3.35 TB/s): the tensor cores bound
// it.  What the design does about each limit:
//
// - Loads overlap the math.  One thread of a producer warpgroup keeps a ring
//   of STAGES shared-memory stages full with TMA (cp.async.bulk.tensor,
//   128-byte swizzle, 64-deep k-steps), each stage guarded by a full and an
//   empty mbarrier; the consumers wait only on data already in flight and
//   hand a stage back as soon as the wgmma that read it has retired.
// - wgmma at the full tile width.  A block tile is BM = 128 rows x BN = 256
//   vocab columns: two consumer warpgroups, each one wgmma.m64n256k16 per
//   16-deep slice with its 64 x 256 f32 accumulator in registers (128 a
//   thread).  Both operands are K-major in shared memory (the "TN" product).
//   Each stage carries 16 KB of x and 32 KB of E for 4.2 MFLOP: 85 FLOP per
//   byte moved from L2.  The producer warpgroup gives up its registers
//   (setmaxnreg) so that each consumer thread can hold 232.
// - The epilogue stays in registers.  Rows of x are the wgmma's M dimension,
//   so each row's columns sit in one quad of lanes.  After each tile's
//   product a lane folds its columns into per-row running state: an online
//   max / sum-exp, the target logit, and a sorted top-KMAX list.  The
//   epilogue runs while the tensor cores wait, so it is kept short: exp2 and
//   the cap's tanh from the approximate-function unit (each within 2 ulp;
//   not tanh.approx, whose 2^-11 would break the tolerance), and the top-k
//   list touched only by values above a cut that the quad's lists already
//   exceed KMAX times; those few are queued in shared memory with predicated
//   stores and inserted in a loop, so the 128-way unrolled code stays small
//   enough for the instruction cache.  Columns arrive in ascending id, so a
//   value enters a list only when strictly greater than an entry, which
//   keeps the lowest id first among ties.  The quad's four lists merge by
//   (value desc, id asc) once per chunk, so the partials shrink from one per
//   128 columns to one per chunk.
// - A top-k of 9 to 32 (KMAX_WIDE) takes a second instantiation with the
//   same registers and shared memory.  Four lists of 32 a lane would take
//   128 more registers beside the 128 of the accumulator (the consumers have
//   232), and shared memory is full (four 48 KB stages and the 32 KB of
//   candidate slots, of the block's 227 KB), so the quad keeps ONE sorted
//   list of 32 per row, split across its four lanes: lane q holds ranks
//   8q .. 8q+7, in the same 2 x 8 register pairs as the short list, and the
//   list's last entry (lane 3's) is the cut.  Each lane queues its columns
//   above the cut in its slots (8 a row); the quad then walks the four
//   queues one candidate at a time (every lane reads the candidate from
//   shared memory), and a candidate enters lane q's part when it is ahead
//   of that part's last entry, lane q-1's last entry moving down into lane
//   q when the candidate is ahead of it too: one shuffle pair and one
//   8-entry insertion per candidate, with no merge at the end of the chunk.
//   The four queues interleave ids, so this list compares (value desc, id
//   asc) on insertion, which keeps the lowest id first among ties as the
//   strict rule does for the short list.  Past a lane's 8 slots the quad
//   goes round again from the list's last entry, ties included.  While the
//   list is not yet full the least of the quad's 32 group maxima (8 columns
//   a group) stands in for the cut: 32 of the tile's columns are at or
//   above it.
//   The walk is a chain of shuffles, and it ran while the tensor cores
//   waited: 0.9-1.2 ms of a 4.6 ms K 32 call against K <= 8's 0.3.  Two
//   changes take it off that path:
//   * A tile's last round of candidates stays in the row's slots (each row
//     keeps 8 of the thread's 16) and is walked during the next tile's
//     products: one step of each row between a k-step's commit and its wait
//     (56 k-steps a tile, each ~1,600 cycles of products, a step ~150), the
//     rest before the next fold reads the list.  Only rounds before the
//     last (some lane with more than 8 candidates) walk on the critical
//     path.
//   * A span's first tile (every list of the warp empty), whose floor lets
//     in ~90 columns a row, takes no walk: each lane takes its own top 8 as
//     the short list does, the quad's four lists become its one list by
//     rank (each entry's rank counted against the other lanes' 24, written
//     to that rank's slot and read back), and the tile's columns the list
//     may still lack, those behind their lane's 8th entry yet ahead of the
//     list's last (any of the true top 32 missing is one: a few), are
//     walked in as a last round.
//   Not taken: a ping-pong of the two warpgroups, one folding while the
//   other's wgmmas run.  A tile is 56 k-steps deep and the ring 4 stages,
//   so the warpgroups cannot run a fold apart on shared stages; each would
//   need its own stream of E (1.7x the bytes from L2 a k-step) for a fold
//   that the two changes above mostly hide.
// - A top-k above KMAX_WIDE (up to the wrapper's 1024) takes the long list
//   in ceil(K / KMAX_WIDE) passes, certified by the wrapper
//   (ops/lens_kernel.py `certify_top_k`): the first is the K = KMAX_WIDE
//   call; each later one (a refill) gets a ceiling per (chunk, row), the
//   last key that pair's list held, and lists the KMAX_WIDE keys strictly
//   below it (value descending, then id ascending).  A pair the wrapper
//   found complete gets the empty key (-inf, INT_MAX), below which nothing
//   lies.  The ceiling hides a row's columns at or above it (-inf) after
//   the row's statistics have read them, so the group maxima above stand
//   in for the cut over the columns the list may take.  A refill runs on a
//   grid of one block per SM whatever pairs are open: a plan kernel lists
//   the (chunk, row tile) units an open pair keeps, each block takes an
//   even share of their tiles (spans), and a unit dealt in pieces is merged
//   by the block that completes it (refill_work.cuh), so one open unit's
//   22-23 tiles run on as many SMs, not on one.
// - E crosses HBM about once.  Blocks are numbered row-tile fastest, so the
//   row tiles of one vocab chunk run together and walk the same E tiles in
//   step: one of them reads each E stage from HBM, the others from L2.  x
//   (8 MB) stays in L2 throughout.
// - f32 (3xTF32, tf32_split.cuh).  A single TF32 product keeps 11 bits of
//   each operand (~1e-3), so f32 takes three: x hi . E hi + x lo . E hi +
//   x hi . E lo, each tf32 wgmma.m64n256k8, into the same accumulator: six
//   times bf16's tensor-core time per call (three products at 495 TFLOP/s,
//   half the bf16 rate; 12.7 ms at the main path's shape) and twice its
//   bytes.  wgmma reads B only from shared memory, so E's lo has to be
//   there: the producer warpgroup's three idle warps split each E tile as
//   it lands (hi in place, lo beside it) and arrive on a third barrier.  A
//   stage holds x hi and lo, E and E lo, so it is 16 deep (64-byte rows) to
//   keep four stages in the ring.  x is split once per call by a small
//   kernel into the wrapper's [2, N, D] scratch and loaded as both planes
//   in one 3-D TMA box.  The fold, the lists and the epilogue read the same
//   f32 accumulator and do not change; the registers stay as bf16's.
// - f16 takes bf16's path whole: the same 2-byte elements, so the same
//   stages, swizzle, ring and registers, and the f16 form of the same
//   wgmma (m64n256k16.f32.f16.f16) at the same tensor-core rate.  The
//   product of two f16 values is exact in f32, as of two bf16 ones, so the
//   plain version's upcast matches the sums up to their order.
// - Edges: TMA zero-fills rows past N, depth past D and columns past V.
//   Padded rows are never written; columns past V are set to -inf after the
//   cap, before any statistic reads them.
//
// The macros LENS_ANATOMY_SKIP_TOPK and LENS_ANATOMY_SKIP_FOLD leave out the
// running top-k or the whole per-tile fold; only perf/lens_anatomy.py sets
// them, to time the parts, and their partials are meaningless.  It also sets
// LENS_F32_BK, the f32 stage's depth (below).
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes.  The launcher returns 0, a cudaError_t of the launch, or a negative
// code for a tensor map the driver refused (see tbx_wgmma_error_string).
//
// Build units: the wrapper compiles this file three times, in parallel, and
// links the objects into one library: -DLENS_WGMMA_UNIT=1 holds the bf16
// instantiations and the C interface, -DLENS_WGMMA_UNIT=2 the f32 ones
// (tbx_wgmma_launch_f32), -DLENS_WGMMA_UNIT=3 the f16 ones
// (tbx_wgmma_launch_f16).  Without the macro (perf/sass_compare.py,
// perf/lens_anatomy.py) one unit holds all three.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#ifndef LENS_WGMMA_UNIT
#define LENS_WGMMA_UNIT 0
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

constexpr int BM = 128;              // rows per block: two warpgroups of 64
constexpr int BN = 256;              // vocab columns per tile
constexpr int BK = 64;               // depth per stage: one 128-byte row of bf16 / f16
constexpr int STAGES = 4;
constexpr int KMAX = 8;              // the short top-k list, per lane
static_assert(KMAX % 4 == 0, "the quad's cut takes KMAX / 4 from each lane");
constexpr int KMAX_WIDE = 4 * KMAX;  // the long one, split across the quad
constexpr int CONSUMER_THREADS = 256;
constexpr int THREADS = CONSUMER_THREADS + 128;  // + one producer warpgroup
constexpr int CONSUMER_WARPS = CONSUMER_THREADS / 32;
// setmaxnreg: 384 threads start at 168 registers (65536 / 384); the producer
// drops to 40 and the consumers take the rest, 128 * 128 / 256 = 64 more.
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int A_BYTES = BM * BK * 2;  // 16 KB of x
constexpr int B_BYTES = BN * BK * 2;  // 32 KB of E
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// Per consumer thread, slots for one tile's top-k candidates of one row;
// slot k of every thread is one row of SLOT_STRIDE bytes.
constexpr int CAND_SLOTS = 16;
constexpr int SLOT_STRIDE = CONSUMER_THREADS * 8;
// The long list's rows each keep half of them: a row's last round of
// candidates waits in its slots while the next tile's products run.
constexpr int WIDE_SLOTS = CAND_SLOTS / 2;
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8 +
                           CAND_SLOTS * CONSUMER_THREADS * 8;
// The f32 (3xTF32) instantiation.  A stage holds x split into hi and lo
// (loaded so by TMA from the wrapper's split copy), E (split in place into
// hi) and E's lo, four times a bf16 stage's bytes per depth.  It is 16 deep:
// rows of 64 bytes under the 64-byte swizzle, two k8 slices 32 bytes apart,
// 48 KB a stage, so the ring keeps bf16's four stages (three in flight while
// one is multiplied).  32-deep stages (128-byte rows, the 128-byte swizzle)
// fit only two, one in flight; 8-deep ones (32-byte rows) eight.  The macro
// LENS_F32_BK picks another depth; only perf/lens_anatomy.py sets it, to
// time the three in turns (PERF.md).  The producer warpgroup's three idle
// warps split E.
#ifndef LENS_F32_BK
#define LENS_F32_BK 16
#endif
constexpr int F32_BK = LENS_F32_BK;
constexpr int F32_ROW = F32_BK * 4;               // bytes a row: the swizzle
constexpr int F32_STAGES = 64 / F32_BK;
constexpr int F32_X_BYTES = 2 * BM * F32_ROW;     // x hi, then x lo
constexpr int F32_E_BYTES = BN * F32_ROW;         // E (hi after the split)
constexpr int F32_STAGE_BYTES = F32_X_BYTES + 2 * F32_E_BYTES;  // + E lo
constexpr int SPLIT_THREADS = 96;                 // producer warps 1-3
constexpr int F32_SMEM_BYTES = 1024 + F32_STAGES * F32_STAGE_BYTES +
                               3 * F32_STAGES * 8 +
                               CAND_SLOTS * CONSUMER_THREADS * 8;
static_assert(F32_SMEM_BYTES <= 232448, "a block's shared memory on sm_90");
constexpr float NEG_BIG = -1e30f;     // logit of an absent target
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL_MASK = 0xffffffffu;
// A barrier wait that outlasts this traps instead of hanging the card.
constexpr unsigned long long WAIT_LIMIT_NS = 10ull * 1000 * 1000 * 1000;


// Shared memory is addressed by 32-bit offsets in the shared window
// throughout: the compiler then keeps every access a shared one.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Store {x, id} at `addr` when `pred` holds: no branch around the store.
__device__ __forceinline__ void st_shared_if(bool pred, uint32_t addr, float x,
                                             int id) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %0, 0;\n\t"
      "@p st.shared.v2.b32 [%1], {%2, %3};\n\t}" ::"r"((int)pred),
      "r"(addr), "r"(__float_as_uint(x)), "r"(id)
      : "memory");
}

__device__ __forceinline__ void ld_shared(uint32_t addr, float& x, int& id) {
  uint32_t bits;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];"
               : "=r"(bits), "=r"(id)
               : "r"(addr)
               : "memory");
  x = __uint_as_float(bits);
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

// The same for the f32 stages' rows of F32_ROW bytes, swizzled over the
// row (64 bytes; 128 or 32 under LENS_F32_BK): 8-row groups 8 rows apart.
__device__ __forceinline__ uint64_t f32_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |          // leading offset (unused)
         (static_cast<uint64_t>(8 * F32_ROW >> 4) << 32) |  // stride offset
         (static_cast<uint64_t>(F32_ROW == 128 ? 1 : F32_ROW == 64 ? 2 : 3)
          << 62);                                    // the row's swizzle
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

// A top-k key as the wrapper builds it (ops/lens_kernel.py `_keys`): the
// value's order-preserving bits above, 0xFFFFFFFF - id below.  The empty key
// (-inf, INT_MAX) is below every column's.
__device__ __forceinline__ void key_parts(long long key, float& v, int& id) {
  const int hi = static_cast<int>(key >> 32);
  v = __int_as_float(hi >= 0 ? hi : hi ^ 0x7FFFFFFF);
  id = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(key));
}

// A pair's ceiling, loaded where it is used (asm volatile: not hoisted
// into a register that lives across the tile loop).
__device__ __forceinline__ long long ld_ceiling(const long long* p) {
  long long v;
  asm volatile("ld.global.nc.b64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

// Keeps the compiler from moving reads of the accumulator above a wait.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The 128 accumulator registers of a m64n256 wgmma, as the asm statements
// below name and bind them.
#define WGMMA_ACC_REGS \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9," \
  "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19," \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29," \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39," \
  "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49," \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59," \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69," \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79," \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89," \
  "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99," \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109," \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119," \
  "%120, %121, %122, %123, %124, %125, %126, %127"
#define WGMMA_ACC_OPERANDS \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), \
  "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
  "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), \
  "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), \
  "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
  "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), \
  "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
  "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), \
  "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
  "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), \
  "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), \
  "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d[64 x 256] += A[64 x 16] * B[256 x 16]^T, both K-major in shared memory,
// in bf16 or (F16) f16.
template <bool F16>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
#define WGMMA_M64N256K16(AB)                                        \
  asm volatile(                                                     \
      "{\n"                                                         \
      ".reg .pred p;\n"                                             \
      "setp.ne.b32 p, %130, 0;\n"                                   \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." AB "." AB " "  \
      "{" WGMMA_ACC_REGS "},"                                       \
      " %128, %129, p, 1, 1, 0, 0;\n"                               \
      "}\n"                                                         \
      : WGMMA_ACC_OPERANDS                                          \
      : "l"(da), "l"(db), "r"(1))
  if constexpr (F16) {
    WGMMA_M64N256K16("f16");
  } else {
    WGMMA_M64N256K16("bf16");
  }
#undef WGMMA_M64N256K16
}

// d[64 x 256] += A[64 x 8] * B[256 x 8]^T in TF32 (f32 operands whose low
// 13 mantissa bits are zero), both K-major in shared memory: tf32 wgmma takes
// no transpose.
__device__ __forceinline__ void wgmma_m64n256k8_tf32(float (&d)[128],
                                                     uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{" WGMMA_ACC_REGS "},"
      " %128, %129, p, 1, 1;\n"
      "}\n"
      : WGMMA_ACC_OPERANDS
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
// cap: one exp2 and one reciprocal, each within 2 ulp, so the result is
// within about 1e-5 of the exact one at a cap of 30.  (tanh.approx's
// relative error of 2^-11 would be 0.015 there.)
__device__ __forceinline__ float capped_tanh(float x, float k2, float cap) {
  return cap * (1.0f - 2.0f * fast_rcp(1.0f + fast_exp2(x * k2)));
}

// ------------------------------------------------------------ running top-k

// (a, ai) ahead of (b, bi) in the top-k order: value descending, then id
// ascending.
__device__ __forceinline__ bool ahead(float a, int ai, float b, int bi) {
  return a > b || (a == b && ai < bi);
}

// Insert (x, id) into a list sorted by decreasing value; x at or below
// tv[KMAX - 1] leaves it as it is.  Equal values keep their earlier (lower)
// ids ahead.
__device__ __forceinline__ void topk_insert(float (&tv)[KMAX], int (&ti)[KMAX],
                                            float x, int id) {
#pragma unroll
  for (int p = KMAX - 1; p > 0; --p) {
    const bool shift = x > tv[p - 1];
    const bool here = !shift && x > tv[p];
    tv[p] = shift ? tv[p - 1] : (here ? x : tv[p]);
    ti[p] = shift ? ti[p - 1] : (here ? id : ti[p]);
  }
  if (x > tv[0]) {
    tv[0] = x;
    ti[0] = id;
  }
}

// Insert (x, id) into a list sorted in the top-k order; the last entry
// falls off.  For values that arrive in any order of ids.
__device__ __forceinline__ void topk_insert_ahead(float (&tv)[KMAX],
                                                  int (&ti)[KMAX], float x,
                                                  int id) {
#pragma unroll
  for (int p = KMAX - 1; p > 0; --p) {
    const bool shift = ahead(x, id, tv[p - 1], ti[p - 1]);
    const bool here = !shift && ahead(x, id, tv[p], ti[p]);
    tv[p] = shift ? tv[p - 1] : (here ? x : tv[p]);
    ti[p] = shift ? ti[p - 1] : (here ? id : ti[p]);
  }
  if (ahead(x, id, tv[0], ti[0])) {
    tv[0] = x;
    ti[0] = id;
  }
}

__device__ __forceinline__ void topk_pop(float (&tv)[KMAX], int (&ti)[KMAX]) {
#pragma unroll
  for (int p = 0; p < KMAX - 1; ++p) {
    tv[p] = tv[p + 1];
    ti[p] = ti[p + 1];
  }
  tv[KMAX - 1] = -INFINITY;
  ti[KMAX - 1] = INT_MAX;
}

#include "refill_work.cuh"

// A walk of the long list still to do: the quad's queue of one round (lane
// q's candidates at ranks [p_q, p_{q+1}) of `total`, p_0 = 0), of which
// steps [k, steps) are left (steps: the warp's longest queue).
struct Walk {
  int p1, p2, p3, total, k, steps;
};

// ------------------------------------------------------------------ kernel

// Grid: row_tiles * n_chunks blocks, row tile fastest.  Chunk s covers the
// vocab tiles [s * T / S, (s + 1) * T / S) of T = ceil(v / BN).  L is the
// running list's length: KMAX (each lane its own list, the quad's four
// merged at the end) or KMAX_WIDE (one list split across the quad).  T is the
// input type: __nv_bfloat16, __half, or float (3xTF32; map_x then covers
// the wrapper's [2, n, d] split of x).  ceiling, [n_chunks, n] keys or null,
// makes the pass a refill (long list only; see the file header) on a grid
// of its own, its work dealt out by the list in `scratch`
// (refill_work.cuh).
template <typename T, bool CAP, int L>
__global__ void __launch_bounds__(THREADS, 1)
    lens_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_e,
                      const int* __restrict__ targets,
                      float* __restrict__ part_max,
                      float* __restrict__ part_sumexp,
                      float* __restrict__ part_tgt,
                      float* __restrict__ part_vals,
                      int* __restrict__ part_ids, int n, int d, int v,
                      int k_top, int n_chunks, float cap,
                      const long long* __restrict__ ceiling,
                      const refill::Scratch scratch) {
  constexpr bool F32 = tf32::is_f32<T>;
  constexpr bool F16 = dtype_code<T> == DTYPE_F16;
  constexpr int kBK = F32 ? F32_BK : BK;
  constexpr int kStages = F32 ? F32_STAGES : STAGES;
  constexpr int kStageBytes = F32 ? F32_STAGE_BYTES : STAGE_BYTES;
  constexpr int kXBytes = F32 ? F32_X_BYTES : A_BYTES;  // E's offset in a stage
  constexpr int kLoadBytes = F32 ? F32_X_BYTES + F32_E_BYTES : STAGE_BYTES;
  constexpr int kBarriers = F32 ? 3 : 2;
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the ring to it.
  // Stage s is at ring + s * kStageBytes (x, then E; f32: x hi, x lo, E, E
  // lo); then the full and the empty barriers (f32: and the ready ones,
  // E split); then the candidate slots.
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + kStages * kStageBytes;  // + 8 * stage
  const uint32_t empty = full + kStages * 8;           // + 8 * stage
  const uint32_t ready = empty + kStages * 8;          // + 8 * stage, f32
  const uint32_t slots = full + kBarriers * kStages * 8;

  const int row_tiles = (n + BM - 1) / BM;
  const int vocab_tiles = (v + BN - 1) / BN;
  const int k_steps = (d + kBK - 1) / kBK;
  // A refill of the long list walks the spans the work list deals this
  // block (units are (chunk, row tile), items vocab tiles); every other
  // launch the block's own unit, whole.
  const bool spread = L == KMAX_WIDE && ceiling != nullptr;
  const refill::Work work{scratch.work, n_chunks * row_tiles};
  // A refill with nothing open has nothing to list.
  if (spread && work.items() == 0) return;
  refill::Spans spans{work, 0, 1};
  if (spread) spans = refill::Spans::of_block(work, blockIdx.x, gridDim.x);
  refill::Span span{-1, 0, 0, 0, 0};
  int row_tile = 0, chunk = 0, t_begin = 0, t_end = 0;
  auto next_span = [&]() -> bool {
    int unit = blockIdx.x;
    if (spread) {
      if (!spans.next(span)) return false;
      unit = span.unit;
    } else if (spans.item++ > 0) {
      return false;
    }
    row_tile = unit % row_tiles;
    chunk = unit / row_tiles;
    t_begin = (int)((long long)chunk * vocab_tiles / n_chunks);
    t_end = (int)((long long)(chunk + 1) * vocab_tiles / n_chunks);
    if (spread) {
      t_end = t_begin + span.upto;
      t_begin += span.first;
    }
    return true;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
      if (F32) mbar_init(ready + 8 * s, SPLIT_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMER_THREADS) {
    // ---- producer warpgroup: hands its registers to the consumers; one
    // lane keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMER_THREADS) {
      int stage = 0;
      uint32_t phase = 0;
      while (next_span())
      for (int t = t_begin; t < t_end; ++t) {
        for (int ks = 0; ks < k_steps; ++ks) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t a = ring + stage * kStageBytes;
          mbar_expect_tx(full + 8 * stage, kLoadBytes);
          if constexpr (F32) {
            tma_load_3d(a, &map_x, full + 8 * stage, ks * kBK, row_tile * BM,
                        0);
          } else {
            tma_load_2d(a, &map_x, full + 8 * stage, ks * BK, row_tile * BM);
          }
          tma_load_2d(a + kXBytes, &map_e, full + 8 * stage, ks * kBK, t * BN);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if constexpr (F32) {
      // Warps 1-3 split each stage's E into hi (in place) and lo once it
      // lands, and hand it to the consumers.
      if (threadIdx.x >= CONSUMER_THREADS + 32) {
        const int ct = threadIdx.x - CONSUMER_THREADS - 32;
        int stage = 0;
        uint32_t phase = 0;
        while (next_span())
        for (int t = t_begin; t < t_end; ++t) {
          for (int ks = 0; ks < k_steps; ++ks) {
            mbar_wait(full + 8 * stage, phase);
            const uint32_t e = ring + stage * kStageBytes + kXBytes;
#pragma unroll 2
            for (int i = ct; i < F32_E_BYTES / 16; i += SPLIT_THREADS) {
              tf32::split_shared16(e + 16 * i, e + F32_E_BYTES + 16 * i);
            }
            tf32::fence_proxy_async();
            __syncwarp();
            if (threadIdx.x % 32 == 0) mbar_arrive(ready + 8 * stage);
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    // ---- consumers: warpgroup wg owns rows wg*64 .. wg*64+63 of the tile.
    const int wg = threadIdx.x / 128;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int q = lane % 4;  // the lane's place in its row's quad
    const uint32_t my_slots = slots + threadIdx.x * 8;
    const uint32_t slots_end = my_slots + CAND_SLOTS * SLOT_STRIDE;
    // Accumulator layout of m64nNk16: d[4j + 2i + c] is row
    // 16*(warp%4) + lane/4 + 8i, column 8j + 2q + c.
    int rows[2], tgt[2];
    float run_max[2], run_sum[2], run_tgt[2];
    float top_v[2][KMAX];
    int top_i[2][KMAX];
    float acc[128];
    int stage = 0;
    uint32_t phase = 0;
    // The long list's walks left to do, and the tile whose columns they
    // queued; a step of each runs between a k-step's products and its wait.
    Walk walk[2] = {};
    int walk_col0 = 0;
    // (Called with i 0 or 1 where it unrolls, so the arrays stay registers.)
    auto walk_step = [&](int i) {
      Walk& w = walk[i];
      if (w.k >= w.steps) return;  // warp-uniform
      const int k = w.k++;
      const int from = (k >= w.p1) + (k >= w.p2) + (k >= w.p3);
      const int first = from == 0 ? 0 : from == 1 ? w.p1
                      : from == 2 ? w.p2 : w.p3;
      float y;
      int jc;
      ld_shared(slots + (threadIdx.x & ~3) * 8 + from * 8 +
                    (i * WIDE_SLOTS + min(k - first, WIDE_SLOTS - 1)) *
                        SLOT_STRIDE,
                y, jc);
      const int id = walk_col0 + 2 * from + jc;
      // Lane q-1's last entry moves down into this lane's part when the
      // candidate goes above it.
      const float up_v = __shfl_up_sync(FULL_MASK, top_v[i][KMAX - 1], 1);
      const int up_i = __shfl_up_sync(FULL_MASK, top_i[i][KMAX - 1], 1);
      const bool carry = (lane & 3) > 0 && ahead(y, id, up_v, up_i);
      if (k < w.total && ahead(y, id, top_v[i][KMAX - 1], top_i[i][KMAX - 1]))
        topk_insert_ahead(top_v[i], top_i[i], carry ? up_v : y,
                          carry ? up_i : id);
    };
    auto flush_walks = [&]() {
      while (walk[0].k < walk[0].steps) walk_step(0);
      while (walk[1].k < walk[1].steps) walk_step(1);
    };

    while (next_span()) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rows[i] = row_tile * BM + wg * 64 + (warp % 4) * 16 + lane / 4 + 8 * i;
      const int t = rows[i] < n ? targets[rows[i]] : -1;
      tgt[i] = (t >= 0 && t < v) ? t : -1;
      run_max[i] = -INFINITY;
      run_sum[i] = 0.0f;
      run_tgt[i] = NEG_BIG;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int p = 0; p < KMAX; ++p) {
        top_v[i][p] = -INFINITY;
        top_i[i][p] = INT_MAX;
      }

    for (int t = t_begin; t < t_end; ++t) {
#pragma unroll
      for (int r = 0; r < 128; ++r) acc[r] = 0.0f;
      int prev = 0;
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait((F32 ? ready : full) + 8 * stage, phase);
        const uint32_t a =
            ring + stage * kStageBytes + wg * 64 * (F32 ? F32_ROW : 128);
        const uint32_t b = ring + stage * kStageBytes + kXBytes;
        wgmma_fence();
        if constexpr (F32) {
          // 3xTF32: x hi . E hi + x lo . E hi + x hi . E lo.
          const uint32_t a_lo = a + BM * F32_ROW;
          const uint32_t b_lo = b + F32_E_BYTES;
#pragma unroll
          for (int kk = 0; kk < F32_BK / 8; ++kk) {
            wgmma_m64n256k8_tf32(acc, f32_desc(a + kk * 32),
                                 f32_desc(b + kk * 32));
            wgmma_m64n256k8_tf32(acc, f32_desc(a_lo + kk * 32),
                                 f32_desc(b + kk * 32));
            wgmma_m64n256k8_tf32(acc, f32_desc(a + kk * 32),
                                 f32_desc(b_lo + kk * 32));
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            wgmma_m64n256k16<F16>(acc, smem_desc(a + kk * 32),
                                  smem_desc(b + kk * 32));
          }
        }
        wgmma_commit();
        if constexpr (L == KMAX_WIDE) {
          // The last tile's deferred walks, a step a row while the
          // products just issued run.
          walk_step(0);
          walk_step(1);
        }
        if (ks > 0) {
          // The previous stage's products are done: hand its buffer back.
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty + 8 * prev);
        }
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + 8 * prev);
      fence_acc(acc);
      if constexpr (L == KMAX_WIDE) flush_walks();

#ifndef LENS_ANATOMY_SKIP_FOLD
      // ---- fold this tile into the running state.  The code is unrolled
      // over the 128 accumulator registers, so each step is kept to a few
      // instructions: the whole epilogue has to stay in the instruction cache.
      const int col0 = t * BN;
      const int base = col0 + 2 * q;  // column of acc[4j + 2i + c]: base + 8j + c
      if (CAP) {
        const float k2 = 2.0f * LOG2E / cap;
#pragma unroll
        for (int r = 0; r < 128; ++r) acc[r] = capped_tanh(acc[r], k2, cap);
      }
      if (col0 + BN > v) {  // vocab tail: TMA zero-filled these columns
        const int lim = v - base;
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (8 * j + c >= lim) {
              acc[4 * j + c] = -INFINITY;
              acc[4 * j + 2 + c] = -INFINITY;
            }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float tile_max = -INFINITY;
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            tile_max = fmaxf(tile_max, acc[4 * j + 2 * i + c]);
        const float m = fmaxf(run_max[i], tile_max);
        const float m2 = m * LOG2E;
        const int rel = tgt[i] - base;  // 8j + c of the target, if this lane's
        float sum = 0.0f;
        float tv = run_tgt[i];
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float x = acc[4 * j + 2 * i + c];
            sum += fast_exp2(fmaf(x, LOG2E, -m2));
            tv = rel == 8 * j + c ? x : tv;
          }
        run_sum[i] = run_sum[i] * fast_exp2((run_max[i] - m) * LOG2E) + sum;
        run_max[i] = m;
        run_tgt[i] = tv;

#ifndef LENS_ANATOMY_SKIP_TOPK
        if constexpr (L == KMAX) {
          // The quad already holds KMAX values at or above `cut`: each lane
          // KMAX at or above its last entry, and each lane two at or above
          // its second.  Every one of them has a lower id than this tile's
          // columns, so a value at or below `cut` cannot enter the quad's
          // top-KMAX, ties included.
          float cut = top_v[i][KMAX - 1];
          float second = top_v[i][KMAX / 4 - 1];
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            cut = fmaxf(cut, __shfl_xor_sync(FULL_MASK, cut, off));
            second = fminf(second, __shfl_xor_sync(FULL_MASK, second, off));
          }
          cut = fmaxf(cut, second);
          if (__any_sync(FULL_MASK, tile_max > cut)) {
            // Queue the lane's candidates above `cut` in its shared-memory
            // slots, in ascending id (stored as 8j + c), with predicated
            // stores, and insert them.  A lane with more candidates than slots
            // (the first tile of a chunk) goes round again after its last
            // queued column, with `cut` raised to its own list's last entry:
            // a later column at or below it has KMAX entries ahead of it.
            int done = -1;  // columns 8j + c <= done are handled
            while (true) {
              uint32_t at = my_slots;  // the next free slot
#pragma unroll
              for (int j = 0; j < 32; ++j)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                  const float x = acc[4 * j + 2 * i + c];
                  const bool take = x > cut && 8 * j + c > done;
                  st_shared_if(take && at < slots_end, at, x, 8 * j + c);
                  at += take ? SLOT_STRIDE : 0;
                }
              const int n_cand = (at - my_slots) / SLOT_STRIDE;
              const int n_take = min(n_cand, CAND_SLOTS);
              for (int k = 0; k < n_take; ++k) {
                float x;
                int jc;
                ld_shared(my_slots + k * SLOT_STRIDE, x, jc);
                topk_insert(top_v[i], top_i[i], x, base + jc);
              }
              if (!__any_sync(FULL_MASK, n_cand > CAND_SLOTS)) break;
              if (n_cand > CAND_SLOTS) {
                float x;
                ld_shared(my_slots + (CAND_SLOTS - 1) * SLOT_STRIDE, x, done);
              } else {
                done = BN;
              }
              cut = fmaxf(cut, top_v[i][KMAX - 1]);
            }
          }
        } else {
          // The quad's one list of KMAX_WIDE: lane q holds its entries
          // KMAX q .. KMAX q + KMAX - 1, so its last entry is lane 3's.
          const int quad = lane & ~3;
          const uint32_t row_slots = my_slots + i * WIDE_SLOTS * SLOT_STRIDE;
          const uint32_t row_slots_end = row_slots + WIDE_SLOTS * SLOT_STRIDE;
          if (ceiling != nullptr) {
            // A refill: the columns at or above the pair's ceiling (listed
            // by an earlier pass, or every column of a complete pair) leave
            // the list's view; the row's statistics above have read them.
            float cv;
            int ci;
            key_parts(ld_ceiling(ceiling + (size_t)chunk * n +
                                 min(rows[i], n - 1)),
                      cv, ci);
            const int ci_rel = ci - base;  // 8j + c of the ceiling's id
#pragma unroll
            for (int j = 0; j < 32; ++j)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const float x = acc[4 * j + 2 * i + c];
                const bool below = x < cv || (x == cv && 8 * j + c > ci_rel);
                acc[4 * j + 2 * i + c] = below ? x : -INFINITY;
              }
          }
          // Rounds of at most WIDE_SLOTS candidates a lane (take(x, 8j + c)
          // picks them), queued in the row's slots in ascending id and
          // walked into the list by the quad.  Every round but the last is
          // walked at once (`raise` then moves the pick past the list's new
          // last entry); the last one waits in the slots and is walked, a
          // step per k-step, while the next tile's products run.
          auto rounds = [&](auto&& take, auto&& raise) {
            walk_col0 = col0;
            int done = -1;  // columns 8j + c <= done are handled
            while (true) {
              __syncwarp();  // the quad has read the slots of the last round
              uint32_t at = row_slots;
#pragma unroll
              for (int j = 0; j < 32; ++j)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                  const float x = acc[4 * j + 2 * i + c];
                  const bool pick = take(x, 8 * j + c) && 8 * j + c > done;
                  st_shared_if(pick && at < row_slots_end, at, x, 8 * j + c);
                  at += pick ? SLOT_STRIDE : 0;
                }
              const int n_cand = (at - row_slots) / SLOT_STRIDE;
              const int n_take = min(n_cand, WIDE_SLOTS);
              __syncwarp();
              // The quad's queue: lane 0's candidates, then lane 1's, ...
              Walk& w = walk[i];
              w.p1 = __shfl_sync(FULL_MASK, n_take, quad);
              w.p2 = w.p1 + __shfl_sync(FULL_MASK, n_take, quad + 1);
              w.p3 = w.p2 + __shfl_sync(FULL_MASK, n_take, quad + 2);
              w.total = w.p3 + __shfl_sync(FULL_MASK, n_take, quad + 3);
              w.steps = __reduce_max_sync(FULL_MASK, w.total);
              w.k = 0;
              if (!__any_sync(FULL_MASK, n_cand > WIDE_SLOTS)) break;
              while (w.k < w.steps) walk_step(i);
              if (n_cand > WIDE_SLOTS) {
                float x;
                ld_shared(row_slots + (WIDE_SLOTS - 1) * SLOT_STRIDE, x, done);
              } else {
                done = BN;
              }
              raise();
            }
          };
          if (__all_sync(FULL_MASK, top_v[i][0] == -INFINITY)) {
            // ---- every list of the warp empty (a span's first tile).  A
            // walk through the quad would take each of the ~90 columns a
            // floor lets in, one shuffle chain a column.  Instead each lane
            // takes its own top-KMAX of its 64 columns as the short list
            // does (ids ascend within a lane, so a strict > keeps the
            // lowest id among ties) ...
            float lane_cut = -INFINITY;
            int done = -1;
            while (true) {
              __syncwarp();
              uint32_t at = row_slots;
#pragma unroll
              for (int j = 0; j < 32; ++j)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                  const float x = acc[4 * j + 2 * i + c];
                  const bool pick = x > lane_cut && 8 * j + c > done;
                  st_shared_if(pick && at < row_slots_end, at, x, 8 * j + c);
                  at += pick ? SLOT_STRIDE : 0;
                }
              const int n_cand = (at - row_slots) / SLOT_STRIDE;
              const int n_take = min(n_cand, WIDE_SLOTS);
              for (int k = 0; k < n_take; ++k) {
                float x;
                int jc;
                ld_shared(row_slots + k * SLOT_STRIDE, x, jc);
                topk_insert(top_v[i], top_i[i], x, base + jc);
              }
              if (!__any_sync(FULL_MASK, n_cand > WIDE_SLOTS)) break;
              if (n_cand > WIDE_SLOTS) {
                float x;
                ld_shared(row_slots + (WIDE_SLOTS - 1) * SLOT_STRIDE, x, done);
              } else {
                done = BN;
              }
              lane_cut = top_v[i][KMAX - 1];
            }
            // ... the quad's four lists become its one list by rank: lane
            // q's entry p goes to rank p + (the other lanes' entries ahead
            // of it; two empty entries by lane), through the quad's slots
            // of that rank, read back as ranks KMAX q .. KMAX q + KMAX - 1
            // ...
            const float own_v = top_v[i][KMAX - 1];
            const int own_i = top_i[i][KMAX - 1];
            int rank[KMAX];
#pragma unroll
            for (int p = 0; p < KMAX; ++p) rank[p] = p;
#pragma unroll 1
            for (int dq = 1; dq < 4; ++dq) {
              const int other = (q + dq) & 3;
#pragma unroll
              for (int p2 = 0; p2 < KMAX; ++p2) {
                const float ov =
                    __shfl_sync(FULL_MASK, top_v[i][p2], quad + other);
                const int oi =
                    __shfl_sync(FULL_MASK, top_i[i][p2], quad + other);
#pragma unroll
                for (int p = 0; p < KMAX; ++p)
                  rank[p] += ahead(ov, oi, top_v[i][p], top_i[i][p]) ||
                             (other < q && ov == top_v[i][p] &&
                              oi == top_i[i][p]);
              }
            }
            __syncwarp();
#pragma unroll
            for (int p = 0; p < KMAX; ++p)
              st_shared_if(true,
                           slots + ((threadIdx.x & ~3) + rank[p] / KMAX) * 8 +
                               (i * WIDE_SLOTS + rank[p] % KMAX) * SLOT_STRIDE,
                           top_v[i][p], top_i[i][p]);
            __syncwarp();
#pragma unroll
            for (int p = 0; p < KMAX; ++p)
              ld_shared(row_slots + p * SLOT_STRIDE, top_v[i][p], top_i[i][p]);
            // ... and the tile's columns it may still lack go in: a column
            // of the true top-KMAX_WIDE missing from it lies behind its
            // lane's own KMAX-th entry (it is in no lane's list) and ahead
            // of the list's last (which then is no top entry): a few.
            float lo_v = __shfl_sync(FULL_MASK, top_v[i][KMAX - 1], quad + 3);
            int lo_i = __shfl_sync(FULL_MASK, top_i[i][KMAX - 1], quad + 3);
            if (lo_v == -INFINITY) lo_i = -1;  // finite columns only
            rounds(
                [&](float x, int jc) {
                  return ahead(x, base + jc, lo_v, lo_i) &&
                         ahead(own_v, own_i, x, base + jc);
                },
                [&]() {
                  lo_v = __shfl_sync(FULL_MASK, top_v[i][KMAX - 1], quad + 3);
                  lo_i = __shfl_sync(FULL_MASK, top_i[i][KMAX - 1], quad + 3);
                  if (lo_v == -INFINITY) lo_i = -1;
                });
          } else {
            // Every entry has a lower id than this tile's columns, so a
            // value at or below the list's last cannot enter.
            float cut = __shfl_sync(FULL_MASK, top_v[i][KMAX - 1], quad + 3);
            // Until the list is full its cut is -inf.  A floor from the
            // tile itself: the least of the quad's 32 group maxima, each
            // over 8 of a lane's columns, has 32 columns of this tile at or
            // above it, so a value below it cannot enter either.  (In a
            // refill the columns the ceiling hides are -inf here, so the 32
            // are columns the list may take.)
            float floor_cut = -INFINITY;
            if (__any_sync(FULL_MASK, cut == -INFINITY)) {
              float least = INFINITY;
#pragma unroll
              for (int g = 0; g < 8; ++g) {
                float group = -INFINITY;
#pragma unroll
                for (int j = 4 * g; j < 4 * g + 4; ++j)
#pragma unroll
                  for (int c = 0; c < 2; ++c)
                    group = fmaxf(group, acc[4 * j + 2 * i + c]);
                least = fminf(least, group);
              }
              least = fminf(least, __shfl_xor_sync(FULL_MASK, least, 1));
              least = fminf(least, __shfl_xor_sync(FULL_MASK, least, 2));
              // x > floor_cut keeps x == least, whose ties the list orders.
              floor_cut = nextafterf(least, -INFINITY);
              cut = fmaxf(cut, floor_cut);
            }
            if (__any_sync(FULL_MASK, tile_max > cut)) {
              rounds([&](float x, int) { return x > cut; },
                     [&]() {
                       // A later column of this tile may tie the list's
                       // last entry with a lower id: from the cut on, ties
                       // included.
                       cut = fmaxf(floor_cut,
                                   nextafterf(__shfl_sync(FULL_MASK,
                                                          top_v[i][KMAX - 1],
                                                          quad + 3),
                                              -INFINITY));
                     });
            }
          }
        }
#endif  // LENS_ANATOMY_SKIP_TOPK
      }
#else
      // Measurement build (perf/lens_anatomy.py): the product alone.
      run_max[0] = fmaxf(run_max[0], acc[0] + acc[127]);
#endif  // LENS_ANATOMY_SKIP_FOLD
    }

    if constexpr (L == KMAX_WIDE) {
      flush_walks();
      if (spread && !span.whole()) {
        // ---- a piece of the unit: its lists into slot m + b; the block
        // whose tiles complete the unit merges the pieces into its lists.
        const size_t slot = (size_t)(span.m + blockIdx.x);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const size_t at =
              (slot * BM + (rows[i] - row_tile * BM)) * KMAX_WIDE + KMAX * q;
#pragma unroll
          for (int p = 0; p < KMAX; ++p) {
            scratch.piece_vals[at + p] = top_v[i][p];
            scratch.piece_ids[at + p] = top_i[i][p];
          }
        }
        __threadfence();
        asm volatile("bar.sync 1, %0;" ::"n"(CONSUMER_THREADS) : "memory");
        __shared__ int merges;
        if (threadIdx.x == 0) {
          const int done = span.upto - span.first;
          const int unit = chunk * row_tiles + row_tile;
          merges = atomicAdd(scratch.tickets + unit, done) + done == span.items;
        }
        asm volatile("bar.sync 1, %0;" ::"n"(CONSUMER_THREADS) : "memory");
        if (merges) {
          __threadfence();
          const int items = work.items();
          const int s0 = work.start(span.m);
          const int b0 = refill::block_of(s0, items, gridDim.x);
          const int b1 =
              refill::block_of(s0 + span.items - 1, items, gridDim.x);
          for (int r = warp; r < BM && row_tile * BM + r < n;
               r += CONSUMER_WARPS) {
            const size_t first =
                ((size_t)(span.m + b0) * BM + r) * KMAX_WIDE;
            const size_t at =
                ((size_t)chunk * n + row_tile * BM + r) * KMAX_WIDE;
            refill::merge_pieces(scratch.piece_vals + first,
                                 scratch.piece_ids + first,
                                 (size_t)BM * KMAX_WIDE, b0, b1 - b0 + 1,
                                 items, gridDim.x, part_vals + at,
                                 part_ids + at, lane);
          }
        }
        // The flag is read; the next span's round may set it again.
        asm volatile("bar.sync 1, %0;" ::"n"(CONSUMER_THREADS) : "memory");
        continue;
      }
    }

    // ---- merge the quad's four states and write the chunk's partials.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool valid = rows[i] < n;
      const size_t out = (size_t)chunk * n + rows[i];
      float m = run_max[i];
      m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, 1));
      m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, 2));
      float s = run_sum[i] * exp2f((run_max[i] - m) * LOG2E);
      s += __shfl_xor_sync(FULL_MASK, s, 1);
      s += __shfl_xor_sync(FULL_MASK, s, 2);
      float tv = run_tgt[i];
      tv = fmaxf(tv, __shfl_xor_sync(FULL_MASK, tv, 1));
      tv = fmaxf(tv, __shfl_xor_sync(FULL_MASK, tv, 2));
      if (q == 0 && valid) {
        part_max[out] = m;
        part_sumexp[out] = s;
        part_tgt[out] = tv;
      }
      if constexpr (L == KMAX) {
#pragma unroll
        for (int r = 0; r < KMAX; ++r) {
          float bv = top_v[i][0];
          int bi = top_i[i][0];
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            const float ov = __shfl_xor_sync(FULL_MASK, bv, off);
            const int oi = __shfl_xor_sync(FULL_MASK, bi, off);
            if (ov > bv || (ov == bv && oi < bi)) {
              bv = ov;
              bi = oi;
            }
          }
          if (top_i[i][0] == bi) topk_pop(top_v[i], top_i[i]);
          if (q == 0 && valid && r < k_top) {
            part_vals[out * k_top + r] = bv;
            part_ids[out * k_top + r] = bi;
          }
        }
      } else {
        // The quad's list is one already: lane q writes its ranks.
#pragma unroll
        for (int p = 0; p < KMAX; ++p) {
          const int r = KMAX * q + p;
          if (valid && r < k_top) {
            part_vals[out * k_top + r] = top_v[i][p];
            part_ids[out * k_top + r] = top_i[i][p];
          }
        }
      }
    }
    }  // spans
  }
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

// A tensor map over `planes` row-major [rows, cols] matrices of `dtype`
// (a DTYPE_* code) one after the other, boxes of planes x box_rows x one row
// (BK bf16 or f16, F32_BK f32) swizzled over the row; reads past an edge are
// zero.
CUresult make_map(CUtensorMap* map, const void* base, int rows, int cols,
                  int box_rows, int dtype, int planes = 1) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const bool f32 = dtype == DTYPE_F32;
  const cuuint64_t bytes = f32 ? 4 : 2;
  const cuuint32_t row = f32 ? F32_ROW : 128;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * bytes,
                                 (cuuint64_t)cols * bytes * rows};
  const cuuint32_t box[3] = {(cuuint32_t)(row / bytes), (cuuint32_t)box_rows,
                             (cuuint32_t)planes};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map,
                f32                   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : dtype == DTYPE_F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                planes > 1 ? 3 : 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                row == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                : row == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename T, bool CAP, int L>
int launch(const CUtensorMap& mx, const CUtensorMap& me, const int* targets,
           float* part_max, float* part_sumexp, float* part_tgt,
           float* part_vals, int* part_ids, int n, int d, int v, int k_top,
           int n_chunks, float cap, const long long* ceiling,
           const refill::Scratch& scratch, int grid, cudaStream_t stream) {
  auto kernel = lens_wgmma_kernel<T, CAP, L>;
  constexpr int bytes = tf32::is_f32<T> ? F32_SMEM_BYTES : SMEM_BYTES;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int row_tiles = (n + BM - 1) / BM;
  kernel<<<ceiling != nullptr ? grid : row_tiles * n_chunks, THREADS, bytes,
           stream>>>(mx, me, targets, part_max, part_sumexp, part_tgt,
                     part_vals, part_ids, n, d, v, k_top, n_chunks, cap,
                     ceiling, scratch);
  return static_cast<int>(cudaGetLastError());
}

// The arguments of tbx_lens_wgmma, which checks them.
#define WGMMA_PARAMS                                                          \
  const void *x, const void *e, void *x_split, const int *targets,            \
      float *part_max, float *part_sumexp, float *part_tgt, float *part_vals, \
      int *part_ids, int n, int d, int v, int k_top, int list_len,            \
      int n_chunks, int has_cap, int dtype, float cap, void *stream,          \
      const long long *ceiling, int *work, float *piece_vals,                 \
      int *piece_ids, int *tickets, int grid
#define WGMMA_ARGS                                                           \
  x, e, x_split, targets, part_max, part_sumexp, part_tgt, part_vals,        \
      part_ids, n, d, v, k_top, list_len, n_chunks, has_cap, dtype, cap,     \
      stream, ceiling, work, piece_vals, piece_ids, tickets, grid

// One launch in the input type T (float: x split first into x_split).
template <typename T>
int launch_typed(WGMMA_PARAMS) {
  constexpr bool F32 = tf32::is_f32<T>;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap mx, me;
  CUresult cr = F32 ? make_map(&mx, x_split, n, d, BM, DTYPE_F32, 2)
                    : make_map(&mx, x, n, d, BM, dtype_code<T>);
  if (cr != CUDA_SUCCESS) return -static_cast<int>(cr);
  cr = make_map(&me, e, v, d, BN, dtype_code<T>);
  if (cr != CUDA_SUCCESS) return -static_cast<int>(cr);
  if constexpr (F32) {
    const cudaError_t rc = tf32::split_rows(static_cast<const float*>(x),
                                            static_cast<float*>(x_split), n, d,
                                            s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  if (ceiling != nullptr) {
    // A refill: the work list of its (chunk, row tile) units and tiles.
    const refill::Geometry g{n, (n + BM - 1) / BM, BM, n_chunks,
                             (v + BN - 1) / BN};
    const cudaError_t rc = refill::launch_plan(ceiling, g, work, s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const refill::Scratch scratch{work, piece_vals, piece_ids, tickets};
  auto run = list_len == KMAX ? (has_cap ? &launch<T, true, KMAX>
                                         : &launch<T, false, KMAX>)
                              : (has_cap ? &launch<T, true, KMAX_WIDE>
                                         : &launch<T, false, KMAX_WIDE>);
  return run(mx, me, targets, part_max, part_sumexp, part_tgt, part_vals,
             part_ids, n, d, v, k_top, n_chunks, cap, ceiling, scratch, grid,
             s);
}

}  // namespace

extern "C" {

// The f32 and f16 parts of tbx_lens_wgmma, which checks the arguments, each
// in its own unit.
int tbx_wgmma_launch_f32(WGMMA_PARAMS);
int tbx_wgmma_launch_f16(WGMMA_PARAMS);

#if LENS_WGMMA_UNIT == 0 || LENS_WGMMA_UNIT == 2
int tbx_wgmma_launch_f32(WGMMA_PARAMS) { return launch_typed<float>(WGMMA_ARGS); }
#endif
#if LENS_WGMMA_UNIT == 0 || LENS_WGMMA_UNIT == 3
int tbx_wgmma_launch_f16(WGMMA_PARAMS) { return launch_typed<__half>(WGMMA_ARGS); }
#endif

#if LENS_WGMMA_UNIT == 0 || LENS_WGMMA_UNIT == 1

// Tile geometry, checked by the wrapper against its own plan.
int tbx_wgmma_block_rows() { return BM; }
int tbx_wgmma_block_cols() { return BN; }
int tbx_wgmma_kmax() { return KMAX; }
int tbx_wgmma_kmax_wide() { return KMAX_WIDE; }
int tbx_wgmma_smem_bytes() { return SMEM_BYTES; }
int tbx_wgmma_f32_smem_bytes() { return F32_SMEM_BYTES; }
// The input types instantiated, as a mask of their dtype codes: bit 0
// bf16, bit 1 f32 (3xTF32), bit 2 f16.
int tbx_wgmma_dtypes() { return DTYPE_BF16 | DTYPE_F32 | DTYPE_F16; }

// Negative codes are -(CUresult) of a refused tensor map.
const char* tbx_wgmma_error_string(int code) {
  if (code < 0) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch one pass on `stream`.  x [n, d] and e [v, d] row-major, both of
// the type `dtype` codes (DTYPE_BF16, DTYPE_F32 or DTYPE_F16), 16-byte
// aligned, d % 8 == 0 (d % 4 == 0 in f32); x_split
// [2, n, d] f32 scratch for the split of x (f32 only; written here first);
// targets [n] int32 (-1 = none); list_len KMAX or KMAX_WIDE, the
// instantiation's list length, and 1 <= k_top <= list_len;
// 1 <= n_chunks <= ceil(v / BN).  Outputs [n_chunks, n] and
// [n_chunks, n, k_top] as in the file header.  ceiling: null, or for a
// refill of the long list (list_len == k_top == KMAX_WIDE) the
// [n_chunks, n] keys below which each pair lists; a refill's max, sum-exp
// and target partials are not read.  A refill runs on `grid` blocks with
// its scratch (refill_work.cuh), for U = n_chunks * ceil(n / BM) units:
// work [3 + 3 U] ints, piece_vals and piece_ids [U + grid, BM, KMAX_WIDE],
// tickets [U] ints, 0 at launch.  It lists only the pairs its ceilings
// leave open.
int tbx_lens_wgmma(WGMMA_PARAMS) {
  if (n < 1 || (list_len != KMAX && list_len != KMAX_WIDE) || k_top < 1 ||
      k_top > list_len || n_chunks < 1 || n_chunks > (v + BN - 1) / BN ||
      (dtype == DTYPE_F32 && (x_split == nullptr || d % 4 != 0)) ||
      (ceiling != nullptr &&
       (list_len != KMAX_WIDE || k_top != KMAX_WIDE || work == nullptr ||
        piece_vals == nullptr || piece_ids == nullptr || tickets == nullptr ||
        grid < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case DTYPE_BF16: return launch_typed<__nv_bfloat16>(WGMMA_ARGS);
    case DTYPE_F32: return tbx_wgmma_launch_f32(WGMMA_ARGS);
    case DTYPE_F16: return tbx_wgmma_launch_f16(WGMMA_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif

}  // extern "C"
