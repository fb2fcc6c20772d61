// Fused logit-lens statistics for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package: ops/pallas_lens.py,
// `_lens_tile_kernel` launched by `lens_stats`.  For rows x [N, D] (final-normed
// residuals) and the tied embedding E [V, D] it emits, per vocab tile of BV
// columns and per row, the partials that one small torch epilogue
// (ops/lens_kernel.py) merges into logsumexp, target logit and top-k:
//
//   logits = x @ E[tile]^T            (f32 accumulate; bf16 on tensor cores)
//   logits = tanh(logits / cap) * cap  [only when has_cap]
//   tile_max[t, n]    = max over the tile's columns
//   tile_sumexp[t, n] = sum exp(logit - tile_max)          (flash-style)
//   tile_tgt[t, n]    = logit of targets[n] if it falls in tile t, else -1e30
//   cand_vals/ids[t, n, :K] = the tile's top-K logits and their global vocab
//                             ids, lowest id first among equal values
//
// so the [N, V] logits never reach device memory.
//
// What bounds it: at the main path's shape (N ~ 1140, D = 3584, V = 256000,
// bf16) one launch is 2*N*D*V ~ 2.1 TFLOP against a 1.8 GB read of E: about
// 2.1 ms of tensor-core time versus 0.55 ms of HBM time, so it is bound by
// the matrix product.  The design keeps the product on the tensor cores
// (WMMA bf16 16x16x16, f32 accumulate) and makes E cross HBM once: blockIdx.x
// walks the row tiles of one vocab tile before blockIdx.y moves to the next,
// so the ~18 blocks that share an E tile run together and read it from L2,
// and x (8 MB) stays in L2 throughout.  The per-tile reductions run out of
// shared memory on the block's own logits tile.  This is the simple first
// version: no cp.async/TMA pipeline and no wgmma, so the loads do not overlap
// the math (see PERF.md for its time against its bound).
//
// TPU artifacts that do not carry over: the sequential vocab-outer grid (blocks
// here run in parallel and carry nothing between them) and the 8-row sublane
// pad on the outputs.
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes.  The launcher returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;        // rows per block
constexpr int BV = 128;       // vocab columns per block (one vocab tile)
constexpr int BK = 32;        // depth of one shared-memory stage
constexpr int THREADS = 256;  // 8 warps
constexpr int CS_LD = BV + 4; // float stride of the block's logits tile
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;

// Row stride (in elements) of the input tiles in shared memory.  The pad
// keeps 16-byte vector stores aligned and WMMA's ldm a multiple of 16 bytes.
template <typename T>
struct TileLd;
template <>
struct TileLd<__nv_bfloat16> {
  static constexpr int value = BK + 8;
};
template <>
struct TileLd<float> {
  static constexpr int value = BK + 4;
};

// The input tiles (x: BM x BK, E: BV x BK) and the f32 logits tile (BM x BV)
// share one buffer: the logits are written only after the last product.
template <typename T>
struct SmemBytes {
  static constexpr int inputs = (BM + BV) * TileLd<T>::value * (int)sizeof(T);
  static constexpr int logits = BM * CS_LD * (int)sizeof(float);
  static constexpr int value = inputs > logits ? inputs : logits;
};

// Copy one BK-deep stage of x rows [row0, row0 + BM) and E rows
// [col0, col0 + BV) into shared memory, 16 bytes per thread and step.
// Rows past N and depth past D are zero-filled.
template <typename T>
__device__ __forceinline__ void load_stage(const T* __restrict__ x,
                                           const T* __restrict__ e, T* As,
                                           T* Es, int row0, long long col0,
                                           int k0, int n, int d) {
  constexpr int LD = TileLd<T>::value;
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int VPR = BK / VEC;  // vectors per tile row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < BM * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    const int gr = row0 + r;
    const int gk = k0 + c;
    uint4 v = zero;
    if (gr < n && gk < d) {
      v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)gr * d + gk));
    }
    *reinterpret_cast<uint4*>(As + r * LD + c) = v;
  }
  for (int i = threadIdx.x; i < BV * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    const int gk = k0 + c;
    uint4 v = zero;
    if (gk < d) {
      v = __ldg(reinterpret_cast<const uint4*>(e + (size_t)(col0 + r) * d + gk));
    }
    *reinterpret_cast<uint4*>(Es + r * LD + c) = v;
  }
}

// logits tile Cs[BM][CS_LD] = x[row0:row0+BM] @ E[col0:col0+BV]^T in f32.
template <typename T>
__device__ __forceinline__ void tile_product(const T* __restrict__ x,
                                             const T* __restrict__ e,
                                             unsigned char* smem, int row0,
                                             long long col0, int n, int d) {
  constexpr int LD = TileLd<T>::value;
  T* As = reinterpret_cast<T*>(smem);
  T* Es = As + BM * LD;
  float* Cs = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using namespace nvcuda;
    // 8 warps over a 4 x 8 grid of 16x16 fragments: warp w owns fragment
    // row w / 2 and fragment columns (w % 2) * 4 .. + 3.
    const int warp = tid / 32;
    const int wr = warp / 2;
    const int wc = (warp % 2) * 4;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.0f);
    for (int k0 = 0; k0 < d; k0 += BK) {
      load_stage<T>(x, e, As, Es, row0, col0, k0, n, d);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            a;
        wmma::load_matrix_sync(a, As + (wr * 16) * LD + kk, LD);
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          // E rows are the product's columns: E[BV][BK] row-major is
          // B[BK][BV] column-major.
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major>
              b;
          wmma::load_matrix_sync(b, Es + ((wc + f) * 16) * LD + kk, LD);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
      __syncthreads();  // also guards Cs, which aliases As/Es
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      wmma::store_matrix_sync(Cs + (wr * 16) * CS_LD + (wc + f) * 16, acc[f],
                              CS_LD, wmma::mem_row_major);
    }
  } else {
    // f32 inputs: plain FMA, each thread a 4 x 8 patch (rows ty*4 + i,
    // columns tx + 16*j).
    const int ty = tid / 16;
    const int tx = tid % 16;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < d; k0 += BK) {
      load_stage<T>(x, e, As, Es, row0, col0, k0, n, d);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[(ty * 4 + i) * LD + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Es[(tx + 16 * j) * LD + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();  // also guards Cs, which aliases As/Es
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        Cs[(ty * 4 + i) * CS_LD + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    lens_tile_kernel(const T* __restrict__ x, const T* __restrict__ e,
                     const int* __restrict__ targets,
                     float* __restrict__ tile_max,
                     float* __restrict__ tile_sumexp,
                     float* __restrict__ tile_tgt,
                     float* __restrict__ cand_vals,
                     int* __restrict__ cand_ids, int n, int d, int k_top,
                     int has_cap, float cap) {
  __shared__ __align__(128) unsigned char smem[SmemBytes<T>::value];
  const int row0 = blockIdx.x * BM;
  const int tile = blockIdx.y;
  const long long col0 = (long long)tile * BV;

  tile_product<T>(x, e, smem, row0, col0, n, d);

  // Per-row reductions: four consecutive lanes own one row and take its
  // columns sub, sub + 4, ... (conflict-free across the warp's 8 rows).
  float* Cs = reinterpret_cast<float*>(smem);
  const int r = threadIdx.x / 4;
  const int sub = threadIdx.x % 4;
  const int grow = row0 + r;
  float* crow = Cs + r * CS_LD;

  float m = -INFINITY;
  for (int c = sub; c < BV; c += 4) {
    float v = crow[c];
    if (has_cap) {
      v = tanhf(v / cap) * cap;
      crow[c] = v;
    }
    m = fmaxf(m, v);
  }
  m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, 1));
  m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, 2));

  float s = 0.0f;
  for (int c = sub; c < BV; c += 4) s += expf(crow[c] - m);
  s += __shfl_xor_sync(FULL_MASK, s, 1);
  s += __shfl_xor_sync(FULL_MASK, s, 2);
  __syncwarp();  // the row's capped values are visible to its four lanes

  const int tgt = grow < n ? targets[grow] : -1;
  const long long local = (long long)tgt - col0;
  const float tv = (tgt >= 0 && local >= 0 && local < BV) ? crow[local] : NEG_INF;

  const size_t out = (size_t)tile * n + grow;
  if (sub == 0 && grow < n) {
    tile_max[out] = m;
    tile_sumexp[out] = s;
    tile_tgt[out] = tv;
  }

  // Tile top-k by iterative max-and-mask; equal values go to the lower column.
  for (int i = 0; i < k_top; ++i) {
    float bv = -INFINITY;
    int bc = BV;
    for (int c = sub; c < BV; c += 4) {
      const float v = crow[c];
      if (v > bv) {
        bv = v;
        bc = c;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(FULL_MASK, bv, off);
      const int oc = __shfl_xor_sync(FULL_MASK, bc, off);
      if (ov > bv || (ov == bv && oc < bc)) {
        bv = ov;
        bc = oc;
      }
    }
    if (bc < BV && (bc & 3) == sub) crow[bc] = -INFINITY;
    __syncwarp();
    if (sub == 0 && grow < n) {
      cand_vals[out * k_top + i] = bv;
      cand_ids[out * k_top + i] = (int)(col0 + bc);
    }
  }
}

}  // namespace

extern "C" {

// Vocab columns per tile; the caller sizes the [V / BV, ...] partials by it.
int tbx_lens_block_v() { return BV; }

const char* tbx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch one fused lens-stats pass on `stream`.  x [n, d] and e [v, d] are
// row-major, bf16 (is_bf16 = 1) or f32; v % BV == 0; d a multiple of 16 bytes
// of elements; targets [n] int32 (-1 = none); outputs as in the file header.
int tbx_lens_stats(const void* x, const void* e, const int* targets,
                   float* tile_max, float* tile_sumexp, float* tile_tgt,
                   float* cand_vals, int* cand_ids, int n, int d, int v,
                   int k_top, int has_cap, float cap, int is_bf16,
                   void* stream) {
  const dim3 grid((n + BM - 1) / BM, v / BV);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    lens_tile_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(e), targets, tile_max, tile_sumexp,
        tile_tgt, cand_vals, cand_ids, n, d, k_top, has_cap, cap);
  } else {
    lens_tile_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(e), targets,
        tile_max, tile_sumexp, tile_tgt, cand_vals, cand_ids, n, d, k_top,
        has_cap, cap);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
