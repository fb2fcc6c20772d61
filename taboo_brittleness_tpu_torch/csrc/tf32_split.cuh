// The 3xTF32 split shared by the f32 instantiations of the Hopper lens
// kernels (lens_stats_wgmma.cu, lens_stats_splitv.cu).
//
// A TF32 tensor-core product keeps 11 bits of each operand, ~1e-3 relative:
// too coarse for f32's readout.  Each f32 operand v is split into
//
//   hi = v rounded to 11 significant bits (round to nearest, ties away from
//        zero: add half the dropped unit, clear the low 13 mantissa bits),
//   lo = (v - hi) rounded the same way (v - hi is exact in f32),
//
// both exact TF32 values, and x . e is taken as hi_x . hi_e + lo_x . hi_e +
// hi_x . lo_e in one f32 accumulator.  The dropped lo_x . lo_e and lo's own
// rounding are each ~2^-22 of the product, f32's order.  Both operands are
// rounded here, so nothing rests on how the tensor core treats the low 13
// bits of an f32 operand.  tests/test_torch_tf32_split.py is the CPU model of
// this arithmetic.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// Whether a kernel's input type T takes the 3xTF32 path.
template <typename T>
constexpr bool is_f32 = false;
template <>
constexpr bool is_f32<float> = true;

// v rounded to TF32 (11 significant bits), as an f32 with its low 13 bits 0.
__device__ __forceinline__ float nearest(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ void split(float v, float& hi, float& lo) {
  hi = nearest(v);
  lo = nearest(v - hi);
}

// x [n4 float4s] -> hi [n4], lo [n4]: the rows of x split once per call, so
// that a kernel's TMA loads both halves instead of splitting every tile.
__global__ void split_kernel(const float4* __restrict__ x,
                             float4* __restrict__ hi, float4* __restrict__ lo,
                             long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    float4 h, l;
    split(v.x, h.x, l.x);
    split(v.y, h.y, l.y);
    split(v.z, h.z, l.z);
    split(v.w, h.w, l.w);
    hi[i] = h;
    lo[i] = l;
  }
}

// Launch split_kernel on `stream` over n * d floats (d % 4 == 0): hi into
// out[0, n * d), lo into out[n * d, 2 * n * d).
inline cudaError_t split_rows(const float* x, float* out, int n, int d,
                              cudaStream_t stream) {
  const long long n4 = (long long)n * d / 4;
  const int threads = 256;
  const long long want = (n4 + threads - 1) / threads;
  const int blocks = (int)(want < 1024 ? want : 1024);
  split_kernel<<<blocks, threads, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out),
      reinterpret_cast<float4*>(out) + n4, n4);
  return cudaGetLastError();
}

// Split the 16 bytes at shared address `at`: hi back in place, lo at `lo_at`.
// The caller's layout (swizzle included) is the same for both tiles, so the
// split works element by element without knowing it.
__device__ __forceinline__ void split_shared16(uint32_t at, uint32_t lo_at) {
  float a, b, c, d;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(a), "=f"(b), "=f"(c), "=f"(d)
               : "r"(at)
               : "memory");
  float ha, hb, hc, hd, la, lb, lc, ld;
  split(a, ha, la);
  split(b, hb, lb);
  split(c, hc, lc);
  split(d, hd, ld);
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(at), "f"(ha),
               "f"(hb), "f"(hc), "f"(hd)
               : "memory");
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(lo_at),
               "f"(la), "f"(lb), "f"(lc), "f"(ld)
               : "memory");
}

// Makes this thread's shared-memory stores visible to the async proxy
// (wgmma's operand reads) once a barrier orders them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

}  // namespace tf32
