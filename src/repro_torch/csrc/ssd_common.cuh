// Shared by K4's kernels (ssd_chunk.cu) and its gradient K4b
// (ssd_chunk_bwd.cu): a warp's cumsum of the log decays over a chunk, and
// the pieces of a register-built wgmma A operand (fp32 values as a sum of
// bf16 parts, ldmatrix).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

// One warp writes cs[i] = sum(a[0 .. i]) for i < n, with a = 0 at or past
// `valid`: each lane sums one contiguous segment, then a warp scan adds the
// segments before it.
__device__ __forceinline__ void warp_cumsum(float* cs, const float* a, long long ast, int n,
                                            int valid, int lane) {
  const int seg = (n + 31) / 32;
  const int lo = min(lane * seg, n);
  const int hi = min(lo + seg, n);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += i < valid ? a[i * ast] : 0.f;
    cs[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  const float before = incl - run;
  for (int i = lo; i < hi; ++i) cs[i] += before;
}

// (v0, v1) as NP packed bf16 pairs, parts[k][t][r], whose sum is (v0, v1)
// to 8 more bits per part: each part is the bf16 rounding of what the
// parts before it leave.
template <int NP, int T>
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t (&parts)[NP][T][4],
                                           int t, int r) {
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    parts[k][t][r] = *reinterpret_cast<const uint32_t*>(&h);
    v0 -= __low2float(h);
    v1 -= __high2float(h);
  }
}

// Keep a register A operand's registers live up to the wait that ends the
// wgmma reading them, so the compiler does not reuse them while it runs.
template <int NP, int T>
__device__ __forceinline__ void fence_operand(uint32_t (&parts)[NP][T][4]) {
#pragma unroll
  for (int k = 0; k < NP; ++k)
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(parts[k][t][r])::"memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// Four 8 x 8 bf16 matrices, not transposed: with lane l addressing row
// 16 w + (l % 16), 16-byte chunk l / 16 of a k-step, r is the A fragment
// of warp w's 16 rows of a 64-row operand (wgmma's register A layout).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

}  // namespace repro
