// Shared by K4's kernels (ssd_chunk.cu) and its gradient K4b
// (ssd_chunk_bwd.cu): a warp's cumsum of the log decays over a chunk.
#pragma once

#include <cuda_runtime.h>

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

}  // namespace repro
