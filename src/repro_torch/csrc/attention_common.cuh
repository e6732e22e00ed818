// Shared pieces of the attention kernels (K2 decode, K3 prefill): dtype
// conversion, warp reductions, and the online-softmax update of one query
// row against one 32-key tile staged in shared memory.
//
// Layout of a row's state over a warp: lane l keeps output dims l, l+32,
// ... (DPL of them, D <= 32 * DPL); the running max m and denominator l are
// replicated in every lane. Scores are computed one key per lane, all in
// fp32, so the kernels keep fp32 from the loaded inputs to the final
// division.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float kNegInf = -1e30f;  // the JAX kernels' NEG_INF
constexpr int kTileK = 32;         // keys per tile: one per lane
constexpr int kWarps = 8;          // warps per block
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DPL>
struct RowState {
  float m;
  float l;
  float acc[DPL];
};

template <int DPL>
__device__ __forceinline__ void row_init(RowState<DPL>& st) {
  st.m = kNegInf;
  st.l = 0.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i) st.acc[i] = 0.f;
}

// Stage keys [k0, k0 + kTileK) of one KV head into shared memory as fp32:
// ks with row stride D + 1 (so lane j reading key j, dim d hits distinct
// banks), vs with row stride D. Keys at or past `k_stop` are zero-filled.
template <typename T>
__device__ __forceinline__ void load_kv_tile(float* ks, float* vs, const T* k, const T* v,
                                             long long kst, long long vst, int k0,
                                             int k_stop, int D) {
  for (int idx = threadIdx.x; idx < kTileK * D; idx += blockDim.x) {
    const int j = idx / D;
    const int d = idx - j * D;
    const int t = k0 + j;
    float kv = 0.f, vv = 0.f;
    if (t < k_stop) {
      kv = to_float(k[t * kst + d]);
      vv = to_float(v[t * vst + d]);
    }
    ks[j * (D + 1) + d] = kv;
    vs[j * D + d] = vv;
  }
}

// Online-softmax update of one row with the staged tile. `valid` says
// whether this lane's key is unmasked; `nkeys` keys of the tile exist.
// Masked scores are set to kNegInf exactly as the JAX kernels do, so a row
// whose first tiles are wholly masked is reset (alpha = 0) once a valid key
// arrives.
template <int DPL>
__device__ __forceinline__ void row_tile(RowState<DPL>& st, const float* qrow,
                                         const float* ks, const float* vs, int D,
                                         bool valid, float scale, int lane, int nkeys) {
  const float* krow = ks + lane * (D + 1);
  float s = 0.f;
  for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
  s = valid ? s * scale : kNegInf;
  const float m_new = fmaxf(st.m, warp_max(s));
  const float alpha = __expf(st.m - m_new);
  const float p = __expf(s - m_new);
  st.l = st.l * alpha + warp_sum(p);
#pragma unroll
  for (int i = 0; i < DPL; ++i) st.acc[i] *= alpha;
  for (int j = 0; j < nkeys; ++j) {
    const float pj = __shfl_sync(0xffffffffu, p, j);
    const float* vrow = vs + j * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) st.acc[i] = fmaf(pj, vrow[d], st.acc[i]);
    }
  }
  st.m = m_new;
}

// Raise a kernel's dynamic shared-memory limit when it needs more than the
// default 48 KB (only D = 128 with many rows does).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace repro
