// K3 flash_attention: forward GQA attention for prefill, causal with an
// optional sliding window (key t visible to query position p when t <= p
// and t > p - window) and a query offset, online softmax in fp32.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py:flash_attention
// (Pallas; grid (B, H, nQ, nK) with the running max / denominator /
// accumulator carried in VMEM scratch across the sequential KV axis).
//
// Bound on the H100: operations at long prompts (causal 2 * B * H * S^2 * D
// multiply-adds over the 989 TFLOP/s bf16 tensor-core peak), bytes at
// short ones (q, k, v read once and o written once over 3.35 TB/s).
//
// Design: one block per (q tile of 32 rows, head, batch); the KV head is
// h / (H / G). The TPU's sequential KV grid axis becomes a loop inside the
// block: each 32-key tile of K and V is staged in shared memory as fp32
// and used by all 32 rows (8 warps x 4 rows); a warp scores one key per
// lane and keeps its rows' running max, denominator and accumulator in
// registers. Tiles wholly above the causal diagonal or wholly outside the
// window are never loaded. Ragged Sq and T are masked here, so any length
// works (no power-of-two block search). This first version runs on the
// CUDA cores; wgmma tiles fed by TMA are the later step toward the bound.
#include "attention_common.cuh"

namespace {

using namespace repro;

constexpr int kRowsPerWarp = 4;
constexpr int kTileQ = kWarps * kRowsPerWarp;

template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int H, int G, int Sq, int Tk, int D,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kst, long long ksg,
                 long long vsb, long long vst, long long vsg,
                 long long osb, long long oss, long long osh,
                 int causal, int window, int q_offset, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                        // kTileQ x D
  float* ks = qs + kTileQ * D;             // kTileK x (D + 1)
  float* vs = ks + kTileK * (D + 1);       // kTileK x D

  const int q0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + g * ksg;
  const T* vb = v + b * vsb + g * vsg;

  for (int idx = threadIdx.x; idx < kTileQ * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int sq = q0 + r;
    qs[idx] = sq < Sq ? to_float(qb[sq * qss + d]) : 0.f;
  }

  // Keys any row of this tile can see.
  const int p_lo = q0 + q_offset;
  const int p_hi = min(q0 + kTileQ, Sq) - 1 + q_offset;
  int k_end = Tk;
  if (causal) k_end = min(k_end, p_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, p_lo - window + 1);
  k_begin = (k_begin / kTileK) * kTileK;

  RowState<DPL> st[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) row_init(st[rr]);

  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
    __syncthreads();  // the previous tile (and, first time, q) is consumed/ready
    load_kv_tile(ks, vs, kb, vb, kst, vst, k0, Tk, D);
    __syncthreads();
    const int nkeys = min(kTileK, Tk - k0);
    const int t = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int sq = q0 + r;
      if (sq < Sq) {  // uniform across the warp
        const int p = sq + q_offset;
        bool valid = t < Tk;
        if (causal) valid = valid && t <= p;
        if (window > 0) valid = valid && t > p - window;
        row_tile<DPL>(st[rr], qs + r * D, ks, vs, D, valid, scale, lane, nkeys);
      }
    }
  }

  T* ob = o + b * osb + h * osh;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int sq = q0 + warp * kRowsPerWarp + rr;
    if (sq >= Sq) continue;
    const float inv = 1.f / fmaxf(st[rr].l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) ob[sq * oss + d] = from_float<T>(st[rr].acc[i] * inv);
    }
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int G,
           int Sq, int Tk, int D, const long long* s, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(kTileQ * D + kTileK * (D + 1) + kTileK * D);
  auto kernel = flash_fwd_kernel<T, DPL>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kTileQ - 1) / kTileQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, G, Sq, Tk, D,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
      causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int H, int G,
             int Sq, int Tk, int D, const long long* s, int causal, int window,
             int q_offset, float scale, cudaStream_t stream) {
  switch ((D + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, B, H, G, Sq, Tk, D, s, causal, window, q_offset, scale, stream);
    case 2: return launch<T, 2>(q, k, v, o, B, H, G, Sq, Tk, D, s, causal, window, q_offset, scale, stream);
    case 3: return launch<T, 3>(q, k, v, o, B, H, G, Sq, Tk, D, s, causal, window, q_offset, scale, stream);
    case 4: return launch<T, 4>(q, k, v, o, B, H, G, Sq, Tk, D, s, causal, window, q_offset, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, in the order
// q (b, s, h), k (b, t, g), v (b, t, g), o (b, s, h); the last dim of every
// tensor is contiguous.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int dtype, int B, int H, int G, int Sq, int Tk, int D,
                                      long long qsb, long long qss, long long qsh,
                                      long long ksb, long long kst, long long ksg,
                                      long long vsb, long long vst, long long vsg,
                                      long long osb, long long oss, long long osh,
                                      int causal, int window, int q_offset, float scale,
                                      void* stream) {
  const long long s[12] = {qsb, qss, qsh, ksb, kst, ksg, vsb, vst, vsg, osb, oss, osh};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, H, G, Sq, Tk, D, s, causal, window, q_offset, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, G, Sq, Tk, D, s, causal, window, q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}
