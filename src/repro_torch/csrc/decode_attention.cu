// K2 decode_attention: flash-decode with GQA. One new query token per
// sequence against its KV cache; R = H / G query heads share each KV head;
// keys at or past kv_len[b] are masked; scale D^-0.5; online softmax in
// fp32 with the denominator clamped at 1e-30.
//
// Replaces: src/repro/kernels/decode_attention/decode_attention.py:decode_attention
// (Pallas; grid (B, G, nK), the R grouped heads as one (R, D) block, state
// carried in VMEM scratch across the sequential KV axis).
//
// Bound on the H100: bytes. A step must read the valid cache once,
// 2 * kv_len * G * D * itemsize bytes per sequence and layer, over
// 3.35 TB/s; the arithmetic is R multiply-adds per loaded element.
//
// Design: B * G blocks alone cannot fill 132 SMs, so the cache is split
// across a (splits, G, B) grid (split-KV) and a second, small kernel
// combines the partial (max, denominator, accumulator) triples. Inside a
// block the R grouped heads are the rows: each 32-key tile of K and V is
// loaded once into shared memory and used by all R heads (one warp per
// head). Blocks whose split starts at or past kv_len exit before loading
// anything, so a step reads only the valid cache, not max_len. Any T works.
// A row with kv_len <= 0 sees no key: every split exits, and the combine
// kernel writes what the plain version gives there, the mean of V over the
// whole cache [0, T) (softmax over uniform -1e30 scores).
#include "attention_common.cuh"

namespace {

using namespace repro;

constexpr int kMaxRowsPerWarp = 4;  // R <= kWarps * kMaxRowsPerWarp = 32

template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    float* __restrict__ m_part, float* __restrict__ l_part,
                    float* __restrict__ acc_part, int H, int G, int Tk, int D,
                    long long qsb, long long qsh, long long ksb, long long kst,
                    long long ksg, long long vsb, long long vst, long long vsg,
                    int n_splits, int split_len, float scale) {
  extern __shared__ float smem[];
  const int split = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int R = H / G;
  const int len = min(kv_len[b], Tk);
  const int s_begin = split * split_len;
  if (s_begin >= len) return;  // uniform over the block, before any barrier
  const int s_end = min(s_begin + split_len, len);

  float* qs = smem;                    // R x D
  float* ks = qs + R * D;              // kTileK x (D + 1)
  float* vs = ks + kTileK * (D + 1);   // kTileK x D
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const T* qb = q + b * qsb + (long long)g * R * qsh;
  for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx - r * D;
    qs[idx] = to_float(qb[r * qsh + d]);
  }
  const T* kb = k + b * ksb + g * ksg;
  const T* vb = v + b * vsb + g * vsg;

  RowState<DPL> st[kMaxRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i) row_init(st[i]);

  for (int k0 = s_begin; k0 < s_end; k0 += kTileK) {
    __syncthreads();
    load_kv_tile(ks, vs, kb, vb, kst, vst, k0, s_end, D);
    __syncthreads();
    const int nkeys = min(kTileK, s_end - k0);
    const bool valid = k0 + lane < s_end;
#pragma unroll
    for (int i = 0; i < kMaxRowsPerWarp; ++i) {
      const int r = warp + i * kWarps;
      if (r < R) row_tile<DPL>(st[i], qs + r * D, ks, vs, D, valid, scale, lane, nkeys);
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxRowsPerWarp; ++i) {
    const int r = warp + i * kWarps;
    if (r >= R) continue;
    const long long idx = ((long long)b * H + g * R + r) * n_splits + split;
    if (lane == 0) {
      m_part[idx] = st[i].m;
      l_part[idx] = st[i].l;
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) acc_part[idx * D + d] = st[i].acc[j];
    }
  }
}

template <typename T>
__global__ void decode_combine_kernel(const int* __restrict__ kv_len,
                                      const float* __restrict__ m_part,
                                      const float* __restrict__ l_part,
                                      const float* __restrict__ acc_part,
                                      const T* __restrict__ v, T* __restrict__ o, int H,
                                      int G, int Tk, int D, long long vsb, long long vst,
                                      long long vsg, long long osb, long long osh,
                                      int n_splits, int split_len) {
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int len = min(kv_len[b], Tk);
  if (len <= 0) {  // no visible key
    const T* vb = v + b * vsb + (h / (H / G)) * vsg;
    for (int d = threadIdx.x; d < D; d += blockDim.x)
      o[b * osb + h * osh + d] = from_float<T>(mean_v(vb, vst, Tk, d));
    return;
  }
  const int active = min(n_splits, (len + split_len - 1) / split_len);
  const float* mp = m_part + (long long)bh * n_splits;
  const float* lp = l_part + (long long)bh * n_splits;
  const float* ap = acc_part + (long long)bh * n_splits * D;
  float m = kNegInf;
  for (int s = 0; s < active; ++s) m = fmaxf(m, mp[s]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < active; ++s) {
      const float w = __expf(mp[s] - m);
      l = fmaf(lp[s], w, l);
      acc = fmaf(ap[(long long)s * D + d], w, acc);
    }
    o[b * osb + h * osh + d] = from_float<T>(acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* k, const void* v, const void* kv_len, void* o,
           void* m_part, void* l_part, void* acc_part, int B, int H, int G, int Tk, int D,
           const long long* s, int n_splits, int split_len, float scale,
           cudaStream_t stream) {
  const int R = H / G;
  const size_t smem = sizeof(float) * (size_t)(R * D + kTileK * (D + 1) + kTileK * D);
  auto kernel = decode_split_kernel<T, DPL>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_splits, G, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)kv_len, (float*)m_part,
      (float*)l_part, (float*)acc_part, H, G, Tk, D, s[0], s[1], s[2], s[3], s[4], s[5],
      s[6], s[7], n_splits, split_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = ((D + 31) / 32) * 32;
  decode_combine_kernel<T><<<B * H, threads, 0, stream>>>(
      (const int*)kv_len, (const float*)m_part, (const float*)l_part,
      (const float*)acc_part, (const T*)v, (T*)o, H, G, Tk, D, s[5], s[6], s[7], s[8],
      s[9], n_splits, split_len);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* kv_len, void* o,
             void* m_part, void* l_part, void* acc_part, int B, int H, int G, int Tk,
             int D, const long long* s, int n_splits, int split_len, float scale,
             cudaStream_t stream) {
  switch ((D + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, kv_len, o, m_part, l_part, acc_part, B, H, G, Tk, D, s, n_splits, split_len, scale, stream);
    case 2: return launch<T, 2>(q, k, v, kv_len, o, m_part, l_part, acc_part, B, H, G, Tk, D, s, n_splits, split_len, scale, stream);
    case 3: return launch<T, 3>(q, k, v, kv_len, o, m_part, l_part, acc_part, B, H, G, Tk, D, s, n_splits, split_len, scale, stream);
    case 4: return launch<T, 4>(q, k, v, kv_len, o, m_part, l_part, acc_part, B, H, G, Tk, D, s, n_splits, split_len, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, in the order
// q (b, h), k (b, t, g), v (b, t, g), o (b, h); the last dim is contiguous.
// m_part and l_part hold B * H * n_splits floats, acc_part that times D.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* kv_len, void* o, void* m_part,
                                       void* l_part, void* acc_part, int dtype, int B,
                                       int H, int G, int Tk, int D, long long qsb,
                                       long long qsh, long long ksb, long long kst,
                                       long long ksg, long long vsb, long long vst,
                                       long long vsg, long long osb, long long osh,
                                       int n_splits, int split_len, float scale,
                                       void* stream) {
  const long long s[10] = {qsb, qsh, ksb, kst, ksg, vsb, vst, vsg, osb, osh};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, kv_len, o, m_part, l_part, acc_part, B, H, G, Tk, D, s, n_splits, split_len, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, kv_len, o, m_part, l_part, acc_part, B, H, G, Tk, D, s, n_splits, split_len, scale, st);
  return (int)cudaErrorInvalidValue;
}
