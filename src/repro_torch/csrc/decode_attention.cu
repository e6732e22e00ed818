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
// 3.35 TB/s; the arithmetic is R multiply-adds per loaded element. At the
// served sizes (a few hundred keys, 4 KV heads) the call is far below a
// microsecond of traffic, so what it costs is launch and latency.
//
// Design: one launch, no scratch in global memory. B * G alone cannot
// fill 132 SMs, so each (KV head, sequence) gets a thread-block cluster of
// C <= 8 blocks along the cache (grid (C, G, B), cluster (C, 1, 1)). Block
// `rank` takes keys [rank * split, (rank + 1) * split) of [0, kv_len[b]),
// split being ceil(kv_len / C) rounded up to whole 32-key tiles, so a
// sequence's work spreads over its cluster whatever its length. Inside a
// block the R grouped heads are the rows, two (four when R > 16) to a warp,
// so each key read from shared memory serves several heads; lane j scores
// key j, fp32 on the CUDA cores (at R = 8 a tensor-core tile would be
// mostly empty, and the call is bound by latency, not arithmetic). When
// the rows need fewer than 8 warps, the spare warps take the next 32-key
// tiles at the same time (up to 4 tiles a step), each warp group with its
// own partial. Keys come in as 16-byte loads into registers, the next
// step's loads in flight while the current one is used. Each warp group
// writes its partial (max, denominator, accumulator) straight into rank
// 0's shared memory through distributed shared memory, so no block waits
// on a remote read; one release/acquire cluster barrier hands the partials
// over, and rank 0 combines them and writes O. (A relaxed cluster barrier,
// arrived at on entry and waited on just before those writes, makes sure
// every block of the cluster has started.) A block whose split starts at
// or past kv_len loads nothing and publishes an empty partial (m = -1e30,
// l = 0), but still reaches every barrier. A row with kv_len <= 0 sees no
// key, and rank 0 writes what the plain version gives there, the mean of
// V over the whole cache [0, T) (softmax over uniform -1e30 scores). Any T
// works; kv_len comes per sequence from a device array, or as one value
// for every sequence.
//
// D runs up to 256 (gemma): a lane keeps up to 8 output dims of each row.
// R is at most 32 up to D = 128 and 16 past it, which keeps both the
// staged q rows and rank 0's partials in shared memory (216 KB at R = 16,
// D = 256, 8 blocks a cluster). Past D = 128 one 32-key tile fills the
// register staging (fp32 takes twice the chunks a thread of bf16 does), so
// a block works on one tile a step.
#include <cooperative_groups.h>
#include <cstdint>

#include "attention_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace repro;

constexpr int kMaxGroup = 32;       // R <= kWarps * 4 up to D = 128
constexpr int kMaxGroupWide = 16;   // R past D = 128, up to kMaxHeadDim
constexpr int kMaxCluster = 8;      // blocks per cluster, the portable limit

constexpr int kMaxKeyGroups = 4;    // 32-key tiles a block works on at once
// Staged q floats per thread: R rows of q_stride(D) floats, at most
// 32 x 128 or 16 x 256 (the two bounds on R above give the same 4096).
// R = 32 at D = 256 would also need rank 0's 8 x 32 partials of 256 floats,
// 264 KB, past the 227 KB a block may have.
constexpr int kMaxQPerThread = kMaxGroup * 128 / kThreads;
static_assert(kMaxGroupWide * kMaxHeadDim == kMaxGroup * 128, "q staging bound");

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// NR: query rows per warp (2, or 4 when R > 16), so each loaded key serves
// NR heads; ceil(R / NR) warps cover the rows. KG such groups of warps work
// on KG consecutive 32-key tiles at once, each keeping its own partial.
template <typename T, int DPL, int NR>
__global__ void __launch_bounds__(kThreads)
decode_cluster_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ kv_len_ptr,
                      int kv_len_val, T* __restrict__ o, int H, int G, int Tk, int D,
                      long long qsb, long long qsh, long long ksb, long long kst,
                      long long ksg, long long vsb, long long vst, long long vsg,
                      long long osb, long long osh, float scale, int vec, int KG) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  // The first cluster barrier only says that every block has started (so
  // its shared memory may be written); it is waited on just before that.
  cluster_arrive_relaxed();
  const int C = gridDim.x;            // the cluster spans the grid's x axis
  const int rank = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int R = H / G;
  const int len = min(kv_len_ptr ? kv_len_ptr[b] : kv_len_val, Tk);
  const int split = len > 0 ? ((len + C - 1) / C + kTileK - 1) / kTileK * kTileK : 0;
  const int s_begin = rank * split;
  const int s_end = min(s_begin + split, len);

  const int QS = q_stride(D), KS = k_stride(D);
  const int wpg = (R + NR - 1) / NR;   // warps per key group
  const int RP = wpg * NR;             // rows padded to whole warps' worth
  const int step = KG * kTileK;        // keys per step
  const int P = C * KG;                // partials per row
  float* qs = smem;                    // RP x QS
  float* ks = qs + RP * QS;            // step x KS
  float* vs = ks + step * KS;          // step x D
  float* pbuf = vs + step * D;         // kWarps x NR x 32: each warp's p
  float* pm = pbuf + kThreads * NR;    // P x R: every partial max (rank 0's copy)
  float* pl = pm + P * R;              // P x R: partial denominators
  float* pacc = pl + P * R;            // P x R x D: partial accumulators
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = warp / wpg;          // key group; warps past KG groups idle
  const int row0 = (warp - grp * wpg) * NR;

  const T* qb = q + b * qsb + (long long)g * R * qsh;
  const T* kb = k + b * ksb + g * ksg;
  const T* vb = v + b * vsb + g * vsg;

  RowState<DPL> st[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) row_init(st[i]);

  if (s_begin < s_end) {  // uniform over the block
    TileRegs<tile_chunks<T, DPL>()> next;   // the first step's loads go out with q's
    if (vec) fetch_tile(next, kb, vb, kst, vst, s_begin, s_end, D, step);
    // q rows (zero in the padded rows and columns): all loads first, then
    // the stores, so the loads are in flight together; and K's pad columns.
    float qv[kMaxQPerThread];
#pragma unroll
    for (int i = 0; i < kMaxQPerThread; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / QS;
      const int d = idx - r * QS;
      qv[i] = idx < RP * QS && r < R && d < D ? to_float(qb[r * qsh + d]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kMaxQPerThread; ++i)
      if (threadIdx.x + i * kThreads < RP * QS) qs[threadIdx.x + i * kThreads] = qv[i];
    for (int idx = threadIdx.x; idx < step * (QS - D); idx += kThreads) {
      const int j = idx / (QS - D);
      ks[j * KS + D + idx - j * (QS - D)] = 0.f;
    }
    for (int k0 = s_begin; k0 < s_end; k0 += step) {
      __syncthreads();  // the previous step is consumed
      if (vec) {
        store_tile<T>(next, ks, vs, D, step);
        if (k0 + step < s_end) fetch_tile(next, kb, vb, kst, vst, k0 + step, s_end, D, step);
      } else {
        for (int t = 0; t < KG; ++t)
          load_kv_tile(ks + t * kTileK * KS, vs + t * kTileK * D, kb, vb, kst, vst,
                       k0 + t * kTileK, s_end, D);
      }
      __syncthreads();
      const int t0 = k0 + grp * kTileK;  // this group's tile
      bool valid[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) valid[i] = t0 + lane < s_end;
      if (grp < KG && t0 < s_end)
        rows_tile<DPL, NR>(st, qs + row0 * QS, ks + grp * kTileK * KS, vs + grp * kTileK * D,
                           D, valid, scale, lane, pbuf + warp * NR * 32);
    }
  }

  // Push the partial (empty when this split holds no key) into rank 0's
  // shared memory; the release/acquire barrier then hands it over.
  cluster_wait();
  float* pm0 = cluster.map_shared_rank(pm, 0);
  float* pl0 = cluster.map_shared_rank(pl, 0);
  float* pacc0 = cluster.map_shared_rank(pacc, 0);
  const int slot = rank * KG + grp;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = row0 + i;
    if (grp >= KG || r >= R) continue;
    if (lane == 0) {
      pm0[slot * R + r] = st[i].m;
      pl0[slot * R + r] = st[i].l;
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) pacc0[(slot * R + r) * D + d] = st[i].acc[j];
    }
  }
  cluster.sync();
  if (rank != 0) return;

  T* ob = o + b * osb + (long long)g * R * osh;
  for (int r = warp; r < R; r += kWarps) {
    if (len <= 0) {  // no visible key
      for (int d = lane; d < D; d += 32) ob[r * osh + d] = from_float<T>(mean_v(vb, vst, Tk, d));
      continue;
    }
    float m = kNegInf;
#pragma unroll
    for (int c = 0; c < kMaxCluster * kMaxKeyGroups; ++c)
      if (c < P) m = fmaxf(m, pm[c * R + r]);
    float l = 0.f;
    float acc[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster * kMaxKeyGroups; ++c) {
      if (c >= P) break;
      const float w = __expf(pm[c * R + r] - m);
      l = fmaf(pl[c * R + r], w, l);
      const float* pa = pacc + (c * R + r) * D;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        if (d < D) acc[j] = fmaf(pa[d], w, acc[j]);
      }
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) ob[r * osh + d] = from_float<T>(acc[j] * inv);
    }
  }
}

template <typename T, int DPL, int NR>
int launch(const void* q, const void* k, const void* v, const void* kv_len_ptr,
           int kv_len_val, void* o, int B, int H, int G, int Tk, int D, const long long* s,
           int C, float scale, int vec, cudaStream_t stream) {
  const int R = H / G;
  const int wpg = (R + NR - 1) / NR;
  // As many key groups as the warps, the register staging and the cap allow.
  const int cpr = (D * (int)sizeof(T) + 15) / 16;
  int KG = kWarps / wpg < kMaxKeyGroups ? kWarps / wpg : kMaxKeyGroups;
  while (KG > 1 && KG * kTileK * cpr > tile_chunks<T, DPL>() * kThreads) --KG;
  const size_t smem = sizeof(float) * (size_t)(wpg * NR * q_stride(D) +
                                               KG * kTileK * (k_stride(D) + D) +
                                               kThreads * NR + C * KG * R * (2 + D));
  auto kernel = decode_cluster_kernel<T, DPL, NR>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, G, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const T*)q, (const T*)k, (const T*)v,
                           (const int*)kv_len_ptr, kv_len_val, (T*)o, H, G, Tk, D, s[0],
                           s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], scale, vec,
                           KG);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* kv_len_ptr,
             int kv_len_val, void* o, int B, int H, int G, int Tk, int D, const long long* s,
             int C, float scale, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const int vec = D % kVec == 0 && ((uintptr_t)k & 15) == 0 && ((uintptr_t)v & 15) == 0 &&
                  s[3] % kVec == 0 && s[2] % kVec == 0 && s[4] % kVec == 0 &&
                  s[6] % kVec == 0 && s[5] % kVec == 0 && s[7] % kVec == 0;
  if (H / G > 16) {  // D <= 128 here (the entry point refuses R > 16 past it)
    switch ((D + 31) / 32) {
      case 1: return launch<T, 1, 4>(q, k, v, kv_len_ptr, kv_len_val, o, B, H, G, Tk, D, s, C, scale, vec, stream);
      case 2: return launch<T, 2, 4>(q, k, v, kv_len_ptr, kv_len_val, o, B, H, G, Tk, D, s, C, scale, vec, stream);
      case 3: return launch<T, 3, 4>(q, k, v, kv_len_ptr, kv_len_val, o, B, H, G, Tk, D, s, C, scale, vec, stream);
      case 4: return launch<T, 4, 4>(q, k, v, kv_len_ptr, kv_len_val, o, B, H, G, Tk, D, s, C, scale, vec, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch ((D + 31) / 32) {
    case 1: return launch<T, 1, 2>(q, k, v, kv_len_ptr, kv_len_val, o, B, H, G, Tk, D, s, C, scale, vec, stream);
    case 2: return launch<T, 2, 2>(q, k, v, kv_len_ptr, kv_len_val, o, B, H, G, Tk, D, s, C, scale, vec, stream);
    case 3: return launch<T, 3, 2>(q, k, v, kv_len_ptr, kv_len_val, o, B, H, G, Tk, D, s, C, scale, vec, stream);
    case 4: return launch<T, 4, 2>(q, k, v, kv_len_ptr, kv_len_val, o, B, H, G, Tk, D, s, C, scale, vec, stream);
    case 5: return launch<T, 5, 2>(q, k, v, kv_len_ptr, kv_len_val, o, B, H, G, Tk, D, s, C, scale, vec, stream);
    case 6: return launch<T, 6, 2>(q, k, v, kv_len_ptr, kv_len_val, o, B, H, G, Tk, D, s, C, scale, vec, stream);
    case 7: return launch<T, 7, 2>(q, k, v, kv_len_ptr, kv_len_val, o, B, H, G, Tk, D, s, C, scale, vec, stream);
    case 8: return launch<T, 8, 2>(q, k, v, kv_len_ptr, kv_len_val, o, B, H, G, Tk, D, s, C, scale, vec, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, in the order
// q (b, h), k (b, t, g), v (b, t, g), o (b, h); the last dim is contiguous.
// kv_len: a (B,) int32 device array, or null and then kv_len_val for every
// sequence. cluster: blocks per (KV head, sequence), 1..8.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* kv_len, int kv_len_val, void* o,
                                       int dtype, int B, int H, int G, int Tk, int D,
                                       long long qsb, long long qsh, long long ksb,
                                       long long kst, long long ksg, long long vsb,
                                       long long vst, long long vsg, long long osb,
                                       long long osh, int cluster, float scale,
                                       void* stream) {
  const long long s[10] = {qsb, qsh, ksb, kst, ksg, vsb, vst, vsg, osb, osh};
  cudaStream_t st = (cudaStream_t)stream;
  if (cluster < 1 || cluster > kMaxCluster || G < 1 || H % G || D < 1 || D > kMaxHeadDim ||
      H / G > (D > 128 ? kMaxGroupWide : kMaxGroup))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(q, k, v, kv_len, kv_len_val, o, B, H, G, Tk, D, s, cluster, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, kv_len, kv_len_val, o, B, H, G, Tk, D, s, cluster, scale, st);
  return (int)cudaErrorInvalidValue;
}
